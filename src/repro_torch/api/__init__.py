"""The declarative surface: ``Experiment`` -> ``Plan`` -> results, the
executable cache's ``cache_stats`` and ``runners``, the named-experiment
``registry`` (``Experiment.from_config``), the disk-backed ``ResultStore``
and the coalescing ``ExperimentService``."""
from repro_torch.api.experiment import Experiment
from repro_torch.api.placement import Placement
from repro_torch.api import registry
from repro_torch.api.plan import Plan, cache_stats, plan_signature, runners
from repro_torch.api.results import SweepResult
from repro_torch.api.service import ExperimentService, SubmissionFuture
from repro_torch.api.store import ResultStore

__all__ = ["Experiment", "ExperimentService", "Placement", "Plan", "ResultStore",
           "SubmissionFuture", "SweepResult", "cache_stats", "plan_signature", "registry",
           "runners"]
