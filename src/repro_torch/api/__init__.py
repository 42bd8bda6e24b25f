"""The declarative surface: ``Experiment`` -> ``Plan`` -> results, and the
executable cache's ``cache_stats``."""
from repro_torch.api.experiment import Experiment
from repro_torch.api.placement import Placement
from repro_torch.api.plan import Plan, cache_stats, plan_signature
from repro_torch.api.results import SweepResult

__all__ = ["Experiment", "Placement", "Plan", "SweepResult", "cache_stats", "plan_signature"]
