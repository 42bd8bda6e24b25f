"""The declarative surface: ``Experiment`` -> ``Plan`` -> results."""
from repro_torch.api.experiment import Experiment
from repro_torch.api.placement import Placement
from repro_torch.api.plan import Plan
from repro_torch.api.results import SweepResult

__all__ = ["Experiment", "Placement", "Plan", "SweepResult"]
