"""The declarative surface: ``Experiment`` -> ``Plan`` -> results."""
from repro_torch.api.experiment import Experiment
from repro_torch.api.plan import Plan

__all__ = ["Experiment", "Plan"]
