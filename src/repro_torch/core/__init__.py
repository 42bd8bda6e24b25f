"""DecAFork / DecAFork+ on the card: configs, estimator, walks, threat
models, the batched simulator (``core.simulator``, which imports the
kernels and so is not imported here) and the Section IV/V theory
(``core.theory``, ``core.irwin_hall``: numpy only)."""
from repro_torch.core.failures import FailureConfig
from repro_torch.core.irwin_hall import (
    design_eps,
    design_eps2,
    false_fork_probability,
    false_termination_probability,
    irwin_hall_cdf,
    scaled_irwin_hall_cdf,
)
from repro_torch.core.outputs import (
    FULL,
    SCALARS,
    OutputSpec,
    RecordedOutputs,
    StepOutputs,
)
from repro_torch.core.protocol import ALGORITHMS, ProtocolConfig

__all__ = [
    "ALGORITHMS",
    "FULL",
    "FailureConfig",
    "OutputSpec",
    "ProtocolConfig",
    "RecordedOutputs",
    "SCALARS",
    "StepOutputs",
    "design_eps",
    "design_eps2",
    "false_fork_probability",
    "false_termination_probability",
    "irwin_hall_cdf",
    "scaled_irwin_hall_cdf",
]
