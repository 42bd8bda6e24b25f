"""DecAFork / DecAFork+ on the card: configs, estimator, walks, threat
models and the batched simulator (``core.simulator``, which imports the
kernels and so is not imported here)."""
from repro_torch.core.failures import FailureConfig
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
]
