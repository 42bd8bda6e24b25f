"""PyTorch / CUDA port of the self-regulating random-walk system.

Runs DecAFork and DecAFork+ ensembles (``repro_torch.api.Experiment``) on
an NVIDIA H100 through hand-written round kernels (``repro_torch.kernels``,
sources in ``csrc/``). Imports torch and numpy only; the JAX package
(``repro``) is the reference it is tested against.
"""
__version__ = "0.1.0"
