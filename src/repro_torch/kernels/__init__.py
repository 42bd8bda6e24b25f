"""Hand-written Hopper kernels of the round (CUDA C++, sm_90a).

  whole_round  — one whole round, ``round_impl="fused"`` (csrc/whole_round.cu)
  round_update — the observation pass, ``estimator_impl="fused"`` (csrc/round_update.cu)
  theta_sums   — the per-node estimator sweep, ``estimator_impl="pallas"`` (csrc/theta_sums.cu)

Each wrapper runs its plain PyTorch version on CPU tensors and launches
its kernel on CUDA tensors, counting launches in ``<wrapper>.launches``.
The kernels are built with nvcc at first use (``_build``).
"""
from repro_torch.kernels.round_update import (
    round_update,
    round_update_plain,
    whole_round,
    whole_round_plain,
)
from repro_torch.kernels.theta_survival import theta_sums, theta_sums_plain

KERNELS = (whole_round, round_update, theta_sums)

__all__ = [
    "KERNELS",
    "round_update",
    "round_update_plain",
    "theta_sums",
    "theta_sums_plain",
    "whole_round",
    "whole_round_plain",
]
