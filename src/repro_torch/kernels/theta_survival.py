"""theta_sums: the per-node DecAFork estimator sweep on the card.

    sums[b, i] = sum_c S_i(t_b - last_seen[b, i, c])

with the optimistic prior (no samples: S = 1) and S(r <= 0) = 1. It
serves ``estimator_impl="pallas"`` in the unfused round.

Replaces ``src/repro/kernels/theta_survival.py::theta_sums``. The TPU
kernel restates the survival gather as a (C, B) compare-accumulate
because a TPU avoids gathers; the CUDA kernel (``csrc/theta_sums.cu``)
reads each row once into registers and gathers the clamped return
times' prefix counts from them by warp shuffles instead. Bound:
bytes (each row's C + B counters are read once). The node-sum is exact
integer arithmetic up to one division, so the kernel is bitwise its
plain version and the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core.estimator import survival_node_sums_rows
from repro_torch.kernels import _build
from repro_torch.kernels._launch import I, P, arg, count_launch, on_cpu, stream


def theta_sums_plain(last_seen, hist, total, t) -> torch.Tensor:
    """The literal formula (``estimator.survival_node_sums_rows``)."""
    return survival_node_sums_rows(last_seen, hist, total, t)


def theta_sums(last_seen, hist, total, t) -> torch.Tensor:
    """(batch, n) float32 node sums. ``last_seen`` (batch, n, C) int32,
    ``hist`` (batch, n, B) int16, ``total`` (batch, n) int32, ``t``
    (batch,) int32, all contiguous (checked on every device). CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    batch, n, C = last_seen.shape
    B = hist.shape[2]
    ptrs = (
        arg(last_seen, "last_seen", torch.int32, (batch, n, C)),
        arg(hist, "hist", torch.int16, (batch, n, B)),
        arg(total, "total", torch.int32, (batch, n)),
        arg(t, "t", torch.int32, (batch,)),
    )
    if on_cpu(last_seen, hist, total, t):
        return theta_sums_plain(last_seen, hist, total, t)
    out = torch.empty((batch, n), dtype=torch.float32, device=last_seen.device)
    fn = _build.load("theta_sums").theta_sums_launch
    fn.argtypes = [P] * 5 + [I] * 4 + [P]
    fn.restype = I
    status = fn(*ptrs, out.data_ptr(), batch, n, C, B, stream())
    _build.check(status, "theta_sums")
    count_launch(theta_sums)
    return out


theta_sums.launches = 0
theta_sums.symbols = ("theta_sums_kernel",)  # its kernel's device function
