"""Model-layout wrappers around the attention and SSD kernels: the
drop-in replacements the model code selects with ``cfg.use_pallas``
(the counterparts of ``repro.kernels.ops``):

  attention_pallas(q, k, v, window)   <-> layers.blocked_causal_attention
  ssd_pallas(x, dt, a, b, c, chunk)   <-> ssm.ssd_chunked

On CUDA tensors they launch the hand-written kernels; on CPU tensors the
kernels' plain versions run.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_intra_chunk


def attention_pallas(q, k, v, window: int = 0):
    """q: (B, S, H, D); k/v: (B, S, KV, D), the model layout, which the
    kernel takes as it is (the reference transposes to (B, H, S, D))."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), window=window)


def ssd_pallas(x, dt, a, b_in, c_in, chunk: int = 128):
    """Drop-in for ``ssm.ssd_chunked(..., return_state=True)``: returns
    (y (B, L, H, P) in x's dtype, final state (B, H, P, N) f32). The
    intra-chunk block runs in the kernel; the inter-chunk recurrence is a
    loop over chunks (the reference's associative scan, in another float
    order)."""
    B, L, H, Pd = x.shape
    N = b_in.shape[-1]
    if L % chunk:
        raise ValueError("L must divide the chunk size")
    nc = L // chunk
    da = (dt * a).reshape(B, nc, chunk, H)
    da_cs = torch.cumsum(da, dim=2)
    xdt = (x * dt[..., None]).reshape(B, nc, chunk, H, Pd)
    bc = b_in.reshape(B, nc, chunk, N).contiguous()
    cc = c_in.reshape(B, nc, chunk, N).contiguous()

    y_intra, states = ssd_intra_chunk(xdt.contiguous(), da_cs.contiguous(), bc, cc)

    gs = torch.exp(da_cs[:, :, -1])  # (B, nc, H)
    run = [states[:, 0]]
    for c in range(1, nc):
        run.append(run[-1] * gs[:, c, :, None, None] + states[:, c])
    s_run = torch.stack(run, dim=1)  # (B, nc, H, P, N)
    s_prev = torch.cat([torch.zeros_like(s_run[:, :1]), s_run[:, :-1]], dim=1)
    in_decay = torch.exp(da_cs)  # (B, nc, Q, H)
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", cc.float(), s_prev) * in_decay[..., None]
    y = (y_intra + y_inter).reshape(B, L, H, Pd).to(x.dtype)
    return y, s_run[:, -1]
