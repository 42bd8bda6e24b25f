"""flash_attention: causal (+ sliding-window) GQA attention on the card.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention``, the
Pallas kernel that ``cfg.use_pallas`` switches into the models' prefill.
Two CUDA kernels share one C entry (``flash_attention_launch``) and are
chosen by dtype: bfloat16 runs on the tensor cores
(``csrc/flash_attention_sm90.cu``: TMA-fed 64-key K/V tiles, wgmma for
Q.K^T and P.V, 128 query rows per CTA), float32 on the CUDA cores in
exact float32 (``csrc/flash_attention.cu``: a CTA serves every query head
of one KV group, register-blocked products, cp.async-fed K/V tiles of 64
keys, 32 at D >= 128). Both keep the online-softmax recurrence in f32 and skip key
tiles wholly above the diagonal or before the window (exact: see the
sources). Unlike the TPU kernel they take the model layout (B, S, H, D)
directly, so the model needs no transposes. The plain version is
``kernels/ref.py::mha_ref``'s formula.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import I, P, arg, count_launch, on_cpu, stream

BLOCK = 128  # the reference kernel's default q and kv blocks: S must divide by min(BLOCK, S)
HEAD_DIMS = (32, 64, 128, 256)  # the head dims the kernel is built for
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_plain(q, k, v, window: int = 0) -> torch.Tensor:
    """Full-materialization causal GQA attention, ``mha_ref``'s formula:
    f32 scores divided by sqrt(D), masked to -inf, softmax, P.V in f32,
    the result in q's dtype. q (B, S, H, D), k / v (B, S, KV, D)."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, D).float()
    scores = torch.einsum("bqkgd,btkd->bkgqt", qg, k.float()) / math.sqrt(D)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", p, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int = 0):
    """Causal attention, (B, S, H, D) in q's dtype, from q (B, S, H, D)
    and k / v (B, S, KV, D), float32 or bfloat16 alike, contiguous; a
    sliding window when ``window > 0``. Shapes are checked as the
    reference checks them (H a multiple of KV, S of its default block),
    on every device. CPU tensors take the plain version; CUDA tensors
    launch the kernel of their dtype, which also needs D in
    ``HEAD_DIMS`` (its own tiles mask the ragged edge, whatever the
    block) and, in bfloat16, 16-byte-aligned inputs (its TMA loads)."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    if H % KV:
        raise ValueError("H must be a multiple of KV")
    if S % min(BLOCK, S):
        raise ValueError("S must be a multiple of the block sizes")
    if q.dtype not in DTYPES:
        raise TypeError(f"q: expected one of {DTYPES}, got {q.dtype}")
    ptrs = (
        arg(q, "q", q.dtype, (B, S, H, D)),
        arg(k, "k", q.dtype, (B, S, KV, D)),
        arg(v, "v", q.dtype, (B, S, KV, D)),
    )
    if on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, window)
    if D not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head dims {HEAD_DIMS}, got {D}")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and any(p % 16 for p in ptrs):
        raise ValueError("bfloat16 q, k and v must be 16-byte aligned (TMA)")
    out = torch.empty_like(q)
    fn = _build.load("flash_attention_sm90" if bf16 else "flash_attention").flash_attention_launch
    fn.argtypes = [P] * 4 + [I] * 7 + [ctypes.c_float, P]
    fn.restype = I
    status = fn(*ptrs, out.data_ptr(), B, S, H, KV, D, int(window), int(bf16),
                1.0 / math.sqrt(D), stream())
    _build.check(status, "flash_attention")
    count_launch(flash_attention)
    return out


flash_attention.launches = 0
# its kernel's device function: bf16 (flash_attention_sm90.cu), f32
flash_attention.symbols = ("flash_sm90_kernel", "flash_kernel")
