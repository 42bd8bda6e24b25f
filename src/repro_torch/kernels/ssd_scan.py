"""ssd_intra_chunk: the Mamba-2 SSD intra-chunk block on the card.

Per (batch, chunk) and head:

    y[q]  = sum_{t <= q} (C_q . B_t) exp(a_q - a_t) x_t
    state = sum_t B_t exp(a_last - a_t) x_t

Replaces ``src/repro/kernels/ssd_scan.py::ssd_intra_chunk``, which
``cfg.use_pallas`` switches into the SSM prefill. Two kernels behind one
C entry, picked by the dtype of B / C. bfloat16 (the served dtype) runs
on the tensor cores (``csrc/ssd_intra_chunk_sm90.cu``: wgmma, x and the
decay weights as TF32 hi / lo pairs; C.B^T and B^T once per chunk into a
scratch buffer as shared-memory images, then one warpgroup per pair of
query tiles or state slice, head and chunk). Float32 stays in exact
float32 on the CUDA cores (``csrc/ssd_intra_chunk.cu``: register-tiled
64 x 64 products fed by cp.async), summed in the order of torch's float32
einsums, which the float32 serving gate needs: bitwise its plain version
at mamba2-1.3b's shape.
Bound: bytes for bf16 (tensor cores), operations for f32 (CUDA cores; see
the sources). Its plain version is
``kernels/ref.py::ssd_chunk_ref`` batched over chunks, with B / C upcast
to f32 before their product, as the TPU kernel does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import I, P, arg, count_launch, on_cpu, stream

MAX_HEAD_DIM = 128  # P the CUDA kernel takes
TILE = 64  # the bf16 kernel's query / time tile
SLICE = 128  # the bf16 kernel's state columns (n) per CTA
DTYPES = (torch.float32, torch.bfloat16)


def ssd_intra_chunk_plain(x, da_cs, b_in, c_in):
    """(y_intra (B, nc, Q, H, P) f32, states (B, nc, H, P, N) f32) from x
    (B, nc, Q, H, P), da_cs (B, nc, Q, H), b_in / c_in (B, nc, Q, N)."""
    Q = x.shape[2]
    x = x.float()
    b, c = b_in.float(), c_in.float()
    diff = da_cs[:, :, :, None, :] - da_cs[:, :, None, :, :]  # (B, nc, Q, Q, H)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(tri[None, None, :, :, None], diff, -1e30))
    scores = torch.einsum("bcqn,bctn->bcqt", c, b)
    y = torch.einsum("bcqth,bcthp->bcqhp", scores[..., None] * decay, x)
    decay_out = torch.exp(da_cs[:, :, -1:, :] - da_cs)  # (B, nc, Q, H)
    state = torch.einsum("bctn,bcthp->bchpn", b, x * decay_out[..., None])
    return y, state


def ssd_intra_chunk(x, da_cs, b_in, c_in):
    """``x`` (B, nc, Q, H, P) float32, ``da_cs`` (B, nc, Q, H) float32,
    ``b_in`` / ``c_in`` (B, nc, Q, N) float32 or bfloat16 (alike), all
    contiguous (checked on every device). Returns (y_intra, states) in
    float32. CPU tensors take the plain version; CUDA tensors launch the
    kernel, which also needs P <= ``MAX_HEAD_DIM``."""
    B, nc, Q, H, Pd = x.shape
    N = b_in.shape[-1]
    if b_in.dtype not in DTYPES:
        raise TypeError(f"b_in: expected one of {DTYPES}, got {b_in.dtype}")
    ptrs = (
        arg(x, "x", torch.float32, (B, nc, Q, H, Pd)),
        arg(da_cs, "da_cs", torch.float32, (B, nc, Q, H)),
        arg(b_in, "b_in", b_in.dtype, (B, nc, Q, N)),
        arg(c_in, "c_in", b_in.dtype, (B, nc, Q, N)),
    )
    if on_cpu(x, da_cs, b_in, c_in):
        return ssd_intra_chunk_plain(x, da_cs, b_in, c_in)
    if Pd > MAX_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes P <= {MAX_HEAD_DIM}, got {Pd}")
    dev = x.device
    y = torch.empty((B, nc, Q, H, Pd), dtype=torch.float32, device=dev)
    st = torch.empty((B, nc, H, Pd, N), dtype=torch.float32, device=dev)
    bf16 = b_in.dtype == torch.bfloat16
    if bf16:  # per chunk: the S tiles on or below the diagonal, then B^T per t-tile
        tiles, slices = -(-Q // TILE), -(-N // SLICE)
        per_chunk = tiles * (tiles + 1) // 2 * TILE * TILE + tiles * slices * SLICE * TILE
    else:  # per chunk: C.B^T
        per_chunk = Q * Q
    scores = torch.empty((B * nc, per_chunk), dtype=torch.float32, device=dev)
    fn = _build.load("ssd_intra_chunk_sm90" if bf16 else "ssd_intra_chunk").ssd_intra_chunk_launch
    fn.argtypes = [P] * 7 + [I] * 6 + [P]
    fn.restype = I
    status = fn(*ptrs, y.data_ptr(), st.data_ptr(), scores.data_ptr(), B * nc, Q, H, Pd, N,
                int(bf16), stream())
    _build.check(status, "ssd_intra_chunk")
    count_launch(ssd_intra_chunk)
    return y, st


ssd_intra_chunk.launches = 0
# the device function that runs once per call, in either library
ssd_intra_chunk.symbols = ("scores_kernel",)
