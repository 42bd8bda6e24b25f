"""Shared neural layers: RMSNorm, RoPE / M-RoPE, SwiGLU, GQA attention
(the port of ``repro.models.layers``).

Attention for a full sequence is the reference's statically blocked
q-block attention (``blocked_causal_attention``): a q block of 512 keeps
the score buffer at (B, H, 512, kv_len). The hand-written flash kernel
(``repro_torch.kernels.attention_pallas``) computes the same function and
replaces it when ``cfg.use_pallas`` is set. Weights keep the reference's
shapes ((d, H, hd) projections, (H, hd, d) output), so a reference
checkpoint loads as it is; the products reshape them to matrices.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.utils import prng

Q_BLOCK = 512  # static query block for blocked attention


# ---------------------------------------------------------------------------
# Norm / MLP
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, dtype, device) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalised in f32, cast back to x's dtype, then scaled (the
    reference's order)."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * scale


def draw(key, shape, scale: float, dtype, *, partitionable: bool = True) -> torch.Tensor:
    """``(jax.random.normal(key, shape) * scale).astype(dtype)``."""
    return (prng.normal(key, shape, partitionable=partitionable) * scale).to(dtype)


def swiglu_init(key, d: int, f: int, dtype, *, partitionable: bool = True):
    k1, k2, k3 = prng.split(key, 3, partitionable=partitionable)
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(f)
    return {
        "gate": draw(k1, (d, f), s_in, dtype, partitionable=partitionable),
        "up": draw(k2, (d, f), s_in, dtype, partitionable=partitionable),
        "down": draw(k3, (f, d), s_out, dtype, partitionable=partitionable),
    }


def swiglu(params, x: torch.Tensor) -> torch.Tensor:
    g = x @ params["gate"]
    u = x @ params["up"]
    return (F.silu(g) * u) @ params["down"]


# ---------------------------------------------------------------------------
# RoPE (standard + M-RoPE)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


# (head_dim, theta, device) -> rope_frequencies: made once, so that a
# decode step (captured or eager) issues no work to rebuild the constant
_ROPE_FREQS: dict = {}


def _cached_rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    key = (head_dim, float(theta), torch.device(device))
    freqs = _ROPE_FREQS.get(key)
    if freqs is None:
        freqs = _ROPE_FREQS[key] = rope_frequencies(head_dim, theta, device)
    return freqs


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int."""
    half = x.shape[-1] // 2
    freqs = _cached_rope_frequencies(x.shape[-1], theta, x.device)  # (half,)
    ang = positions[..., None].float() * freqs  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# (sections, device) -> the position stream of each frequency band
_MROPE_BANDS: dict = {}


def _mrope_bands(sections: tuple, device) -> torch.Tensor:
    key = (tuple(sections), torch.device(device))
    sel = _MROPE_BANDS.get(key)
    if sel is None:
        sel = torch.repeat_interleave(torch.arange(3), torch.tensor(sections))
        sel = _MROPE_BANDS[key] = sel.to(device)
    return sel


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. x: (B, S, H, D); positions3: (3, B, S),
    the temporal / height / width coordinate streams. The half-head-dim
    frequency bands are split into ``sections`` chunks; band j rotates by
    the stream of its chunk."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError("mrope sections must sum to head_dim/2")
    freqs = _cached_rope_frequencies(x.shape[-1], theta, x.device)  # (half,)
    pos_per_band = positions3.float()[_mrope_bands(sections, x.device)]  # (half, B, S)
    ang = torch.movedim(pos_per_band, 0, -1) * freqs  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention (train/prefill: blocked; decode: cached single query)
# ---------------------------------------------------------------------------


def attention_init(key, cfg, dtype, *, partitionable: bool = True):
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    k1, k2, k3, k4 = prng.split(key, 4, partitionable=partitionable)
    s = 1.0 / math.sqrt(d)
    so = 1.0 / math.sqrt(H * hd)
    return {
        "wq": draw(k1, (d, H, hd), s, dtype, partitionable=partitionable),
        "wk": draw(k2, (d, KV, hd), s, dtype, partitionable=partitionable),
        "wv": draw(k3, (d, KV, hd), s, dtype, partitionable=partitionable),
        "wo": draw(k4, (H, hd, d), so, dtype, partitionable=partitionable),
    }


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def unproject(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd", x, w)`` as one matrix product."""
    h, k, d = w.shape
    return x.reshape(*x.shape[:-2], h * k) @ w.reshape(h * k, d)


def _block_attend(q, k, v, q_offset: int, kv_offset: int, window: int):
    """Attend one q block against a kv slice with causal (+window) mask.
    q: (B, Tq, KV, G, hd); k/v: (B, Tk, KV, hd). Returns (B, Tq, KV, G, vd)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqkgd,btkd->bkgqt", q.float(), k.float()) * scale
    qpos = q_offset + torch.arange(q.shape[1], device=q.device)[:, None]
    kpos = kv_offset + torch.arange(k.shape[1], device=q.device)[None, :]
    mask = kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    scores = torch.where(mask[None, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgqt,btkd->bqkgd", probs.to(v.dtype), v)


def blocked_causal_attention(q, k, v, window: int = 0, q_block: int = Q_BLOCK):
    """Statically unrolled q-block causal attention with exact KV slicing:
    q block i touches only kv[0 : (i+1) * q_block] (or its window slice).
    q: (B, S, H, hd); k/v: (B, S, KV, hd)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    vd = v.shape[-1]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd)
    if S <= q_block:
        return _block_attend(qg, k, v, 0, 0, window).reshape(B, S, H, vd)
    if S % q_block:
        raise ValueError("sequence must be a multiple of the q block")
    outs = []
    for i in range(S // q_block):
        q_i = qg[:, i * q_block:(i + 1) * q_block]
        end = (i + 1) * q_block
        start = 0 if window <= 0 else max(0, end - window - q_block)
        outs.append(_block_attend(q_i, k[:, start:end], v[:, start:end], i * q_block, start, window))
    return torch.cat(outs, dim=1).reshape(B, S, H, vd)


def decode_attention(q, k_cache, v_cache, cache_positions, pos, window: int = 0):
    """Single-token attention against a (possibly ring-buffer) KV cache.
    q: (B, 1, H, hd); caches (B, T, KV, hd); cache_positions (B, T)
    absolute positions, -1 = empty; pos (B,) the current position. The
    probabilities are cast to the cache's dtype before P.V (the
    reference's order)."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    vd = v_cache.shape[-1]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, KV, G, hd)
    scores = torch.einsum("bkgd,btkd->bkgt", qg.float(), k_cache.float()) * scale
    valid = (cache_positions >= 0) & (cache_positions <= pos[:, None])
    if window > 0:
        valid &= cache_positions > (pos[:, None] - window)
    scores = torch.where(valid[:, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, vd)
