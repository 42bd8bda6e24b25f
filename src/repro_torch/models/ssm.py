"""Mamba-2 (SSD, state-space duality) blocks: the full-sequence mixer
and the decode step (the port of ``repro.models.ssm``).

The selective state-space recurrence
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t,    y_t = C_t h_t + D x_t
is computed chunkwise: quadratic attention-like work inside chunks of
length Q, a state recurrence between them. The reference runs that
recurrence as an associative scan; here it is a loop over the chunks
(the same sums in another float order). Single-group (G=1) B/C as in
mamba2-1.3b. With ``cfg.use_pallas`` the intra-chunk block runs in the
hand-written kernel (``repro_torch.kernels.ssd_pallas``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import draw, rmsnorm
from repro_torch.utils import prng

SSD_CHUNK = 256


def ssm_init(key, cfg, dtype, *, partitionable: bool = True):
    d = cfg.d_model
    di = cfg.ssm_d_inner
    n = cfg.ssm_state
    hs = cfg.ssm_heads
    conv_dim = di + 2 * n
    dev = key.device
    ks = prng.split(key, 4, partitionable=partitionable)
    s = 1.0 / math.sqrt(d)
    f32 = torch.float32
    return {
        "in_proj": draw(ks[0], (d, 2 * di + 2 * n + hs), s, dtype, partitionable=partitionable),
        "conv_w": (prng.normal(ks[1], (cfg.ssm_conv, conv_dim), partitionable=partitionable)
                   / math.sqrt(cfg.ssm_conv)).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, hs, dtype=f32, device=dev)),  # A = -exp(a_log)
        "d_skip": torch.ones((hs,), dtype=f32, device=dev),
        "dt_bias": torch.full((hs,), math.log(math.e - 1), dtype=f32, device=dev),
        "gate_norm": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": (prng.normal(ks[2], (di, d), partitionable=partitionable)
                     / math.sqrt(di)).to(dtype),
    }


def _split_in_proj(cfg, zxbcdt):
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * n]
    dt = zxbcdt[..., di + di + 2 * n:]
    return z, xbc, dt


def causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal 1-D conv then SiLU; xbc: (B, L, Cd), w: (K, Cd)."""
    K = w.shape[0]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(K):
        out = out + pad[:, i:i + xbc.shape[1]] * w[K - 1 - i]
    return F.silu(out + b)


def ssd_chunked(x, dt, a, b_in, c_in, chunk: int = SSD_CHUNK, return_state: bool = False):
    """Chunkwise SSD in plain torch; returns y (B, L, H, P) (without the D
    skip or gating), and with ``return_state`` the final state
    (B, H, P, N) for the decode cache. x (B, L, H, P), dt (B, L, H)
    softplus'd steps, a (H,) negative decay, b_in / c_in (B, L, N)."""
    B, L, H, P = x.shape
    N = b_in.shape[-1]
    if L % chunk:
        raise ValueError(f"L={L} must be a multiple of chunk={chunk}")
    nc = L // chunk
    xc = x.reshape(B, nc, chunk, H, P)
    dtc = dt.reshape(B, nc, chunk, H)
    bc = b_in.reshape(B, nc, chunk, N)
    cc = c_in.reshape(B, nc, chunk, N)

    da = dtc * a  # (B, nc, Q, H) log-decay increments (negative)
    da_cs = torch.cumsum(da, dim=2)
    da_total = da_cs[:, :, -1]  # (B, nc, H)
    xdt = (xc * dtc[..., None]).float()

    # intra-chunk (quadratic); mask before exp, as the reference does
    diff = da_cs[:, :, :, None, :] - da_cs[:, :, None, :, :]  # (B, nc, Q, Q, H)
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(tri[None, None, :, :, None], diff, -1e30))
    scores = torch.einsum("bcqn,bctn->bcqt", cc, bc)  # in the model dtype
    y_intra = torch.einsum("bcqth,bcthp->bcqhp", scores.float()[..., None] * decay, xdt)

    # chunk states
    decay_out = torch.exp(da_total[:, :, None, :] - da_cs)  # (B, nc, Q, H)
    states = torch.einsum("bctn,bcthp->bchpn", bc.float(), xdt * decay_out[..., None])

    # inter-chunk recurrence: s_c = s_{c-1} * g_c + states_c
    gs = torch.exp(da_total)  # (B, nc, H)
    run = [states[:, 0]]
    for c in range(1, nc):
        run.append(run[-1] * gs[:, c, :, None, None] + states[:, c])
    s_run = torch.stack(run, dim=1)
    s_prev = torch.cat([torch.zeros_like(s_run[:, :1]), s_run[:, :-1]], dim=1)

    in_decay = torch.exp(da_cs)  # decay from the chunk start to position q
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", cc.float(), s_prev) * in_decay[..., None]

    y = (y_intra + y_inter).to(x.dtype).reshape(B, L, H, P)
    if return_state:
        return y, s_run[:, -1]
    return y


def ssm_forward_train(params, x: torch.Tensor, cfg, return_cache: bool = False):
    """Full mamba2 mixer for a prefill sequence; x: (B, L, d). With
    ``return_cache`` also returns {'state', 'conv'} for decoding."""
    di, n, hs, p = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = x @ params["in_proj"]
    z, xbc_raw, dt = _split_in_proj(cfg, zxbcdt)
    xbc = causal_conv(xbc_raw, params["conv_w"], params["conv_b"])
    xs = xbc[..., :di].reshape(*x.shape[:2], hs, p)
    b_in = xbc[..., di:di + n]
    c_in = xbc[..., di + n:]
    dt = F.softplus(dt.float() + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    chunk = min(cfg.ssd_chunk or SSD_CHUNK, x.shape[1])
    if cfg.use_pallas:
        from repro_torch.kernels import ssd_pallas

        y, state = ssd_pallas(xs, dt, a, b_in, c_in, chunk=chunk)
    else:
        y, state = ssd_chunked(xs, dt, a, b_in, c_in, chunk=chunk, return_state=True)
    y = y + (params["d_skip"][None, None, :, None] * xs.float()).to(y.dtype)
    y = y.reshape(*x.shape[:2], di)
    y = y * F.silu(z)
    y = rmsnorm(y, params["gate_norm"], cfg.norm_eps)
    out = y @ params["out_proj"]
    if return_cache:
        k = params["conv_w"].shape[0]
        return out, {"state": state.float(), "conv": xbc_raw[:, -(k - 1):]}
    return out


def ssm_decode_step(params, x: torch.Tensor, state, conv_cache, cfg):
    """Single-token recurrent update. x: (B, 1, d); state: (B, H, P, N);
    conv_cache: (B, K-1, conv_dim). Returns (y (B, 1, d), new_state,
    new_conv_cache)."""
    di, n, hs, p = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = x @ params["in_proj"]
    z, xbc, dt = _split_in_proj(cfg, zxbcdt)
    xbc_t = xbc[:, 0]  # (B, conv_dim)
    # window[k] holds x_{t-K+1+k} while conv_w[j] multiplies lag j: flip
    window = torch.cat([conv_cache, xbc_t[:, None]], dim=1)  # (B, K, Cd)
    conv_out = torch.einsum("bkc,kc->bc", window, params["conv_w"].flip(0)) + params["conv_b"]
    conv_out = F.silu(conv_out)
    new_conv_cache = window[:, 1:]

    xs = conv_out[:, :di].reshape(-1, hs, p)  # (B, H, P)
    b_in = conv_out[:, di:di + n]
    c_in = conv_out[:, di + n:]
    dtv = F.softplus(dt[:, 0].float() + params["dt_bias"])  # (B, H)
    a = -torch.exp(params["a_log"])
    g = torch.exp(dtv * a)
    xdt = xs.float() * dtv[..., None]
    new_state = state * g[..., None, None] + torch.einsum("bhp,bn->bhpn", xdt, b_in.float())
    y = torch.einsum("bhpn,bn->bhp", new_state, c_in.float())
    y = y + params["d_skip"][None, :, None] * xs.float()
    y = y.reshape(-1, 1, di).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm(y, params["gate_norm"], cfg.norm_eps)
    return y @ params["out_proj"], new_state, new_conv_cache
