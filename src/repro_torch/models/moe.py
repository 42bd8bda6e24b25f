"""Mixture-of-Experts layer (capacity-based, GShard semantics) and MLA
(the port of ``repro.models.moe``).

Dispatch is sort-based, as in the reference: the (token, expert) pairs
are sorted by expert (stably), each pair's rank within its expert gives
its slot in that expert's capacity buffer, and the expert FFN runs as
batched (E, C, d) x (E, d, f) products. Pairs past capacity are dropped.

Every step is free of host synchronisation, so a decode step that holds
the layer is captured whole as a CUDA graph: the per-expert counts are a
``scatter_add_`` into E bins (the reference's ``bincount`` reads its
length back), dropped pairs are written to one spare row past the E x C
slots that nothing reads (the reference's ``mode="drop"`` scatter), and
masks are ``torch.where``, not boolean indexing. The combine is
deterministic: each token gathers its k expert rows and sums them in a
fixed order (the reference's scatter-add would be an atomic add on a
GPU, whose order, and so whose bf16 sum, changes from run to run).

``moe_groups > 1`` dispatches each token group on its own (the
reference vmaps over the groups); here the groups are a leading axis of
every dispatch tensor, and each expert's buffer holds its slots of every
group, (E, G * C, d), so the expert products stay one batched product.

deepseek-v2's MLA (multi-head latent attention) is here too: the
low-rank compressed KV (cached as ``c_kv`` plus one shared rope key),
its naive decompression, and the absorbed-matmul decode.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import draw, project, rmsnorm, swiglu, swiglu_init
from repro_torch.utils import prng


# ---------------------------------------------------------------------------
# Routed experts
# ---------------------------------------------------------------------------


def moe_init(key, cfg, dtype, *, partitionable: bool = True):
    d, e, fe = cfg.d_model, cfg.moe_num_experts, cfg.moe_d_ff
    ks = prng.split(key, 5, partitionable=partitionable)
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(fe)
    params = {
        "router": draw(ks[0], (d, e), s_in, torch.float32, partitionable=partitionable),
        "gate": draw(ks[1], (e, d, fe), s_in, dtype, partitionable=partitionable),
        "up": draw(ks[2], (e, d, fe), s_in, dtype, partitionable=partitionable),
        "down": draw(ks[3], (e, fe, d), s_out, dtype, partitionable=partitionable),
    }
    if cfg.moe_num_shared:
        params["shared"] = swiglu_init(ks[4], d, cfg.moe_num_shared * fe, dtype,
                                       partitionable=partitionable)
    return params


def moe_capacity(tokens: int, cfg) -> int:
    """Slots per expert for ``tokens`` tokens: the reference's expression,
    in its order, rounded up to a multiple of 8 (at least 8)."""
    cap = int(
        math.ceil(tokens * cfg.moe_top_k / cfg.moe_num_experts * cfg.capacity_factor)
    )
    return max(8, -(-cap // 8) * 8)


def moe_apply(params, x: torch.Tensor, cfg):
    """x: (B, S, d) -> (y (B, S, d), aux_loss: f32 scalar). With
    ``cfg.moe_groups > 1`` (and T = B * S a multiple of it) each group of
    T / G tokens is dispatched on its own, with its own capacity, and the
    aux loss is the groups' mean."""
    B, S, d = x.shape
    T = B * S
    G = cfg.moe_groups if cfg.moe_groups > 1 and T % cfg.moe_groups == 0 else 1
    y, aux = _moe_tokens(params, x.reshape(G, T // G, d), cfg, moe_capacity(T // G, cfg))
    y = y.reshape(B, S, d)
    aux = torch.mean(aux) if G > 1 else aux[0]
    if cfg.moe_num_shared:
        y = y + swiglu(params["shared"], x)
    return y, aux


def moe_routing(params, xf: torch.Tensor, cfg, C: int):
    """The router and the slots of token groups xf (G, T, d) with C slots
    an expert: returns (gate values (G, T, k) f32, renormalised over the
    k; expert ids (G, T, k) int64; each pair's slot in its expert's
    buffer (G, T, k), C where it is dropped; probabilities (G, T, E)
    f32)."""
    G, T, _ = xf.shape
    k, E = cfg.moe_top_k, cfg.moe_num_experts
    probs = torch.softmax(xf.float() @ params["router"], dim=-1)  # (G, T, E)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)  # (G, T, k)
    gate_vals = gate_vals / torch.clamp(torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)

    # each pair's rank within its expert, in the stable sort's order
    flat_e = expert_idx.reshape(G, T * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    e_sorted = torch.gather(flat_e, 1, order)
    counts = torch.zeros((G, E), dtype=torch.int64, device=xf.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=1) - counts
    rank_sorted = torch.arange(T * k, device=xf.device) - torch.gather(starts, 1, e_sorted)
    rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)  # back to pair order
    slot = torch.where(rank < C, rank, C).reshape(G, T, k)
    return gate_vals, expert_idx, slot, probs


def _moe_tokens(params, xf: torch.Tensor, cfg, C: int):
    """Dispatch, expert FFN and combine for token groups xf (G, T, d);
    returns (y (G, T, d), aux (G,) f32)."""
    G, T, d = xf.shape
    k, E = cfg.moe_top_k, cfg.moe_num_experts
    gate_vals, expert_idx, slot, probs = moe_routing(params, xf, cfg, C)

    # ---- load-balance auxiliary loss (Switch-style) -----------------------
    me = torch.mean(probs, dim=1)  # (G, E)
    ce = torch.mean(F.one_hot(expert_idx[..., 0], E).float(), dim=1)
    aux = E * torch.sum(me * ce, dim=-1) * cfg.router_aux_weight

    # ---- dispatch: row (e * G + g) * C + slot of an (E * G * C + 1, d)
    # buffer; dropped pairs all go to the spare last row ---------------------
    keep = slot < C
    g_idx = torch.arange(G, device=xf.device)[:, None, None]
    row = (expert_idx * G + g_idx) * C + slot
    spare = E * G * C
    dest = torch.where(keep, row, spare).reshape(-1)
    buf = torch.zeros((spare + 1, d), dtype=xf.dtype, device=xf.device)
    src = xf[:, :, None, :].expand(G, T, k, d).reshape(-1, d)
    buf.index_copy_(0, dest, src)

    # ---- expert FFN: one batched product over experts ---------------------
    h = buf[:spare].view(E, G * C, d)
    g = torch.bmm(h, params["gate"])
    u = torch.bmm(h, params["up"])
    out = torch.bmm(F.silu(g) * u, params["down"]).view(spare, d)

    # ---- combine: each token's k rows, summed in a fixed order -------------
    gathered = out[torch.where(keep, row, 0).reshape(-1)].view(G, T, k, d)
    gathered = torch.where(keep[..., None], gathered, 0.0)
    y = torch.sum(gathered * gate_vals[..., None].to(xf.dtype), dim=2)
    return y, aux


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, deepseek-v2)
# ---------------------------------------------------------------------------


def mla_init(key, cfg, dtype, *, partitionable: bool = True):
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    r, rr, qr = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.q_lora_rank
    ks = prng.split(key, 8, partitionable=partitionable)
    s = 1.0 / math.sqrt(d)
    dev = key.device

    def over(k, shape, div):  # normal(k, shape) / div, as the reference divides
        return (prng.normal(k, shape, partitionable=partitionable) / div).to(dtype)

    params = {
        "wdkv": draw(ks[0], (d, r), s, dtype, partitionable=partitionable),
        "wkr": draw(ks[1], (d, rr), s, dtype, partitionable=partitionable),
        "kv_norm": torch.ones((r,), dtype=dtype, device=dev),
        "wuk": over(ks[2], (r, H, hd), math.sqrt(r)),
        "wuv": over(ks[3], (r, H, hd), math.sqrt(r)),
        "wo": over(ks[4], (H, hd, d), math.sqrt(H * hd)),
    }
    if qr:
        params["wdq"] = draw(ks[5], (d, qr), s, dtype, partitionable=partitionable)
        params["q_norm"] = torch.ones((qr,), dtype=dtype, device=dev)
        params["wuq"] = over(ks[6], (qr, H, hd + rr), math.sqrt(qr))
    else:
        params["wq"] = draw(ks[7], (d, H, hd + rr), s, dtype, partitionable=partitionable)
    return params


def mla_project_q(params, x, cfg):
    """-> q_nope (B, S, H, hd), q_rope (B, S, H, rr)."""
    hd = cfg.head_dim
    if cfg.q_lora_rank:
        cq = rmsnorm(x @ params["wdq"], params["q_norm"], cfg.norm_eps)
        q = project(cq, params["wuq"])
    else:
        q = project(x, params["wq"])
    return q[..., :hd], q[..., hd:]


def mla_compress_kv(params, x, cfg):
    """-> c_kv (B, S, r) normalized, k_rope (B, S, rr)."""
    ckv = rmsnorm(x @ params["wdkv"], params["kv_norm"], cfg.norm_eps)
    return ckv, x @ params["wkr"]


def mla_decompress(params, ckv):
    """Naive path: -> k_nope (B, T, H, hd), v (B, T, H, hd)."""
    return project(ckv, params["wuk"]), project(ckv, params["wuv"])


def mla_decode_absorbed(params, q_nope, q_rope, ckv_cache, kr_cache, valid, cfg):
    """Absorbed-matmul MLA decode: W_uk folded into the query and W_uv into
    the output, so the cache is read as (T, r + rr) per token instead of
    decompressed to (T, H, hd).

        score_h(t) = (W_uk_h^T q_h) . c_t + q_rope_h . k_rope_t
        out_h      = W_uv_h^T (sum_t p_h(t) c_t)

    q_nope (B, 1, H, hd), q_rope (B, 1, H, rr) with rope applied,
    ckv_cache (B, T, r), kr_cache (B, T, rr), valid (B, T) bool. Returns
    (B, 1, H, hd) in the cache's dtype."""
    hd, rr = cfg.head_dim, cfg.rope_head_dim
    scale = 1.0 / math.sqrt(hd + rr)
    q_abs = torch.einsum("bhe,rhe->bhr", q_nope[:, 0], params["wuk"])  # (B, H, r)
    ckv = ckv_cache.float()
    scores = torch.einsum("bhr,btr->bht", q_abs.float(), ckv)
    scores = scores + torch.einsum("bhe,bte->bht", q_rope[:, 0].float(), kr_cache.float())
    scores = torch.where(valid[:, None, :], scores * scale, -1e30)
    p = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bht,btr->bhr", p, ckv)
    out = torch.einsum("bhr,rhe->bhe", ctx, params["wuv"].float())
    return out[:, None].to(ckv_cache.dtype)
