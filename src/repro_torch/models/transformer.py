"""Decoder blocks of every architecture family (the port of
``repro.models.transformer``): dense, moe (routed experts, optionally
with deepseek-v2's MLA attention), ssm, hybrid (parallel attention +
SSM branches), audio (codebook embeddings and heads) and vlm (M-RoPE
and a vision-embedding prefix).

Each layer's parameters are a dict of tensors (``block_init``), held by
the model as its own module (``model.ModelParams``); the stack is a
Python loop over the layers, not the reference's ``lax.scan`` over
stacked (L, ...) leaves. Decode updates each layer's cache in place.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_mrope,
    apply_rope,
    attention_init,
    blocked_causal_attention,
    decode_attention,
    draw,
    project,
    rmsnorm,
    rmsnorm_init,
    swiglu,
    swiglu_init,
    unproject,
)
from repro_torch.utils import prng
from repro_torch.utils.tree import tree_leaves, tree_replace

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
VISION_EMBED_DIM = 1024  # the stub ViT's output width (the reference's)


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return TORCH_DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# Block init
# ---------------------------------------------------------------------------


def block_init(key, cfg: ModelConfig, *, partitionable: bool = True) -> Dict[str, Any]:
    dt = torch_dtype(cfg)
    dev = key.device
    ks = prng.split(key, 6, partitionable=partitionable)
    kw = dict(partitionable=partitionable)
    if cfg.arch_type == "ssm":
        return {
            "norm": rmsnorm_init(cfg.d_model, dt, dev),
            "ssm": ssm_lib.ssm_init(ks[0], cfg, dt, **kw),
        }
    p: Dict[str, Any] = {
        "attn_norm": rmsnorm_init(cfg.d_model, dt, dev),
        "mlp_norm": rmsnorm_init(cfg.d_model, dt, dev),
    }
    if cfg.use_mla:
        p["attn"] = moe_lib.mla_init(ks[0], cfg, dt, **kw)
    else:
        p["attn"] = attention_init(ks[0], cfg, dt, **kw)
    if cfg.arch_type == "hybrid":
        p["ssm"] = ssm_lib.ssm_init(ks[1], cfg, dt, **kw)
        p["attn_branch_norm"] = rmsnorm_init(cfg.d_model, dt, dev)
        p["ssm_branch_norm"] = rmsnorm_init(cfg.d_model, dt, dev)
    if cfg.arch_type == "moe":
        p["moe"] = moe_lib.moe_init(ks[2], cfg, dt, **kw)
    else:
        p["mlp"] = swiglu_init(ks[3], cfg.d_model, cfg.d_ff, dt, **kw)
    return p


def _ssm_shapes(cfg: ModelConfig, dt) -> Dict[str, tuple]:
    d, di, n, hs = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * n
    f32 = torch.float32
    return {"ssm.in_proj": ((d, 2 * di + 2 * n + hs), dt),
            "ssm.conv_w": ((cfg.ssm_conv, conv_dim), dt), "ssm.conv_b": ((conv_dim,), dt),
            "ssm.a_log": ((hs,), f32), "ssm.d_skip": ((hs,), f32),
            "ssm.dt_bias": ((hs,), f32), "ssm.gate_norm": ((di,), dt),
            "ssm.out_proj": ((di, d), dt)}


def _attn_shapes(cfg: ModelConfig, dt) -> Dict[str, tuple]:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if not cfg.use_mla:
        return {"attn.wq": ((d, H, hd), dt), "attn.wk": ((d, KV, hd), dt),
                "attn.wv": ((d, KV, hd), dt), "attn.wo": ((H, hd, d), dt)}
    r, rr, qr = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.q_lora_rank
    out = {"attn.wdkv": ((d, r), dt), "attn.wkr": ((d, rr), dt), "attn.kv_norm": ((r,), dt),
           "attn.wuk": ((r, H, hd), dt), "attn.wuv": ((r, H, hd), dt),
           "attn.wo": ((H, hd, d), dt)}
    if qr:
        out.update({"attn.wdq": ((d, qr), dt), "attn.q_norm": ((qr,), dt),
                    "attn.wuq": ((qr, H, hd + rr), dt)})
    else:
        out["attn.wq"] = ((d, H, hd + rr), dt)
    return out


def param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """{dotted path: (shape, dtype)} of what ``embed_init`` and
    ``block_init`` draw, layer leaves under ``layers.<i>.``."""
    dt = torch_dtype(cfg)
    d, V, nq = cfg.d_model, cfg.vocab_size, cfg.num_codebooks
    top = {"final_norm": ((d,), dt)}
    if nq:
        top.update({"embed": ((nq, V, d), dt), "unembed": ((nq, d, V), dt)})
    else:
        top["embed"] = ((V, d), dt)
        if not cfg.tie_embeddings:
            top["unembed"] = ((d, V), dt)
    if cfg.arch_type == "vlm":
        top["vision_proj"] = ((VISION_EMBED_DIM, d), dt)
    if cfg.arch_type == "ssm":
        layer = {"norm": ((d,), dt), **_ssm_shapes(cfg, dt)}
    else:
        layer = {"attn_norm": ((d,), dt), "mlp_norm": ((d,), dt), **_attn_shapes(cfg, dt)}
        if cfg.arch_type == "hybrid":
            layer.update({**_ssm_shapes(cfg, dt), "attn_branch_norm": ((d,), dt),
                          "ssm_branch_norm": ((d,), dt)})
        if cfg.arch_type == "moe":
            E, fe, fs = cfg.moe_num_experts, cfg.moe_d_ff, cfg.moe_num_shared * cfg.moe_d_ff
            layer.update({"moe.router": ((d, E), torch.float32), "moe.gate": ((E, d, fe), dt),
                          "moe.up": ((E, d, fe), dt), "moe.down": ((E, fe, d), dt)})
            if fs:
                layer.update({"moe.shared.gate": ((d, fs), dt), "moe.shared.up": ((d, fs), dt),
                              "moe.shared.down": ((fs, d), dt)})
        else:
            f = cfg.d_ff
            layer.update({"mlp.gate": ((d, f), dt), "mlp.up": ((d, f), dt),
                          "mlp.down": ((f, d), dt)})
    for i in range(cfg.num_layers):
        top.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    return top


# ---------------------------------------------------------------------------
# Attention paths (full-sequence and decode)
# ---------------------------------------------------------------------------


def _rope_q_k(cfg, q, k, pos_info):
    if cfg.mrope:
        p3 = pos_info["positions3"]
        return (apply_mrope(q, p3, cfg.rope_theta, cfg.mrope_sections),
                apply_mrope(k, p3, cfg.rope_theta, cfg.mrope_sections))
    pos = pos_info["positions"]
    return apply_rope(q, pos, cfg.rope_theta), apply_rope(k, pos, cfg.rope_theta)


def _vision_grid(cfg: ModelConfig) -> int:
    """The side of the vision prefix's square patch grid."""
    return max(int(math.ceil(math.sqrt(max(cfg.vision_tokens, 1)))), 1)


def attn_full(lp, x, cfg: ModelConfig, pos_info, window: int):
    """Full-sequence GQA attention; returns (out, (k, v)) for the cache."""
    q, k = _rope_q_k(cfg, project(x, lp["wq"]), project(x, lp["wk"]), pos_info)
    v = project(x, lp["wv"])
    if cfg.use_pallas:
        from repro_torch.kernels import attention_pallas

        out = attention_pallas(q, k, v, window=window)
    else:
        out = blocked_causal_attention(q, k, v, window=window)
    return unproject(out, lp["wo"]), (k, v)


def _ring_insert(cache: torch.Tensor, pos: torch.Tensor, new: torch.Tensor) -> None:
    """Write ``new`` (B, ...) at slot ``pos % T`` of each stream's ring
    buffer ``cache`` (B, T, ...), in place."""
    bidx = torch.arange(pos.shape[0], device=pos.device)
    cache[bidx, pos % cache.shape[1]] = new


def attn_decode(lp, x, cfg: ModelConfig, cache_l, pos_info):
    """x: (B, 1, d). ``cache_l`` holds this layer's 'k' / 'v' ring
    buffers (B, T, KV, hd); the new key and value are written into them
    in place (the reference returns updated copies)."""
    pos = pos_info["pos"]  # (B,)
    q, k_new = project(x, lp["wq"]), project(x, lp["wk"])
    if cfg.mrope:
        # decode runs in the text region: the three coordinate streams
        # advance together as i - vision_tokens + grid (make_pos_info)
        pos_txt = pos - cfg.vision_tokens + _vision_grid(cfg)
        p3 = pos_txt[None, :, None].expand(3, pos.shape[0], 1)
        q = apply_mrope(q, p3, cfg.rope_theta, cfg.mrope_sections)
        k_new = apply_mrope(k_new, p3, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta)
    k_cache, v_cache = cache_l["k"], cache_l["v"]
    _ring_insert(k_cache, pos, k_new[:, 0])
    _ring_insert(v_cache, pos, project(x, lp["wv"])[:, 0])
    out = decode_attention(q, k_cache, v_cache, pos_info["cache_positions"], pos,
                           window=cfg.sliding_window)
    return unproject(out, lp["wo"])


def mla_full(lp, x, cfg: ModelConfig, pos_info):
    """Full-sequence MLA (naive decompression, plain blocked attention with
    q / k heads of hd + rr and v heads of hd, whatever ``use_pallas``
    says, as in the reference); returns (out, (c_kv, k_rope)) for the
    cache."""
    q_nope, q_rope = moe_lib.mla_project_q(lp, x, cfg)
    ckv, kr = moe_lib.mla_compress_kv(lp, x, cfg)
    k_nope, v = moe_lib.mla_decompress(lp, ckv)
    pos = pos_info["positions"]
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    kr = apply_rope(kr[:, :, None, :], pos, cfg.rope_theta)  # (B, S, 1, rr)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, kr.expand(*k_nope.shape[:3], kr.shape[-1])], dim=-1)
    out = blocked_causal_attention(q, k, v, window=0)
    return unproject(out, lp["wo"]), (ckv, kr[:, :, 0, :])


def mla_decode(lp, x, cfg: ModelConfig, cache_l, pos_info):
    """One token of MLA against this layer's 'ckv' / 'krope' ring buffers
    (updated in place): the absorbed-matmul decode with
    ``cfg.mla_absorb``, else the naive decompression of the whole
    compressed cache."""
    pos = pos_info["pos"]
    q_nope, q_rope = moe_lib.mla_project_q(lp, x, cfg)
    ckv_new, kr_new = moe_lib.mla_compress_kv(lp, x, cfg)
    q_rope = apply_rope(q_rope, pos[:, None], cfg.rope_theta)
    kr_new = apply_rope(kr_new[:, :, None, :], pos[:, None], cfg.rope_theta)[:, :, 0]
    ckv, kr = cache_l["ckv"], cache_l["krope"]
    _ring_insert(ckv, pos, ckv_new[:, 0])
    _ring_insert(kr, pos, kr_new[:, 0])
    cache_pos = pos_info["cache_positions"]
    if cfg.mla_absorb:
        valid = (cache_pos >= 0) & (cache_pos <= pos[:, None])
        if cfg.sliding_window > 0:
            valid &= cache_pos > (pos[:, None] - cfg.sliding_window)
        out = moe_lib.mla_decode_absorbed(lp, q_nope, q_rope, ckv, kr, valid, cfg)
    else:
        k_nope, v = moe_lib.mla_decompress(lp, ckv)
        k = torch.cat([k_nope, kr[:, :, None, :].expand(*k_nope.shape[:3], kr.shape[-1])],
                      dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = decode_attention(q, k, v, cache_pos, pos, window=0)
    return unproject(out, lp["wo"])


# ---------------------------------------------------------------------------
# Block apply
# ---------------------------------------------------------------------------


def _mix(lp, attn_out, ssm_out, cfg):
    """The hybrid block's mixer: the mean of the two normalised branches."""
    return 0.5 * (rmsnorm(attn_out, lp["attn_branch_norm"], cfg.norm_eps)
                  + rmsnorm(ssm_out, lp["ssm_branch_norm"], cfg.norm_eps))


def block_apply_full(lp, x, cfg: ModelConfig, pos_info, collect_cache: bool):
    """Returns (x', cache_entry or None). (The MoE layer's aux loss is the
    training path's, which is not ported for this family.)"""
    cache_entry = {} if collect_cache else None
    if cfg.arch_type == "ssm":
        h = rmsnorm(x, lp["norm"], cfg.norm_eps)
        if collect_cache:
            y, sc = ssm_lib.ssm_forward_train(lp["ssm"], h, cfg, return_cache=True)
            cache_entry.update(sc)
        else:
            y = ssm_lib.ssm_forward_train(lp["ssm"], h, cfg)
        return x + y, cache_entry
    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    if cfg.use_mla:
        attn_out, (ckv, kr) = mla_full(lp["attn"], h, cfg, pos_info)
        if collect_cache:
            cache_entry.update({"ckv": ckv, "krope": kr})
    else:
        attn_out, (k, v) = attn_full(lp["attn"], h, cfg, pos_info, cfg.sliding_window)
        if collect_cache:
            cache_entry.update({"k": k, "v": v})
    if cfg.arch_type == "hybrid":
        if collect_cache:
            ssm_out, sc = ssm_lib.ssm_forward_train(lp["ssm"], h, cfg, return_cache=True)
            cache_entry.update(sc)
        else:
            ssm_out = ssm_lib.ssm_forward_train(lp["ssm"], h, cfg)
        x = x + _mix(lp, attn_out, ssm_out, cfg)
    else:
        x = x + attn_out
    h2 = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    if cfg.arch_type == "moe":
        return x + moe_lib.moe_apply(lp["moe"], h2, cfg)[0], cache_entry
    return x + swiglu(lp["mlp"], h2), cache_entry


def block_apply_decode(lp, x, cfg: ModelConfig, cache_l, pos_info):
    """One token through one layer. ``cache_l`` is this layer's slice of
    the cache, updated in place. Returns x'."""
    if cfg.arch_type == "ssm":
        h = rmsnorm(x, lp["norm"], cfg.norm_eps)
        y, st, cc = ssm_lib.ssm_decode_step(lp["ssm"], h, cache_l["state"], cache_l["conv"], cfg)
        cache_l["state"].copy_(st)
        cache_l["conv"].copy_(cc)
        return x + y
    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    if cfg.use_mla:
        attn_out = mla_decode(lp["attn"], h, cfg, cache_l, pos_info)
    else:
        attn_out = attn_decode(lp["attn"], h, cfg, cache_l, pos_info)
    if cfg.arch_type == "hybrid":
        y, st, cc = ssm_lib.ssm_decode_step(lp["ssm"], h, cache_l["state"], cache_l["conv"], cfg)
        cache_l["state"].copy_(st)
        cache_l["conv"].copy_(cc)
        x = x + _mix(lp, attn_out, y, cfg)
    else:
        x = x + attn_out
    h2 = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    if cfg.arch_type == "moe":
        return x + moe_lib.moe_apply(lp["moe"], h2, cfg)[0]
    return x + swiglu(lp["mlp"], h2)


# ---------------------------------------------------------------------------
# Embeddings / heads
# ---------------------------------------------------------------------------


def embed_init(key, cfg: ModelConfig, *, partitionable: bool = True) -> Dict[str, Any]:
    dt = torch_dtype(cfg)
    ks = prng.split(key, 4, partitionable=partitionable)
    kw = dict(partitionable=partitionable)
    d, V, nq = cfg.d_model, cfg.vocab_size, cfg.num_codebooks
    p: Dict[str, Any] = {"final_norm": rmsnorm_init(d, dt, key.device)}
    if nq:
        p["embed"] = draw(ks[0], (nq, V, d), 0.02, dt, **kw)
        p["unembed"] = draw(ks[1], (nq, d, V), 0.02, dt, **kw)
    else:
        p["embed"] = draw(ks[0], (V, d), 0.02, dt, **kw)
        if not cfg.tie_embeddings:
            p["unembed"] = draw(ks[1], (d, V), 0.02, dt, **kw)
    if cfg.arch_type == "vlm":
        p["vision_proj"] = (prng.normal(ks[2], (VISION_EMBED_DIM, d), **kw)
                            / math.sqrt(VISION_EMBED_DIM)).to(dt)
    return p


def embed_tokens(p, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Token ids (B, S) -> (B, S, d); with codebooks, ids (B, S, nq) and
    the sum of the codebooks' embeddings (MusicGen), in codebook order."""
    tokens = tokens.long()
    if cfg.num_codebooks:
        h = p["embed"][0][tokens[..., 0]]
        for q in range(1, cfg.num_codebooks):
            h = h + p["embed"][q][tokens[..., q]]
        return h
    return p["embed"][tokens]


def logits_from_h(p, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """(B, S, d) -> logits (B, S, V), or (B, S, nq, V) with codebooks."""
    h = rmsnorm(h, p["final_norm"], cfg.norm_eps)
    if cfg.num_codebooks:
        B, S, d = h.shape
        out = torch.matmul(h.reshape(1, B * S, d), p["unembed"])  # (nq, B * S, V)
        return out.permute(1, 0, 2).reshape(B, S, cfg.num_codebooks, -1)
    w = p["embed"].T if cfg.tie_embeddings else p["unembed"]
    return h @ w


# ---------------------------------------------------------------------------
# Position streams
# ---------------------------------------------------------------------------


def make_pos_info(cfg: ModelConfig, batch_size: int, seq_len: int, device):
    """{"positions": (B, S)}, and for M-RoPE "positions3": (3, B, S), the
    vision prefix on its (t 0, row, column) grid, the text after it with
    the three streams advancing together from the grid's side."""
    i = torch.arange(seq_len, dtype=torch.int32, device=device)
    info = {"positions": i.expand(batch_size, seq_len)}
    if cfg.mrope:
        tv, g = cfg.vision_tokens, _vision_grid(cfg)
        is_vis = i < tv
        txt = i - tv + g
        p3 = torch.stack([torch.where(is_vis, 0, txt), torch.where(is_vis, i // g, txt),
                          torch.where(is_vis, i % g, txt)]).to(torch.int32)  # (3, S)
        info["positions3"] = p3[:, None, :].expand(3, batch_size, seq_len)
    return info


# ---------------------------------------------------------------------------
# Training: the loss of a stack of model replicas
# ---------------------------------------------------------------------------


def check_trainable(cfg: ModelConfig) -> None:
    """Raise for a configuration the training path does not cover."""
    if cfg.use_pallas:
        raise NotImplementedError(
            f"{cfg.name}: use_pallas=True has no backward: flash_attention and "
            "ssd_intra_chunk are forward-only kernels (the reference's jax.grad "
            "through pallas_call fails too); train with use_pallas=False"
        )
    if cfg.arch_type != "dense":
        raise NotImplementedError(
            f"{cfg.name}: training the {cfg.arch_type} family is not ported yet (the RW-SGD "
            "payload trains dense models); see ROADMAP.md queue 1, item 12"
        )


def _replica_project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("rtd,rdhk->rthk")`` as one batched matrix product."""
    r, d, h, k = w.shape
    return (x @ w.reshape(r, d, h * k)).reshape(*x.shape[:-1], h, k)


def replica_losses(p, cfg: ModelConfig, tokens: torch.Tensor, labels: torch.Tensor):
    """Each replica's mean next-token cross-entropy, (R,) float32, in the
    reference's order: ``lse - gold`` in float32, averaged over the
    replica's (B, S) positions (``Model.loss``; a dense stack adds no
    auxiliary loss).

    ``p`` is a dict tree with a leading replica axis R on every leaf and
    the layer leaves stacked as in the reference, (R, L, ...) under
    ``p["layers"]``; ``tokens`` and ``labels`` are (R, B, S). Every
    product is batched over R. The embedding is read as a one-hot
    product, exact in any float dtype, so its gradient is a product too:
    an indexed read would backpropagate through an atomic scatter-add,
    whose order, and so whose float sum, changes from run to run on a
    GPU. ``gold`` is a gather whose backward scatters one value into
    each (position, label) element, which no two positions share, so it
    is exact."""
    check_trainable(cfg)
    R, B, S = tokens.shape
    T = B * S
    dt = torch_dtype(cfg)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    vocab = torch.arange(cfg.vocab_size, device=tokens.device)
    onehot = (tokens.reshape(R, T, 1) == vocab).to(dt)  # (R, T, V)
    x = onehot @ p["embed"]  # (R, T, d)
    # one row of positions, broadcast: the rotation is then computed once,
    # whatever the number of replicas
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    layers = p["layers"]
    per_layer = [leaf.unbind(1) for leaf in tree_leaves(layers)]  # one stack in backward
    for i in range(cfg.num_layers):
        lp = tree_replace(layers, [leaf[i] for leaf in per_layer])
        at = lp["attn"]
        h = rmsnorm(x, lp["attn_norm"][:, None], cfg.norm_eps)
        q = _replica_project(h, at["wq"]).reshape(R * B, S, H, hd)
        k = _replica_project(h, at["wk"]).reshape(R * B, S, KV, hd)
        v = _replica_project(h, at["wv"]).reshape(R * B, S, KV, hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        out = blocked_causal_attention(q, k, v, window=cfg.sliding_window)
        x = x + out.reshape(R, T, H * hd) @ at["wo"].reshape(R, H * hd, cfg.d_model)
        h2 = rmsnorm(x, lp["mlp_norm"][:, None], cfg.norm_eps)
        x = x + swiglu(lp["mlp"], h2)
    h = rmsnorm(x, p["final_norm"][:, None], cfg.norm_eps)
    w = p["embed"].transpose(1, 2) if cfg.tie_embeddings else p["unembed"]
    logits = (h @ w).to(torch.float32)  # (R, T, V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.reshape(R, T, 1).long())[..., 0]
    return torch.mean(lse - gold, dim=-1)
