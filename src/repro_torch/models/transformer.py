"""Decoder blocks of the dense and SSM families (the port of
``repro.models.transformer``).

Each layer's parameters are a dict of tensors (``block_init``), held by
the model as its own module (``model.ModelParams``); the stack is a
Python loop over the layers, not the reference's ``lax.scan`` over
stacked (L, ...) leaves.

Only the ``dense`` and ``ssm`` branches are ported. The other families
raise ``NotImplementedError`` naming their ROADMAP.md item: MoE and MLA
(``models/moe.py``), the hybrid attention + SSM block, the audio
codebooks and the vlm's M-RoPE and vision prefix.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
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
PORTED_ARCHS = ("dense", "ssm")
# family -> (what is missing, its item in ROADMAP.md queue 1)
_DEFERRED = {
    "moe": ("MoE routing and MLA attention, models/moe.py", 13),
    "mla": ("MoE routing and MLA attention, models/moe.py", 13),
    "hybrid": ("the hybrid attention + SSM block", 14),
    "audio": ("the audio family's codebook embeddings and heads", 15),
    "vlm": ("the vlm family's M-RoPE and vision prefix", 16),
}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return TORCH_DTYPES[cfg.dtype]


def check_ported(cfg: ModelConfig) -> None:
    """Raise for a configuration this slice of the port does not cover."""
    family = cfg.arch_type
    if family in PORTED_ARCHS:
        family = ("mla" if cfg.use_mla else "audio" if cfg.num_codebooks
                  else "vlm" if cfg.mrope else None)
    if family is not None:
        what, item = _DEFERRED[family]
        raise NotImplementedError(
            f"{cfg.name}: {what} is not ported yet; see ROADMAP.md queue 1, item {item}"
        )


# ---------------------------------------------------------------------------
# Block init
# ---------------------------------------------------------------------------


def block_init(key, cfg: ModelConfig, *, partitionable: bool = True) -> Dict[str, Any]:
    check_ported(cfg)
    dt = torch_dtype(cfg)
    ks = prng.split(key, 6, partitionable=partitionable)
    if cfg.arch_type == "ssm":
        return {
            "norm": rmsnorm_init(cfg.d_model, dt, key.device),
            "ssm": ssm_lib.ssm_init(ks[0], cfg, dt, partitionable=partitionable),
        }
    return {
        "attn_norm": rmsnorm_init(cfg.d_model, dt, key.device),
        "mlp_norm": rmsnorm_init(cfg.d_model, dt, key.device),
        "attn": attention_init(ks[0], cfg, dt, partitionable=partitionable),
        "mlp": swiglu_init(ks[3], cfg.d_model, cfg.d_ff, dt, partitionable=partitionable),
    }


def param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """{dotted path: (shape, dtype)} of what ``embed_init`` and
    ``block_init`` draw, layer leaves under ``layers.<i>.``."""
    check_ported(cfg)
    dt, f32 = torch_dtype(cfg), torch.float32
    d, V = cfg.d_model, cfg.vocab_size
    top = {"final_norm": ((d,), dt), "embed": ((V, d), dt)}
    if not cfg.tie_embeddings:
        top["unembed"] = ((d, V), dt)
    if cfg.arch_type == "ssm":
        di, n, hs = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
        conv_dim = di + 2 * n
        layer = {"norm": ((d,), dt), "ssm.in_proj": ((d, 2 * di + 2 * n + hs), dt),
                 "ssm.conv_w": ((cfg.ssm_conv, conv_dim), dt), "ssm.conv_b": ((conv_dim,), dt),
                 "ssm.a_log": ((hs,), f32), "ssm.d_skip": ((hs,), f32),
                 "ssm.dt_bias": ((hs,), f32), "ssm.gate_norm": ((di,), dt),
                 "ssm.out_proj": ((di, d), dt)}
    else:
        H, KV, hd, f = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
        layer = {"attn_norm": ((d,), dt), "mlp_norm": ((d,), dt),
                 "attn.wq": ((d, H, hd), dt), "attn.wk": ((d, KV, hd), dt),
                 "attn.wv": ((d, KV, hd), dt), "attn.wo": ((H, hd, d), dt),
                 "mlp.gate": ((d, f), dt), "mlp.up": ((d, f), dt), "mlp.down": ((f, d), dt)}
    for i in range(cfg.num_layers):
        top.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    return top


# ---------------------------------------------------------------------------
# Attention paths (full-sequence and decode)
# ---------------------------------------------------------------------------


def attn_full(lp, x, cfg: ModelConfig, pos_info, window: int):
    """Full-sequence GQA attention; returns (out, (k, v)) for the cache."""
    q = project(x, lp["wq"])
    k = project(x, lp["wk"])
    v = project(x, lp["wv"])
    q = apply_rope(q, pos_info["positions"], cfg.rope_theta)
    k = apply_rope(k, pos_info["positions"], cfg.rope_theta)
    if cfg.use_pallas:
        from repro_torch.kernels import attention_pallas

        out = attention_pallas(q, k, v, window=window)
    else:
        out = blocked_causal_attention(q, k, v, window=window)
    return unproject(out, lp["wo"]), (k, v)


def attn_decode(lp, x, cfg: ModelConfig, cache_l, pos_info):
    """x: (B, 1, d). ``cache_l`` holds this layer's 'k' / 'v' ring
    buffers (B, T, KV, hd); the new key and value are written into them
    in place (the reference returns updated copies)."""
    pos = pos_info["pos"]  # (B,)
    q = apply_rope(project(x, lp["wq"]), pos[:, None], cfg.rope_theta)
    k_new = apply_rope(project(x, lp["wk"]), pos[:, None], cfg.rope_theta)
    v_new = project(x, lp["wv"])
    k_cache, v_cache = cache_l["k"], cache_l["v"]
    slot = pos % k_cache.shape[1]  # ring-buffer insert
    bidx = torch.arange(pos.shape[0], device=pos.device)
    k_cache[bidx, slot] = k_new[:, 0]
    v_cache[bidx, slot] = v_new[:, 0]
    out = decode_attention(q, k_cache, v_cache, pos_info["cache_positions"], pos,
                           window=cfg.sliding_window)
    return unproject(out, lp["wo"])


# ---------------------------------------------------------------------------
# Block apply
# ---------------------------------------------------------------------------


def block_apply_full(lp, x, cfg: ModelConfig, pos_info, collect_cache: bool):
    """Returns (x', cache_entry or None)."""
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
    attn_out, (k, v) = attn_full(lp["attn"], h, cfg, pos_info, cfg.sliding_window)
    if collect_cache:
        cache_entry.update({"k": k, "v": v})
    x = x + attn_out
    h2 = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
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
    x = x + attn_decode(lp["attn"], h, cfg, cache_l, pos_info)
    h2 = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    return x + swiglu(lp["mlp"], h2)


# ---------------------------------------------------------------------------
# Embeddings / heads
# ---------------------------------------------------------------------------


def embed_init(key, cfg: ModelConfig, *, partitionable: bool = True) -> Dict[str, Any]:
    check_ported(cfg)
    dt = torch_dtype(cfg)
    ks = prng.split(key, 4, partitionable=partitionable)
    p: Dict[str, Any] = {"final_norm": rmsnorm_init(cfg.d_model, dt, key.device)}
    p["embed"] = draw(ks[0], (cfg.vocab_size, cfg.d_model), 0.02, dt, partitionable=partitionable)
    if not cfg.tie_embeddings:
        p["unembed"] = draw(ks[1], (cfg.d_model, cfg.vocab_size), 0.02, dt,
                            partitionable=partitionable)
    return p


def embed_tokens(p, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return p["embed"][tokens.long()]


def logits_from_h(p, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(h, p["final_norm"], cfg.norm_eps)
    w = p["embed"].T if cfg.tie_embeddings else p["unembed"]
    return h @ w


# ---------------------------------------------------------------------------
# Position streams
# ---------------------------------------------------------------------------


def make_pos_info(cfg: ModelConfig, batch_size: int, seq_len: int, device):
    pos = torch.arange(seq_len, dtype=torch.int32, device=device).expand(batch_size, seq_len)
    return {"positions": pos}


# ---------------------------------------------------------------------------
# Training: the loss of a stack of model replicas
# ---------------------------------------------------------------------------


def check_trainable(cfg: ModelConfig) -> None:
    """Raise for a configuration the training path does not cover."""
    check_ported(cfg)
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
