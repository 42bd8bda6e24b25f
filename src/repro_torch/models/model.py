"""Public model API for serving: init / forward / prefill / decode (the
port of ``repro.models.model``).

A ``Model`` wraps a ``ModelConfig``; parameters live in a
``ModelParams`` module (the top-level leaves, and one module per layer in
an ``nn.ModuleList``), passed to each method as in the reference:

  init(key, device)                  -> params
  forward_logits(params, batch)      -> logits (B, S, V)
  prefill(params, batch)             -> (last_logits, cache)
  decode_step(params, cache, batch)  -> (logits, cache)

Batches are dicts of tensors (see ``batch_spec``). Caches keep the
reference's stacked layout ((L, B, T, ...) tensors under
``cache["layers"]``) and are updated in place by ``decode_step`` (the
reference returns new arrays; in place saves a copy of the cache per
token). ``loss`` (training) is not ported yet: it comes with the RW-SGD
payload (ROADMAP.md queue 1, item 8).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    block_apply_decode,
    block_apply_full,
    block_init,
    check_ported,
    embed_init,
    embed_tokens,
    logits_from_h,
    make_pos_info,
    torch_dtype,
)
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device

class ParamTree(nn.Module):
    """A nested dict of tensors as a module: dict values become
    submodules, tensors become parameters without gradients (this slice
    serves). Read with ``tree["name"]``, as the reference reads its dict
    pytrees."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)


class ModelParams(ParamTree):
    """The top-level leaves (embed, unembed, final_norm) and
    ``layers``, one ``ParamTree`` per layer."""

    def __init__(self, top: Dict[str, Any], layers):
        super().__init__(top)
        self.layers = nn.ModuleList([ParamTree(lp) for lp in layers])


class TensorSpec(NamedTuple):
    """Shape and dtype of a batch entry (the reference's ShapeDtypeStruct)."""

    shape: tuple
    dtype: torch.dtype


class Model:
    def __init__(self, cfg: ModelConfig):
        check_ported(cfg)
        self.cfg = cfg
        # launch.serve.generate's captured decode loops, one per signature
        # (the most recently used few, launch.serve.DECODE_GRAPHS)
        self.decode_graphs: Dict[tuple, Any] = {}

    # ------------------------------------------------------------------ init
    @torch.no_grad()
    def init(self, key, device=None, *, partitionable: bool = True) -> ModelParams:
        """Random weights from ``key`` (``prng.key(seed)``) in the
        reference's key order: ``split(key)`` into the embedding's and the
        layers' keys, then ``split(k_layers, L)``, one key per layer (what
        the reference's vmapped draw does). Drawn one leaf and one layer
        at a time on ``device`` (cuda unless given)."""
        cfg = self.cfg
        dev = resolve_device(device)
        key = key.to(dev)
        k_emb, k_layers = prng.split(key, 2, partitionable=partitionable)
        layer_keys = prng.split(k_layers, cfg.num_layers, partitionable=partitionable)
        layers = [block_init(layer_keys[i], cfg, partitionable=partitionable)
                  for i in range(cfg.num_layers)]
        return ModelParams(embed_init(k_emb, cfg, partitionable=partitionable), layers)

    # --------------------------------------------------------------- forward
    def _stack_full(self, params, h, pos_info, collect_cache: bool):
        caches = []
        for lp in params.layers:
            h, entry = block_apply_full(lp, h, self.cfg, pos_info, collect_cache)
            caches.append(entry)
        if not collect_cache:
            return h, None
        return h, {k: torch.stack([c[k] for c in caches]) for k in caches[0]}

    @torch.no_grad()
    def forward_logits(self, params, batch) -> torch.Tensor:
        h = embed_tokens(params, self.cfg, batch["tokens"])
        pos_info = make_pos_info(self.cfg, h.shape[0], h.shape[1], h.device)
        h, _ = self._stack_full(params, h, pos_info, collect_cache=False)
        return logits_from_h(params, self.cfg, h)

    @torch.no_grad()
    def prefill(self, params, batch):
        """Full-sequence forward; returns (last-position logits
        (B, 1, V), cache)."""
        cfg = self.cfg
        h = embed_tokens(params, cfg, batch["tokens"])
        B, S = h.shape[0], h.shape[1]
        pos_info = make_pos_info(cfg, B, S, h.device)
        h, layers = self._stack_full(params, h, pos_info, collect_cache=True)
        last = logits_from_h(params, cfg, h[:, -1:])
        cache: Dict[str, Any] = {"layers": layers}
        if cfg.arch_type != "ssm":
            cache["cache_positions"] = (
                torch.arange(S, dtype=torch.int32, device=h.device).expand(B, S).clone()
            )
        cache["next_pos"] = torch.full((B,), S, dtype=torch.int32, device=h.device)
        return last, cache

    # ----------------------------------------------------------------- decode
    def cache_len(self, seq_len: int) -> int:
        w = self.cfg.sliding_window
        return min(seq_len, w) if w > 0 else seq_len

    def init_cache(self, batch_size: int, seq_len: int, device=None):
        """Zeroed decode cache sized for a context of ``seq_len`` tokens,
        on ``device`` (cuda unless given)."""
        cfg = self.cfg
        dev = resolve_device(device)
        dt = torch_dtype(cfg)
        T = self.cache_len(seq_len)
        L, B = cfg.num_layers, batch_size
        layers: Dict[str, Any] = {}
        if cfg.arch_type == "ssm":
            hs, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
            conv_dim = cfg.ssm_d_inner + 2 * n
            layers["state"] = torch.zeros((L, B, hs, p, n), dtype=torch.float32, device=dev)
            layers["conv"] = torch.zeros((L, B, cfg.ssm_conv - 1, conv_dim), dtype=dt, device=dev)
        else:
            kv, hd = cfg.num_kv_heads, cfg.head_dim
            layers["k"] = torch.zeros((L, B, T, kv, hd), dtype=dt, device=dev)
            layers["v"] = torch.zeros((L, B, T, kv, hd), dtype=dt, device=dev)
        cache: Dict[str, Any] = {
            "layers": layers, "next_pos": torch.zeros((B,), dtype=torch.int32, device=dev)
        }
        if cfg.arch_type != "ssm":
            cache["cache_positions"] = torch.full((B, T), -1, dtype=torch.int32, device=dev)
        return cache

    @torch.no_grad()
    def decode_step(self, params, cache, batch):
        """One-token decode. batch: {'tokens': (B, 1)}; returns (logits
        (B, 1, V), cache), the cache updated in place (``next_pos``
        included). It issues no host synchronisation, so
        ``launch.serve.generate`` captures it as a CUDA graph."""
        cfg = self.cfg
        pos = cache["next_pos"]  # (B,)
        h = embed_tokens(params, cfg, batch["tokens"])
        pos_info: Dict[str, Any] = {"pos": pos}
        if cfg.arch_type != "ssm":
            cache_positions = cache["cache_positions"]
            slot = pos % cache_positions.shape[1]
            bidx = torch.arange(pos.shape[0], device=pos.device)
            cache_positions[bidx, slot] = pos
            pos_info["cache_positions"] = cache_positions
        layers = cache["layers"]
        for i, lp in enumerate(params.layers):
            h = block_apply_decode(lp, h, cfg, {k: t[i] for k, t in layers.items()}, pos_info)
        pos.add_(1)  # in place: a captured step keeps its cache at fixed addresses
        return logits_from_h(params, cfg, h), cache


# ---------------------------------------------------------------------------
# Batch specs
# ---------------------------------------------------------------------------


def batch_spec(cfg: ModelConfig, batch_size: int, seq_len: int, mode: str):
    """``TensorSpec`` dict for ``mode`` in {'train', 'prefill', 'decode'}
    (the dense and ssm families: token ids only)."""
    check_ported(cfg)
    if mode in ("train", "prefill"):
        toks = TensorSpec((batch_size, seq_len), torch.int32)
        return {"tokens": toks, "labels": toks} if mode == "train" else {"tokens": toks}
    if mode == "decode":
        return {"tokens": TensorSpec((batch_size, 1), torch.int32)}
    raise ValueError(mode)
