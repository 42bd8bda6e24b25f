"""Serving loop: prefill + batched autoregressive generation (the port
of ``repro.launch.serve``).

One ``decode_step`` per token over a batch of streams, greedy or
temperature sampling, ring-buffer KV caches (sliding-window archs), and
the EOS freeze with a periodic early exit (off for codebook tokens, as in
the reference). On the card the decode step and its sampling replay as
one captured CUDA graph per token. A batch is what the model's prefill
takes (``models.model.batch_spec``): token ids (B, S), (B, S, nq) for
the audio family's codebooks, and the vlm's ``vision_embeds``.

  from repro_torch.launch.serve import generate
  tokens, stats = generate(model, params, prompts, max_new_tokens=64)

CLI demo (the card unless ``--device cpu``):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi_6b
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.kernels.capture import Captured
from repro_torch.models.model import Model
from repro_torch.utils import prng
from repro_torch.utils.tree import tree_clone, tree_leaves


def _sample(logits: torch.Tensor, key, temperature: float, partitionable: bool) -> torch.Tensor:
    """logits: (B, 1, V[, nq]) -> int32 token ids of the batch shape."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return prng.categorical(key, logits / temperature, partitionable=partitionable).to(torch.int32)


def expand_cache(model: Model, cache, total_len: int, out=None):
    """Re-home a prefill cache into a decode cache with headroom: into
    ``out`` (a decode cache of this batch and length, e.g. a
    :class:`DecodeGraph`'s static one, overwritten) or a new one.

    Each layer tensor is copied into the front of the decode one when the
    decode one is at least as long; otherwise the decode one stays zero
    and only the first positions are kept (the reference's rule, also for
    a sliding window shorter than the prompt)."""
    B = cache["next_pos"].shape[0]
    if out is None:
        out = model.init_cache(B, total_len, device=cache["next_pos"].device)
    else:  # as init_cache leaves a new one
        for t in out["layers"].values():
            t.zero_()
        if "cache_positions" in out:
            out["cache_positions"].fill_(-1)
    for name, src in cache["layers"].items():
        dst = out["layers"][name]
        if dst.shape == src.shape:
            dst.copy_(src)
        elif dst.dim() == src.dim() and dst.shape[:2] == src.shape[:2] and dst.shape[2] >= src.shape[2]:
            dst[:, :, :src.shape[2]].copy_(src)
    if "cache_positions" in cache:
        P = cache["cache_positions"].shape[1]
        T = out["cache_positions"].shape[1]
        if T >= P:
            out["cache_positions"][:, :P] = cache["cache_positions"]
        else:
            out["cache_positions"].copy_(cache["cache_positions"][:, :T])
    out["next_pos"].copy_(cache["next_pos"])
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


DECODE_GRAPHS = 4  # decode loops a model keeps, least recently used dropped first


class DecodeGraph:
    """The decode loop of one signature: the decode step plus sampling
    (greedy or temperature, the EOS freeze), over static tensors: the
    decode cache (``cache``, which :func:`expand_cache` fills from each
    prefill), the current token, the sampling key, a device-side step
    counter ``i``, the finished mask and the generated tokens. On CUDA
    the step is captured once as a CUDA graph and replayed per token;
    on the CPU it runs eagerly through the same buffers. The key of step
    ``i`` is ``fold_in(key, i)`` with ``i`` read on the device, the same
    key words as the eager loop's Python ``i``. The EOS check stays on
    the host, between replays."""

    def __init__(self, model: Model, batch_size: int, total_len: int, device,
                 max_new_tokens: int, temperature: float, eos_id: Optional[int],
                 partitionable: bool):
        self.temperature, self.eos_id, self.partitionable = temperature, eos_id, partitionable
        self.track_eos = _tracks_eos(model, eos_id)
        self.max_new_tokens = max_new_tokens
        B = batch_size
        per_token = _token_shape(model)  # () or (nq,)
        self.cache = model.init_cache(B, total_len, device=device)
        self.bufs = {
            "cache": self.cache,
            "tok": torch.empty((B, 1) + per_token, dtype=torch.int32, device=device),
            "key": torch.empty((2,), dtype=torch.int64, device=device),
            "i": torch.zeros((), dtype=torch.int64, device=device),
            "finished": torch.zeros((B,), dtype=torch.bool, device=device),
            "gen": torch.zeros((B, max_new_tokens) + per_token, dtype=torch.int32,
                               device=device),
        }
        self.graph = None
        self.capture_s = None  # host seconds of the warm-up and capture

    def _step(self, model: Model, params, b: dict) -> None:
        """One token on the buffers ``b``: the captured work."""
        logits, _ = model.decode_step(params, b["cache"], {"tokens": b["tok"]})
        b["key"].copy_(prng.fold_in(b["key"], b["i"]))
        nxt = _sample(logits, b["key"], self.temperature, self.partitionable).reshape(
            b["tok"].shape)
        if self.track_eos:
            b["finished"].logical_or_(b["tok"][:, 0] == self.eos_id)
            nxt = torch.where(b["finished"][:, None], torch.full_like(nxt, self.eos_id), nxt)
        b["tok"].copy_(nxt)
        b["i"].add_(1)
        b["gen"].index_copy_(1, b["i"].view(1), nxt)

    def run(self, model: Model, params, tok, key, eos_check_every: int):
        """Decode from ``cache`` (filled by :func:`expand_cache`, updated in
        place) with first token ``tok``; returns (the tokens so far,
        (B, 1 + steps), a copy; steps). ``params`` must be the tensors of
        the signature: a captured graph reads them at their addresses.
        The runner keeps no reference to the model or its parameters, so
        a model that holds it can be freed."""
        b = self.bufs
        b["tok"].copy_(tok)
        b["key"].copy_(key)
        b["i"].zero_()
        b["finished"].zero_()
        b["gen"][:, :1].copy_(tok)
        cuda = tok.is_cuda
        if cuda and self.graph is None:
            t0 = time.perf_counter()
            # the warm-up decodes one token on throwaway copies
            self.graph = Captured(lambda: self._step(model, params, b),
                                  warmup=lambda: self._step(model, params, tree_clone(b)))
            self.capture_s = time.perf_counter() - t0
        steps = 0
        for i in range(self.max_new_tokens - 1):
            if (self.track_eos and eos_check_every > 0 and i % eos_check_every == 0
                    and bool(b["finished"].all())):
                break  # every stream frozen: the rest would all be eos
            if cuda:
                self.graph.replay()
            else:
                self._step(model, params, b)
            steps += 1
        return b["gen"][:, :1 + steps].clone(), steps


def _decode_signature(params, cache, total_len, max_new_tokens, temperature, eos_id,
                      partitionable):
    """What a captured decode loop depends on: the parameters' addresses,
    shapes and dtypes (the graph reads them in place), the prefill
    cache's layout and the decode cache's length, the tokens it writes
    and how it samples."""
    weights = tuple((p.data_ptr(), tuple(p.shape), p.dtype) for p in params.parameters())
    layout = tuple((tuple(t.shape), t.dtype, t.device) for t in tree_leaves(cache))
    return (weights, layout, total_len, max_new_tokens, float(temperature), eos_id,
            partitionable)


def _decode_graph(model: Model, sig: tuple, make) -> DecodeGraph:
    """The model's decode loop for ``sig``, made by ``make()`` on a miss;
    the model keeps the ``DECODE_GRAPHS`` most recently used."""
    graphs = model.decode_graphs
    runner = graphs.pop(sig, None)
    if runner is None:
        while len(graphs) >= DECODE_GRAPHS:
            graphs.pop(next(iter(graphs)))
        runner = make()
    graphs[sig] = runner
    return runner


def _token_shape(model: Model) -> tuple:
    """The shape of one stream's token at one step: () or (nq,)."""
    nq = model.cfg.num_codebooks
    return (nq,) if nq else ()


def _tracks_eos(model: Model, eos_id: Optional[int]) -> bool:
    """Whether streams freeze at ``eos_id``: never for codebook tokens,
    as in the reference."""
    return eos_id is not None and not model.cfg.num_codebooks


def _prefill(model, params, batch, max_new_tokens, temperature, key, partitionable):
    """The prefill (eager), a new decode cache and the first token."""
    tokens = batch["tokens"]
    dev = tokens.device
    _sync(dev)
    t0 = time.perf_counter()
    last_logits, cache = model.prefill(params, batch)
    cache = expand_cache(model, cache, tokens.shape[1] + max_new_tokens + 1)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    tok = _sample(last_logits, key, temperature, partitionable).reshape(
        (tokens.shape[0], 1) + _token_shape(model))
    return cache, tok, t_prefill


def _finish(gen, decode_steps, t_prefill, t_decode, max_new_tokens, eos_id):
    B = gen.shape[0]
    if gen.shape[1] < max_new_tokens:  # early exit: pad the frozen tail
        pad = torch.full((B, max_new_tokens - gen.shape[1]) + tuple(gen.shape[2:]), eos_id,
                         dtype=gen.dtype, device=gen.device)
        gen = torch.cat([gen, pad], dim=1)
    stats = {
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_steps": decode_steps,
        "tokens_per_s": B * max(decode_steps, 1) / max(t_decode, 1e-9),
    }
    return gen, stats


@torch.no_grad()
def generate(
    model: Model,
    params,
    batch: dict,
    max_new_tokens: int,
    temperature: float = 0.0,
    eos_id: Optional[int] = None,
    key=None,
    eos_check_every: int = 8,
    *,
    partitionable: bool = True,
):
    """Prefill ``batch`` then decode up to ``max_new_tokens`` greedily or
    sampled; runs where ``batch["tokens"]`` and ``params`` lie. The
    decode cache holds ``batch["tokens"].shape[1] + max_new_tokens + 1``
    positions, as in the reference (for the vlm the text's length, not
    the vision prefix's: a prefix longer than ``max_new_tokens + 1``
    leaves no prefill cache, see :func:`expand_cache`).

    Returns (generated (B, max_new_tokens[, nq]) int32, stats). Streams
    that hit ``eos_id`` keep emitting it (finished mask; not for codebook
    tokens); the loop exits early once every stream is finished, checked
    on the host every ``eos_check_every`` steps, and the rest is padded
    with ``eos_id`` -- what the full loop would have emitted. ``stats``: ``prefill_s``,
    ``decode_s`` (host clock after a device synchronize),
    ``decode_steps`` (steps executed) and ``tokens_per_s``.

    The decode loop is the reference's jitted ``decode_step``: a
    :class:`DecodeGraph` per signature (the model keeps the
    ``DECODE_GRAPHS`` most recently used), captured as a CUDA graph at
    its first use and replayed per token (on the CPU it runs eagerly
    through the same buffers); each prefill's cache is written straight
    into its static decode cache. The prefill stays eager: it
    is one call per request batch, about 2x its tensor-core bound at
    yi-6b. :func:`generate_eager` is the same loop issued op by op."""
    tokens = batch["tokens"]
    dev = tokens.device
    if key is None:
        key = prng.key(0, device=dev)
    B, total = tokens.shape[0], tokens.shape[1] + max_new_tokens + 1
    _sync(dev)
    t0 = time.perf_counter()
    last_logits, cache = model.prefill(params, batch)
    sig = _decode_signature(params, cache, total, max_new_tokens, temperature, eos_id,
                            partitionable)
    runner = _decode_graph(model, sig, lambda: DecodeGraph(
        model, B, total, dev, max_new_tokens, temperature, eos_id, partitionable))
    expand_cache(model, cache, total, out=runner.cache)  # the prefill, straight into it
    del cache
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    tok = _sample(last_logits, key, temperature, partitionable).reshape(
        (B, 1) + _token_shape(model))
    t0 = time.perf_counter()
    gen, decode_steps = runner.run(model, params, tok, key, eos_check_every)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return _finish(gen, decode_steps, t_prefill, t_decode, max_new_tokens, eos_id)


@torch.no_grad()
def generate_eager(
    model: Model,
    params,
    batch: dict,
    max_new_tokens: int,
    temperature: float = 0.0,
    eos_id: Optional[int] = None,
    key=None,
    eos_check_every: int = 8,
    *,
    partitionable: bool = True,
):
    """:func:`generate` with every decode step issued op by op from
    Python: the oracle the captured loop is held to (tokens equal)."""
    tokens = batch["tokens"]
    dev = tokens.device
    if key is None:
        key = prng.key(0, device=dev)
    cache, tok, t_prefill = _prefill(model, params, batch, max_new_tokens, temperature, key,
                                     partitionable)
    B = tokens.shape[0]
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    track_eos = _tracks_eos(model, eos_id)
    outs = [tok]
    decode_steps = 0
    t0 = time.perf_counter()
    for i in range(max_new_tokens - 1):
        if track_eos and eos_check_every > 0 and i % eos_check_every == 0 and bool(finished.all()):
            break  # every stream frozen: the rest would all be eos
        logits, cache = model.decode_step(params, cache, {"tokens": tok})
        decode_steps += 1
        key = prng.fold_in(key, i)
        nxt = _sample(logits, key, temperature, partitionable).reshape(tok.shape)
        if track_eos:
            finished = finished | (tok[:, 0] == eos_id)
            nxt = torch.where(finished[:, None], torch.full_like(nxt, eos_id), nxt)
        tok = nxt
        outs.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return _finish(torch.cat(outs, dim=1), decode_steps, t_prefill, t_decode, max_new_tokens,
                   eos_id)


def main(argv=None):
    ap = argparse.ArgumentParser(description="prefill + greedy decode of a smoke config")
    ap.add_argument("--arch", default="yi_6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_smoke_config
    from repro_torch.data import random_batch_like
    from repro_torch.models.model import batch_spec
    from repro_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    model = Model(cfg)
    key = prng.key(0, device=dev)
    params = model.init(key, dev)
    batch = random_batch_like(batch_spec(cfg, args.batch, args.prompt_len, "prefill"), device=dev)
    batch["tokens"] = batch["tokens"] % cfg.vocab_size
    gen, stats = generate(model, params, batch, args.max_new, temperature=args.temperature)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"arch={cfg.name} on {where}: prefill {stats['prefill_s'] * 1e3:.0f} ms, "
          f"decode {stats['tokens_per_s']:.0f} tok/s")
    print("stream 0:", gen[0].reshape(-1)[:16].tolist())


if __name__ == "__main__":
    main()
