"""Serving loop: prefill + batched autoregressive generation (the port
of ``repro.launch.serve``).

One ``decode_step`` per token over a batch of streams, greedy or
temperature sampling, ring-buffer KV caches (sliding-window archs), and
the EOS freeze with a periodic early exit.

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

from repro_torch.models.model import Model
from repro_torch.utils import prng


def _sample(logits: torch.Tensor, key, temperature: float, partitionable: bool) -> torch.Tensor:
    """logits: (B, 1, V) -> int32 token ids (B, 1)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return prng.categorical(key, logits / temperature, partitionable=partitionable).to(torch.int32)


def expand_cache(model: Model, cache, total_len: int):
    """Re-home a prefill cache into a decode cache with headroom.

    Each layer tensor is copied into the front of the new one when the
    new one is at least as long; otherwise the new one stays zero and
    only the first positions are kept (the reference's rule, also for a
    sliding window shorter than the prompt)."""
    B = cache["next_pos"].shape[0]
    out = model.init_cache(B, total_len, device=cache["next_pos"].device)
    for name, src in cache["layers"].items():
        dst = out["layers"][name]
        if dst.shape == src.shape:
            out["layers"][name] = src
        elif dst.dim() == src.dim() and dst.shape[:2] == src.shape[:2] and dst.shape[2] >= src.shape[2]:
            dst[:, :, :src.shape[2]] = src
    if "cache_positions" in cache:
        P = cache["cache_positions"].shape[1]
        T = out["cache_positions"].shape[1]
        if T >= P:
            out["cache_positions"][:, :P] = cache["cache_positions"]
        else:
            out["cache_positions"] = cache["cache_positions"][:, :T].clone()
    out["next_pos"] = cache["next_pos"]
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
    sampled; runs where ``batch["tokens"]`` and ``params`` lie.

    Returns (generated (B, max_new_tokens) int32, stats). Streams that hit
    ``eos_id`` keep emitting it (finished mask); the loop exits early once
    every stream is finished, checked on the host every
    ``eos_check_every`` steps, and the rest is padded with ``eos_id`` --
    what the full loop would have emitted. ``stats``: ``prefill_s``,
    ``decode_s`` (host clock after a device synchronize),
    ``decode_steps`` (steps executed) and ``tokens_per_s``."""
    tokens = batch["tokens"]
    dev = tokens.device
    if key is None:
        key = prng.key(0, device=dev)
    prompt_len = tokens.shape[1]

    _sync(dev)
    t0 = time.perf_counter()
    last_logits, cache = model.prefill(params, batch)
    cache = expand_cache(model, cache, prompt_len + max_new_tokens + 1)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    B = tokens.shape[0]
    tok = _sample(last_logits, key, temperature, partitionable).reshape(B, 1)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    track_eos = eos_id is not None
    outs = [tok]
    decode_steps = 0
    t0 = time.perf_counter()
    for i in range(max_new_tokens - 1):
        if track_eos and eos_check_every > 0 and i % eos_check_every == 0 and bool(finished.all()):
            break  # every stream frozen: the rest would all be eos
        logits, cache = model.decode_step(params, cache, {"tokens": tok})
        decode_steps += 1
        key = prng.fold_in(key, i)
        nxt = _sample(logits, key, temperature, partitionable).reshape(B, 1)
        if track_eos:
            finished = finished | (tok[:, 0] == eos_id)
            nxt = torch.where(finished[:, None], torch.full_like(nxt, eos_id), nxt)
        tok = nxt
        outs.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    gen = torch.cat(outs, dim=1)
    if gen.shape[1] < max_new_tokens:  # early exit: pad the frozen tail
        pad = torch.full((B, max_new_tokens - gen.shape[1]), eos_id, dtype=gen.dtype, device=dev)
        gen = torch.cat([gen, pad], dim=1)
    stats = {
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_steps": decode_steps,
        "tokens_per_s": B * max(decode_steps, 1) / max(t_decode, 1e-9),
    }
    return gen, stats


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
