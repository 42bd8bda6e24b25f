"""Synthetic data (the port of ``repro.data.synthetic``).

Two roles, as in the reference:
  1. ``random_batch_like``: dtype- and shape-correct random batches for
     serving and tests;
  2. a learnable task for decentralized training (the RW-SGD payload,
     ``repro_torch.optim.rw_sgd``): sequences from a fixed random
     low-rank first-order Markov chain over the vocabulary. Each graph
     node owns a shard: ``sample_batch`` keys its draw by the node id, so
     a walk trains on "the local data of the visited node".

Every draw is the port's threefry (``utils.prng``), so a key gives the
reference's bits: ``sample_batch`` is bitwise the reference's tokens
given the same task logits.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device


class SyntheticTask(NamedTuple):
    logits: torch.Tensor  # (V, V) float32 unnormalized row transition logits
    entropy: float  # conditional entropy of the chain (nats/token)


def make_markov_task(vocab: int, key=None, temperature: float = 2.0, rank: int = 16, *,
                     partitionable: bool = True, device=None) -> SyntheticTask:
    """Low-rank chain: logits = U V^T / sqrt(rank) * temperature, so the
    transition structure is learnable from ~rank * vocab observations.
    ``key`` defaults to ``key(1234)``; the logits land on ``device``
    (cuda unless given) or on ``key``'s device."""
    if key is None:
        key = prng.key(1234, device=resolve_device(device))
    elif device is not None:
        key = key.to(device)
    k1, k2 = prng.split(key, 2, partitionable=partitionable)
    u = prng.normal(k1, (vocab, rank), partitionable=partitionable)
    v = prng.normal(k2, (rank, vocab), partitionable=partitionable)
    g = u @ v / math.sqrt(rank) * temperature
    probs = torch.softmax(g, dim=-1)
    # the stationary distribution by power iteration
    pi = torch.full((vocab,), 1.0 / vocab, dtype=torch.float32, device=g.device)
    for _ in range(64):
        pi = pi @ probs
    h_cond = -torch.sum(pi[:, None] * probs * torch.log(probs + 1e-12))
    return SyntheticTask(logits=g, entropy=float(h_cond))


def sample_batch(task: SyntheticTask, key, batch: int, seq: int, node_id=0, *,
                 partitionable: bool = True):
    """Tokens and next-token labels from the chain, deterministic per
    (key, node_id): ``fold_in(key, node_id)``, split into the start key
    and the sequence key, ``randint`` start tokens, ``split(kseq, seq)``
    and one ``categorical`` per position over ``task.logits[tok]``, as
    the reference draws them. ``key`` is (..., 2) and ``node_id`` an int
    or an integer tensor broadcastable against the key's leading axes
    (the payload passes ``walks.pos``, one node shard per slot); returns
    {"tokens", "labels"}: int32 (*lead, batch, seq)."""
    logits = task.logits
    k = prng.fold_in(key, node_id)
    ks = prng.split(k, 2, partitionable=partitionable)
    k0, kseq = ks[..., 0, :], ks[..., 1, :]
    vocab = logits.shape[0]
    start = prng.randint(k0, (batch,), 0, vocab, partitionable=partitionable)
    keys = prng.split(kseq, seq, partitionable=partitionable)  # (*lead, seq, 2)
    # ``prng.categorical``'s draw (Gumbel noise in the logits' shape, the
    # argmax of noise + logits) with every position's noise drawn at once
    # (its float transform one index of the first axis at a time, so a
    # payload's trajectory rows stay independent); the argmax runs
    # position by position, since each row of logits is the previous
    # token's
    gumbel = prng.gumbel_rows if keys.dim() > 2 else prng.gumbel
    noise = gumbel(keys, (batch, vocab), partitionable=partitionable)
    tok = start.long()
    toks = [tok]
    for p in range(seq):
        tok = torch.argmax(noise[..., p, :, :] + logits[tok], dim=-1)
        toks.append(tok)
    full = torch.stack(toks, dim=-1).to(torch.int32)  # (*lead, batch, seq + 1)
    return {"tokens": full[..., :-1], "labels": full[..., 1:]}


def node_batches(task: SyntheticTask, key, n_nodes: int, batch: int, seq: int, *,
                 partitionable: bool = True):
    """(n_nodes, batch, seq) batches, one shard per graph node."""
    ids = torch.arange(n_nodes, device=task.logits.device)
    return sample_batch(task, key, batch, seq, ids, partitionable=partitionable)


def random_batch_like(spec, key=None, *, device=None, partitionable: bool = True):
    """A random batch matching a ``batch_spec`` dict: entry ``i`` (in
    sorted name order) draws from ``fold_in(key, i)``, integers uniform
    on [0, 64), floats standard normal. ``key`` defaults to
    ``key(0)``; the batch lands on ``key``'s device, or on ``device``."""
    if key is None:
        key = prng.key(0, device=device)
    elif device is not None:
        key = key.to(device)
    out = {}
    for i, (name, s) in enumerate(sorted(spec.items())):
        k = prng.fold_in(key, i)
        if s.dtype.is_floating_point:
            out[name] = prng.normal(k, s.shape, partitionable=partitionable).to(s.dtype)
        else:
            out[name] = prng.randint(k, s.shape, 0, 64, partitionable=partitionable).to(s.dtype)
    return out
