"""Synthetic batches (the port of ``repro.data.synthetic``).

Only ``random_batch_like`` is ported: dtype- and shape-correct random
batches for serving and tests, drawn with the port's threefry so a seed
gives the reference's batch. The learnable Markov task
(``make_markov_task``, ``sample_batch``) comes with the RW-SGD payload
(ROADMAP.md queue 1, item 8).
"""
from __future__ import annotations

from repro_torch.utils import prng


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
