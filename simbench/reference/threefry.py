"""A frozen copy of JAX's threefry-2x32 bit layout (``jax_threefry_partitionable``
on, the default from jax 0.5 on), written from JAX's ``jax/_src/prng.py``.

Two forms of the same block hash: on numpy ``uint32`` arrays (the
reference's walk-sized draws on the host), and on torch ``int64`` tensors
masked to 32 bits (the topology's node- and edge-sized draws, on whatever
device holds them). A key is an array whose last axis holds its two
words.

- ``fold_in(key, d)``: the block of counter ``(0, d)``;
- ``split(key, num)``: the blocks of counters ``(0, i)``, ``i < num``;
- random bits of shape S: word ``i`` is ``b1 ^ b2`` of the block of
  counter ``(0, i)``, over the flat index of S;
- uniform float32 on [0, 1): 23 bits under the exponent of 1.0, minus 1.
"""
from __future__ import annotations

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
MASK = 0xFFFFFFFF


def _hash_np(k1, k2, x0, x1):
    """The block hash on broadcastable uint32 arrays."""
    k1, k2, x0, x1 = (np.asarray(a, dtype=np.uint32) for a in (k1, k2, x0, x1))
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(_PARITY))
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)`` for any whole seed: (2,) uint32 words."""
    seed = int(seed)
    hi = 0 if -(2**31) <= seed < 2**31 else (seed >> 32) & MASK
    return np.array([hi, seed & MASK], dtype=np.uint32)


def fold_in(keys: np.ndarray, data) -> np.ndarray:
    """(..., 2) keys and data broadcast against their leading axes."""
    keys = np.asarray(keys, dtype=np.uint32)
    d = np.asarray(data).astype(np.int64) & MASK
    o0, o1 = _hash_np(keys[..., 0], keys[..., 1], 0, d.astype(np.uint32))
    o0, o1 = np.broadcast_arrays(o0, o1)
    return np.stack([o0, o1], axis=-1)


def split(keys: np.ndarray, num: int = 2) -> np.ndarray:
    """(..., 2) -> (..., num, 2)."""
    keys = np.asarray(keys, dtype=np.uint32)
    ctr = np.arange(num, dtype=np.uint32)
    o0, o1 = _hash_np(keys[..., 0, None], keys[..., 1, None], 0, ctr)
    return np.stack([o0, o1], axis=-1)


def bits_at(keys: np.ndarray, counters) -> np.ndarray:
    """The random words at flat ``counters`` of a draw from ``keys``
    (broadcast together): only the words that are needed, since each
    word of this layout hashes its own counter."""
    keys = np.asarray(keys, dtype=np.uint32)
    b1, b2 = _hash_np(keys[..., 0], keys[..., 1], 0, np.asarray(counters, dtype=np.uint32))
    return b1 ^ b2


def bits(keys: np.ndarray, shape) -> np.ndarray:
    """(..., 2) keys -> (..., *shape) random words."""
    shape = tuple(shape)
    size = int(np.prod(shape, dtype=np.int64))
    keys = np.asarray(keys, dtype=np.uint32)
    out = bits_at(keys[..., None, :], np.arange(size, dtype=np.uint32))
    return out.reshape(keys.shape[:-1] + shape)


def to_uniform(words: np.ndarray) -> np.ndarray:
    """uint32 words -> float32 on [0, 1)."""
    f = ((words >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    return f - np.float32(1.0)


def randint(keys: np.ndarray, shape, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, 0, maxval)`` (int32): two draws,
    combined modulo the span with uint32 wraparound."""
    sub = split(keys, 2)
    hi = bits(sub[..., 0, :], shape)
    lo = bits(sub[..., 1, :], shape)
    span = int(maxval)
    mult = (2**16) % span
    mult = (mult * mult) % span
    with np.errstate(over="ignore"):
        off = (hi % np.uint32(span)) * np.uint32(mult) + (lo % np.uint32(span))
    return (off % np.uint32(span)).astype(np.int32)


# -- the same hash on torch int64 tensors ------------------------------------


def _hash_torch(k1, k2, x0, x1):
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) & MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def uniform_torch(key_words, shape, device):
    """Uniform float32 of ``shape`` from one key (two Python ints), drawn
    on ``device`` with torch: the topology's node and edge draws."""
    import torch

    size = 1
    for s in shape:
        size *= s
    ctr = torch.arange(size, dtype=torch.int64, device=device)
    k1, k2 = (int(w) for w in key_words)
    b1, b2 = _hash_torch(torch.full_like(ctr, k1), torch.full_like(ctr, k2),
                         torch.zeros_like(ctr), ctr)
    words = b1 ^ b2
    f = ((words >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return f.reshape(tuple(shape))
