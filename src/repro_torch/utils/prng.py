"""Bit-exact threefry2x32 in PyTorch: the ``jax.random`` surface the
simulator draws from.

Every draw of a round is keyed by ``fold_in_time(key, t, tag)`` in the
reference, so a trajectory can only be compared with it if this module
produces JAX's bits. A key is a tensor whose last axis holds the two
uint32 words of a threefry key; leading axes are batch axes (one key per
trajectory, stream, ...). Words are carried in ``torch.int64`` and
masked to 32 bits after every add and shift: torch has no ``<<`` for
``uint32`` on the CPU, and int64 holds every intermediate exactly.

Two bit layouts exist, as in JAX (``jax_threefry_partitionable``):

- partitionable (``partitionable=True``, the default from jax 0.5 on):
  ``split`` hashes the counter pair ``(0, i)`` and random bits of shape S
  are ``b1 ^ b2`` of the hash of ``(0, iota(S))``;
- original (``partitionable=False``, the default of jax 0.4.x): ``split``
  and the random bits hash ``iota(2 * num)`` / ``iota(size)`` cut in two
  halves.

``fold_in`` is the same in both. Mirrors ``jax/_src/prng.py``
(``threefry_2x32``, ``_threefry_seed``, ``_threefry_split``,
``_threefry_fold_in``, ``_threefry_random_bits_*``) and
``jax/_src/random.py`` (``_uniform``, ``_randint``).
"""
from __future__ import annotations

import torch

from repro_torch.utils import trace

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(k1, k2, x0, x1):
    """The threefry2x32 block hash on broadcastable int64 word tensors;
    returns the two output words (int64 holding uint32 values). Its work
    is the ``threefry`` stage of whatever stage calls it, and it counts
    its blocks (the broadcast output's elements) as ``threefry_blocks``."""
    with trace.stage(trace.THREEFRY):
        ks = (k1, k2, k1 ^ k2 ^ _PARITY)
        x0 = (x0 + ks[0]) & MASK
        x1 = (x1 + ks[1]) & MASK
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = (x0 + x1) & MASK
                x1 = _rotl(x1, r) ^ x0
            x0 = (x0 + ks[(i + 1) % 3]) & MASK
            x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
        trace.count("threefry_blocks", x0.numel())
    return x0, x1


def _words(keys: torch.Tensor, extra_dims: int):
    """The two key words, with ``extra_dims`` trailing singleton axes so
    they broadcast against a counter array of that rank."""
    shape = keys.shape[:-1] + (1,) * extra_dims
    keys = keys.contiguous()  # outputs then take the standard layout
    return keys[..., 0].reshape(shape), keys[..., 1].reshape(shape)


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)`` as its (2,) word pair."""
    seed = int(seed)
    hi = (seed >> 32) & MASK if not -(2**31) <= seed < 2**31 else 0
    return torch.tensor([hi, seed & MASK], dtype=torch.int64, device=device)


def _hash_flat(keys: torch.Tensor, count: int) -> torch.Tensor:
    """``threefry_2x32(key, iota(count))`` (the original layout's counter
    hash): the flat counter is cut into two halves (zero-padded when odd)
    that form the two input words. Returns (..., count) words."""
    half = (count + 1) // 2
    iota = torch.arange(2 * half, dtype=torch.int64, device=keys.device)
    iota[count:] = 0
    k1, k2 = _words(keys, 1)
    o0, o1 = threefry2x32(k1, k2, iota[:half], iota[half:])
    return torch.cat([o0, o1], dim=-1)[..., :count]


def split(keys: torch.Tensor, num: int = 2, *, partitionable: bool = True):
    """``jax.random.split``: (..., 2) keys -> (..., num, 2)."""
    if partitionable:
        lo = torch.arange(num, dtype=torch.int64, device=keys.device)
        k1, k2 = _words(keys, 1)
        b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
        return torch.stack([b1, b2], dim=-1)
    flat = _hash_flat(keys, 2 * num)
    return flat.reshape(keys.shape[:-1] + (num, 2))


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hash the counter pair ``(0, data)``.
    ``data`` is an int or an integer tensor broadcastable against the
    keys' batch axes (one datum per key)."""
    keys = keys.contiguous()
    k1, k2 = keys[..., 0], keys[..., 1]
    if isinstance(data, int):  # filled on the device: no host-to-device copy, no sync
        d = torch.full((), data & MASK, dtype=torch.int64, device=keys.device)
    else:
        d = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & MASK
    o0, o1 = threefry2x32(k1, k2, torch.zeros_like(d), d)
    o0, o1 = torch.broadcast_tensors(o0, o1)
    return torch.stack([o0, o1], dim=-1)


def fold_in_time(keys: torch.Tensor, t, tag=0) -> torch.Tensor:
    """``utils/prng.py::fold_in_time``: fold the component tag, then the
    step counter. ``tag`` may be a tensor of tags, drawing several
    streams' keys in one pass (broadcast against the keys' batch axes)."""
    return fold_in(fold_in(keys, tag), t)


def random_bits(keys: torch.Tensor, shape, *, partitionable: bool = True):
    """32-bit random words: (..., 2) keys -> (..., *shape) int64."""
    shape = tuple(shape)
    size = 1
    for s in shape:
        size *= s
    if partitionable:
        lo = torch.arange(size, dtype=torch.int64, device=keys.device)
        k1, k2 = _words(keys, 1)
        b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
        bits = b1 ^ b2
    else:
        bits = _hash_flat(keys, size)
    return bits.reshape(keys.shape[:-1] + shape)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """``_uniform``'s float32 construction: 23 mantissa bits under the
    exponent of 1.0, reinterpreted as float32, minus 1 -> [0, 1)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(keys: torch.Tensor, shape, *, partitionable: bool = True):
    """``jax.random.uniform(key, shape)`` (float32 on [0, 1))."""
    return bits_to_uniform(random_bits(keys, shape, partitionable=partitionable))


def randint(
    keys: torch.Tensor, shape, minval: int, maxval: int, *,
    partitionable: bool = True,
) -> torch.Tensor:
    """``jax.random.randint`` for int32 with static bounds: two 32-bit
    draws combined modulo the span, with JAX's uint32 wraparound."""
    sub = split(keys, 2, partitionable=partitionable)
    hi = random_bits(sub[..., 0, :], shape, partitionable=partitionable)
    lo = random_bits(sub[..., 1, :], shape, partitionable=partitionable)
    span = (maxval - minval) & MASK if maxval > minval else 1
    mult = (2**16) % span
    mult = ((mult * mult) & MASK) % span
    off = ((((hi % span) * mult) & MASK) + (lo % span)) & MASK
    return (minval + off % span).to(torch.int32)



def _uniform_range(keys, shape, minval: float, maxval: float, *, partitionable: bool):
    """``_uniform`` with float32 bounds: ``f * (maxval - minval) + minval``
    over the [0, 1) floats, clipped below at ``minval`` (JAX's order of
    float32 operations)."""
    return _scale(uniform(keys, shape, partitionable=partitionable), minval, maxval)


def _scale(f: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """The bounds are rounded to float32 and their difference taken in
    float32 on the host (exact as Python floats), so no host-to-device
    copy lies on a captured sampling step."""
    lo = torch.tensor(minval, dtype=torch.float32)
    span = float(torch.tensor(maxval, dtype=torch.float32) - lo)
    return torch.clamp_min(f * span + float(lo), float(lo))


# XLA's float32 erf_inv (``ErfInv32`` in xla/client/lib/math.cc): Giles'
# degree-9 polynomials in w = -log1p(-x^2), one for w < 5 and one above.
# torch.erfinv is a different (more accurate) approximation that differs
# from it by up to some 60 ulp; this one stays within 2 ulp of XLA's.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, XLA's formula (see above)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, c_lt, c_ge) + p * w
    return torch.where(x.abs() == 1, x * torch.finfo(torch.float32).max, p * x)


# jax's ``_normal_real`` draws on [nextafter(-1, 0), 1) so that erf_inv
# stays finite
_NORMAL_LO = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
_SQRT2 = float(torch.tensor(2.0, dtype=torch.float32).sqrt())
# the partitionable layout hashes each element's own counter, so a large
# draw from one key is made in pieces of this many elements (bounding the
# int64 temporaries of the hash)
_CHUNK = 1 << 24


def normal(keys: torch.Tensor, shape, *, partitionable: bool = True) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (float32): ``sqrt(2) *
    erf_inv(u)`` with ``u`` uniform on ``[nextafter(-1, 0), 1)``, as
    ``jax._src.random._normal_real``. The bits are JAX's; values agree
    with it within a few float32 ulp (3 measured: ``log1p`` and the
    products round differently in the last bit)."""
    shape = tuple(shape)
    size = 1
    for s in shape:
        size *= s
    if keys.dim() != 1 or not partitionable or size <= _CHUNK:
        u = _uniform_range(keys, shape, _NORMAL_LO, 1.0, partitionable=partitionable)
        return erf_inv(u) * _SQRT2
    out = torch.empty(size, dtype=torch.float32, device=keys.device)
    k1, k2 = keys[0], keys[1]
    for start in range(0, size, _CHUNK):
        ctr = torch.arange(start, min(start + _CHUNK, size), dtype=torch.int64, device=keys.device)
        b1, b2 = threefry2x32(k1, k2, torch.zeros_like(ctr), ctr)
        u = _scale(bits_to_uniform(b1 ^ b2), _NORMAL_LO, 1.0)
        out[start:start + ctr.numel()] = erf_inv(u) * _SQRT2
        del ctr, b1, b2, u
    return out.reshape(shape)


_TINY = float(torch.finfo(torch.float32).tiny)


def gumbel(keys: torch.Tensor, shape, *, partitionable: bool = True) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` (float32, mode "low"):
    ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)``."""
    u = _uniform_range(keys, shape, _TINY, 1.0, partitionable=partitionable)
    return -torch.log(-torch.log(u))


def gumbel_rows(keys: torch.Tensor, shape, *, partitionable: bool = True) -> torch.Tensor:
    """:func:`gumbel` for keys with a leading row axis: the bits of every
    row at once (integer work, exact however it is batched), the float
    transform one row at a time, so that each row's noise depends on that
    row alone (a vectorised ``log``'s lanes and its scalar tail can
    differ in the last bit on the CPU, and where a row falls in the
    tensor would then decide its bits)."""
    u = _uniform_range(keys, shape, _TINY, 1.0, partitionable=partitionable)
    return torch.cat([-torch.log(-torch.log(row)) for row in u.split(1)])


def categorical(keys: torch.Tensor, logits: torch.Tensor, *, partitionable: bool = True):
    """``jax.random.categorical(key, logits, axis=-1)``: the argmax over
    the last axis of ``logits`` plus Gumbel noise drawn in ``logits``' own
    shape (JAX draws it so when ``shape`` is None; the leading axes are
    the batch). Returns int64 indices of shape ``logits.shape[:-1]``."""
    g = gumbel(keys, tuple(logits.shape), partitionable=partitionable)
    return torch.argmax(g + logits, dim=-1)
