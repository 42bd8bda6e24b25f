"""The benchmark's graphs, made from a seed by frozen copies of two
generators, so that the graph a cell runs on never moves with the
program:

- ``regular``: the port's random d-regular generator (greedy stub
  matching with restarts, then a connectivity check), which the paper's
  Figs. 1-5 use at n 100, d 8;
- ``cayley``: a ``degree``-regular Cayley graph of Z_n (node i joins
  i +- o_k for ``degree / 2`` distinct offsets in [1, n/2), drawn until
  they and n are coprime, so that it is connected), built in O(n D) for
  the production step's n 131,072.

Each returns ``(neighbors (n, D) int32, degrees (n,) int32, mirror
(n, D) int64)``: ``neighbors[neighbors[i, k], mirror[i, k]] == i``.
"""
from __future__ import annotations

import numpy as np


def _connected(a: np.ndarray) -> bool:
    n = a.shape[0]
    seen = np.zeros(n, dtype=bool)
    frontier = np.zeros(n, dtype=bool)
    seen[0] = frontier[0] = True
    while frontier.any():
        nxt = a[frontier].any(0) & ~seen
        seen |= nxt
        frontier = nxt
    return bool(seen.all())


def _pairing(n: int, d: int, rng) -> np.ndarray | None:
    stubs = np.repeat(np.arange(n), d)
    rng.shuffle(stubs)
    stubs = stubs.tolist()
    a = np.zeros((n, n), dtype=bool)
    while stubs:
        u = stubs.pop()
        found = False
        for _ in range(60):
            j = int(rng.integers(len(stubs))) if stubs else -1
            if j < 0:
                break
            v = stubs[j]
            if v != u and not a[u, v]:
                stubs[j] = stubs[-1]
                stubs.pop()
                a[u, v] = a[v, u] = True
                found = True
                break
        if not found:
            return None
    return a


def regular(n: int, degree: int, seed: int):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        a = _pairing(n, degree, rng)
        if a is not None and _connected(a):
            break
    else:
        raise RuntimeError("failed to sample a simple connected regular graph")
    nbrs = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, degree))
    for i in range(n):
        js = np.nonzero(a[i])[0].astype(np.int32)
        nbrs[i, : len(js)] = js
    slot = {(i, int(j)): k for i in range(n) for k, j in enumerate(nbrs[i])}
    mirror = np.array([[slot[(int(j), i)] for j in nbrs[i]] for i in range(n)], dtype=np.int64)
    return nbrs, np.full(n, degree, np.int32), mirror


def cayley(n: int, degree: int, seed: int):
    rng = np.random.default_rng(seed)
    while True:
        offs = rng.choice(np.arange(1, n // 2), degree // 2, replace=False)
        if np.gcd.reduce(np.append(offs, n)) == 1:
            break
    i = np.arange(n)[:, None]
    nbrs = np.concatenate([(i + offs) % n, (i - offs) % n], axis=1).astype(np.int32)
    h = degree // 2
    k = np.arange(degree)
    mirror = np.broadcast_to(np.where(k < h, k + h, k - h), (n, degree)).astype(np.int64)
    return nbrs, np.full(n, degree, np.int32), mirror


FAMILIES = {"regular": regular, "cayley": cayley}


def make(spec: dict):
    """The graph of a configuration's ``graph`` entry: ``family``, ``n``,
    ``degree``, ``seed``."""
    return FAMILIES[spec["family"]](int(spec["n"]), int(spec["degree"]), int(spec["seed"]))
