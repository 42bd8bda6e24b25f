"""Graph generators for the decentralized system (numpy, shared verbatim
in behaviour with the JAX package's ``graphs/generators.py``: the same
seed gives the same graph).

Self-contained (no networkx). Every generator returns a `Graph` — a padded
neighbor-list representation that the simulator moves to the device once:

  neighbors : (n, max_deg) int32, padded with 0 (mask via degrees)
  degrees   : (n,)         int32

The paper evaluates on random d-regular graphs (Figs. 1-5) plus complete,
Erdos-Renyi and power-law graphs (Fig. 6); we implement all of those plus
ring and 2-D torus for tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Callable

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """Immutable padded-adjacency graph."""

    n: int
    neighbors: np.ndarray  # (n, max_deg) int32, row i padded with i itself
    degrees: np.ndarray  # (n,) int32
    family: str = "custom"

    @property
    def max_degree(self) -> int:
        return int(self.neighbors.shape[1])

    @property
    def num_edges(self) -> int:
        return int(self.degrees.sum()) // 2

    def adjacency(self) -> np.ndarray:
        """Dense boolean adjacency (test/analysis use only)."""
        a = np.zeros((self.n, self.n), dtype=bool)
        for i in range(self.n):
            for j in self.neighbors[i, : self.degrees[i]]:
                a[i, j] = True
        return a

    def validate(self) -> None:
        a = self.adjacency()
        assert (a == a.T).all(), "graph must be undirected"
        assert not a.diagonal().any(), "no self loops"
        assert is_connected_adj(a), "graph must be connected"


def _adj_to_graph(a: np.ndarray, family: str) -> Graph:
    n = a.shape[0]
    degs = a.sum(1).astype(np.int32)
    max_deg = int(degs.max())
    # Pad each row with the node's own index: sampling code never reads
    # beyond `degrees[i]`, padding value only needs to be a valid index.
    nbrs = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, max_deg))
    for i in range(n):
        js = np.nonzero(a[i])[0].astype(np.int32)
        nbrs[i, : len(js)] = js
    return Graph(n=n, neighbors=nbrs, degrees=degs, family=family)


def is_connected_adj(a: np.ndarray) -> bool:
    """BFS connectivity check on a dense adjacency matrix."""
    n = a.shape[0]
    seen = np.zeros(n, dtype=bool)
    frontier = np.zeros(n, dtype=bool)
    frontier[0] = True
    seen[0] = True
    while frontier.any():
        nxt = (a[frontier].any(0)) & ~seen
        seen |= nxt
        frontier = nxt
    return bool(seen.all())


def random_regular_graph(n: int, d: int, seed: int = 0) -> Graph:
    """Random d-regular graph via greedy stub matching with restarts.

    Plain configuration-model rejection has acceptance ~ e^{-(d^2-1)/4}
    (hopeless for d = 8), so we instead match stubs greedily, rejecting
    self-loops/multi-edges locally, and restart on dead ends — the same
    strategy networkx uses. Connectivity is checked at the end (a random
    d >= 3 regular graph is connected w.h.p.).
    """
    if n * d % 2 != 0:
        raise ValueError("n*d must be even")
    if d >= n:
        raise ValueError("d must be < n")
    rng = np.random.default_rng(seed)
    for _attempt in range(200):
        a = _greedy_regular_pairing(n, d, rng)
        if a is None:
            continue
        if is_connected_adj(a):
            return _adj_to_graph(a, "regular")
    raise RuntimeError("failed to sample a simple connected regular graph")


def _greedy_regular_pairing(n: int, d: int, rng) -> np.ndarray | None:
    stubs = np.repeat(np.arange(n), d)
    rng.shuffle(stubs)
    stubs = stubs.tolist()
    a = np.zeros((n, n), dtype=bool)
    while stubs:
        u = stubs.pop()
        # try a bounded number of random partners for u
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
            return None  # dead end: restart with a fresh shuffle
    return a


def erdos_renyi_graph(n: int, p: float | None = None, seed: int = 0) -> Graph:
    """Connected Erdos-Renyi G(n, p); defaults to p = 2 ln n / n."""
    if p is None:
        p = min(1.0, 2.0 * np.log(n) / n)
    rng = np.random.default_rng(seed)
    for _attempt in range(1000):
        a = rng.random((n, n)) < p
        a = np.triu(a, 1)
        a = a | a.T
        if is_connected_adj(a):
            return _adj_to_graph(a, "erdos_renyi")
    raise RuntimeError("failed to sample connected ER graph; increase p")


def complete_graph(n: int) -> Graph:
    a = ~np.eye(n, dtype=bool)
    return _adj_to_graph(a, "complete")


def power_law_graph(n: int, m: int = 3, seed: int = 0) -> Graph:
    """Barabasi-Albert preferential attachment (power-law degrees)."""
    if m < 1 or m >= n:
        raise ValueError("need 1 <= m < n")
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n), dtype=bool)
    # seed clique of m+1 nodes
    for i in range(m + 1):
        for j in range(i + 1, m + 1):
            a[i, j] = a[j, i] = True
    targets_pool = list(range(m + 1)) * m
    for v in range(m + 1, n):
        chosen: set[int] = set()
        while len(chosen) < m:
            chosen.add(int(targets_pool[rng.integers(len(targets_pool))]))
        for u in chosen:
            a[u, v] = a[v, u] = True
            targets_pool.append(u)
        targets_pool.extend([v] * m)
    assert is_connected_adj(a)
    return _adj_to_graph(a, "power_law")


def community_graph(
    n: int,
    k_bridges: int = 2,
    p_in: float | None = None,
    seed: int = 0,
) -> Graph:
    """Two ER communities joined by ``k_bridges`` random bridge edges.

    Nodes ``[0, n//2)`` form one community, ``[n//2, n)`` the other —
    the id boundary ``n//2`` is exactly the threshold the zoo's
    ``edge_cut`` attack severs, so cutting there isolates the halves.
    Each half is a connected G(n/2, p_in) (default ``p_in = 3 ln(n/2) /
    (n/2)``); bridges pair uniformly random endpoints across the halves
    (deduplicated, so the bridge count is exactly ``k_bridges``).
    """
    if n < 4:
        raise ValueError("community graph needs n >= 4")
    if k_bridges < 1:
        raise ValueError("need k_bridges >= 1 (else the graph disconnects)")
    h = n // 2
    sizes = (h, n - h)
    if p_in is None:
        p_in = min(1.0, 3.0 * np.log(max(sizes)) / min(sizes))
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n), dtype=bool)
    for lo, size in ((0, sizes[0]), (h, sizes[1])):
        for _attempt in range(1000):
            block = rng.random((size, size)) < p_in
            block = np.triu(block, 1)
            block = block | block.T
            if is_connected_adj(block):
                a[lo : lo + size, lo : lo + size] = block
                break
        else:
            raise RuntimeError(
                "failed to sample a connected community; increase p_in"
            )
    bridges: set = set()
    while len(bridges) < k_bridges:
        u = int(rng.integers(0, h))
        v = int(rng.integers(h, n))
        bridges.add((u, v))
    for u, v in sorted(bridges):
        a[u, v] = a[v, u] = True
    return _adj_to_graph(a, "community")


def ring_graph(n: int) -> Graph:
    a = np.zeros((n, n), dtype=bool)
    idx = np.arange(n)
    a[idx, (idx + 1) % n] = True
    a[(idx + 1) % n, idx] = True
    return _adj_to_graph(a, "ring")


def torus_graph(rows: int, cols: int) -> Graph:
    n = rows * cols
    a = np.zeros((n, n), dtype=bool)
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for dr, dc in ((1, 0), (0, 1)):
                j = ((r + dr) % rows) * cols + (c + dc) % cols
                a[i, j] = a[j, i] = True
    return _adj_to_graph(a, "torus")


GRAPH_FAMILIES: Dict[str, Callable[..., Graph]] = {
    "regular": random_regular_graph,
    "erdos_renyi": erdos_renyi_graph,
    "complete": complete_graph,
    "power_law": power_law_graph,
    "community": community_graph,
    "ring": ring_graph,
    "torus": torus_graph,
}


def make_graph(family: str, n: int, seed: int = 0, **kwargs) -> Graph:
    """Uniform constructor used by configs/benchmarks."""
    if family == "regular":
        return random_regular_graph(n, kwargs.get("degree", 8), seed)
    if family == "erdos_renyi":
        return erdos_renyi_graph(n, kwargs.get("p"), seed)
    if family == "complete":
        return complete_graph(n)
    if family == "power_law":
        return power_law_graph(n, kwargs.get("m", 3), seed)
    if family == "community":
        return community_graph(
            n, kwargs.get("k_bridges", 2), kwargs.get("p_in"), seed
        )
    if family == "ring":
        return ring_graph(n)
    if family == "torus":
        return torus_graph(kwargs.get("rows", 8), kwargs.get("cols", max(1, n // 8)))
    raise KeyError(f"unknown graph family {family!r}")
