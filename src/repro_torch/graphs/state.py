"""Dynamic topology as run-time state (counterpart of ``graphs/state.py``).

``GraphState`` carries the live topology as two boolean masks over the
static padded adjacency of a :class:`Graph`, with a leading batch axis
(one row per trajectory):

  node_up : (batch, n) bool       — node i is operational
  edge_up : (batch, n, D) bool    — the edge from i to ``neighbors[i, k]``

The static ``Graph`` is the superset topology shared by every
trajectory; the masks only remove edges from it.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.graphs.generators import Graph


class GraphState(NamedTuple):
    """Live topology masks; all-True == the static graph."""

    node_up: torch.Tensor  # (batch, n) bool
    edge_up: torch.Tensor  # (batch, n, D) bool


def init_graph_state(batch: int, n: int, max_deg: int, device) -> GraphState:
    """Fully-operational topology (every mask True)."""
    return GraphState(
        node_up=torch.ones((batch, n), dtype=torch.bool, device=device),
        edge_up=torch.ones((batch, n, max_deg), dtype=torch.bool, device=device),
    )


def mirror_indices(graph: Graph) -> np.ndarray:
    """(n, D) int32 M with ``neighbors[neighbors[i,k], M[i,k]] == i``.

    Padded slots (k >= degrees[i]) map to themselves. O(n * D) via a sort
    over directed-edge keys; memoized on the (immutable) graph.
    """
    cached = getattr(graph, "_mirror_cache_torch", None)
    if cached is not None:
        return cached
    nbrs = np.asarray(graph.neighbors)
    degs = np.asarray(graph.degrees)
    n, D = nbrs.shape
    src = np.repeat(np.arange(n, dtype=np.int64), D).reshape(n, D)
    fwd = src * n + nbrs  # key of slot (i, k): edge i -> j
    rev = nbrs.astype(np.int64) * n + src  # key of the mirrored slot j -> i
    order = np.argsort(fwd.ravel(), kind="stable")
    pos = np.searchsorted(fwd.ravel()[order], rev.ravel())
    mirror = (order[np.clip(pos, 0, n * D - 1)] % D).astype(np.int32).reshape(n, D)
    pad = np.arange(D, dtype=np.int32)[None, :] >= degs[:, None]
    mirror[pad] = np.broadcast_to(np.arange(D, dtype=np.int32), (n, D))[pad]
    object.__setattr__(graph, "_mirror_cache_torch", mirror)  # frozen dataclass
    return mirror


def availability_rows(
    edge_up_rows: torch.Tensor,  # (..., D) edge masks for these rows
    node_up_rows: torch.Tensor,  # (...,) liveness of the rows' own nodes
    node_up_nbrs: torch.Tensor,  # (..., D) liveness of each row's neighbors
    degrees_rows: torch.Tensor,  # (...,)
) -> torch.Tensor:
    """Slot (r, k) is available iff it exists in the static graph
    (k < degree), the edge is up, and both endpoints are up. The
    neighbors' liveness is gathered by the caller (it needs the full
    node vector of the row's own trajectory)."""
    D = edge_up_rows.shape[-1]
    within = (
        torch.arange(D, device=edge_up_rows.device) < degrees_rows[..., None]
    )
    return within & edge_up_rows & node_up_rows[..., None] & node_up_nbrs


def availability(
    gs: GraphState, neighbors: torch.Tensor, degrees: torch.Tensor
) -> torch.Tensor:
    """(batch, n, D) bool: slot (i, k) is traversable right now."""
    batch, n = gs.node_up.shape
    nbr_up = torch.gather(
        gs.node_up, 1, neighbors.reshape(1, -1).expand(batch, -1).long()
    ).reshape(gs.edge_up.shape)
    return availability_rows(gs.edge_up, gs.node_up, nbr_up, degrees)
