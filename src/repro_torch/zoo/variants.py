"""Walk-variant strategies, the zoo's defense axis (counterpart of the
JAX package's ``zoo/variants.py``), batched over trajectories.

Each variant is a movement rule over the slot machinery of
``core/walkers.py``; the simulator calls :func:`move_variant` when
``ProtocolConfig.walk_variant != "uniform"`` (a static field: each
variant is its own round, and the default round is untouched):

  * ``uniform``: the paper's walk (``walkers.move_walks``);
  * ``jump``: after the normal hop, teleport w.p. ``p_jump`` to a
    uniformly random up node (random walks with jumps);
  * ``biased``: node2vec-style p/q walk relative to the previous node
    (``WalkState.prev``): returning weighs ``1/bias_p``, staying at
    distance 1 weighs 1, moving outward ``1/bias_q``;
  * ``bloom``: self-avoiding walk with a ``bloom_bits``-wide Bloom
    filter of the nodes it left (``WalkState.bloom``, forked with the
    slot); it prefers unmarked available neighbours and falls back to
    uniform when every candidate is marked.

Every rule holds position where no eligible edge exists and keeps
inactive slots frozen, as in the reference. Each draws from the round's
movement key exactly as the reference splits it.
"""
from __future__ import annotations

import torch

from repro_torch.core import walkers as wlk
from repro_torch.utils import prng

__all__ = ["DEFENSES", "defense", "init_variant_state", "move_variant"]

# named defense presets: ProtocolConfig field overrides (the caller's
# overrides go on top, see ``defense``)
DEFENSES: dict = {
    "uniform": {},
    "jump": {"walk_variant": "jump", "p_jump": 0.05},
    "biased": {"walk_variant": "biased", "bias_p": 4.0, "bias_q": 0.5},
    "bloom": {"walk_variant": "bloom", "bloom_bits": 64},
}


def defense(name: str, **overrides) -> dict:
    """The named defense's ``ProtocolConfig`` overrides (+ the caller's)."""
    try:
        base = DEFENSES[name]
    except KeyError:
        raise KeyError(f"unknown defense {name!r}; known: {sorted(DEFENSES)}") from None
    return {**base, **overrides}


def init_variant_state(ws: wlk.WalkState, pcfg) -> wlk.WalkState:
    """Attach the variant's per-walk memory to a fresh WalkState:
    ``biased`` starts ``prev`` at the walk's own node (so the first hop
    is uniform), ``bloom`` with an empty filter."""
    if pcfg.walk_variant == "biased":
        return ws._replace(prev=ws.pos.clone())
    if pcfg.walk_variant == "bloom":
        shape = ws.pos.shape + (pcfg.bloom_bits,)
        return ws._replace(bloom=torch.zeros(shape, dtype=torch.bool, device=ws.pos.device))
    return ws


def move_variant(ws, pcfg, prows, neighbors, degrees, keys, avail, node_up,
                 *, partitionable: bool = True) -> wlk.WalkState:
    """One movement round under ``pcfg.walk_variant``: the contract of
    ``walkers.move_walks`` (the round's movement keys (batch, 2), the live
    availability (batch, n, D)), plus ``node_up`` (batch, n) for jumps
    and the protocol rows for the variants' rates."""
    variant = pcfg.walk_variant
    if variant == "uniform":
        return wlk.move_walks(ws, neighbors, degrees, keys, avail, partitionable=partitionable)
    if variant == "jump":
        return _move_jump(ws, prows, neighbors, degrees, keys, avail, node_up, partitionable)
    if variant == "biased":
        return _move_biased(ws, prows, neighbors, degrees, keys, avail, partitionable)
    if variant == "bloom":
        return _move_bloom(ws, neighbors, keys, avail, partitionable)
    raise ValueError(f"unknown walk_variant {variant!r}")


def _rows(table: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``table[b][pos[b]]`` for a (batch, n, D) table: (batch, W, D)."""
    return torch.gather(table, 1, pos.long()[..., None].expand(-1, -1, table.shape[2]))


def _move_jump(ws, prows, neighbors, degrees, keys, avail, node_up, part):
    """The normal hop, then w.p. ``p_jump`` a teleport to an up node
    rank-selected by one uniform (so a jump never lands on a crashed
    node; with no node up the walk keeps its hop)."""
    W = ws.pos.shape[1]
    n = node_up.shape[1]
    k_hop, k_gate, k_dest = prng.split(keys, 3, partitionable=part).unbind(1)
    ws = wlk.move_walks(ws, neighbors, degrees, k_hop, avail, partitionable=part)
    u = prng.uniform(torch.stack([k_gate, k_dest]), (W,), partitionable=part)
    do_jump = u[0] < prows.p_jump.view(-1, 1)
    n_up = node_up.sum(dim=1, dtype=torch.int32).view(-1, 1)
    idx = torch.minimum((u[1] * n_up).to(torch.int32), n_up - 1)
    rank = torch.cumsum(node_up.to(torch.int32), dim=1) - 1  # rank among up nodes
    ids = torch.arange(n, dtype=torch.int32, device=node_up.device).expand(node_up.shape)
    rank_to_node = wlk._scatter_drop(
        torch.zeros_like(ids), torch.where(node_up, rank, n), ids
    )
    dest = torch.gather(rank_to_node, 1, torch.clamp(idx, 0, n - 1).long())
    teleport = ws.active & do_jump & (n_up > 0)
    return ws._replace(pos=torch.where(teleport, dest, ws.pos))


def _move_biased(ws, prows, neighbors, degrees, keys, avail, part):
    """node2vec-style p/q walk: weight each available incident edge by
    where it leads relative to the previous node, then draw one uniform
    against the row's weight CDF. The CDF and its total are sums in
    ascending slot order, one float32 add at a time, as XLA computes the
    reference's ``cumsum`` and ``sum`` over a row: bitwise on any
    device."""
    W = ws.pos.shape[1]
    D = neighbors.shape[1]
    p = ws.pos.long()
    rows = neighbors[p]  # (batch, W, D) candidate destinations
    row_mask = _rows(avail, ws.pos)
    prev = ws.prev.long()
    prev_rows = neighbors[prev]  # (batch, W, D) the previous node's neighbours
    prev_deg = torch.arange(D, device=p.device) < degrees[prev][..., None]
    is_prev = rows == ws.prev[..., None]
    dist1 = ((rows[..., :, None] == prev_rows[..., None, :]) & prev_deg[..., None, :]).any(-1)
    one = torch.ones((), dtype=torch.float32, device=p.device)
    inv_p = (one / prows.bias_p).view(-1, 1, 1)
    inv_q = (one / prows.bias_q).view(-1, 1, 1)
    w = torch.where(is_prev, inv_p, torch.where(dist1, one, inv_q))
    w = torch.where(row_mask, w, torch.zeros((), dtype=torch.float32, device=p.device))
    cols = [w[..., 0]]
    for d in range(1, D):
        cols.append(cols[-1] + w[..., d])
    cdf = torch.stack(cols, dim=-1)
    tot = cols[-1]
    u = prng.uniform(keys, (W,), partitionable=part) * tot
    # the first slot whose cdf exceeds u (a zero-weight slot shares its
    # predecessor's cdf, so it is never first)
    sel = wlk.first_true(cdf > u[..., None])
    nxt = torch.gather(rows, 2, sel[..., None]).squeeze(2).to(ws.pos.dtype)
    can_move = ws.active & (tot > 0)
    return ws._replace(
        pos=torch.where(can_move, nxt, ws.pos),
        prev=torch.where(can_move, ws.pos, ws.prev),
    )


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c`` modulo 2**32 for uint32 values held in int64, in two
    16-bit halves of ``c`` so that no product leaves int64's range."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & prng.MASK


def _bloom_hashes(node: torch.Tensor, bits: int):
    """Two multiplicative hashes into [0, bits), as the reference
    computes them in uint32 with wraparound."""
    x = node.long() & prng.MASK
    h1 = _mul_u32(x, 2654435761) % bits
    h2 = ((_mul_u32(x, 40503) + 2699) & prng.MASK) % bits
    return h1, h2


def _move_bloom(ws, neighbors, keys, avail, part):
    """Self-avoiding hop: mark the node being left in the walk's filter,
    then hop uniformly among available neighbours not in the filter,
    falling back to every available neighbour when all are marked."""
    W = ws.pos.shape[1]
    B = ws.bloom.shape[2]
    bloom = ws.bloom.clone()
    h1, h2 = _bloom_hashes(ws.pos, B)
    for h in (h1, h2):  # in order: the second read sees the first write
        h = h[..., None]
        bloom.scatter_(2, h, torch.gather(bloom, 2, h) | ws.active[..., None])
    rows = neighbors[ws.pos.long()]  # (batch, W, D)
    g1, g2 = _bloom_hashes(rows, B)
    visited = torch.gather(bloom, 2, g1) & torch.gather(bloom, 2, g2)
    row_mask = _rows(avail, ws.pos)
    fresh = row_mask & ~visited
    mask = torch.where(fresh.any(dim=2, keepdim=True), fresh, row_mask)
    u = prng.uniform(keys, (W,), partitionable=part)
    adeg, sel = wlk.select_available_edge(mask, u)
    nxt = torch.gather(rows, 2, sel[..., None]).squeeze(2).to(ws.pos.dtype)
    can_move = ws.active & (adeg > 0)
    return ws._replace(pos=torch.where(can_move, nxt, ws.pos), bloom=bloom)
