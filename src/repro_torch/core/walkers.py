"""Walk-slot state machine: movement, forking, termination (batched).

Counterpart of the JAX package's ``core/walkers.py``: ``max_walks``
slots per trajectory, a slot is a walk iff ``active``; ``track[slot]``
names the ``last_seen`` column the walk writes (for DecAFork each slot
owns its own column, cleared on reuse; for MissingPerson it is the
initial id the walk replaces, shared with the walk it replaces).
The reference's ``mode="drop"`` scatters to the out-of-range index W
become explicit masks here: every scatter goes into a buffer one column
wider, whose last column is dropped.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.estimator import NEVER
from repro_torch.utils import prng


class WalkState(NamedTuple):
    pos: torch.Tensor  # (batch, W) int32 current node
    active: torch.Tensor  # (batch, W) bool
    track: torch.Tensor  # (batch, W) int32 last_seen column of the walk


def init_walks(
    z0: torch.Tensor, max_walks: int, n_nodes: int, keys: torch.Tensor,
    *, partitionable: bool = True,
) -> WalkState:
    """Start Z_0 walks at uniformly random nodes; ``z0`` is (batch,)."""
    pos = prng.randint(keys, (max_walks,), 0, n_nodes, partitionable=partitionable)
    slots = torch.arange(max_walks, dtype=torch.int32, device=keys.device)
    return WalkState(
        pos=pos,
        active=slots < z0.view(-1, 1),
        track=slots.expand(pos.shape).clone(),
    )


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none), as
    ``jnp.argmax`` over a bool mask."""
    return torch.argmax(mask.to(torch.int8), dim=-1)


def select_available_edge(row_mask: torch.Tensor, u: torch.Tensor):
    """Rank-select one available incident-edge slot per row: the
    ``idx``-th available slot with ``idx = min(floor(u * adeg), adeg - 1)``.
    Returns ``(adeg, sel)``; ``sel`` is meaningless where ``adeg == 0``."""
    adeg = row_mask.sum(dim=-1, dtype=torch.int32)
    idx = torch.minimum((u * adeg).to(torch.int32), adeg - 1)
    rank = torch.cumsum(row_mask.to(torch.int32), dim=-1) - 1
    sel = first_true((rank == idx[..., None]) & row_mask)
    return adeg, sel


def move_walks_rows(
    ws: WalkState,
    neighbors_rows: torch.Tensor,  # (batch, W, D) = neighbors[pos]
    u: torch.Tensor,  # (batch, W) hop uniforms
    avail_rows: torch.Tensor,  # (batch, W, D) availability at pos
) -> torch.Tensor:
    """One synchronous hop over pre-gathered rows; returns the new pos.
    A walk whose node has no available incident edge holds position."""
    adeg, sel = select_available_edge(avail_rows, u)
    nxt = torch.gather(neighbors_rows, 2, sel[..., None]).squeeze(2)
    can_move = ws.active & (adeg > 0)
    return torch.where(can_move, nxt.to(ws.pos.dtype), ws.pos)


def move_walks(
    ws: WalkState,
    neighbors: torch.Tensor,  # (n, D)
    degrees: torch.Tensor,  # (n,)
    keys: torch.Tensor,  # (batch, 2)
    avail: torch.Tensor,  # (batch, n, D) from graphs.state.availability
    *, partitionable: bool = True,
) -> WalkState:
    """Each active walk moves to a uniform available neighbor."""
    W = ws.pos.shape[1]
    u = prng.uniform(keys, (W,), partitionable=partitionable)
    p = ws.pos.long()
    avail_rows = torch.gather(
        avail, 1, p[..., None].expand(-1, -1, avail.shape[2])
    )
    pos = move_walks_rows(ws, neighbors[p], u, avail_rows)
    return ws._replace(pos=pos)


def execute_terminations(ws: WalkState, term: torch.Tensor) -> WalkState:
    return ws._replace(active=ws.active & ~term)


def _scatter_drop(base: torch.Tensor, index: torch.Tensor, src) -> torch.Tensor:
    """``base.at[index].set(src, mode="drop")`` along the last axis, with
    index == base.shape[-1] meaning "dropped"."""
    wide = torch.cat([base, base[..., :1]], dim=-1)
    if isinstance(src, torch.Tensor):
        src = src.to(base.dtype)
    else:  # filled on the device: no host-to-device copy, so it captures
        src = torch.full((), src, dtype=base.dtype, device=base.device)
    wide.scatter_(-1, index.long(), src.expand(index.shape))
    return wide[..., :-1].contiguous()


def allocate_fork_slots(active: torch.Tensor, ev_mask: torch.Tensor):
    """Pair the r-th fork event with the r-th free slot (capacity-capped,
    overflow dropped); ``ev_mask`` is (batch, E) for any number E of
    events, ranked in flat order. Returns ``(safe_slot, ev_ok, ev_slot)``
    as the reference does, each (batch, E), with ``safe_slot == W`` for
    dropped events."""
    W = active.shape[-1]
    slots = torch.arange(W, dtype=torch.int32, device=active.device)
    free = ~active
    n_free = free.sum(dim=-1, keepdim=True)
    free_rank = torch.cumsum(free.to(torch.int32), dim=-1) - 1
    ev_rank = torch.cumsum(ev_mask.to(torch.int32), dim=-1) - 1
    ev_ok = ev_mask & (ev_rank < n_free)
    rank_to_slot = _scatter_drop(
        torch.zeros_like(active, dtype=torch.int32),
        torch.where(free, free_rank, W),
        slots.expand(active.shape),
    )
    ev_slot = torch.gather(rank_to_slot, -1, torch.clamp(ev_rank, 0, W - 1).long())
    safe_slot = torch.where(ev_ok, ev_slot, W)
    return safe_slot, ev_ok, ev_slot


def execute_forks(
    ws: WalkState,
    last_seen: torch.Tensor,  # (batch, n, C) int32, updated in place
    ev_mask: torch.Tensor,  # (batch, E) bool fork events
    ev_origin: torch.Tensor,  # (batch, E) node the fork leaves from
    ev_track: torch.Tensor | None,  # (batch, E) identity, or None: the slot's own
    t: torch.Tensor,  # (batch,) int32
    ev_parent: torch.Tensor | None = None,  # (batch, E) parent slot per event
):
    """Allocate free slots to fork events (walkers.py:176-229 in the JAX
    package). DecAFork (``ev_track is None``): each fork gets a fresh
    identity (the slot itself), the slot's stale column is cleared and
    the forking node has, by construction, just seen the new walk
    (``last_seen`` gets ``t - NEVER`` added at the origin row).
    MissingPerson: the replacement carries the missing walk's identity
    ``ev_track`` and ``last_seen`` is left alone. ``ev_parent`` defaults
    to the event index. Returns ``(WalkState, last_seen, n_forks,
    fork_parent)``; ``fork_parent[s]`` is the parent slot of a walk
    forked into slot s this round, else -1."""
    batch, W = ws.pos.shape
    safe_slot, ev_ok, ev_slot = allocate_fork_slots(ws.active, ev_mask)
    if ev_parent is None:
        ev_parent = torch.arange(
            ev_mask.shape[1], dtype=torch.int32, device=ws.pos.device
        ).expand(batch, -1)
    fork_parent = _scatter_drop(torch.full_like(ws.pos, -1), safe_slot, ev_parent)
    active = _scatter_drop(ws.active, safe_slot, True)
    pos = _scatter_drop(ws.pos, safe_slot, ev_origin)
    if ev_track is None:
        track = _scatter_drop(ws.track, safe_slot, ev_slot)
        fresh = _scatter_drop(torch.zeros_like(ws.active), safe_slot, True)
        col_origin = _scatter_drop(torch.zeros_like(ws.pos), safe_slot, ev_origin)
        last_seen.masked_fill_(fresh[:, None, :], NEVER)
        n, C = last_seen.shape[1:]
        bidx = torch.arange(batch, device=ws.pos.device)[:, None]
        flat = (bidx * n + col_origin.long()) * C + torch.arange(W, device=ws.pos.device)
        add = torch.where(fresh, (t - NEVER).view(-1, 1), 0).to(last_seen.dtype)
        last_seen.view(-1).index_put_((flat.reshape(-1),), add.reshape(-1), accumulate=True)
    else:
        track = _scatter_drop(ws.track, safe_slot, ev_track)
    n_forks = ev_ok.sum(dim=-1, dtype=torch.int32)
    return WalkState(pos=pos, active=active, track=track), last_seen, n_forks, fork_parent


def execute_grid_forks(
    ws: WalkState,
    last_seen: torch.Tensor,  # (batch, n, C)
    ev: torch.Tensor,  # (batch, W, C) bool event grid: (parent walk, identity)
    t: torch.Tensor,
):
    """The MissingPerson fork grid: event (k, l) forks a duplicate of walk
    k carrying identity l. The W * C events are flattened row-major, so
    slots go to events in (parent, identity) order."""
    batch, W, C = ev.shape
    e = torch.arange(W * C, dtype=torch.int32, device=ev.device)
    parent = (e // C).expand(batch, -1)
    track = (e % C).expand(batch, -1)
    origin = torch.gather(ws.pos, 1, parent.long())
    return execute_forks(ws, last_seen, ev.reshape(batch, W * C), origin, track, t, parent)
