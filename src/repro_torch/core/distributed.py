"""Node-sharded distributed protocol step (counterpart of the JAX
package's ``core/distributed.py``).

The paper's system is decentralized: every node acts on *local* state
only (Rule 1). Over ``torch.distributed`` each rank holds the rows of
its shard of the nodes -- ``last_seen``, the return-time histograms and
their totals, the neighbor lists, degrees and edge masks -- while the
O(W) walk descriptors (positions, active flags, tracks), the key and the
O(n) ``node_up`` vector are replicated. Per round each rank

  1. proposes the next hop of every walk sitting on one of its nodes
     (it owns their neighbor lists and edge masks) over the currently
     available incident edges, with the same rank-select as
     ``walkers.move_walks``; the proposals meet in a sum over the node
     axes (the holding node forwards the token);
  2. records return-time samples and last-seen updates on its own rows;
  3. evaluates theta-hat and the fork / terminate rule for the walks
     each of its nodes chooses; the disjoint decision masks meet in a
     second sum (the message exchange of Rule 1);
  4. executes forks and terminations on the replicated walk state, which
     every rank does alike.

So a round has two collectives, ``all_reduce(SUM)`` of int32 over the
O(W) walk axis: their bytes do not grow with the graph. Integer sums
give the same bits in any order, so a run at any world size is bitwise
the one-shard run. A rank's node tables are updated in place.

:func:`run_sharded` runs rounds through a :class:`ShardedRunner`, the
counterpart of the reference's ``jax.jit(step)``: on CUDA tensors whose
collectives are NCCL's (or that have none, ``mesh=None``) one round is
captured as a CUDA graph and replayed once a round; gloo's collectives
do not capture, so runs over gloo (the CPU, or two ranks on one card)
run the same round eagerly through the same static buffers.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import estimator as est
from repro_torch.core import protocol as prt
from repro_torch.core import walkers as wlk
from repro_torch.graphs.state import availability_rows
from repro_torch.utils import prng
from repro_torch.utils.tree import copy_into, tree_clone

__all__ = [
    "ShardedGraph",
    "ShardedProtocolState",
    "ShardedRunner",
    "gather_state",
    "init_sharded_state",
    "make_sharded_step",
    "run_sharded",
    "shard_index",
    "shard_state",
]


# fold_in_time tags of the round's two streams: movement, decisions
_TAGS = (0, 4)


class ShardedProtocolState(NamedTuple):
    """Walk state replicated; node tables sharded on their first axis."""

    t: torch.Tensor  # () int32, replicated
    pos: torch.Tensor  # (W,) int32, replicated
    active: torch.Tensor  # (W,) bool, replicated
    track: torch.Tensor  # (W,) int32, replicated
    last_seen: torch.Tensor  # (n, W) int32, node-sharded
    hist: torch.Tensor  # (n, B) float32, node-sharded
    total: torch.Tensor  # (n,) float32, node-sharded
    key: torch.Tensor  # (2,) threefry key words, replicated


class ShardedGraph(NamedTuple):
    """The step's topology arguments."""

    neighbors: torch.Tensor  # (n, D) int32, node-sharded
    degrees: torch.Tensor  # (n,) int32, node-sharded
    node_up: torch.Tensor  # (n,) bool, replicated: availability reads neighbors'
    edge_up: torch.Tensor  # (n, D) bool, node-sharded


def shard_index(mesh, node_axes: Sequence[str]) -> tuple[int, int]:
    """(this rank's shard, number of shards): its coordinates on
    ``node_axes``, the first axis major. ``mesh=None`` is one shard."""
    if mesh is None:
        return 0, 1
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.mesh.shape))
    coord = mesh.get_coordinate()
    shard, n_shards = 0, 1
    for a in node_axes:
        shard = shard * sizes[a] + coord[names.index(a)]
        n_shards *= sizes[a]
    return shard, n_shards


def _rows(n_nodes: int, mesh, node_axes) -> tuple[int, int]:
    """(first row, rows) of this rank's shard."""
    shard, n_shards = shard_index(mesh, node_axes)
    if n_nodes % n_shards:
        raise ValueError(f"n_nodes={n_nodes} must divide over {n_shards} shards")
    n_local = n_nodes // n_shards
    return shard * n_local, n_local


def make_sharded_step(mesh, node_axes: Sequence[str], n_nodes: int,
                      pcfg: prt.ProtocolConfig, *, partitionable: bool = True):
    """The protocol round for this rank of ``mesh``, nodes sharded over
    ``node_axes`` (e.g. ``("data",)`` or ``("pod", "data")``);
    ``mesh=None`` is one shard and no collective. The step takes the
    reference's twelve arguments (``t, pos, active, track, last_seen,
    hist, total, key, neighbors, degrees, node_up, edge_up``: the
    node-sharded ones are this rank's rows) and returns its nine results
    (``t + 1, pos, active, track, last_seen, hist, total, key, z``).
    ``node_up`` is replicated: availability needs the liveness of
    neighbors, which live on other shards. Pass all-True masks for a
    static topology. The process group is the caller's."""
    axes = tuple(node_axes)
    lo, n_local = _rows(n_nodes, mesh, axes)
    groups = () if mesh is None else tuple(mesh.get_group(a) for a in axes)
    decafork_plus = pcfg.algorithm == "decafork+"
    consts_by_device = {}  # device -> the decision rows
    tags_by_device = {}  # device -> the two stream tags
    folded = [None]  # (key, its version, fold_in(key, _TAGS))
    # the collectives' backend (None: no collective); it decides whether
    # run_sharded captures the round
    backend = None if not groups else dist.get_backend(groups[0])

    def psum(x):
        # a sum over ("pod", "data") is the sum over each axis in turn
        for g in groups:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=g)
        return x

    def on_shard(pos, active):
        local = active & (pos >= lo) & (pos < lo + n_local)
        return local, torch.clamp(pos - lo, 0, n_local - 1).long()

    def key_folds(key):
        """``fold_in(key, tag)`` for the two stream tags. fold_in_time(key,
        t, tag) = fold_in(fold_in(key, tag), t): the inner fold depends on
        the key alone, which the step returns unchanged, so it is hashed
        once per key (a new key tensor, or one written in place, is hashed
        again). A new key's folds are written into the same tensor, so a
        captured round that reads them sees them once this has run
        outside the capture (:class:`ShardedRunner` calls it at each
        run)."""
        f = folded[0]
        if f is None or f[0] is not key or f[1] != key._version:
            tags = tags_by_device.get(key.device)
            if tags is None:
                tags = tags_by_device[key.device] = torch.tensor(_TAGS, dtype=torch.int64,
                                                                 device=key.device)
            new = prng.fold_in(key, tags)
            if f is not None and f[2].device == new.device:
                new = f[2].copy_(new)
            folded[0] = (key, key._version, new)
        return folded[0][2]

    def step(t, pos, active, track, last_seen, hist, total, key,
             neighbors, degrees, node_up, edge_up):
        dev = pos.device
        W = pos.shape[0]
        C, bins = last_seen.shape[1], hist.shape[1]
        t = torch.as_tensor(t, dtype=torch.int32, device=dev)
        slots = torch.arange(W, dtype=torch.int32, device=dev)
        # a down node kills its resident walks (node_up is replicated)
        active = active & node_up[pos.long()]
        local, lpos = on_shard(pos, active)

        # 1. movement: the owner proposes the next hop over the available
        # edges of the walk's row (gathered first: availability is
        # elementwise, so the W visited rows give the full table's values)
        consts = consts_by_device.get(dev)
        if consts is None:  # the decision rows
            consts = consts_by_device[dev] = prt.protocol_rows([pcfg], dev)
        rows = consts
        k_move, k_dec = prng.fold_in(key_folds(key), t)  # both streams in one pass
        u = prng.uniform(k_move, (W,), partitionable=partitionable)
        nbrs = neighbors[lpos]  # (W, D)
        row_mask = availability_rows(edge_up[lpos], node_up[lo + lpos],
                                     node_up[nbrs.long()], degrees[lpos])
        adeg, sel = wlk.select_available_edge(row_mask, u)
        nxt = torch.gather(nbrs, 1, sel[:, None]).squeeze(1)
        proposal = torch.where(local, torch.where(adeg > 0, nxt, pos), 0)
        pos = torch.where(active, psum(proposal), pos)

        # 2. observations on local rows (a walk elsewhere adds 0 or NEVER
        # to the clipped row: no change)
        local, lpos = on_shard(pos, active)
        trk = track.long()
        prev = last_seen[lpos, trk]
        r = t - prev
        valid = local & (prev != est.NEVER) & (r >= 1)
        b = torch.clamp(r, 1, bins).long() - 1
        w = valid.float()
        hist.view(-1).index_put_((lpos * bins + b,), w, accumulate=True)
        total.index_put_((lpos,), w, accumulate=True)
        upd = torch.where(local, t, est.NEVER)
        last_seen.view(-1).scatter_reduce_(0, lpos * C + trk, upd, "amax")

        # 3. node-local estimates and decisions. Each node chooses its
        # lowest visiting slot. Theta takes the cumsum of the W visited
        # rows only where the reference takes it over the shard's whole
        # table: the counts are exact integers in float32, so the rows'
        # values are the same.
        chosen = prt.choose_walks_pairwise(lpos, local)
        ls_rows = last_seen[lpos]  # (W, C)
        cum = est.survival_cumulative(hist[lpos])  # (W, B+1)
        s = est.survival_eval(cum, total[lpos], slots[:, None], t - ls_rows)
        cols = torch.arange(C, device=dev)
        mask = (ls_rows != est.NEVER) & (cols != track[:, None])
        theta = 0.5 + torch.where(mask, s, torch.zeros_like(s)).sum(dim=1)
        enabled = (t >= pcfg.protocol_start).view(1)
        fork, term = prt.decafork_decisions(theta[None], chosen[None], k_dec[None], rows,
                                            enabled, decafork_plus,
                                            partitionable=partitionable)
        # the decision exchange: disjoint masks, summed in one collective
        dec = psum(torch.cat([fork, term]).to(torch.int32)) > 0
        fork, term = dec[0], dec[1]

        # 4. execute (replicated, deterministic)
        active = active & ~term
        ev_origin = pos  # a forked walk starts where its parent sits
        safe_slot, ev_ok, ev_slot = wlk.allocate_fork_slots(active, fork)
        active = wlk._scatter_drop(active, safe_slot, True)
        pos = wlk._scatter_drop(pos, safe_slot, ev_origin)
        track = wlk._scatter_drop(track, safe_slot, ev_slot)
        # clear the reused column; the fork's origin row, if local, has
        # just seen the new walk
        fresh = wlk._scatter_drop(torch.zeros_like(active), safe_slot, ev_ok)
        o_local, o_row = on_shard(ev_origin, ev_ok)
        col_origin = wlk._scatter_drop(torch.zeros_like(pos), safe_slot, o_row)
        origin_is_local = wlk._scatter_drop(torch.zeros_like(active), safe_slot, o_local)
        last_seen.masked_fill_(fresh[None, :], est.NEVER)
        add = torch.where(origin_is_local & fresh, t - est.NEVER, 0).to(last_seen.dtype)
        last_seen.view(-1).index_put_((col_origin.long() * C + slots,), add, accumulate=True)

        z = active.sum(dtype=torch.int32)
        return t + 1, pos, active, track, last_seen, hist, total, key, z

    step.backend = backend
    step.key_folds = key_folds
    step.runners = {}  # (device, capture) -> ShardedRunner, for run_sharded
    return step


def init_sharded_state(n_nodes: int, pcfg: prt.ProtocolConfig, key: torch.Tensor,
                       *, partitionable: bool = True) -> ShardedProtocolState:
    """The whole graph's starting state on ``key``'s device: Z_0 walks
    at nodes drawn by ``randint(key)``, every table empty."""
    W, dev = pcfg.max_walks, key.device
    return ShardedProtocolState(
        t=torch.zeros((), dtype=torch.int32, device=dev),
        pos=prng.randint(key, (W,), 0, n_nodes, partitionable=partitionable),
        active=torch.arange(W, device=dev) < pcfg.z0,
        track=torch.arange(W, dtype=torch.int32, device=dev),
        last_seen=torch.full((n_nodes, W), est.NEVER, dtype=torch.int32, device=dev),
        hist=torch.zeros((n_nodes, pcfg.rt_bins), dtype=torch.float32, device=dev),
        total=torch.zeros((n_nodes,), dtype=torch.float32, device=dev),
        key=key,
    )


def shard_state(state: ShardedProtocolState, graph: ShardedGraph, mesh,
                node_axes: Sequence[str], device=None):
    """This rank's arguments from the whole graph's: copies of its rows
    of the node tables, the rest replicated, on ``device`` (default: where
    they are)."""
    lo, n_local = _rows(state.last_seen.shape[0], mesh, node_axes)

    def put(x, sharded):
        x = x[lo:lo + n_local] if sharded else x
        return x.to(device, copy=True) if device is not None else x.clone()

    sharded = ("last_seen", "hist", "total")
    st = ShardedProtocolState(*(put(getattr(state, f), f in sharded) for f in state._fields))
    gr = ShardedGraph(*(put(getattr(graph, f), f != "node_up") for f in graph._fields))
    return st, gr


def gather_state(state: ShardedProtocolState, mesh,
                 node_axes: Sequence[str]) -> ShardedProtocolState:
    """The whole graph's state from every rank's rows (a collective over
    the default group: every rank of ``mesh`` calls it). Where shards
    repeat (a model axis), the lowest rank's rows are taken."""
    if mesh is None:
        return state
    names = tuple(mesh.mesh_dim_names)
    layout = mesh.mesh.numpy()
    shard_of = {}
    for coord in np.ndindex(layout.shape):
        s = 0
        for a in node_axes:
            i = names.index(a)
            s = s * layout.shape[i] + coord[i]
        shard_of[int(layout[coord])] = s
    owner = {}
    for rank in sorted(shard_of):
        owner.setdefault(shard_of[rank], rank)
    out = state._asdict()
    for f in ("last_seen", "hist", "total"):
        x = getattr(state, f).contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x)
        out[f] = torch.cat([parts[owner[s]] for s in range(len(owner))])
    return ShardedProtocolState(**out)


RECORD_CHUNK = 256  # rounds of Z a runner records in place between copies out


class ShardedRunner:
    """Rounds of one sharded ``step`` on static buffers: the state and the
    graph of a run are copied into tensors the runner owns, and Z is
    recorded in place at a device-side column, so the round index never
    passes through Python. With ``capture`` (CUDA tensors, NCCL's
    collectives or none) one round is captured as a CUDA graph at the
    first run and replayed once a round; the device ``t`` advances inside
    the graph. Without it the same round runs eagerly through the same
    buffers. The capture's warm-up runs one real round on throwaway
    copies on the capture's side stream (NCCL's communicator, the step's
    constant rows and the key's folds are made there, outside the
    capture). A failed capture or replay raises; nothing falls back to
    eager."""

    def __init__(self, step, capture: bool):
        self.step, self.capture = step, capture
        self.state = self.graph = None  # static buffers, made at the first run
        self.z = self.column = None
        self.captured = None
        self.capture_s = None  # host seconds of the warm-up and capture
        self.lock = threading.Lock()

    def _round(self) -> None:
        *st, z = self.step(*self.state, *self.graph)
        for d, s in zip(self.state, st):
            if d is not s:  # the node tables and the key are updated in place
                d.copy_(s)
        self.z.index_copy_(0, self.column, z.view(1))
        self.column.add_(1)

    def _warmup(self) -> None:
        self.step(*tree_clone(self.state), *self.graph)
        self.step.key_folds(self.state.key)

    def run(self, state: ShardedProtocolState, graph: ShardedGraph, rounds: int):
        """``rounds`` rounds from ``state``: (final state, Z per round as an
        int32 tensor on the state's device); neither aliases the runner's
        buffers. No host synchronisation."""
        with self.lock:
            if self.state is None:
                self.state, self.graph = tree_clone(state), tree_clone(graph)
                dev = state.pos.device
                self.z = torch.zeros((RECORD_CHUNK,), dtype=torch.int32, device=dev)
                self.column = torch.zeros((1,), dtype=torch.int64, device=dev)
            else:
                copy_into((self.state, self.graph), (state, graph))
            if self.capture and self.captured is None:
                # imported here: repro_torch.kernels imports this package
                from repro_torch.kernels.capture import Captured

                t0 = time.perf_counter()
                self.captured = Captured(self._round, warmup=self._warmup)
                self.capture_s = time.perf_counter() - t0
            self.step.key_folds(self.state.key)  # a new key's folds, before any replay
            zs = []
            for c0 in range(0, rounds, RECORD_CHUNK):
                n = min(RECORD_CHUNK, rounds - c0)
                self.column.zero_()
                if self.capture:
                    self.captured.replay(n)
                else:
                    for _ in range(n):
                        self._round()
                zs.append(self.z[:n].clone())
            z = torch.cat(zs) if zs else torch.zeros(0, dtype=torch.int32,
                                                     device=self.z.device)
            return tree_clone(self.state), z


def run_sharded(step, state: ShardedProtocolState, graph: ShardedGraph, rounds: int, *,
                capture: bool | None = None):
    """``rounds`` steps from ``state`` through the step's
    :class:`ShardedRunner` for the state's device; returns (final state,
    Z per round as an int32 tensor on the state's device). No host
    synchronisation.

    ``capture=None`` captures exactly when the collectives can be: CUDA
    tensors and NCCL's backend (or no collective, ``mesh=None``); over
    gloo (the CPU, or two ranks on one card) the rounds run eagerly.
    ``capture=False`` runs eagerly anywhere (the oracle a captured run is
    held to); ``capture=True`` where the rounds cannot be captured
    raises."""
    dev = state.pos.device
    capturable = dev.type == "cuda" and step.backend in (None, "nccl")
    if capture is None:
        capture = capturable
    elif capture and not capturable:
        why = (f"its collectives are {step.backend}'s, which do not capture"
               if step.backend not in (None, "nccl") else f"its tensors are on the {dev.type}")
        raise ValueError("a sharded round captures only on CUDA tensors over NCCL (or with no "
                         f"collective), and {why}: pass capture=False")
    key = (dev, bool(capture))
    runner = step.runners.get(key)
    if runner is None:
        runner = step.runners[key] = ShardedRunner(step, bool(capture))
    return runner.run(state, graph, rounds)
