"""Threat models: walk-level and topology-level failures (batched).

Counterpart of the JAX package's ``core/failures.py``: bursts,
probabilistic failures, the Byzantine 2-state chain, node crashes
(scheduled and i.i.d.), link failures and the single static Pac-Man.
``FailureConfig`` keeps the reference's fields; its numeric fields become
(batch,) tensors (schedules (batch, K)) through :func:`failure_rows`.
The zoo attacks (mobile or multi-node Pac-Man, edge cuts) are not ported
in this slice and raise.

Every model is branch-free on the rows: a disabled mechanism (rate 0,
node -1, time -1) is a numeric no-op on the same program.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.graphs.state import GraphState
from repro_torch.utils import prng

_SCHEDULES = (
    ("burst_times", "burst_sizes"),
    ("node_crash_times", "node_crash_ids"),
    ("edge_cut_times", "edge_cut_thresholds"),
)


@dataclasses.dataclass(frozen=True)
class FailureConfig:
    """Failure parameters (fields and defaults as in the reference).

    A burst time of -1 never fires, which is how padded stacks encode
    "fewer bursts than the widest row" (:func:`pad_bursts`).
    """

    burst_times: Tuple[int, ...] = ()
    burst_sizes: Tuple[int, ...] = ()
    p_fail: float = 0.0
    p_fail_start: int = 0
    byzantine_node: int = -1  # -1 disables
    p_byz: float = 0.0
    byz_start: bool = True
    byz_start_time: int = 0
    node_crash_times: Tuple[int, ...] = ()
    node_crash_ids: Tuple[int, ...] = ()
    p_node_fail: float = 0.0
    p_node_recover: float = 0.0
    node_fail_start: int = 0
    p_link_fail: float = 0.0
    p_link_recover: float = 0.0
    link_fail_start: int = 0
    pacman_node: int = -1
    pacman_start_time: int = 0
    pacman_nodes: Tuple[int, ...] = ()
    pacman_hop_prob: float = 1.0
    edge_cut_times: Tuple[int, ...] = ()
    edge_cut_thresholds: Tuple[int, ...] = ()
    pacman_mobile: bool = False

    def __post_init__(self):
        for a, b in _SCHEDULES:
            if len(getattr(self, a)) != len(getattr(self, b)):
                raise ValueError(f"{a} and {b} must align")
        for f in (
            "burst_times", "burst_sizes", "node_crash_times", "node_crash_ids",
            "pacman_nodes", "edge_cut_times", "edge_cut_thresholds",
        ):
            object.__setattr__(self, f, tuple(int(v) for v in getattr(self, f)))

    @property
    def n_bursts(self) -> int:
        return len(self.burst_times)

    @property
    def n_node_crashes(self) -> int:
        return len(self.node_crash_times)

    @property
    def n_pacman(self) -> int:
        return len(self.pacman_nodes)

    @property
    def n_edge_cuts(self) -> int:
        return len(self.edge_cut_times)

    @property
    def static_fields(self) -> tuple:
        return tuple(getattr(self, f) for f in _FAILURE_META)


_FAILURE_META = ("pacman_mobile",)
_FAILURE_DATA = tuple(
    f.name for f in dataclasses.fields(FailureConfig) if f.name not in _FAILURE_META
)


def check_ported(fcfg: FailureConfig) -> None:
    """Raise for a failure configuration this slice does not run."""
    if fcfg.pacman_mobile or fcfg.n_pacman:
        raise NotImplementedError(
            "mobile and multi-node Pac-Man are not ported yet "
            "(ROADMAP.md queue 1, item 7: zoo)"
        )
    if fcfg.n_edge_cuts:
        raise NotImplementedError(
            "scheduled edge cuts are not ported yet (ROADMAP.md queue 1, item 7: zoo)"
        )


class FailureRows(NamedTuple):
    """The numeric failure fields, one row per trajectory."""

    burst_times: torch.Tensor  # (batch, K) int32
    burst_sizes: torch.Tensor  # (batch, K) int32
    p_fail: torch.Tensor  # (batch,) float32
    p_fail_start: torch.Tensor  # (batch,) int32
    byzantine_node: torch.Tensor
    p_byz: torch.Tensor
    byz_start: torch.Tensor  # (batch,) bool
    byz_start_time: torch.Tensor
    node_crash_times: torch.Tensor  # (batch, Kc) int32
    node_crash_ids: torch.Tensor
    p_node_fail: torch.Tensor
    p_node_recover: torch.Tensor
    node_fail_start: torch.Tensor
    p_link_fail: torch.Tensor
    p_link_recover: torch.Tensor
    link_fail_start: torch.Tensor
    pacman_node: torch.Tensor
    pacman_start_time: torch.Tensor


_ROW_DTYPES = {
    "p_fail": torch.float32, "p_byz": torch.float32,
    "p_node_fail": torch.float32, "p_node_recover": torch.float32,
    "p_link_fail": torch.float32, "p_link_recover": torch.float32,
    "byz_start": torch.bool,
}


def failure_rows(cfgs: Sequence[FailureConfig], device) -> FailureRows:
    """Stack the numeric fields of ``cfgs`` (padded to common schedule
    lengths first)."""
    cfgs = pad_bursts(list(cfgs))
    cols = {}
    for f in FailureRows._fields:
        vals = [getattr(c, f) for c in cfgs]
        dtype = _ROW_DTYPES.get(f, torch.int32)
        cols[f] = torch.tensor(vals, dtype=dtype, device=device)
    return FailureRows(**cols)


def apply_probabilistic_failures(active, t, rows: FailureRows, keys, *, partitionable=True):
    """Each walk dies w.p. ``p_fail`` once ``t >= p_fail_start``."""
    u = prng.uniform(keys, active.shape[-1:], partitionable=partitionable)
    die = (u < rows.p_fail.view(-1, 1)) & (t >= rows.p_fail_start).view(-1, 1)
    return active & ~die


def burst_kills(active, u_burst, sizes_eff):
    """Kill, for each burst b in order, the ``sizes_eff[:, b]`` active
    walks of lowest score ``u_burst[:, b]`` (score rank among the active)."""
    for b in range(u_burst.shape[1]):
        score = torch.where(active, u_burst[:, b], torch.inf)
        rank = (score[..., :, None] > score[..., None, :]).sum(dim=-1)
        active = active & ~(rank < sizes_eff[:, b : b + 1])
    return active


def burst_uniforms(keys, K: int, W: int, *, partitionable=True):
    """(batch, K, W) burst score uniforms: ``fold_in(k_burst, i)``."""
    if K == 0:
        return torch.ones((keys.shape[0], 0, W), device=keys.device)
    ids = torch.arange(K, device=keys.device).view(K, 1)
    kk = prng.fold_in(keys, ids)  # (K, batch, 2)
    return prng.uniform(kk, (W,), partitionable=partitionable).transpose(0, 1)


def burst_sizes_eff(t, rows: FailureRows):
    """Burst sizes where ``t == burst_times``, else 0."""
    return torch.where(t.view(-1, 1) == rows.burst_times, rows.burst_sizes, 0)


def apply_burst_failures(active, t, rows: FailureRows, keys, *, partitionable=True):
    """Kill ``size`` uniformly random active walks at each scheduled time."""
    K = rows.burst_times.shape[1]
    u = burst_uniforms(keys, K, active.shape[-1], partitionable=partitionable)
    return burst_kills(active, u, burst_sizes_eff(t, rows))


def byzantine_kill_node(t, byz_state, rows: FailureRows, keys, *, partitionable=True):
    """Advance the 2-state chain; returns ``(byz_state, kill_node)`` with
    ``kill_node`` -1 where the node kills nobody this round."""
    armed = (t >= rows.byz_start_time) & (rows.byzantine_node >= 0)
    flip = (prng.uniform(keys, (), partitionable=partitionable) < rows.p_byz) & armed
    byz_state = byz_state ^ flip
    kill = torch.where(byz_state & armed, rows.byzantine_node, -1)
    return byz_state, kill


def step_byzantine(active, pos, t, byz_state, rows: FailureRows, keys, *, partitionable=True):
    """Advance the chain and kill the walks sitting on the Byz node."""
    byz_state, kill_node = byzantine_kill_node(
        t, byz_state, rows, keys, partitionable=partitionable
    )
    return active & ~(pos == kill_node.view(-1, 1)), byz_state


def pacman_kill_node(t, rows: FailureRows):
    """The single static Pac-Man's node where armed, else -1."""
    armed = (t >= rows.pacman_start_time) & (rows.pacman_node >= 0)
    return torch.where(armed, rows.pacman_node, -1)


def apply_pacman(active, pos, t, rows: FailureRows):
    """The static Pac-Man silently absorbs every walk stepping onto it."""
    return active & ~(pos == pacman_kill_node(t, rows).view(-1, 1))


def topology_uniforms(keys, neighbors, mirror, *, partitionable=True):
    """One step's topology uniforms: node crash / recovery (batch, n) and
    the mirror-symmetrized link fail / recovery (batch, n, D) — one draw
    per undirected edge, living at the lower endpoint."""
    n, D = neighbors.shape
    sub = prng.split(keys, 4, partitionable=partitionable).transpose(0, 1)
    u_node = prng.uniform(sub[:2], (n,), partitionable=partitionable)
    u_edge = prng.uniform(sub[2:], (n, D), partitionable=partitionable)
    ids = torch.arange(n, device=neighbors.device)
    lower = ids[:, None] < neighbors
    mirrored = u_edge[:, :, neighbors.long(), mirror.long()]
    e = torch.where(lower, u_edge, mirrored)
    return u_node[0], u_node[1], e[0], e[1]


def scheduled_crash_mask(n: int, t, rows: FailureRows):
    """(batch, n) bool — nodes downed by a schedule entry firing at t."""
    ids = torch.arange(n, device=t.device)
    down = torch.zeros((t.shape[0], n), dtype=torch.bool, device=t.device)
    for i in range(rows.node_crash_times.shape[1]):
        cid = rows.node_crash_ids[:, i : i + 1]
        fire = (t.view(-1, 1) == rows.node_crash_times[:, i : i + 1]) & (cid >= 0)
        down = down | ((ids == cid) & fire)
    return down


def gate(t, start, rate):
    """A start-gated rate: ``rate`` once ``t >= start``, else -1 (uniforms
    in [0, 1) are never below -1)."""
    return torch.where(t >= start, rate, torch.full_like(rate, -1.0))


def apply_topology(gs: GraphState, t, rows: FailureRows, sched_down, u_nfail, u_nrec, e_fail, e_rec):
    """Pure mask update given pre-drawn uniforms."""
    p_nf = gate(t, rows.node_fail_start, rows.p_node_fail).view(-1, 1)
    crash = u_nfail < p_nf
    recover = u_nrec < rows.p_node_recover.view(-1, 1)
    node_up = torch.where(gs.node_up, ~(crash | sched_down), recover & ~sched_down)
    p_lf = gate(t, rows.link_fail_start, rows.p_link_fail).view(-1, 1, 1)
    fail = e_fail < p_lf
    rec = e_rec < rows.p_link_recover.view(-1, 1, 1)
    edge_up = torch.where(gs.edge_up, ~fail, rec)
    return GraphState(node_up=node_up, edge_up=edge_up)


def step_topology(gs, t, rows, keys, neighbors, mirror, *, partitionable=True):
    """Advance the live topology one step (``topology_uniforms`` then
    ``apply_topology``, as in the reference)."""
    u_nfail, u_nrec, e_fail, e_rec = topology_uniforms(
        keys, neighbors, mirror, partitionable=partitionable
    )
    sched = scheduled_crash_mask(neighbors.shape[0], t, rows)
    return apply_topology(gs, t, rows, sched, u_nfail, u_nrec, e_fail, e_rec)


def kill_resident_walks(active, pos, node_up):
    """A node crash takes its resident walks down with it."""
    return active & torch.gather(node_up, 1, pos.long())


def pad_bursts(cfgs: Sequence[FailureConfig]):
    """Pad configs to common schedule lengths (time/id -1 never fires)."""
    widths = {
        a: max((len(getattr(c, a)) for c in cfgs), default=0)
        for pair in _SCHEDULES for a in pair
    }
    fills = {"burst_sizes": 0}

    def pad(c):
        upd = {}
        for a, k in widths.items():
            v = getattr(c, a)
            if len(v) < k:
                upd[a] = v + (fills.get(a, -1),) * (k - len(v))
        return dataclasses.replace(c, **upd) if upd else c

    return [pad(c) for c in cfgs]
