"""The multi-walk simulator (counterpart of the JAX package's
``core/simulator.py``), batched over trajectories.

One synchronous round (t -> t+1), as in the reference:
  1. the topology evolves (scheduled edge cuts included); a crashing
     node kills its resident walks; a mobile Pac-Man hops (stream tag 7);
  2. every surviving walk hops to a uniform available neighbor, or by
     its zoo variant's rule (``zoo.variants.move_variant``);
  3. walk-level failures strike (probabilistic, burst, Byzantine,
     Pac-Man: one node, several, or the mobile positions);
  4. every visited node records return-time samples and last-seen times;
  5. the chosen walk's node computes theta-hat (Eq. 1) and decides
     (DecAFork fork, DecAFork+ fork or terminate, MissingPerson timeout
     replacement; ``"none"`` decides nothing);
  6. forks and terminations execute through the slot machinery.

The state carries a leading batch axis (one row per trajectory). The
reference's jitted ``lax.scan`` is :class:`RoundRunner`: one round
captured as a CUDA graph and replayed per round (eagerly through the
same static buffers on the CPU); ``run_rounds`` is the eager Python loop
over rounds it is held to. Every random stream folds the carried step
counter ``t``, so where a run is cut cannot change a drawn bit. Two
round implementations exist:

  - ``protocol_step_unfused``: the literal stage sequence, the oracle
    (``round_impl="unfused"``); its estimator is ``gather``, ``compare``,
    ``pallas`` (the theta_sums kernel) or ``fused`` (the round_update
    kernel), with the analytic survival of footnote 5 and the auto_eps
    thresholds as options; MissingPerson and ``"none"`` run only here;
  - ``protocol_step_fused`` (DecAFork / DecAFork+): the whole round in
    the whole_round kernel, with every uniform drawn outside from the
    same streams, the Byzantine chain advanced outside and the start
    gates folded into the rates (the reference's Pallas branch,
    simulator.py:653-745).

The observation state (``last_seen``, ``hist``, ``total``) is updated in
place round to round: a round writes W rows of an n-row table.

A run may carry a payload (``core.payload.Payload``, e.g. the RW-SGD
replicas of ``optim.rw_sgd``): its carry rides beside the state, and
each round runs, in the reference's order (simulator.py:863-871 there),
the round's payload key ``fold_in_time(key, t, PAYLOAD_STREAM)`` from the
pre-round ``t``, then the protocol round, then ``on_terminate``,
``on_fork`` and ``on_visit`` (:func:`payload_round`). The payload's keys
are streams the round never draws from, so its ``StepOutputs`` are
bitwise those of the payload-free run.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import estimator as est
from repro_torch.core import failures as flr
from repro_torch.core import protocol as prt
from repro_torch.core import walkers as wlk
from repro_torch.core.payload import PAYLOAD_STREAM, payload_init_key
from repro_torch.core.outputs import (
    SCALARS,
    OutputSpec,
    PayloadOutputSpec,
    RecordedOutputs,
    StepOutputs,
    empty_recording,
    stack_rounds,
)
from repro_torch.graphs.generators import Graph
from repro_torch.graphs.spectral import stationary_distribution
from repro_torch.graphs.state import (
    GraphState,
    availability,
    init_graph_state,
    mirror_indices,
)
from repro_torch.kernels import platform
from repro_torch.kernels.capture import Captured
from repro_torch.kernels.round_update import round_update, whole_round
from repro_torch.kernels.theta_survival import theta_sums
from repro_torch.utils import prng, trace
from repro_torch.utils.tree import copy_into, tree_clone, tree_leaves


class SimState(NamedTuple):
    t: torch.Tensor  # (batch,) int32 step counter
    walks: wlk.WalkState
    last_seen: torch.Tensor  # (batch, n, W) int32
    rts: est.ReturnTimeState
    byz_state: torch.Tensor  # (batch,) bool
    key: torch.Tensor  # (batch, 2) threefry key words
    graph: GraphState
    theta_hist: torch.Tensor  # (batch, n, TB) float32 auto_eps warm-up histogram
    # (batch, 1+K) int32 Pac-Man positions of a mobile run, else None
    pacman_pos: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class Setup:
    """What every round of a batch of trajectories shares: the graph on
    the device, the static protocol config and the per-trajectory rows.
    ``steps`` (the run's budget) trims the gather estimator's bins;
    ``pi`` is the graph's stationary distribution when the survival is
    analytic. ``fcfg`` is the batch's first failure config, padded: its
    static fields (``pacman_mobile``, the schedule widths) are the
    batch's."""

    neighbors: torch.Tensor  # (n, D) int32
    degrees: torch.Tensor  # (n,) int32
    mirror: torch.Tensor  # (n, D) int32
    pcfg: prt.ProtocolConfig
    prows: prt.ProtocolRows
    frows: flr.FailureRows
    steps: int
    partitionable: bool = True
    pi: torch.Tensor | None = None  # (n,) float32
    fcfg: flr.FailureConfig = flr.FailureConfig()

    @property
    def n(self) -> int:
        return int(self.neighbors.shape[0])


def make_setup(graph: Graph, pcfgs, fcfgs, steps: int, device, partitionable=True) -> Setup:
    """Move the graph to ``device`` and stack one protocol / failure row per trajectory. The rows must share
    the static protocol fields (they run one program)."""
    pcfg = pcfgs[0]
    if any(p.static_fields != pcfg.static_fields for p in pcfgs):
        raise ValueError("trajectories of one batch must share the static protocol fields")
    if any(f.static_fields != fcfgs[0].static_fields for f in fcfgs):
        raise ValueError("trajectories of one batch must share the static failure fields")

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)

    return Setup(
        neighbors=dev(graph.neighbors),
        degrees=dev(graph.degrees),
        mirror=dev(mirror_indices(graph)),
        pcfg=pcfg,
        prows=prt.protocol_rows(pcfgs, device),
        frows=flr.failure_rows(fcfgs, device),
        steps=int(steps),
        partitionable=partitionable,
        pi=(
            torch.as_tensor(stationary_distribution(graph), dtype=torch.float32, device=device)
            if pcfg.analytic_survival else None
        ),
        fcfg=flr.pad_bursts(list(fcfgs))[0],
    )


def init_state(keys: torch.Tensor, setup: Setup) -> SimState:
    """Initial state for one trajectory per key row (``keys`` (batch, 2))."""
    pcfg = setup.pcfg
    W = pcfg.max_walks
    n, D = setup.neighbors.shape
    batch = keys.shape[0]
    sub = prng.split(keys, 2, partitionable=setup.partitionable)
    walks = wlk.init_walks(
        setup.prows.z0, W, n, sub[:, 0], partitionable=setup.partitionable
    )
    if pcfg.walk_variant != "uniform":
        # the zoo package (which registers its experiment with the api)
        # loads only when a variant runs
        from repro_torch.zoo.variants import init_variant_state

        walks = init_variant_state(walks, pcfg)
    if pcfg.algorithm == "missingperson":
        # paper: L_{i,l}(0) = 0 for every initial id at every node
        ids = torch.arange(W, device=keys.device).view(1, 1, W)
        last_seen = torch.where(ids < setup.prows.z0.view(-1, 1, 1), 0, est.NEVER)
        last_seen = last_seen.to(torch.int32).expand(batch, n, W).contiguous()
    else:
        last_seen = torch.full((batch, n, W), est.NEVER, dtype=torch.int32, device=keys.device)
        # the starting node of each initial walk has seen it at t=0
        est.scatter_max_last_seen(
            last_seen, walks.pos, walks.track,
            torch.where(walks.active, 0, est.NEVER).to(torch.int32),
        )
    return SimState(
        t=torch.zeros((batch,), dtype=torch.int32, device=keys.device),
        walks=walks,
        last_seen=last_seen,
        rts=est.init_return_time_state(batch, n, pcfg.rt_bins, keys.device),
        byz_state=setup.frows.byz_start.clone(),
        key=sub[:, 1],
        graph=init_graph_state(batch, n, D, keys.device),
        theta_hist=torch.zeros(
            (batch, n, prt.theta_bins(pcfg)), dtype=torch.float32, device=keys.device
        ),
        pacman_pos=(
            flr.initial_pacman_positions(setup.frows) if setup.fcfg.pacman_mobile else None
        ),
    )


def resolved_estimator_impl(pcfg: prt.ProtocolConfig) -> str:
    impl = pcfg.estimator_impl
    return platform.best_estimator_impl() if impl == "auto" else impl


def resolved_round_impl(pcfg: prt.ProtocolConfig) -> str:
    impl = pcfg.round_impl
    return platform.best_round_impl() if impl == "auto" else impl


class RoundDecision(NamedTuple):
    """How one configuration's rounds execute, and why."""

    impl: str  # 'fused' | 'unfused'
    backend: str | None  # 'kernel' when fused
    reason: str

    @property
    def fused(self) -> bool:
        return self.impl == "fused"


def round_impl_decision(
    pcfg: prt.ProtocolConfig, fcfg: flr.FailureConfig | None = None
) -> RoundDecision:
    """The whole-round fuse predicate with its reason (simulator.py:237-307
    of the reference, for its Pallas backend): the kernel computes the
    node-sum theta family, so the gather family takes the unfused round."""

    def unfused(reason):
        return RoundDecision("unfused", None, reason)

    impl = resolved_round_impl(pcfg)
    if impl != "fused":
        return unfused(f"round_impl resolved to {impl!r}")
    if pcfg.algorithm not in prt.FUSED_ALGORITHMS:
        return unfused(f"algorithm {pcfg.algorithm!r} has no fused round")
    if pcfg.analytic_survival:
        return unfused("analytic_survival only runs the stage sequence")
    if pcfg.auto_eps:
        return unfused("auto_eps thresholds only run the stage sequence")
    eimpl = resolved_estimator_impl(pcfg)
    if eimpl not in platform.NODE_SUM_FAMILY:
        return unfused(
            f"estimator_impl {eimpl!r} is outside the whole_round kernel's "
            "node-sum family"
        )
    if pcfg.walk_variant != "uniform":
        return unfused(f"walk_variant {pcfg.walk_variant!r} has no fused round")
    if fcfg is not None:
        if fcfg.pacman_mobile:
            return unfused("mobile Pac-Man is not in the whole_round kernel")
        if fcfg.n_pacman:
            return unfused("multiple Pac-Man nodes are not in the whole_round kernel")
        if fcfg.n_edge_cuts:
            return unfused("scheduled edge cuts are not in the whole_round kernel")
    backend = platform.FUSED_ROUND_BACKEND
    return RoundDecision("fused", backend, f"all stages supported by the {backend} fused round")


def _stream_keys(state: SimState, setup: Setup) -> torch.Tensor:
    """(6, batch, 2): ``fold_in_time(key, t, tag)`` for the reference
    round's stream tags 0-5, in order: move, probabilistic failure,
    burst, Byzantine, decision, topology."""
    tags = torch.arange(6, device=state.key.device).view(6, 1)
    return prng.fold_in_time(state.key, state.t, tags)


def _decafork_tail(ws, last_seen, t, theta, chosen, fork_mask, term_mask):
    """DecAFork / DecAFork+ forks and terminations through the slot
    machinery (shared by both round implementations): ``(ws, last_seen,
    n_forks, n_terms, fork_parent, theta_mean)``."""
    ws = wlk.execute_terminations(ws, term_mask)
    n_terms = term_mask.sum(dim=1, dtype=torch.int32)
    ws, last_seen, n_forks, fork_parent = wlk.execute_forks(
        ws, last_seen, fork_mask, ws.pos, None, t
    )
    theta_mean = torch.where(chosen, theta, 0.0).sum(dim=1) / torch.clamp(
        chosen.sum(dim=1, dtype=torch.int32), min=1
    )
    return ws, last_seen, n_forks, n_terms, fork_parent, theta_mean


def _round_result(state, ws, last_seen, rts, byz_state, gs, theta_hist, n_failed,
                  n_forks, n_terms, fork_parent, theta_mean, term_mask, pacman_pos=None):
    """The next state and the round's outputs."""
    new = SimState(
        t=state.t + 1, walks=ws, last_seen=last_seen, rts=rts, byz_state=byz_state,
        key=state.key, graph=gs, theta_hist=theta_hist, pacman_pos=pacman_pos,
    )
    out = StepOutputs(
        z=ws.active.sum(dim=1, dtype=torch.int32),
        forks=n_forks,
        terms=n_terms,
        failures=n_failed,
        theta_mean=theta_mean,
        fork_parent=fork_parent,
        terminated=term_mask,
    )
    return new, out


def _node_sum_theta(impl, last_seen, rts, t, pos):
    if impl == "compare":
        return est.theta_hat_from_node_sums(
            est.node_sums_compare(last_seen, rts.hist, rts.total, t), pos
        )
    if impl == "pallas":
        return est.theta_hat_from_node_sums(theta_sums(last_seen, rts.hist, rts.total, t), pos)
    raise ValueError(f"unknown estimator_impl {impl!r}")


def protocol_step_unfused(state: SimState, setup: Setup):
    """One round as the literal stage sequence (the oracle)."""
    part = setup.partitionable
    pcfg, prows, frows = setup.pcfg, setup.prows, setup.frows
    nbr, deg = setup.neighbors, setup.degrees
    with trace.stage("keys"):
        k_move, k_pfail, k_burst, k_byz, k_dec, k_topo = _stream_keys(state, setup)
    t = state.t
    ws = state.walks
    n_before = ws.active.sum(dim=1, dtype=torch.int32)

    # 1. topology (scheduled edge cuts included); a crashing node kills
    # its resident walks
    with trace.stage("topology"):
        gs = flr.step_topology(state.graph, t, frows, k_topo, nbr, setup.mirror,
                               partitionable=part)
        ws = ws._replace(active=flr.kill_resident_walks(ws.active, ws.pos, gs.node_up))
        avail = availability(gs, nbr, deg)
        # 1b. a mobile Pac-Man hops over the same live topology, on its own
        # stream (tag 7)
        pac_pos = state.pacman_pos
        if setup.fcfg.pacman_mobile:
            k_pac = prng.fold_in_time(state.key, t, 7)
            pac_pos = flr.step_mobile_pacman(pac_pos, t, frows, k_pac, nbr, avail,
                                             partitionable=part)
    # 2. movement over the available edges (the zoo's variants by their rule)
    with trace.stage("hop"):
        if pcfg.walk_variant == "uniform":
            ws = wlk.move_walks(ws, nbr, deg, k_move, avail, partitionable=part)
        else:
            from repro_torch.zoo.variants import move_variant

            ws = move_variant(ws, pcfg, prows, nbr, deg, k_move, avail, gs.node_up,
                              partitionable=part)
    # 3. walk-level threat models
    with trace.stage("failures"):
        active = flr.apply_probabilistic_failures(ws.active, t, frows, k_pfail,
                                                  partitionable=part)
        active = flr.apply_burst_failures(active, t, frows, k_burst, partitionable=part)
        active, byz_state = flr.step_byzantine(
            active, ws.pos, t, state.byz_state, frows, k_byz, partitionable=part
        )
        active = flr.apply_pacman(active, ws.pos, t, frows, pac_pos)
        ws = ws._replace(active=active)
        n_failed = n_before - active.sum(dim=1, dtype=torch.int32)

    # 4. observations for all visitors; the round_update kernel fuses
    # them with the node sums where those are the estimate
    impl = resolved_estimator_impl(pcfg)
    decafork = pcfg.algorithm in prt.FUSED_ALGORITHMS
    fuse = impl == "fused" and decafork and setup.pi is None
    last_seen = state.last_seen
    with trace.stage("observation"):
        prev = est.gather_rows(last_seen, ws.pos).gather(2, ws.track.long()[..., None])[..., 0]
        tc = t.view(-1, 1)
        r = tc - prev
        valid = active & (prev != est.NEVER) & (r >= 1)
        upd = torch.where(active, tc, est.NEVER).to(torch.int32)
        if fuse:
            last_seen, hist, total, node_sums = round_update(
                last_seen, state.rts.hist, state.rts.total, ws.pos, ws.track,
                r, valid, upd, t,
            )
            rts = est.ReturnTimeState(hist, total)
        else:
            rts = est.record_returns(state.rts, ws.pos, r, valid)
            est.scatter_max_last_seen(last_seen, ws.pos, ws.track, upd)

    # 5. estimation and decisions for the chosen walks
    theta_hist = state.theta_hist
    batch, W = ws.pos.shape
    with trace.stage("decisions"):
        chosen = prt.choose_walks(ws.pos, active, setup.n)
        enabled = t >= prows.protocol_start
        if decafork:
            if fuse:
                theta = est.theta_hat_from_node_sums(node_sums, ws.pos)
            elif impl == "gather" or setup.pi is not None:
                theta = est.theta_hat_rows(
                    last_seen, rts.hist, rts.total, t, ws.pos, ws.track,
                    pi=setup.pi, max_elapsed=setup.steps,
                )
            else:
                theta = _node_sum_theta(impl, last_seen, rts, t, ws.pos)
            eps = eps2 = None
            if pcfg.auto_eps:
                # per-node thresholds from the warm-up theta-hat histogram:
                # each chosen walk adds an exact 1.0 to its node's bin
                TB = theta_hist.shape[2]
                b = torch.clamp(
                    (theta / prows.theta_bin_width.view(-1, 1)).to(torch.int32), 0, TB - 1
                )
                w = (chosen & ~enabled.view(-1, 1)).to(torch.float32)
                flat = (est._flat_rows(batch, setup.n, ws.pos) * TB + b.long()).reshape(-1)
                theta_hist.view(-1).index_put_((flat,), w.reshape(-1), accumulate=True)
                eps, eps2 = prt.theta_quantile_thresholds(theta_hist, ws.pos, prows)
            fork_mask, term_mask = prt.decafork_decisions(
                theta, chosen, k_dec, prows, enabled, pcfg.algorithm == "decafork+",
                eps, eps2, partitionable=part,
            )
        elif pcfg.algorithm == "missingperson":
            ev = prt.missingperson_decisions(
                last_seen, ws.pos, ws.track, chosen, t, k_dec, prows, enabled,
                partitionable=part,
            )  # (batch, W, C): only initial-id columns (< z0) can fire
    with trace.stage("slots"):
        if decafork:
            ws, last_seen, n_forks, n_terms, fork_parent, theta_mean = _decafork_tail(
                ws, last_seen, t, theta, chosen, fork_mask, term_mask
            )
        else:
            zeros = torch.zeros((batch,), dtype=torch.int32, device=t.device)
            n_terms, theta_mean = zeros, zeros.float()
            term_mask = torch.zeros_like(active)
            if pcfg.algorithm == "missingperson":
                ws, last_seen, n_forks, fork_parent = wlk.execute_grid_forks(
                    ws, last_seen, ev, t)
            else:  # "none": the walks with no self-regulation
                n_forks = zeros
                fork_parent = torch.full_like(ws.pos, -1)
    return _round_result(state, ws, last_seen, rts, byz_state, gs, theta_hist, n_failed,
                         n_forks, n_terms, fork_parent, theta_mean, term_mask, pac_pos)


def protocol_step_fused(state: SimState, setup: Setup):
    """One round through the whole_round kernel; every uniform is drawn
    here from the streams the unfused sequence consumes."""
    part = setup.partitionable
    pcfg, prows, frows = setup.pcfg, setup.prows, setup.frows
    with trace.stage("keys"):
        k_move, k_pfail, k_burst, k_byz, k_dec, k_topo = _stream_keys(state, setup)
    t = state.t
    ws = state.walks
    W = ws.pos.shape[1]
    K = frows.burst_times.shape[1]
    n_before = ws.active.sum(dim=1, dtype=torch.int32)

    with trace.stage("draws"):
        # the walk-sized uniforms in one draw: move, pfail, fork, term, bursts
        dec = prng.split(k_dec, 2, partitionable=part)
        walk_keys = [k_move[None], k_pfail[None], dec[:, 0][None], dec[:, 1][None]]
        if K:
            ids = torch.arange(K, device=t.device).view(K, 1)
            walk_keys.append(prng.fold_in(k_burst, ids))
        u = prng.uniform(torch.cat(walk_keys), (W,), partitionable=part)
        u_burst = u[4:].transpose(0, 1).contiguous()
        u_nfail, u_nrec, e_fail, e_rec = flr.topology_uniforms(
            k_topo, setup.neighbors, setup.mirror, partitionable=part
        )
    with trace.stage("gates"):
        sched = flr.scheduled_crash_mask(setup.n, t, frows)
        # the Byzantine chain advances outside; the kernel needs the node
        byz_state, byz_kill = flr.byzantine_kill_node(
            t, state.byz_state, frows, k_byz, partitionable=part
        )
        enabled = t >= prows.protocol_start
        params_f = torch.stack(
            [
                flr.gate(t, frows.p_fail_start, frows.p_fail),
                flr.gate(t, frows.node_fail_start, frows.p_node_fail),
                flr.gate(t, frows.link_fail_start, frows.p_link_fail),
                frows.p_node_recover, frows.p_link_recover,
                prows.eps, prows.eps2, prows.p,
            ],
            dim=1,
        )
        params_i = torch.stack(
            [t, byz_kill, flr.pacman_kill_node(t, frows), enabled.to(torch.int32)], dim=1
        ).to(torch.int32)
        sizes_eff = flr.burst_sizes_eff(t, frows)
    with trace.stage("whole_round"):
        (last_seen, hist, total, node_up, edge_up, pos, active, theta, chosen,
         fork_mask, term_mask) = whole_round(
            state.last_seen, state.rts.hist, state.rts.total,
            state.graph.node_up, state.graph.edge_up,
            ws.pos, ws.track, ws.active, setup.neighbors, setup.degrees,
            u[0], u[1], u[2], u[3], u_burst, sizes_eff,
            u_nfail, u_nrec, sched, e_fail.contiguous(), e_rec.contiguous(),
            params_f, params_i,
            decafork_plus=pcfg.algorithm == "decafork+",
        )
    ws = ws._replace(pos=pos, active=active)
    n_failed = n_before - active.sum(dim=1, dtype=torch.int32)
    with trace.stage("slots"):
        ws, last_seen, n_forks, n_terms, fork_parent, theta_mean = _decafork_tail(
            ws, last_seen, t, theta, chosen, fork_mask, term_mask
        )
    return _round_result(
        state, ws, last_seen, est.ReturnTimeState(hist, total), byz_state,
        GraphState(node_up, edge_up), state.theta_hist, n_failed,
        n_forks, n_terms, fork_parent, theta_mean, term_mask,
    )


def protocol_step(state: SimState, setup: Setup, decision: RoundDecision | None = None):
    """One round, dispatched by :func:`round_impl_decision`."""
    if decision is None:
        decision = round_impl_decision(setup.pcfg, setup.fcfg)
    if decision.fused:
        return protocol_step_fused(state, setup)
    return protocol_step_unfused(state, setup)


def init_payload(keys: torch.Tensor, setup: Setup, payload):
    """The payload carry of every trajectory row of ``keys`` (batch, 2),
    from ``payload_init_key`` of each row's run key."""
    return payload.init(payload_init_key(keys), partitionable=setup.partitionable)


def init_carry(keys: torch.Tensor, setup: Setup, payload=None):
    """The step-0 carry of every trajectory row of ``keys``: ``(SimState,
    payload carry | None)``, the one initialisation a straight run and
    the first segment of a segmented run both start from (the
    reference's ``_init_carry`` and its ensemble and sweep forms; the
    port's state has no observation padding, so nothing is stripped at
    the end as the reference's ``_finalize_segmented`` does)."""
    state = init_state(keys, setup)
    return state, (None if payload is None else init_payload(keys, setup, payload))


def payload_round(state: SimState, carry, setup: Setup, payload,
                  decision: RoundDecision | None = None):
    """One round with a payload, in the reference's order: the payload
    key from the pre-round ``t``, the protocol round, then
    ``on_terminate``, ``on_fork`` and ``on_visit`` (which sees the walks
    after the round's hop). Returns ``(state, outputs, carry,
    payload outputs)``."""
    t = state.t
    k_visit = prng.fold_in_time(state.key, t, PAYLOAD_STREAM)
    new, out = protocol_step(state, setup, decision)
    carry = payload.on_terminate(carry, out.terminated)
    carry = payload.on_fork(carry, out.fork_parent)
    carry, pout = payload.on_visit(carry, new.walks, t, k_visit,
                                   partitionable=setup.partitionable)
    return new, out, carry, pout


def _payload_record(pout, pspec: PayloadOutputSpec | None) -> tuple:
    """The tensors of one round's payload outputs that a run records:
    ``pspec``'s fields, or every field of the payload's outputs."""
    sel = pout if pspec is None else pspec.select(pout)
    vals = tuple(sel)
    if not all(isinstance(v, torch.Tensor) for v in vals):
        raise TypeError("payload outputs must be a NamedTuple of tensors or ()")
    return vals


def _payload_outputs(pout, pspec: PayloadOutputSpec | None, values: tuple):
    """Recorded payload values in the outputs' own structure: the
    payload's NamedTuple (or ``()``), or the selection's RecordedOutputs."""
    if pspec is not None:
        return RecordedOutputs(pspec.select(pout)._fields, values)
    return type(pout)(*values) if hasattr(pout, "_fields") else tuple(values)


def run_rounds(state: SimState, setup: Setup, length: int, spec: OutputSpec = SCALARS,
               decision: RoundDecision | None = None, payload=None, carry=None,
               pspec: PayloadOutputSpec | None = None):
    """Advance ``length`` rounds; returns the final state and the
    recorded outputs with (batch, length, ...) fields. With a payload,
    ``((state, carry), (outputs, payload outputs))``, the payload's
    outputs stacked the same way."""
    if decision is None:
        decision = round_impl_decision(setup.pcfg, setup.fcfg)
    rounds, prounds, pout = [], [], ()  # only each round's recorded fields are kept
    for _ in range(length):
        if payload is None:
            state, out = protocol_step(state, setup, decision)
        else:
            state, out, carry, pout = payload_round(state, carry, setup, payload, decision)
            prounds.append(_payload_record(pout, pspec))
        rounds.append(tuple(getattr(out, f) for f in spec.fields))
    rec = stack_rounds(spec, rounds)
    if payload is None:
        return state, rec
    values = tuple(torch.stack(field, dim=1) for field in zip(*prounds))
    return (state, carry), (rec, _payload_outputs(pout, pspec, values))


def run_core(keys: torch.Tensor, setup: Setup, spec: OutputSpec = SCALARS,
             decision: RoundDecision | None = None):
    """One trajectory per key row, ``setup.steps`` rounds from the
    initial state, eagerly: ``(final SimState, RecordedOutputs)``."""
    return run_rounds(init_state(keys, setup), setup, setup.steps, spec, decision)


# ---------------------------------------------------------------------------
# Captured rounds
# ---------------------------------------------------------------------------


def _setup_tensors(setup: Setup) -> tuple:
    return (setup.neighbors, setup.degrees, setup.mirror, setup.prows, setup.frows, setup.pi)


RECORD_CHUNK = 256  # rounds a runner records in place between copies out


class RoundRunner:
    """``setup.steps`` rounds of one static structure (Setup shapes and
    static protocol fields, RoundDecision, OutputSpec, batch, payload),
    run as the reference runs its jitted scan: on CUDA one round is
    captured as a CUDA graph at the first run and replayed once per
    round; on the CPU the same round runs eagerly through the same
    buffers.

    The runner owns static inputs: the ``SimState`` fields, the payload's
    carry (a payload's replicas, say), the Setup's tensors (graph,
    protocol and failure rows) and recording buffers of ``RECORD_CHUNK``
    rounds for the step outputs and the payload's outputs. A run copies
    the caller's state, carry and setup values into them, so re-running
    with new keys, thresholds, rates or schedules captures nothing new.
    The captured round ends by copying the next state and carry into the
    static ones and writing each recorded field at a device-side column
    of the chunk, so the round index never passes through Python; after
    each chunk the run copies it into that run's own (batch, steps, ...)
    outputs. What a runner keeps between runs is therefore independent
    of ``steps``, and results never alias its buffers. With a payload
    the captured round holds the payload's whole step (on_visit's
    forward, backward and optimizer update for RW-SGD). A failed capture
    or replay raises; there is no eager fallback on CUDA. The capture's
    warm-up runs one real round on throwaway copies of the state and the
    carry (its kernel launches count); each replay adds the captured
    graph's kernel nodes to their wrappers' counters
    (``kernels.capture.Captured``)."""

    def __init__(self, setup: Setup, spec: OutputSpec, decision: RoundDecision,
                 payload=None, pspec: PayloadOutputSpec | None = None):
        self.spec, self.decision, self.steps = spec, decision, setup.steps
        self.payload, self.pspec = payload, pspec
        nbr, deg, mir, prows, frows, pi = tree_clone(_setup_tensors(setup))
        self.setup = dataclasses.replace(setup, neighbors=nbr, degrees=deg, mirror=mir,
                                         prows=prows, frows=frows, pi=pi)
        dev = nbr.device
        self.state = None  # the static SimState, allocated at the first run
        self.carry = None  # the static payload carry, likewise
        self.batch, self.walks = int(prows.z0.shape[0]), setup.pcfg.max_walks
        self.chunk = max(1, min(RECORD_CHUNK, self.steps))
        self.recorded = empty_recording(spec, self.batch, self.chunk, self.walks, dev)
        self.precorded = None  # the payload outputs' chunk, shaped at the first round
        self.pout = None  # one round's payload outputs (their structure)
        self.column = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.graph = None
        self.capture_s = None  # host seconds of the warm-up and capture
        self.lock = threading.Lock()  # held for each run (api.service runs threads)
        self.done = None  # CUDA event: the last run's work, which the next one waits for

    @property
    def captures(self) -> int:
        """CUDA graphs captured: 1 once a CUDA run has captured, else 0."""
        return int(self.graph is not None)

    def _step(self, state, carry):
        """One round from ``state`` (and ``carry``): ``(state, outputs,
        carry, payload outputs)``."""
        if self.payload is None:
            new, out = protocol_step(state, self.setup, self.decision)
            return new, out, None, ()
        return payload_round(state, carry, self.setup, self.payload, self.decision)

    def _payload_buffers(self, pout) -> None:
        """The payload outputs' recording chunk, (batch, chunk, ...) per
        recorded field, made from the first round's outputs."""
        if self.precorded is None:
            self.pout = pout
            self.precorded = tuple(
                torch.empty((v.shape[0], self.chunk) + tuple(v.shape[1:]), dtype=v.dtype,
                            device=v.device)
                for v in _payload_record(pout, self.pspec))

    def _round(self) -> None:
        """One round on the static buffers: the captured work."""
        new, out, carry, pout = self._step(self.state, self.carry)
        with trace.stage("commit"):
            for d, s in zip(tree_leaves((self.state, self.carry)), tree_leaves((new, carry))):
                d.copy_(s)  # the next state in place (a no-op where updated in place)
            for buf, f in zip(self.recorded, self.spec.fields):
                buf.index_copy_(1, self.column, getattr(out, f).unsqueeze(1))
            if self.payload is not None:
                self._payload_buffers(pout)
                for buf, v in zip(self.precorded, _payload_record(pout, self.pspec)):
                    buf.index_copy_(1, self.column, v.unsqueeze(1))
            self.column.add_(1)

    def _warmup(self) -> None:
        """A real round on throwaway copies of the state and the carry
        (the capture's warm-up); it also shapes the payload's buffers."""
        _new, _out, _carry, pout = self._step(tree_clone(self.state), tree_clone(self.carry))
        if self.payload is not None:
            self._payload_buffers(pout)

    def run(self, state: SimState, setup: Setup, carry=None, rounds: int | None = None,
            outputs=None, start: int = 0):
        """``rounds`` rounds (default ``steps - start``) from ``state`` (and
        the payload's ``carry``) under ``setup``'s values: ``(final
        SimState, RecordedOutputs)``, as :func:`run_rounds` gives them;
        with a payload ``((state, carry), (outputs, payload outputs))``.

        The outputs always span the whole run, (batch, steps, ...): this
        call fills columns ``[start, start + rounds)``, of ``outputs``
        where given (what an earlier call of this run returned), else of
        fresh ones. So a segment of a run is a call from a mid-run
        state, through the same captured round: a segment captures
        nothing new, and ``setup.steps`` stays the run's whole budget
        (it trims the gather estimator's bins). Each call holds the
        runner's lock, so two threads never share its static buffers;
        on CUDA the next call's stream waits for this call's work."""
        if (carry is None) != (self.payload is None):
            raise ValueError("a payload runner runs with its carry, and only then")
        rounds = self.steps - start if rounds is None else int(rounds)
        if rounds < 1 or start < 0 or start + rounds > self.steps:
            raise ValueError(f"rounds [{start}, {start + rounds}) outside the run's "
                             f"{self.steps} steps")
        with trace.span("run", rounds=rounds, batch=self.batch), self.lock:
            return self._run(state, setup, carry, rounds, outputs, start)

    def _run(self, state, setup, carry, rounds, outputs, start):
        cuda = self.column.is_cuda
        if cuda and self.done is not None:
            torch.cuda.current_stream().wait_event(self.done)
        with trace.span("copy_in"):
            copy_into(_setup_tensors(self.setup), _setup_tensors(setup))
            if self.state is None:
                self.state, self.carry = tree_clone(state), tree_clone(carry)
            else:
                copy_into((self.state, self.carry), (state, carry))
        if cuda and self.graph is None:
            with trace.span("capture") as sp:
                self.graph = Captured(self._round, warmup=self._warmup, root="round")
            self.capture_s = sp.seconds
        dev = self.column.device
        if outputs is None:
            outs = empty_recording(self.spec, self.batch, self.steps, self.walks, dev)
            pouts = None
        elif self.payload is None:
            outs, pouts = tuple(outputs), None
        else:
            outs, pouts = tuple(outputs[0]), tuple(outputs[1])
        for c0 in range(start, start + rounds, self.chunk):
            n = min(self.chunk, start + rounds - c0)
            with trace.span("chunk", start=c0, rounds=n):
                self.column.zero_()
                with trace.span("replay"):
                    if cuda:
                        self.graph.replay(n)
                    else:
                        for _ in range(n):
                            self._round()
                if pouts is None and self.payload is not None:
                    pouts = tuple(torch.empty((b.shape[0], self.steps) + tuple(b.shape[2:]),
                                              dtype=b.dtype, device=dev)
                                  for b in self.precorded)
                with trace.span("copy_out"):
                    for o, b in zip(outs + (pouts or ()), self.recorded + (self.precorded or ())):
                        o[:, c0:c0 + n].copy_(b[:, :n])
        with trace.span("clone_out"):
            rec = RecordedOutputs(self.spec.fields, outs)
            if self.payload is None:
                result = tree_clone(self.state), rec
            else:
                pstruct = (_payload_outputs(self.pout, self.pspec, pouts) if outputs is None
                           else outputs[1])
                result = ((tree_clone(self.state), tree_clone(self.carry)), (rec, pstruct))
        if cuda:
            self.done = torch.cuda.Event()
            self.done.record()
        return result


# ---------------------------------------------------------------------------
# Trajectory metrics
# ---------------------------------------------------------------------------


def reaction_time(z, z0: int, failure_time: int) -> int:
    """Steps from ``failure_time`` until Z_t first returns to >= z0 (-1: never)."""
    post = np.asarray(z)[failure_time:]
    hits = np.nonzero(post >= z0)[0]
    return int(hits[0]) if hits.size else -1


def max_overshoot(z, z0: int) -> int:
    return int(np.max(np.asarray(z)) - z0)


def survived(z) -> bool:
    """Resilience objective: at least one walk alive at all times."""
    return bool((np.asarray(z) > 0).all())
