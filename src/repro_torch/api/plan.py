"""Execution plans: the layer between an Experiment and the simulator.

Counterpart of the JAX package's ``api/plan.py``: ``run`` (one
trajectory), ``ensemble`` (a batch of seeds) and ``sweep`` (scenario
lists, grouped by static structure), every batch as rows of one set of
state tensors. Ensemble keys are ``split(key(base), seeds)``, as in the
reference (plan.py:288), so seed i here is seed i there; a sweep gives
every scenario those same keys, so ``sweep(...)[i]`` is ``ensemble`` on
scenario i.

The executable cache is the counterpart of the reference's compile
cache: a process-wide table of :class:`~repro_torch.core.simulator.RoundRunner`
slots keyed on :func:`plan_signature`. A runner owns static input
tensors and, on CUDA, one captured round that it replays per round; the
numeric leaves of a run (keys, eps grids, rates, schedules, the graph's
tensors) are copied into its static inputs, so the same structure never
captures again across ``run`` / ``ensemble`` / ``sweep`` calls or
re-planned Experiments. ``cache_stats`` reports the slots and the CUDA
graphs captured. The kernels are built once per process at first use.

A payload (``Experiment(payload=...)``) rides every trajectory row: its
carry is initialised per row from the row's key, its hooks run inside
the captured round, and every entry point returns the reference's pair
``((final, carry), (outputs, payload outputs))`` (``ensemble`` and
``sweep_stacked`` the outputs pair, ``sweep`` a SweepResult with
``payloads``).

Durable execution (``run_segmented``, ``ensemble_segmented``,
``segment_steps=`` and ``store=``; see :class:`Plan` and
``api/store.py``): the reference compiles one program per segment length
(``seg_len`` is in its signature); here a segment is the same captured
round replayed from a mid-run state, so a segmented run and a straight
run of one structure share one slot and a segment captures nothing.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import threading
import warnings
from typing import Sequence, Tuple

import torch

from repro_torch.api.results import SweepResult
from repro_torch.api.store import ResultStore
from repro_torch.core import failures as flr
from repro_torch.core import simulator as sim
from repro_torch.core.outputs import RecordedOutputs
from repro_torch.sweep.scenario import as_pair, group_scenarios, stack_configs
from repro_torch.utils import prng, trace
from repro_torch.utils.faults import fault_point
from repro_torch.utils.tree import tree_map

__all__ = ["Plan", "cache_stats", "clear_cache", "executable", "payload_key", "plan_signature",
           "runners"]

# the process-wide executable cache: (mode, signature) -> RoundRunner
_EXECUTABLES: dict = {}
_CACHE_LOCK = threading.Lock()


def payload_key(payload):
    """The signature component of a payload: its type-qualified
    ``signature()`` tuple where it declares one (structurally equal
    payloads then share a slot), else the object itself (identity)."""
    if payload is None:
        return None
    key = getattr(payload, "_signature_key", lambda: None)()
    return payload if key is None else ("payload",) + key


def plan_signature(
    mode: str,
    n: int,
    max_deg: int,
    steps: int,
    pcfg,
    schedule_lens: Tuple[int, ...],
    spec,
    fcfg_static: tuple = (),
    *,
    batch: int,
    device,
    partitionable: bool,
    decision: sim.RoundDecision,
    payload=None,
    pspec=None,
    shard: tuple | None = None,
) -> tuple:
    """Hashable static signature of one runner.

    The reference's keys (api/plan.py:86): the mode, the graph's n and
    max degree, the steps, the protocol's static fields, whether
    ``fork_prob`` is None, the padded failure-schedule lengths (bursts,
    node crashes, extra Pac-Man ids, edge cuts), the payload's
    :func:`payload_key`, the output specs (step and payload) and the
    failure config's static fields; then what the reference's arrays
    carry in their avals and placement: the batch (rows), the device and
    the threefry layout; and the round decision that ``"auto"`` resolved
    to. A block of a sweep spread over several devices adds ``shard``,
    its (index, count), so each block has a runner of its own even where
    devices repeat. Numeric leaves (keys, eps grids, rates, schedules,
    the graph's tensors) deliberately do not appear: they are copied into
    the runner's static inputs and re-run without a new capture.
    """
    return (
        mode,
        n,
        max_deg,
        steps,
        pcfg.static_fields,
        pcfg.fork_prob is None,
        tuple(schedule_lens),
        payload_key(payload),
        spec,
        pspec,
        tuple(fcfg_static),
        batch,
        torch.device(device),
        partitionable,
        decision,
    ) + (() if shard is None else (("shard",) + tuple(shard),))


def executable(mode: str, signature: tuple, build):
    """The process-wide cache lookup: one runner per (mode, signature),
    made by ``build()`` on first use. A runner is shared by every caller
    of its structure; it holds its own lock for each run."""
    key = (mode, signature)
    with _CACHE_LOCK:
        runner = _EXECUTABLES.get(key)
        if runner is None:
            runner = _EXECUTABLES[key] = build()
    return runner


def cache_stats() -> dict:
    """Observability for the executable cache: ``entries`` is the number
    of (mode, signature) slots ever made; ``graphs_captured`` the CUDA
    graphs captured by them (the counterpart of the reference's
    ``xla_compiles``; one per CUDA slot, at its first run, and none on
    the CPU, where runners run eagerly); ``by_mode`` splits the captures
    per execution mode (run / ensemble / sweep)."""
    by_mode: dict = {}
    for (mode, _sig), runner in _EXECUTABLES.items():
        by_mode[mode] = by_mode.get(mode, 0) + runner.captures
    return {
        "entries": len(_EXECUTABLES),
        "graphs_captured": sum(by_mode.values()),
        "by_mode": by_mode,
    }


def runners() -> list:
    """Every cached runner, in the order the cache made them (each holds
    its captured round, ``runner.graph``, once it has run on CUDA)."""
    with _CACHE_LOCK:
        return list(_EXECUTABLES.values())


def clear_cache() -> None:
    """Drop every cached runner and its graph (tests only: a cleared
    cache means every structure captures again on next use)."""
    _EXECUTABLES.clear()


def _schedule_lens(fcfg) -> tuple:
    """The shape-bearing failure-schedule lengths, in signature order."""
    return (fcfg.n_bursts, fcfg.n_node_crashes, fcfg.n_pacman, fcfg.n_edge_cuts)


def _cat_rows(parts: list, device):
    """The trees of ``parts`` (the blocks of a spread sweep: states,
    carries, outputs) joined along their leading row axis on ``device``."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(device) for p in parts])
    if isinstance(first, RecordedOutputs):
        return RecordedOutputs(first._fields, tuple(
            _cat_rows([p[i] for p in parts], device) for i in range(len(first))))
    if isinstance(first, dict):
        return {k: _cat_rows([p[k] for p in parts], device) for k in first}
    if isinstance(first, tuple):
        vals = [_cat_rows([p[i] for p in parts], device) for i in range(len(first))]
        return type(first)(*vals) if hasattr(first, "_fields") else tuple(vals)
    return first


def _as_key(key, device) -> torch.Tensor:
    if isinstance(key, int):
        return prng.key(key, device=device)
    return torch.as_tensor(key, dtype=torch.int64, device=device)


class Plan:
    """The plan of one Experiment; build it with ``Experiment.plan()``.

    ``run`` / ``ensemble`` run the base (protocol, failures) scenario;
    ``sweep_stacked`` runs one group of scenarios (one static structure)
    as ``S * seeds`` rows, scenario-major; ``sweep`` runs any scenario
    list, one batch per group, results in input order. A payload is
    validated against every scenario's protocol config here.

    Durable execution: ``run_segmented`` / ``ensemble_segmented`` and
    ``segment_steps=`` on ``sweep_stacked`` / ``sweep`` run the same
    rounds in resumable segments, bitwise the straight call. A segment
    replays the straight run's captured round from a mid-run state
    (``RoundRunner.run(rounds=, start=)``), so it uses the straight
    run's cache slot and captures nothing new: the segment length is not
    part of :func:`plan_signature`. With ``store=`` (None | ``'env'`` |
    a path | a :class:`~repro_torch.api.store.ResultStore`) each
    boundary writes a snapshot (the state, the payload's carry and the
    outputs so far) under the run's content key, and a killed run
    resumes from its deepest loadable snapshot whatever chunking it
    runs with; ``sweep_stacked(store=)`` also answers a finished call
    from disk without running anything."""

    def __init__(self, experiment):
        self.experiment = experiment
        self.graph = experiment.graph
        self.steps = experiment.steps
        self.spec = experiment._spec
        self.pspec = experiment._pspec
        self.payload = experiment.payload
        self.device = experiment.device
        self.partitionable = experiment.partitionable
        self.pcfg = experiment.protocol
        self.fcfg = experiment.failures
        self.decision = None
        if self.pcfg is not None:
            self.decision = sim.round_impl_decision(self.pcfg, self.fcfg)
        if self.payload is not None:
            declared = [as_pair(s)[0] for s in experiment.scenarios or ()]
            for pcfg in declared + ([self.pcfg] if self.pcfg is not None else []):
                self.payload.validate(pcfg)

    def _setup(self, batch: int) -> sim.Setup:
        return sim.make_setup(
            self.graph, [self.pcfg] * batch, [self.fcfg] * batch, self.steps,
            self.device, self.partitionable,
        )

    def _require_base(self, what: str):
        if self.pcfg is None:
            raise ValueError(
                f"Plan.{what} needs a base scenario: construct the "
                "Experiment with protocol=/failures= (or use .sweep on its "
                "scenarios)"
            )

    def _signature(self, mode: str, pcfg, fcfg, decision, batch: int, device=None,
                   shard: tuple | None = None) -> tuple:
        """The runner signature of ``batch`` rows of this structure on
        ``device`` (default the plan's; the padded ``fcfg`` carries the
        group's schedule widths)."""
        return plan_signature(
            mode, self.graph.n, int(self.graph.neighbors.shape[1]), self.steps, pcfg,
            _schedule_lens(fcfg), self.spec, fcfg.static_fields, batch=batch,
            device=self.device if device is None else device,
            partitionable=self.partitionable, decision=decision,
            payload=self.payload, pspec=self.pspec, shard=shard,
        )

    def _execute(self, mode: str, keys, setup: sim.Setup, fcfg, decision, *,
                 segment_steps: int | None = None, store=None, skey: str | None = None,
                 shard: tuple | None = None):
        """``setup.steps`` rounds from the initial state of ``keys``
        through the cached runner of this structure (a spread block's on
        its keys' device), straight or in segments
        (:meth:`_drive_segments`)."""
        if self.payload is not None:
            self.payload.validate(setup.pcfg)
        sig = self._signature(mode, setup.pcfg, fcfg, decision, int(keys.shape[0]),
                              None if shard is None else keys.device, shard)
        runner = executable(mode, sig, lambda: sim.RoundRunner(
            setup, self.spec, decision, self.payload, self.pspec))
        if segment_steps is None:
            with trace.span("init_carry"):
                state, carry = sim.init_carry(keys, setup, self.payload)
            return runner.run(state, setup, carry)
        return self._drive_segments(mode, runner, keys, setup, segment_steps, store, skey)

    def _outputs(self, result, fn):
        """``fn`` applied to every recorded tensor of a run's outputs
        (with a payload, its outputs too)."""
        if self.payload is None:
            return result.map(fn)
        rec, pouts = result
        return rec.map(fn), (pouts.map(fn) if isinstance(pouts, RecordedOutputs)
                             else tree_map(fn, pouts))

    def _output_tensors(self, outputs) -> list:
        return list(outputs) if self.payload is None else list(outputs[0]) + list(outputs[1])

    # -- durable segmented execution -----------------------------------------
    #
    # Every random stream folds the CARRIED step counter ``t`` (never a
    # loop index), so a run cut into segments is bitwise the straight
    # one. With a store, each boundary writes a self-contained snapshot
    # (carry + outputs so far) under the run's content key, so a killed
    # process resumes from the deepest loadable snapshot regardless of
    # the chunking it now uses.

    def _segment_store(self, store, sig, configs, seeds, base):
        store = ResultStore.resolve(store)
        if store is None:
            return None, None
        return store, store.sweep_key(sig, self.graph, configs, seeds, base)

    def _drive_segments(self, mode, runner, keys, setup, segment_steps, store, skey):
        """One segmented run to completion through ``runner``, in the
        format of ``runner.run``. Each segment's outputs land in the run's
        own (rows, steps, ...) outputs. Snapshot writes are best-effort —
        a failing store degrades to lost progress and a warning, never a
        failed run — and fault site ``segment.boundary`` fires after
        every boundary."""
        segment_steps = int(segment_steps)
        if segment_steps < 1:
            raise ValueError(f"segment_steps must be >= 1, got {segment_steps}")
        steps = self.steps
        done, recorded = 0, None
        found = None if store is None else store.latest_segment(
            skey, max_steps=steps, device=keys.device)
        if found is not None:
            done, snap = found
            (state, carry), recorded = snap["carry"], snap["recorded"]
        else:
            state, carry = sim.init_carry(keys, setup, self.payload)
        outputs = None
        while done < steps:
            seg = min(segment_steps, steps - done)
            result = runner.run(state, setup, carry, rounds=seg, outputs=outputs, start=done)
            if self.payload is None:
                state, outputs = result
            else:
                (state, carry), outputs = result
            if recorded is not None:  # resumed: the snapshot's columns
                for o, r in zip(self._output_tensors(outputs), self._output_tensors(recorded)):
                    o[:, :r.shape[1]].copy_(r)
                recorded = None
            done += seg
            if store is not None and done < steps:
                try:
                    store.put_segment(
                        skey, done,
                        {"carry": (state, carry),
                         "recorded": self._outputs(outputs, lambda v: v[:, :done])},
                        extra_meta={"mode": mode, "total_steps": steps},
                    )
                except Exception as exc:  # write-behind is best-effort
                    warnings.warn(f"segment write-behind failed at {done}/{steps} "
                                  f"steps: {exc!r}")
            fault_point("segment.boundary")
        return (state, outputs) if self.payload is None else ((state, carry), outputs)

    # -- entry points ----------------------------------------------------------

    def run(self, key=0):
        """One trajectory: ``(final SimState, RecordedOutputs)``, with a
        payload ``((final SimState, carry), (RecordedOutputs, payload
        outputs))``. The state and carry keep their batch axis of 1; the
        outputs are (steps, ...)."""
        self._require_base("run")
        keys = _as_key(key, self.device)[None]
        final, rec = self._execute("run", keys, self._setup(1), self.fcfg, self.decision)
        return final, self._outputs(rec, lambda v: v[0])

    def run_segmented(self, key=0, *, segment_steps: int, store=None):
        """:meth:`run` in resumable segments: the same return value,
        bitwise. ``store=`` enables boundary snapshots and resume from
        them; on completion the snapshots are cleared."""
        self._require_base("run_segmented")
        keys = _as_key(key, self.device)[None]
        sig = self._signature("run", self.pcfg, self.fcfg, self.decision, 1)
        store, skey = self._segment_store(store, sig, (self.pcfg, self.fcfg), 1, keys[0])
        final, rec = self._execute("run", keys, self._setup(1), self.fcfg, self.decision,
                                   segment_steps=segment_steps, store=store, skey=skey)
        if store is not None:
            store.clear_segments(skey)
        return final, self._outputs(rec, lambda v: v[0])

    def ensemble(self, seeds: int, base_key=0):
        """A seed ensemble: RecordedOutputs with (seeds, steps, ...)
        fields (with a payload, the pair ``(outputs, payload outputs)``)."""
        self._require_base("ensemble")
        keys = prng.split(_as_key(base_key, self.device), seeds,
                          partitionable=self.partitionable)
        _final, rec = self._execute("ensemble", keys, self._setup(seeds), self.fcfg,
                                    self.decision)
        return rec

    def ensemble_segmented(self, seeds: int, base_key=0, *, segment_steps: int, store=None):
        """:meth:`ensemble` in resumable segments: the same outputs,
        bitwise."""
        self._require_base("ensemble_segmented")
        base = _as_key(base_key, self.device)
        keys = prng.split(base, seeds, partitionable=self.partitionable)
        sig = self._signature("ensemble", self.pcfg, self.fcfg, self.decision, seeds)
        store, skey = self._segment_store(store, sig, (self.pcfg, self.fcfg), seeds, base)
        _final, rec = self._execute("ensemble", keys, self._setup(seeds), self.fcfg,
                                    self.decision, segment_steps=segment_steps, store=store,
                                    skey=skey)
        if store is not None:
            store.clear_segments(skey)
        return rec

    def sweep_stacked(self, scenarios: Sequence | None = None, *, seeds: int, base_key=0,
                      store=None, segment_steps: int | None = None):
        """One group of scenarios (one static structure) as one batch of
        ``S * seeds`` rows, scenario-major, in one round loop: every
        scenario reuses the ensemble's keys ``split(key(base), seeds)``.
        Outputs are RecordedOutputs with (S, seeds, steps, ...) fields
        (with a payload, the pair ``(outputs, payload outputs)``).

        ``store=`` enables disk-backed persistence: a store-warm call
        returns the stored tensors on the plan's device without making a
        runner or running a round; the content key covers the plan
        signature (device type included), the graph, every scenario's
        config values, ``seeds`` and the base key's words.
        ``segment_steps=`` runs the rounds in resumable segments (bitwise
        the straight call); with a store each boundary writes a
        snapshot, so a killed process resumes a half-finished sweep from
        disk. The finished result lands under the SAME key as the
        straight call's, and ``segment_steps`` never enters the key."""
        scenarios = self._scenarios(scenarios, "sweep_stacked")
        store = ResultStore.resolve(store)
        S = len(scenarios)
        skey = None
        if store is not None:
            group = self._group(scenarios, seeds, base_key)
            skey = store.sweep_key(group["sig"], self.graph, group["configs"], seeds,
                                   _as_key(base_key, "cpu"))
            cached = store.get(skey, device=self.device)
            if cached is not None:
                return cached
        _final, rec = self.sweep_group(scenarios, seeds=seeds, base_key=base_key,
                                       segment_steps=segment_steps, store=store, skey=skey)
        result = self._outputs(rec, lambda v: v.reshape((S, seeds) + v.shape[1:]))
        if store is not None:
            store.put(skey, result, extra_meta={"scenarios": S, "seeds": int(seeds)})
            if segment_steps is not None:
                store.clear_segments(skey)
        return result

    def _group(self, scenarios: Sequence, seeds: int, base_key) -> dict:
        """The stacked configs, keys and signature of one group."""
        pcfgs, fcfgs = stack_configs(scenarios)
        if self.payload is not None:
            self.payload.validate(pcfgs[0])
        decision = sim.round_impl_decision(pcfgs[0], fcfgs[0])
        S = len(scenarios)
        return dict(pcfgs=pcfgs, fcfgs=fcfgs, decision=decision,
                    configs=tuple(pcfgs) + tuple(fcfgs),
                    sig=self._signature("sweep", pcfgs[0], fcfgs[0], decision, S * seeds))

    def sweep_group(self, scenarios: Sequence, *, seeds: int, base_key=0,
                    segment_steps: int | None = None, store=None, skey: str | None = None):
        """:meth:`sweep_stacked`'s batch with its final state: ``(final
        SimState, RecordedOutputs)``, both with ``S * seeds`` rows,
        scenario-major (with a payload ``((state, carry), (outputs,
        payload outputs))``); with ``segment_steps``, in segments, their
        snapshots in ``store`` under ``skey``.

        Where the placement spreads the group (``api/placement.py``), the
        scenarios go in contiguous blocks, one per device, each through
        its own runner (its own cache slot); on cards each block runs in
        a host thread of its own, so the cards run at once. Every block
        gives its scenarios the ensemble's keys, and the blocks' results
        are gathered on the plan's device in row order, bitwise the
        one-device batch."""
        with trace.span("sweep_group", scenarios=len(scenarios), seeds=seeds):
            return self._sweep_group(scenarios, seeds, base_key, segment_steps, store, skey)

    def _sweep_group(self, scenarios, seeds, base_key, segment_steps, store, skey):
        group = self._group(scenarios, seeds, base_key)
        S = len(scenarios)
        devices = self.experiment.placement.devices(self.device, S)
        seg = dict(segment_steps=segment_steps, store=store)
        if len(devices) == 1:
            return self._sweep_block(group, 0, S, seeds, base_key, self.device, skey=skey,
                                     **seg)
        k, per = len(devices), S // len(devices)

        def block(i):
            dev = devices[i]
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                return self._sweep_block(
                    group, i * per, (i + 1) * per, seeds, base_key, dev, shard=(i, k),
                    skey=None if skey is None else f"{skey}-{i}of{k}", **seg)

        if all(d.type == "cuda" for d in devices):  # one host thread per card
            with concurrent.futures.ThreadPoolExecutor(k) as pool:
                parts = list(pool.map(block, range(k)))
        else:  # CPU blocks in turn: their ops already spread over the cores
            parts = [block(i) for i in range(k)]
        if segment_steps is not None and store is not None and skey is not None:
            for i in range(k):  # the caller stores the whole group's result under skey
                store.clear_segments(f"{skey}-{i}of{k}")
        # each block's work is on its device's current stream, which the
        # copies below wait for
        return _cat_rows(parts, self.device)

    def _sweep_block(self, group: dict, lo: int, hi: int, seeds: int, base_key, device, *,
                     shard: tuple | None = None, segment_steps=None, store=None, skey=None):
        """Scenarios ``[lo, hi)`` of ``group`` as ``(hi - lo) * seeds`` rows
        on ``device`` (:meth:`sweep_group`'s result for them)."""
        with trace.span("keys"):
            keys = prng.split(_as_key(base_key, device), seeds, partitionable=self.partitionable)
        with trace.span("make_setup"):
            setup = sim.make_setup(
                self.graph, [p for p in group["pcfgs"][lo:hi] for _ in range(seeds)],
                [f for f in group["fcfgs"][lo:hi] for _ in range(seeds)], self.steps, device,
                self.partitionable,
            )
        return self._execute("sweep", keys.repeat(hi - lo, 1), setup, group["fcfgs"][0],
                             group["decision"], segment_steps=segment_steps, store=store,
                             skey=skey, shard=shard)

    def sweep(self, scenarios: Sequence | None = None, *, seeds: int, base_key=0,
              store=None, segment_steps: int | None = None) -> SweepResult:
        """Any scenario list: one :meth:`sweep_stacked` batch per group of
        :meth:`groups`, per-scenario results (leading ``(seeds,)`` axis)
        in input order. ``store=`` and ``segment_steps=`` apply to each
        group's batch (see :meth:`sweep_stacked`)."""
        scenarios = self._scenarios(scenarios, "sweep")
        store = ResultStore.resolve(store)
        names = tuple(getattr(s, "name", f"scenario{i}") for i, s in enumerate(scenarios))
        results = [None] * len(scenarios)
        payloads = None if self.payload is None else [None] * len(scenarios)
        for _sig, idxs in self.groups(scenarios):
            stacked = self.sweep_stacked([scenarios[i] for i in idxs], seeds=seeds,
                                         base_key=base_key, store=store,
                                         segment_steps=segment_steps)
            for j, i in enumerate(idxs):
                row = self._outputs(stacked, lambda v, j=j: v[j])
                if self.payload is None:
                    results[i] = row
                else:
                    results[i], payloads[i] = row
        return SweepResult(names=names, outputs=results, payloads=payloads)

    def round_decisions(self, scenarios: Sequence | None = None) -> list:
        """``[(group key, indices, RoundDecision)]``: how each group's
        rounds execute, with the reason, decided on the group's padded
        schedules; a base-only plan gives ``[(None, [0], decision)]``."""
        if scenarios is None and not self.experiment.scenarios:
            self._require_base("round_decisions")
            return [(None, [0], self.decision)]
        scenarios = self._scenarios(scenarios, "round_decisions")
        out = []
        for sig, idxs in self.groups(scenarios):
            pairs = [as_pair(scenarios[i]) for i in idxs]
            fcfgs = flr.pad_bursts([f for _, f in pairs])
            out.append((sig, idxs, sim.round_impl_decision(pairs[0][0], fcfgs[0])))
        return out

    def groups(self, scenarios: Sequence | None = None) -> list:
        """``[(group key, [indices])]``: which scenarios share one batch."""
        return group_scenarios(self._scenarios(scenarios, "groups"))

    def _scenarios(self, scenarios, what: str) -> list:
        scenarios = self.experiment.scenarios if scenarios is None else scenarios
        if not scenarios:
            raise ValueError(
                f"Plan.{what} needs scenarios: pass them to the call or "
                "construct the Experiment with scenarios=[...]"
            )
        return list(scenarios)

    def __repr__(self):
        base = "1 base scenario" if self.pcfg is not None else "no base scenario"
        ns = len(self.experiment.scenarios or ())
        return (f"Plan(n={self.graph.n}, steps={self.steps}, {base}, "
                f"{ns} declared scenario(s), device={self.device})")
