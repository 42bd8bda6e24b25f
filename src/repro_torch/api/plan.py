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
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.api.results import SweepResult
from repro_torch.core import failures as flr
from repro_torch.core import simulator as sim
from repro_torch.core.outputs import RecordedOutputs
from repro_torch.sweep.scenario import as_pair, group_scenarios, stack_configs
from repro_torch.utils import prng
from repro_torch.utils.tree import tree_map

__all__ = ["Plan", "cache_stats", "clear_cache", "executable", "payload_key", "plan_signature"]

# the process-wide executable cache: (mode, signature) -> RoundRunner
_EXECUTABLES: dict = {}


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
    to. Numeric leaves (keys, eps grids, rates, schedules, the graph's
    tensors) deliberately do not appear: they are copied into the
    runner's static inputs and re-run without a new capture.
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
    )


def executable(mode: str, signature: tuple, build):
    """The process-wide cache lookup: one runner per (mode, signature),
    made by ``build()`` on first use."""
    key = (mode, signature)
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


def clear_cache() -> None:
    """Drop every cached runner and its graph (tests only: a cleared
    cache means every structure captures again on next use)."""
    _EXECUTABLES.clear()


def _schedule_lens(fcfg) -> tuple:
    """The shape-bearing failure-schedule lengths, in signature order."""
    return (fcfg.n_bursts, fcfg.n_node_crashes, fcfg.n_pacman, fcfg.n_edge_cuts)


def _as_key(key, device) -> torch.Tensor:
    if isinstance(key, int):
        return prng.key(key, device=device)
    return torch.as_tensor(key, dtype=torch.int64, device=device)


def _check_unported(store, segment_steps) -> None:
    if store is not None or segment_steps is not None:
        raise NotImplementedError(
            "store= and segment_steps= (durable, resumable sweeps) are not "
            "ported yet (ROADMAP.md queue 1, item 9: durable execution)"
        )


class Plan:
    """The plan of one Experiment; build it with ``Experiment.plan()``.

    ``run`` / ``ensemble`` run the base (protocol, failures) scenario;
    ``sweep_stacked`` runs one group of scenarios (one static structure)
    as ``S * seeds`` rows, scenario-major; ``sweep`` runs any scenario
    list, one batch per group, results in input order. A payload is
    validated against every scenario's protocol config here."""

    def __init__(self, experiment):
        self.experiment = experiment
        self.graph = experiment.graph
        self.steps = experiment.steps
        self.spec = experiment._spec
        self.pspec = experiment._pspec
        self.payload = experiment.payload
        self.device = experiment.placement.place(experiment.device)
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

    def _execute(self, mode: str, keys, setup: sim.Setup, fcfg, decision):
        """``setup.steps`` rounds from the initial state of ``keys``
        through the cached runner of this structure."""
        if self.payload is not None:
            self.payload.validate(setup.pcfg)
        sig = plan_signature(
            mode, setup.n, int(setup.neighbors.shape[1]), setup.steps, setup.pcfg,
            _schedule_lens(fcfg), self.spec, fcfg.static_fields, batch=int(keys.shape[0]),
            device=self.device, partitionable=self.partitionable, decision=decision,
            payload=self.payload, pspec=self.pspec,
        )
        runner = executable(mode, sig, lambda: sim.RoundRunner(
            setup, self.spec, decision, self.payload, self.pspec))
        carry = None if self.payload is None else sim.init_payload(keys, setup, self.payload)
        return runner.run(sim.init_state(keys, setup), setup, carry)

    def _outputs(self, result, fn):
        """``fn`` applied to every recorded tensor of a run's outputs
        (with a payload, its outputs too)."""
        if self.payload is None:
            return result.map(fn)
        rec, pouts = result
        return rec.map(fn), (pouts.map(fn) if isinstance(pouts, RecordedOutputs)
                             else tree_map(fn, pouts))

    def run(self, key=0):
        """One trajectory: ``(final SimState, RecordedOutputs)``, with a
        payload ``((final SimState, carry), (RecordedOutputs, payload
        outputs))``. The state and carry keep their batch axis of 1; the
        outputs are (steps, ...)."""
        self._require_base("run")
        keys = _as_key(key, self.device)[None]
        final, rec = self._execute("run", keys, self._setup(1), self.fcfg, self.decision)
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

    def sweep_stacked(self, scenarios: Sequence | None = None, *, seeds: int, base_key=0,
                      store=None, segment_steps: int | None = None):
        """One group of scenarios (one static structure) as one batch of
        ``S * seeds`` rows, scenario-major, in one round loop: every
        scenario reuses the ensemble's keys ``split(key(base), seeds)``.
        Outputs are RecordedOutputs with (S, seeds, steps, ...) fields
        (with a payload, the pair ``(outputs, payload outputs)``)."""
        _check_unported(store, segment_steps)
        scenarios = self._scenarios(scenarios, "sweep_stacked")
        _final, rec = self.sweep_group(scenarios, seeds=seeds, base_key=base_key)
        S = len(scenarios)
        return self._outputs(rec, lambda v: v.reshape((S, seeds) + v.shape[1:]))

    def sweep_group(self, scenarios: Sequence, *, seeds: int, base_key=0):
        """:meth:`sweep_stacked`'s batch with its final state: ``(final
        SimState, RecordedOutputs)``, both with ``S * seeds`` rows,
        scenario-major (with a payload ``((state, carry), (outputs,
        payload outputs))``)."""
        pcfgs, fcfgs = stack_configs(scenarios)
        S = len(scenarios)
        keys = prng.split(_as_key(base_key, self.device), seeds,
                          partitionable=self.partitionable)
        setup = sim.make_setup(
            self.graph, [p for p in pcfgs for _ in range(seeds)],
            [f for f in fcfgs for _ in range(seeds)], self.steps, self.device,
            self.partitionable,
        )
        decision = sim.round_impl_decision(pcfgs[0], fcfgs[0])
        return self._execute("sweep", keys.repeat(S, 1), setup, fcfgs[0], decision)

    def sweep(self, scenarios: Sequence | None = None, *, seeds: int, base_key=0,
              store=None, segment_steps: int | None = None) -> SweepResult:
        """Any scenario list: one :meth:`sweep_stacked` batch per group of
        :meth:`groups`, per-scenario results (leading ``(seeds,)`` axis)
        in input order."""
        _check_unported(store, segment_steps)
        scenarios = self._scenarios(scenarios, "sweep")
        names = tuple(getattr(s, "name", f"scenario{i}") for i, s in enumerate(scenarios))
        results = [None] * len(scenarios)
        payloads = None if self.payload is None else [None] * len(scenarios)
        for _sig, idxs in self.groups(scenarios):
            stacked = self.sweep_stacked([scenarios[i] for i in idxs], seeds=seeds,
                                         base_key=base_key)
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
