"""Execution plans: the layer between an Experiment and the simulator.

Counterpart of the JAX package's ``api/plan.py``: ``run`` (one
trajectory), ``ensemble`` (a batch of seeds) and ``sweep`` (scenario
lists, grouped by static structure), every batch as rows of one set of
state tensors. PyTorch runs eagerly, so there is no compile cache; the
kernels are built once per process at first use. Ensemble keys are
``split(key(base), seeds)``, as in the reference (plan.py:288), so seed
i here is seed i there; a sweep gives every scenario those same keys, so
``sweep(...)[i]`` is ``ensemble`` on scenario i.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.api.results import SweepResult
from repro_torch.core import failures as flr
from repro_torch.core import protocol as prt
from repro_torch.core import simulator as sim
from repro_torch.sweep.scenario import as_pair, group_scenarios, stack_configs
from repro_torch.utils import prng

__all__ = ["Plan"]


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
    list, one batch per group, results in input order."""

    def __init__(self, experiment):
        self.experiment = experiment
        self.graph = experiment.graph
        self.steps = experiment.steps
        self.spec = experiment._spec
        self.device = experiment.placement.place(experiment.device)
        self.partitionable = experiment.partitionable
        self.pcfg = experiment.protocol
        self.fcfg = experiment.failures
        self.decision = None
        if self.pcfg is not None:
            prt.check_ported(self.pcfg)
            flr.check_ported(self.fcfg)
            self.decision = sim.round_impl_decision(self.pcfg, self.fcfg)
        for s in experiment.scenarios or ():
            pcfg, fcfg = as_pair(s)
            prt.check_ported(pcfg)
            flr.check_ported(fcfg)

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

    def run(self, key=0):
        """One trajectory: ``(final SimState, RecordedOutputs)``. The state
        keeps its batch axis of 1; the outputs are (steps, ...)."""
        self._require_base("run")
        keys = _as_key(key, self.device)[None]
        final, rec = sim.run_core(keys, self._setup(1), self.spec, self.decision)
        return final, rec.map(lambda v: v[0])

    def ensemble(self, seeds: int, base_key=0):
        """A seed ensemble: RecordedOutputs with (seeds, steps, ...) fields."""
        self._require_base("ensemble")
        keys = prng.split(_as_key(base_key, self.device), seeds,
                          partitionable=self.partitionable)
        _final, rec = sim.run_core(keys, self._setup(seeds), self.spec, self.decision)
        return rec

    def sweep_stacked(self, scenarios: Sequence | None = None, *, seeds: int, base_key=0,
                      store=None, segment_steps: int | None = None):
        """One group of scenarios (one static structure) as one batch of
        ``S * seeds`` rows, scenario-major, in one round loop: every
        scenario reuses the ensemble's keys ``split(key(base), seeds)``.
        Outputs are RecordedOutputs with (S, seeds, steps, ...) fields."""
        _check_unported(store, segment_steps)
        scenarios = self._scenarios(scenarios, "sweep_stacked")
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
        _final, rec = sim.run_core(keys.repeat(S, 1), setup, self.spec, decision)
        return rec.map(lambda v: v.reshape((S, seeds) + v.shape[1:]))

    def sweep(self, scenarios: Sequence | None = None, *, seeds: int, base_key=0,
              store=None, segment_steps: int | None = None) -> SweepResult:
        """Any scenario list: one :meth:`sweep_stacked` batch per group of
        :meth:`groups`, per-scenario results (leading ``(seeds,)`` axis)
        in input order."""
        _check_unported(store, segment_steps)
        scenarios = self._scenarios(scenarios, "sweep")
        names = tuple(getattr(s, "name", f"scenario{i}") for i, s in enumerate(scenarios))
        results = [None] * len(scenarios)
        for _sig, idxs in self.groups(scenarios):
            stacked = self.sweep_stacked([scenarios[i] for i in idxs], seeds=seeds,
                                         base_key=base_key)
            for j, i in enumerate(idxs):
                results[i] = stacked.map(lambda v, j=j: v[j])
        return SweepResult(names=names, outputs=results)

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
