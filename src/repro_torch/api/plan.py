"""Execution plans: the layer between an Experiment and the simulator.

Counterpart of the JAX package's ``api/plan.py`` for one base scenario:
``run`` (one trajectory) and ``ensemble`` (a batch of seeds, one row per
trajectory in every state tensor). PyTorch runs eagerly, so there is no
compile cache; the kernels are built once per process at first use.
Ensemble keys are ``split(key(base), seeds)``, as in the reference
(plan.py:288), so seed i here is seed i there.
"""
from __future__ import annotations

import torch

from repro_torch.core import failures as flr
from repro_torch.core import protocol as prt
from repro_torch.core import simulator as sim
from repro_torch.utils import prng

__all__ = ["Plan"]


def _as_key(key, device) -> torch.Tensor:
    if isinstance(key, int):
        return prng.key(key, device=device)
    return torch.as_tensor(key, dtype=torch.int64, device=device)


class Plan:
    """The plan of one Experiment; build it with ``Experiment.plan()``."""

    def __init__(self, experiment):
        self.experiment = experiment
        self.graph = experiment.graph
        self.steps = experiment.steps
        self.spec = experiment._spec
        self.device = experiment.device
        self.pcfg = experiment.protocol
        self.fcfg = experiment.failures
        self.partitionable = experiment.partitionable
        prt.check_ported(self.pcfg)
        flr.check_ported(self.fcfg)
        self.decision = sim.round_impl_decision(self.pcfg, self.fcfg)

    def _setup(self, batch: int) -> sim.Setup:
        return sim.make_setup(
            self.graph, [self.pcfg] * batch, [self.fcfg] * batch, self.steps,
            self.device, self.partitionable,
        )

    def run(self, key=0):
        """One trajectory: ``(final SimState, RecordedOutputs)``. The state
        keeps its batch axis of 1; the outputs are (steps, ...)."""
        keys = _as_key(key, self.device)[None]
        final, rec = sim.run_core(keys, self._setup(1), self.spec, self.decision)
        return final, rec.map(lambda v: v[0])

    def ensemble(self, seeds: int, base_key=0):
        """A seed ensemble: RecordedOutputs with (seeds, steps, ...) fields."""
        keys = prng.split(_as_key(base_key, self.device), seeds,
                          partitionable=self.partitionable)
        _final, rec = sim.run_core(keys, self._setup(seeds), self.spec, self.decision)
        return rec

    def round_decisions(self) -> list:
        """``[(None, [0], RoundDecision)]``: how the base scenario's rounds
        execute, with the reason (the reference's shape for a plan
        without scenario rows)."""
        return [(None, [0], self.decision)]

    def __repr__(self):
        return f"Plan(n={self.graph.n}, steps={self.steps}, device={self.device})"
