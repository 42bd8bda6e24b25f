"""The declarative Experiment spec (counterpart of the JAX package's
``api/experiment.py``), for one base scenario:

    from repro_torch.api import Experiment

    exp = Experiment(graph=g, protocol=pcfg, failures=fcfg, steps=9000)
    final, outs = exp.run(key=0)      # one trajectory
    outs = exp.ensemble(seeds=50)     # the paper's seed ensembles

It runs on ``cuda`` unless ``device`` says otherwise (``device="cpu"``
runs the kernels' plain versions); with no CUDA device and no explicit
device it raises. ``partitionable`` picks JAX's threefry bit layout
(True: jax >= 0.5's default; False: jax 0.4's), so the same seed draws
the same bits as the reference under either.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.api.plan import Plan
from repro_torch.core.failures import FailureConfig
from repro_torch.core.outputs import resolve_spec
from repro_torch.core.protocol import ProtocolConfig
from repro_torch.utils.device import resolve_device

__all__ = ["Experiment"]


@dataclasses.dataclass(frozen=True)
class Experiment:
    """graph, protocol, failures (default: failure-free), steps, outputs
    (``None`` / ``'scalars'`` / ``'full'`` / an OutputSpec / field names),
    device, partitionable. ``scenarios`` and ``payload`` exist only to
    raise: sweeps and payloads are not ported yet."""

    graph: Any
    protocol: ProtocolConfig | None = None
    failures: FailureConfig | None = None
    steps: int | None = None
    outputs: Any = None
    device: Any = None
    partitionable: bool = True
    scenarios: Any = None
    payload: Any = None
    name: str | None = None

    def __post_init__(self):
        if self.scenarios is not None:
            raise NotImplementedError(
                "scenario sweeps are not ported yet (ROADMAP.md queue 1, item 5)"
            )
        if self.payload is not None:
            raise NotImplementedError(
                "walk payloads are not ported yet (ROADMAP.md queue 1, item 8)"
            )
        if self.steps is None:
            raise TypeError("Experiment needs steps= (trajectory length)")
        if self.protocol is None:
            raise TypeError("Experiment needs protocol=")
        if self.failures is None:
            object.__setattr__(self, "failures", FailureConfig())
        object.__setattr__(self, "steps", int(self.steps))
        object.__setattr__(self, "device", resolve_device(self.device))
        object.__setattr__(self, "_spec", resolve_spec(self.outputs))
        self.plan()  # unported configurations raise here, not mid-run

    def plan(self) -> Plan:
        return Plan(self)

    def run(self, key: int | torch.Tensor = 0):
        """One trajectory; see :meth:`Plan.run`."""
        return self.plan().run(key)

    def ensemble(self, seeds: int, base_key: int | torch.Tensor = 0):
        """A seed ensemble; see :meth:`Plan.ensemble`."""
        return self.plan().ensemble(seeds, base_key)

    def sweep(self, *args, **kwargs):
        raise NotImplementedError(
            "Experiment.sweep is not ported yet (ROADMAP.md queue 1, item 5)"
        )
