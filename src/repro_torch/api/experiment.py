"""The declarative Experiment spec (counterpart of the JAX package's
``api/experiment.py``):

    from repro_torch.api import Experiment

    exp = Experiment(graph=g, protocol=pcfg, failures=fcfg, steps=9000)
    final, outs = exp.run(key=0)      # one trajectory
    outs = exp.ensemble(seeds=50)     # the paper's seed ensembles
    res = Experiment(graph=g, scenarios=[...], steps=9000).sweep(seeds=50)
    exp = Experiment.from_config({"experiment": "zoo", "n": 64, "device": "cuda"})
    exp = Experiment(graph=g, protocol=pcfg, steps=900, payload=RwSgdPayload(...))
    (final, replicas), (outs, learn) = exp.run(key=0)   # RW-SGD riding the walks

It runs on ``cuda`` unless ``device`` says otherwise (``device="cpu"``
runs the kernels' plain versions); with no CUDA device and no explicit
device it raises. ``partitionable`` picks JAX's threefry bit layout
(True: jax >= 0.5's default; False: jax 0.4's), so the same seed draws
the same bits as the reference under either.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from repro_torch.api.placement import Placement
from repro_torch.api.plan import Plan
from repro_torch.api.results import SweepResult
from repro_torch.core.failures import FailureConfig
from repro_torch.core.outputs import split_outputs
from repro_torch.core.protocol import ProtocolConfig
from repro_torch.utils.device import resolve_device

__all__ = ["Experiment"]


@dataclasses.dataclass(frozen=True)
class Experiment:
    """graph; protocol (the base scenario, needed by ``run`` /
    ``ensemble``; optional when scenarios are given); failures (default:
    failure-free); steps; scenarios (``Scenario`` / ``(pcfg, fcfg)``
    rows, the default list of ``sweep``); outputs (``None`` /
    ``'scalars'`` / ``'full'`` / an OutputSpec / field names);
    placement (``'auto'`` / ``'local'`` / ``'sharded'``: how a sweep's
    groups spread their scenarios over the visible cards,
    ``api/placement.py``; on one device all three keep the rows where
    they are); device;
    partitionable; name; payload (a ``core.payload.Payload``, e.g.
    ``optim.RwSgdPayload``: the workload the walks carry, one carry per
    trajectory row). With a payload, ``outputs=None`` records every
    StepOutputs field, and a field-name sequence may mix StepOutputs
    names with the payload's output fields (``core.outputs.split_outputs``)."""

    graph: Any
    protocol: ProtocolConfig | None = None
    failures: FailureConfig | None = None
    steps: int | None = None
    scenarios: Sequence | None = None
    payload: Any = None
    outputs: Any = None
    placement: Placement | str | None = "auto"
    device: Any = None
    partitionable: bool = True
    name: str | None = None

    def __post_init__(self):
        if self.steps is None:
            raise TypeError("Experiment needs steps= (trajectory length)")
        if self.failures is not None and self.protocol is None:
            raise TypeError("failures= given without protocol=")
        if self.protocol is None and not self.scenarios:
            raise TypeError(
                "Experiment needs a base scenario (protocol=/failures=) "
                "and/or scenarios=[...]"
            )
        if self.protocol is not None and self.failures is None:
            object.__setattr__(self, "failures", FailureConfig())
        if self.scenarios is not None:
            object.__setattr__(self, "scenarios", tuple(self.scenarios))
        object.__setattr__(self, "placement", Placement.resolve(self.placement))
        object.__setattr__(self, "steps", int(self.steps))
        object.__setattr__(self, "device", resolve_device(self.device))
        spec, pspec = split_outputs(self.outputs, self.payload)
        object.__setattr__(self, "_spec", spec)
        object.__setattr__(self, "_pspec", pspec)
        self.plan()  # unported configurations raise here, not mid-run

    @classmethod
    def from_config(cls, config) -> "Experiment":
        """Build a registered experiment from a plain config mapping:
        ``config["experiment"]`` names a builder of
        :mod:`repro_torch.api.registry`, every other key is a keyword
        override (``device`` and ``partitionable`` included)."""
        from repro_torch.api import registry

        cfg = dict(config)
        name = cfg.pop("experiment", None)
        if not name:
            raise ValueError(
                "config needs an 'experiment' key naming a registered experiment; "
                f"registered: {list(registry.names())}"
            )
        return registry.build(name, **cfg)

    def plan(self) -> Plan:
        return Plan(self)

    def run(self, key: int | torch.Tensor = 0):
        """One trajectory; see :meth:`Plan.run`."""
        return self.plan().run(key)

    def ensemble(self, seeds: int, base_key: int | torch.Tensor = 0):
        """A seed ensemble; see :meth:`Plan.ensemble`."""
        return self.plan().ensemble(seeds, base_key)

    def sweep(self, scenarios: Sequence | None = None, *, seeds: int,
              base_key: int | torch.Tensor = 0, store=None,
              segment_steps: int | None = None) -> SweepResult:
        """A mixed scenario list, one batch per group; see :meth:`Plan.sweep`
        (``store=`` persists each group's results on disk, ``segment_steps=``
        runs them in resumable segments)."""
        return self.plan().sweep(scenarios, seeds=seeds, base_key=base_key, store=store,
                                 segment_steps=segment_steps)

    def __repr__(self):
        label = f" {self.name!r}" if self.name else ""
        parts = [f"n={getattr(self.graph, 'n', '?')}", f"steps={self.steps}"]
        if self.protocol is not None:
            parts.append(f"protocol={self.protocol.algorithm}")
        if self.scenarios:
            parts.append(f"scenarios={len(self.scenarios)}")
        if self.payload is not None:
            parts.append(f"payload={type(self.payload).__name__}")
        parts.append(f"device={self.device}")
        return f"Experiment{label}({', '.join(parts)})"
