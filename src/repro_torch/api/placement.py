"""Device placement of a sweep's rows (counterpart of the JAX package's
``api/placement.py``).

The reference places a group's stacked scenario leaves across the local
mesh's ``data`` axis; here a group's scenarios are split into contiguous
blocks, one per visible device, each block run by its own runner on its
device (``api/plan.py``):

  ``"auto"``     spread when more than one device is visible and their
                 number divides the group's scenario count; otherwise
                 stay on the Experiment's device (correctness never
                 depends on placement).
  ``"sharded"``  spread, and raise when the count does not divide (the
                 reference's message); on one device the rows stay where
                 they are.
  ``"local"``    never spread.

The visible devices of a CUDA Experiment are every card of the process
(``torch.cuda.device_count()``); a CPU Experiment has one. The
node-sharded step itself is ``repro_torch.core.distributed``.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["Placement"]

_POLICIES = ("auto", "sharded", "local")


def _visible_devices(device: torch.device) -> list:
    """The devices a sweep of an Experiment on ``device`` may spread
    over: every card for a CUDA device, else ``device`` alone."""
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


@dataclasses.dataclass(frozen=True)
class Placement:
    """Scenario-axis placement policy: ``"auto"``, ``"sharded"`` or
    ``"local"``."""

    policy: str = "auto"

    def __post_init__(self):
        if self.policy not in _POLICIES:
            raise ValueError(
                f"unknown placement policy {self.policy!r}; use one of "
                f"{list(_POLICIES)}"
            )

    @classmethod
    def resolve(cls, value) -> "Placement":
        """Normalize an ``Experiment(placement=...)`` argument."""
        if value is None:
            return cls.AUTO
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            return cls(value)
        raise TypeError(
            f"placement must be a Placement or one of {list(_POLICIES)}; "
            f"got {value!r}"
        )

    def devices(self, device, n_scenarios: int) -> list:
        """The devices a group of ``n_scenarios`` scenarios of an
        Experiment on ``device`` runs on, one contiguous block of
        scenarios each: ``[device]`` when the rows stay put."""
        device = torch.device(device)
        if self.policy == "local":
            return [device]
        visible = _visible_devices(device)
        if len(visible) == 1:
            return [device]
        if n_scenarios % len(visible):
            if self.policy == "sharded":
                raise ValueError(
                    f"placement='sharded' but {n_scenarios} scenarios do not "
                    f"divide the data axis ({len(visible)} devices); "
                    "pad the scenario list or use Placement.AUTO"
                )
            return [device]
        return visible


Placement.AUTO = Placement("auto")
Placement.SHARDED = Placement("sharded")
Placement.LOCAL = Placement("local")
