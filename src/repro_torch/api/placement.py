"""Device placement of a sweep's rows (counterpart of the JAX package's
``api/placement.py``, for one device).

``"auto"`` and ``"local"`` keep every row on the Experiment's device.
``"sharded"`` spreads the rows over the visible devices, as the
reference's policy does: on one device (one card, or the CPU) they stay
where they are, exactly as ``"local"``. Rows over several cards are not
ported yet (ROADMAP.md queue 1, item 17) and raise. The node-sharded
step itself is ``repro_torch.core.distributed``.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["Placement"]

_POLICIES = ("auto", "sharded", "local")


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

    def place(self, device: torch.device) -> torch.device:
        """The device a sweep's rows live on."""
        if (self.policy == "sharded" and torch.device(device).type == "cuda"
                and torch.cuda.device_count() > 1):
            raise NotImplementedError(
                "placement='sharded' over several cards is not ported yet "
                "(ROADMAP.md queue 1, item 17: sweep rows over several cards)"
            )
        return device


Placement.AUTO = Placement("auto")
Placement.SHARDED = Placement("sharded")
Placement.LOCAL = Placement("local")
