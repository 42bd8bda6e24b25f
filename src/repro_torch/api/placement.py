"""Device placement of a sweep's rows (counterpart of the JAX package's
``api/placement.py``, for one device).

``"auto"`` and ``"local"`` keep every row on the Experiment's device.
``"sharded"`` (rows spread over several devices) raises: the
node-sharded, multi-device step is not ported yet (ROADMAP.md queue 1,
item 11).
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
        if self.policy == "sharded":
            raise NotImplementedError(
                "placement='sharded' (rows over several devices) is not "
                "ported yet (ROADMAP.md queue 1, item 11: node-sharded step)"
            )
        return device


Placement.AUTO = Placement("auto")
Placement.SHARDED = Placement("sharded")
Placement.LOCAL = Placement("local")
