"""Trajectory output selection: which ``StepOutputs`` fields a run stacks.

Counterpart of the JAX package's ``core/outputs.py`` without the payload
specs. Every round produces a full :class:`StepOutputs`; an
:class:`OutputSpec` names the fields a run keeps over time (scalars-only
by default: the per-walk fields are ``(W,)`` wide). Recorded
trajectories come back as a :class:`RecordedOutputs`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Sequence, Tuple

import torch


class StepOutputs(NamedTuple):
    """Everything one synchronous round reports, one row per trajectory."""

    z: torch.Tensor  # (batch,) live walk count after the step
    forks: torch.Tensor  # (batch,) forks executed this step
    terms: torch.Tensor  # (batch,) deliberate terminations this step
    failures: torch.Tensor  # (batch,) walks lost to the threat model
    theta_mean: torch.Tensor  # (batch,) mean theta-hat over chosen walks
    fork_parent: torch.Tensor  # (batch, W) parent slot of a fork into s, else -1
    terminated: torch.Tensor  # (batch, W) walks deliberately terminated


ALL_FIELDS: Tuple[str, ...] = StepOutputs._fields
SCALAR_FIELDS: Tuple[str, ...] = ("z", "forks", "terms", "failures", "theta_mean")
# each field's dtype; the per-walk fields carry a trailing (W,) axis
FIELD_DTYPES = {
    "z": torch.int32, "forks": torch.int32, "terms": torch.int32, "failures": torch.int32,
    "theta_mean": torch.float32, "fork_parent": torch.int32, "terminated": torch.bool,
}
PER_WALK_FIELDS: Tuple[str, ...] = ("fork_parent", "terminated")


@dataclasses.dataclass(frozen=True)
class OutputSpec:
    """The set of ``StepOutputs`` fields a run records, in canonical order."""

    fields: Tuple[str, ...] = SCALAR_FIELDS

    def __post_init__(self):
        wanted = tuple(self.fields)
        unknown = [f for f in wanted if f not in ALL_FIELDS]
        if unknown:
            raise ValueError(
                f"unknown StepOutputs field(s) {unknown!r}; valid fields are "
                f"{list(ALL_FIELDS)}"
            )
        if not wanted:
            raise ValueError("OutputSpec needs at least one field")
        object.__setattr__(
            self, "fields", tuple(f for f in ALL_FIELDS if f in set(wanted))
        )


SCALARS = OutputSpec(SCALAR_FIELDS)
FULL = OutputSpec(ALL_FIELDS)


def resolve_spec(outputs: Any) -> OutputSpec:
    """``None`` / ``'scalars'`` / ``'full'`` / an OutputSpec / field names."""
    if outputs is None:
        return SCALARS
    if isinstance(outputs, OutputSpec):
        return outputs
    if isinstance(outputs, str):
        named = {"scalars": SCALARS, "full": FULL}
        if outputs in named:
            return named[outputs]
        raise ValueError(
            f"unknown outputs shorthand {outputs!r}; use 'scalars', 'full', "
            "an OutputSpec, or a tuple of StepOutputs field names"
        )
    if isinstance(outputs, Sequence):
        return OutputSpec(tuple(outputs))
    raise TypeError(
        f"outputs must be None, 'scalars', 'full', an OutputSpec or a "
        f"sequence of field names; got {outputs!r}"
    )


class RecordedOutputs:
    """Namedtuple-like view over the fields an OutputSpec recorded.
    Asking for a field the spec dropped raises with the fix."""

    __slots__ = ("_fields", "_values")

    def __init__(self, fields: Tuple[str, ...], values: Tuple[Any, ...]):
        if len(fields) != len(values):
            raise ValueError("fields/values length mismatch")
        object.__setattr__(self, "_fields", tuple(fields))
        object.__setattr__(self, "_values", tuple(values))

    def __getattr__(self, name):
        fields = object.__getattribute__(self, "_fields")
        if name in fields:
            return object.__getattribute__(self, "_values")[fields.index(name)]
        if name in ALL_FIELDS:
            raise AttributeError(
                f"StepOutputs field {name!r} was not recorded: this run's "
                f"OutputSpec is {fields!r}. Re-run with outputs='full' (or an "
                f"OutputSpec including {name!r}) to record it."
            )
        raise AttributeError(name)

    def __setattr__(self, name, value):
        raise AttributeError("RecordedOutputs is immutable")

    def __iter__(self):
        return iter(self._values)

    def __len__(self):
        return len(self._values)

    def __getitem__(self, i):
        if isinstance(i, str):
            return getattr(self, i)
        return self._values[i]

    def _asdict(self) -> dict:
        return dict(zip(self._fields, self._values))

    def map(self, fn) -> "RecordedOutputs":
        """The same fields with ``fn`` applied to every value."""
        return RecordedOutputs(self._fields, tuple(fn(v) for v in self._values))

    def __repr__(self):
        body = ", ".join(f"{f}={v!r}" for f, v in zip(self._fields, self._values))
        return f"RecordedOutputs({body})"


def empty_recording(spec: OutputSpec, batch: int, steps: int, walks: int, device) -> tuple:
    """Uninitialised (batch, steps, ...) buffers for ``spec.fields``, which
    a captured round fills one step at a time."""
    return tuple(
        torch.empty((batch, steps) + ((walks,) if f in PER_WALK_FIELDS else ()),
                    dtype=FIELD_DTYPES[f], device=device)
        for f in spec.fields
    )


def stack_rounds(spec: OutputSpec, rounds: Sequence[tuple]) -> RecordedOutputs:
    """Stack per-round values of ``spec.fields`` along a time axis after
    the batch axis: every field comes back as (batch, steps, ...)."""
    return RecordedOutputs(
        spec.fields,
        tuple(torch.stack([r[i] for r in rounds], dim=1) for i in range(len(spec.fields))),
    )
