"""Trajectory output selection: which ``StepOutputs`` fields a run stacks.

Counterpart of the JAX package's ``core/outputs.py``. Every round
produces a full :class:`StepOutputs`; an :class:`OutputSpec` names the
fields a run keeps over time (scalars-only by default: the per-walk
fields are ``(W,)`` wide; all of them when a payload is attached), and a
:class:`PayloadOutputSpec` does the same for a payload's per-round
outputs. Recorded trajectories come back as a :class:`RecordedOutputs`.
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


@dataclasses.dataclass(frozen=True)
class PayloadOutputSpec:
    """The payload-output fields a run records: a selection of the
    fields of the NamedTuple a payload's ``on_visit`` returns (e.g.
    ``RwSgdOutputs``), in the payload's own field order; the selection
    comes back as a :class:`RecordedOutputs`. ``None`` in place of a
    spec records the payload's whole outputs."""

    fields: Tuple[str, ...]

    def __post_init__(self):
        wanted = tuple(self.fields)
        if not wanted:
            raise ValueError("PayloadOutputSpec needs at least one field")
        if len(set(wanted)) != len(wanted):
            object.__setattr__(self, "fields", tuple(dict.fromkeys(wanted)))

    def select(self, pout: Any) -> "RecordedOutputs":
        """The selected fields of one round's payload outputs."""
        have = getattr(pout, "_fields", None)
        if have is None:
            raise TypeError(
                "payload outputs are not field-addressable (no ._fields); "
                "emit a NamedTuple-like outputs pytree to use payload-output "
                f"thinning, or drop the payload field selection {self.fields!r}"
            )
        missing = [f for f in self.fields if f not in have]
        if missing:
            raise ValueError(
                f"payload outputs have no field(s) {missing!r}; this payload "
                f"emits {tuple(have)!r}"
            )
        keep = tuple(f for f in have if f in set(self.fields))
        return RecordedOutputs(keep, tuple(getattr(pout, f) for f in keep))


def resolve_spec(outputs: Any, payload: Any = None) -> OutputSpec:
    """``None`` / ``'scalars'`` / ``'full'`` / an OutputSpec / field
    names. ``None`` means scalars for a payload-free run and every field
    when a payload is attached (its hooks mirror the per-walk fork and
    terminate events)."""
    if outputs is None:
        return FULL if payload is not None else SCALARS
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


def split_outputs(outputs: Any, payload: Any):
    """Resolve ``outputs=`` to ``(OutputSpec, PayloadOutputSpec | None)``.

    A field-name sequence may mix ``StepOutputs`` names with the
    payload's own output fields (``payload.output_fields()``); a name in
    both sets is the ``StepOutputs`` field. ``None`` / a shorthand / an
    OutputSpec, or a sequence of ``StepOutputs`` names only, leave the
    payload recording everything (``None`` payload spec); a sequence
    naming payload fields makes them the PayloadOutputSpec, and its
    ``StepOutputs`` names (scalars where none is given) the OutputSpec.
    """
    if outputs is None or isinstance(outputs, (str, OutputSpec)):
        return resolve_spec(outputs, payload), None
    if isinstance(outputs, PayloadOutputSpec):
        if payload is None:
            raise ValueError("a PayloadOutputSpec was given but no payload is attached")
        return resolve_spec(None, payload), outputs
    if not isinstance(outputs, Sequence):
        return resolve_spec(outputs, payload), None  # its TypeError
    names = tuple(outputs)
    step = tuple(f for f in names if f in ALL_FIELDS)
    rest = tuple(f for f in names if f not in ALL_FIELDS)
    if not rest:
        return OutputSpec(step), None
    declared = tuple(payload.output_fields()) if payload is not None else ()
    unknown = [f for f in rest if f not in declared]
    if unknown:
        raise ValueError(
            f"unknown output field(s) {unknown!r}: not StepOutputs fields "
            f"({list(ALL_FIELDS)}) and not payload output fields "
            f"({list(declared)})"
        )
    spec = OutputSpec(step) if step else SCALARS
    return spec, PayloadOutputSpec(rest)


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
