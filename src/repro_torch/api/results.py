"""Result containers for the declarative Experiment API (counterpart of
the JAX package's ``api/results.py``)."""
from __future__ import annotations

__all__ = ["SweepResult"]


class SweepResult:
    """Per-scenario outputs of a sweep, input order preserved.

    ``len`` is the scenario count, iteration yields each scenario's
    outputs (leading ``(seeds,)`` axis), and indexing takes a position or
    a scenario name. An unknown name raises ``KeyError`` listing the
    names; duplicate names are refused at construction. When the sweep
    carried a payload, ``payloads`` is the parallel list of per-scenario
    payload outputs (``payload(name_or_index)`` looks one up); otherwise
    it is ``None``.
    """

    def __init__(self, names: tuple, outputs: list, payloads: list | None = None):
        self.names = tuple(names)
        dupes = sorted({n for n in self.names if self.names.count(n) > 1})
        if dupes:
            raise ValueError(
                f"duplicate scenario name(s) {dupes!r}: every scenario in a "
                "sweep needs a unique name, or name lookups would silently "
                "resolve to the first match"
            )
        self.outputs = list(outputs)
        if len(self.outputs) != len(self.names):
            raise ValueError(
                f"{len(self.names)} names but {len(self.outputs)} outputs"
            )
        self.payloads = list(payloads) if payloads is not None else None

    def _index(self, i) -> int:
        if isinstance(i, str):
            try:
                return self.names.index(i)
            except ValueError:
                raise KeyError(
                    f"unknown scenario name {i!r}; available scenarios: "
                    f"{list(self.names)}"
                ) from None
        return i

    def __getitem__(self, i):
        return self.outputs[self._index(i)]

    def payload(self, i):
        """Per-scenario payload outputs by position or scenario name."""
        if self.payloads is None:
            raise KeyError(
                "this sweep ran without a payload, so there are no payload "
                "outputs; attach payload= to the Experiment to record them"
            )
        return self.payloads[self._index(i)]

    def __len__(self):
        return len(self.outputs)

    def __iter__(self):
        return iter(self.outputs)

    def items(self):
        return list(zip(self.names, self.outputs))

    def __repr__(self):
        return f"SweepResult({len(self.outputs)} scenarios: {list(self.names)!r})"
