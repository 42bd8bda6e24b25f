"""Deterministic host-level fault injection (the chaos harness), the
port's own copy of the JAX package's ``utils/faults.py``.

The simulator's *walks* already survive arbitrary node/link failures by
construction; this module gives the *host* stack — result store IO,
service worker loop, segment checkpoints — the same systematically
exercised failure surface. A :class:`FaultPlan` scripts exactly which
named **site** fails on which invocation and how, so every chaos test is
deterministic and replayable:

    plan = FaultPlan().at("service.run_group", Raise(TransientFault("x")))
    with plan.active():
        ...   # the first _run_group attempt raises; the retry proceeds

Sites are plain strings compiled into the host code via
:func:`fault_point` calls — a no-op (one lookup of an inactive module
global) outside chaos tests. The instrumented sites of ``repro_torch``:

  ``checkpoint.write``   inside ``checkpoint._atomic_write``, before the
                         temp file is published (tearable: a :class:`Torn`
                         action leaves a truncated file at the FINAL path,
                         simulating a pre-atomic torn write, then kills);
  ``store.get``          entry of ``ResultStore.get``;
  ``store.put``          entry of ``ResultStore.put``;
  ``service.run_group``  entry of every ``ExperimentService`` group
                         attempt (initial, retry, and per-member split
                         re-runs all pass through it);
  ``segment.boundary``   after each completed segment of a segmented run
                         (snapshot already written — a :class:`Kill` here
                         is "the process died between segments").

Failure vocabulary:

  :class:`TransientFault`   an injected error the service's default
                            retry predicate classifies as retryable;
  :class:`PermanentFault`   never retried — exercises clean per-future
                            error delivery and group splitting;
  :class:`SimulatedKill`    "the process died HERE". Deliberately a
                            ``BaseException`` so no best-effort
                            ``except Exception`` recovery path can
                            swallow it — exactly like a real SIGKILL.

Actions: :class:`Raise`, :class:`Delay`, :class:`Kill`, :class:`Torn`.
Each site holds a FIFO of actions; every :func:`fault_point` hit pops
one (``None`` entries are explicit no-ops, for targeting the k-th
invocation). ``plan.hits`` counts every site hit and ``plan.fired``
records what actually fired, so tests can assert coverage.

Activation is a module-level global (NOT thread-local): the
ExperimentService worker runs on its own thread and must see the plan
the test activated. The active plan is this module's own: a plan
activated in the JAX package's copy does not fire here, nor the other
way round.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager

__all__ = [
    "FaultPlan",
    "fault_point",
    "Raise",
    "Delay",
    "Kill",
    "Torn",
    "FaultError",
    "TransientFault",
    "PermanentFault",
    "SimulatedKill",
    "SITES",
]

SITES = (
    "checkpoint.write",
    "store.get",
    "store.put",
    "service.run_group",
    "segment.boundary",
)


class FaultError(Exception):
    """Base class of injected exceptions."""


class TransientFault(FaultError):
    """An injected error the default service retry predicate retries."""


class PermanentFault(FaultError):
    """An injected error that must fail cleanly, never retry."""


class SimulatedKill(BaseException):
    """The process 'died' at a kill point.

    A ``BaseException`` on purpose: recovery code is allowed to swallow
    ``Exception`` (best-effort IO, retries) but a kill must unwind the
    whole host stack, exactly like the real thing.
    """

    def __init__(self, site: str):
        super().__init__(f"simulated process kill at fault site {site!r}")
        self.site = site


class Raise:
    """Raise ``exc`` (an instance, or a zero-arg factory/class)."""

    def __init__(self, exc):
        self.exc = exc

    def fire(self, site: str):
        exc = self.exc() if callable(self.exc) else self.exc
        raise exc

    def __repr__(self):
        return f"Raise({self.exc!r})"


class Delay:
    """Sleep ``seconds`` (slow IO / scheduler stall), then continue."""

    def __init__(self, seconds: float):
        self.seconds = float(seconds)

    def fire(self, site: str):
        time.sleep(self.seconds)

    def __repr__(self):
        return f"Delay({self.seconds})"


class Kill:
    """Raise :class:`SimulatedKill` — the process dies at this site."""

    def fire(self, site: str):
        raise SimulatedKill(site)

    def __repr__(self):
        return "Kill()"


class Torn:
    """Tear the write at a tearable site, then die.

    Only honored where :func:`fault_point` is called with
    ``tearable=True`` (``checkpoint.write``): the writer publishes the
    first ``keep_bytes`` of the payload at the FINAL path — the
    half-written file a pre-atomic writer leaves behind — and then
    raises :class:`SimulatedKill`. Recovery code must treat the torn
    file as absent/corrupt, never as data.
    """

    def __init__(self, keep_bytes: int = 24):
        self.keep_bytes = int(keep_bytes)

    def __repr__(self):
        return f"Torn(keep_bytes={self.keep_bytes})"


class FaultPlan:
    """A deterministic per-site schedule of fault actions (module docstring).

    ``at(site, *actions)`` appends actions to the site's FIFO; each
    :func:`fault_point` hit pops one (missing/None == no-op). Use
    ``plan.skip(site, k)`` to let the first k invocations through.
    """

    def __init__(self):
        self._sites: dict = {}
        self._lock = threading.Lock()
        self.hits: dict = {}
        self.fired: list = []

    def at(self, site: str, *actions) -> "FaultPlan":
        self._sites.setdefault(site, deque()).extend(actions)
        return self

    def skip(self, site: str, k: int = 1) -> "FaultPlan":
        """Append k explicit no-ops (target a later invocation)."""
        return self.at(site, *([None] * k))

    def pending(self, site: str) -> int:
        """Actions not yet consumed at ``site`` (0 == site is drained)."""
        return len(self._sites.get(site, ()))

    # -- firing (called from fault_point) ---------------------------------

    def _fire(self, site: str, tearable: bool):
        with self._lock:
            self.hits[site] = self.hits.get(site, 0) + 1
            queue = self._sites.get(site)
            action = queue.popleft() if queue else None
            if action is not None:
                self.fired.append((site, action))
        if action is None:
            return None
        if isinstance(action, Torn):
            if not tearable:
                raise RuntimeError(
                    f"Torn action scheduled at non-tearable site {site!r}"
                )
            return action  # the writer implements the tear + kill
        action.fire(site)
        return None

    @contextmanager
    def active(self):
        """Activate this plan process-wide for the duration of the block."""
        global _ACTIVE
        prev = _ACTIVE
        _ACTIVE = self
        try:
            yield self
        finally:
            _ACTIVE = prev

    def __repr__(self):
        sched = {s: list(q) for s, q in self._sites.items() if q}
        return f"FaultPlan(pending={sched}, hits={self.hits})"


_ACTIVE: FaultPlan | None = None


def fault_point(site: str, *, tearable: bool = False):
    """The instrumentation hook host code compiles in at a named site.

    No-op (returns None) unless a :class:`FaultPlan` is active. With an
    active plan: counts the hit, pops the site's next action and performs
    it — raising for :class:`Raise`/:class:`Kill`, sleeping for
    :class:`Delay`. A :class:`Torn` action is *returned* to the caller
    (only at ``tearable=True`` sites), which must tear its own write and
    raise :class:`SimulatedKill`.
    """
    plan = _ACTIVE
    if plan is None:
        return None
    return plan._fire(site, tearable)
