"""The experiment service: coalescing submissions from many callers (the
port of the JAX package's ``api/service.py``).

One process serving many studies wastes most of its time running
*compatible* work separately: two callers sweeping the same static
program structure (same algorithm / capacity / histogram resolution /
seeds / base key) each pay a full ``sweep_stacked`` run even though one
batch of rows (one captured round on the card) could run both scenario
lists as extra rows of ONE stacked call. :class:`ExperimentService`
closes that gap:

  * callers :meth:`~ExperimentService.submit` scenario lists and get a
    :class:`SubmissionFuture` back immediately;
  * pending requests are grouped by **coalescing key** —
    ``(group_key(scenario), seeds, base-key words)``, the same
    static-signature grouping ``Plan.sweep`` uses plus the batching
    axes — and each group executes as exactly one
    ``Plan.sweep_stacked`` call, however many callers contributed rows;
  * results stream back per group: a future over a mixed submission
    yields each scenario's outputs as soon as *its* group finishes
    (:meth:`SubmissionFuture.stream`), not when the whole sweep does;
  * every group call goes through the disk-backed
    :class:`~repro_torch.api.store.ResultStore` (default: the directory
    named by ``$REPRO_RESULT_STORE``, if set), so repeated studies are free
    across processes too.

Coalescing is bitwise-invisible to callers: ``sweep_stacked`` gives every
scenario row the same per-seed keys ``ensemble`` would derive from
``base_key`` (the stacking invariant of ``Plan.sweep``), so a scenario's results do not depend
on which strangers shared its batch (each trajectory row of the port
computes alone, its payload's training included). The coalescing key
pins ``seeds`` and the base key precisely so that invariant applies.

Two execution modes: the default background worker thread (submissions
coalesce across a short ``linger`` window), or ``autostart=False`` +
explicit :meth:`~ExperimentService.flush` for deterministic batching —
everything submitted since the last flush coalesces maximally (this is
what the tests and benchmarks use).

**Resilience** (the durable-execution contract, chaos-tested through
``repro_torch.utils.faults``): every group attempt passes fault site
``service.run_group``; retryable failures (:func:`default_retryable`)
retry with exponential backoff + jitter (drawn from the service's own
seeded ``random.Random``) up to ``retries`` times; a group
that still fails with >1 member is *split* and its members re-run
individually, so one poisoned scenario fails only its own futures; a
per-submission ``timeout=`` bounds how long requests may wait before
their future fails with :class:`DeadlineExceededError`; and a (simulated)
kill unwinding the worker thread never strands callers — pending futures
are failed, and ``flush``/``result`` detect the dead worker and drain
inline. ``close()`` is deterministic: post-close ``submit`` raises
:class:`ServiceClosedError` immediately, and anything still queued at
close resolves (delivered by the final drain, or failed with
:class:`ServiceClosedError`) — futures never hang.

On CUDA the worker thread runs inside ``torch.cuda.device(plan.device)``
(the current device is per host thread), and the runners it captures
capture in CUDA's ``thread_local`` mode (``kernels/capture.py``), so
callers may go on with their own CUDA work meanwhile; a cached runner
holds its lock for each run, so a caller's inline drain and the worker
never share its static buffers.
"""
from __future__ import annotations

import contextlib
import random
import threading
import time
from typing import Sequence

import torch

from repro_torch.api.results import SweepResult
from repro_torch.api.store import ResultStore
from repro_torch.utils.faults import TransientFault, fault_point

__all__ = [
    "ExperimentService",
    "SubmissionFuture",
    "ServiceClosedError",
    "DeadlineExceededError",
    "default_retryable",
]


class ServiceClosedError(RuntimeError):
    """``submit()`` on a closed service — it no longer accepts work."""


class DeadlineExceededError(TimeoutError):
    """A submission's deadline passed before its group (re)ran."""


def default_retryable(exc: BaseException) -> bool:
    """The default retry classification: transient injected faults and
    environmental IO/timeout errors retry; everything else — bad configs,
    shape errors, poisoned scenarios — fails fast (or splits)."""
    return isinstance(exc, (TransientFault, OSError, TimeoutError))


def _key_token(base_key) -> tuple:
    """Hashable coalescing token for a base key: its two threefry words,
    so equal keys — int seeds or key tensors — coalesce, distinct ones
    never do."""
    from repro_torch.api.plan import _as_key

    return ("key", tuple(_as_key(base_key, "cpu").tolist()))


class SubmissionFuture:
    """One caller's pending sweep: resolves to a :class:`SweepResult`.

    Scenario outputs land per coalesced group — :meth:`stream` yields
    ``(name, outputs, payload_outputs)`` in completion order as each
    group's compiled call finishes; :meth:`result` blocks for the full
    :class:`SweepResult` (input order, exactly what ``Plan.sweep``
    returns). A failure in any group the submission touched raises from
    both.
    """

    def __init__(self, service, names: tuple, has_payload: bool):
        self._service = service
        self.names = names
        self._outputs = [None] * len(names)
        self._payloads = [None] * len(names) if has_payload else None
        self._cv = threading.Condition()
        self._completed: list = []  # indices, completion order
        self._remaining = len(names)
        self._error: BaseException | None = None

    # -- delivery (service side) ------------------------------------------

    def _deliver(self, index: int, outputs, payload_outputs) -> None:
        with self._cv:
            self._outputs[index] = outputs
            if self._payloads is not None:
                self._payloads[index] = payload_outputs
            self._completed.append(index)
            self._remaining -= 1
            self._cv.notify_all()

    def _fail(self, exc: BaseException) -> None:
        with self._cv:
            if self._error is None:
                self._error = exc
            self._remaining = 0
            self._cv.notify_all()

    # -- consumption (caller side) ----------------------------------------

    def done(self) -> bool:
        """True once every scenario resolved (or the submission failed)."""
        with self._cv:
            return self._remaining == 0

    def result(self, timeout: float | None = None) -> SweepResult:
        """Block for the full :class:`SweepResult` (scenarios in
        submission order); raises the group's error on failure."""
        self._service._ensure_progress()
        with self._cv:
            if not self._cv.wait_for(lambda: self._remaining == 0, timeout):
                raise TimeoutError(
                    f"submission incomplete after {timeout}s "
                    f"({len(self._completed)}/{len(self.names)} scenarios)"
                )
            if self._error is not None:
                raise self._error
            return SweepResult(
                names=self.names,
                outputs=list(self._outputs),
                payloads=(
                    None if self._payloads is None else list(self._payloads)
                ),
            )

    def stream(self, timeout: float | None = None):
        """Yield ``(name, outputs, payload_outputs)`` per scenario in
        completion order, as coalesced groups finish (payload slot is
        None for payload-free plans). ``timeout`` bounds each wait."""
        self._service._ensure_progress()
        served = 0
        while True:
            with self._cv:
                if not self._cv.wait_for(
                    lambda: served < len(self._completed)
                    or self._remaining == 0,
                    timeout,
                ):
                    raise TimeoutError(
                        f"no scenario completed within {timeout}s"
                    )
                if self._error is not None:
                    raise self._error
                batch = self._completed[served:]
                served += len(batch)
                drained = self._remaining == 0 and served == len(
                    self._completed
                )
            for i in batch:
                yield (
                    self.names[i],
                    self._outputs[i],
                    None if self._payloads is None else self._payloads[i],
                )
            if drained:
                return


class _Request:
    """One scenario row of one submission, tagged for delivery."""

    __slots__ = (
        "future", "index", "scenario", "seeds", "base_key", "key", "deadline",
    )

    def __init__(self, future, index, scenario, seeds, base_key, key, deadline):
        self.future = future
        self.index = index
        self.scenario = scenario
        self.seeds = seeds
        self.base_key = base_key
        self.key = key  # the coalescing key
        self.deadline = deadline  # monotonic seconds, or None


class ExperimentService:
    """Coalescing submission queue over one compiled Plan (see module
    docstring).

    Parameters:
      experiment  the :class:`Experiment` (or pre-lowered ``Plan``) every
                  submission runs against;
      store       result persistence: ``'env'`` (default — honor
                  ``$REPRO_RESULT_STORE`` when set), None (off), a
                  directory path, or a :class:`ResultStore`;
      autostart   start the background worker thread (False: batches run
                  only on explicit :meth:`flush` — deterministic, used by
                  tests/benchmarks);
      linger      seconds the worker waits after a wake-up before
                  draining, so concurrent submitters land in one batch;
      retries     re-attempts per group on a retryable failure (see
                  ``retryable``) before splitting/failing;
      backoff     base seconds of the exponential retry backoff (each
                  retry waits ``backoff * 2**k``, +25% jitter);
      retryable   predicate ``exc -> bool`` classifying retryable
                  failures (default :func:`default_retryable`);
      segment_steps  when set, every group runs through the durable
                  segmented executor (``sweep_stacked(segment_steps=)``):
                  with a store, a killed process resumes half-finished
                  sweeps from their boundary snapshots; it never enters
                  the store's key.

    ``stats`` counts traffic: ``submissions`` / ``scenarios`` in,
    ``batches`` group runs out, ``coalesced`` scenarios that rode a
    batch with >1 submission contributing, ``retries`` re-attempts,
    ``splits`` degraded groups re-run member-by-member.
    """

    def __init__(
        self,
        experiment,
        *,
        store="env",
        autostart: bool = True,
        linger: float = 0.002,
        retries: int = 2,
        backoff: float = 0.05,
        retryable=None,
        segment_steps: int | None = None,
    ):
        from repro_torch.api.plan import Plan

        self.plan = (
            experiment if isinstance(experiment, Plan) else experiment.plan()
        )
        self.store = ResultStore.resolve(store)
        self.linger = float(linger)
        self.retries = int(retries)
        self.backoff = float(backoff)
        self.retryable = default_retryable if retryable is None else retryable
        self.segment_steps = segment_steps
        self._rng = random.Random(0)  # the retry jitter, reproducible
        self.stats = {
            "submissions": 0,
            "scenarios": 0,
            "batches": 0,
            "coalesced": 0,
            "retries": 0,
            "splits": 0,
        }
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._queue: list = []
        self._inflight = 0
        self._closed = False
        self._worker = None
        self._worker_error: BaseException | None = None
        if autostart:
            self._worker = threading.Thread(
                target=self._worker_loop,
                name="ExperimentService",
                daemon=True,
            )
            self._worker.start()

    # -- submission --------------------------------------------------------

    def submit(
        self,
        scenarios: Sequence,
        *,
        seeds: int,
        base_key=0,
        timeout: float | None = None,
    ) -> SubmissionFuture:
        """Enqueue a scenario list; returns immediately with a
        :class:`SubmissionFuture`. Scenarios coalesce with every pending
        request sharing ``(static structure, seeds, base_key)``.
        ``timeout=`` sets a deadline: requests whose group has not (re)run
        by then fail their future with :class:`DeadlineExceededError`."""
        from repro_torch.sweep.scenario import group_key

        scenarios = list(scenarios)
        if not scenarios:
            raise ValueError("submit() needs at least one scenario")
        names = tuple(
            getattr(s, "name", f"scenario{i}") for i, s in enumerate(scenarios)
        )
        dupes = sorted({n for n in names if names.count(n) > 1})
        if dupes:
            raise ValueError(f"duplicate scenario names in submission: {dupes}")
        seeds = int(seeds)
        ktok = _key_token(base_key)
        deadline = None if timeout is None else time.monotonic() + timeout
        future = SubmissionFuture(
            self, names, has_payload=self.plan.payload is not None
        )
        reqs = [
            _Request(
                future, i, s, seeds, base_key, (group_key(s), seeds, ktok),
                deadline,
            )
            for i, s in enumerate(scenarios)
        ]
        with self._lock:
            if self._closed:
                raise ServiceClosedError("ExperimentService is closed")
            self._queue.extend(reqs)
            self.stats["submissions"] += 1
            self.stats["scenarios"] += len(reqs)
            self._wake.notify_all()
        return future

    def run(self, scenarios: Sequence, *, seeds: int, base_key=0) -> SweepResult:
        """Submit and block for the result (one-caller convenience)."""
        return self.submit(scenarios, seeds=seeds, base_key=base_key).result()

    # -- execution ---------------------------------------------------------

    def flush(self, timeout: float | None = None) -> None:
        """Run everything pending and block until the queue is empty and
        no batch is in flight. With ``autostart=False`` (or a worker that
        died) this drains inline, so every submission since the last
        flush coalesces maximally — a dead worker never strands work."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._worker_alive() is None:
                self._drain()
            with self._lock:
                remaining = (
                    None if deadline is None
                    else max(0.0, deadline - time.monotonic())
                )
                if not self._wake.wait_for(
                    lambda: (not self._queue and self._inflight == 0)
                    or self._worker_error is not None,
                    remaining,
                ):
                    raise TimeoutError(f"queue not drained within {timeout}s")
                if not self._queue and self._inflight == 0:
                    return
            # the worker died mid-stream: loop around and take over inline

    def close(self, timeout: float | None = None) -> None:
        """Drain pending work, then stop the worker. Idempotent; further
        ``submit`` calls raise :class:`ServiceClosedError`. Deterministic
        teardown: every future submitted before close resolves — rows the
        final drain delivered succeed, anything left (a drain killed
        mid-way, a worker that never ran) fails with
        :class:`ServiceClosedError` — no caller hangs."""
        with self._lock:
            self._closed = True
            self._wake.notify_all()
        worker, self._worker = self._worker, None
        if worker is not None and worker.is_alive():
            worker.join(timeout)
        try:
            self._drain()  # autostart=False (or a dead worker): inline
        finally:
            with self._lock:
                leftovers, self._queue = self._queue, []
            if leftovers:
                exc = ServiceClosedError("ExperimentService is closed")
                for fut in {id(r.future): r.future for r in leftovers}.values():
                    fut._fail(exc)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _worker_alive(self):
        """The live worker thread, or None (not started / joined / died)."""
        worker = self._worker
        if worker is None or not worker.is_alive():
            return None
        return worker

    def _ensure_progress(self) -> None:
        """Guard futures against deadlock: blocking on a result while no
        live worker exists runs the pending batch inline."""
        if self._worker_alive() is None:
            self._drain()

    def _worker_loop(self) -> None:
        device = self.plan.device
        ctx = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
        try:
            with ctx:
                self._serve()
        except BaseException as exc:
            # the worker "process" died (e.g. a SimulatedKill). Record it
            # and wake waiters: flush()/result() detect the dead thread
            # and drain inline, so no caller hangs on a killed worker.
            with self._lock:
                self._worker_error = exc
                self._wake.notify_all()

    def _serve(self) -> None:
        while True:
            with self._lock:
                self._wake.wait_for(lambda: self._queue or self._closed)
                if self._closed and not self._queue:
                    return
            if self.linger:
                time.sleep(self.linger)  # let concurrent submitters land
            self._drain()

    def _drain(self) -> None:
        """Pop the whole queue, group by coalescing key, run each group
        as ONE ``sweep_stacked`` call, deliver rows to their futures."""
        with self._lock:
            batch, self._queue = self._queue, []
            self._inflight += 1
        try:
            groups: dict = {}
            order = []
            for req in batch:
                if req.key not in groups:
                    groups[req.key] = []
                    order.append(req.key)
                groups[req.key].append(req)
            for key in order:
                self._run_group(groups[key])
        finally:
            with self._lock:
                self._inflight -= 1
                self._wake.notify_all()

    def _expire(self, reqs: list) -> list:
        """Fail requests whose deadline passed; return the live rest."""
        now = time.monotonic()
        live = []
        for r in reqs:
            if r.deadline is not None and now > r.deadline:
                r.future._fail(
                    DeadlineExceededError(
                        f"submission deadline exceeded before scenario "
                        f"{getattr(r.scenario, 'name', r.index)!r} ran"
                    )
                )
            else:
                live.append(r)
        return live

    def _fail_group(self, reqs: list, exc: BaseException) -> None:
        for fut in {id(r.future): r.future for r in reqs}.values():
            fut._fail(exc)

    def _run_group(self, reqs: list, _split: bool = True) -> None:
        """Run one coalesced group with the full resilience ladder:
        deadline check -> attempt (fault site ``service.run_group``) ->
        exponential-backoff retries for retryable failures -> split a
        still-failing multi-member group and re-run members individually
        (one poisoned scenario fails only its own futures) -> clean
        per-future error delivery. A (simulated) kill fails the touching
        futures and re-raises — it unwinds the worker like the real thing.
        """
        plan = self.plan
        has_payload = plan.payload is not None
        reqs = self._expire(reqs)
        if not reqs:
            return
        attempt = 0
        while True:
            try:
                fault_point("service.run_group")
                stacked = plan.sweep_stacked(
                    [r.scenario for r in reqs],
                    seeds=reqs[0].seeds,
                    base_key=reqs[0].base_key,
                    store=self.store,
                    segment_steps=self.segment_steps,
                )
                break
            except Exception as exc:
                if attempt < self.retries and self.retryable(exc):
                    attempt += 1
                    self.stats["retries"] += 1
                    delay = self.backoff * (2 ** (attempt - 1))
                    if delay > 0:
                        time.sleep(delay * (1.0 + 0.25 * self._rng.random()))
                    reqs = self._expire(reqs)
                    if not reqs:
                        return
                    continue
                if _split and len(reqs) > 1:
                    # graceful degradation: the group is poisoned but the
                    # culprit is unknown — re-run members individually so
                    # only the culprit's futures fail
                    self.stats["splits"] += 1
                    for req in reqs:
                        self._run_group([req], _split=False)
                    return
                self._fail_group(reqs, exc)
                return
            except BaseException as exc:
                self._fail_group(reqs, exc)  # no caller may hang on a kill
                raise
        self.stats["batches"] += 1
        if len({id(r.future) for r in reqs}) > 1:
            self.stats["coalesced"] += len(reqs)
        for j, req in enumerate(reqs):
            row = plan._outputs(stacked, lambda v, j=j: v[j])
            outputs, payload_out = row if has_payload else (row, None)
            req.future._deliver(req.index, outputs, payload_out)

    def __repr__(self):
        s = self.stats
        return (
            f"ExperimentService({self.plan!r}, store={self.store!r}, "
            f"submissions={s['submissions']}, scenarios={s['scenarios']}, "
            f"batches={s['batches']})"
        )
