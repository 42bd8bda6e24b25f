"""Stages, counters and spans of the port: where a round's device time and
a study's host time go.

- **Stages** (:func:`stage`) name the parts of a round in the round's own
  code (``keys``, ``draws``, ``whole_round``, ..., and ``threefry`` inside
  every hash). They cost nothing at replay: while a
  :class:`~repro_torch.kernels.capture.Captured` captures, each stage
  boundary records the last graph node captured so far, and after the
  capture every node gets the path of the stage it was captured in
  (``round/draws/threefry``; :func:`assign_stages`). Outside a capture a
  stage is one check of a module global.
- **Counters** (:func:`count`) add a number under the open stage: inside a
  capture to that stage of the captured graph (one round's count, which
  every replay repeats); otherwise to the active :class:`Tracer`, for work
  that runs eagerly. ``prng.threefry2x32`` counts ``threefry_blocks``.
- **Spans** (:func:`span`) time host work: name, attributes, id, parent,
  thread, trace (the spans under one top-level span of a thread), start
  and end on ``time.perf_counter_ns``. A span always times itself
  (``seconds``); only an active :class:`Tracer` keeps it. While a Tracer
  is active, ``Captured.replay`` also records CUDA events around its graph
  launches and adds its graph's counts; the Tracer puts those events on
  the host clock through two anchors.

:func:`round_stages` replays a runner's captured round under
``torch.profiler`` and gives each stage its device time from the
operations of its own nodes (:func:`attribute`, a pure function of the
graph's nodes and the profiled operations).

    with trace.Tracer() as tracer:
        plan.sweep_group(scenarios, seeds=50)
    tracer.read()  # spans, counters, device busy / window, named idle gaps
    trace.round_stages(runner, rounds=20)  # per-stage device time of a round
"""
from __future__ import annotations

import contextlib
import itertools
import statistics
import threading
import time
from typing import NamedTuple

_CAPTURE = None  # the StageRecorder of the capture in progress
_TRACER = None  # the active Tracer
_NULL = contextlib.nullcontext()

DEVICE_KINDS = ("kernel", "memset", "memcpy")  # graph nodes that run device work
THREEFRY = "threefry"


def stage(name: str):
    """A context manager naming the work inside it as stage ``name`` of
    the round being captured (nested in the stage open around it)."""
    rec = _CAPTURE
    if rec is None or rec.thread != threading.get_ident():
        return _NULL
    return rec.stage(name)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name``: to the open stage of the capture in
    progress on this thread, else to the active Tracer, else nowhere."""
    rec = _CAPTURE
    if rec is not None and rec.thread == threading.get_ident():
        rec.add(name, n)
        return
    tracer = _TRACER
    if tracer is not None:
        tracer.add(name, n)


def active():
    """The active :class:`Tracer`, or None."""
    return _TRACER


# ---------------------------------------------------------------------------
# Stages of a captured graph
# ---------------------------------------------------------------------------


class StageRecorder:
    """The stage marks of one capture. ``frontier()`` returns the graph
    nodes that the next captured work would depend on (the last ones
    captured); each mark pairs it with the stage path open before the
    mark, so the nodes captured since the previous mark belong to that
    path. ``counts`` holds each path's counters."""

    def __init__(self, root: str, frontier):
        self.root, self.frontier = root, frontier
        self.thread = threading.get_ident()
        self.path = [root]
        self.marks: list = []
        self.counts: dict = {}

    def _mark(self) -> None:
        self.marks.append((tuple(self.frontier()), "/".join(self.path)))

    @contextlib.contextmanager
    def stage(self, name: str):
        self._mark()
        self.path.append(name)
        try:
            yield
        finally:
            self._mark()
            self.path.pop()

    def add(self, name: str, n: int) -> None:
        c = self.counts.setdefault("/".join(self.path), {})
        c[name] = c.get(name, 0) + int(n)

    def finish(self) -> None:
        """The last mark: what follows the last stage is the root's."""
        self._mark()


@contextlib.contextmanager
def recording(recorder: StageRecorder):
    """Route this thread's stages and counts to ``recorder`` (one capture
    at a time in a process)."""
    global _CAPTURE
    if _CAPTURE is not None:
        raise RuntimeError("a capture's stages are already being recorded")
    _CAPTURE = recorder
    try:
        yield recorder
    finally:
        _CAPTURE = None


def assign_stages(preds: dict, order: list, marks: list, root: str) -> dict:
    """node -> stage path. ``marks`` in capture order, each ``(frontier,
    path)``: the nodes the frontier depends on (itself included) that no
    earlier mark covered were captured under ``path``. ``preds`` maps a
    node to the nodes it depends on; a node no mark covers is the root's."""
    out: dict = {}
    for frontier, path in marks:
        todo = [n for n in frontier if n not in out]
        while todo:
            node = todo.pop()
            if node in out:
                continue
            out[node] = path
            todo.extend(p for p in preds.get(node, ()) if p not in out)
    for node in order:
        out.setdefault(node, root)
    return out


class Node(NamedTuple):
    """One node of a captured graph, in the graph's order."""

    path: str  # the stage it was captured in
    kind: str  # 'kernel' | 'memset' | 'memcpy' | another node type's name
    name: str | None  # a kernel node's device function (as compiled)
    symbol: str | None  # the port kernel it runs, if any (its name in a profile)


def stage_table(nodes: list, counts: dict) -> dict:
    """path -> ``{"nodes", "kernel_nodes", <counter>...}``: each stage's
    own graph nodes and its own counts (a parent's exclude its children's)."""
    table: dict = {}
    for nd in nodes:
        row = table.setdefault(nd.path, {"nodes": 0, "kernel_nodes": 0})
        row["nodes"] += 1
        row["kernel_nodes"] += nd.kind == "kernel"
    for path, c in counts.items():
        row = table.setdefault(path, {"nodes": 0, "kernel_nodes": 0})
        for k, v in c.items():
            row[k] = row.get(k, 0) + v
    return table


# ---------------------------------------------------------------------------
# Spans and the Tracer
# ---------------------------------------------------------------------------


class Span:
    """A timed piece of host work (see :func:`span`)."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "id", "parent", "trace", "thread",
                 "_tracer")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.id = self.parent = self.trace = self.thread = self._tracer = None
        self.start_ns = self.end_ns = 0

    def __enter__(self):
        tracer = _TRACER
        if tracer is not None:
            tracer._open(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._tracer is not None:
            self._tracer._close(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def span(name: str, **attrs) -> Span:
    """A context manager timing host work ``name`` (``.seconds`` after
    it); an active :class:`Tracer` keeps it with its parent, thread and
    trace ids."""
    return Span(name, attrs)


def self_times(spans: list) -> dict:
    """span id -> its duration minus the part its children cover (ns)."""
    children: dict = {}
    for s in spans:
        if s["parent"] is not None:
            children.setdefault(s["parent"], []).append((s["start_ns"], s["end_ns"]))
    return {s["id"]: s["end_ns"] - s["start_ns"] - covered(children.get(s["id"], ()))
            for s in spans}


def covered(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def host_clock(anchors: list):
    """The map from a device offset (ms after the first anchor's event) to
    host ns, from two anchors ``(host_ns, device_ms_after_first)``: the
    first anchor's host time plus the offset scaled by the host's length
    of the window over the device's (the clocks' drift spread evenly)."""
    (h0, d0), (h1, d1) = anchors
    scale = (h1 - h0) / ((d1 - d0) * 1e6) if d1 > d0 else 1.0
    return lambda ms: h0 + (ms - d0) * 1e6 * scale


def device_gaps(marks: list, start_ns: float, end_ns: float) -> list:
    """The ``(start, end)`` host-ns intervals of the window in which no
    replay ran, given the replays' ``(start, end)``."""
    gaps, t = [], start_ns
    for s, e in sorted(marks):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if end_ns > t:
        gaps.append((t, end_ns))
    return gaps


def name_gaps(gaps: list, spans: list) -> list:
    """Each gap as ``(start_ns, length_ns, name)``: the path of the
    innermost span open over most of it, or ``caller`` where none was."""
    by_id = {s["id"]: s for s in spans}

    def depth(s):
        d = 0
        while s["parent"] is not None and s["parent"] in by_id:
            s, d = by_id[s["parent"]], d + 1
        return d

    def path(s):
        names = [s["name"]]
        while s["parent"] is not None and s["parent"] in by_id:
            s = by_id[s["parent"]]
            names.append(s["name"])
        return "/".join(reversed(names))

    out = []
    for g0, g1 in gaps:
        best = None
        for s in spans:
            if 2 * (min(g1, s["end_ns"]) - max(g0, s["start_ns"])) > g1 - g0:
                if best is None or depth(s) > depth(best):
                    best = s
        out.append((g0, g1 - g0, "caller" if best is None else path(best)))
    return out


class Tracer:
    """Keeps spans, counters and replay marks while active (one at a time
    in a process; ``with Tracer() as t:`` or ``start`` / ``stop``). On a
    CUDA device it anchors the device clock to the host's at start and at
    stop: an event recorded on a synchronized device, and the host clock
    read right after that event's ``synchronize()``."""

    def __init__(self):
        import torch

        self.cuda = torch.cuda.is_available()
        self._spans: list = []
        self.counters: dict = {}
        self._marks: list = []  # (graph root, start event, end event, times)
        self._anchors: list = []  # (event, host ns)
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()

    # -- life ---------------------------------------------------------------

    def start(self) -> "Tracer":
        global _TRACER
        if _TRACER is not None:
            raise RuntimeError("a Tracer is already active")
        if self.cuda:
            self._anchors.append(self._anchor())
        _TRACER = self
        return self

    def stop(self) -> None:
        global _TRACER
        if _TRACER is self:
            _TRACER = None
            if self.cuda:
                self._anchors.append(self._anchor())

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    @staticmethod
    def _anchor():
        import torch

        torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ev.synchronize()
        return ev, time.perf_counter_ns()

    # -- recording ----------------------------------------------------------

    def _open(self, s: Span) -> None:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        s._tracer, s.id, s.thread = self, next(self._ids), threading.get_ident()
        s.parent = stack[-1].id if stack else None
        s.trace = stack[0].id if stack else s.id
        stack.append(s)

    def _close(self, s: Span) -> None:
        stack = self._local.stack
        if stack and stack[-1] is s:
            stack.pop()
        with self._lock:
            self._spans.append(s)

    def add(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + int(n)

    def device_mark(self):
        """A CUDA event recorded now (the start of a replay)."""
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def replayed(self, graph, start, times: int) -> None:
        """A replay of ``graph`` (a ``Captured``) ``times`` times since the
        event ``start``: its end event, and its counts ``times`` over."""
        end = self.device_mark()
        with self._lock:
            self._marks.append((graph.root, start, end, int(times)))
            for name, n in graph.counts.items():
                self.counters[name] = self.counters.get(name, 0) + n * int(times)

    # -- reading ------------------------------------------------------------

    def read(self) -> dict:
        """``spans`` (with ``self_ns``), ``counters`` and, on a CUDA
        device, ``busy_s`` (the union of the replays), ``window_s`` (anchor
        to anchor on the device), ``drift_ns`` (the host's window minus the
        device's), ``replays`` (host ns) and ``idle_gaps`` / ``idle_by_name``
        (each device gap between replays named by :func:`name_gaps`)."""
        if _TRACER is self:
            raise RuntimeError("stop the Tracer before reading it")
        spans = [dict(id=s.id, parent=s.parent, trace=s.trace, thread=s.thread, name=s.name,
                      attrs=dict(s.attrs), start_ns=s.start_ns, end_ns=s.end_ns)
                 for s in sorted(self._spans, key=lambda s: (s.start_ns, s.id))]
        selfs = self_times(spans)
        for s in spans:
            s["dur_ns"] = s["end_ns"] - s["start_ns"]
            s["self_ns"] = selfs[s["id"]]
        out = dict(spans=spans, counters=dict(self.counters))
        if len(self._anchors) < 2:
            return out
        (e0, h0), (e1, h1) = self._anchors
        e1.synchronize()
        to_host = host_clock([(h0, 0.0), (h1, e0.elapsed_time(e1))])
        replays = [(to_host(e0.elapsed_time(a)), to_host(e0.elapsed_time(b)), n, root)
                   for root, a, b, n in self._marks]
        gaps = name_gaps(device_gaps([(s, e) for s, e, _, _ in replays], h0, h1), spans)
        by_name: dict = {}
        for _, length, name in gaps:
            by_name[name] = by_name.get(name, 0.0) + length / 1e9
        window_ms = e0.elapsed_time(e1)
        out.update(
            busy_s=covered([(s, e) for s, e, _, _ in replays]) / 1e9,
            window_s=window_ms / 1e3, drift_ns=(h1 - h0) - window_ms * 1e6,
            replays=[dict(start_ns=s, end_ns=e, times=n, graph=root) for s, e, n, root in replays],
            idle_gaps=[dict(start_ns=s, length_ns=g, name=name) for s, g, name in gaps],
            idle_by_name=sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1]),
        )
        return out


# ---------------------------------------------------------------------------
# Device attribution of a captured round
# ---------------------------------------------------------------------------


class MisalignedWindow(RuntimeError):
    """A profiled window whose operations do not line up with the graph's
    device nodes (the profiler dropped or added records)."""


def op_kind(name: str) -> str:
    """A profiled device operation's node kind, from its name: a graph's
    memset and memcpy nodes run as device functions named ``memset32``,
    ``memcpy32_post`` and the like (a stream's as ``Memset`` /
    ``Memcpy`` records)."""
    low = name[:6].lower()
    return low if low in ("memset", "memcpy") else "kernel"


def _prefixes(path: str):
    parts = path.split("/")
    return ["/".join(parts[:i]) for i in range(1, len(parts) + 1)]


def attribute(nodes: list, ops: list, rounds: int) -> dict:
    """Each stage's device time in ``rounds`` replays of a chain graph.

    ``nodes``: the graph's device nodes in chain order, each ``(path,
    kind, symbol)``; ``ops``: the profiled device operations ``(start,
    end, name)`` in µs, sorted by start. The window must hold exactly
    ``rounds`` × the nodes, each of the node's kind, and the op at a port
    kernel's node must carry that kernel's name; else
    :class:`MisalignedWindow`. ``largest_gaps``: the five longest gaps
    between nodes, ``(µs, round, node, path of the node after it)``;
    ``median_gap_ms``: the median round's gaps (a profiled window can
    stall for milliseconds inside one round). Per
    round, in ms: ``span_ms`` (each round's
    first op start to its last op end), ``gap_ms`` (the span no op
    covers), ``launch_gap_ms`` (between one round's last op and the
    next's first: outside the spans), and per stage path ``self_ms`` (its
    own nodes' op time), ``kernel_ms`` (its own kernel ops), ``gap_ms``
    (the gaps before its own nodes) and ``device_ms`` (first op start to
    last op end over each contiguous run of its own and its children's
    nodes). The stages' self and gap times add up to the span."""
    N = len(nodes)
    if N == 0 or len(ops) != rounds * N:
        raise MisalignedWindow(f"{len(ops)} device ops for {rounds} rounds of {N} device nodes")
    stages: dict = {}

    def row(path):
        r = stages.get(path)
        if r is None:
            r = stages[path] = dict(self_ms=0.0, kernel_ms=0.0, gap_ms=0.0, device_ms=0.0)
        return r

    span = gaps = launch = 0.0
    round_gaps, largest = [], []  # each round's gaps (ms); (gap µs, round, node, path)
    prev_end = None
    for r in range(rounds):
        window = ops[r * N:(r + 1) * N]
        end, gaps_before = None, gaps
        runs: dict = {}  # prefix -> (first start, last end, last index)
        for i, ((path, kind, symbol), (s, e, name)) in enumerate(zip(nodes, window)):
            if op_kind(name) != kind:
                raise MisalignedWindow(f"round {r}, node {i}: a {kind} node ran as {name!r}")
            if symbol and symbol not in name:
                raise MisalignedWindow(f"round {r}, node {i}: {symbol} ran as {name!r}")
            st = row(path)
            st["self_ms"] += (e - s) / 1e3
            if kind == "kernel":
                st["kernel_ms"] += (e - s) / 1e3
            if end is not None and s > end:
                st["gap_ms"] += (s - end) / 1e3
                gaps += (s - end) / 1e3
                largest.append((s - end, r, i, path))
            end = e if end is None else max(end, e)
            for p in _prefixes(path):
                run = runs.get(p)
                if run is not None and run[2] == i - 1:
                    runs[p] = (run[0], max(run[1], e), i)
                else:
                    if run is not None:
                        row(p)["device_ms"] += (run[1] - run[0]) / 1e3
                    runs[p] = (s, e, i)
        for p, (s0, e0, _) in runs.items():
            row(p)["device_ms"] += (e0 - s0) / 1e3
        span += (end - window[0][0]) / 1e3
        round_gaps.append(gaps - gaps_before)
        if prev_end is not None:
            launch += max(0.0, window[0][0] - prev_end) / 1e3
        prev_end = end
    accounted = sum(st["self_ms"] for st in stages.values()) + gaps
    if abs(accounted - span) > 0.01 * span:
        raise MisalignedWindow(f"ops overlap: self + gaps {accounted:.4f} ms, span {span:.4f} ms")
    per = 1.0 / rounds
    return dict(
        rounds=rounds, device_ops=len(ops), span_ms=span * per, gap_ms=gaps * per,
        median_gap_ms=statistics.median(round_gaps),
        launch_gap_ms=launch / max(1, rounds - 1), accounted=accounted / span if span else 1.0,
        largest_gaps=sorted(largest, reverse=True)[:5],
        stages={p: {k: v * per for k, v in st.items()} for p, st in sorted(stages.items())},
    )


def last_rounds(ops: list, nodes: int, rounds: int, pad: int) -> list:
    """The operations of the last ``rounds`` of ``rounds + pad`` profiled
    replays of ``nodes`` device nodes each. A long window loses its first
    records (the profiler's buffers), so ``pad`` leading rounds absorb up
    to ``pad * nodes`` lost operations; more lost, or any extra, is a
    :class:`MisalignedWindow`."""
    want = rounds * nodes
    if not want <= len(ops) <= (rounds + pad) * nodes:
        raise MisalignedWindow(f"{len(ops)} device ops for {rounds} + {pad} rounds of {nodes} "
                               "device nodes")
    return ops[len(ops) - want:]


def is_threefry(path: str) -> bool:
    return path.rsplit("/", 1)[-1] == THREEFRY


def round_stages(runner, rounds: int, *, tries: int = 3) -> dict:
    """``rounds`` replays of ``runner``'s captured round under
    ``torch.profiler`` (CUDA activity only), after one more that absorbs
    the records a long window loses at its start (:func:`last_rounds`),
    attributed stage by stage (:func:`attribute`; a misaligned window is
    profiled again, up to ``tries`` times, then raises). The runner's
    recording column is zeroed outside the profiler, so ``rounds`` may be
    up to ``runner.chunk`` (then with no leading round); the replays run
    on the runner's own buffers, which the next run copies its inputs
    into afresh. Adds to :func:`attribute`'s result
    ``threefry_ms`` (the own time of every ``threefry`` stage),
    ``threefry_blocks`` (one round's, from the capture) and each stage's
    ``nodes``, ``kernel_nodes`` and counts."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    graph = runner.graph
    if graph is None:
        raise ValueError("the runner has not captured its round")
    if not graph.chain:
        raise ValueError("the captured round is not a chain of nodes: no order to attribute by")
    rounds = int(rounds)
    if not 1 <= rounds <= runner.chunk:
        raise ValueError(f"rounds must be in [1, {runner.chunk}] (the runner's chunk)")
    nodes = [(nd.path, nd.kind, nd.symbol) for nd in graph.nodes if nd.kind in DEVICE_KINDS]
    pad = 1 if rounds < runner.chunk else 0
    err = None
    for _ in range(tries):
        runner.column.zero_()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            graph.replay(rounds + pad)
            torch.cuda.synchronize()
        ops = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                     if e.device_type == DeviceType.CUDA)
        try:
            out = attribute(nodes, last_rounds(ops, len(nodes), rounds, pad), rounds)
        except MisalignedWindow as exc:
            err = exc
            continue
        for path, row in graph.stages.items():
            out["stages"].setdefault(path, dict(self_ms=0.0, kernel_ms=0.0, gap_ms=0.0,
                                                device_ms=0.0)).update(row)
        out.update(
            threefry_ms=sum(st["self_ms"] for p, st in out["stages"].items() if is_threefry(p)),
            threefry_blocks=int(graph.counts.get("threefry_blocks", 0)),
        )
        return out
    raise err
