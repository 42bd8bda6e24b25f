"""The program's own trace of a cell: the per-layer metrics that read the
port's stages, spans and counters (``repro_torch.utils.trace``).

In a ``--trace 1`` run the first of those metrics to be read calls
:func:`program`: it builds the cell again (the window's plan is gone by
then), runs the set-up study that captures every runner, then one more
study, index ``studies``, under a ``trace.Tracer`` (its result is
discarded), and attributes each runner's captured round stage by stage
with ``trace.round_stages`` over a window sized as ``tracing.profile``
sizes its own (about ``PROFILE_S`` of device time), but of at most
``MAX_TRACED_OPS`` operations with its leading round, half of
``tracing.profile``'s. The result is kept in ``record["program"]``; a
per-stage table and the study's named device gaps go to standard error.
A program without the tracer (no ``repro_torch.utils.trace`` or
``api.runners``) gives None, and so does every metric that reads it. It
reaches the program through those two public names only.

Standalone, on a card, for the device levels and the tracer's cost:

    python3 simbench/program_trace.py --workload <cell> --seed <n> [--repeat 3]

prints each runner's stage table after the set-up study, then,
``--repeat`` times, an untraced and a traced study with the same key
(each first every other time) and the stage tables again.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
import traceback

MAX_TRACED_OPS = 20_000  # a window of 28,000 or more lost its first records on an H100
PROFILE_S = 1.0  # device seconds profiled per runner, at most


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _run_seed() -> int:
    """The run's ``--seed`` (the harness keeps no seed in the record)."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_known_args()[0].seed


def _tools():
    """``(trace, runners)`` of the program, or None where it has no tracer."""
    try:
        from repro_torch.api import runners
        from repro_torch.utils import trace
    except ImportError:
        return None
    return trace, runners


def program(record: dict):
    """``record["program"]``, made at the first call (see the module)."""
    if "program" in record:
        return record["program"]
    record["program"] = None
    tools = _tools()
    if tools is None or record.get("device", "cpu") == "cpu":
        return None
    try:
        from simbench import harness

        record["program"] = trace_cell(harness.load_cell(record["cell"]), _run_seed(),
                                       record["studies"],
                                       statistics.median(record["study_s"]) / record["steps"],
                                       tools)
    except Exception:  # the metrics then stay out of the line; say why
        traceback.print_exc()
    return record["program"]


def traced_study(run, key, index: int, trace) -> tuple:
    """One study under a Tracer: (host seconds, ``Tracer.read()``)."""
    with trace.Tracer() as tracer:
        with trace.span("study", index=index):
            t0 = time.perf_counter()
            run.study(key)
            seconds = time.perf_counter() - t0
    return seconds, tracer.read()


def stage_rows(runners, per_round_s: float, trace) -> list:
    """Each captured runner's ``round_stages`` over its sized window."""
    live = [r for r in runners() if r.graph is not None]
    per_runner_s = per_round_s / max(1, len(live))
    out = []
    for r in live:
        nodes = sum(nd.kind in trace.DEVICE_KINDS for nd in r.graph.nodes)
        rounds = max(1, min(r.chunk - 1, MAX_TRACED_OPS // max(1, nodes) - 1,
                            round(PROFILE_S / per_runner_s)))
        before = event_ms(r, rounds)
        st = trace.round_stages(r, rounds)
        st.update(algorithm=r.setup.pcfg.algorithm, rows=int(r.batch), device_nodes=nodes,
                  event_ms=(before, event_ms(r, rounds)))
        out.append(st)
        log_stages(st)
    return out


def event_ms(runner, rounds: int) -> float:
    """A round's device time by CUDA events over ``rounds`` plain replays
    (the level the card is at around a profiled window)."""
    import torch

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    runner.column.zero_()
    a.record()
    runner.graph.replay(rounds)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / rounds


def log_stages(st: dict) -> None:
    _log(f"[program] {st['algorithm']} x {st['rows']}: {st['rounds']} rounds profiled, "
         f"{st['device_ops']} ops; a round: span {st['span_ms']:.4f} ms, between nodes "
         f"{st['gap_ms']:.4f} ms (median round {st['median_gap_ms']:.4f}), threefry "
         f"{st['threefry_ms']:.4f} ms ({st['threefry_blocks']} blocks), between rounds "
         f"{st['launch_gap_ms']:.4f} ms; "
         f"self + gaps = {st['accounted']:.5f} of the span; by CUDA events before and after "
         f"{st['event_ms'][0]:.4f} / {st['event_ms'][1]:.4f} ms a round; largest gaps (µs, "
         f"round, node, stage) {[(round(g, 2), r, i, p) for g, r, i, p in st['largest_gaps']]}")
    _log(f"[program]   {'stage':<28} {'nodes':>6} {'kern':>5} {'blocks':>11} {'device ms':>10} "
         f"{'self ms':>9} {'kernel ms':>9} {'gap ms':>8}")
    for path, s in st["stages"].items():
        _log(f"[program]   {path:<28} {s.get('nodes', 0):>6} {s.get('kernel_nodes', 0):>5} "
             f"{s.get('threefry_blocks', 0):>11} {s['device_ms']:>10.4f} {s['self_ms']:>9.4f} "
             f"{s['kernel_ms']:>9.4f} {s['gap_ms']:>8.4f}")


def log_study(seconds: float, read: dict) -> None:
    _log(f"[program] traced study: {seconds:.3f} s, {len(read['spans'])} spans, counters "
         f"{read['counters']}, device busy {read.get('busy_s', 0):.3f} s of "
         f"{read.get('window_s', 0):.3f} s, clock drift {read.get('drift_ns', 0):.0f} ns")
    for name, s in read.get("idle_by_name", [])[:8]:
        _log(f"[program]   device idle {s * 1e3:.3f} ms under {name}")


def trace_cell(cell, seed: int, index: int, per_round_s: float, tools) -> dict:
    """The cell's runners captured afresh, study ``index`` traced, each
    runner's round attributed; ``per_round_s`` (a round of every runner)
    sizes the profiled windows."""
    from simbench import harness

    trace, runners = tools
    run = harness.Run(cell, "cuda")
    run.study(harness.study_key(seed, harness.WARMUP_STUDY))  # captures every runner
    seconds, read = traced_study(run, harness.study_key(seed, index), index, trace)
    log_study(seconds, read)
    return dict(
        study_s=seconds, counters=read["counters"], busy_s=read.get("busy_s"),
        window_s=read.get("window_s"), drift_ns=read.get("drift_ns"),
        idle_by_name=read.get("idle_by_name", []), spans=len(read["spans"]),
        runners=stage_rows(runners, per_round_s, trace),
    )


# -- what the metrics read: sums over the cell's runners ----------------------


def _runners(record):
    prog = program(record)
    return (prog or {}).get("runners") or None


def _span_ms(r) -> float:
    """A round's span with the median round's gaps: a profiled window can
    stall for milliseconds inside one of its rounds (the profiler's own
    doing), which the mean span would carry."""
    return r["span_ms"] - r["gap_ms"] + r["median_gap_ms"]


def threefry_share(record):
    """The own device time of every ``threefry`` stage over the rounds'
    spans, summed over the runners, in %."""
    rs = _runners(record)
    return None if rs is None else 100.0 * sum(r["threefry_ms"] for r in rs) / sum(
        _span_ms(r) for r in rs)


def node_gap_share(record):
    """The rounds' spans that no device operation covers, over the spans,
    summed over the runners, in %."""
    rs = _runners(record)
    return None if rs is None else 100.0 * sum(r["median_gap_ms"] for r in rs) / sum(
        _span_ms(r) for r in rs)


def threefry_blocks_per_round(record):
    """The threefry blocks one round of every runner hashes (the capture's
    count), summed."""
    rs = _runners(record)
    return None if rs is None else float(sum(r["threefry_blocks"] for r in rs))


def main() -> int:
    from pathlib import Path

    checkout = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(checkout), str(checkout / "src")]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args()
    from simbench import harness

    tools = _tools()
    if tools is None:
        _log("program_trace: the program has no tracer")
        return 1
    trace, runners = tools
    run = harness.Run(harness.load_cell(args.workload), "cuda")
    run.study(harness.study_key(args.seed, harness.WARMUP_STUDY))
    live = [r for r in runners() if r.graph is not None]
    stage_rows(runners, sum(event_ms(r, 1) for r in live) / 1e3, trace)  # before any study
    for i in range(args.repeat):  # untraced and traced in turns, each first every other time
        key = harness.study_key(args.seed, i)
        if i % 2:
            traced, read = traced_study(run, key, i, trace)
        t0 = time.perf_counter()
        run.study(key)
        plain = time.perf_counter() - t0
        if not i % 2:
            traced, read = traced_study(run, key, i, trace)
        _log(f"[program] study {i}: untraced {plain:.4f} s, traced {traced:.4f} s "
             f"({100 * (traced / plain - 1):+.2f} %)")
        log_study(traced, read)
        stage_rows(runners, plain / run.steps, trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
