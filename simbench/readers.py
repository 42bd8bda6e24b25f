"""What the metric readers of ``metrics/`` share: each reads the run's
record (``harness.run_cell``) and returns a number, or None where the
run has nothing to read (the harness then leaves the metric out)."""
from __future__ import annotations

from simbench import counts


def traj_rounds(record) -> float:
    """Trajectory-rounds a second: the rows of every completed study times
    its rounds, over the window's wall time."""
    return record["studies"] * record["rows"] * record["steps"] / record["window_s"]


def _traced(record):
    return (record.get("trace") or {}).get("runners") or None


def kernels_per_round(record):
    """The captured rounds' kernel nodes, summed over the cell's runners."""
    nodes = [r["kernel_nodes"] for r in record["runners"] if r["kernel_nodes"] is not None]
    return float(sum(nodes)) if nodes else None


def capture_s(record):
    caps = [r["capture_s"] for r in record["runners"] if r["capture_s"] is not None]
    return float(sum(caps)) if caps else None


def round_mfu(record):
    """The least time the chip could take for a round's own work, over the
    device's time per round by CUDA events, summed over the runners (a
    study runs each runner's rounds in turn), in %."""
    runners = _traced(record)
    if not runners:
        return None
    least = sum(counts.least_seconds(counts.round_work(record["shape"], r["algorithm"], r["rows"]))
                for r in runners)
    return 100.0 * least / sum(r["event_ms_per_round"] / 1e3 for r in runners)


def whole_round_roofline(record):
    """whole_round's least time from the round's shapes over its two
    launches' device time per round in the profiled window, in %."""
    runners = [r for r in _traced(record) or () if r["whole_round_s"] > 0]
    if not runners:
        return None
    least = sum(counts.least_seconds(counts.whole_round_work(record["shape"], r["rows"]))
                for r in runners)
    return 100.0 * least / sum(r["whole_round_s"] / r["profiled_rounds"] for r in runners)


def device_idle(record):
    """1 - the captured rounds' device time (CUDA events around every
    replay in the window) over the window (events at its start and end),
    in %: the share in which the device waits for the host."""
    trace = record.get("trace")
    if not trace or not trace["window_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
