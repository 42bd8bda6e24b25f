"""The traced part of a ``--trace 1`` run.

During the window, :class:`ReplayClock` puts CUDA events around every
replay of a captured round (one call replays a chunk of up to 256
rounds): the device's busy time is the replays' event time, the window
runs from an event at its start to one at its end, and each gap between
two replays is named by what the host does there (the runner's chunk
copies, the next group's or study's set-up). After the window, each
runner replays its captured round between CUDA events (its device time
per round) and then under ``torch.profiler`` (each device operation's
time, whole_round's among them). The profiler is not used for the idle
share: under it a graph launch takes the host 3-5 ms where the device
runs the replay in 2.5 (0.5 ms of host time without it), so the device
waits for the host, there only. Replays run on the runner's own buffers
from where the window left them; a study copies its inputs in afresh, so
they change no result.
"""
from __future__ import annotations

import statistics
import time

MAX_TRACED_OPS = 40_000  # a profiled window keeps about 110,000 records
EVENT_GROUP_S = 0.25  # device seconds between two CUDA events
PROFILE_S = 1.0  # device seconds profiled per runner, at most
PROFILE_TRIES = 3
WHOLE_ROUND_KERNELS = ("whole_round_kernel", "whole_round_topology_kernel")


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _replay(runner, rounds: int) -> None:
    runner.column.zero_()  # the recording chunk's column: at most ``chunk`` rounds a call
    runner.graph.replay(rounds)


def _event_ms(torch, runner, rounds: int, groups: int = 3) -> list:
    times = []
    for _ in range(groups):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        _replay(runner, rounds)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / rounds)
    return times


def profile(run, record: dict, *, log=print) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    per_round_s = statistics.median(record["study_s"]) / record["steps"]
    runners = [r for r in run.runners() if r.graph is not None]
    per_runner_s = per_round_s / max(1, len(runners))
    out, ops_all = [], {}
    for r in runners:
        nodes = int(r.graph.kernel_nodes)
        cap = r.chunk
        g = max(1, min(cap, round(EVENT_GROUP_S / per_runner_s)))
        ev = _event_ms(torch, r, g)
        p = max(1, min(cap, MAX_TRACED_OPS // max(1, nodes), round(PROFILE_S / per_runner_s)))
        for _ in range(PROFILE_TRIES):  # the profiler can drop records: take a whole window
            torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                _replay(r, p)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            events = list(prof.events())
            dev = [(e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.device_type == DeviceType.CUDA]
            if len(dev) >= p * nodes:
                break
        cpu = [(e.time_range.start, e.time_range.end, e.name) for e in events
               if e.device_type == DeviceType.CPU]
        launches = [(s, e, (e - s) / 1e3) for s, e, name in cpu if name == "cudaGraphLaunch"]
        ops = {}
        for s, e, name in dev:
            name = name[:160]
            ops[name] = ops.get(name, 0.0) + (e - s) / 1e6
            ops_all[name] = ops_all.get(name, 0.0) + (e - s) / 1e6
        wr = sum(v for k, v in ops.items() if any(w in k for w in WHOLE_ROUND_KERNELS))
        info = dict(
            rows=int(r.batch), algorithm=r.setup.pcfg.algorithm, event_rounds=g,
            event_ms_per_round=statistics.median(ev), event_groups_ms=ev, profiled_rounds=p,
            device_ops=len(dev), profiled_wall_s=wall,
            busy_s=sum(e - s for s, e in _union([(s, e) for s, e, _ in dev])) / 1e6,
            launch_ms=[d for _, _, d in launches],
            whole_round_s=wr, graph_kernel_nodes=nodes,
        )
        log(f"[simbench] traced runner {info['algorithm']} x {info['rows']}: device "
            f"{info['event_ms_per_round']:.4f} ms a round by events over {g} rounds; "
            f"profiled {p} rounds: {len(dev)} device ops ({len(dev) / p:.1f} a round, "
            f"{nodes} graph nodes), busy {info['busy_s'] * 1e3:.3f} ms of {wall * 1e3:.3f} ms "
            f"({info['busy_s'] / p * 1e3:.4f} ms a round); graph launches on the host under "
            f"the profiler {', '.join(f'{x:.3f}' for x in info['launch_ms'][:4])} ... ms")
        out.append(info)
    top = sorted(ops_all.items(), key=lambda kv: -kv[1])[:10]
    return dict(runners=out, device_ops=[[k, v] for k, v in top])


class ReplayClock:
    """CUDA events around every replay of a captured round while it is
    entered (``Captured.replay`` wrapped), and at the window's start and
    end; ``study`` names the study that runs (set by the window)."""

    def __init__(self):
        import torch

        self.torch, self.study, self.marks = torch, 0, []
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)

    def __enter__(self):
        from repro_torch.kernels import capture

        self._capture, self._orig = capture, capture.Captured.replay
        clock, orig, torch = self, self._orig, self.torch

        def replay(graph, times=1):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            orig(graph, times)
            b.record()
            clock.marks.append((id(graph), clock.study, a, b, times))

        capture.Captured.replay = replay
        self.start.record()
        return self

    def __exit__(self, *exc):
        self.end.record()
        self._capture.Captured.replay = self._orig
        return False

    def read(self) -> dict:
        """Busy and window seconds, each gap's seconds by what the host
        does there, and each replay's ms a round."""
        self.end.synchronize()
        busy = sum(a.elapsed_time(b) for _, _, a, b, _ in self.marks) / 1e3
        gaps = {}

        def add(label, ms):
            gaps[label] = gaps.get(label, 0.0) + max(ms, 0.0) / 1e3

        prev = None
        for m in self.marks:
            if prev is None:
                add("host: the first study's set-up (make_setup, init_state, copies in)",
                    self.start.elapsed_time(m[2]))
            elif prev[1] != m[1]:
                add("host: a study's end (synchronize) and the next one's set-up",
                    prev[3].elapsed_time(m[2]))
            elif prev[0] != m[0]:
                add("host: the next group's set-up (make_setup, init_state, copies in)",
                    prev[3].elapsed_time(m[2]))
            else:
                add("host: the runner's chunk copies between replays", prev[3].elapsed_time(m[2]))
            prev = m
        if prev is not None:
            add("host: the last study's end (outputs, state clone, synchronize)",
                prev[3].elapsed_time(self.end))
        window = self.start.elapsed_time(self.end) / 1e3
        return dict(busy_s=busy, window_s=window,
                    idle_gaps=sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1]),
                    replay_ms=[round(a.elapsed_time(b) / n, 4) for _, _, a, b, n in self.marks])
