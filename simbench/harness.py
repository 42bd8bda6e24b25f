"""One run of one benchmark cell of ``repro_torch``, driven by data.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``:
the graph, the protocol, the failures, the rounds of a study) and a
traffic mix (``traffic/<name>.json``: the scenarios of a study, the seeds
of each, the outputs recorded, the rows compared). Its metrics are
readers, ``metrics/<name>.py``, of the run's record. Nothing here names a
cell.

A run: set-up (the graph from its seed, the Experiment, one whole study
that captures every runner the cell uses); the window (whole studies back
to back through ``Plan.sweep_group``, each from the key of ``(seed, i)``,
until the next would end past ``--seconds``); with ``--trace 1`` the
captured rounds replayed under CUDA events and the profiler; then the
comparison of the last study with the plain reference
(``reference/``), on rows drawn from the seed.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

import numpy as np

from simbench import graphs
from simbench.reference import compare
from simbench.reference import threefry as tf

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARMUP_STUDY = 0xFFFFFFFF  # the set-up study's index: the window's run from 0


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    chips: int = 1


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root.parent / "BENCHMARK.json").read_text())
    (w,) = [w for w in bench["workloads"] if w["name"] == workload] or [None]
    if w is None:
        raise SystemExit(f"simbench: no workload {workload!r} in BENCHMARK.json")

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return Cell(
        name=workload,
        config=json.loads((root / "configs" / f"{w['config']}.json").read_text()),
        traffic=json.loads((root / "traffic" / f"{w['traffic']}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if mine(m)],
        per_layer=[m for m in bench["per_layer"] if mine(m)],
        chips=int(w["chips"]),
    )


def study_key(seed: int, i: int) -> np.ndarray:
    """The base key of study ``i`` of a run: ``fold_in(key(seed), i)``."""
    return tf.fold_in(tf.key(seed), i)


def scenario_params(config: dict, traffic: dict) -> list:
    """``[(name, protocol fields, failure fields)]`` of the traffic's
    scenarios: the configuration's protocol, its algorithm's defaults,
    then the scenario's own fields."""
    out = []
    for s in traffic["scenarios"]:
        s = dict(s)
        name, alg = s.pop("name"), s.pop("algorithm")
        proto = {**config["protocol"], **config["algorithms"][alg], **s, "algorithm": alg}
        out.append((name, proto, dict(config["failures"])))
    return out


# the fields the reference models; a cell that sets another is refused
# rather than compared with a reference that ignores it
REFERENCE_PROTOCOL = {"algorithm", "z0", "max_walks", "rt_bins", "protocol_start", "eps", "eps2",
                      "eps_mp", "fork_prob", "estimator_impl", "round_impl"}
REFERENCE_FAILURES = {"burst_times", "burst_sizes", "p_fail", "p_fail_start", "p_node_fail",
                      "p_node_recover", "node_fail_start", "p_link_fail", "p_link_recover",
                      "link_fail_start"}
NODE_SUM_ESTIMATORS = ("auto", "fused", "compare", "pallas")


def reference_rows(params: list, seeds: int) -> dict:
    """The reference's per-row parameters of a group, scenario-major."""
    for _, p, fl in params:
        extra = (set(p) - REFERENCE_PROTOCOL) | (set(fl) - REFERENCE_FAILURES)
        if extra or p.get("estimator_impl", "auto") not in NODE_SUM_ESTIMATORS:
            raise ValueError(f"the reference does not model {sorted(extra) or p['estimator_impl']}")
    def col(f, default):
        return np.array([f(p, fl, default) for _, p, fl in params for _ in range(seeds)])

    def proto(key, default):
        return col(lambda p, fl, d: p.get(key, d), default)

    def fail(key, default):
        return col(lambda p, fl, d: fl.get(key, d), default)

    R = len(params) * seeds
    K = max(len(fl.get("burst_times", ())) for _, _, fl in params)

    def sched(key, fill):
        return np.array([list(fl.get(key, ())) + [fill] * (K - len(fl.get(key, ())))
                         for _, _, fl in params for _ in range(seeds)], dtype=np.int64).reshape(R, K)

    z0 = proto("z0", 10)
    return dict(
        z0=z0, eps=proto("eps", 2.0), eps2=proto("eps2", 5.75), eps_mp=proto("eps_mp", 300.0),
        p=np.array([1.0 / z if f is None else f for z, f in zip(z0, proto("fork_prob", None))]),
        protocol_start=proto("protocol_start", 0),
        burst_times=sched("burst_times", -1), burst_sizes=sched("burst_sizes", 0),
        p_fail=fail("p_fail", 0.0), p_fail_start=fail("p_fail_start", 0),
        p_node_fail=fail("p_node_fail", 0.0), p_node_recover=fail("p_node_recover", 0.0),
        node_fail_start=fail("node_fail_start", 0), p_link_fail=fail("p_link_fail", 0.0),
        p_link_recover=fail("p_link_recover", 0.0), link_fail_start=fail("link_fail_start", 0),
    )


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc!r}"


class Run:
    """The system under test at one cell's sizes on one device."""

    def __init__(self, cell: Cell, device: str):
        import torch

        from repro_torch.api import Experiment
        from repro_torch.core import FailureConfig, ProtocolConfig
        from repro_torch.graphs import Graph
        from repro_torch.sweep import Scenario

        self.torch, self.device, self.cell = torch, device, cell
        cfg, tr = cell.config, cell.traffic
        self.nbrs, self.degs, self.mirror = graphs.make(cfg["graph"])
        graph = Graph(n=int(self.nbrs.shape[0]), neighbors=self.nbrs, degrees=self.degs,
                      family=cfg["graph"]["family"])
        self.params = scenario_params(cfg, tr)
        scen = [Scenario(name, ProtocolConfig(**p), FailureConfig(**{
            k: tuple(v) if isinstance(v, list) else v for k, v in f.items()}))
            for name, p, f in self.params]
        self.seeds, self.steps = int(tr["seeds"]), int(cfg["steps"])
        self.plan = Experiment(graph=graph, scenarios=scen, steps=self.steps,
                               outputs=tr.get("outputs", "scalars"), device=device,
                               partitionable=True).plan()
        self.groups = [idxs for _, idxs in self.plan.groups(scen)]
        self.scenarios = scen
        self.rows = len(scen) * self.seeds

    def study(self, key: np.ndarray) -> list:
        """One study: every group of the traffic through ``sweep_group``
        from the base key ``key``; ``[(final state, outputs)]``."""
        torch = self.torch
        base = torch.as_tensor(key.astype(np.int64), device=self.device)
        out = [self.plan.sweep_group([self.scenarios[i] for i in idxs], seeds=self.seeds,
                                     base_key=base) for idxs in self.groups]
        if self.device != "cpu":
            torch.cuda.synchronize()
        return out

    def runners(self) -> list:
        from repro_torch.api import plan as plan_mod

        return list(plan_mod._EXECUTABLES.values())


def window(run: Run, seed: int, seconds: float, clock=None):
    """Whole studies back to back until the next one would end past
    ``seconds``; returns ``(last study's result, its index, studies,
    window seconds, each study's seconds)``. ``clock``
    (``tracing.ReplayClock``) is told which study runs."""
    times, last, i = [], None, 0
    t0 = time.perf_counter()
    while True:
        last = None  # only one study's outputs are held at a time
        if clock is not None:
            clock.study = i
        ts = time.perf_counter()
        last = run.study(study_key(seed, i))
        now = time.perf_counter()
        times.append(now - ts)
        i += 1
        if now - t0 + statistics.median(times) > seconds:
            return last, i - 1, i, now - t0, times


SETTLE_GROUP_S = 0.25  # device seconds a settling group replays
SETTLE_TOLERANCE = 0.01
SETTLE_LIMIT_S = 20.0


def settle(run: Run, log) -> list:
    """Replay each runner's captured round in groups of about
    ``SETTLE_GROUP_S`` until two successive groups' device times (CUDA
    events) agree within ``SETTLE_TOLERANCE``: a card can run the same
    round about a quarter slower for its first seconds of work in a
    process, and that would otherwise fall into the window's first
    study. Replays run on the runner's own buffers; a study copies its
    inputs in afresh. Returns each runner's group times (ms a round)."""
    import torch

    out = []
    t0 = time.perf_counter()
    for r in run.runners():
        if r.graph is None:
            continue
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        rounds, times = 1, []
        while True:
            a.record()
            r.column.zero_()
            r.graph.replay(rounds)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / rounds)
            if len(times) == 1:  # size the groups from the first round
                rounds = max(1, min(r.chunk, round(SETTLE_GROUP_S * 1e3 / times[0])))
                continue
            if (abs(times[-1] / times[-2] - 1) <= SETTLE_TOLERANCE and len(times) > 2
                    or time.perf_counter() - t0 > SETTLE_LIMIT_S):
                break
        out.append(times)
        log(f"[simbench] settled {r.setup.pcfg.algorithm} x {r.batch}: "
            f"{', '.join(f'{x:.4f}' for x in times)} ms a round")
    return out


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def sampled_rows(seed: int, group_rows: int, k: int) -> np.ndarray:
    """The rows of a group compared with the reference, drawn from the seed."""
    rng = np.random.default_rng(seed % 2**63)
    return np.sort(rng.choice(group_rows, size=min(k, group_rows), replace=False))


def program_rows(result, rows: np.ndarray) -> tuple:
    """The compared rows of one group's ``(final state, outputs)`` as numpy."""
    final, rec = result

    def take(x):
        return x[rows].cpu().numpy()

    outs = {f: take(getattr(rec, f)) for f in rec._fields}
    state = dict(t=take(final.t), pos=take(final.walks.pos), active=take(final.walks.active),
                 track=take(final.walks.track), last_seen=take(final.last_seen),
                 hist=take(final.rts.hist), total=take(final.rts.total), key=take(final.key),
                 node_up=take(final.graph.node_up), edge_up=take(final.graph.edge_up))
    return outs, state


def reference_jobs(run: Run, key: np.ndarray, seed: int, rows_per_group: int, chunk: int) -> list:
    """The reference's work for the last study: one job per chunk of the
    compared rows of each group: ``(group, rows, kwargs of simulate)``."""
    base_keys = tf.split(key, run.seeds)
    jobs = []
    for g, idxs in enumerate(run.groups):
        params = [run.params[i] for i in idxs]
        rows_all = reference_rows(params, run.seeds)
        rows = sampled_rows(seed + g, len(idxs) * run.seeds, rows_per_group)
        for c in range(0, len(rows), chunk):
            r = rows[c:c + chunk]
            jobs.append((g, r, dict(
                graph=dict(neighbors=run.nbrs, degrees=run.degs, mirror=run.mirror),
                algorithm=params[0][1]["algorithm"], W=int(params[0][1]["max_walks"]),
                B=int(params[0][1]["rt_bins"]), rows={k: v[r] for k, v in rows_all.items()},
                keys=base_keys[r % run.seeds], steps=run.steps)))
    return jobs


def _simulate(kw):
    from simbench.reference.simulate import simulate

    return simulate(**kw)


def run_reference(jobs: list, topo_device: str, workers: int) -> list:
    """Each job's ``(outputs, final)``: node- and edge-sized topology on
    ``topo_device`` in this process; otherwise in ``workers`` spawned
    processes (numpy, one job each at a time)."""
    churn = any(np.any(kw["rows"]["p_node_fail"] > 0) or np.any(kw["rows"]["p_link_fail"] > 0)
                for _, _, kw in jobs)
    if churn or workers <= 1:
        from simbench.reference.simulate import simulate

        return [simulate(**kw, topo_device=topo_device) for _, _, kw in jobs]
    with ProcessPoolExecutor(min(workers, len(jobs)), mp_context=get_context("spawn")) as pool:
        return list(pool.map(_simulate, [kw for _, _, kw in jobs]))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t_start: float,
             *, log=print) -> dict:
    """One run; returns the record the metrics read, with the comparison."""
    import torch

    cuda = device != "cpu"
    run = Run(cell, device)
    run.study(study_key(seed, WARMUP_STUDY))  # captures every runner of the cell
    settled = settle(run, log) if cuda else []
    setup_s = time.perf_counter() - t_start
    smi_start = nvidia_smi() if cuda else "cpu"
    log(f"[simbench] window start: {smi_start}")
    if trace and cuda:
        from simbench import tracing

        with tracing.ReplayClock() as clock:
            last, last_i, studies, window_s, times = window(run, seed, seconds, clock)
    else:
        last, last_i, studies, window_s, times = window(run, seed, seconds)
    smi_end = nvidia_smi() if cuda else "cpu"
    log(f"[simbench] window end: {smi_end}")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    bad = forbidden_modules()
    for r in runner_info(run):
        log(f"[simbench] runner {r['algorithm']} x {r['rows']}: fused {r['fused']}, "
            f"{r['kernel_nodes']} graph nodes, the port's kernels a round {r['per_replay']}, "
            f"capture {r['capture_s']} s")
    record = dict(
        cell=cell.name, device=device, setup_s=setup_s, window_s=window_s, studies=studies,
        study_s=times, rows=run.rows, steps=run.steps, n=int(run.nbrs.shape[0]),
        peak_bytes=int(peak), forbidden=bad, smi=(smi_start, smi_end),
        shape=shape_of(cell.config), runners=runner_info(run), trace=None, settled=settled,
    )
    if trace and cuda:
        record["trace"] = dict(clock.read(), **tracing.profile(run, record, log=log))
        log(f"[simbench] window's replays, ms a round: {record['trace']['replay_ms']}")
    # the comparison: the program's compared rows, then its state freed
    tr = cell.traffic
    jobs = reference_jobs(run, study_key(seed, last_i), seed, int(tr["compare_rows"]),
                          int(tr.get("compare_chunk", tr["compare_rows"])))
    got = [program_rows(last[g], rows) for g, rows, _ in jobs]
    del last
    run.plan = None
    from repro_torch.api import plan as plan_mod

    plan_mod.clear_cache()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want = run_reference(jobs, device, int(tr.get("compare_workers", 1)))
    record["reference_s"] = time.perf_counter() - t_ref
    record["compared"] = compare.compare(got, want)
    record["compared_rows"] = sum(len(r) for _, r, _ in jobs)
    return record


def shape_of(config: dict) -> dict:
    p, g = config["protocol"], config["graph"]
    return dict(n=int(g["n"]), degree=int(g["degree"]), max_walks=int(p["max_walks"]),
                rt_bins=int(p["rt_bins"]), z0=int(p["z0"]),
                bursts=len(config["failures"].get("burst_times", ())))


def runner_info(run: Run) -> list:
    """What each runner of the cell reports: its rows, the algorithm, the
    capture's seconds, the captured round's kernel nodes and each
    kernel wrapper's nodes in it."""
    out = []
    for r in run.runners():
        g = r.graph
        out.append(dict(
            rows=int(r.batch), algorithm=r.setup.pcfg.algorithm, fused=bool(r.decision.fused),
            capture_s=r.capture_s, kernel_nodes=None if g is None else int(g.kernel_nodes),
            per_replay={} if g is None else {k.__name__: int(v) for k, v in g.per_replay.items()},
        ))
    return out
