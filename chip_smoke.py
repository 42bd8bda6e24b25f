#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py            # the paper-scale run (9000 steps)
    python3 chip_smoke.py --steps N  # a shorter main path (the cut is printed)

Phases, each printed on its own line:

1. device: nvidia-smi's name and power limit, torch's device name, and
   the build of the three kernels from ``src/repro_torch/csrc`` (nvcc,
   sm_90a, one process per source);
2. kernels: each kernel against its plain PyTorch version on the card,
   bitwise, on numpy-seeded inputs at the main path's shapes (batch 50,
   n 100, C = W = 64, B = 1024, D = 8), and round_update / theta_sums
   also at n = 100,000, batch 1; median times by CUDA events, the plain
   version's time and the bytes-moved bound at 3.35 TB/s;
3. main path: the paper's DecAFork and DecAFork+ ensembles (regular
   graph n = 100, d = 8; Z0 = 10, W = 64, B = 1024, 50 seeds, bursts of
   5 and 6 walks at steps 2000 and 6000, decisions from step 1000)
   through ``repro_torch.api.Experiment`` on ``cuda``; the whole_round
   launch count must equal the rounds run, and Z_t must survive near Z0;
   then a 40-round torch.profiler window of the same configuration gives
   the device's busy share and its kernels per round;
4. cross-device parity: 200 rounds, 4 seeds, churny failures, on cuda and
   on the CPU; integer outputs bitwise, theta_mean within 1e-6;
5. unfused paths: ``round_impl="unfused"`` with ``estimator_impl`` =
   ``"fused"`` (round_update) and ``"pallas"`` (theta_sums); their
   integer outputs must equal the fused round's.

Before the last line it prints the card's name and power limit, then one
JSON object with every kernel's launches, error and times; the last line
is ``{"ok": true, "device": {...}}``. Any failed check raises. Without a
CUDA device, or without the repository's ``src/`` beside it, it exits
non-zero and prints no result. Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
OPS_PER_S = 67e12  # H100 SXM float32 / int32 outside the tensor cores
ROOT = os.path.dirname(os.path.abspath(__file__))

PAPER = dict(n=100, degree=8, z0=10, max_walks=64, rt_bins=1024, protocol_start=1000,
             bursts=(2000, 6000), burst_sizes=(5, 6), steps=9000, seeds=50)
ALGS = {"decafork": dict(eps=2.0), "decafork+": dict(eps=3.0, eps2=7.57)}
CHURN = dict(burst_times=(60, 140), burst_sizes=(5, 6), p_fail=0.002,
             byzantine_node=2, p_byz=0.05, byz_start_time=30,
             p_node_fail=0.01, p_node_recover=0.3, node_fail_start=20,
             p_link_fail=0.02, p_link_recover=0.4, link_fail_start=20,
             pacman_node=4, pacman_start_time=100,
             node_crash_times=(50,), node_crash_ids=(3,))
INT_FIELDS = ("z", "forks", "terms", "failures", "fork_parent", "terminated")


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, groups: int = 7) -> float:
    """Median over ``groups`` of the mean time of ``reps`` calls, by CUDA
    events, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    times.sort()
    return times[len(times) // 2]


def max_abs_err(got, want) -> float:
    """Largest absolute difference over a tuple of outputs (0.0 when
    bitwise); raises unless every output is bitwise equal."""
    import torch

    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.cpu(), w.cpu()
        if g.dtype.is_floating_point:
            same = torch.equal(g.view(torch.int32), w.view(torch.int32))
            err = max(err, float((g - w).abs().max()) if g.numel() else 0.0)
        else:
            same = torch.equal(g, w)
        if not same:
            raise AssertionError(f"output {i} differs from the plain version (max |err| {err})")
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def observation_inputs(rng, batch, n, C, B, W, t, dev):
    """A mid-trajectory observation round (as the reference's
    ``random_round_inputs``): counts, last-seen times, walk events."""
    import numpy as np
    import torch

    ls = rng.integers(-1, t, (batch, n, C)).astype(np.int32)
    hist = np.floor(rng.random((batch, n, B)) * 3).astype(np.int16)
    total = hist.sum(axis=2, dtype=np.int32)
    pos = rng.integers(0, n, (batch, W)).astype(np.int32)
    track = np.stack([rng.permutation(C)[:W] for _ in range(batch)]).astype(np.int32)
    active = rng.random((batch, W)) < 0.8
    prev = np.take_along_axis(ls, pos[..., None], 1)[..., 0]
    prev = np.take_along_axis(prev, track, 1)
    r = (t - prev).astype(np.int32)
    valid = active & (prev != -1) & (r >= 1)
    upd = np.where(active, t, -1).astype(np.int32)
    tt = np.full((batch,), t, np.int32)
    to = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    if int(C) * int(total.max()) >= 2**24:
        raise AssertionError("node-sum inputs break the exact-integer condition C * total < 2**24")
    return tuple(to(a) for a in (ls, hist, total, pos, track, r, valid, upd, tt))


def whole_round_inputs(rng, batch, n, C, B, D, W, K, graph, dev):
    """A churny whole round: partial masks, live uniforms, a firing burst."""
    import numpy as np
    import torch

    ls, hist, total, pos, track, _r, _v, _u, tt = observation_inputs(
        rng, batch, n, C, B, W, 70, dev
    )
    to = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    f32 = lambda *s: to(rng.random(s).astype(np.float32))  # noqa: E731
    nbrs = to(graph.neighbors.astype(np.int32))
    degs = to(graph.degrees.astype(np.int32))
    node_up = to(rng.random((batch, n)) < 0.9)
    edge_up = to(rng.random((batch, n, D)) < 0.9)
    active = to(rng.random((batch, W)) < 0.8)
    bsz = to(rng.integers(0, 4, (batch, K)).astype(np.int32))
    sched = to(rng.random((batch, n)) < 0.02)
    params_f = np.tile(np.array([0.05, 0.05, 0.05, 0.3, 0.4, 3.0, 7.57, 0.1], np.float32), (batch, 1))
    params_i = np.tile(np.array([70, 2, 4, 1], np.int32), (batch, 1))
    return (ls, hist, total, node_up, edge_up, pos, track, active, nbrs, degs,
            f32(batch, W), f32(batch, W), f32(batch, W), f32(batch, W),
            f32(batch, K, W), bsz, f32(batch, n), f32(batch, n), sched,
            f32(batch, n, D), f32(batch, n, D), to(params_f), to(params_i))


def obs_bytes(batch, n, C, B, W, sums_rows) -> int:
    """Bytes the observation pass must move: the W walk vectors, and the
    last_seen / hist / total of every row whose node sum it returns, plus
    those sums (float32)."""
    return batch * (W * 4 * 6 + sums_rows * (C * 4 + B * 2 + 4 + 4))


def check_kernels(rng, graph, dev, large_n=100_000):
    import torch

    from repro_torch.kernels import (
        round_update, round_update_plain, theta_sums, theta_sums_plain,
        whole_round, whole_round_plain,
    )

    clone = lambda xs: tuple(x.clone() for x in xs)  # noqa: E731
    cpu = lambda xs: tuple(x.cpu() for x in xs)  # noqa: E731
    rows = []
    batch, n, C, B, D, W, K = 50, 100, 64, 1024, 8, 64, 2

    def entry(name, source, replaces, err, ms, plain_ms, nbytes, nops, shape):
        """The bound is the larger of bytes over HBM bandwidth and simple
        (integer / float32) operations over the non-tensor-core rate."""
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / OPS_PER_S * 1e3
        bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        log("kernels", kernel=name, shape=shape, max_abs_err=err, ms=f"{ms:.6f}",
            plain_ms=f"{plain_ms:.6f}", bound_ms=f"{bound:.6f}", bound_by=by,
            bytes=nbytes, ops=nops)
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                    bound_by=by, library_ms=None, shape=shape, bytes=nbytes, ops=nops)

    for shape in ((batch, n), (1, large_n)):
        bt, nn = shape
        x = observation_inputs(rng, bt, nn, C, B, W, 70, dev)
        ls, hist, total, t = x[0], x[1], x[2], x[8]
        # theta_sums: plain version on the card and on the CPU, kernel
        want = theta_sums_plain(ls, hist, total, t)
        err = max_abs_err((theta_sums(ls, hist, total, t),), (want,))
        if nn == n:  # the CPU's plain version agrees with the card's
            max_abs_err((theta_sums_plain(*cpu((ls, hist, total, t))),), (want,))
        reps = 50 if nn == n else 5
        ms = cuda_ms(lambda: theta_sums(ls, hist, total, t), reps)
        plain_ms = cuda_ms(lambda: theta_sums_plain(ls, hist, total, t), 1, 3)
        ent = entry("theta_sums", "src/repro_torch/csrc/theta_sums.cu",
                    "src/repro/kernels/theta_survival.py:52", err, ms, plain_ms,
                    obs_bytes(bt, nn, C, B, 0, nn), bt * nn * (B + 2 * C), f"batch={bt},n={nn}")
        if nn == n:
            rows.append(ent)
        else:
            rows[0]["large"] = ent
        # round_update: in place, so each version gets its own copy
        got = round_update(*clone(x))
        want = round_update_plain(*clone(x))
        err = max_abs_err(got, want)
        work = clone(x)
        ms = cuda_ms(lambda: round_update(*work), reps)
        plain_ms = cuda_ms(lambda: round_update_plain(*work), 1, 3)
        ent = entry("round_update", "src/repro_torch/csrc/round_update.cu",
                    "src/repro/kernels/round_update.py:163", err, ms, plain_ms,
                    obs_bytes(bt, nn, C, B, W, nn), bt * (nn * (B + 2 * C) + 4 * W),
                    f"batch={bt},n={nn}")
        if nn == n:
            rows.append(ent)
        else:
            rows[1]["large"] = ent

    # whole_round at the main path's shapes, both algorithms
    x = whole_round_inputs(rng, batch, n, C, B, D, W, K, graph, dev)
    for plus in (False, True):
        got = whole_round(*clone(x), decafork_plus=plus)
        want = whole_round_plain(*clone(x), plus)
        err = max_abs_err(got, want)
        max_abs_err(whole_round_plain(*cpu(clone(x)), plus), want)
    work = clone(x)
    ms = cuda_ms(lambda: whole_round(*work, decafork_plus=True), 50)
    plain_ms = cuda_ms(lambda: whole_round_plain(*work, True), 1, 3)
    # bytes: topology tables and uniforms, the walk vectors, and the rows
    # the walks visit (last_seen, hist, total read; outputs written)
    visited = sum(len(set(p.tolist())) for p in x[5].cpu())
    nbytes = (batch * (n * D * (1 + 4 + 4 + 1) + n * (1 + 4 + 4 + 1 + 1))
              + batch * W * (4 * 8 + 4 * K + D * 8)
              + visited * (C * 4 + B * 2 + 4))
    rows.append(entry("whole_round", "src/repro_torch/csrc/whole_round.cu",
                      "src/repro/kernels/round_update.py:442", err, ms, plain_ms,
                      nbytes, batch * (3 * n * D + W * (4 * D + (1 + K) * W + B + 2 * C)),
                      f"batch={batch},n={n}"))
    return rows


# ---------------------------------------------------------------------------
# phases 3-5: the port's entry points
# ---------------------------------------------------------------------------


def experiment(graph, alg, steps, device, *, protocol_start, failures, **pkw):
    from repro_torch.api import Experiment
    from repro_torch.core import FailureConfig, ProtocolConfig

    pcfg = ProtocolConfig(
        algorithm=alg, z0=PAPER["z0"], max_walks=PAPER["max_walks"],
        rt_bins=PAPER["rt_bins"], protocol_start=protocol_start, **ALGS[alg], **pkw,
    )
    return Experiment(graph=graph, protocol=pcfg, failures=FailureConfig(**failures),
                      steps=steps, outputs="full", device=device)


def main_experiment(graph, alg, steps):
    """The paper's configuration of Figs. 1-3 on the card."""
    return experiment(graph, alg, steps, "cuda", protocol_start=PAPER["protocol_start"],
                      failures=dict(burst_times=PAPER["bursts"],
                                    burst_sizes=PAPER["burst_sizes"]),
                      estimator_impl="auto", round_impl="auto")


def main_path(graph, steps, seeds, kernel_ms):
    import numpy as np
    import torch

    from repro_torch.kernels import whole_round

    res = {}
    for alg in ALGS:
        exp = main_experiment(graph, alg, steps)
        (_, _, decision), = exp.plan().round_decisions()
        if not decision.fused:
            raise AssertionError(f"the main path did not fuse: {decision.reason}")
        torch.cuda.synchronize()
        before = whole_round.launches
        t0 = time.perf_counter()
        outs = exp.ensemble(seeds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = whole_round.launches - before
        if launches != steps:
            raise AssertionError(f"whole_round launched {launches} times for {steps} rounds")
        z = outs.z.cpu().numpy()
        if z.shape != (seeds, steps):
            raise AssertionError(f"z has shape {z.shape}")
        start = min(PAPER["protocol_start"], steps - 1)
        post = z[:, start:]
        alive = float((z > 0).all(axis=1).mean())
        mean_z = float(post.mean())
        if alive < 1.0 or not PAPER["z0"] / 2 <= mean_z <= 2 * PAPER["z0"]:
            raise AssertionError(f"{alg}: survival {alive}, mean Z after start {mean_z}")
        if not np.isfinite(outs.theta_mean.cpu().numpy()).all():
            raise AssertionError(f"{alg}: non-finite theta_mean")
        ms_round = wall * 1e3 / steps
        share = launches * kernel_ms / (wall * 1e3)
        res[alg] = dict(steps=steps, seeds=seeds, wall_s=wall, ms_per_round=ms_round,
                        trajectory_rounds_per_s=seeds * steps / wall,
                        kernel_share=share, survival=alive, mean_z_after_start=mean_z,
                        max_z=int(z.max()), min_z_after_start=int(post.min()),
                        forks=int(outs.forks.sum()), terms=int(outs.terms.sum()),
                        whole_round_launches=launches)
        log("main", alg=alg, steps=steps, seeds=seeds, wall_s=f"{wall:.3f}",
            ms_per_round=f"{ms_round:.4f}",
            trajectory_rounds_per_s=f"{seeds * steps / wall:.1f}",
            kernel_share=f"{share:.4f}", survival=alive, mean_z=f"{mean_z:.3f}",
            whole_round_launches=launches)
    return res


def profile_rounds(graph, seeds, rounds=40):
    """Device busy share over ``rounds`` rounds of the main path, from
    torch.profiler's CUDA kernel times: all kernels, and whole_round
    alone, over the profiled wall time (the profiler's own overhead
    lengthens the wall, so both shares are lower bounds)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import simulator as sim
    from repro_torch.utils import prng

    res = {}
    for alg in ALGS:
        plan = main_experiment(graph, alg, PAPER["steps"]).plan()
        keys = prng.split(prng.key(0, device="cuda"), seeds)
        setup = plan._setup(seeds)
        state = sim.init_state(keys, setup)
        # a round issues the same operations before and after
        # protocol_start (decisions are masks), so a short warm-up will do
        state, _ = sim.run_rounds(state, setup, 5, decision=plan.decision)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sim.run_rounds(state, setup, rounds, decision=plan.decision)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in events)
        wr = sum(e.self_device_time_total for e in events if "whole_round" in e.key)
        launches = sum(e.count for e in events)
        out = dict(rounds=rounds, wall_ms_per_round=wall_us / rounds / 1e3,
                   device_busy_share=busy / wall_us if busy else None,
                   whole_round_share=wr / wall_us if busy else None,
                   device_kernels_per_round=launches / rounds if busy else None)
        log("profile", alg=alg,
            **{k: ("not measured" if v is None else v) for k, v in out.items()})
        res[alg] = out
    return res


def int_outputs_equal(a, b, label):
    import numpy as np

    for f in INT_FIELDS:
        if not np.array_equal(getattr(a, f).cpu().numpy(), getattr(b, f).cpu().numpy()):
            raise AssertionError(f"{label}: {f} differs")


def cross_device(graph):
    import numpy as np

    steps, seeds = 200, 4
    res = {}
    for alg in ALGS:
        outs = [
            experiment(graph, alg, steps, dev, protocol_start=50, failures=CHURN,
                       estimator_impl="auto").ensemble(seeds)
            for dev in ("cuda", "cpu")
        ]
        int_outputs_equal(outs[0], outs[1], f"cross-device {alg}")
        err = float(np.abs(outs[0].theta_mean.cpu().numpy() - outs[1].theta_mean.numpy()).max())
        np.testing.assert_allclose(outs[0].theta_mean.cpu().numpy(), outs[1].theta_mean.numpy(),
                                   rtol=1e-6, atol=1e-6)
        res[alg] = dict(steps=steps, seeds=seeds, theta_mean_max_abs_err=err,
                        forks=int(outs[1].forks.sum()), terms=int(outs[1].terms.sum()))
        log("parity", alg=alg, steps=steps, seeds=seeds, integers="bitwise",
            theta_mean_max_abs_err=err)
    return res


def unfused_paths(graph, counts):
    import torch

    from repro_torch.kernels import round_update, theta_sums

    steps, seeds = 200, PAPER["seeds"]
    fail = dict(burst_times=(100, 150), burst_sizes=PAPER["burst_sizes"])
    res = {}
    for alg in ALGS:
        kw = dict(protocol_start=50, failures=fail)
        fused = experiment(graph, alg, steps, "cuda", estimator_impl="fused", **kw).ensemble(seeds)
        for eimpl, kern in (("fused", round_update), ("pallas", theta_sums)):
            torch.cuda.synchronize()
            kern.launches = 0
            t0 = time.perf_counter()
            outs = experiment(graph, alg, steps, "cuda", estimator_impl=eimpl,
                              round_impl="unfused", **kw).ensemble(seeds)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if kern.launches != steps:
                raise AssertionError(f"{kern.__name__} launched {kern.launches} times")
            counts[kern.__name__] += kern.launches
            int_outputs_equal(outs, fused, f"unfused {eimpl} {alg}")
            res[f"{alg}/{eimpl}"] = dict(steps=steps, seeds=seeds, wall_s=wall,
                                         ms_per_round=wall * 1e3 / steps)
            log("unfused", alg=alg, estimator_impl=eimpl, steps=steps, seeds=seeds,
                launches=kern.launches, ms_per_round=f"{wall * 1e3 / steps:.4f}",
                integers="equal to the fused round")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=PAPER["steps"],
                    help="main-path rounds (the paper runs 9000)")
    args = ap.parse_args()

    try:
        import numpy as np
        import torch
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.graphs import make_graph
        from repro_torch.kernels import KERNELS, _build
    except ImportError as exc:
        print(f"chip_smoke: the repository's src/repro_torch is missing ({exc})", file=sys.stderr)
        return 1

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    build_s = _build.build_all()
    log("device", nvidia_smi=repr(smi), torch_device=repr(name),
        torch=torch.__version__, cuda=torch.version.cuda, build_s=f"{build_s:.2f}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    rng = np.random.default_rng(0)
    graph = make_graph("regular", PAPER["n"], seed=0, degree=PAPER["degree"])
    rows = check_kernels(rng, graph, "cuda")
    by_name = {r["name"]: r for r in rows}

    if args.steps < PAPER["steps"]:
        log("main", cut=f"steps {args.steps} of the paper's {PAPER['steps']}; n, W, B and seeds uncut")
    for k in KERNELS:  # the main path's counts start here
        k.launches = 0
    main_res = main_path(graph, args.steps, PAPER["seeds"], by_name["whole_round"]["ms"])
    counts = {k.__name__: k.launches for k in KERNELS}
    log("main", launches=counts)
    profile = profile_rounds(graph, PAPER["seeds"])
    parity = cross_device(graph)
    unfused = unfused_paths(graph, counts)

    for r in rows:
        r["launches"] = counts.get(r["name"], 0)
        if r["launches"] == 0:
            raise AssertionError(f"{r['name']} was never launched on its path")
    log("launches", **{k.__name__: counts[k.__name__] for k in KERNELS})

    detail = dict(nvidia_smi=smi, device=name, torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=build_s, kernels=rows,
                  main=main_res, profile=profile, parity=parity, unfused=unfused)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(detail, fh, indent=1)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
