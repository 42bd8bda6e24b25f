"""Shared machinery of the paper-figure drivers (counterpart of the
reference's ``benchmarks/common.py``).

Every figure is a scenario sweep: its curves are (protocol, failure)
regimes run over a seed ensemble. :func:`run_sweep_cases` hands a
figure's curve set to one ``repro_torch.api.Experiment`` (one batch per
static group); :func:`run_case` runs one ensemble (per-graph cases). Each
result reports the wall time per simulated (scenario x step x seed) and
the paper's qualitative metrics: stability (mean |Z_t - Z_0|), reaction
time to each burst, overshoot and survival rate.

Reduced mode (the default): 4500 steps, 8 seeds, bursts at 1500 / 3000,
decisions from step 800. Paper mode (``BENCH_FULL=1``): 9000 steps, 50
seeds, bursts at 2000 / 6000, decisions from step 1000, as in Figs. 1-3.

The drivers run on ``cuda`` unless given ``device=``; their protocol
configs take ``estimator_impl="auto"``, the node-sum family of the
port's kernels (the DecAFork groups run the whole_round kernel, unfused
groups the round_update kernel), where the reference's scripts leave the
default. Results go to ``--out`` (``figures_out/`` by default).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import time

import numpy as np

from repro_torch.api import Experiment
from repro_torch.core import FailureConfig, ProtocolConfig
from repro_torch.graphs import make_graph
from repro_torch.sweep import Scenario

FULL = os.environ.get("BENCH_FULL", "0") == "1"

# canonical synchronous-rounds parameters
Z0 = 10
EPS_DECAFORK = 2.0
EPS_DFKP = 3.0
EPS2_DFKP = 7.57  # design_eps2(10, 1e-3)
EPS_MP = 400.0
MAX_WALKS = 64

STEPS = 9000 if FULL else 4500
SEEDS = 50 if FULL else 8
BURSTS = (2000, 6000) if FULL else (1500, 3000)
BURST_SIZES = (5, 6)
PROTO_START = 1000 if FULL else 800

# the estimator family the port's round kernels compute
ESTIMATOR_IMPL = "auto"
# the threefry bit layout the drivers draw with (jax >= 0.5's default)
PARTITIONABLE = True
OUT_DIR = "figures_out"


def pcfg_for(alg: str, proto_start: int = PROTO_START, **overrides) -> ProtocolConfig:
    base = dict(z0=Z0, max_walks=MAX_WALKS, protocol_start=proto_start, rt_bins=1024,
                estimator_impl=ESTIMATOR_IMPL)
    if alg == "decafork":
        base.update(eps=EPS_DECAFORK)
    elif alg == "decafork+":
        base.update(eps=EPS_DFKP, eps2=EPS2_DFKP)
    elif alg == "missingperson":
        base.update(eps_mp=EPS_MP)
    base.update(overrides)
    return ProtocolConfig(algorithm=alg, **base)


def burst_failures(bursts=BURSTS, **overrides) -> FailureConfig:
    base = dict(burst_times=tuple(bursts), burst_sizes=BURST_SIZES)
    base.update(overrides)
    return FailureConfig(**base)


def scenario(name: str, alg: str, fcfg: FailureConfig, proto_start: int = PROTO_START,
             **overrides) -> Scenario:
    """Figure-curve shorthand: a named scenario from the canonical configs."""
    return Scenario(name, pcfg_for(alg, proto_start, **overrides), fcfg)


def default_graph(n: int = 100, seed: int = 0):
    return make_graph("regular", n, seed=seed, degree=8)


@dataclasses.dataclass
class EnsembleResult:
    """One curve: its Z_t (seeds, steps), wall microseconds per (step x
    seed), fork and termination totals, and the setting its metrics read
    (the figure's decisions' start, bursts and steps)."""

    name: str
    z: np.ndarray
    us_per_call: float
    forks: int
    terms: int
    proto_start: int = PROTO_START
    bursts: tuple = BURSTS
    steps: int = STEPS

    def metrics(self, z0: int = Z0, bursts=None) -> dict:
        z = self.z
        post = z[:, self.proto_start:]
        m = {
            "mean_z": float(post.mean()),
            "mean_abs_dev": float(np.abs(post - z0).mean()),
            "max_z": int(z.max()),
            "min_z_post": int(post.min()),
            "survival_rate": float((z > 0).all(1).mean()),
        }
        reacts = []
        for bt in self.bursts if bursts is None else bursts:
            per_seed = []
            for s in range(z.shape[0]):
                hits = np.nonzero(z[s, bt + 1:] >= z0)[0]
                per_seed.append(int(hits[0]) if hits.size else self.steps)
            reacts.append(float(np.median(per_seed)))
        m["reaction_median"] = reacts
        m["overshoot"] = int(z.max() - z0)
        return m

    def csv_row(self) -> str:
        m = self.metrics()
        derived = (
            f"meanZ={m['mean_z']:.1f}|dev={m['mean_abs_dev']:.2f}"
            f"|react={'/'.join(str(int(r)) for r in m['reaction_median'])}"
            f"|overshoot={m['overshoot']}|surv={m['survival_rate']:.2f}"
        )
        return f"{self.name},{self.us_per_call:.2f},{derived}"


def _result(name, z, outs, us, setting: dict) -> EnsembleResult:
    return EnsembleResult(name=name, z=z, us_per_call=us, forks=int(outs.forks.sum()),
                          terms=int(outs.terms.sum()), **setting)


def run_case(name: str, graph, pcfg: ProtocolConfig, fcfg: FailureConfig, steps: int = STEPS,
             seeds: int = SEEDS, *, device=None, proto_start=PROTO_START,
             bursts=BURSTS) -> EnsembleResult:
    """One ensemble (``Experiment.ensemble``); ``proto_start`` and
    ``bursts`` are the figure's, which its metrics read."""
    t0 = time.time()
    outs = Experiment(graph=graph, protocol=pcfg, failures=fcfg, steps=steps, device=device,
                      partitionable=PARTITIONABLE).ensemble(seeds)
    z = outs.z.cpu().numpy()  # blocks until done
    wall = time.time() - t0
    return _result(name, z, outs, wall * 1e6 / (steps * seeds),
                   dict(proto_start=proto_start, bursts=tuple(bursts), steps=steps))


def run_sweep_cases(graph, scenarios: list, steps: int = STEPS, seeds: int = SEEDS, *,
                    device=None, proto_start=PROTO_START, bursts=BURSTS) -> list:
    """A figure's whole curve set as one sweep (one batch per static
    group); ``us_per_call`` is the wall time per (scenario x step x
    seed) over the whole sweep."""
    t0 = time.time()
    res = Experiment(graph=graph, scenarios=scenarios, steps=steps, device=device,
                     partitionable=PARTITIONABLE).sweep(seeds=seeds)
    zs = [o.z.cpu().numpy() for o in res.outputs]  # blocks until done
    wall = time.time() - t0
    us = wall * 1e6 / (steps * seeds * len(scenarios))
    setting = dict(proto_start=proto_start, bursts=tuple(bursts), steps=steps)
    return [_result(name, z, o, us, setting) for name, z, o in zip(res.names, zs, res.outputs)]


def machine_metadata() -> dict:
    """The environment stamped into every result file: torch, CUDA, the
    device's name, and nvidia-smi's name and power limit where a card is
    present (numbers from different cards or power limits do not
    compare)."""
    import platform as _platform

    import torch

    meta = {
        "machine": _platform.node(),
        "platform": _platform.platform(),
        "cpu_count": os.cpu_count(),
        "python": _platform.python_version(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device_name": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu",
        "device_count": torch.cuda.device_count(),
        "nvidia_smi": None,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
    }
    if torch.cuda.is_available():
        try:
            meta["nvidia_smi"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=30, check=True).stdout.strip()
        except (OSError, subprocess.SubprocessError):
            pass
    return meta


def save_result(bench: str, rows: list, extra: dict | None = None, out: str | None = None,
                full: bool = FULL) -> str:
    """Write ``<out>/<bench>.json`` (``figures_out/`` by default) with the
    rows, the mode and :func:`machine_metadata`; returns its path."""
    out = out or OUT_DIR
    os.makedirs(out, exist_ok=True)
    payload = {"bench": bench, "full": full, "rows": rows, "meta": machine_metadata()}
    if extra:
        payload.update(extra)
    path = os.path.join(out, f"{bench}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, default=float)
    return path


def run_figure(bench: str, groups, *, steps: int, seeds: int, device=None,
               proto_start=PROTO_START, bursts=BURSTS, batched: bool = True,
               verbose: bool = True, out=None):
    """Run a figure's ``groups`` (``[(graph, [Scenario, ...])]``): each
    group as one sweep (``batched``) or each scenario as its own
    ensemble; print each curve's CSV row when ``verbose``, write the rows
    (name, us_per_call, the metrics, forks, terms) and return them."""
    rows = []
    for graph, scen in groups:
        kw = dict(device=device, proto_start=proto_start, bursts=bursts)
        if batched:
            results = run_sweep_cases(graph, scen, steps, seeds, **kw)
        else:
            results = [run_case(s.name, graph, s.pcfg, s.fcfg, steps, seeds, **kw)
                       for s in scen]
        for r in results:
            rows.append({"name": r.name, "us_per_call": r.us_per_call, **r.metrics(),
                         "forks": r.forks, "terms": r.terms})
            if verbose:
                print(r.csv_row(), flush=True)
    save_result(bench, rows, out=out)
    return rows
