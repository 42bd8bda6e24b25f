"""Fig. 8 (beyond the paper): learning under failure, as one batched
sweep (counterpart of the reference's ``benchmarks/fig8_learning.py``).

The walks carry a workload, decentralized RW-SGD learning, so the figure
that matters is the *loss* under failure: one ``RwSgdPayload`` rides
``Experiment.sweep``, every (protocol x failure regime x seed)
trajectory trains its own replica set inside the captured round, and the
loss curves come back batched.

Grid: {decafork, decafork+, none} x {burst, Pac-Man absorption, node
churn}, one sweep group per protocol, every failure regime a scenario row
inside it. The ``none`` rows show what failure does to unregulated
RW-SGD (walks die, replicas stop training, the curve flatlines); the
DecAFork rows keep learning.

Writes ``<out>/fig8_learning.json``: per-scenario loss and Z curves
(downsampled), pre- and post-failure loss means, live replicas at the
end, survival, and the count of new executable-cache slots (one per
protocol group; the reference counts XLA compiles there).
"""
from __future__ import annotations

import numpy as np

from repro_torch.api import Experiment, cache_stats
from repro_torch.configs import get_smoke_config
from repro_torch.core import FailureConfig, ProtocolConfig
from repro_torch.data import make_markov_task
from repro_torch.figures.common import ESTIMATOR_IMPL, FULL, PARTITIONABLE, save_result
from repro_torch.graphs import make_graph
from repro_torch.models.model import Model
from repro_torch.optim import RwSgdPayload, adamw
from repro_torch.sweep import Scenario
from repro_torch.utils.device import resolve_device

STEPS = 900 if FULL else 300
SEEDS = 4 if FULL else 2
Z0, MAX_WALKS = 5, 12
ALGS = ("decafork", "decafork+", "none")


def _pcfg(alg: str, proto_start: int) -> ProtocolConfig:
    return ProtocolConfig(
        algorithm=alg, z0=Z0, max_walks=MAX_WALKS, eps=1.6, eps2=8.0,
        protocol_start=proto_start, rt_bins=256, estimator_impl=ESTIMATOR_IMPL,
    )


def failure_regimes(fail_at: int) -> list:
    """``(tag, FailureConfig)`` rows, the figure's three failure axes."""
    return [
        ("burst", FailureConfig(burst_times=(fail_at,), burst_sizes=(3,))),
        ("pacman", FailureConfig(pacman_node=0, pacman_start_time=fail_at)),
        ("churn", FailureConfig(p_node_fail=1e-3, p_node_recover=0.05,
                                node_fail_start=fail_at)),
    ]


def scenarios(*, steps=None, proto_start=None, fail_at=None):
    """``[(graph, [Scenario, ...])]``: the figure's grid; the decisions
    start a third of the way in and the failures strike half way, as in
    the reference script, unless given."""
    steps = STEPS if steps is None else steps
    proto_start = steps // 3 if proto_start is None else proto_start
    fail_at = steps // 2 if fail_at is None else fail_at
    return [(make_graph("regular", 48, seed=0, degree=6), [
        Scenario(f"fig8/{alg}/{tag}", _pcfg(alg, proto_start), fcfg)
        for alg in ALGS for tag, fcfg in failure_regimes(fail_at)
    ])]


def build_payload(device=None) -> RwSgdPayload:
    """The reference script's payload: a 1-layer d 64 model, vocabulary
    256, trained by ``adamw(5e-3)`` on a rank-4 chain; local batch 2 x
    16 tokens."""
    cfg = get_smoke_config("paper_rwsgd", num_layers=1, d_model=64, d_ff=128, vocab_size=256,
                           num_heads=2, num_kv_heads=2)
    task = make_markov_task(cfg.vocab_size, rank=4, temperature=2.5,
                            partitionable=PARTITIONABLE, device=device)
    return RwSgdPayload(Model(cfg), adamw(5e-3), task, max_walks=MAX_WALKS,
                        local_batch=2, seq_len=16)


def _downsample(curve: np.ndarray, points: int = 100) -> list:
    idx = np.linspace(0, curve.shape[0] - 1, min(points, curve.shape[0]))
    # JSON-safe: rounds where no replica trained are null, not a number
    return [None if np.isnan(v) else float(v) for v in curve[idx.astype(int)]]


def _masked_mean(x: np.ndarray):
    """Mean over the finite entries; None when every entry is masked."""
    x = x[np.isfinite(x)]
    return float(x.mean()) if x.size else None


def row(name: str, z, trained, mean_loss, fail_at: int) -> dict:
    """One scenario's row from its (seeds, T) ``z``, ``trained`` and
    ``mean_loss``, as the reference script computes it."""
    # a round where no replica trained has no loss (its 0.0 is a
    # placeholder): an absorbed population reads as a dead curve
    loss = np.where(trained > 0, mean_loss, np.nan)
    live = np.sum(np.isfinite(loss), axis=0)  # seeds with a loss at t
    mean_curve = np.where(live > 0, np.nansum(loss, axis=0) / np.maximum(live, 1), np.nan)
    return {
        "name": name,
        "loss_curve": _downsample(mean_curve),
        "z_curve": _downsample(z.mean(0)),
        "loss_pre_failure": _masked_mean(loss[:, max(fail_at - 50, 0):fail_at]),
        "loss_final": _masked_mean(loss[:, -50:]),
        "trained_final": float(trained[:, -1].mean()),
        "survival_rate": float((z > 0).all(1).mean()),
    }


def run(verbose=True, *, device=None, out=None, steps=None, seeds=None, proto_start=None,
        fail_at=None):
    """The grid on ``device`` (cuda unless given), ``STEPS`` rounds x
    ``SEEDS`` seeds unless given; ``proto_start`` and ``fail_at`` default
    to a third and a half of the steps."""
    device = resolve_device(device)
    steps = STEPS if steps is None else steps
    seeds = SEEDS if seeds is None else seeds
    fail_at = steps // 2 if fail_at is None else fail_at
    [(graph, scen)] = scenarios(steps=steps, proto_start=proto_start, fail_at=fail_at)
    payload = build_payload(device)
    slots_before = cache_stats()["entries"]
    res = Experiment(graph=graph, scenarios=scen, steps=steps, payload=payload, device=device,
                     partitionable=PARTITIONABLE).sweep(seeds=seeds)
    slots = cache_stats()["entries"] - slots_before

    rows = []
    for name in res.names:
        learn = res.payload(name)
        rows.append(row(name, res[name].z.cpu().numpy(), learn.trained.cpu().numpy(),
                        learn.mean_loss.cpu().numpy(), fail_at))
        if verbose:
            r = rows[-1]
            fmt = lambda v: "dead" if v is None else f"{v:.3f}"
            print(f"{name},loss {fmt(r['loss_pre_failure'])}->{fmt(r['loss_final'])},"
                  f"replicas@end={r['trained_final']:.1f},"
                  f"surv={r['survival_rate']:.2f}", flush=True)
    extra = {
        "steps": steps, "seeds": seeds, "fail_at": fail_at,
        "entropy_floor": payload.task.entropy,
        "new_cache_slots": slots,
        "protocol_groups": len(ALGS),
    }
    if slots > len(ALGS):
        raise AssertionError(f"fig8: {slots} new executable-cache slots for {len(ALGS)} groups")
    save_result("fig8_learning", rows, extra, out=out)
    if verbose:
        print(f"# fig8: {len(scen)} scenarios in {slots} new cache slots "
              f"({len(ALGS)} protocol groups)", flush=True)
    return rows
