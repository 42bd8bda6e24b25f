"""Fig. 9 (beyond the paper): the zoo, attacks x defenses (counterpart
of the reference's ``benchmarks/fig9_zoo.py``).

Every walk-variant defense against every attack on the two-community
graph whose id boundary is what ``edge_cut`` severs, declared through
the registered ``"zoo"`` experiment (``Experiment.from_config``) and run
as one Plan sweep: one batch per static group (walk variant x attack
statics). ``Plan.round_decisions`` records how each group runs its
rounds, with the reason, in the result file.

Qualitative expectations:

  * ``none``: every defense holds Z near Z0;
  * ``mobile_pacman``: a hopping absorber bleeds walks everywhere; the
    forking has to outpace it;
  * ``multi_pacman``: one absorber per community doubles the drain;
  * ``edge_cut``: the partition strands walks; ``jump`` teleports across
    the cut while ``uniform`` cannot re-mix.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.api import Experiment
from repro_torch.figures import common
from repro_torch.figures.common import (
    EPS2_DFKP, EPS_DFKP, ESTIMATOR_IMPL, FULL, MAX_WALKS, Z0, save_result,
)

N = 64
STEPS = 4500 if FULL else 1200
SEEDS = 16 if FULL else 4
PROTO_START = 1000 if FULL else 200

DEFENSES = ("uniform", "jump", "biased", "bloom")


def attack_time(steps=STEPS, proto_start=PROTO_START) -> int:
    """Every attack strikes a third of the way from the decisions' start
    to the end."""
    return proto_start + (steps - proto_start) // 3


def attacks(attack_at=None, n=N):
    attack_at = attack_time() if attack_at is None else attack_at
    half = n // 2
    return (
        ("none", {}),
        ("mobile_pacman", {"node": 0, "hop_prob": 0.5, "start": attack_at}),
        ("multi_pacman", {"nodes": (0, half), "start": attack_at}),
        ("edge_cut", {"time": attack_at, "threshold": half}),
    )


def experiment(*, device=None, steps=STEPS, proto_start=PROTO_START, attack_at=None,
               n=N) -> Experiment:
    """The grid as one registry-named experiment."""
    return Experiment.from_config({
        "experiment": "zoo",
        "n": n,
        "graph_seed": 0,
        "graph_kwargs": {"k_bridges": 2},
        "steps": steps,
        "protocol": {
            "algorithm": "decafork+", "z0": Z0, "eps": EPS_DFKP, "eps2": EPS2_DFKP,
            "max_walks": MAX_WALKS, "protocol_start": proto_start, "rt_bins": 1024,
            "estimator_impl": ESTIMATOR_IMPL,
        },
        "defenses": DEFENSES,
        "attacks": attacks(attack_at, n),
        "name": "fig9_zoo",
        "device": device,
        "partitionable": common.PARTITIONABLE,
    })


def scenarios(*, proto_start=PROTO_START, attack_at=None, n=N, steps=STEPS, device="cpu"):
    """``[(graph, [Scenario, ...])]``: the grid's one sweep."""
    exp = experiment(device=device, steps=steps, proto_start=proto_start, attack_at=attack_at,
                     n=n)
    return [(exp.graph, list(exp.scenarios))]


def run(verbose=True, *, device=None, out=None, steps=STEPS, seeds=SEEDS,
        proto_start=PROTO_START, attack_at=None, n=N):
    exp = experiment(device=device, steps=steps, proto_start=proto_start, attack_at=attack_at,
                     n=n)
    plan = exp.plan()
    names = [s.name for s in exp.scenarios]
    decisions = [
        {"scenarios": [names[i] for i in idxs], "impl": dec.impl, "backend": dec.backend,
         "reason": dec.reason}
        for _sig, idxs, dec in plan.round_decisions()
    ]
    t0 = time.time()
    res = plan.sweep(seeds=seeds)
    zs = [o.z.cpu().numpy() for o in res.outputs]  # blocks until done
    wall = time.time() - t0
    us = wall * 1e6 / (steps * seeds * len(names))
    rows = []
    for name, z, o in zip(res.names, zs, res.outputs):
        post = z[:, proto_start:]
        row = {
            "name": f"fig9/{name}",
            "us_per_call": us,
            "mean_z_post": float(post.mean()),
            "mean_abs_dev": float(np.abs(post - Z0).mean()),
            "min_z_post": int(post.min()),
            "max_z": int(z.max()),
            "survival_rate": float((z > 0).all(1).mean()),
            "forks": int(o.forks.sum()),
            "terms": int(o.terms.sum()),
        }
        rows.append(row)
        if verbose:
            print(f"fig9/{name},{us:.2f},"
                  f"meanZ={row['mean_z_post']:.1f}|dev={row['mean_abs_dev']:.2f}"
                  f"|minZ={row['min_z_post']}|surv={row['survival_rate']:.2f}", flush=True)
    save_result("fig9_zoo", rows, out=out, extra={
        "grid": {"defenses": list(DEFENSES), "attacks": [a for a, _ in attacks(attack_at, n)],
                 "n": n, "steps": steps, "seeds": seeds, "graph": "community",
                 "attack_at": attack_time(steps, proto_start) if attack_at is None
                 else attack_at},
        "compile_groups": len(plan.groups()),
        "round_decisions": decisions,
    })
    return rows
