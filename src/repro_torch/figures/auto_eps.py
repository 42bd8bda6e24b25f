"""Beyond the paper: self-calibrating thresholds against the paper's
hand-tuned eps (counterpart of the reference's ``benchmarks/auto_eps.py``).

``auto_eps`` replaces the Irwin-Hall design rule with per-node quantiles
of the warm-up theta-hat distribution. The Fig. 4 / Fig. 6 graphs run
with one global quantile setting against the per-graph-tuned DecAFork.
The auto runs take the theta_sums kernel (``estimator_impl="pallas"``);
the tuned runs the whole_round kernel.
"""
from repro_torch.figures.common import (
    BURSTS, PROTO_START, SEEDS, STEPS, burst_failures, run_figure, scenario,
)
from repro_torch.graphs import make_graph

SWEEP = [
    ("regular", 50, dict(degree=8)),
    ("regular", 100, dict(degree=8)),
    ("regular", 200, dict(degree=8)),
    ("power_law", 100, dict(m=4)),
    ("erdos_renyi", 100, {}),
]
TUNED_EPS = {("regular", 50): 1.85, ("regular", 100): 2.0, ("regular", 200): 2.1,
             ("power_law", 100): 1.9, ("erdos_renyi", 100): 1.9}
# self-calibration needs ~100+ theta-hat samples per node: a warm-up of
# ~1200 steps
AUTO_START = 1200


def scenarios(*, proto_start=PROTO_START, bursts=BURSTS, auto_start=AUTO_START):
    """``[(graph, [tuned, auto])]``: one ensemble each."""
    return [(make_graph(fam, n, seed=0, **kw), [
        scenario(f"auto_eps/tuned/{fam}-{n}", "decafork", burst_failures(bursts), proto_start,
                 eps=TUNED_EPS[(fam, n)]),
        scenario(f"auto_eps/auto/{fam}-{n}", "decafork+", burst_failures(bursts), auto_start,
                 auto_eps=True, estimator_impl="pallas"),
    ]) for fam, n, kw in SWEEP]


def run(verbose=True, *, device=None, out=None, steps=STEPS, seeds=SEEDS,
        proto_start=PROTO_START, bursts=BURSTS, auto_start=AUTO_START):
    return run_figure("auto_eps", scenarios(proto_start=proto_start, bursts=bursts,
                                            auto_start=auto_start),
                      steps=steps, seeds=seeds, device=device, proto_start=proto_start,
                      bursts=bursts, batched=False, verbose=verbose,
                      out=out)
