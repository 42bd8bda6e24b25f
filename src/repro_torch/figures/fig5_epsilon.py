"""Fig. 5: the eps trade-off, reaction time against undesired forks
(counterpart of the reference's ``benchmarks/fig5_epsilon.py``).

Paper claim: a larger eps reacts faster but forks more walks beyond Z_0;
a smaller eps risks failure after the second burst. The whole eps grid
is one batch.
"""
from repro_torch.figures.common import (
    BURSTS, PROTO_START, SEEDS, STEPS, burst_failures, default_graph, run_figure, scenario,
)

EPS_GRID = (1.8, 2.0, 2.25, 2.5)


def scenarios(*, proto_start=PROTO_START, bursts=BURSTS):
    """``[(graph, [Scenario, ...])]``: the figure's sweeps."""
    fcfg = burst_failures(bursts)
    return [(default_graph(), [scenario(f"fig5/eps={eps}", "decafork", fcfg, proto_start, eps=eps)
                               for eps in EPS_GRID])]


def run(verbose=True, *, device=None, out=None, steps=STEPS, seeds=SEEDS,
        proto_start=PROTO_START, bursts=BURSTS):
    return run_figure("fig5_epsilon", scenarios(proto_start=proto_start, bursts=bursts),
                      steps=steps, seeds=seeds, device=device, proto_start=proto_start,
                      bursts=bursts, verbose=verbose, out=out)
