"""Fig. 4: consistency across graph sizes n in {50, 100, 200}
(counterpart of the reference's ``benchmarks/fig4_nodes.py``).

Paper claim: DecAFork recovers on all sizes; smaller graphs react faster.
Each n is its own sweep (the graph's size is part of the batch's shape).
"""
from repro_torch.figures.common import (
    BURSTS, PROTO_START, SEEDS, STEPS, burst_failures, run_figure, scenario,
)
from repro_torch.graphs import make_graph

# eps tuned per n as in the paper (eps in {1.85, 2, 2.1})
EPS_BY_N = {50: 1.85, 100: 2.0, 200: 2.1}


def scenarios(*, proto_start=PROTO_START, bursts=BURSTS):
    """``[(graph, [Scenario, ...])]``: one sweep per graph size."""
    return [(make_graph("regular", n, seed=0, degree=8),
             [scenario(f"fig4/n={n}", "decafork", burst_failures(bursts), proto_start, eps=eps)])
            for n, eps in EPS_BY_N.items()]


def run(verbose=True, *, device=None, out=None, steps=STEPS, seeds=SEEDS,
        proto_start=PROTO_START, bursts=BURSTS):
    return run_figure("fig4_nodes", scenarios(proto_start=proto_start, bursts=bursts),
                      steps=steps, seeds=seeds, device=device, proto_start=proto_start,
                      bursts=bursts, verbose=verbose, out=out)
