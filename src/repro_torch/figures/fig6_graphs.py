"""Fig. 6: stability across graph families (counterpart of the
reference's ``benchmarks/fig6_graphs.py``): random regular, complete,
Erdos-Renyi and power-law, eps mildly tuned per family as the paper tunes
it per graph. Each family is its own ensemble.
"""
from repro_torch.figures.common import (
    BURSTS, PROTO_START, SEEDS, STEPS, burst_failures, run_figure, scenario,
)
from repro_torch.graphs import make_graph

FAMILIES = [
    ("regular", dict(degree=8), 2.0),
    ("complete", {}, 2.0),
    ("erdos_renyi", {}, 1.9),
    ("power_law", dict(m=4), 1.9),
]


def scenarios(*, proto_start=PROTO_START, bursts=BURSTS):
    """``[(graph, [Scenario])]``: one ensemble per family."""
    return [(make_graph(fam, 100, seed=0, **kw),
             [scenario(f"fig6/{fam}", "decafork", burst_failures(bursts), proto_start, eps=eps)])
            for fam, kw, eps in FAMILIES]


def run(verbose=True, *, device=None, out=None, steps=STEPS, seeds=SEEDS,
        proto_start=PROTO_START, bursts=BURSTS):
    return run_figure("fig6_graphs", scenarios(proto_start=proto_start, bursts=bursts),
                      steps=steps, seeds=seeds, device=device, proto_start=proto_start,
                      bursts=bursts, batched=False, verbose=verbose,
                      out=out)
