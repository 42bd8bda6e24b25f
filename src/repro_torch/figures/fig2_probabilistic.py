"""Fig. 2: continuous probabilistic failures p_f on top of bursts
(counterpart of the reference's ``benchmarks/fig2_probabilistic.py``).

Paper claims: DecAFork recovers from bursts but cannot hold Z_0 under
continuous failures; DecAFork+ stays stable across p_f values. Both p_f
values of an algorithm are rows of one batch.
"""
from repro_torch.figures.common import (
    BURSTS, PROTO_START, SEEDS, STEPS, burst_failures, default_graph, run_figure, scenario,
)

PF_GRID = (0.001, 0.0002)


def scenarios(*, proto_start=PROTO_START, bursts=BURSTS):
    """``[(graph, [Scenario, ...])]``: the figure's sweeps."""
    return [(default_graph(), [
        scenario(f"fig2/{alg}/pf={pf}", alg,
                 burst_failures(bursts, p_fail=pf, p_fail_start=proto_start), proto_start)
        for pf in PF_GRID
        for alg in ("decafork", "decafork+")
    ])]


def run(verbose=True, *, device=None, out=None, steps=STEPS, seeds=SEEDS,
        proto_start=PROTO_START, bursts=BURSTS):
    return run_figure("fig2_probabilistic", scenarios(proto_start=proto_start, bursts=bursts),
                      steps=steps, seeds=seeds, device=device, proto_start=proto_start,
                      bursts=bursts, verbose=verbose, out=out)
