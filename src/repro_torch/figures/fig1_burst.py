"""Fig. 1: burst failures, MissingPerson vs DecAFork vs DecAFork+
(counterpart of the reference's ``benchmarks/fig1_burst.py``).

Paper claims: MissingPerson over-reacts (overshoot well past Z_0);
DecAFork reacts and stabilizes around Z_0; DecAFork+ reacts faster
(terminations allow a more aggressive eps). The three curves run as one
sweep (one batch per algorithm).
"""
from repro_torch.figures.common import (
    BURSTS, PROTO_START, SEEDS, STEPS, burst_failures, default_graph, run_figure, scenario,
)


def scenarios(*, proto_start=PROTO_START, bursts=BURSTS):
    """``[(graph, [Scenario, ...])]``: the figure's sweeps."""
    fcfg = burst_failures(bursts)
    return [(default_graph(), [scenario(f"fig1/{alg}", alg, fcfg, proto_start)
                               for alg in ("missingperson", "decafork", "decafork+")])]


def run(verbose=True, *, device=None, out=None, steps=STEPS, seeds=SEEDS,
        proto_start=PROTO_START, bursts=BURSTS):
    return run_figure("fig1_burst", scenarios(proto_start=proto_start, bursts=bursts),
                      steps=steps, seeds=seeds, device=device, proto_start=proto_start,
                      bursts=bursts, verbose=verbose, out=out)
