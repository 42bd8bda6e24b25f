"""Fig. 3: a Byzantine node (2-state Markov chain) kills incoming walks
(counterpart of the reference's ``benchmarks/fig3_byzantine.py``).

Paper claims: DecAFork with the burst-tuned eps fails; only DecAFork+
copes with both the Byz phase and the sudden honest phase (no runaway
overshoot). The two DecAFork eps values are one batch.
"""
from repro_torch.core import FailureConfig
from repro_torch.figures.common import (
    BURSTS, PROTO_START, SEEDS, STEPS, default_graph, run_figure, scenario,
)


def scenarios(*, proto_start=PROTO_START, byz_at=None):
    """``[(graph, [Scenario, ...])]``; the node turns Byzantine at
    ``byz_at`` (default: 1000 steps after decisions start)."""
    byz_at = proto_start + 1000 if byz_at is None else byz_at
    fcfg = FailureConfig(byzantine_node=0, p_byz=0.001, byz_start_time=byz_at)
    return [(default_graph(), [
        scenario("fig3/decafork", "decafork", fcfg, proto_start),
        scenario("fig3/decafork/eps=2.5", "decafork", fcfg, proto_start, eps=2.5),
        scenario("fig3/decafork+", "decafork+", fcfg, proto_start),
    ])]


def run(verbose=True, *, device=None, out=None, steps=STEPS, seeds=SEEDS,
        proto_start=PROTO_START, byz_at=None, bursts=BURSTS):
    """``bursts`` only sets where the reaction metric looks, as in the
    reference (this figure schedules no burst)."""
    return run_figure("fig3_byzantine", scenarios(proto_start=proto_start, byz_at=byz_at),
                      steps=steps, seeds=seeds, device=device, proto_start=proto_start,
                      bursts=bursts, verbose=verbose, out=out)
