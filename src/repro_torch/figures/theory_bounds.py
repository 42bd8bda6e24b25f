"""Theory against simulation: Thm. 2's reaction bound and Cor. 3's
overshoot (counterpart of the reference's ``benchmarks/theory_bounds.py``).

The worst-case analytical bounds (``repro_torch.core.theory``, numpy)
must upper-bound the quantities the DecAFork ensemble shows.
"""
from repro_torch.core.theory import Rates, overshoot_recursion, reaction_time_bound
from repro_torch.figures.common import (
    BURSTS, PROTO_START, SEEDS, STEPS, Z0, burst_failures, default_graph, run_case,
    save_result, scenario,
)
from repro_torch.graphs import arrival_rate_estimate, return_rate_estimate


def scenarios(*, proto_start=PROTO_START, bursts=BURSTS):
    """``[(graph, [Scenario])]``: the one ensemble."""
    return [(default_graph(), [scenario("theory/decafork", "decafork", burst_failures(bursts),
                                        proto_start)])]


def bounds(graph) -> dict:
    """Thm. 2's time to the first fork after D = 5 failures (K = 5
    remain) and Cor. 3's population bound 500 steps after the burst, at
    the graph's estimated rates."""
    rates = Rates(lambda_r=float(return_rate_estimate(graph).mean()),
                  lambda_a=float(arrival_rate_estimate(graph)))
    t_bound = reaction_time_bound(d_failed=5, r_forked=0, k_remaining=Z0 - 5, t_d=0.0,
                                  eps=2.0, p=1.0 / Z0, rates=rates, delta=0.05)
    oc = overshoot_recursion(z_after_failure=Z0 - 5, d_failed=5, t_d=0.0, steps=500,
                             eps=2.0, p=1.0 / Z0, rates=rates)
    return {"thm2_first_fork_bound": float(t_bound), "cor3_z_bound_at_500": float(oc[-1])}


def run(verbose=True, *, device=None, out=None, steps=STEPS, seeds=SEEDS,
        proto_start=PROTO_START, bursts=BURSTS):
    [(g, [s])] = scenarios(proto_start=proto_start, bursts=bursts)
    res = run_case(s.name, g, s.pcfg, s.fcfg, steps, seeds, device=device,
                   proto_start=proto_start, bursts=bursts)
    m = res.metrics()
    b = bounds(g)
    rows = [{
        "name": "theory/thm2_vs_sim",
        "us_per_call": res.us_per_call,
        **b,
        "observed_full_recovery_median": float(m["reaction_median"][0]),
        "observed_max_z": m["max_z"],
        "metrics": m,
        "forks": res.forks,
        "terms": res.terms,
    }]
    if verbose:
        print(f"theory/thm2,{res.us_per_call:.2f},"
              f"bound_first_fork={b['thm2_first_fork_bound']:.0f}"
              f"|observed_recovery={m['reaction_median'][0]:.0f}"
              f"|cor3_bound500={b['cor3_z_bound_at_500']:.1f}|observed_maxZ={m['max_z']}",
              flush=True)
    save_result("theory_bounds", rows, out=out)
    return rows
