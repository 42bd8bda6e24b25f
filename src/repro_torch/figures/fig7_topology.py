"""Fig. 7 (beyond the paper): dynamic-topology failure regimes
(counterpart of the reference's ``benchmarks/fig7_topology.py``).

Node crashes (one scheduled crash with slow recovery; i.i.d. churn),
i.i.d. link failures, and a Pac-Man node that silently absorbs every
visiting walk, under DecAFork, DecAFork+ and the unregulated ``none``
baseline. Each algorithm's rows are one batch.
"""
from repro_torch.core import FailureConfig
from repro_torch.figures.common import (
    BURSTS, PROTO_START, SEEDS, STEPS, default_graph, run_figure, scenario,
)


def crash_time(steps=STEPS, proto_start=PROTO_START) -> int:
    """The scheduled crash and the Pac-Man's start: a third of the way
    from the decisions' start to the end."""
    return proto_start + (steps - proto_start) // 3


def topology_failures(proto_start=PROTO_START, crash_at=None) -> list:
    """``(tag, FailureConfig)`` rows of the three topology threat models."""
    crash_at = crash_time(proto_start=proto_start) if crash_at is None else crash_at
    return [
        ("crash", FailureConfig(node_crash_times=(crash_at,), node_crash_ids=(0,),
                                p_node_recover=0.002)),
        ("churn", FailureConfig(p_node_fail=5e-5, p_node_recover=0.01,
                                node_fail_start=proto_start)),
        ("links", FailureConfig(p_link_fail=2e-4, p_link_recover=0.02,
                                link_fail_start=proto_start)),
        ("pacman", FailureConfig(pacman_node=0, pacman_start_time=crash_at)),
    ]


def scenarios(*, proto_start=PROTO_START, crash_at=None):
    """``[(graph, [Scenario, ...])]``: the figure's sweep."""
    return [(default_graph(), [
        scenario(f"fig7/{alg}/{tag}", alg, fcfg, proto_start)
        for alg in ("decafork", "decafork+", "none")
        for tag, fcfg in topology_failures(proto_start, crash_at)
    ])]


def run(verbose=True, *, device=None, out=None, steps=STEPS, seeds=SEEDS,
        proto_start=PROTO_START, crash_at=None, bursts=BURSTS):
    """``crash_at`` defaults to :func:`crash_time` of the reference's
    constants; ``bursts`` only sets where the reaction metric looks."""
    return run_figure("fig7_topology", scenarios(proto_start=proto_start, crash_at=crash_at),
                      steps=steps, seeds=seeds, device=device, proto_start=proto_start,
                      bursts=bursts, verbose=verbose, out=out)
