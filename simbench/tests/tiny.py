"""Tiny cells for the CPU tests: the two configurations' code paths (the
fused round with bursts, the fused round under node and link churn, and
MissingPerson's unfused round) at sizes a test run holds."""
from simbench.harness import Cell

LIMITS = dict(outputs_mismatched=0, state_mismatched=0, theta_mean_gap=3e-3)


def paper(steps=120):
    cfg = dict(graph=dict(family="regular", n=24, degree=4, seed=0),
               protocol=dict(z0=6, max_walks=16, rt_bins=64, protocol_start=30,
                             estimator_impl="auto", round_impl="auto"),
               algorithms={"decafork": {"eps": 2.0}, "decafork+": {"eps": 3.0, "eps2": 5.0},
                           "missingperson": {"eps_mp": 40.0}},
               failures=dict(burst_times=[60, 100], burst_sizes=[3, 4]), steps=steps)
    tr = dict(seeds=3, outputs="full", compare_rows=6, compare_chunk=6, compare_workers=1,
              limits=LIMITS,
              scenarios=[dict(name="mp", algorithm="missingperson"),
                         dict(name="a", algorithm="decafork", eps=1.8),
                         dict(name="b", algorithm="decafork"),
                         dict(name="c", algorithm="decafork+")])
    return Cell(name="tiny-paper", config=cfg, traffic=tr, end_to_end=[], per_layer=[])


def production(steps=30):
    cfg = dict(graph=dict(family="cayley", n=512, degree=8, seed=0),
               protocol=dict(z0=8, max_walks=16, rt_bins=64, protocol_start=0,
                             estimator_impl="auto", round_impl="auto"),
               algorithms={"decafork+": {"eps": 3.0, "eps2": 6.0}},
               failures=dict(p_node_fail=0.01, p_node_recover=0.3, p_link_fail=0.01,
                             p_link_recover=0.4), steps=steps)
    tr = dict(seeds=4, outputs="full", compare_rows=4, limits=LIMITS,
              scenarios=[dict(name="p", algorithm="decafork+")])
    return Cell(name="tiny-production", config=cfg, traffic=tr, end_to_end=[], per_layer=[])
