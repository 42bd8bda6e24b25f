"""The plain reference against the program on the CPU at tiny sizes, and
its frozen threefry against the program's draws."""
import numpy as np
import pytest
import torch

from simbench import graphs, harness
from simbench.reference import threefry as tf
from simbench.tests import tiny


def test_threefry_matches_the_program_draws():
    from repro_torch.utils import prng

    for seed in (0, 7, 2**31 + 5, 2**40 + 3):
        k = tf.key(seed)
        assert np.array_equal(k, prng.key(seed).numpy())
        np.testing.assert_array_equal(tf.split(k, 5), prng.split(prng.key(seed), 5).numpy())
        np.testing.assert_array_equal(tf.fold_in(k, 12345), prng.fold_in(prng.key(seed), 12345).numpy())
        np.testing.assert_array_equal(tf.to_uniform(tf.bits(k, (3, 7))),
                                      prng.uniform(prng.key(seed), (3, 7)).numpy())
        np.testing.assert_array_equal(tf.randint(k[None], (9,), 131072),
                                      prng.randint(prng.key(seed)[None], (9,), 0, 131072).numpy())
        np.testing.assert_array_equal(tf.uniform_torch(k, (4, 5), "cpu").numpy(),
                                      tf.to_uniform(tf.bits(k, (4, 5))))


@pytest.mark.parametrize("family,n,degree", [("regular", 24, 4), ("cayley", 4096, 16)])
def test_graphs_match_the_program(family, n, degree):
    from repro_torch.graphs import Graph, make_graph
    from repro_torch.graphs.state import mirror_indices

    nbrs, degs, mirror = graphs.make(dict(family=family, n=n, degree=degree, seed=0))
    if family == "regular":
        g = make_graph("regular", n, seed=0, degree=degree)
        np.testing.assert_array_equal(nbrs, g.neighbors)
        np.testing.assert_array_equal(degs, g.degrees)
    g = Graph(n=n, neighbors=nbrs, degrees=degs)
    np.testing.assert_array_equal(mirror, mirror_indices(g))
    assert (nbrs[nbrs, mirror] == np.arange(n)[:, None]).all()


@pytest.mark.parametrize("make", [tiny.paper, tiny.production], ids=["paper", "production"])
def test_reference_agrees_with_the_program(make):
    """Both configurations' paths: MissingPerson's unfused round and the
    fused DecAFork / DecAFork+ rounds with bursts; the fused round under
    node and link churn. Integers and the final state bitwise."""
    rec = harness.run_cell(make(), 2**31 + 99, 0.0, False, "cpu", 0.0, log=lambda m: None)
    assert rec["compared"]["outputs_mismatched"] == 0
    assert rec["compared"]["state_mismatched"] == 0
    assert rec["compared"]["theta_mean_gap"] < 1e-5
    assert rec["studies"] == 1 and rec["compared_rows"] >= 4


def test_reference_in_spawned_workers_matches_in_process():
    run = harness.Run(tiny.paper(60), "cpu")
    key = harness.study_key(3, 0)
    jobs = harness.reference_jobs(run, key, 3, 6, 2)
    a = harness.run_reference(jobs, "cpu", 1)
    b = harness.run_reference(jobs, "cpu", 2)
    for (oa, fa), (ob, fb) in zip(a, b):
        for k in oa:
            np.testing.assert_array_equal(oa[k], ob[k])
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k])


def test_sampled_rows_come_from_the_seed():
    a = harness.sampled_rows(5, 200, 16)
    assert np.array_equal(a, harness.sampled_rows(5, 200, 16))
    assert not np.array_equal(a, harness.sampled_rows(6, 200, 16))
    assert len(set(a.tolist())) == 16 and a.max() < 200


def test_study_keys_differ_by_seed_and_index():
    keys = {tuple(harness.study_key(s, i)) for s in (1, 2**33 + 1) for i in (0, 1)}
    assert len(keys) == 4
    torch.manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("make", [tiny.paper, tiny.production], ids=["paper", "production"])
def test_reference_agrees_with_the_program_on_the_card(card, make):
    """The captured rounds on the card, traced: the same comparison, and
    every per-layer reading there."""
    from repro_torch.api import plan as plan_mod

    from simbench import readers

    plan_mod.clear_cache()
    rec = harness.run_cell(make(), 2**31 + 99, 0.0, True, card, 0.0, log=lambda m: None)
    plan_mod.clear_cache()
    assert rec["compared"]["outputs_mismatched"] == 0
    assert rec["compared"]["state_mismatched"] == 0
    assert rec["compared"]["theta_mean_gap"] < 1e-5
    assert readers.kernels_per_round(rec) > 0 and readers.capture_s(rec) > 0
    assert 0 < readers.round_mfu(rec) <= 100 and 0 <= readers.device_idle(rec) < 100
    assert 0 < readers.whole_round_roofline(rec) <= 100


def test_reference_refuses_fields_it_does_not_model():
    params = harness.scenario_params(tiny.paper().config, tiny.paper().traffic)
    name, proto, fail = params[1]
    with pytest.raises(ValueError, match="byzantine_node"):
        harness.reference_rows([(name, proto, dict(fail, byzantine_node=3))], 2)
    with pytest.raises(ValueError, match="gather"):
        harness.reference_rows([(name, dict(proto, estimator_impl="gather"), fail)], 2)
    rows = harness.reference_rows([(name, dict(proto, fork_prob=0.25), fail)], 2)
    assert rows["p"].tolist() == [0.25, 0.25]
