"""The port's copies of ``core/theory.py`` and ``core/irwin_hall.py``
(numpy only) against the JAX package's modules: every public function
on a grid of inputs, values equal (both are the same float64 numpy
code)."""
import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import irwin_hall as jih  # noqa: E402
from repro.core import theory as jth  # noqa: E402
from repro_torch.core import irwin_hall as tih  # noqa: E402
from repro_torch.core import theory as tth  # noqa: E402

RATES = [(0.05, 0.02), (0.1, 0.08), (0.02, 0.015)]
HISTORIES = [
    dict(n_active=10),
    dict(n_active=5, terminations=((0.0, 5),)),
    dict(n_active=6, terminations=((2.0, 3), (5.0, 1)), forks=((4.0, 2), (8.0, 1))),
]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: under xdist the workers share the
    cores, and a torch thread per core slows many small ops a
    hundredfold."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("k", [0, 1, 2, 5, 9, 25, 26, 40])
def test_irwin_hall_cdfs(k):
    s = np.linspace(-1.0, k + 1.0, 57)
    _eq(tih.irwin_hall_cdf(s, k), jih.irwin_hall_cdf(s, k))
    _eq(tih.irwin_hall_cdf(0.7, k), jih.irwin_hall_cdf(0.7, k))
    for support in (1.0, 0.37, 0.01):
        _eq(tih.scaled_irwin_hall_cdf(s, k, support), jih.scaled_irwin_hall_cdf(s, k, support))


@pytest.mark.parametrize("z0", [2, 5, 10, 20])
def test_threshold_design(z0):
    for delta in (1e-2, 1e-3, 1e-4):
        assert tih.design_eps(z0, delta) == jih.design_eps(z0, delta)
        assert tih.design_eps2(z0, delta) == jih.design_eps2(z0, delta)
    for eps, p in ((1.5, None), (2.0, 0.1), (3.0, 0.5)):
        assert tih.false_fork_probability(z0, eps, p) == jih.false_fork_probability(z0, eps, p)
        assert (tih.false_termination_probability(z0, eps + 4, p)
                == jih.false_termination_probability(z0, eps + 4, p))


@pytest.mark.parametrize("rates", RATES)
def test_lemmas_and_bounds(rates):
    tr, jr = tth.Rates(*rates), jth.Rates(*rates)
    x = np.linspace(-0.1, 1.1, 41)
    for t, t_f, t_d in ((30.0, 10.0, 30.0), (50.0, 5.0, 20.0), (12.0, 11.0, 40.0)):
        _eq(tth.fork_estimate_cdf(x, t, t_f, t_d, tr), jth.fork_estimate_cdf(x, t, t_f, t_d, jr))
        assert (tth.fork_estimate_mean_closed(t, t_f, t_d, tr)
                == jth.fork_estimate_mean_closed(t, t_f, t_d, jr))
        _eq(tth.fork_estimate_moments(t, t_f, t_d, tr, grid=4000),
            jth.fork_estimate_moments(t, t_f, t_d, jr, grid=4000))
    for h in HISTORIES:
        th, jh = tth.PopulationHistory(**h), jth.PopulationHistory(**h)
        for t in (10.0, 40.0):
            assert tth.theta_mean(t, th, tr) == jth.theta_mean(t, jh, jr)
            assert tth.theta_variance(t, th, tr) == jth.theta_variance(t, jh, jr)
            for eps, p in ((2.0, 0.1), (4.0, 0.5)):
                assert (tth.fork_probability_bound(t, th, tr, eps, p)
                        == jth.fork_probability_bound(t, jh, jr, eps, p))
                assert (tth.termination_probability_bound(t, th, tr, eps + 3, p)
                        == jth.termination_probability_bound(t, jh, jr, eps + 3, p))


@pytest.mark.parametrize("rates", RATES)
def test_theorems(rates):
    tr, jr = tth.Rates(*rates), jth.Rates(*rates)
    args = dict(t_d=0.0, eps=2.0, p=0.1)
    short = dict(horizon=400, eps_prime_grid=4)
    assert (tth.reaction_time_bound(5, 0, 5, rates=tr, delta=0.05, **short, **args)
            == jth.reaction_time_bound(5, 0, 5, rates=jr, delta=0.05, **short, **args))
    assert (tth.reaction_time_bound(3, 1, 6, rates=tr, **short, **args)
            == jth.reaction_time_bound(3, 1, 6, rates=jr, **short, **args))
    assert tth.reaction_time_bound(2, 2, 5, rates=tr, **args) == 0.0
    big = dict(t_d=0.0, eps=3.0, p=0.2)
    assert (tth.multi_fork_reaction_bound(3, 6, 2, rates=tr, **big)
            == jth.multi_fork_reaction_bound(3, 6, 2, rates=jr, **big))
    for nu in (0, 1, 5, 12):
        assert tth.fork_rate_upper(nu, 2.0, 0.1) == jth.fork_rate_upper(nu, 2.0, 0.1)
    for z_max, horizon in ((15, 100.0), (20, 1000.0)):
        assert (tth.growth_bound_delta(z_max, 10, horizon, 100, 2.0, 0.1, tr)
                == jth.growth_bound_delta(z_max, 10, horizon, 100, 2.0, 0.1, jr))
    assert (tth.time_until_growth(15, 10, 100, 2.0, 0.1, tr, 0.05)
            == jth.time_until_growth(15, 10, 100, 2.0, 0.1, jr, 0.05))
    for use_ceiling in (True, False):
        _eq(tth.overshoot_recursion(5, 5, 0.0, 60, 2.0, 0.1, tr, use_ceiling),
            jth.overshoot_recursion(5, 5, 0.0, 60, 2.0, 0.1, jr, use_ceiling))
    assert (tth.overshoot_exact_bound(5, 5, 0.0, 6, 2.0, 0.1, tr)
            == jth.overshoot_exact_bound(5, 5, 0.0, 6, 2.0, 0.1, jr))


def test_public_surface_is_the_reference_s():
    for mod_t, mod_j in ((tth, jth), (tih, jih)):
        pub_t = {n for n in dir(mod_t) if not n.startswith("_") and callable(getattr(mod_t, n))}
        pub_j = {n for n in dir(mod_j) if not n.startswith("_") and callable(getattr(mod_j, n))}
        assert pub_t == pub_j
