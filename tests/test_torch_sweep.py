"""The sweep layer and the algorithm / estimator modes it brings
(MissingPerson, ``none``, ``auto_eps``, ``analytic_survival``), held
against the live JAX package on the CPU (the port's kernels run their
plain versions there).

n = 24 ER graph, W = 16, B = 128, 200 steps, 4 seeds. Integer outputs
and final carries are bitwise; ``theta_mean`` is within rtol = atol =
1e-6 (the port sums the chosen walks' theta, and the gather family its C
columns, in another order).

  - a mixed sweep (MissingPerson; ``none``; a DecAFork eps grid whose
    scenarios have burst schedules of different lengths; DecAFork+ with
    ``p_fail``) against ``repro.api.Experiment(...).sweep``; the port's
    DecAFork groups take the whole_round kernel's path, held against the
    reference's ``round_impl="unfused", estimator_impl="compare"``;
  - its grouping and round decisions against the reference's;
  - ``sweep[i]`` against the port's own ``ensemble`` of scenario i;
  - MissingPerson, ``none``, ``auto_eps`` (compare and the theta_sums
    kernel's plain version) and ``analytic_survival`` ensembles, final
    carries included;
  - the components (``missingperson_decisions``, ``execute_grid_forks``,
    ``theta_quantile_thresholds``, ``analytic_survival_eval``) on random
    inputs, ``graphs.spectral``, and the guards.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.api as japi  # noqa: E402
from repro.core import estimator as jest  # noqa: E402
from repro.core import failures as jflr  # noqa: E402
from repro.core import protocol as jprt  # noqa: E402
from repro.core import walkers as jwlk  # noqa: E402
from repro.core.outputs import FULL as JFULL  # noqa: E402
from repro.core.simulator import _graph_arrays, _run_core  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro.graphs import spectral as jspec  # noqa: E402
from repro.sweep import Scenario as JScenario  # noqa: E402
from repro_torch.api import Experiment, Placement, SweepResult  # noqa: E402
from repro_torch.core import estimator as test  # noqa: E402
from repro_torch.core import protocol as tprt  # noqa: E402
from repro_torch.core import simulator as sim  # noqa: E402
from repro_torch.core import walkers as twlk  # noqa: E402
from repro_torch.core.failures import FailureConfig  # noqa: E402
from repro_torch.core.outputs import FULL  # noqa: E402
from repro_torch.core.protocol import ProtocolConfig  # noqa: E402
from repro_torch.graphs import make_graph, spectral as tspec  # noqa: E402
from repro_torch.sweep import Scenario, group_scenarios, stack_configs  # noqa: E402
from repro_torch.utils import prng  # noqa: E402

PART = bool(jax.config.jax_threefry_partitionable)
N, STEPS, SEEDS, BASE = 24, 200, 4, 0
BASE_P = dict(z0=6, max_walks=16, rt_bins=128, protocol_start=40)
INT_FIELDS = ("z", "forks", "terms", "failures", "fork_parent", "terminated")
CARRY = ("t", "walks.pos", "walks.active", "walks.track", "last_seen", "rts.hist",
         "rts.total", "byz_state", "graph.node_up", "graph.edge_up", "theta_hist")
# the port's DecAFork rows take the whole_round kernel's path ("auto"); its
# oracle in the reference is the unfused round on the node-sum family
KERNEL = dict(estimator_impl="auto")
ORACLE = dict(estimator_impl="compare", round_impl="unfused")

# name -> (protocol fields, failure fields, port-only fields, reference-only fields)
MIXED = {
    "missingperson": (dict(algorithm="missingperson", eps_mp=60.0),
                      dict(burst_times=(80,), burst_sizes=(3,)), {}, {}),
    "none": (dict(algorithm="none"), dict(burst_times=(80,), burst_sizes=(2,)), {}, {}),
    "eps=1.8": (dict(eps=1.8), dict(burst_times=(80,), burst_sizes=(3,)), KERNEL, ORACLE),
    "eps=2.2": (dict(eps=2.2), dict(burst_times=(80, 140), burst_sizes=(3, 2)), KERNEL, ORACLE),
    "eps=2.5": (dict(eps=2.5), {}, KERNEL, ORACLE),
    "decafork+": (dict(algorithm="decafork+", eps=3.0, eps2=7.57),
                  dict(p_fail=0.003), KERNEL, ORACLE),
}
# single-configuration ensembles (final carries included)
MODES = {
    "missingperson": MIXED["missingperson"][:2] + ({}, {}),
    "none": MIXED["none"][:2] + ({}, {}),
    "auto_eps/compare": (dict(algorithm="decafork+", eps=3.0, eps2=7.57, auto_eps=True,
                              eps_quantile=0.1, eps2_quantile=0.95, auto_min_samples=5,
                              protocol_start=80),
                         dict(burst_times=(120,), burst_sizes=(3,)),
                         dict(estimator_impl="compare"), dict(estimator_impl="compare")),
    "auto_eps/pallas": (None, None, dict(estimator_impl="pallas"), dict(estimator_impl="compare")),
    "analytic_survival": (dict(analytic_survival=True, eps=2.5),
                          dict(burst_times=(80,), burst_sizes=(3,)), {}, {}),
}
MODES["auto_eps/pallas"] = MODES["auto_eps/compare"][:2] + MODES["auto_eps/pallas"][2:]


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


def _cfgs(spec, port: bool):
    pkw, fkw, tkw, jkw = spec
    P, F = (ProtocolConfig, FailureConfig) if port else (jprt.ProtocolConfig, jflr.FailureConfig)
    return P(**{**BASE_P, **pkw, **(tkw if port else jkw)}), F(**fkw)


def _graph(port=True):
    return make_graph("erdos_renyi", N, seed=0) if port else jgen.erdos_renyi_graph(N, seed=0)


def _np(rec):
    return {f: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for f, v in rec._asdict().items()}


def _get(state, path):
    for part in path.split("."):
        state = getattr(state, part)
    return np.asarray(state.numpy() if isinstance(state, torch.Tensor) else state)


def assert_outputs(got, want, label):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{label}: {f}")
    np.testing.assert_allclose(got["theta_mean"], want["theta_mean"], rtol=1e-6, atol=1e-6,
                               err_msg=f"{label}: theta_mean")


_CACHE = {}


def _cached(key, fn):
    if key not in _CACHE:
        _CACHE[key] = fn()
    return _CACHE[key]


def port_sweep():
    scen = [Scenario(n, *_cfgs(s, True)) for n, s in MIXED.items()]
    exp = Experiment(graph=_graph(), scenarios=scen, steps=STEPS, outputs="full",
                     device="cpu", partitionable=PART)
    return _cached("port_sweep", lambda: exp.sweep(seeds=SEEDS, base_key=BASE)), exp


def jax_sweep():
    def go():
        scen = [JScenario(n, *_cfgs(s, False)) for n, s in MIXED.items()]
        exp = japi.Experiment(graph=_graph(False), scenarios=scen, steps=STEPS, outputs=JFULL)
        return {n: _np(o) for n, o in exp.sweep(seeds=SEEDS, base_key=BASE).items()}
    return _cached("jax_sweep", go)


def port_ensemble(mode):
    """The port's ensemble of one configuration, as ``Plan.ensemble`` runs
    it, with its final state: ``(final state, outputs)`` as numpy."""
    def go():
        pcfg, fcfg = _cfgs(MODES[mode], True)
        plan = Experiment(graph=_graph(), protocol=pcfg, failures=fcfg, steps=STEPS,
                          outputs="full", device="cpu", partitionable=PART).plan()
        keys = prng.split(prng.key(BASE), SEEDS, partitionable=PART)
        final, rec = sim.run_core(keys, plan._setup(SEEDS), FULL, plan.decision)
        return {f: _get(final, f) for f in CARRY}, _np(rec)
    return _cached(("port", mode), go)


def jax_ensemble(mode):
    def go():
        pcfg, fcfg = _cfgs(MODES[mode], False)
        g = _graph(False)
        nbr, deg, mir, pi = _graph_arrays(g, pcfg)
        keys = jax.random.split(jax.random.key(BASE), SEEDS)
        final, rec = jax.jit(jax.vmap(
            lambda k: _run_core(k, nbr, deg, mir, pi, pcfg, fcfg, STEPS, g.n, spec=JFULL)
        ))(keys)
        return {f: _get(final, f) for f in CARRY}, _np(rec)
    return _cached(("jax", mode[: mode.index("/")] if "/" in mode else mode), go)


# ---------------------------------------------------------------------------
# the slice end to end
# ---------------------------------------------------------------------------


def test_mixed_sweep_matches_jax_sweep():
    got, _ = port_sweep()
    want = jax_sweep()
    assert isinstance(got, SweepResult) and got.names == tuple(MIXED)
    for name in MIXED:
        out = _np(got[name])
        assert out["z"].shape == (SEEDS, STEPS)
        assert_outputs(out, want[name], f"sweep {name}")
    assert want["missingperson"]["forks"].sum() > 0  # every rule acted
    assert want["eps=1.8"]["forks"].sum() > 0 and want["decafork+"]["terms"].sum() > 0
    assert want["none"]["forks"].sum() == 0


def test_groups_and_round_decisions_match_jax(monkeypatch):
    """The same grouping as the reference; the port's fused round is the
    whole_round kernel, the reference's Pallas backend, so the reference
    decides here as it does on the TPU."""
    import repro.kernels.platform as jplatform

    monkeypatch.setattr(jplatform, "fused_round_backend", lambda: "pallas")
    _, exp = port_sweep()
    node_sum = dict(estimator_impl="compare")  # the reference's "auto" on the CPU is gather
    scen = [JScenario(n, *_cfgs((s[0], s[1], KERNEL, node_sum) if s[2] else s, False))
            for n, s in MIXED.items()]
    jplan = japi.Experiment(graph=_graph(False), scenarios=scen, steps=STEPS).plan()
    plan = exp.plan()
    assert [i for _, i in plan.groups()] == [i for _, i in jplan.groups()]
    assert [i for _, i in plan.groups()] == [[0], [1], [2, 3, 4], [5]]
    got, want = plan.round_decisions(), jplan.round_decisions()
    assert [g[1] for g in got] == [w[1] for w in want]
    for (_, idx, d), (_, _, w) in zip(got, want):
        assert d.impl == w.impl, (idx, d, w)
        if not d.fused:
            assert d.reason == w.reason
    assert [d.fused for _, _, d in got] == [False, False, True, True]
    assert got[0][2].reason == "algorithm 'missingperson' has no fused round"


@pytest.mark.parametrize("name", ["missingperson", "none", "eps=2.2", "eps=2.5"])
def test_sweep_scenario_is_its_own_ensemble(name):
    """``sweep[i]`` equals ``ensemble`` on scenario i bitwise: the same
    keys, and a padded burst schedule (eps=2.5 has none, eps=2.2 two)
    never fires."""
    got, _ = port_sweep()
    if name in MODES:
        want = port_ensemble(name)[1]
    else:
        pcfg, fcfg = _cfgs(MIXED[name], True)
        want = _np(Experiment(graph=_graph(), protocol=pcfg, failures=fcfg, steps=STEPS,
                              outputs="full", device="cpu", partitionable=PART)
                   .ensemble(SEEDS, BASE))
    out = _np(got[name])
    for f in FULL.fields:
        np.testing.assert_array_equal(out[f], want[f], err_msg=f"{name}: {f}")


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_ensemble_matches_jax(mode):
    """MissingPerson, ``none``, auto_eps and analytic survival: outputs
    and final carries (the auto_eps histogram included)."""
    (gs, go), (ws, wo) = port_ensemble(mode), jax_ensemble(mode)
    assert_outputs(go, wo, mode)
    for f in CARRY:
        np.testing.assert_array_equal(gs[f], ws[f], err_msg=f"{mode}: final {f}")
    if mode.startswith("auto_eps"):
        assert ws["theta_hist"].sum() > 0 and wo["terms"].sum() > 0
    if mode.startswith(("auto_eps", "analytic")):
        pcfg, fcfg = _cfgs(MODES[mode], True)
        assert not sim.round_impl_decision(pcfg, fcfg).fused


# ---------------------------------------------------------------------------
# components on random inputs
# ---------------------------------------------------------------------------

BATCH, C, W, T = 3, 16, 16, 90


def _keys(seed):
    return (jax.random.split(jax.random.key(seed), BATCH),
            prng.split(prng.key(seed), BATCH, partitionable=PART))


def _rows(cfgs):
    return tprt.protocol_rows(cfgs, "cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_missingperson_decisions_and_grid_forks(seed):
    rng = np.random.default_rng(seed)
    ls = rng.integers(-1, T, (BATCH, N, C)).astype(np.int32)
    pos = rng.integers(0, N, (BATCH, W)).astype(np.int32)
    track = rng.integers(0, C, (BATCH, W)).astype(np.int32)
    active = rng.random((BATCH, W)) < 0.6
    chosen = active & (rng.random((BATCH, W)) < 0.7)
    cfgs = [ProtocolConfig(algorithm="missingperson", z0=z, max_walks=W, eps_mp=e, fork_prob=p)
            for z, e, p in ((6, 30.0, 0.9), (9, 50.0, None), (16, 10.0, 0.5))]
    jc = [jprt.ProtocolConfig(**{f: getattr(c, f) for f in ("algorithm", "z0", "max_walks",
                                                              "eps_mp", "fork_prob")})
          for c in cfgs]
    jk, tk = _keys(seed + 5)
    t = torch.full((BATCH,), T, dtype=torch.int32)
    enabled = torch.tensor([True, True, False])
    ev = tprt.missingperson_decisions(
        torch.as_tensor(ls), torch.as_tensor(pos), torch.as_tensor(track),
        torch.as_tensor(chosen), t, tk, _rows(cfgs), enabled, partitionable=PART)
    ws = twlk.WalkState(torch.as_tensor(pos), torch.as_tensor(active), torch.as_tensor(track))
    ws2, ls2, nf, fp = twlk.execute_grid_forks(ws, torch.as_tensor(ls), ev, t)
    assert ev.sum() > 0
    for b in range(BATCH):
        jev = jprt.missingperson_decisions(jnp.asarray(ls[b]), jnp.asarray(pos[b]),
                                           jnp.asarray(track[b]), jnp.asarray(chosen[b]),
                                           jnp.int32(T), jk[b], jc[b],
                                           jnp.asarray(bool(enabled[b])))
        np.testing.assert_array_equal(np.asarray(jev), ev[b].numpy())
        jws = jwlk.WalkState(jnp.asarray(pos[b]), jnp.asarray(active[b]), jnp.asarray(track[b]))
        jws2, jls2, jnf, jfp = jwlk.execute_grid_forks(jws, jnp.asarray(ls[b]), jev, jnp.int32(T))
        for want, got in ((jws2.pos, ws2.pos), (jws2.active, ws2.active),
                          (jws2.track, ws2.track), (jls2, ls2), (jnf, nf), (jfp, fp)):
            np.testing.assert_array_equal(np.asarray(want), got[b].numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_theta_quantile_thresholds_and_per_walk_eps(seed):
    rng = np.random.default_rng(seed)
    cfgs = [ProtocolConfig(algorithm="decafork+", max_walks=W, eps=e, eps2=e2,
                           eps_quantile=q, eps2_quantile=q2, auto_min_samples=m)
            for e, e2, q, q2, m in ((2.0, 6.0, 0.05, 0.995, 5), (2.5, 7.0, 0.2, 0.9, 50),
                                    (3.0, 5.0, 0.5, 0.5, 1))]
    TB = tprt.theta_bins(cfgs[0])
    hist = np.floor(rng.random((BATCH, N, TB)) * rng.random((BATCH, N, 1)) * 4).astype(np.float32)
    pos = rng.integers(0, N, (BATCH, W)).astype(np.int32)
    theta = (rng.random((BATCH, W)) * 8).astype(np.float32)
    chosen = rng.random((BATCH, W)) < 0.6
    jk, tk = _keys(seed + 7)
    rows = _rows(cfgs)
    eps, eps2 = tprt.theta_quantile_thresholds(torch.as_tensor(hist), torch.as_tensor(pos), rows)
    fork, term = tprt.decafork_decisions(
        torch.as_tensor(theta), torch.as_tensor(chosen), tk, rows,
        torch.ones(BATCH, dtype=torch.bool), True, eps, eps2, partitionable=PART)
    for b, c in enumerate(cfgs):
        jc = jprt.ProtocolConfig(**{f.name: getattr(c, f.name) for f in dataclasses.fields(c)})
        je, je2 = jprt.theta_quantile_thresholds(jnp.asarray(hist[b]), jnp.asarray(pos[b]), jc)
        np.testing.assert_array_equal(np.asarray(je), eps[b].numpy())
        np.testing.assert_array_equal(np.asarray(je2), eps2[b].numpy())
        jf, jt = jprt.decafork_decisions(jnp.asarray(theta[b]), jnp.asarray(chosen[b]), jk[b],
                                         jc, jnp.asarray(True), eps=je, eps2=je2)
        np.testing.assert_array_equal(np.asarray(jf), fork[b].numpy())
        np.testing.assert_array_equal(np.asarray(jt), term[b].numpy())


def test_analytic_survival_theta_and_spectral():
    rng = np.random.default_rng(3)
    for name, kw in (("erdos_renyi", {}), ("power_law", {}), ("regular", dict(degree=4))):
        g, jg = make_graph(name, N, seed=1, **kw), jgen.make_graph(name, N, seed=1, **kw)
        for fn in ("transition_matrix", "stationary_distribution", "expected_return_times",
                   "return_rate_estimate", "spectral_gap", "mixing_time_bound",
                   "arrival_rate_estimate", "cover_time_estimate"):
            np.testing.assert_array_equal(getattr(tspec, fn)(g), getattr(jspec, fn)(jg),
                                          err_msg=f"{name}: {fn}")
    pi = np.asarray(tspec.stationary_distribution(g), np.float32)
    ls = rng.integers(-1, T, (BATCH, N, C)).astype(np.int32)
    pos = rng.integers(0, N, (BATCH, W)).astype(np.int32)
    track = rng.integers(0, C, (BATCH, W)).astype(np.int32)
    empty = np.zeros((BATCH, N, 8), np.int16)
    got = test.theta_hat_rows(torch.as_tensor(ls), torch.as_tensor(empty),
                              torch.zeros((BATCH, N), dtype=torch.int32),
                              torch.full((BATCH,), T, dtype=torch.int32),
                              torch.as_tensor(pos), torch.as_tensor(track),
                              pi=torch.as_tensor(pi))
    for b in range(BATCH):
        want = jest.theta_hat_rows(jnp.asarray(ls[b]), jnp.asarray(empty[b]),
                                   jnp.zeros((N,), jnp.int32), jnp.int32(T),
                                   jnp.asarray(pos[b]), jnp.asarray(track[b]),
                                   pi=jnp.asarray(pi))
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    r = torch.as_tensor(rng.integers(-3, 400, (BATCH, W)).astype(np.int32))
    nodes = torch.as_tensor(pos)
    np.testing.assert_allclose(
        test.analytic_survival_eval(torch.as_tensor(pi), nodes, r).numpy(),
        np.asarray(jest.analytic_survival_eval(jnp.asarray(pi), jnp.asarray(pos),
                                               jnp.asarray(r.numpy()))),
        rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the surface and its guards
# ---------------------------------------------------------------------------


def test_stacking_and_results():
    a = Scenario("a", ProtocolConfig(**BASE_P), FailureConfig(burst_times=(5,), burst_sizes=(1,)))
    b = Scenario("b", ProtocolConfig(**BASE_P, eps=2.5), FailureConfig())
    c = (ProtocolConfig(**BASE_P, fork_prob=0.5), FailureConfig())
    assert [i for _, i in group_scenarios([a, b, c])] == [[0, 1], [2]]
    pcfgs, fcfgs = stack_configs([a, b])
    assert [f.burst_times for f in fcfgs] == [(5,), (-1,)]
    assert [f.burst_sizes for f in fcfgs] == [(1,), (0,)]
    with pytest.raises(ValueError, match="static structures"):
        stack_configs([a, c])
    with pytest.raises(ValueError, match="duplicate"):
        SweepResult(("x", "x"), [1, 2])
    res = SweepResult(("x", "y"), [1, 2])
    assert res["y"] == 2 and res[0] == 1 and len(res) == 2 and res.payloads is None
    with pytest.raises(KeyError, match="available scenarios"):
        res["z"]
    with pytest.raises(KeyError, match="without a payload"):
        res.payload(0)


def test_guards_name_their_roadmap_items(tmp_path):
    g = _graph()
    p = ProtocolConfig(**BASE_P)
    scen = [Scenario("a", p, FailureConfig()), Scenario("a", p, FailureConfig())]
    exp = Experiment(graph=g, scenarios=scen[:1], steps=5, device="cpu")
    # durable execution (item 9) is ported: a stored sweep and a segmented
    # one are bitwise the straight sweep
    straight = exp.plan().sweep_stacked(seeds=1)
    for got in (exp.sweep(seeds=1, store=str(tmp_path / "somewhere"))["a"],
                exp.plan().sweep_stacked(seeds=1, segment_steps=2).map(lambda v: v[0])):
        for f in got._fields:
            assert torch.equal(getattr(got, f), getattr(straight, f)[0]), f
    # the node-sharded step (item 11) is ported: on one device "sharded"
    # keeps the rows where "local" does, bitwise (tests/test_sweep.py's
    # test_placement_policies_agree_on_single_device)
    runs = {pl: Experiment(graph=g, protocol=p, steps=60, device="cpu", placement=pl).ensemble(2)
            for pl in ("sharded", "local")}
    for f in runs["local"]._fields:
        assert torch.equal(getattr(runs["sharded"], f), getattr(runs["local"], f)), f
    # the walk payload (item 8) is ported: a payload sweep builds and runs
    from repro_torch.data import make_markov_task
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import Model
    from repro_torch.optim import RwSgdPayload, adamw

    cfg = ModelConfig(name="tiny", arch_type="dense", num_layers=1, d_model=16, d_ff=32,
                      vocab_size=32, num_heads=2, num_kv_heads=2, head_dim=8, dtype="float32")
    payload = RwSgdPayload(Model(cfg), adamw(1e-2), make_markov_task(32, device="cpu"),
                           max_walks=p.max_walks, local_batch=1, seq_len=4)
    res = Experiment(graph=g, scenarios=scen[:1], steps=3, device="cpu",
                     payload=payload).sweep(seeds=1)
    assert res.payload("a").mean_loss.shape == (1, 3) and res["a"].z.shape == (1, 3)
    with pytest.raises(ValueError, match="duplicate"):
        Experiment(graph=g, scenarios=scen, steps=5, device="cpu").sweep(seeds=1)
    with pytest.raises(ValueError, match="base scenario"):
        exp.ensemble(2)
    with pytest.raises(ValueError, match="base scenario"):
        exp.run(0)
    with pytest.raises(TypeError):
        Experiment(graph=g, steps=5, device="cpu")
    assert Experiment(graph=g, protocol=p, steps=5, device="cpu",
                      placement=Placement.LOCAL).plan().device == torch.device("cpu")
