"""Fig. 9's zoo grid through the port's driver, held against the live JAX
package on the CPU.

The 4 x 4 grid (walk-variant defenses x attacks; community graph n 24,
150 steps, 2 seeds, decisions from step 40, attacks at step 80, Fig. 9's
protocol: DecAFork+ Z0 10, eps 3.0 / 7.57, W 64, B 1024) runs through
Fig. 9's driver (``repro_torch.figures.fig9_zoo``: the registered
``"zoo"`` experiment, one Plan sweep), which records every output field
here (``outputs="full"``); each group's final state is taken from its
``Plan.sweep_group``. Against the reference's sweep cores on the same
grid (one compiled program per group, the node-sum oracle's round:
``estimator_impl="compare", round_impl="unfused"``; the port runs its own
``"auto"``, the round_update kernel's path):

  - integer outputs and final carries (``prev``, ``bloom``, ``pacman_pos``
    included) bitwise, ``theta_mean`` within rtol = atol = 1e-6;
  - the driver's rows against the reference script's formulas on the
    reference's trajectories;
  - the ``uniform|none`` row against the plain configuration.

The zoo's components, round decisions and registry are in
``test_torch_zoo.py``.
"""
import tempfile

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.api as japi  # noqa: E402
import repro.zoo  # noqa: E402,F401  (registers the reference's "zoo" experiment)
from repro.core.outputs import FULL as JFULL  # noqa: E402
from repro.core.simulator import _graph_arrays, _run_core  # noqa: E402
from repro.sweep import stack_configs as jstack  # noqa: E402
from repro_torch.api import Experiment  # noqa: E402
from repro_torch.api.plan import Plan  # noqa: E402
from repro_torch.core import FailureConfig  # noqa: E402
from repro_torch.figures import common, fig9_zoo  # noqa: E402

PART = bool(jax.config.jax_threefry_partitionable)
N, STEPS, SEEDS, START, ATTACK_AT = 24, 150, 2, 40, 80
ORACLE = dict(estimator_impl="compare", round_impl="unfused")
INT_FIELDS = ("z", "forks", "terms", "failures", "fork_parent", "terminated")
CARRY = ("t", "walks.pos", "walks.active", "walks.track", "walks.prev", "walks.bloom",
         "last_seen", "rts.hist", "rts.total", "byz_state", "graph.node_up",
         "graph.edge_up", "theta_hist", "pacman_pos")


def _get(state, path):
    for part in path.split("."):
        state = getattr(state, part)
        if state is None:
            return None
    return np.asarray(state.numpy() if isinstance(state, torch.Tensor) else state)


_CACHE = {}


def _cached(key, fn):
    if key not in _CACHE:
        _CACHE[key] = fn()
    return _CACHE[key]


def port_experiment():
    return fig9_zoo.experiment(device="cpu", steps=STEPS, proto_start=START,
                               attack_at=ATTACK_AT, n=N)


def port_grid():
    """Fig. 9's driver at the grid's setting, every output recorded, each
    group's ``Plan.sweep_group`` result kept: (name -> (carry, outputs),
    the driver's rows)."""
    def go():
        groups = []
        sweep_group, from_config = Plan.sweep_group, Experiment.from_config

        def kept(self, scenarios, **kw):
            out = sweep_group(self, scenarios, **kw)
            groups.append(([s.name for s in scenarios], out))
            return out

        with pytest.MonkeyPatch.context() as mp, tempfile.TemporaryDirectory() as tmp:
            mp.setattr(Plan, "sweep_group", kept)
            mp.setattr(Experiment, "from_config",
                       classmethod(lambda cls, cfg: from_config({**cfg, "outputs": "full"})))
            mp.setattr(common, "PARTITIONABLE", PART)
            rows = fig9_zoo.run(verbose=False, device="cpu", out=tmp, steps=STEPS, seeds=SEEDS,
                                proto_start=START, attack_at=ATTACK_AT, n=N)
        out = {}
        for names, (final, rec) in groups:
            carry = {f: _get(final, f) for f in CARRY}
            for j, name in enumerate(names):
                rows_j = slice(j * SEEDS, (j + 1) * SEEDS)
                out[name] = (
                    {f: (None if v is None else v[rows_j]) for f, v in carry.items()},
                    {f: getattr(rec, f)[rows_j].numpy() for f in rec._fields},
                )
        return out, rows
    return _cached("port", go)


def jax_grid():
    """The reference's sweep of the same grid (its registered ``"zoo"``
    experiment with the driver's protocol), one jitted program per group
    (``_run_core`` with the final state kept)."""
    def go():
        pcfg = port_experiment().scenarios[0].pcfg
        protocol = {f: getattr(pcfg, f) for f in (
            "algorithm", "z0", "eps", "eps2", "max_walks", "protocol_start", "rt_bins")}
        exp = japi.Experiment.from_config({
            "experiment": "zoo", "n": N, "graph_seed": 0, "graph_kwargs": {"k_bridges": 2},
            "steps": STEPS, "protocol": {**protocol, **ORACLE}, "defenses": fig9_zoo.DEFENSES,
            "attacks": fig9_zoo.attacks(ATTACK_AT, N)})
        g = exp.graph
        scen = exp.scenarios
        keys = jax.random.split(jax.random.key(0), SEEDS)
        out = {}
        for _sig, idxs in exp.plan().groups():
            pcfgs, fcfgs = jstack([scen[i] for i in idxs])
            nbr, deg, mir, pi = _graph_arrays(g, scen[idxs[0]].pcfg)

            def one(pc, fc):
                return jax.vmap(lambda k: _run_core(k, nbr, deg, mir, pi, pc, fc, STEPS, g.n,
                                                    spec=JFULL))(keys)

            final, rec = jax.jit(jax.vmap(one))(pcfgs, fcfgs)
            for j, i in enumerate(idxs):
                carry = {f: _get(final, f) for f in CARRY}
                out[scen[i].name] = (
                    {f: (None if v is None else v[j]) for f, v in carry.items()},
                    {f: np.asarray(getattr(rec, f))[j] for f in rec._fields},
                )
        return out
    return _cached("jax", go)


def test_zoo_grid_matches_jax_sweep():
    (got, _rows), want = port_grid(), jax_grid()
    assert list(got) == list(want) and len(got) == 16
    for name in want:
        (gc, go), (wc, wo) = got[name], want[name]
        for f in INT_FIELDS:
            np.testing.assert_array_equal(go[f], wo[f], err_msg=f"{name}: {f}")
        np.testing.assert_allclose(go["theta_mean"], wo["theta_mean"], rtol=1e-6, atol=1e-6,
                                   err_msg=f"{name}: theta_mean")
        for f in CARRY:
            assert (gc[f] is None) == (wc[f] is None), (name, f)
            if wc[f] is not None:
                np.testing.assert_array_equal(gc[f], wc[f], err_msg=f"{name}: final {f}")
    # every defense ran its memory, every attack struck
    assert want["biased|none"][0]["walks.prev"] is not None
    assert want["bloom|none"][0]["walks.bloom"].any()
    assert want["uniform|mobile_pacman"][0]["pacman_pos"].shape == (SEEDS, 1)
    for d in fig9_zoo.DEFENSES:
        assert want[f"{d}|multi_pacman"][1]["failures"].sum() > 0
        assert want[f"{d}|none"][1]["forks"].sum() > 0
    assert want["uniform|edge_cut"][0]["graph.edge_up"].sum() < \
        want["uniform|none"][0]["graph.edge_up"].sum()


def test_uniform_none_row_is_the_plain_config():
    """The grid's ``uniform|none`` row (unfused, padded Pac-Man and cut
    slots that never fire) equals the plain configuration's ensemble,
    which takes the whole_round kernel's path."""
    got = port_grid()[0]["uniform|none"][1]
    exp = port_experiment()
    (row,) = [s for s in exp.scenarios if s.name == "uniform|none"]
    assert row.fcfg == FailureConfig()
    plain = Experiment(graph=exp.graph, protocol=row.pcfg, failures=row.fcfg, steps=STEPS,
                       outputs="full", device="cpu", partitionable=PART)
    (_, _, decision), = plain.plan().round_decisions()
    assert decision.fused
    want = plain.ensemble(SEEDS)
    for f in want._fields:
        np.testing.assert_array_equal(got[f], getattr(want, f).numpy(), err_msg=f)


def test_fig9_zoo_grid_matches_jax():
    """Fig. 9's driver's rows at the grid's setting (mean_z_post,
    min_z_post, max_z, survival_rate, forks, terms) against the reference
    script's formulas on the reference's trajectories."""
    _got, rows = port_grid()
    want = jax_grid()
    assert [r["name"] for r in rows] == [f"fig9/{s.name}" for s in port_experiment().scenarios]
    assert sorted(r["name"] for r in rows) == sorted(f"fig9/{name}" for name in want)
    for row in rows:
        wo = want[row["name"].removeprefix("fig9/")][1]
        z = wo["z"]
        post = z[:, START:]
        expect = {"mean_z_post": float(post.mean()), "min_z_post": int(post.min()),
                  "max_z": int(z.max()), "survival_rate": float((z > 0).all(1).mean()),
                  "forks": int(wo["forks"].sum()), "terms": int(wo["terms"].sum())}
        for k, v in expect.items():
            assert row[k] == v, (row["name"], k, row[k], v)
    assert sum(r["forks"] for r in rows) > 0
