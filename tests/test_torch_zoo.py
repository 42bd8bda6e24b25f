"""The zoo (walk-variant defenses x attacks) of the port, held against the
live JAX package on the CPU.

  - components on numpy-seeded inputs, bitwise: each variant's move
    (``jump``, ``biased`` with the preset and with non-dyadic p / q,
    ``bloom``), the Bloom hashes, ``step_mobile_pacman``, the multi-node
    ``apply_pacman``, ``edge_cut_mask`` and forks copying ``prev`` and
    ``bloom``;
  - ``round_decisions()`` of the 4 x 4 grid (community graph n 24)
    against the reference's (its Pallas backend);
  - ``zoo_scenarios`` and ``Experiment.from_config({"experiment": "zoo"})``
    against the reference's rows; Fig. 9's scenario list against
    ``benchmarks/fig9_zoo.py``'s at its constants and at the grid's
    setting.

The grid end to end, through Fig. 9's driver, is in
``test_torch_zoo_grid.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from benchmarks import fig9_zoo as rfig9  # noqa: E402
import repro.zoo as jzoo  # noqa: E402
from repro.core import failures as jflr  # noqa: E402
from repro.core import protocol as jprt  # noqa: E402
from repro.core import walkers as jwlk  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
import repro.api as japi  # noqa: E402
from repro.zoo import variants as jvar  # noqa: E402
from repro_torch import zoo as tzoo  # noqa: E402
from repro_torch.api import Experiment  # noqa: E402
from repro_torch.core import failures as tflr  # noqa: E402
from repro_torch.core import protocol as tprt  # noqa: E402
from repro_torch.core import walkers as twlk  # noqa: E402
from repro_torch.figures import fig9_zoo  # noqa: E402
from repro_torch.graphs import make_graph  # noqa: E402
from repro_torch.graphs.state import GraphState, availability  # noqa: E402
from repro_torch.utils import prng  # noqa: E402
from repro_torch.zoo import variants as tvar  # noqa: E402

PART = bool(jax.config.jax_threefry_partitionable)
N, STEPS, START, ATTACK_AT = 24, 150, 40, 80
PROTO = dict(algorithm="decafork+", z0=6, eps=3.0, eps2=7.57, max_walks=16, rt_bins=128,
             protocol_start=START)
DEFENSES = ("uniform", "jump", "biased", "bloom")
# Fig. 9's attacks at the grid's setting
ATTACKS = (
    ("none", {}),
    ("mobile_pacman", {"node": 0, "hop_prob": 0.5, "start": ATTACK_AT}),
    ("multi_pacman", {"nodes": (0, N // 2), "start": ATTACK_AT}),
    ("edge_cut", {"time": ATTACK_AT, "threshold": N // 2}),
)
CONFIG = dict(experiment="zoo", n=N, graph_seed=0, graph_kwargs={"k_bridges": 2}, steps=STEPS,
              defenses=DEFENSES, attacks=ATTACKS)
PORT_IMPL = dict(estimator_impl="auto")


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


def port_experiment():
    return Experiment.from_config({**CONFIG, "protocol": {**PROTO, **PORT_IMPL},
                                   "outputs": "full", "device": "cpu",
                                   "partitionable": PART})


def jax_experiment(**impl):
    return japi.Experiment.from_config({**CONFIG, "protocol": {**PROTO, **impl}})


def test_round_decisions_match_jax(monkeypatch):
    """Every zoo group runs unfused with the reference's reason; the
    ``none`` rows share a group with multi-node Pac-Man and edge cuts, so
    their padded schedules send them unfused too."""
    import repro.kernels.platform as jplatform

    monkeypatch.setattr(jplatform, "fused_round_backend", lambda: "pallas")
    plan = port_experiment().plan()
    jplan = jax_experiment(estimator_impl="compare").plan()
    assert [i for _, i in plan.groups()] == [i for _, i in jplan.groups()]
    got, want = plan.round_decisions(), jplan.round_decisions()
    assert len(got) == 8
    for (_, idx, d), (_, jdx, w) in zip(got, want):
        assert idx == jdx
        # the reference's Pallas whole-round kernel is the port's whole_round
        reason = w.reason.replace("pallas whole-round kernel", "whole_round kernel")
        assert (d.impl, d.reason) == (w.impl, reason), (idx, d, w)
        assert d.backend == ("kernel" if w.backend == "pallas" else w.backend)
    assert not any(d.fused for _, _, d in got)


@pytest.mark.parametrize("tiny", [False, True], ids=["reference-constants", "grid"])
def test_fig9_scenario_list_matches_the_reference_script(tiny, monkeypatch):
    """Fig. 9's driver's grid against ``benchmarks/fig9_zoo.py``'s (read,
    never run) at the script's constants and at the grid's setting of
    ``test_torch_zoo_grid.py``; the port adds only its execution fields
    (``estimator_impl="auto"``, the kernels' node-sum family)."""
    if tiny:
        for k, v in dict(N=N, STEPS=STEPS, PROTO_START=START, ATTACKS=ATTACKS).items():
            monkeypatch.setattr(rfig9, k, v)
    jexp = rfig9.experiment()
    kw = dict(proto_start=START, attack_at=ATTACK_AT, n=N, steps=STEPS) if tiny else {}
    [(g, scen)] = fig9_zoo.scenarios(**kw)
    np.testing.assert_array_equal(g.neighbors, jexp.graph.neighbors)
    assert [s.name for s in scen] == [s.name for s in jexp.scenarios]
    for s, js in zip(scen, jexp.scenarios):
        pf, jpf = _fields(s.pcfg), _fields(js.pcfg)
        assert (pf.pop("estimator_impl"), jpf.pop("estimator_impl")) == ("auto", "gather")
        assert pf == jpf and _fields(s.fcfg) == _fields(js.fcfg), s.name


def _fields(cfg):
    return {f.name: (tuple(np.asarray(v).reshape(-1).tolist())
                     if isinstance(v := getattr(cfg, f.name), (tuple, jax.Array)) else v)
            for f in dataclasses.fields(cfg)}


def test_zoo_scenarios_and_registry_build_the_reference_rows():
    defenses = ["uniform", ("jump", {"p_jump": 0.2}), "biased", "bloom"]
    attacks = [("edge_cut", {"time": 30, "threshold": 9}), "mobile_pacman",
               ("multi_pacman", {"nodes": (1, 2, 3)}), ("burst", {"times": (5,), "sizes": (2,)}),
               ("byzantine", {"node": 3}), ("probabilistic", {"p": 0.1}), ("pacman", {"node": 2})]
    base = dict(z0=4, max_walks=8, rt_bins=32)
    got = tzoo.zoo_scenarios(defenses, attacks, tprt.ProtocolConfig(**base))
    want = jzoo.zoo_scenarios(defenses, attacks, jprt.ProtocolConfig(**base))
    assert [s.name for s in got] == [s.name for s in want]
    for g, w in zip(got, want):
        assert _fields(g.pcfg) == _fields(w.pcfg) and _fields(g.fcfg) == _fields(w.fcfg)
    exp, jexp = port_experiment(), jax_experiment(**PORT_IMPL)
    assert [s.name for s in exp.scenarios] == [s.name for s in jexp.scenarios]
    for g, w in zip(exp.scenarios, jexp.scenarios):
        assert _fields(g.pcfg) == _fields(w.pcfg) and _fields(g.fcfg) == _fields(w.fcfg)
    assert np.array_equal(exp.graph.neighbors, jexp.graph.neighbors)
    assert sorted(tzoo.ATTACKS) == sorted(jzoo.ATTACKS) and tzoo.DEFENSES == jzoo.DEFENSES
    with pytest.raises(KeyError):
        tzoo.attack("nope")
    with pytest.raises(ValueError, match="experiment"):
        Experiment.from_config({"n": 8})


# ---------------------------------------------------------------------------
# components on random inputs
# ---------------------------------------------------------------------------

BATCH, W, T = 3, 16, 90


def _graph():
    return make_graph("community", N, 0, k_bridges=2), jgen.community_graph(N, 2, seed=0)


def _walk_inputs(seed):
    rng = np.random.default_rng(seed)
    g, _ = _graph()
    pos = rng.integers(0, N, (BATCH, W)).astype(np.int32)
    prev = np.where(rng.random((BATCH, W)) < 0.3, pos,
                    g.neighbors[pos, rng.integers(0, 3, (BATCH, W))]).astype(np.int32)
    active = rng.random((BATCH, W)) < 0.8
    node_up = rng.random((BATCH, N)) < 0.85
    node_up[1] = False  # a trajectory with every node down
    edge_up = rng.random((BATCH, N, g.max_degree)) < 0.8
    bloom = rng.random((BATCH, W, 64)) < 0.3
    return g, pos, prev, active, node_up, edge_up, bloom


def _keys(seed):
    return (jax.random.split(jax.random.key(seed), BATCH),
            prng.split(prng.key(seed), BATCH, partitionable=PART))


VARIANTS = {
    "jump": dict(walk_variant="jump", p_jump=0.4),
    "biased": dict(walk_variant="biased", bias_p=4.0, bias_q=0.5),
    "biased/non-dyadic": dict(walk_variant="biased", bias_p=3.0, bias_q=0.7),
    "bloom": dict(walk_variant="bloom", bloom_bits=64),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_move_variant_matches_jax(variant, seed):
    g, pos, prev, active, node_up, edge_up, bloom = _walk_inputs(seed)
    nbr, deg = torch.as_tensor(g.neighbors), torch.as_tensor(g.degrees)
    pcfg = tprt.ProtocolConfig(max_walks=W, **VARIANTS[variant])
    # the rates enter the reference as float32 values, as in its sweeps
    jcfg = jprt.ProtocolConfig(max_walks=W, **{
        k: (jnp.float32(v) if isinstance(v, float) else v) for k, v in VARIANTS[variant].items()})
    ws = twlk.WalkState(torch.as_tensor(pos), torch.as_tensor(active), torch.zeros_like(
        torch.as_tensor(pos)), torch.as_tensor(prev), torch.as_tensor(bloom))
    avail = availability(GraphState(torch.as_tensor(node_up), torch.as_tensor(edge_up)), nbr, deg)
    jk, tk = _keys(seed + 3)
    got = tvar.move_variant(ws, pcfg, tprt.protocol_rows([pcfg] * BATCH, "cpu"), nbr, deg, tk,
                            avail, torch.as_tensor(node_up), partitionable=PART)
    moved = 0
    for b in range(BATCH):
        jws = jwlk.WalkState(jnp.asarray(pos[b]), jnp.asarray(active[b]), jnp.zeros(W, jnp.int32),
                             jnp.asarray(prev[b]), jnp.asarray(bloom[b]))
        want = jvar.move_variant(jws, jcfg, jnp.asarray(g.neighbors), jnp.asarray(g.degrees),
                                 jk[b], jnp.asarray(avail[b].numpy()), jnp.asarray(node_up[b]))
        for f in ("pos", "prev", "bloom"):
            np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                          getattr(got, f)[b].numpy(), err_msg=f"{variant} {f}")
        moved += int((np.asarray(want.pos) != pos[b]).sum())
    assert moved > 0


def test_init_variant_state_and_bloom_hashes():
    pos = torch.tensor([[0, 5, 7]], dtype=torch.int32)
    ws = twlk.WalkState(pos, torch.ones_like(pos, dtype=torch.bool), pos.clone())
    for name, kw in VARIANTS.items():
        got = tvar.init_variant_state(ws, tprt.ProtocolConfig(**kw))
        want = jvar.init_variant_state(jwlk.WalkState(jnp.asarray(pos[0]), jnp.ones(3, bool),
                                                      jnp.asarray(pos[0])),
                                       jprt.ProtocolConfig(**kw))
        for f in ("prev", "bloom"):
            w = getattr(want, f)
            assert (w is None) == (getattr(got, f) is None), name
            if w is not None:
                np.testing.assert_array_equal(np.asarray(w), getattr(got, f)[0].numpy())
    ids = np.array([0, 1, 2, 23, 99, 4095, 65537, 2**31 - 1, 2**31 + 7, 2**32 - 1],
                   dtype=np.uint32)
    for bits in (7, 64, 1000):
        jh = jvar._bloom_hashes(jnp.asarray(ids), bits)
        th = tvar._bloom_hashes(torch.as_tensor(ids.astype(np.int64)), bits)
        for a, b in zip(jh, th):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


ATTACK_ROWS = [
    dict(pacman_node=3, pacman_nodes=(7, -1), pacman_start_time=50, pacman_hop_prob=0.6,
         edge_cut_times=(T, 10), edge_cut_thresholds=(12, 5)),
    dict(pacman_node=-1, pacman_nodes=(20, 1), pacman_start_time=T + 1, pacman_hop_prob=1.0,
         edge_cut_times=(T, -1), edge_cut_thresholds=(-1, 12)),
    dict(pacman_node=15, pacman_nodes=(15, 2), pacman_start_time=0, pacman_hop_prob=0.0,
         edge_cut_times=(5, T), edge_cut_thresholds=(3, 7)),
]


@pytest.mark.parametrize("seed", [0, 1])
def test_attacks_match_jax(seed):
    """The multi-node and mobile ``apply_pacman``, ``step_mobile_pacman``
    and ``edge_cut_mask`` (over padded adjacency slots too), and the
    edge cut through ``step_topology``."""
    from repro.graphs.state import GraphState as JGraphState, mirror_indices

    g, pos, _prev, active, node_up, edge_up, _bloom = _walk_inputs(seed)
    rng = np.random.default_rng(seed + 10)
    pac = rng.integers(-1, N, (BATCH, 3)).astype(np.int32)
    nbr, deg = torch.as_tensor(g.neighbors), torch.as_tensor(g.degrees)
    mir = mirror_indices(_graph()[1])
    rows = tflr.failure_rows([tflr.FailureConfig(**a) for a in ATTACK_ROWS], "cpu")
    t = torch.full((BATCH,), T, dtype=torch.int32)
    gs = GraphState(torch.as_tensor(node_up), torch.as_tensor(edge_up))
    avail = availability(gs, nbr, deg)
    jk, tk = _keys(seed + 5)
    ta, tp = torch.as_tensor(active), torch.as_tensor(pos)
    got = dict(
        static=tflr.apply_pacman(ta, tp, t, rows),
        carried=tflr.apply_pacman(ta, tp, t, rows, torch.as_tensor(pac)),
        hop=tflr.step_mobile_pacman(torch.as_tensor(pac), t, rows, tk, nbr, avail,
                                    partitionable=PART),
        cut=tflr.edge_cut_mask(nbr, t, rows),
        topo=tflr.step_topology(gs, t, rows, tk, nbr, torch.as_tensor(mir), partitionable=PART),
    )
    assert tflr.initial_pacman_positions(rows).tolist() == \
        [[a["pacman_node"], *a["pacman_nodes"]] for a in ATTACK_ROWS]
    hit = 0
    for b, kw in enumerate(ATTACK_ROWS):
        c, tt = jflr.FailureConfig(**kw), jnp.int32(T)
        ja, jp = jnp.asarray(active[b]), jnp.asarray(pos[b])
        want = dict(
            static=jflr.apply_pacman(ja, jp, tt, c),
            carried=jflr.apply_pacman(ja, jp, tt, c, jnp.asarray(pac[b])),
            hop=jflr.step_mobile_pacman(jnp.asarray(pac[b]), tt, c, jk[b],
                                        jnp.asarray(g.neighbors), jnp.asarray(g.degrees),
                                        jnp.asarray(avail[b].numpy())),
            cut=jflr.edge_cut_mask(jnp.asarray(g.neighbors), tt, c),
        )
        for k, w in want.items():
            np.testing.assert_array_equal(np.asarray(w), got[k][b].numpy(), err_msg=k)
        jgs = jflr.step_topology(JGraphState(jnp.asarray(node_up[b]), jnp.asarray(edge_up[b])),
                                 tt, c, jk[b], jnp.asarray(g.neighbors), jnp.asarray(mir))
        np.testing.assert_array_equal(np.asarray(jgs.edge_up), got["topo"].edge_up[b].numpy())
        hit += int(np.asarray(want["cut"]).sum()) + int((~np.asarray(want["carried"])).sum())
    assert hit > 0 and not torch.equal(got["hop"], torch.as_tensor(pac))


def test_forks_copy_prev_and_bloom():
    """DecAFork forks and MissingPerson's grid forks: each child takes its
    parent's ``prev`` and Bloom history, as in the reference."""
    rng = np.random.default_rng(4)
    g, pos, prev, active, _nu, _eu, bloom = _walk_inputs(4)
    ls = rng.integers(-1, T, (BATCH, N, W)).astype(np.int32)
    track = np.stack([rng.permutation(W) for _ in range(BATCH)]).astype(np.int32)
    fork = rng.random((BATCH, W)) < 0.3
    grid = rng.random((BATCH, W, W)) < 0.02
    t = torch.full((BATCH,), T, dtype=torch.int32)
    ws = twlk.WalkState(*(torch.as_tensor(a) for a in (pos, active, track, prev, bloom)))
    got = (twlk.execute_forks(ws, torch.as_tensor(ls), torch.as_tensor(fork), ws.pos, None, t),
           twlk.execute_grid_forks(ws, torch.as_tensor(ls), torch.as_tensor(grid), t))
    for b in range(BATCH):
        jws = jwlk.WalkState(*(jnp.asarray(a[b]) for a in (pos, active, track, prev, bloom)))
        want = (jwlk.execute_forks(jws, jnp.asarray(ls[b]), jnp.asarray(fork[b]), jws.pos, None,
                                   jnp.int32(T)),
                jwlk.execute_grid_forks(jws, jnp.asarray(ls[b]), jnp.asarray(grid[b]),
                                        jnp.int32(T)))
        for (wws, wls, wn, wfp), (gws, gls, gn, gfp) in zip(want, got):
            for f in wws._fields:
                np.testing.assert_array_equal(np.asarray(getattr(wws, f)),
                                              getattr(gws, f)[b].numpy(), err_msg=f)
            for w, x in ((wls, gls), (wn, gn), (wfp, gfp)):
                np.testing.assert_array_equal(np.asarray(w), x[b].numpy())
            assert int(wn) > 0
