"""Round components of the port held against their JAX counterparts on
random numpy-seeded inputs: integer and bool results bitwise, node sums
bitwise, gather-family theta within rtol = atol = 1e-6 (it sums C floats
in another order)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import estimator as jest  # noqa: E402
from repro.core import failures as jflr  # noqa: E402
from repro.core import protocol as jprt  # noqa: E402
from repro.core import walkers as jwlk  # noqa: E402
from repro.graphs.generators import erdos_renyi_graph  # noqa: E402
from repro.graphs.state import GraphState as JGraphState, mirror_indices  # noqa: E402
from repro_torch.core import estimator as test  # noqa: E402
from repro_torch.core import failures as tflr  # noqa: E402
from repro_torch.core import protocol as tprt  # noqa: E402
from repro_torch.core import walkers as twlk  # noqa: E402
from repro_torch.graphs.state import GraphState as TGraphState  # noqa: E402
from repro_torch.utils import prng  # noqa: E402


def tiny_payload(max_walks):
    """An RW-SGD payload of a 1-layer d 16 model (vocabulary 32)."""
    from repro_torch.data import make_markov_task
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import Model
    from repro_torch.optim import RwSgdPayload, adamw

    cfg = ModelConfig(name="tiny", arch_type="dense", num_layers=1, d_model=16, d_ff=32,
                      vocab_size=32, num_heads=2, num_kv_heads=2, head_dim=8, dtype="float32")
    return RwSgdPayload(Model(cfg), adamw(1e-2), make_markov_task(32, rank=4, device="cpu"),
                        max_walks=max_walks, local_batch=1, seq_len=4)

PART = bool(jax.config.jax_threefry_partitionable)
BATCH, N, C, B, W, T = 3, 19, 16, 64, 16, 70


def _jkeys(seed, k=BATCH):
    return jax.random.split(jax.random.key(seed), k)


def _tkeys(seed, k=BATCH):
    return prng.split(prng.key(seed), k, partitionable=PART)


def _eq(want, got, msg=""):
    np.testing.assert_array_equal(np.asarray(want), got.numpy(), err_msg=msg)


def _observation(seed):
    rng = np.random.default_rng(seed)
    ls = rng.integers(-1, T, (BATCH, N, C)).astype(np.int32)
    hist = np.floor(rng.random((BATCH, N, B)) * 3).astype(np.int16)
    total = hist.sum(2, dtype=np.int32)
    pos = rng.integers(0, N, (BATCH, W)).astype(np.int32)
    track = np.stack([rng.permutation(C)[:W] for _ in range(BATCH)]).astype(np.int32)
    active = rng.random((BATCH, W)) < 0.8
    assert C * total.max() < 2**24  # the node-sum's exact-integer condition
    return ls, hist, total, pos, track, active


@pytest.mark.parametrize("seed", [0, 1])
def test_estimator_observation_and_node_sums(seed):
    ls, hist, total, pos, track, active = _observation(seed)
    prev = np.take_along_axis(np.take_along_axis(ls, pos[..., None], 1)[..., 0], track, 1)
    r = (T - prev).astype(np.int32)
    valid = active & (prev != -1) & (r >= 1)
    upd = np.where(active, T, -1).astype(np.int32)
    t = torch.full((BATCH,), T, dtype=torch.int32)
    rts = test.record_returns(
        test.ReturnTimeState(torch.as_tensor(hist.copy()), torch.as_tensor(total.copy())),
        torch.as_tensor(pos), torch.as_tensor(r), torch.as_tensor(valid),
    )
    tls = test.scatter_max_last_seen(
        torch.as_tensor(ls.copy()), torch.as_tensor(pos), torch.as_tensor(track),
        torch.as_tensor(upd),
    )
    sums = test.node_sums_compare(tls, rts.hist, rts.total, t)
    theta_ns = test.theta_hat_from_node_sums(sums, torch.as_tensor(pos))
    theta_g = test.theta_hat_rows(tls, rts.hist, rts.total, t, torch.as_tensor(pos),
                                  torch.as_tensor(track), max_elapsed=50)
    for b in range(BATCH):
        jr = jest.record_returns(jest.ReturnTimeState(jnp.asarray(hist[b]), jnp.asarray(total[b])),
                                 pos[b], r[b], valid[b])
        jls = jnp.asarray(ls[b]).at[pos[b], track[b]].max(upd[b], mode="drop")
        _eq(jr.hist, rts.hist[b], "hist")
        _eq(jr.total, rts.total[b], "total")
        _eq(jls, tls[b], "last_seen")
        jsums = jest.node_sums_compare(jls, jr.hist, jr.total, jnp.int32(T))
        _eq(jsums, sums[b], "node sums")
        _eq(jest.theta_hat_from_node_sums(jsums, pos[b]), theta_ns[b], "theta")
        jtheta = jest.theta_hat_rows(jls, jr.hist, jr.total, jnp.int32(T), pos[b], track[b],
                                     max_elapsed=50)
        np.testing.assert_allclose(np.asarray(jtheta), theta_g[b].numpy(), rtol=1e-6, atol=1e-6)


def test_walks_hop_and_select():
    g = erdos_renyi_graph(N, seed=0)
    nbr, deg = torch.as_tensor(g.neighbors), torch.as_tensor(g.degrees)
    tw = twlk.init_walks(torch.tensor([6, 9, 16], dtype=torch.int32), W, N, _tkeys(1),
                         partitionable=PART)
    rng = np.random.default_rng(2)
    avail = rng.random((BATCH, N, g.max_degree)) < 0.7
    moved = twlk.move_walks(tw, nbr, deg, _tkeys(4), torch.as_tensor(avail), partitionable=PART)
    for b, (z0, jk, mk) in enumerate(zip((6, 9, 16), _jkeys(1), _jkeys(4))):
        jw = jwlk.init_walks(z0, W, N, jk)
        for f in ("pos", "active", "track"):
            _eq(getattr(jw, f), getattr(tw, f)[b], f)
        jm = jwlk.move_walks(jw, jnp.asarray(g.neighbors), jnp.asarray(g.degrees), mk,
                             jnp.asarray(avail[b]))
        _eq(jm.pos, moved.pos[b], "moved pos")
    mask = rng.random((40, 8)) < 0.5
    u = rng.random(40).astype(np.float32)
    jadeg, jsel = jwlk.select_available_edge(jnp.asarray(mask), jnp.asarray(u), jnp.int32)
    tadeg, tsel = twlk.select_available_edge(torch.as_tensor(mask), torch.as_tensor(u))
    _eq(jadeg, tadeg)
    ok = np.asarray(jadeg) > 0  # sel is unspecified where nothing is available
    np.testing.assert_array_equal(np.asarray(jsel)[ok], tsel.numpy()[ok])


@pytest.mark.parametrize("seed", [0, 3])
def test_fork_slots_and_forks(seed):
    rng = np.random.default_rng(seed)
    active = rng.random((BATCH, W)) < 0.6
    ev = rng.random((BATCH, W)) < 0.4
    pos = rng.integers(0, N, (BATCH, W)).astype(np.int32)
    track = np.tile(np.arange(W, dtype=np.int32), (BATCH, 1))
    ls = rng.integers(-1, T, (BATCH, N, W)).astype(np.int32)
    ws = twlk.WalkState(torch.as_tensor(pos), torch.as_tensor(active), torch.as_tensor(track))
    t = torch.full((BATCH,), T, dtype=torch.int32)
    safe, ok, slot = twlk.allocate_fork_slots(ws.active, torch.as_tensor(ev))
    ws2 = twlk.execute_terminations(ws, torch.as_tensor(rng.random((BATCH, W)) < 0.0))
    nw, nls, nf, fp = twlk.execute_forks(ws2, torch.as_tensor(ls.copy()), torch.as_tensor(ev),
                                         ws2.pos, None, t)
    for b in range(BATCH):
        js, jok, jslot = jwlk.allocate_fork_slots(jnp.asarray(active[b]), jnp.asarray(ev[b]))
        _eq(js, safe[b])
        _eq(jok, ok[b])
        np.testing.assert_array_equal(np.asarray(jslot)[np.asarray(jok)], slot[b].numpy()[ok[b].numpy()])
        jws = jwlk.WalkState(jnp.asarray(pos[b]), jnp.asarray(active[b]), jnp.asarray(track[b]))
        jw2, jls, jnf, jfp = jwlk.execute_forks(jws, jnp.asarray(ls[b]), jnp.asarray(ev[b]),
                                                jws.pos, None, jnp.int32(T))
        for f in ("pos", "active", "track"):
            _eq(getattr(jw2, f), getattr(nw, f)[b], f)
        _eq(jls, nls[b], "last_seen")
        _eq(jnf, nf[b])
        _eq(jfp, fp[b])


def test_choose_and_decisions():
    rng = np.random.default_rng(7)
    pos = rng.integers(0, 6, (BATCH, W)).astype(np.int32)
    active = rng.random((BATCH, W)) < 0.7
    theta = (rng.random((BATCH, W)) * 10).astype(np.float32)
    cfgs = [tprt.ProtocolConfig(algorithm="decafork+", z0=z, max_walks=W, eps=3.0, eps2=7.57,
                                protocol_start=s) for z, s in ((4, 0), (10, 50), (6, 0))]
    rows = tprt.protocol_rows(cfgs, "cpu")
    enabled = torch.tensor([True, False, True])
    chosen = tprt.choose_walks(torch.as_tensor(pos), torch.as_tensor(active), 6)
    pair = tprt.choose_walks_pairwise(torch.as_tensor(pos), torch.as_tensor(active))
    torch.testing.assert_close(chosen, pair, rtol=0, atol=0)
    for plus in (False, True):
        fork, term = tprt.decafork_decisions(torch.as_tensor(theta), chosen, _tkeys(9), rows,
                                             enabled, plus, partitionable=PART)
        for b, c in enumerate(cfgs):
            jc = jprt.ProtocolConfig(algorithm="decafork+" if plus else "decafork", z0=c.z0,
                                     max_walks=W, eps=3.0, eps2=7.57)
            jch = jprt.choose_walks(jnp.asarray(pos[b]), jnp.asarray(active[b]), 6)
            _eq(jch, chosen[b])
            jf, jt = jprt.decafork_decisions(jnp.asarray(theta[b]), jch, _jkeys(9)[b], jc,
                                             jnp.asarray(bool(enabled[b])))
            _eq(jf, fork[b], "fork")
            _eq(jt, term[b], "term")


def test_protocol_config_validation():
    with pytest.raises(ValueError):
        tprt.ProtocolConfig(algorithm="nope")
    with pytest.raises(ValueError):
        tprt.ProtocolConfig(z0=50, max_walks=10)
    with pytest.raises(ValueError):
        tprt.ProtocolConfig(round_impl="bad")
    assert tprt.ProtocolConfig(z0=8).p == jprt.ProtocolConfig(z0=8).p
    assert tprt.ProtocolConfig().static_fields == jprt.ProtocolConfig().static_fields
    from repro_torch.api import Experiment
    from repro_torch.graphs import make_graph

    # every protocol field is ported, the zoo's walk variants too: a Plan
    # takes each config; so is the walk payload: a payload plan builds
    # and runs
    for ported in [dict(algorithm="missingperson"), dict(algorithm="none"),
                   dict(auto_eps=True), dict(analytic_survival=True)] + [
                       dict(walk_variant=v) for v in tprt.WALK_VARIANTS]:
        Experiment(graph=make_graph("ring", 8), protocol=tprt.ProtocolConfig(**ported),
                   steps=5, device="cpu").plan()
    (_, replicas), (outs, learn) = Experiment(
        graph=make_graph("ring", 8), protocol=tprt.ProtocolConfig(z0=4, max_walks=8), steps=3,
        device="cpu", payload=tiny_payload(8)).run()
    assert outs.z.shape == (3,) and learn.trained.shape == (3,)
    assert replicas.steps.shape == (1, 8) and int(learn.trained[0]) == int(outs.z[0])


FAIL = dict(burst_times=(70, 5), burst_sizes=(3, 2), p_fail=0.2, p_fail_start=10,
            byzantine_node=2, p_byz=0.5, byz_start_time=8,
            p_node_fail=0.2, p_node_recover=0.3, node_fail_start=5,
            p_link_fail=0.3, p_link_recover=0.4, link_fail_start=5,
            pacman_node=4, pacman_start_time=20,
            node_crash_times=(70,), node_crash_ids=(3,))


def test_failure_models():
    g = erdos_renyi_graph(N, seed=0)
    nbr, mir = g.neighbors, mirror_indices(g)
    rng = np.random.default_rng(11)
    active = rng.random((BATCH, W)) < 0.8
    pos = rng.integers(0, 6, (BATCH, W)).astype(np.int32)
    node_up = rng.random((BATCH, N)) < 0.8
    edge_up = rng.random((BATCH, N, g.max_degree)) < 0.8
    byz = np.array([True, False, True])
    fc = [tflr.FailureConfig(**FAIL), tflr.FailureConfig(**{**FAIL, "byzantine_node": -1}),
          tflr.FailureConfig(burst_times=(70,), burst_sizes=(4,))]
    rows = tflr.failure_rows(fc, "cpu")
    t = torch.full((BATCH,), T, dtype=torch.int32)
    ta, tp, tb, tz = (torch.as_tensor(a) for a in (active, pos, byz, node_up))
    out = dict(
        pfail=tflr.apply_probabilistic_failures(ta, t, rows, _tkeys(1), partitionable=PART),
        burst=tflr.apply_burst_failures(ta, t, rows, _tkeys(2), partitionable=PART),
        byz=tflr.step_byzantine(ta, tp, t, tb, rows, _tkeys(3), partitionable=PART),
        pac=tflr.apply_pacman(ta, tp, t, rows),
        kill=tflr.kill_resident_walks(ta, tp, tz),
        sched=tflr.scheduled_crash_mask(N, t, rows),
        topo=tflr.step_topology(TGraphState(tz, torch.as_tensor(edge_up)), t, rows, _tkeys(4),
                                torch.as_tensor(nbr), torch.as_tensor(mir), partitionable=PART),
        uni=tflr.topology_uniforms(_tkeys(4), torch.as_tensor(nbr), torch.as_tensor(mir),
                                   partitionable=PART),
    )
    for b, c in enumerate(jflr.pad_bursts([jflr.FailureConfig(**FAIL),
                                           jflr.FailureConfig(**{**FAIL, "byzantine_node": -1}),
                                           jflr.FailureConfig(burst_times=(70,), burst_sizes=(4,))])):
        ja, jp, tt = jnp.asarray(active[b]), jnp.asarray(pos[b]), jnp.int32(T)
        _eq(jflr.apply_probabilistic_failures(ja, tt, c, _jkeys(1)[b]), out["pfail"][b], "pfail")
        _eq(jflr.apply_burst_failures(ja, tt, c, _jkeys(2)[b]), out["burst"][b], "burst")
        jb = jflr.step_byzantine(ja, jp, tt, jnp.asarray(byz[b]), c, _jkeys(3)[b])
        _eq(jb[0], out["byz"][0][b], "byz kill")
        _eq(jb[1], out["byz"][1][b], "byz state")
        _eq(jflr.apply_pacman(ja, jp, tt, c), out["pac"][b], "pacman")
        _eq(jflr.kill_resident_walks(ja, jp, jnp.asarray(node_up[b])), out["kill"][b], "kill")
        _eq(jflr.scheduled_crash_mask(N, tt, c), out["sched"][b], "sched")
        jgs = jflr.step_topology(JGraphState(jnp.asarray(node_up[b]), jnp.asarray(edge_up[b])),
                                 tt, c, _jkeys(4)[b], jnp.asarray(nbr), jnp.asarray(mir))
        _eq(jgs.node_up, out["topo"].node_up[b], "node_up")
        _eq(jgs.edge_up, out["topo"].edge_up[b], "edge_up")
        for want, got in zip(jflr.topology_uniforms(_jkeys(4)[b], jnp.asarray(nbr), jnp.asarray(mir)),
                             out["uni"]):
            _eq(np.asarray(want).view(np.int32), got[b].view(torch.int32), "uniforms")


def test_failure_config_guards_and_padding():
    padded = tflr.pad_bursts([tflr.FailureConfig(burst_times=(5,), burst_sizes=(2,)),
                              tflr.FailureConfig(burst_times=(1, 2, 3), burst_sizes=(1, 1, 1))])
    assert padded[0].burst_times == (5, -1, -1) and padded[0].burst_sizes == (2, 0, 0)
    with pytest.raises(ValueError):
        tflr.FailureConfig(burst_times=(1,), burst_sizes=())
    from repro_torch.api import Experiment
    from repro_torch.graphs import make_graph

    # the zoo's attacks are ported (padded like every schedule): a Plan
    # takes each; durable sweeps (store=) still raise
    for zoo in (dict(pacman_mobile=True), dict(pacman_nodes=(3,)),
                dict(edge_cut_times=(5,), edge_cut_thresholds=(3,))):
        Experiment(graph=make_graph("ring", 8), protocol=tprt.ProtocolConfig(),
                   failures=tflr.FailureConfig(**zoo), steps=5, device="cpu").plan()
    padded = tflr.pad_bursts([tflr.FailureConfig(pacman_nodes=(3, 4)), tflr.FailureConfig(),
                              tflr.FailureConfig(edge_cut_times=(5,), edge_cut_thresholds=(3,))])
    assert padded[1].pacman_nodes == (-1, -1) and padded[0].edge_cut_times == (-1,)
    assert padded[0].edge_cut_thresholds == (-1,) and padded[2].pacman_nodes == (-1, -1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Experiment(graph=make_graph("ring", 8), protocol=tprt.ProtocolConfig(), steps=5,
                   device="cpu").sweep([(tprt.ProtocolConfig(), tflr.FailureConfig())],
                                       seeds=1, store="results")
