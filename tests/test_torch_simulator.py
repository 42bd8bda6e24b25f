"""The slice end to end: DecAFork / DecAFork+ trajectories of the port
against the live JAX package, on the CPU (the port's kernels run their
plain versions there).

n = 19 ER graph, W = 16, B = 64, 40 steps, 3 seeds, under every threat
model at once (``CHURN``) and under bursts only. Integer outputs and the
final carry are bitwise; ``theta_mean`` is within rtol = atol = 1e-6 (it
sums the chosen walks' theta in another order).

  - the port's fused round (the whole_round kernel's path) against JAX
    ``round_impl="unfused", estimator_impl="compare"``, the oracle of
    ``whole_round_pallas``;
  - the port's unfused round with each estimator against JAX's unfused
    round with the same estimator (DecAFork+ under CHURN);
  - the port's fused round against its own unfused round;
  - a reference state carried into the port at t = 20 (``convert``) and
    run on to t = 40 against the reference's own rounds 20-40.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import failures as jflr  # noqa: E402
from repro.core import protocol as jprt  # noqa: E402
from repro.core.outputs import FULL as JFULL  # noqa: E402
from repro.core.simulator import _graph_arrays, _run_core  # noqa: E402
from repro.graphs.generators import erdos_renyi_graph  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import Experiment  # noqa: E402
from repro_torch.core import simulator as sim  # noqa: E402
from repro_torch.core.failures import FailureConfig  # noqa: E402
from repro_torch.core.outputs import FULL  # noqa: E402
from repro_torch.core.protocol import ProtocolConfig  # noqa: E402
from repro_torch.graphs import make_graph  # noqa: E402
from repro_torch.utils import prng  # noqa: E402

PART = bool(jax.config.jax_threefry_partitionable)
STEPS, SEEDS, BASE = 40, 3, 0
# the CHURN scenario of tests/test_fused_round.py: bursts, probabilistic
# kills, a Byzantine chain, node and link churn, a scheduled crash and a
# Pac-Man node
CHURN = dict(
    burst_times=(10, 25), burst_sizes=(3, 2), p_fail=0.01,
    byzantine_node=2, p_byz=0.05, byz_start_time=8,
    p_node_fail=0.02, p_node_recover=0.3, node_fail_start=5,
    p_link_fail=0.05, p_link_recover=0.4, link_fail_start=5,
    pacman_node=4, pacman_start_time=20,
    node_crash_times=(12,), node_crash_ids=(3,),
)
BURSTS = dict(burst_times=(8, 20), burst_sizes=(3, 4))
FAILURES = {"churn": CHURN, "bursts": BURSTS}
INT_FIELDS = ("z", "forks", "terms", "failures", "fork_parent", "terminated")
CARRY = ("t", "walks.pos", "walks.active", "walks.track", "last_seen", "rts.hist",
         "rts.total", "byz_state", "graph.node_up", "graph.edge_up", "theta_hist")


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


def _pkw(alg):
    return dict(algorithm=alg, z0=6, max_walks=16, rt_bins=64, eps=2.0 if alg == "decafork" else 3.0,
                eps2=7.57)


def _graph():
    return erdos_renyi_graph(19, seed=0)


def _export(state) -> dict:
    """A (batched) JAX SimState as the flat numpy dict ``convert`` reads."""
    out = {}
    for f in CARRY:
        obj = state
        for part in f.split("."):
            obj = getattr(obj, part)
        out[f] = np.asarray(obj)
    out["key"] = np.asarray(jax.random.key_data(state.key))
    return out


_JAX_CACHE = {}


def jax_ensemble(alg, fname, impl, steps=STEPS):
    """The reference's ensemble (``Plan.ensemble``'s keys), with its final
    states: ``(exported final state, outputs as numpy)``."""
    ck = (alg, fname, impl, steps)
    if ck not in _JAX_CACHE:
        g = _graph()
        pcfg = jprt.ProtocolConfig(**_pkw(alg), estimator_impl=impl, round_impl="unfused")
        fcfg = jflr.FailureConfig(**FAILURES[fname])
        nbr, deg, mir, pi = _graph_arrays(g, pcfg)
        keys = jax.random.split(jax.random.key(BASE), SEEDS)
        final, rec = jax.jit(jax.vmap(
            lambda k: _run_core(k, nbr, deg, mir, pi, pcfg, fcfg, steps, g.n, spec=JFULL)
        ))(keys)
        _JAX_CACHE[ck] = (_export(final), {f: np.asarray(v) for f, v in rec._asdict().items()})
    return _JAX_CACHE[ck]


def port_ensemble(alg, fname, impl, round_impl, state=None, steps=STEPS, length=STEPS):
    """The port's ensemble on the CPU, from the initial state or ``state``."""
    setup = sim.make_setup(
        make_graph("erdos_renyi", 19, seed=0),
        [ProtocolConfig(**_pkw(alg), estimator_impl=impl, round_impl=round_impl)] * SEEDS,
        [FailureConfig(**FAILURES[fname])] * SEEDS, steps, "cpu", PART,
    )
    if state is None:
        state = sim.init_state(prng.split(prng.key(BASE), SEEDS, partitionable=PART), setup)
    final, rec = sim.run_rounds(state, setup, length, FULL)
    return _export_port(final), {f: v.numpy() for f, v in rec._asdict().items()}


def _export_port(state) -> dict:
    out = {}
    for f in CARRY:
        obj = state
        for part in f.split("."):
            obj = getattr(obj, part)
        out[f] = obj.numpy()
    return out


def assert_same(got, want, label):
    (gs, go), (ws, wo) = got, want
    for f in INT_FIELDS:
        np.testing.assert_array_equal(go[f], wo[f], err_msg=f"{label}: {f}")
    np.testing.assert_allclose(go["theta_mean"], wo["theta_mean"], rtol=1e-6, atol=1e-6,
                               err_msg=f"{label}: theta_mean")
    for f in CARRY:
        np.testing.assert_array_equal(gs[f], ws[f], err_msg=f"{label}: final {f}")


@pytest.mark.parametrize("fname", ["churn", "bursts"])
@pytest.mark.parametrize("alg", ["decafork", "decafork+"])
def test_fused_round_matches_jax_oracle(alg, fname):
    want = jax_ensemble(alg, fname, "compare")
    got = port_ensemble(alg, fname, "compare", "fused")
    assert_same(got, want, f"fused {alg}/{fname}")
    assert want[1]["forks"].sum() > 0  # the protocol acted


@pytest.mark.parametrize("impl", ["compare", "fused", "pallas", "gather"])
def test_unfused_round_matches_jax(impl):
    """DecAFork+ (whose rules include DecAFork's fork rule); DecAFork's
    unfused compare round is held by the fused test's oracle run."""
    alg = "decafork+"
    assert_same(port_ensemble(alg, "churn", impl, "unfused"),
                jax_ensemble(alg, "churn", impl), f"unfused {alg}/{impl}")


@pytest.mark.parametrize("alg", ["decafork", "decafork+"])
def test_port_fused_round_is_its_unfused_round(alg):
    fused = port_ensemble(alg, "bursts", "fused", "fused")
    unfused = port_ensemble(alg, "bursts", "fused", "unfused")
    assert_same(fused, unfused, f"self-consistency {alg}")
    np.testing.assert_array_equal(fused[1]["theta_mean"], unfused[1]["theta_mean"])


def test_experiment_api_run_and_ensemble():
    """``Experiment.run`` / ``.ensemble`` are the core's trajectories:
    seed i of the ensemble is ``run`` on the i-th split key."""
    want_state, want = jax_ensemble("decafork+", "churn", "compare")
    exp = Experiment(
        graph=make_graph("erdos_renyi", 19, seed=0),
        protocol=ProtocolConfig(**_pkw("decafork+"), estimator_impl="auto"),
        failures=FailureConfig(**CHURN), steps=STEPS, outputs="full", device="cpu",
        partitionable=PART,
    )
    (_, _, decision), = exp.plan().round_decisions()
    assert decision.fused and decision.backend == "kernel"
    outs = exp.ensemble(SEEDS, BASE)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(outs, f).numpy(), want[f], err_msg=f)
    keys = prng.split(prng.key(BASE), SEEDS, partitionable=PART)
    final, one = exp.run(keys[1])
    np.testing.assert_array_equal(one.z.numpy(), want["z"][1])
    np.testing.assert_array_equal(final.last_seen[0].numpy(), want_state["last_seen"][1])
    assert sim.survived(one.z.numpy()) == bool((want["z"][1] > 0).all())


def test_state_carried_across_from_jax():
    """20 rounds in JAX, the state carried into the port, 20 more rounds:
    equal to the reference's own rounds 20-40."""
    half, _ = jax_ensemble("decafork+", "churn", "compare", steps=20)
    want_state, want = jax_ensemble("decafork+", "churn", "compare")
    state = convert.state_from_arrays(half, "cpu")
    assert state.t.tolist() == [20] * SEEDS
    got_state, got = port_ensemble("decafork+", "churn", "compare", "fused", state=state,
                                   length=20)
    tail = {f: v[:, 20:] for f, v in want.items()}
    assert_same((got_state, got), (want_state, tail), "carried")


def test_config_conversion_and_guards(tmp_path):
    p = convert.protocol_config(dict(algorithm="decafork+", z0=np.int32(6), eps=np.float32(3.0)))
    assert p.z0 == 6 and p.algorithm == "decafork+"
    f = convert.failure_config(dict(burst_times=np.array([5, 9]), burst_sizes=(1, 2),
                                    p_fail=np.float32(0.25)))
    assert f.burst_times == (5, 9) and f.p_fail == 0.25
    g = make_graph("ring", 8)
    # the zoo's variants and attacks pass the Plan's checks, and so does
    # the walk payload (its plan builds and runs); durable sweeps run too
    jump = Experiment(graph=g,
                      protocol=ProtocolConfig(walk_variant="jump", estimator_impl="auto"),
                      failures=FailureConfig(pacman_mobile=True, pacman_nodes=(3,)),
                      steps=5, device="cpu")
    (_, _, decision), = jump.plan().round_decisions()
    assert decision.reason == "walk_variant 'jump' has no fused round"
    from repro_torch.data import make_markov_task
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import Model
    from repro_torch.optim import RwSgdPayload, adamw

    cfg = ModelConfig(name="tiny", arch_type="dense", num_layers=1, d_model=16, d_ff=32,
                      vocab_size=32, num_heads=2, num_kv_heads=2, head_dim=8, dtype="float32")
    payload = RwSgdPayload(Model(cfg), adamw(1e-2), make_markov_task(32, device="cpu"),
                           max_walks=16, local_batch=1, seq_len=4)
    plan = Experiment(graph=g, protocol=ProtocolConfig(max_walks=16), steps=4, device="cpu",
                      payload=payload).plan()
    outs, learn = plan.ensemble(2)
    assert outs.fork_parent.shape == (2, 4, 16) and learn.loss.shape == (2, 4, 16)
    stored = Experiment(graph=g, protocol=ProtocolConfig(), steps=5, device="cpu").sweep(
        [(ProtocolConfig(), FailureConfig())], seeds=1, store=str(tmp_path / "results"))
    assert stored["scenario0"].z.shape == (1, 5) and (tmp_path / "results").is_dir()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Experiment(graph=g, protocol=ProtocolConfig(), steps=5)
    gather = Experiment(graph=g, protocol=ProtocolConfig(estimator_impl="gather"), steps=5,
                        device="cpu")
    (_, _, decision), = gather.plan().round_decisions()
    assert not decision.fused and "node-sum family" in decision.reason
