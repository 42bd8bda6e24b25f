"""The port's node-sharded protocol step (``repro_torch.core.distributed``)
against the JAX package's ``core/distributed.py``.

At one shard (``mesh=None``) the port's step is held to the reference's
jitted step on a 1-device mesh: the four cases of
``tests/test_distributed.py`` and a 300-round DecAFork+ run with forks
and terminations, on all-True and on random topology masks. Every
compared field is bitwise (integers, and the float32 counts in ``hist``
and ``total``: whole numbers, exact in float32). Then the port over gloo
at world size 2 (``("data",)``) and 4 (a (2, 2) ``("pod", "data")``
mesh), in spawned processes, bitwise its one-shard run, and the
world-size-4 run bitwise the reference's 4-device run (a subprocess
with ``XLA_FLAGS`` set before JAX starts). The step's runner
(``run_sharded`` through ``ShardedRunner``'s static buffers, eager on
the CPU) is bitwise the bare step, and asking it to capture over gloo
or on CPU tensors raises."""
import concurrent.futures
import functools
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import estimator as ref_est  # noqa: E402
from repro.core import walkers as ref_wlk  # noqa: E402
from repro.core.distributed import make_sharded_step as ref_make_step  # noqa: E402
from repro.core.protocol import ProtocolConfig as RefProtocolConfig  # noqa: E402
from repro.graphs import random_regular_graph  # noqa: E402
from repro.utils.compat import AxisType, make_mesh  # noqa: E402
from repro.utils.prng import fold_in_time  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import estimator as est  # noqa: E402
from repro_torch.core import walkers as wlk  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    ShardedGraph,
    ShardedProtocolState,
    gather_state,
    make_sharded_step,
    run_sharded,
    shard_state,
)
from repro_torch.core.protocol import ProtocolConfig  # noqa: E402
from repro_torch.graphs.state import availability as port_availability  # noqa: E402
from repro_torch.graphs.state import GraphState as PortGraphState  # noqa: E402
from repro_torch.launch.sharded import spawn_run  # noqa: E402
from repro_torch.utils import prng  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
PART = bool(jax.config.jax_threefry_partitionable)
# tests/test_distributed.py's setting, and the 300-round DecAFork+ run
# with decisions from step 100 (Z moves between 6 and 20)
CASES = dict(algorithm="decafork+", z0=6, max_walks=24, eps=1.8, eps2=6.5,
             protocol_start=200, rt_bins=256)
LONG = dict(CASES, protocol_start=100)
ROUNDS = 300
FIELDS = ("pos", "active", "track", "last_seen", "hist", "total")  # results 1-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graph():
    return random_regular_graph(64, 8, seed=1)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))


def _masks(g, random):
    """All-True masks, or tests/test_distributed.py's random ones (the
    edge mask kept symmetric)."""
    if not random:
        return np.ones((g.n,), bool), np.ones((g.n, g.max_degree), bool)
    rng = np.random.default_rng(7)
    node_up = rng.random(g.n) > 0.15
    edge = rng.random((g.n, g.max_degree)) > 0.2
    for i in range(g.n):
        for k in range(int(g.degrees[i])):
            j = int(g.neighbors[i, k])
            if j > i:
                kk = int(np.nonzero(np.asarray(g.neighbors[j]) == i)[0][0])
                edge[j, kk] = edge[i, k]
    return node_up, edge


def _ref_args(g, kw, seed, random=False):
    """The reference step's twelve starting arguments (tests/
    test_distributed.py's ``_init``), as JAX arrays."""
    key = jax.random.key(seed)
    W = kw["max_walks"]
    node_up, edge_up = _masks(g, random)
    return [jnp.int32(0), jax.random.randint(key, (W,), 0, g.n, dtype=jnp.int32),
            jnp.arange(W) < kw["z0"], jnp.arange(W, dtype=jnp.int32),
            jnp.full((g.n, W), -1, jnp.int32), jnp.zeros((g.n, kw["rt_bins"]), jnp.float32),
            jnp.zeros((g.n,), jnp.float32), key, jnp.asarray(g.neighbors),
            jnp.asarray(g.degrees), jnp.asarray(node_up), jnp.asarray(edge_up)]


def _numpy(args):
    return [np.asarray(jax.random.key_data(a)) if jnp.issubdtype(a.dtype, jax.dtypes.prng_key)
            else np.asarray(a) for a in args]


_REF_STEPS = {}


def _ref_rounds(mesh, g, kw, args, rounds):
    """Each round's results 1-6 and z from the reference's jitted step
    (compiled once per setting)."""
    k = json.dumps(kw, sort_keys=True)
    if k not in _REF_STEPS:
        _REF_STEPS[k] = jax.jit(ref_make_step(mesh, ("data",), g.n, RefProtocolConfig(**kw)))
    step = _REF_STEPS[k]
    out = []
    with mesh:
        for _ in range(rounds):
            res = step(*args)
            args = list(res[:8]) + args[8:]
            out.append([np.asarray(x) for x in res[1:7]] + [int(res[8])])
    return out


def _port_rounds(g, kw, args_np, rounds):
    """The same from the port's step at one shard on the CPU."""
    state, gr = convert.sharded_step_from_arrays(args_np, "cpu")
    step = make_sharded_step(None, ("data",), g.n, ProtocolConfig(**kw), partitionable=PART)
    out = []
    for _ in range(rounds):
        *st, z = step(*state, *gr)
        state = type(state)(*st)
        out.append([x.numpy().copy() for x in st[1:7]] + [int(z)])
    return out


def _assert_rounds_equal(ref, got):
    assert len(ref) == len(got)
    for i, (a, b) in enumerate(zip(ref, got)):
        for f, x, y in zip(FIELDS + ("z",), a, b):
            np.testing.assert_array_equal(y, x, err_msg=f"round {i}: {f}")


# -- the estimator's survival functions -------------------------------------


def test_survival_eval_matches_reference():
    rng = np.random.default_rng(0)
    hist = np.floor(rng.random((9, 16)) * 4).astype(np.float32)
    hist[3] = 0  # a node with no samples: S = 1
    total = hist.sum(1)
    nodes = rng.integers(0, 9, (40, 5)).astype(np.int32)
    r = rng.integers(-3, 24, (40, 5)).astype(np.int32)  # r <= 0 and r past the bins
    cum_ref = ref_est.survival_cumulative(ref_est.ReturnTimeState(jnp.asarray(hist),
                                                                  jnp.asarray(total)))
    s_ref = ref_est.survival_eval(cum_ref, jnp.asarray(total), jnp.asarray(nodes), jnp.asarray(r))
    cum = est.survival_cumulative(torch.as_tensor(hist))
    s = est.survival_eval(cum, torch.as_tensor(total), torch.as_tensor(nodes), torch.as_tensor(r))
    np.testing.assert_array_equal(cum.numpy(), np.asarray(cum_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))  # bitwise
    assert (s.numpy()[nodes == 3] == 1).all() and (s.numpy()[r <= 0] == 1).all()


# -- the four cases of tests/test_distributed.py at one shard ---------------


def test_distributed_step_runs_and_self_regulates(graph, mesh):
    args = _ref_args(graph, CASES, 0)
    ref = _ref_rounds(mesh, graph, CASES, args, 600)
    got = _port_rounds(graph, CASES, _numpy(args), 600)
    _assert_rounds_equal(ref, got)
    zs = np.asarray([r[-1] for r in got])
    assert zs.min() >= 1 and zs.max() <= CASES["max_walks"]
    assert got[-1][5].sum() > 0  # return-time samples accumulated
    assert (got[-1][0] >= 0).all() and (got[-1][0] < graph.n).all()


def test_distributed_movement_follows_edges(graph, mesh):
    args = _ref_args(graph, CASES, 1)
    ref = _ref_rounds(mesh, graph, CASES, args, 25)
    got = _port_rounds(graph, CASES, _numpy(args), 25)
    _assert_rounds_equal(ref, got)
    adj = graph.adjacency()
    old = np.asarray(args[1])
    for r in got:
        new, act = r[0], r[1]
        moved = act & (old != new)
        assert adj[old[moved], new[moved]].all()
        old = new


def test_distributed_masked_movement_parity_with_single_device(graph, mesh):
    """Resident-walk kills and masked movement: the port's sharded step
    equals the reference's and the port's own single-device hop
    (``walkers.move_walks`` over the same availability) on every round."""
    args = _ref_args(graph, CASES, 3, random=True)
    ref = _ref_rounds(mesh, graph, CASES, args, 8)
    got = _port_rounds(graph, CASES, _numpy(args), 8)
    _assert_rounds_equal(ref, got)
    state, gr = convert.sharded_step_from_arrays(_numpy(args), "cpu")
    gs = PortGraphState(gr.node_up[None], gr.edge_up[None])
    avail = port_availability(gs, gr.neighbors, gr.degrees)
    pos, active = state.pos[None], state.active[None]
    for t, r in enumerate(got):  # protocol_start=200 >> t: no decisions
        ws = wlk.WalkState(pos=pos, active=active & gr.node_up[pos.long()], track=state.track[None])
        ws = wlk.move_walks(ws, gr.neighbors, gr.degrees,
                            prng.fold_in_time(state.key[None], t, 0), avail, partitionable=PART)
        np.testing.assert_array_equal(r[0], ws.pos[0].numpy())
        np.testing.assert_array_equal(r[1], ws.active[0].numpy())
        pos, active = ws.pos, ws.active


def test_distributed_full_masks_bitwise_equal_unmasked(graph, mesh):
    """All-True masks: the reference's unmasked uniform-neighbor hop."""
    args = _ref_args(graph, CASES, 5)
    got = _port_rounds(graph, CASES, _numpy(args), 5)
    pos, active, track, key = args[1], args[2], args[3], args[7]
    move = jax.jit(lambda ws, t: ref_wlk.move_walks(ws, args[8], args[9], fold_in_time(key, t, 0)))
    for t, r in enumerate(got):
        ref = move(ref_wlk.WalkState(pos=pos, active=active, track=track), jnp.int32(t))
        np.testing.assert_array_equal(r[0], np.asarray(ref.pos))
        pos = ref.pos
    ref_masked = _ref_rounds(mesh, graph, CASES, args, 5)
    _assert_rounds_equal(ref_masked, got)


# -- the 300-round DecAFork+ run, with forks and terminations ---------------


@pytest.fixture(scope="module")
def long_args(graph):
    """The 300-round run's starting arguments (numpy) per mask kind."""
    return {m: _ref_args(graph, LONG, 0, random=(m == "random")) for m in ("all_true", "random")}


@pytest.fixture(scope="module")
def long_port(graph, long_args):
    return {m: _port_rounds(graph, LONG, _numpy(a), ROUNDS) for m, a in long_args.items()}


@pytest.mark.parametrize("masks", ["all_true", "random"])
def test_decafork_plus_300_rounds_bitwise_reference(graph, mesh, long_args, long_port, masks):
    ref = _ref_rounds(mesh, graph, LONG, long_args[masks], ROUNDS)
    got = long_port[masks]
    _assert_rounds_equal(ref, got)
    dz = np.diff([r[-1] for r in got])
    assert (dz > 0).any() and (dz < 0).any()  # forks and terminations both happen


# -- several ranks over gloo ------------------------------------------------

REF4 = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.core.distributed import make_sharded_step
from repro.core.protocol import ProtocolConfig
from repro.utils.compat import AxisType, make_mesh

inp, out, kw, rounds = sys.argv[1], sys.argv[2], json.loads(sys.argv[3]), int(sys.argv[4])
assert len(jax.devices()) == 4, jax.devices()
d = np.load(inp)
args = [jnp.asarray(d[f"a{i}"]) for i in range(12)]
args[7] = jax.random.wrap_key_data(args[7])
mesh = make_mesh((2, 2), ("pod", "data"), axis_types=(AxisType.Auto,) * 2)
step = jax.jit(make_sharded_step(mesh, ("pod", "data"), args[4].shape[0], ProtocolConfig(**kw)))
zs = []
with mesh:
    for _ in range(rounds):
        res = step(*args)
        args = list(res[:8]) + args[8:]
        zs.append(int(res[8]))
np.savez(out, z=np.asarray(zs, np.int32), **{f"r{i}": np.asarray(res[i]) for i in range(1, 7)})
"""


@pytest.fixture(scope="module", autouse=True)
def background(graph, tmp_path_factory):
    """Started before the module's first test, beside the one-shard
    tests: the random-mask run over gloo at world size 2 (``("data",)``)
    and 4 (``("pod", "data")``, 2 x 2), from the converted reference
    state, and the reference's 4-device run in a subprocess (JAX reads
    XLA_FLAGS once, at start)."""
    args = _numpy(_ref_args(graph, LONG, 0, random=True))
    d = tmp_path_factory.mktemp("sharded")
    np.savez(d / "in.npz", **{f"a{i}": a for i, a in enumerate(args)})
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable, "-c", REF4, str(d / "in.npz"), str(d / "out.npz"),
                             json.dumps(LONG), str(ROUNDS)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    state, gr = convert.sharded_step_from_arrays(args, "cpu")
    run = functools.partial(spawn_run, state, gr, ProtocolConfig(**LONG), ROUNDS, device="cpu",
                            partitionable=PART)
    pool = concurrent.futures.ThreadPoolExecutor(2)
    runs = {2: pool.submit(run, world=2),
            4: pool.submit(run, world=4, mesh_shape=(2, 2), mesh_axes=("pod", "data"),
                           node_axes=("pod", "data"))}
    try:
        yield dict(runs=runs, ref4=(proc, d / "out.npz"))
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()
        pool.shutdown(wait=True)


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_world_size_bitwise_one_shard(long_port, background, world):
    got, one = background["runs"][world].result(timeout=300), long_port["random"]
    np.testing.assert_array_equal(got["z"].numpy(), [r[-1] for r in one])
    for f, want in zip(FIELDS, one[-1]):
        np.testing.assert_array_equal(getattr(got["state"], f).numpy(), want, err_msg=f)
    assert int(got["state"].t) == ROUNDS


def test_world_size_4_bitwise_reference_4_devices(background):
    proc, out = background["ref4"]
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-2000:]
    ref = np.load(out)
    got = background["runs"][4].result(timeout=300)
    np.testing.assert_array_equal(got["z"].numpy(), ref["z"])
    for i, f in enumerate(FIELDS, start=1):
        np.testing.assert_array_equal(getattr(got["state"], f).numpy(), ref[f"r{i}"], err_msg=f)


# -- shapes, helpers, conversion --------------------------------------------


def _stub_mesh(shape, names, coord):
    """What the step reads of a DeviceMesh, without a process group."""
    return types.SimpleNamespace(mesh_dim_names=names, mesh=torch.arange(np.prod(shape)).view(shape),
                                 get_coordinate=lambda: list(coord))


def test_node_count_must_divide_over_shards():
    pcfg = ProtocolConfig(**CASES)
    with pytest.raises(ValueError, match="must divide over 3 shards"):
        make_sharded_step(_stub_mesh((3,), ("data",), (0,)), ("data",), 64, pcfg)
    with pytest.raises(ValueError, match="must divide over 6 shards"):
        make_sharded_step(_stub_mesh((2, 3, 2), ("pod", "data", "model"), (0, 0, 0)),
                          ("pod", "data"), 64, pcfg)


def test_shard_state_takes_the_rank_rows(graph):
    state, gr = convert.sharded_step_from_arrays(_numpy(_ref_args(graph, CASES, 2, True)), "cpu")
    state = state._replace(last_seen=torch.arange(64 * 24, dtype=torch.int32).view(64, 24))
    # coordinate (pod 1, data 0, model 1) of a (2, 2, 2) mesh: shard 2 of 4
    mesh = _stub_mesh((2, 2, 2), ("pod", "data", "model"), (1, 0, 1))
    st, g = shard_state(state, gr, mesh, ("pod", "data"))
    for f in ("last_seen", "hist", "total"):
        assert torch.equal(getattr(st, f), getattr(state, f)[32:48])
    for f in ("neighbors", "degrees", "edge_up"):
        assert torch.equal(getattr(g, f), getattr(gr, f)[32:48])
    assert torch.equal(g.node_up, gr.node_up) and torch.equal(st.pos, state.pos)
    st.last_seen.zero_()  # copies: the whole graph's tables are untouched
    assert state.last_seen[32, 0] == 32 * 24
    assert gather_state(st, None, ("data",)) is st


def test_convert_round_trip(graph):
    args = _numpy(_ref_args(graph, LONG, 4, random=True))
    state, gr = convert.sharded_step_from_arrays(args, "cpu")
    assert isinstance(gr, ShardedGraph)
    assert state.hist.dtype == torch.float32 and state.last_seen.dtype == torch.int32
    back = convert.sharded_step_to_arrays(state, gr)
    for name, a, b in zip(convert.SHARDED_STEP_ARGS, args, back):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    key = jax.random.wrap_key_data(jnp.asarray(back[7]))
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(key)), args[7])
    with pytest.raises(ValueError, match="twelve|12"):
        convert.sharded_step_from_arrays(args[:11], "cpu")
    # the converted state runs
    st, z = run_sharded(make_sharded_step(None, ("data",), graph.n, ProtocolConfig(**LONG),
                                          partitionable=PART), state, gr, 1)
    assert int(st.t) == 1 and z.shape == (1,)


# -- the runner: static buffers, eager here, captured on the card -----------


def test_runner_is_the_bare_step(graph, long_args, long_port):
    """``run_sharded`` runs the step through a ``ShardedRunner``'s static
    buffers: the 300-round random-mask run in three calls (120 + 100 +
    80 rounds, each from the last one's state) is bitwise the bare step's
    rounds, the caller's state is not written, and one eager runner
    serves every call."""
    state, gr = convert.sharded_step_from_arrays(_numpy(long_args["random"]), "cpu")
    before = [x.clone() for x in state]
    step = make_sharded_step(None, ("data",), graph.n, ProtocolConfig(**LONG), partitionable=PART)
    zs, st = [], state
    for rounds in (120, 100, 80):
        st, z = run_sharded(step, st, gr, rounds)
        zs.append(z)
    one = long_port["random"]
    np.testing.assert_array_equal(torch.cat(zs).numpy(), [r[-1] for r in one])
    for f, want in zip(FIELDS, one[-1]):
        np.testing.assert_array_equal(getattr(st, f).numpy(), want, err_msg=f)
    assert int(st.t) == ROUNDS and all(torch.equal(a, b) for a, b in zip(state, before))
    assert list(step.runners) == [(torch.device("cpu"), False)]
    assert step.runners[(torch.device("cpu"), False)].captured is None


def test_capture_is_refused_over_gloo_and_on_the_cpu(graph, long_args, tmp_path):
    """Gloo's collectives do not capture: ``capture=True`` over a gloo
    group (world size 1 in this process) raises, and so does it on CPU
    tensors with no collective; the default over gloo runs eagerly,
    bitwise the one shard."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import data_axes, make_local_mesh

    state, gr = convert.sharded_step_from_arrays(_numpy(long_args["random"]), "cpu")
    pcfg = ProtocolConfig(**LONG)
    one = make_sharded_step(None, ("data",), graph.n, pcfg, partitionable=PART)
    assert one.backend is None
    with pytest.raises(ValueError, match="tensors are on the cpu"):
        run_sharded(one, state, gr, 3, capture=True)
    want, wz = run_sharded(one, state, gr, 40)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        mesh = make_local_mesh(device_type="cpu")
        step = make_sharded_step(mesh, data_axes(mesh), graph.n, pcfg, partitionable=PART)
        assert step.backend == "gloo"
        with pytest.raises(ValueError, match="gloo's, which do not capture"):
            run_sharded(step, state, gr, 3, capture=True)
        got, z = run_sharded(step, state, gr, 40)
    finally:
        dist.destroy_process_group()
    assert torch.equal(z, wz)
    for f in ShardedProtocolState._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
