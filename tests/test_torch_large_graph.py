"""A fused round on a graph larger than one thread block's shared memory
once held: n 262,144 on a Cayley graph, the reference's production W 64,
on the CPU, against the live JAX package.

``round_impl="auto"`` resolves to the port's fused round (the
whole_round kernel on the card, its plain version here). Up to this
slice the kernel kept ``node_up`` in shared memory, ``n + 18 W + 4``
bytes a block, which at W 64 passes the H100's 227 KB above about
231,000 nodes; its topology pass is now a node-tiled launch of its own,
so any n runs (the card tests hold the kernel bitwise its plain version
at n 262,144 and 1,048,576). Here the port's ``Plan.run`` is held to the
reference's ``round_impl="unfused", estimator_impl="compare"`` run (the
oracle of ``whole_round_pallas``) from the same key: integer outputs and
the final carry bitwise, ``theta_mean`` within 1e-6. The bins are cut to
64 (the production's 512 would cost the reference's compare estimator,
which scans every node's histogram, ~4 s a round here) and the degree to
4; decisions start at round 0, so forks fire in the 4 rounds, and node
and link churn runs over the whole graph."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import failures as jflr  # noqa: E402
from repro.core import protocol as jprt  # noqa: E402
from repro.core.outputs import FULL as JFULL  # noqa: E402
from repro.core.simulator import _graph_arrays, _run_core  # noqa: E402
from repro.graphs.generators import Graph as RefGraph  # noqa: E402
from repro_torch.api import Experiment  # noqa: E402
from repro_torch.core.failures import FailureConfig  # noqa: E402
from repro_torch.core.protocol import ProtocolConfig  # noqa: E402
from repro_torch.graphs.generators import Graph  # noqa: E402

PART = bool(jax.config.jax_threefry_partitionable)
N, DEGREE, STEPS = 262_144, 4, 4
PROTOCOL = dict(algorithm="decafork+", z0=16, max_walks=64, eps=4.0, eps2=11.0, rt_bins=64,
                protocol_start=0)
CHURN = dict(p_fail=0.01, p_node_fail=0.001, p_node_recover=0.3, p_link_fail=0.002,
             p_link_recover=0.4, burst_times=(2,), burst_sizes=(3,))
INT_FIELDS = ("z", "forks", "terms", "failures", "fork_parent", "terminated")
CARRY = ("t", "walks.pos", "walks.active", "walks.track", "last_seen", "rts.hist",
         "rts.total", "byz_state", "graph.node_up", "graph.edge_up")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cayley(n, degree, seed=0):
    """Node i joins i +- o_k for ``degree / 2`` offsets coprime with n
    (connected), in O(n D): ``make_graph`` fills a dense n x n adjacency."""
    rng = np.random.default_rng(seed)
    while True:
        offs = rng.choice(np.arange(1, n // 2), degree // 2, replace=False)
        if np.gcd.reduce(np.append(offs, n)) == 1:
            break
    i = np.arange(n)[:, None]
    return np.concatenate([(i + offs) % n, (i - offs) % n], axis=1).astype(np.int32)


def _field(state, path):
    for part in path.split("."):
        state = getattr(state, part)
    return np.asarray(state)


@pytest.fixture(scope="module")
def nbrs():
    return _cayley(N, DEGREE)


@pytest.fixture(scope="module")
def reference(nbrs):
    g = RefGraph(n=N, neighbors=nbrs, degrees=np.full(N, DEGREE, np.int32), family="cayley")
    pcfg = jprt.ProtocolConfig(**PROTOCOL, estimator_impl="compare", round_impl="unfused")
    nbr, deg, mir, pi = _graph_arrays(g, pcfg)
    final, rec = jax.jit(jax.vmap(lambda k: _run_core(
        k, nbr, deg, mir, pi, pcfg, jflr.FailureConfig(**CHURN), STEPS, N, spec=JFULL
    )))(jax.random.key(0)[None])
    return ({f: _field(final, f)[0] for f in CARRY},
            {f: np.asarray(v)[0] for f, v in rec._asdict().items()})


@pytest.fixture(scope="module")
def port(nbrs):
    g = Graph(n=N, neighbors=nbrs, degrees=np.full(N, DEGREE, np.int32), family="cayley")
    exp = Experiment(graph=g, protocol=ProtocolConfig(**PROTOCOL, estimator_impl="auto"),
                     failures=FailureConfig(**CHURN), steps=STEPS, outputs="full",
                     device="cpu", partitionable=PART)
    (_, _, decision), = exp.plan().round_decisions()
    final, rec = exp.run(0)
    return decision, ({f: _field(final, f)[0] for f in CARRY},
                      {f: v.numpy() for f, v in rec._asdict().items()})


def test_auto_resolves_to_the_fused_round(port):
    assert port[0].fused and port[0].backend == "kernel"


def test_integer_outputs_bitwise_reference(port, reference):
    got, want = port[1][1], reference[1]
    for f in INT_FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    np.testing.assert_allclose(got["theta_mean"], want["theta_mean"], rtol=1e-6, atol=1e-6)
    assert want["forks"].sum() > 0 and want["failures"].sum() > 0  # decisions and kills fired


@pytest.mark.parametrize("field", CARRY)
def test_final_carry_bitwise_reference(port, reference, field):
    np.testing.assert_array_equal(port[1][0][field], reference[0][field], err_msg=field)


def test_topology_churned_over_the_whole_graph(reference):
    """Node and link churn struck across the graph, beyond the first
    ~231,000 nodes the old kernel could hold."""
    node_up, edge_up = reference[0]["graph.node_up"], reference[0]["graph.edge_up"]
    assert not node_up[231_000:].all() and not edge_up[231_000:].all()
