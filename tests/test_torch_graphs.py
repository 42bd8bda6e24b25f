"""The port's graphs are the reference's: identical neighbors, degrees
and mirror indices for the families and sizes the tests and benchmarks
use, and the same availability masks under live topology."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.graphs import generators as jgen  # noqa: E402
from repro.graphs import state as jstate  # noqa: E402
from repro_torch.graphs import generators as tgen  # noqa: E402
from repro_torch.graphs import state as tstate  # noqa: E402

CASES = [
    ("regular", 100, 0, dict(degree=8)),
    ("regular", 40, 3, dict(degree=4)),
    ("regular", 16, 1, dict(degree=4)),
    ("erdos_renyi", 19, 0, {}),
    ("erdos_renyi", 40, 2, {}),
    ("ring", 12, 0, {}),
    ("torus", 32, 0, dict(rows=4, cols=8)),
    ("complete", 9, 0, {}),
    ("power_law", 30, 1, {}),
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


@pytest.mark.parametrize("family,n,seed,kw", CASES)
def test_graph_and_mirror_identical(family, n, seed, kw):
    jg = jgen.make_graph(family, n, seed=seed, **kw)
    tg = tgen.make_graph(family, n, seed=seed, **kw)
    assert (jg.n, jg.family) == (tg.n, tg.family)
    np.testing.assert_array_equal(jg.neighbors, tg.neighbors)
    np.testing.assert_array_equal(jg.degrees, tg.degrees)
    np.testing.assert_array_equal(jstate.mirror_indices(jg), tstate.mirror_indices(tg))


def test_availability_matches_reference():
    rng = np.random.default_rng(5)
    g = tgen.make_graph("erdos_renyi", 19, seed=0)
    nbr = torch.as_tensor(g.neighbors)
    deg = torch.as_tensor(g.degrees)
    node_up = rng.random((3, g.n)) < 0.8
    edge_up = rng.random((3, g.n, g.max_degree)) < 0.7
    got = tstate.availability(
        tstate.GraphState(torch.as_tensor(node_up), torch.as_tensor(edge_up)), nbr, deg
    )
    for b in range(3):
        want = jstate.availability(
            jstate.GraphState(jnp.asarray(node_up[b]), jnp.asarray(edge_up[b])),
            jnp.asarray(g.neighbors), jnp.asarray(g.degrees),
        )
        np.testing.assert_array_equal(np.asarray(want), got[b].numpy())
