"""The port's three round kernels, held to the TPU kernels they replace.

On the CPU each wrapper runs its plain PyTorch version; these tests feed
the same numpy-seeded inputs to it and to the JAX package's Pallas
kernel in interpret mode (``whole_round_pallas``, ``round_update_pallas``,
``theta_sums``), including a node count that is not a multiple of the
Pallas tile (n = 19), and require every output bitwise. The CUDA
kernels themselves are held against these plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.graphs.generators import erdos_renyi_graph  # noqa: E402
from repro.kernels import theta_survival as jts  # noqa: E402
from repro.kernels.round_update import (  # noqa: E402
    random_round_inputs,
    round_update_pallas,
    whole_round_pallas,
)
from repro_torch.kernels import (  # noqa: E402
    round_update,
    theta_sums,
    whole_round,
)

BATCH = 2


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


def _obs_batch(n, C=16, B=64, W=16, seed=0):
    """``random_round_inputs`` rows stacked into a batch (numpy)."""
    rows = [
        [np.asarray(a) for a in random_round_inputs(jax.random.key(seed + b), n, C, B, W)]
        for b in range(BATCH)
    ]
    out = [np.stack([r[i] for r in rows]) for i in range(9)]
    assert C * out[2].max() < 2**24  # the node-sum's exact-integer condition
    return out


def _torch(arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]


@pytest.mark.parametrize("n", [19, 16])
def test_round_update_matches_pallas(n):
    arrs = _obs_batch(n)
    got = round_update(*_torch(arrs))
    for b in range(BATCH):
        want = round_update_pallas(*[jnp.asarray(a[b]) for a in arrs], interpret=True)
        for name, w, g in zip(("last_seen", "hist", "total", "sums"), want, got):
            np.testing.assert_array_equal(np.asarray(w), g[b].numpy(), err_msg=name)


@pytest.mark.parametrize("n", [19, 16])
def test_theta_sums_matches_pallas(n):
    ls, hist, total, *_rest, t = _obs_batch(n, seed=5)
    got = theta_sums(*_torch((ls, hist, total, t)))
    for b in range(BATCH):
        want = jts.theta_sums(jnp.asarray(ls[b]), jnp.asarray(hist[b]), jnp.asarray(total[b]),
                              jnp.int32(t[b]), interpret=True)
        np.testing.assert_array_equal(np.asarray(want), got[b].numpy())


def _whole_round_inputs(n, seed, K=2, W=16, C=16, B=64, crowded=False):
    """A churny whole round: partial topology masks, live rates, a firing
    burst, a Byzantine and a Pac-Man node (numpy, batched). ``crowded``
    starts every walk on one of 3 nodes, so many slots share a row."""
    g = erdos_renyi_graph(n, seed=1)
    D = g.max_degree
    rng = np.random.default_rng(seed)
    ls, hist, total, pos, track, _r, _v, _u, t = _obs_batch(n, C, B, W, seed)
    if crowded:  # nodes where both a fork and a termination fire
        pos = np.random.default_rng(0).choice([0, 1, 9], pos.shape).astype(np.int32)
    f32 = lambda *s: rng.random(s).astype(np.float32)  # noqa: E731
    params_f = np.array([[0.05, 0.1, 0.1, 0.3, 0.4, 7.0, 8.0, 0.5]] * BATCH, np.float32)
    params_i = np.array([[70, 2, 4, 1], [70, -1, -1, 1]], np.int32)
    return dict(
        last_seen=ls, hist=hist, total=total,
        node_up=rng.random((BATCH, n)) < 0.85, edge_up=rng.random((BATCH, n, D)) < 0.85,
        pos=pos, track=track, active=rng.random((BATCH, W)) < 0.8,
        neighbors=g.neighbors.astype(np.int32), degrees=g.degrees.astype(np.int32),
        u_move=f32(BATCH, W), u_pfail=f32(BATCH, W), u_fork=f32(BATCH, W), u_term=f32(BATCH, W),
        u_burst=f32(BATCH, K, W), burst_sizes_eff=np.array([[3, 0], [1, 2]], np.int32),
        u_nfail=f32(BATCH, n), u_nrec=f32(BATCH, n), sched_down=rng.random((BATCH, n)) < 0.05,
        e_fail=f32(BATCH, n, D), e_rec=f32(BATCH, n, D),
        params_f=params_f, params_i=params_i,
    )


WHOLE_OUT = ("last_seen", "hist", "total", "node_up", "edge_up", "pos", "active", "theta",
             "chosen", "fork", "term")


@pytest.mark.parametrize("plus,crowded", [
    pytest.param(False, False, id="False"), pytest.param(True, False, id="True"),
    pytest.param(False, True, id="crowded-False"), pytest.param(True, True, id="crowded-True"),
])
def test_whole_round_matches_pallas(plus, crowded):
    x = _whole_round_inputs(19, seed=3, crowded=crowded)
    got = whole_round(*_torch(x.values()), decafork_plus=plus)
    nbr = x["neighbors"]
    for b in range(BATCH):
        p = x["pos"][b]
        j = lambda k: jnp.asarray(x[k][b])  # noqa: E731
        want = whole_round_pallas(
            j("last_seen"), j("hist"), j("total"), j("node_up"), j("edge_up"),
            j("pos"), j("track"), j("active"), jnp.asarray(nbr[p]),
            jnp.asarray(x["degrees"][p]), jnp.asarray(x["edge_up"][b][p]),
            jnp.asarray(x["e_fail"][b][p]), jnp.asarray(x["e_rec"][b][p]),
            j("u_move"), j("u_pfail"), j("u_fork"), j("u_term"), j("u_burst"),
            j("burst_sizes_eff"), j("u_nfail"), j("u_nrec"), j("sched_down"),
            j("e_fail"), j("e_rec"), j("params_f")[None], j("params_i")[None],
            decafork_plus=plus, interpret=True,
        )
        for name, w, g in zip(WHOLE_OUT, want, got):
            np.testing.assert_array_equal(np.asarray(w), g[b].numpy(), err_msg=name)
    assert got[9].any() and (got[10].any() or not plus)  # the fixture decides


def test_wrapper_rejects_mixed_devices():
    x = _torch(_obs_batch(19))
    x[0] = x[0].to("meta")
    with pytest.raises(ValueError, match="one device"):
        round_update(*x)
