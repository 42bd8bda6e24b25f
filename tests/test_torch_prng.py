"""The port's threefry (``repro_torch.utils.prng``) is bitwise live
``jax.random``: keys, split, fold_in, fold_in_time, float32 uniform and
int32 randint, under whichever threefry layout this JAX uses."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.utils.prng import fold_in_time as jax_fold_in_time  # noqa: E402
from repro_torch.utils import prng  # noqa: E402

PART = bool(jax.config.jax_threefry_partitionable)
SEEDS = (0, 1, 7, 42, 12345, 2**31 - 1)


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


def _data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.int32) if a.dtype == np.float32 else a,
                                  b.view(np.int32) if b.dtype == np.float32 else b)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    jk, tk = jax.random.key(seed), prng.key(seed)
    np.testing.assert_array_equal(_data(jk), tk.numpy())
    for num in (1, 2, 3, 4, 50):
        np.testing.assert_array_equal(
            _data(jax.random.split(jk, num)), prng.split(tk, num, partitionable=PART).numpy()
        )
    for d in (0, 5, 2**31 + 3):
        np.testing.assert_array_equal(_data(jax.random.fold_in(jk, d)), prng.fold_in(tk, d).numpy())


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shape", [(), (1,), (7,), (16,), (19, 8), (2, 3, 5)])
def test_uniform_and_randint(seed, shape):
    jk, tk = jax.random.key(seed), prng.key(seed)
    _bits_equal(jax.random.uniform(jk, shape), prng.uniform(tk, shape, partitionable=PART))
    for lo, hi in ((0, 19), (0, 100), (-1, 70), (3, 3)):
        got = prng.randint(tk, shape, lo, hi, partitionable=PART)
        _bits_equal(jax.random.randint(jk, shape, lo, hi, dtype=jnp.int32), got)


def test_fold_in_time_tags_and_batched_keys():
    """Batched keys (the Plan's ``split(key(base), seeds)``) and a tensor
    of tags draw every stream's key in one call, bitwise per element."""
    base = 11
    jkeys = jax.random.split(jax.random.key(base), 5)
    tkeys = prng.split(prng.key(base), 5, partitionable=PART)
    np.testing.assert_array_equal(_data(jkeys), tkeys.numpy())
    t = torch.tensor([0, 3, 17, 40, 9000], dtype=torch.int32)
    tags = torch.arange(8).view(8, 1)
    got = prng.fold_in_time(tkeys, t, tags)  # (8, 5, 2)
    for s in range(5):
        for tag in range(8):
            want = _data(jax_fold_in_time(jkeys[s], int(t[s]), tag))
            np.testing.assert_array_equal(got[tag, s].numpy(), want)
    u = prng.uniform(got, (16,), partitionable=PART)
    want = jax.vmap(jax.vmap(lambda k: jax.random.uniform(k, (16,))))(
        jax.random.wrap_key_data(got.numpy().astype(np.uint32))
    )
    _bits_equal(want, u)


def test_randint_many_keys():
    """``init_walks``' draw: randint over a batch of keys."""
    keys = prng.split(prng.key(3), 6, partitionable=PART)
    got = prng.randint(keys, (64,), 0, 100, partitionable=PART)
    jkeys = jax.random.split(jax.random.key(3), 6)
    want = jax.vmap(lambda k: jax.random.randint(k, (64,), 0, 100, dtype=jnp.int32))(jkeys)
    _bits_equal(want, got)
