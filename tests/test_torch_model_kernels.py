"""The port's attention and SSD kernels, held to the TPU kernels they
replace, on the CPU.

The same numpy-seeded inputs go through the JAX package's Pallas kernels
in interpret mode (``flash_attention`` / ``attention_pallas``,
``ssd_intra_chunk`` / ``ssd_pallas``) or its oracles (``mha_ref``,
``ssd_chunked``), and through the port's plain versions and model-layout
wrappers, which run the plain versions for CPU tensors. Tolerances are
the reference's own kernel tests' (``tests/test_kernels.py``): 2e-4 for
f32 attention, 3e-2 for bf16, 3e-4 for SSD. The CUDA kernels themselves
are held against these plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.kernels.ops import attention_pallas as jattention_pallas  # noqa: E402
from repro.kernels.ops import ssd_pallas as jssd_pallas  # noqa: E402
from repro.kernels.ssd_scan import ssd_intra_chunk as jssd_intra  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    attention_pallas,
    flash_attention,
    flash_attention_plain,
    ssd_intra_chunk,
    ssd_intra_chunk_plain,
    ssd_pallas,
)


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


def _qkv(seed, B, S, H, KV, D, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(dtype) for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))


def _t(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t):
    return t.float().numpy()


_mha_ref = jax.jit(jref.mha_ref, static_argnames=("window", "causal"))


@pytest.mark.parametrize("S,H,KV,D", [(128, 4, 4, 32), (256, 8, 2, 64), (256, 6, 1, 32)])
@pytest.mark.parametrize("window", [0, 96])
def test_flash_attention_matches_reference(S, H, KV, D, window):
    q, k, v = _qkv(S * H + window, 2, S, H, KV, D)
    want = np.asarray(_mha_ref(q, k, v, window=window))
    plain = flash_attention_plain(_t(q), _t(k), _t(v), window)
    np.testing.assert_allclose(_np(plain), want, rtol=2e-4, atol=2e-4)
    wrapped = attention_pallas(_t(q), _t(k), _t(v), window=window)
    np.testing.assert_allclose(_np(wrapped), want, rtol=2e-4, atol=2e-4)
    if S == 128:  # the Pallas kernel itself, interpret mode, (B, H, S, D) layout
        tr = lambda a: jnp.swapaxes(jnp.asarray(a), 1, 2)  # noqa: E731
        pallas = np.swapaxes(np.asarray(jflash(tr(q), tr(k), tr(v), window=window,
                                               interpret=True)), 1, 2)
        np.testing.assert_allclose(_np(plain), pallas, rtol=2e-4, atol=2e-4)


def test_flash_attention_bf16():
    q, k, v = _qkv(77, 1, 128, 4, 2, 32, ml_dtypes.bfloat16)
    want = np.asarray(jattention_pallas(q, k, v, interpret=True), np.float32)
    got = flash_attention(_t(q), _t(k), _t(v))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), want, rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(_np(got), np.asarray(jref.mha_ref(q, k, v), np.float32),
                               rtol=3e-2, atol=3e-2)


def test_flash_attention_rejects_bad_shapes():
    q = torch.zeros((1, 128, 4, 32))
    k = torch.zeros((1, 128, 3, 32))
    with pytest.raises(ValueError, match="multiple of KV"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="multiple of KV"):
        jflash(jnp.zeros((1, 4, 128, 32)), jnp.zeros((1, 3, 128, 32)), jnp.zeros((1, 3, 128, 32)))
    q = torch.zeros((1, 192, 4, 32))  # longer than a block and not a multiple of it
    with pytest.raises(ValueError, match="multiple of the block"):
        flash_attention(q, q[:, :, :2].contiguous(), q[:, :, :2].contiguous())
    q = torch.zeros((1, 128, 4, 32))
    with pytest.raises(TypeError):
        flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, q[:, :, :2], q[:, :, :2].contiguous())


def _ssd_inputs(seed, B, L, H, P, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(H)).astype(np.float32)
    b_in = rng.standard_normal((B, L, N)).astype(np.float32)
    c_in = rng.standard_normal((B, L, N)).astype(np.float32)
    return x, dt, a, b_in, c_in


@pytest.mark.parametrize("L,H,P,N,chunk,bf16", [
    pytest.param(128, 2, 16, 8, 64, False, id="128-2-16-8-64"),
    pytest.param(256, 4, 32, 16, 128, False, id="256-4-32-16-128"),
    # the served dtype: B / C rounded to bf16 for both packages (the plain
    # version is the CUDA kernel's oracle on the card in that dtype too)
    pytest.param(128, 2, 16, 8, 64, True, id="128-2-16-8-64-bf16"),
    pytest.param(256, 4, 32, 16, 128, True, id="256-4-32-16-128-bf16"),
])
def test_ssd_matches_reference(L, H, P, N, chunk, bf16):
    x, dt, a, b_in, c_in = _ssd_inputs(L * H, 2, L, H, P, N)
    if bf16:
        b_in, c_in = b_in.astype(ml_dtypes.bfloat16), c_in.astype(ml_dtypes.bfloat16)
    # the kernel's own inputs, as ssd_pallas prepares them
    B, nc = 2, L // chunk
    da_cs = np.cumsum((dt * a).reshape(B, nc, chunk, H), axis=2)
    xdt = (x * dt[..., None]).reshape(B, nc, chunk, H, P)
    bc, cc = b_in.reshape(B, nc, chunk, N), c_in.reshape(B, nc, chunk, N)
    y_want, st_want = jssd_intra(xdt, da_cs, bc, cc, interpret=True)
    for fn in (ssd_intra_chunk_plain, ssd_intra_chunk):
        y, st = fn(_t(xdt), _t(da_cs), _t(bc), _t(cc))
        np.testing.assert_allclose(y.numpy(), np.asarray(y_want), rtol=3e-4, atol=3e-4)
        np.testing.assert_allclose(st.numpy(), np.asarray(st_want), rtol=3e-4, atol=3e-4)
    # the model-layout wrapper: intra-chunk block + inter-chunk recurrence
    y_want, st_want = jssd_pallas(x, dt, a, b_in, c_in, chunk=chunk, interpret=True)
    y, st = ssd_pallas(*map(_t, (x, dt, a, b_in, c_in)), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_want), rtol=3e-4, atol=3e-4)


def test_ssd_rejects_bad_shapes():
    x, dt, a, b_in, c_in = map(_t, _ssd_inputs(0, 1, 96, 2, 16, 8))
    with pytest.raises(ValueError, match="chunk"):
        ssd_pallas(x, dt, a, b_in, c_in, chunk=64)
    xdt = x.reshape(1, 1, 96, 2, 16)
    da = torch.zeros((1, 1, 96, 2))
    bc = b_in.reshape(1, 1, 96, 8)
    with pytest.raises(TypeError):
        ssd_intra_chunk(xdt.double(), da, bc, bc)
    with pytest.raises(ValueError, match="shape"):
        ssd_intra_chunk(xdt, da, bc, bc[:, :, :, :4].contiguous())
