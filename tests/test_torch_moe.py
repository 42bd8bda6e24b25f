"""The port's MoE layer and MLA (``repro_torch.models.moe``) held to the
JAX package on the CPU.

The dbrx-132b and deepseek-v2-236b smoke configs, with the reference's
weights (``Model.init``, seed 3) carried across by
``convert.model_params_from_arrays``; numpy-seeded inputs. ``moe_apply``
within 2e-4 (its output and aux loss), over global and grouped dispatch,
shared experts and a capacity that drops tokens. The integer routing
(each pair's expert and slot) is the reference's exactly, wherever the
gap between a token's k-th and (k+1)-th router probability exceeds 1e-6
(two matrix products may order a closer pair either way; a flipped pair
moves the slots of its experts' later pairs, so slots are compared up to
each group's first near tie). MLA's projections, and the absorbed decode
against the reference's and against the port's own naive decode, within
2e-4.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import model_params_from_arrays  # noqa: E402
from repro_torch.models import layers, moe  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
NEAR_TIE = 1e-6
ARCHS = ("dbrx_132b", "deepseek_v2_236b")
B, S = 2, 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def weights():
    """Per arch: layer 0 of the reference's weights (seed 3) and of the
    port's, converted from them."""
    out = {}
    for arch in ARCHS:
        jparams = jax.jit(JModel(jget_smoke_config(arch)).init)(jax.random.key(3))
        params = model_params_from_arrays(_flat(jparams), get_smoke_config(arch), "cpu")
        out[arch] = (jax.tree.map(lambda a: a[0], jparams["layers"]), params.layers[0])
    return out


def _x(cfg, seed, b=B, s=S):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _close(want, got):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **TOL)


def _ref_routing(p, xf, cfg, C):
    """The reference's routing (``moe.py::_moe_tokens``'s lines, which
    it does not return) for one token group: expert ids (T, k), each
    pair's slot in pair order (T, k), C where dropped, and each token's
    top-k probability margin."""
    T = xf.shape[0]
    k, E = cfg.moe_top_k, cfg.moe_num_experts
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xf.astype(jnp.float32), p["router"]), axis=-1)
    top, expert_idx = jax.lax.top_k(probs, k + 1)
    flat_e = expert_idx[:, :k].reshape(T * k)
    order = jnp.argsort(flat_e, stable=True)
    counts = jnp.bincount(flat_e, length=E)
    starts = jnp.cumsum(counts) - counts
    rank = jnp.arange(T * k, dtype=jnp.int32) - starts[flat_e[order]]
    slot = jnp.zeros(T * k, jnp.int32).at[order].set(jnp.where(rank < C, rank, C))
    return expert_idx[:, :k], slot.reshape(T, k), top[:, k - 1] - top[:, k]


# (arch, overrides): global sort, grouped dispatch, a capacity that drops
# tokens, and both at once; deepseek-v2 with its shared expert
MOE_CASES = [
    ("dbrx_132b", {}), ("dbrx_132b", dict(moe_groups=2)),
    ("dbrx_132b", dict(capacity_factor=0.5)),
    ("dbrx_132b", dict(moe_groups=4, capacity_factor=0.5)),
    ("deepseek_v2_236b", {}), ("deepseek_v2_236b", dict(moe_groups=2, capacity_factor=0.5)),
]


@pytest.mark.parametrize("arch,over", MOE_CASES,
                         ids=[f"{a}-{'-'.join(f'{k}{v}' for k, v in o.items()) or 'global'}"
                              for a, o in MOE_CASES])
def test_moe_apply_matches_reference(weights, arch, over):
    jlp, lp = weights[arch]
    jcfg, cfg = jget_smoke_config(arch, **over), get_smoke_config(arch, **over)
    x = _x(cfg, 1)
    T = B * S
    G = cfg.moe_groups if cfg.moe_groups > 1 else 1
    C = moe.moe_capacity(T // G, cfg)
    assert C == jmoe.moe_capacity(T // G, jcfg)

    def ref(p, x):
        y, aux = jmoe.moe_apply(p, x, jcfg)
        xg = x.reshape(G, T // G, -1)
        return (y, aux, *jax.vmap(lambda xx: _ref_routing(p, xx, jcfg, C))(xg))

    want_y, want_aux, want_e, want_slot, margin = jax.jit(ref)(jlp["moe"], x)
    y, aux = moe.moe_apply(lp["moe"], torch.from_numpy(x), cfg)
    _, expert_idx, slot, _ = moe.moe_routing(lp["moe"], torch.from_numpy(x).reshape(G, T // G, -1),
                                             cfg, C)
    clear = np.asarray(margin) > NEAR_TIE  # (G, T / G)
    np.testing.assert_array_equal(expert_idx.numpy()[clear], np.asarray(want_e)[clear])
    want_slot = np.asarray(want_slot)
    for g in range(G):
        upto = int(np.argmin(clear[g])) if not clear[g].all() else T // G
        np.testing.assert_array_equal(slot[g, :upto].numpy(), want_slot[g, :upto])
    assert (want_slot == C).any() == ("capacity_factor" in over)  # the drop cases drop
    if clear.all():
        _close(want_y, y)
    _close(want_aux, aux)
    assert aux.dtype == torch.float32 and aux.shape == ()


def test_moe_capacity_is_the_reference_expression():
    for arch in ARCHS:
        for cf in (0.5, 1.0, 1.25, 2.0):
            jcfg, cfg = (jget_smoke_config(arch, capacity_factor=cf),
                         get_smoke_config(arch, capacity_factor=cf))
            for tokens in (1, 4, 7, 64, 100, 128, 2048, 12_345):
                assert moe.moe_capacity(tokens, cfg) == jmoe.moe_capacity(tokens, jcfg)


@pytest.mark.parametrize("q_lora", [True, False])
def test_mla_projections_match_reference(weights, q_lora):
    """``mla_project_q`` (with and without the query's low-rank path),
    ``mla_compress_kv`` and ``mla_decompress``."""
    jcfg, cfg = jget_smoke_config("deepseek_v2_236b"), get_smoke_config("deepseek_v2_236b")
    if q_lora:
        jp, p = weights["deepseek_v2_236b"][0]["attn"], weights["deepseek_v2_236b"][1]["attn"]
    else:  # weights drawn for q_lora_rank 0 (a wq in place of wdq / q_norm / wuq)
        jcfg = dataclasses.replace(jcfg, q_lora_rank=0)
        cfg = dataclasses.replace(cfg, q_lora_rank=0)
        jp = jax.jit(lambda k: jmoe.mla_init(k, jcfg, jnp.float32))(jax.random.key(5))
        p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
        assert "wq" in p and "wuq" not in p
    x = _x(cfg, 2)

    def run(M, p, x, c):
        q_nope, q_rope = M.mla_project_q(p, x, c)
        ckv, kr = M.mla_compress_kv(p, x, c)
        return (q_nope, q_rope, ckv, kr, *M.mla_decompress(p, ckv))

    want = jax.jit(lambda p, x: run(jmoe, p, x, jcfg))(jp, x)
    got = run(moe, p, torch.from_numpy(x), cfg)
    for w, g in zip(want, got):
        _close(w, g)
    hd, rr, H = cfg.head_dim, cfg.rope_head_dim, cfg.num_heads
    assert got[0].shape == (B, S, H, hd) and got[1].shape == (B, S, H, rr)


def test_mla_decode_absorbed_matches_reference_and_naive_decode(weights):
    """The absorbed decode against the reference's, and against the
    naive decode (the cache decompressed, the rope key broadcast, one
    ``decode_attention``): the same function by associativity."""
    jp, p = weights["deepseek_v2_236b"][0]["attn"], weights["deepseek_v2_236b"][1]["attn"]
    jcfg, cfg = jget_smoke_config("deepseek_v2_236b"), get_smoke_config("deepseek_v2_236b")
    rng = np.random.default_rng(4)
    H, hd, rr, r, T = cfg.num_heads, cfg.head_dim, cfg.rope_head_dim, cfg.kv_lora_rank, 40
    q_nope = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    q_rope = rng.standard_normal((B, 1, H, rr)).astype(np.float32)
    ckv = rng.standard_normal((B, T, r)).astype(np.float32)
    kr = rng.standard_normal((B, T, rr)).astype(np.float32)
    cache_pos = np.where(np.arange(T) < 30, np.arange(T), -1).astype(np.int32)
    cache_pos = np.broadcast_to(cache_pos, (B, T)).copy()
    pos = np.array([29, 17], np.int32)
    valid = (cache_pos >= 0) & (cache_pos <= pos[:, None])
    args = (q_nope, q_rope, ckv, kr, valid)
    want = jax.jit(lambda p, *a: jmoe.mla_decode_absorbed(p, *a, jcfg))(jp, *args)
    got = moe.mla_decode_absorbed(p, *map(torch.from_numpy, args), cfg)
    _close(want, got)
    assert got.shape == (B, 1, H, hd)
    k_nope, v = moe.mla_decompress(p, torch.from_numpy(ckv))
    k = torch.cat([k_nope, torch.from_numpy(kr)[:, :, None].expand(B, T, H, rr)], dim=-1)
    q = torch.cat([torch.from_numpy(q_nope), torch.from_numpy(q_rope)], dim=-1)
    naive = layers.decode_attention(q, k, v, torch.from_numpy(cache_pos), torch.from_numpy(pos))
    torch.testing.assert_close(got, naive, **TOL)
