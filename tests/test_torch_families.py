"""The families the port serves beside dense and ssm, held to the JAX
package on the CPU: moe (dbrx-132b; deepseek-v2-236b with MLA, its decode
naive and absorbed), hybrid (hymba-1.5b), audio (musicgen-large's
codebooks) and vlm (qwen2-vl-2b's M-RoPE and vision prefix).

On each smoke config: the parameter layout equals the reference's
``Model.init`` leaf for leaf, and the port's ``Model.init`` draws its
weights within 4 float32 ulp; with the reference's weights carried
across by ``convert``, greedy ``generate`` is token for token the
reference's (hymba with ``ssd_chunk=32``, two chunks). M-RoPE's position
streams and rotation, and ``batch_spec`` for every family. Inputs are
numpy-seeded. The prefill and decode steps of the same models:
``tests/test_torch_families_prefill.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import model_params_from_arrays, params_tree_from_arrays  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.transformer import param_shapes  # noqa: E402
from repro_torch.utils import prng  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

PART = bool(jax.config.jax_threefry_partitionable)
TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ("dbrx_132b", "deepseek_v2_236b", "hymba_1_5b", "musicgen_large", "qwen2_vl_2b")
B, S = 2, 64  # S counts the vlm's vision prefix


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix="", leaf=np.asarray):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}.", leaf))
        else:
            out[prefix + k] = leaf(v)
    return out


def _cfgs(arch, **over):
    if arch == "hymba_1_5b":
        over.setdefault("ssd_chunk", 32)  # two chunks at S = 64
    return jget_smoke_config(arch, **over), get_smoke_config(arch, **over)


@pytest.fixture(scope="module")
def weights():
    """Reference weights per arch (seed 3), flattened to numpy."""
    out = {}
    for arch in ARCHS:
        jparams = jax.jit(JModel(_cfgs(arch)[0]).init)(jax.random.key(3))
        out[arch] = (jparams, _flat(jparams))
    return out


def _tokens(cfg, rng, b, s):
    nq = cfg.num_codebooks
    return rng.integers(0, cfg.vocab_size, (b, s) + ((nq,) if nq else ())).astype(np.int32)


def _batch(cfg, seed, b=B, s=S):
    """A prefill batch as numpy: token ids (b, s[, nq]); for the vlm
    s - vision_tokens text ids and the vision embeddings."""
    rng = np.random.default_rng(seed)
    text = s - cfg.vision_tokens if cfg.arch_type == "vlm" else s
    out = {"tokens": _tokens(cfg, rng, b, text)}
    if cfg.arch_type == "vlm":
        out["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_tokens, transformer.VISION_EMBED_DIM)).astype(np.float32)
    return out


def _close(want, got):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **TOL)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_and_init_match_reference(arch, weights):
    """``param_shapes`` is the reference's ``jax.eval_shape(Model.init)``
    leaf for leaf; the port's own ``Model.init`` draws the reference's
    weights within 4 ulp (``normal``'s erf_inv), in the key order of
    ``block_init`` / ``moe_init`` / ``mla_init`` / ``embed_init``."""
    jcfg, cfg = _cfgs(arch)
    want = _flat(jax.eval_shape(JModel(jcfg).init, jax.random.key(0)), leaf=lambda a: a)
    L = cfg.num_layers
    expect = {}
    for path, a in want.items():
        parts = path.split(".")
        dt = getattr(torch, str(a.dtype))
        if parts[0] == "layers":
            for i in range(L):
                expect[".".join(["layers", str(i)] + parts[1:])] = (tuple(a.shape[1:]), dt)
        else:
            expect[path] = (tuple(a.shape), dt)
    assert param_shapes(cfg) == expect

    _, flat = weights[arch]
    tree = params_tree_from_arrays(flat, cfg, "cpu")  # every leaf crosses, as a tree too
    converted = Model.params_tree(model_params_from_arrays(flat, cfg, "cpu"))
    leaves, want_leaves = tree_leaves(tree), tree_leaves(converted)
    assert len(leaves) == len(want_leaves) == len(flat)
    assert all(torch.equal(a, b) for a, b in zip(leaves, want_leaves))
    got = Model(cfg).init(prng.key(3), "cpu", partitionable=PART).state_dict()
    assert {k: (tuple(t.shape), t.dtype) for k, t in got.items()} == expect
    for path, w in flat.items():
        parts = path.split(".")
        for i in range(L) if parts[0] == "layers" else [None]:
            name = path if i is None else ".".join(["layers", str(i)] + parts[1:])
            ww = w if i is None else w[i]
            ulp = np.abs(ww.view(np.int32).astype(np.int64) - got[name].numpy().view(np.int32))
            assert ulp.max() <= 4, name


# ---------------------------------------------------------------------------
# positions
# ---------------------------------------------------------------------------


def test_mrope_and_position_streams_match_reference():
    """``make_pos_info``'s three streams (vision grid, then text), and
    ``apply_mrope`` on them and on a decode position, where the three
    streams move together."""
    jcfg, cfg = _cfgs("qwen2_vl_2b")
    rng = np.random.default_rng(6)
    H, hd = cfg.num_heads, cfg.head_dim
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    xt = x[:, :1]
    pos = np.array([S + 3, S + 11], np.int32)

    def run(L, T, x, xt, pos, c):
        info = T.make_pos_info(c, B, S) if T is jtransformer else T.make_pos_info(c, B, S, "cpu")
        g = max(int(np.ceil(np.sqrt(c.vision_tokens))), 1)
        p3 = pos - c.vision_tokens + g
        p3 = (jnp.broadcast_to(p3[None, :, None], (3, B, 1)) if T is jtransformer
              else p3[None, :, None].expand(3, B, 1))
        return (info["positions"], info["positions3"],
                L.apply_mrope(x, info["positions3"], c.rope_theta, c.mrope_sections),
                L.apply_mrope(xt, p3, c.rope_theta, c.mrope_sections))

    want = jax.jit(lambda *a: run(jlayers, jtransformer, *a, jcfg))(x, xt, pos)
    got = run(layers, transformer, *map(torch.from_numpy, (x, xt, pos)), cfg)
    for w, g in zip(want[:2], got[:2]):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    for w, g in zip(want[2:], got[2:]):
        _close(w, g)
    assert int(got[1][0, 0, cfg.vision_tokens - 1]) == 0  # the prefix is at t = 0
    with pytest.raises(ValueError, match="sections"):
        layers.apply_mrope(torch.from_numpy(x), got[1], cfg.rope_theta, (8, 8, 8))


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_tokens_equal_reference(weights, arch):
    """Greedy ``generate`` (the port through its kernels' plain versions,
    the reference through its plain layers): the same tokens, of shape
    (B, new, nq) for codebooks; the vlm's decode cache is sized from its
    text, so its prefix-long prefill cache is dropped, as in the
    reference."""
    jparams, flat = weights[arch]
    jcfg, _ = _cfgs(arch)
    _, cfg = _cfgs(arch, use_pallas=True)
    params = model_params_from_arrays(flat, cfg, "cpu")
    nb = _batch(cfg, 4)
    new = 6
    want, _ = jserve.generate(JModel(jcfg), jparams, {k: jnp.asarray(v) for k, v in nb.items()},
                              new)
    got, stats = serve.generate(Model(cfg), params,
                                {k: torch.from_numpy(v) for k, v in nb.items()}, new)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    nq = cfg.num_codebooks
    assert got.shape == (B, new) + ((nq,) if nq else ()) and got.dtype == torch.int32
    assert stats["decode_steps"] == new - 1
    if nq:  # EOS tracking stays off for codebooks
        got_eos, stats = serve.generate(Model(cfg), params,
                                        {k: torch.from_numpy(v) for k, v in nb.items()}, new,
                                        eos_id=int(got[0, 0, 0]), eos_check_every=1)
        assert torch.equal(got_eos, got) and stats["decode_steps"] == new - 1


def test_batch_spec_matches_reference():
    from repro.models.model import batch_spec as jbatch_spec
    from repro_torch.models.model import batch_spec

    for arch in ARCHS + ("yi_6b", "mamba2_1_3b"):
        jcfg, cfg = _cfgs(arch)
        for mode in ("train", "prefill", "decode"):
            want = jbatch_spec(jcfg, 2, 64, mode)
            got = batch_spec(cfg, 2, 64, mode)
            assert set(got) == set(want), (arch, mode)
            for k, s in got.items():
                assert s.shape == tuple(want[k].shape), (arch, mode, k)
                assert s.dtype == getattr(torch, str(want[k].dtype)), (arch, mode, k)
    with pytest.raises(ValueError):
        batch_spec(cfg, 2, 64, "bogus")
