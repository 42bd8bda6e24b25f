"""Prefill and decode of the moe (dbrx-132b; deepseek-v2-236b with MLA,
its decode naive and absorbed), hybrid (hymba-1.5b), audio
(musicgen-large) and vlm (qwen2-vl-2b) smoke configs, held to the JAX
package on the CPU.

Both sides run the same weights: the port's ``Model.init`` (seed 3)
handed to the reference as its pytree (``Model.params_tree``: layer
leaves stacked (L, ...)); ``tests/test_torch_families.py`` holds that
draw to the reference's own within 4 ulp. The prefill's last logits,
``forward_logits`` and every cache leaf, then two decode steps' logits,
the cache and its positions agree within 2e-4, with ``use_pallas``
False and True (the reference's Pallas kernels in interpret mode
against the port's plain kernel versions; hymba with ``ssd_chunk=32``,
two chunks). Inputs are numpy-seeded.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.transformer import VISION_EMBED_DIM  # noqa: E402
from repro_torch.utils import prng  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
B, S = 2, 64  # S counts the vlm's vision prefix


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **over):
    if arch == "hymba_1_5b":
        over.setdefault("ssd_chunk", 32)  # two chunks at S = 64
    return jget_smoke_config(arch, **over), get_smoke_config(arch, **over)


def _tokens(cfg, rng, b, s):
    nq = cfg.num_codebooks
    return rng.integers(0, cfg.vocab_size, (b, s) + ((nq,) if nq else ())).astype(np.int32)


def _batch(cfg, seed):
    """A prefill batch as numpy: token ids (B, S[, nq]); for the vlm
    S - vision_tokens text ids and the vision embeddings."""
    rng = np.random.default_rng(seed)
    text = S - cfg.vision_tokens if cfg.arch_type == "vlm" else S
    out = {"tokens": _tokens(cfg, rng, B, text)}
    if cfg.arch_type == "vlm":
        out["vision_embeds"] = rng.standard_normal(
            (B, cfg.vision_tokens, VISION_EMBED_DIM)).astype(np.float32)
    return out


def _close(want, got):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **TOL)


# (arch, overrides): deepseek-v2's decode both ways
CASES = [("dbrx_132b", {}), ("deepseek_v2_236b", {}),
         ("deepseek_v2_236b", dict(mla_absorb=True)), ("hymba_1_5b", {}),
         ("musicgen_large", {}), ("qwen2_vl_2b", {})]


@pytest.mark.parametrize("arch,over", CASES, ids=[a + ("-absorb" if o else "") for a, o in CASES])
def test_prefill_and_decode_match_reference(arch, over):
    """The decode cache holds the whole prompt (the vlm's prefix too);
    ``forward_logits`` is compared on the plain path (the kernel path
    runs the same stack as the prefill)."""
    params = Model(get_smoke_config(arch)).init(prng.key(3), "cpu")
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), Model.params_tree(params))
    for use_pallas in (False, True):
        jcfg, cfg = _cfgs(arch, use_pallas=use_pallas, **over)
        jm, m = JModel(jcfg), Model(cfg)
        nb = _batch(cfg, 0)
        tb = {k: torch.from_numpy(v) for k, v in nb.items()}
        if use_pallas:
            jlast, jcache = jax.jit(jm.prefill)(jparams, nb)
        else:
            jlogits, (jlast, jcache) = jax.jit(
                lambda p, b: (jm.forward_logits(p, b), jm.prefill(p, b)))(jparams, nb)
            _close(jlogits, m.forward_logits(params, tb))
        last, cache = m.prefill(params, tb)
        _close(jlast, last)
        assert set(cache["layers"]) == set(jcache["layers"])
        for name, t in cache["layers"].items():
            _close(jcache["layers"][name], t)
        jcache = jserve.expand_cache(jm, jcache, S + 4)
        cache = serve.expand_cache(m, cache, S + 4)
        jdec = jax.jit(jm.decode_step)
        for step in range(2):
            nxt = _tokens(cfg, np.random.default_rng(10 + step), B, 1)
            jlg, jcache = jdec(jparams, jcache, {"tokens": jnp.asarray(nxt)})
            lg, cache = m.decode_step(params, cache, {"tokens": torch.from_numpy(nxt)})
            _close(jlg, lg)
        np.testing.assert_array_equal(np.asarray(jcache["next_pos"]), cache["next_pos"].numpy())
        np.testing.assert_array_equal(np.asarray(jcache["cache_positions"]),
                                      cache["cache_positions"].numpy())
        for name, t in cache["layers"].items():
            _close(jcache["layers"][name], t)
