"""The port's serving path (``repro_torch.models``, ``launch.serve``)
held to the JAX package on the CPU.

Weights cross with ``convert.model_params_from_arrays``, so both sides
run the same parameters; inputs are numpy-seeded. Layers and whole
models agree within 2e-4 (f32, smoke configs; the sums run in another
order), with ``use_pallas`` False (blocked attention, ``ssd_chunked``)
and True (Pallas in interpret mode against the kernels' plain versions).
``ssd_chunk=32`` makes several chunks, so the inter-chunk recurrence
runs. Greedy generation is token-for-token the reference's. The port's
``normal`` and ``categorical`` draw JAX's bits in both threefry layouts,
and ``Model.init`` gives the reference's weights within 4 float32 ulp
(``normal``'s erf_inv differs from XLA's in the last bits).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import model_params_from_arrays  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers, ssm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.transformer import param_shapes  # noqa: E402
from repro_torch.utils import prng  # noqa: E402

PART = bool(jax.config.jax_threefry_partitionable)
TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ("yi_6b", "mamba2_1_3b")
B, S = 2, 64


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _cfgs(arch, use_pallas):
    kw = dict(use_pallas=use_pallas)
    if arch == "mamba2_1_3b":
        kw["ssd_chunk"] = 32  # two chunks at S = 64
    return jget_smoke_config(arch, **kw), get_smoke_config(arch, **kw)


@pytest.fixture(scope="module")
def weights():
    """Reference weights per arch (seed 3), flattened to numpy."""
    out = {}
    for arch in ARCHS:
        jcfg, _ = _cfgs(arch, False)
        jparams = jax.jit(JModel(jcfg).init)(jax.random.key(3))
        out[arch] = (jparams, _flat(jparams))
    return out


def _tokens(cfg, seed=0, b=B, s=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(want, got, **kw):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **(kw or TOL))


# ---------------------------------------------------------------------------
# random draws and init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("partitionable", [True, False])
def test_normal_and_categorical_match_jax(partitionable):
    with jax.threefry_partitionable(partitionable):
        for seed in (0, 5):
            jk, tk = jax.random.key(seed), prng.key(seed)
            want = np.asarray(jax.random.normal(jk, (3, 517)))
            got = prng.normal(tk, (3, 517), partitionable=partitionable).numpy()
            ulp = np.abs(want.view(np.int32).astype(np.int64) - got.view(np.int32))
            assert ulp.max() <= 4
            logits = np.random.default_rng(seed).standard_normal((4, 1, 97)).astype(np.float32)
            want = np.asarray(jax.random.categorical(jk, jnp.asarray(logits), axis=-1))
            got = prng.categorical(tk, torch.from_numpy(logits), partitionable=partitionable)
            np.testing.assert_array_equal(want, got.numpy())


def test_normal_in_pieces_matches_one_draw(monkeypatch):
    """A large draw is hashed in pieces; the pieces are the same bits."""
    whole = prng.normal(prng.key(9), (40, 31))
    monkeypatch.setattr(prng, "_CHUNK", 100)
    np.testing.assert_array_equal(whole.numpy(), prng.normal(prng.key(9), (40, 31)).numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference(arch, weights):
    _, flat = weights[arch]
    jcfg, cfg = _cfgs(arch, False)
    got = Model(cfg).init(prng.key(3), "cpu", partitionable=PART).state_dict()
    assert len(got) == sum(a.shape[0] if k.startswith("layers.") else 1 for k, a in flat.items())
    for path, want in flat.items():
        parts = path.split(".")
        for i in range(cfg.num_layers) if parts[0] == "layers" else [None]:
            name = path if i is None else ".".join(["layers", str(i)] + parts[1:])
            w = want if i is None else want[i]
            g = got[name].numpy()
            assert g.shape == w.shape and g.dtype == w.dtype, name
            ulp = np.abs(w.view(np.int32).astype(np.int64) - g.view(np.int32))
            assert ulp.max() <= 4, name
    assert {k: (tuple(t.shape), t.dtype) for k, t in got.items()} == param_shapes(cfg)


def test_unported_families_raise():
    """The moe, hybrid, audio and vlm families build and serve (their
    parity: tests/test_torch_moe.py, test_torch_families*.py); training
    them is not ported yet and raises, citing its ROADMAP.md item."""
    from repro_torch.data import random_batch_like
    from repro_torch.models.model import batch_spec
    from repro_torch.models.transformer import check_trainable

    for arch in ("dbrx_132b", "deepseek_v2_236b", "hymba_1_5b", "musicgen_large", "qwen2_vl_2b"):
        cfg = get_smoke_config(arch)
        m = Model(cfg)
        params = m.init(prng.key(0), "cpu")
        batch = random_batch_like(batch_spec(cfg, 1, 32, "prefill"), device="cpu")
        batch["tokens"] = batch["tokens"] % cfg.vocab_size
        gen, stats = serve.generate(m, params, batch, 2)
        nq = cfg.num_codebooks
        assert gen.shape == (1, 2) + ((nq,) if nq else ()) and stats["decode_steps"] == 1
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 12"):
            check_trainable(cfg)
        with pytest.raises(NotImplementedError, match="item 12"):
            m.loss(Model.params_tree(params), {"tokens": batch["tokens"],
                                               "labels": batch["tokens"]})


# ---------------------------------------------------------------------------
# layers with converted weights
# ---------------------------------------------------------------------------


def _layer(weights, arch, i=0):
    jparams, flat = weights[arch]
    _, cfg = _cfgs(arch, False)
    params = model_params_from_arrays(flat, cfg, "cpu")
    return jax.tree.map(lambda a: a[i], jparams["layers"]), params.layers[i]


def test_dense_layers_match(weights):
    jlp, lp = _layer(weights, "yi_6b")
    _, cfg = _cfgs("yi_6b", False)
    rng = np.random.default_rng(1)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    cache_pos = np.where(np.arange(S) < 50, np.arange(S), -1).astype(np.int32)
    cache_pos = np.broadcast_to(cache_pos, (B, S)).copy()
    now = np.array([49, 30], np.int32)

    def run(L, lp, x, q, k, v, pos, cache_pos, now):
        # q_block 16: the multi-block path of blocked attention and its windows
        return (L.rmsnorm(x, lp["attn_norm"]), L.swiglu(lp["mlp"], x),
                L.apply_rope(q, pos, cfg.rope_theta),
                *[L.blocked_causal_attention(q, k, v, window=w, q_block=16) for w in (0, 24)],
                *[L.decode_attention(q[:, :1], k, v, cache_pos, now, window=w) for w in (0, 16)])

    arrays = (x, q, k, v, pos, cache_pos, now)
    want = jax.jit(lambda *a: run(jlayers, *a))(jlp, *arrays)
    got = run(layers, lp, *map(torch.from_numpy, arrays))
    for w, g in zip(want, got):
        _close(w, g)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_ssm_layers_match(weights, use_pallas):
    jlp, lp = _layer(weights, "mamba2_1_3b", 1)
    jcfg, cfg = _cfgs("mamba2_1_3b", use_pallas)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    xt = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)

    def run(M, c, p, x, xt):
        y, cache = M.ssm_forward_train(p, x, c, return_cache=True)
        return (y, cache["state"], cache["conv"],
                *M.ssm_decode_step(p, xt, cache["state"], cache["conv"], c))

    want = jax.jit(lambda *a: run(jssm, jcfg, *a))(jlp["ssm"], x, xt)
    got = run(ssm, cfg, lp["ssm"], torch.from_numpy(x), torch.from_numpy(xt))
    for w, g in zip(want, got):
        _close(w, g)


# ---------------------------------------------------------------------------
# whole models and the serving loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_prefill_decode_forward_match(weights, arch, use_pallas):
    jparams, flat = weights[arch]
    jcfg, cfg = _cfgs(arch, use_pallas)
    jm, m = JModel(jcfg), Model(cfg)
    params = model_params_from_arrays(flat, cfg, "cpu")
    toks = _tokens(cfg)
    batch, tbatch = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    jlogits, (jlast, jcache) = jax.jit(lambda p, b: (jm.forward_logits(p, b), jm.prefill(p, b)))(
        jparams, batch)
    _close(jlogits, m.forward_logits(params, tbatch))
    last, cache = m.prefill(params, tbatch)
    _close(jlast, last)
    for name, t in cache["layers"].items():
        _close(jcache["layers"][name], t)
    jcache = jserve.expand_cache(jm, jcache, S + 4)
    cache = serve.expand_cache(m, cache, S + 4)
    jdec = jax.jit(jm.decode_step)
    for step in range(2):
        nxt = _tokens(cfg, seed=10 + step, s=1)
        jlg, jcache = jdec(jparams, jcache, {"tokens": jnp.asarray(nxt)})
        lg, cache = m.decode_step(params, cache, {"tokens": torch.from_numpy(nxt)})
        _close(jlg, lg)
    np.testing.assert_array_equal(np.asarray(jcache["next_pos"]), cache["next_pos"].numpy())
    if "cache_positions" in cache:
        np.testing.assert_array_equal(np.asarray(jcache["cache_positions"]),
                                      cache["cache_positions"].numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_tokens_equal_reference(weights, arch):
    jparams, flat = weights[arch]
    jcfg, cfg = _cfgs(arch, True)
    params = model_params_from_arrays(flat, cfg, "cpu")
    toks = _tokens(cfg, seed=4)
    want, _ = jserve.generate(JModel(jcfg), jparams, {"tokens": jnp.asarray(toks)}, 6)
    got, stats = serve.generate(Model(cfg), params, {"tokens": torch.from_numpy(toks)}, 6)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert got.dtype == torch.int32 and stats["decode_steps"] == 5


def test_generate_sampled_and_eos_early_exit_match_reference(weights):
    """Temperature sampling (categorical on ``fold_in(key, i)`` per step)
    with an EOS that every stream hits: the tokens, the early exit and the
    stats equal the reference's."""
    jparams, flat = weights["yi_6b"]
    jcfg, cfg = _cfgs("yi_6b", False)
    m = Model(cfg)
    params = model_params_from_arrays(flat, cfg, "cpu")
    toks = _tokens(cfg, seed=5, b=1, s=8)
    T, kw = 10, dict(temperature=0.8, partitionable=PART)
    sampled, _ = serve.generate(m, params, {"tokens": torch.from_numpy(toks)}, T, key=prng.key(7), **kw)
    eos = int(sampled[0, 1])  # the stream emits this early
    got, stats = serve.generate(m, params, {"tokens": torch.from_numpy(toks)}, T, key=prng.key(7),
                                eos_id=eos, eos_check_every=1, **kw)
    want, wstats = jserve.generate(JModel(jcfg), jparams, {"tokens": jnp.asarray(toks)}, T,
                                   temperature=0.8, key=jax.random.key(7), eos_id=eos,
                                   eos_check_every=1)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    np.testing.assert_array_equal(sampled[0, :2].numpy(), got[0, :2].numpy())
    assert stats.keys() == wstats.keys()
    assert stats["decode_steps"] == wstats["decode_steps"]
    assert 1 <= stats["decode_steps"] < T - 1  # the early exit fired
    full, fstats = serve.generate(m, params, {"tokens": torch.from_numpy(toks)}, T,
                                  key=prng.key(7), eos_id=eos, eos_check_every=0, **kw)
    assert fstats["decode_steps"] == T - 1  # exit disabled: the loop ran to the end
    np.testing.assert_array_equal(full.numpy(), got.numpy())  # the padded tail is exact


def test_serve_cli_runs_on_the_cpu(capsys):
    serve.main(["--arch", "mamba2_1_3b", "--batch", "1", "--prompt-len", "16", "--max-new", "3",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "mamba2-1.3b-smoke on cpu" in out and "stream 0:" in out


def test_model_params_from_arrays_checks_paths(weights):
    _, flat = weights["yi_6b"]
    _, cfg = _cfgs("yi_6b", False)
    bad = dict(flat)
    bad.pop("final_norm")
    with pytest.raises(KeyError, match="final_norm"):
        model_params_from_arrays(bad, cfg, "cpu")
    bad = dict(flat, embed=flat["embed"][:, :8])
    with pytest.raises(ValueError, match="embed"):
        model_params_from_arrays(bad, dataclasses.replace(cfg), "cpu")
