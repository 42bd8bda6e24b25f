"""The port's training step (``repro_torch.launch.train.make_train_step``
over ``Model.loss``) against the live JAX package on the CPU, for the moe
(dbrx-132b; deepseek-v2-236b with MLA), audio (musicgen-large's codebook
loss over (B, S, nq, V) logits) and vlm (qwen2-vl-2b's projected vision
prefix, dropped before the head) smoke configs in float32, with ``ce``
and the MoE's load-balance ``aux`` compared apart; from the same
weights (numpy arrays, carried into the port by
``convert.params_tree_from_arrays``) and a numpy-seeded batch.

Tolerances, each stated where it is used:
  - the loss within 1e-5 relative (the products sum in another order);
  - parameters after one step within rtol 2e-4 / atol 2e-5 (the
    reference's own tolerance between microbatch counts,
    ``tests/test_serve_and_extras.py::test_microbatch_equivalence``).
    AdamW's first step is ``lr * g / (|g| + eps)``, the sign of the
    gradient where it is far above eps, so its learning rate is 1e-5:
    a gradient near 0 whose sign the two summation orders disagree on
    then moves a parameter at most 2e-5 apart;
  - the aux loss within 1e-5 relative;
  - remat against no remat: bitwise (the same operations on the same
    values).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke_config  # noqa: E402
from repro.launch.train import make_train_step as jmake_train_step  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_tree_from_arrays  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.transformer import VISION_EMBED_DIM  # noqa: E402
from repro_torch.optim import adamw, sgd  # noqa: E402
from repro_torch.utils import prng  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

ARCHS = ("dbrx_132b", "deepseek_v2_236b", "musicgen_large", "qwen2_vl_2b")
B, S = 4, 32  # S counts the vlm's vision prefix
RTOL, ATOL = 2e-4, 2e-5
OPTS = {"sgd": (lambda: jsgd(0.1), lambda: sgd(0.1)),
        "adamw": (lambda: jadamw(1e-5), lambda: adamw(1e-5))}


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
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = v.detach().numpy()
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _cfgs(arch, **over):
    return jget_smoke_config(arch, **over), get_smoke_config(arch, **over)


def _batch(cfg, rng):
    """Token ids and labels (B, S) ((B, S, nq) with codebooks; S minus
    the vision prefix for the vlm, with its vision embeddings)."""
    nq = cfg.num_codebooks
    text = S - cfg.vision_tokens if cfg.arch_type == "vlm" else S
    shape = (B, text) + ((nq,) if nq else ())
    out = {k: rng.integers(0, cfg.vocab_size, shape).astype(np.int32) for k in ("tokens", "labels")}
    if cfg.arch_type == "vlm":
        out["vision_embeds"] = rng.standard_normal(
            (B, cfg.vision_tokens, VISION_EMBED_DIM)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def case():
    """Per arch: weights (the port's ``Model.init``, seed 3, which draws
    the reference's within 4 ulp), a batch (numpy), and
    the reference's steps from them: SGD and AdamW, and SGD over two
    microbatches, jitted as one program (one compile per arch)."""
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg, cfg = _cfgs(arch)
        flat = _flat(Model.params_tree(Model(cfg).init(prng.key(3), "cpu")))
        jparams = _nest({k: jnp.asarray(v) for k, v in flat.items()})
        batch = _batch(cfg, np.random.default_rng(20 + i))
        runs = {"sgd": (OPTS["sgd"][0](), 1), "adamw": (OPTS["adamw"][0](), 1),
                "sgd_mb2": (OPTS["sgd"][0](), 2)}

        def steps(p, b):
            return {name: jmake_train_step(JModel(jcfg), opt, microbatches=mb)(p, opt.init(p), b)
                    for name, (opt, mb) in runs.items()}

        res = jax.jit(steps)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
        ref = {name: (_flat(new), {k: float(v) for k, v in met.items()})
               for name, (new, _, met) in res.items()}
        out[arch] = (flat, batch, ref)
    return out


def _port_step(arch, flat, batch, opt, microbatches=1, donate=False, **over):
    _, cfg = _cfgs(arch, **over)
    tree = params_tree_from_arrays(flat, cfg, "cpu")
    step = train.make_train_step(Model(cfg), opt, microbatches=microbatches, donate=donate)
    new, state, met = step(tree, opt.init(tree), {k: torch.from_numpy(v) for k, v in batch.items()})
    return new, state, {k: float(v) for k, v in met.items()}


def _close_params(got, want):
    got = _flat(got)
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=RTOL, atol=ATOL, err_msg=path)


def _close_loss(got, want):
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(case, arch, opt):
    """One step from the same weights: ``loss``, ``ce`` and ``aux`` apart,
    and every updated parameter (experts, router, MLA projections,
    codebook embeddings and heads, the vision projection)."""
    flat, batch, ref = case[arch]
    want, wmet = ref[opt]
    new, state, met = _port_step(arch, flat, batch, OPTS[opt][1]())
    for k in ("loss", "ce", "aux"):
        _close_loss(met[k], wmet[k])
    assert (met["aux"] > 0) == (wmet["aux"] > 0) == (arch in ("dbrx_132b", "deepseek_v2_236b"))
    assert int(state.step) == 1
    _close_params(new, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatches_match_reference_and_one_microbatch(case, arch):
    """Two microbatches (float32 accumulation): the reference's two, and
    the port's one, within the reference's microbatch tolerance (the
    MoE's aux loss is per microbatch, so the losses differ there)."""
    flat, batch, ref = case[arch]
    want, wmet = ref["sgd_mb2"]
    new2, _, met2 = _port_step(arch, flat, batch, sgd(0.1), microbatches=2)
    for k in ("loss", "ce", "aux"):
        _close_loss(met2[k], wmet[k])
    _close_params(new2, want)
    if arch in ("musicgen_large", "qwen2_vl_2b"):
        new1, _, met1 = _port_step(arch, flat, batch, sgd(0.1), microbatches=1)
        _close_loss(met2["loss"], met1["loss"])
        _close_params(new2, _flat(new1))


@pytest.mark.parametrize("arch", ["dbrx_132b", "deepseek_v2_236b"])
def test_model_loss_aux_matches_reference(case, arch):
    """``Model.loss`` itself returns the summed aux loss of the MoE layers
    (``block_apply_full``'s; the serving path drops it), the reference's
    within 1e-5, and adds it to ``ce``."""
    flat, batch, ref = case[arch]
    _, wmet = ref["sgd"]
    _, cfg = _cfgs(arch)
    tree = params_tree_from_arrays(flat, cfg, "cpu")
    total, met = Model(cfg).loss(tree, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close_loss(float(met["aux"]), wmet["aux"])
    assert float(total) == float(met["ce"] + met["aux"])


@pytest.mark.parametrize("arch", ["dbrx_132b", "qwen2_vl_2b"])
def test_remat_is_bitwise_no_remat(case, arch):
    """``cfg.remat``: the same loss, aux and updated parameters, bitwise."""
    flat, batch, _ = case[arch]
    runs = [_port_step(arch, flat, batch, adamw(1e-3), remat=r) for r in (False, True)]
    assert runs[0][2] == runs[1][2]
    for a, b in zip(tree_leaves(runs[0][0]), tree_leaves(runs[1][0])):
        assert torch.equal(a, b)
