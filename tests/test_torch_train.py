"""The port's training step (``repro_torch.launch.train.make_train_step``
over ``Model.loss``) against the live JAX package on the CPU, for the
dense, ssm and hybrid families' smoke configs in float32, from the same
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
  - remat against no remat, and a donated update against the functional
    one: bitwise (the same operations on the same values).
"""
import dataclasses

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
from repro_torch.optim import adamw, sgd  # noqa: E402
from repro_torch.utils import prng  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

ARCHS = ("granite_8b", "mamba2_1_3b", "hymba_1_5b")
B, S = 4, 32
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
    if arch in ("mamba2_1_3b", "hymba_1_5b"):
        over.setdefault("ssd_chunk", 16)  # two chunks at S = 32
    return jget_smoke_config(arch, **over), get_smoke_config(arch, **over)


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
        rng = np.random.default_rng(10 + i)
        batch = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
                 for k in ("tokens", "labels")}
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
    """One step from the reference's weights: loss, ce, aux and every
    updated parameter."""
    flat, batch, ref = case[arch]
    want, wmet = ref[opt]
    new, state, met = _port_step(arch, flat, batch, OPTS[opt][1]())
    for k in ("loss", "ce"):
        _close_loss(met[k], wmet[k])
    assert met["aux"] == wmet["aux"] == 0.0
    assert int(state.step) == 1
    _close_params(new, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatches_match_reference_and_one_microbatch(case, arch):
    """Two microbatches (float32 accumulation): the reference's two, and
    the port's one, within the reference's microbatch tolerance."""
    flat, batch, ref = case[arch]
    want, wmet = ref["sgd_mb2"]
    new2, _, met2 = _port_step(arch, flat, batch, sgd(0.1), microbatches=2)
    _close_loss(met2["loss"], wmet["loss"])
    _close_params(new2, want)
    new1, _, met1 = _port_step(arch, flat, batch, sgd(0.1), microbatches=1)
    _close_loss(met2["loss"], met1["loss"])
    _close_params(new2, _flat(new1))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bitwise_no_remat(case, arch):
    """``cfg.remat`` (each layer under ``torch.utils.checkpoint``) recomputes
    the same forward: loss and updated parameters bitwise, with two
    microbatches."""
    flat, batch, _ = case[arch]
    runs = [_port_step(arch, flat, batch, adamw(1e-3), microbatches=2, remat=r)
            for r in (False, True)]
    assert runs[0][2] == runs[1][2]
    for a, b in zip(tree_leaves(runs[0][0]), tree_leaves(runs[1][0])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("opt", ["sgd_momentum", "adamw"])
def test_donated_update_is_bitwise_functional(case, opt, monkeypatch):
    """``donate=True`` writes the update into the given tensors in pieces
    (a piece of 1,000 elements here, so leaves span several): parameters,
    moments and the step counter bitwise the functional update's, and the
    returned tensors are the given ones."""
    monkeypatch.setattr(train, "DONATE_CHUNK", 1000)
    flat, batch, _ = case["hymba_1_5b"]
    make = (lambda: sgd(0.1, momentum=0.9)) if opt == "sgd_momentum" else (lambda: adamw(1e-3))
    _, cfg = _cfgs("hymba_1_5b")
    results = []
    for donate in (False, True):
        tree = params_tree_from_arrays(flat, cfg, "cpu")
        o = make()
        state = o.init(tree)
        state = o.update(tree, state, tree)[1]  # non-zero moments and step
        step = train.make_train_step(Model(cfg), o, donate=donate)
        given = tree_leaves(tree) + tree_leaves((state.mu, state.nu))
        new, new_state, _ = step(tree, state, {k: torch.from_numpy(v) for k, v in batch.items()})
        got = tree_leaves(new) + tree_leaves((new_state.mu, new_state.nu))
        assert all((a is b) == donate for a, b in zip(got, given))
        results.append((got, int(new_state.step)))
    assert results[0][1] == results[1][1] == 2
    for a, b in zip(results[0][0], results[1][0]):
        assert torch.equal(a, b)


def test_use_pallas_refuses_to_train(case):
    """Neither model kernel has a backward (the reference's jax.grad
    through pallas_call fails too)."""
    flat, batch, _ = case["granite_8b"]
    with pytest.raises(NotImplementedError, match="backward"):
        _port_step("granite_8b", flat, batch, sgd(0.1), use_pallas=True)


def test_train_cli_on_the_cpu(capsys):
    """``python -m repro_torch.launch.train`` on a smoke config, on the
    CPU: it prints the loss of its steps, which stay finite."""
    import sys

    argv = sys.argv
    sys.argv = ["train", "--arch", "granite_8b", "--smoke", "--steps", "3", "--batch", "2",
                "--seq", "16", "--device", "cpu"]
    try:
        train.main()
    finally:
        sys.argv = argv
    out = capsys.readouterr().out
    assert "arch=granite-8b-smoke" in out
    losses = [float(line.split()[3]) for line in out.splitlines() if line.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_configs_are_unchanged_by_training():
    """``remat`` is a field of the config the step reads, not state:
    ``adjust_config`` turns it on for train shapes only."""
    from repro_torch.configs.shapes import SHAPES, adjust_config

    cfg = get_smoke_config("granite_8b")
    assert adjust_config(cfg, SHAPES["train_4k"]) == dataclasses.replace(cfg, remat=True)
    assert adjust_config(cfg, SHAPES["prefill_32k"]) is cfg
