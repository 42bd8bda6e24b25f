"""The RW-SGD building blocks of the port against the live JAX package,
on the CPU: the optimizers, ``Model.loss``, the Markov task and its
sampler, the replica stack's slot copies and the batched local step.

Tolerances, each stated where it is used:
  - optimizers: parameters and moments after three steps within
    atol 1e-7 (float32 ulps of O(1) values; the bias corrections' ``pow``
    may round differently), step counters bitwise;
  - ``Model.loss``: value within 1e-5, every gradient within 1e-5 of the
    leaf's largest gradient (the products sum in another order);
  - ``sample_batch``: tokens bitwise, given the reference's logits;
  - ``make_markov_task``: logits within 1e-5, entropy within 1e-5 (its
    ``u @ v`` product may differ by an ulp between XLA and torch);
  - slot copies (``fork_replica``): bitwise, they only move values.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke_config  # noqa: E402
from repro.data import make_markov_task as jmake_markov_task  # noqa: E402
from repro.data import node_batches as jnode_batches  # noqa: E402
from repro.data import sample_batch as jsample_batch  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import cosine_schedule as jcosine  # noqa: E402
from repro.optim import init_replicas as jinit_replicas  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro.optim.rw_sgd import local_sgd_step as jlocal_sgd_step  # noqa: E402
from repro.optim.rw_sgd import replica_train_step as jreplica_train_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import walkers as wlk  # noqa: E402
from repro_torch.data import (  # noqa: E402
    SyntheticTask, make_markov_task, node_batches, sample_batch,
)
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    adamw, cosine_schedule, fork_replica, init_replicas, local_sgd_step, replica_train_step, sgd,
)
from repro_torch.utils import prng  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_replace  # noqa: E402

PART = bool(jax.config.jax_threefry_partitionable)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: under xdist each worker shares the
    machine's cores with the others, and torch's default of one thread
    per core oversubscribes them (the results do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree, prefix=""):
    """A nested dict of arrays as dotted paths -> numpy."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = v.detach().float().numpy()
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        parts = path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(v, copy=True))
    return out


def _close(got_tree, want_tree, atol, label):
    want = _flat(want_tree)
    for path, got in _flat(got_tree).items():
        np.testing.assert_allclose(np.asarray(got, np.float32), want[path].astype(np.float32),
                                   rtol=0, atol=atol, err_msg=f"{label}: {path}")


# ---------------------------------------------------------------------------
# optimizers, step for step
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "adamw": (lambda m: m.adamw(3e-3), None),
    "adamw_wd_bf16_moments": (
        lambda m: m.adamw(1e-2, weight_decay=0.1,
                          moment_dtype=jnp.bfloat16 if m is jax_opt else torch.bfloat16), None),
    "adamw_cosine": (lambda m: m.adamw(m.cosine(1e-2, warmup=2, total=5)), None),
    "sgd": (lambda m: m.sgd(0.1), None),
    "sgd_momentum": (lambda m: m.sgd(0.1, momentum=0.9), None),
}


class jax_opt:  # the reference's constructors
    adamw, sgd, cosine = staticmethod(jadamw), staticmethod(jsgd), staticmethod(jcosine)


class port_opt:
    adamw, sgd, cosine = staticmethod(adamw), staticmethod(sgd), staticmethod(cosine_schedule)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizers_step_for_step(name):
    """Three steps of each optimizer on the same params and gradients;
    atol 1e-7 on params and moments (float32 ulps), steps bitwise, and
    equal signatures where both declare one."""
    make, _ = OPTIMIZERS[name]
    jo, to = make(jax_opt), make(port_opt)
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
    grads = [{"w": rng.standard_normal((3, 4)).astype(np.float32),
              "b": {"c": rng.standard_normal((5,)).astype(np.float32)}} for _ in range(3)]
    jp, tp = jax.tree.map(jnp.asarray, params), _nest(_flat(params))
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = to.update(_nest(_flat(g)), ts, tp)
    _close(tp, jp, 1e-7, f"{name} params")
    assert int(ts.step) == int(js.step) == 3
    for jm, tm in ((js.mu, ts.mu), (js.nu, ts.nu)):
        if jm == ():
            assert tm == ()
        else:
            _close(tm, jm, 1e-7, f"{name} moments")
    assert (to.signature is None) == (jo.signature is None)


def test_schedules_match():
    """The constant and cosine schedules at several steps (bitwise: the
    same float32 operations)."""
    js, ts = jcosine(3e-3, warmup=10, total=100, min_ratio=0.2), cosine_schedule(
        3e-3, warmup=10, total=100, min_ratio=0.2)
    steps = np.array([0, 1, 5, 10, 11, 50, 99, 100, 150], np.int32)
    want = np.asarray(js(jnp.asarray(steps)))
    got = ts(torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert ts.signature == js.signature
    assert adamw(0.5).signature[:2] == ("adamw", 0.5)


# ---------------------------------------------------------------------------
# Model.loss
# ---------------------------------------------------------------------------


def test_model_loss_and_grads_match_reference():
    """paper-rwsgd's smoke config: value within 1e-5 and each gradient
    within 1e-5 of its leaf's largest, against ``jax.value_and_grad`` of
    the reference's ``Model.loss``; ``params_tree`` round-trips; one
    ``local_sgd_step`` (SGD) moves every parameter within 1e-6 of the
    reference's."""
    jcfg = jget_smoke_config("paper_rwsgd")
    jm = JModel(jcfg)
    params = jm.init(jax.random.key(3))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    labs = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        params, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)})
    model = Model(get_smoke_config("paper_rwsgd"))
    tree = convert.params_tree_from_arrays(_flat(params), model.cfg, "cpu")
    leaves = [x.requires_grad_() for x in tree_leaves(tree)]
    loss, met = model.loss(tree_replace(tree, leaves),
                           {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labs)})
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(jl)) < 1e-5
    assert abs(float(met["ce"].detach()) - float(jmet["ce"])) < 1e-5 and float(met["aux"]) == 0.0
    want = _flat(jg)
    for path, g in _flat(tree_replace(tree, [g.numpy() for g in grads])).items():
        scale = np.abs(want[path]).max()
        np.testing.assert_allclose(g, want[path], rtol=0, atol=1e-5 * scale, err_msg=path)
    back = Model.params_tree(Model.params_from_tree(tree))
    for a, b in zip(tree_leaves(back), tree_leaves(tree)):
        assert torch.equal(a, b.detach())
    # one local step of one model (the reference's local_sgd_step), with
    # SGD, whose update is linear in the gradient: parameters within 1e-6
    # (AdamW's first step, lr * g / (|g| + eps), turns an ulp of a gradient
    # near eps into up to lr; test_optimizers_step_for_step holds AdamW
    # itself on equal gradients)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labs)}
    plain = tree_replace(tree, [x.detach() for x in leaves])
    new, state, loss1, _ = local_sgd_step(model.loss, sgd(0.1), plain, sgd(0.1).init(plain), batch)
    jnew, jstate, _, _ = jlocal_sgd_step(jm.loss, jsgd(0.1), params, jsgd(0.1).init(params),
                                         {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)})
    assert int(state.step) == int(jstate.step) == 1 and abs(float(loss1) - float(jl)) < 1e-5
    _close(new, jnew, 1e-6, "local_sgd_step")


def test_training_guards():
    """No backward kernel for use_pallas=True, and only dense trains."""
    with pytest.raises(NotImplementedError, match="backward"):
        Model(get_smoke_config("paper_rwsgd", use_pallas=True)).loss({}, {})
    with pytest.raises(NotImplementedError, match="ssm"):
        Model(get_smoke_config("mamba2_1_3b")).loss({}, {})


# ---------------------------------------------------------------------------
# the Markov task and its sampler
# ---------------------------------------------------------------------------


def test_sample_batch_tokens_bitwise():
    """Given the reference's logits, every token of ``sample_batch`` (a
    (rows, W) grid of node ids, as the payload draws) and of
    ``node_batches`` equals the reference's."""
    jt = jmake_markov_task(96, rank=4, temperature=2.5)
    task = convert.task_from_arrays(np.asarray(jt.logits), jt.entropy, "cpu")
    pos = np.array([[0, 5, 5, 11], [3, 1, 0, 7]], np.int32)
    jkeys = jax.random.split(jax.random.key(9), 2)
    want = jax.vmap(lambda k, p: jax.vmap(lambda nid: jsample_batch(jt, k, 3, 10, nid))(p))(
        jkeys, jnp.asarray(pos))
    keys = prng.split(prng.key(9), 2, partitionable=PART)
    got = sample_batch(task, keys[:, None, :], 3, 10, torch.from_numpy(pos), partitionable=PART)
    for f in ("tokens", "labels"):
        assert got[f].dtype == torch.int32 and got[f].shape == (2, 4, 3, 10)
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]), err_msg=f)
    jn = jnode_batches(jt, jax.random.key(2), 6, 2, 5)
    tn = node_batches(task, prng.key(2), 6, 2, 5, partitionable=PART)
    np.testing.assert_array_equal(tn["tokens"].numpy(), np.asarray(jn["tokens"]))


def test_make_markov_task_within_float_bound():
    """The port's own task: logits and entropy within 1e-5 of the
    reference's (one XLA / torch ulp in ``u @ v``)."""
    for vocab, rank, temp in ((64, 4, 2.0), (256, 16, 2.5)):
        jt = jmake_markov_task(vocab, rank=rank, temperature=temp)
        tt = make_markov_task(vocab, rank=rank, temperature=temp, partitionable=PART,
                              device="cpu")
        np.testing.assert_allclose(tt.logits.numpy(), np.asarray(jt.logits), rtol=0, atol=1e-5)
        assert abs(tt.entropy - jt.entropy) < 1e-5


# ---------------------------------------------------------------------------
# the replica stack: slot copies (tests/test_rw_sgd.py's cases)
# ---------------------------------------------------------------------------


def _toy_loss(p, b):
    """Each replica's squared distance to its target: (R, 3) -> (R,)."""
    return torch.sum((p["w"] - b) ** 2, dim=-1)


def _replicas(n_slots=4):
    """One row of ``n_slots`` slots with distinct params, moments and
    steps: two masked train steps against slot-specific targets."""
    opt = adamw(1e-1)
    rs = init_replicas(lambda k: {"w": prng.normal(k, (3,))}, opt.init,
                       prng.key(0)[None], n_slots)
    step = replica_train_step(_toy_loss, opt)
    targets = torch.arange(n_slots, dtype=torch.float32).view(1, n_slots, 1) * torch.ones(3)
    for _ in range(2):
        rs, _ = step(rs, targets, torch.ones((1, n_slots), dtype=torch.bool))
    return rs


def _slot(rs, s):
    return [x[0, s] for x in tree_leaves(rs)]


def _same_slot(a, sa, b, sb):
    for x, y in zip(_slot(a, sa), _slot(b, sb)):
        assert torch.equal(x, y)


def test_fork_into_out_of_range_or_masked_slot_is_noop():
    rs = _replicas(4)
    for out in (fork_replica(rs, 0, 4, True), fork_replica(rs, 0, 2, False)):
        for x, y in zip(tree_leaves(out), tree_leaves(rs)):
            assert torch.equal(x, y)


def test_chained_fork_reads_pre_round_state():
    """Slot 0 is overwritten and read in one call: its child gets the
    old replica (``tests/test_rw_sgd.py:57``)."""
    rs = _replicas(4)
    out = fork_replica(rs, torch.tensor([1, 0]), torch.tensor([0, 3]), torch.tensor([True, True]))
    _same_slot(out, 0, rs, 1)
    _same_slot(out, 3, rs, 0)
    _same_slot(out, 1, rs, 1)
    _same_slot(out, 2, rs, 2)


def test_parent_forked_then_parent_fails_child_keeps_copy():
    rs = _replicas(4)
    ws = wlk.WalkState(pos=torch.tensor([[0, 1, 2, 3]], dtype=torch.int32),
                       active=torch.tensor([[True, True, False, False]]),
                       track=torch.arange(4, dtype=torch.int32)[None])
    ls = torch.full((1, 5, 4), -1, dtype=torch.int32)
    new_ws, _, n, fork_parent = wlk.execute_forks(
        ws, ls, torch.tensor([[True, False, False, False]]), ws.pos, None,
        torch.tensor([3], dtype=torch.int32))
    assert int(n[0]) == 1
    child = int(torch.nonzero(fork_parent[0] >= 0)[0, 0])
    slots = torch.arange(4)
    out = fork_replica(rs, torch.clamp(fork_parent, min=0), slots[None], fork_parent >= 0)
    _same_slot(out, child, rs, 0)
    assert bool(new_ws.active[0, child])


def test_terminate_then_refork_overwrites_stale_state():
    """A re-fork into a terminated walk's slot replaces every leaf:
    params, both moments, the optimizer's and the replica's step."""
    rs = _replicas(4)
    step = replica_train_step(_toy_loss, adamw(1e-1))
    rs, _ = step(rs, torch.full((1, 4, 3), 9.0), torch.tensor([[False, False, True, False]]))
    out = fork_replica(rs, 1, 2, True)
    _same_slot(out, 2, rs, 1)
    for x, y in zip(_slot(out, 2), _slot(rs, 2)):
        assert not torch.equal(x, y), "stale leaf survived slot reuse"


def test_replica_train_step_matches_reference():
    """The batched step against the reference's vmapped step over three
    steps with one slot inactive: params and moments within 1e-6, losses
    within 1e-5, step counters bitwise, the inactive slot untouched."""
    init = lambda k: {"w": jax.random.normal(k, (3,))}
    jrs = jinit_replicas(init, jadamw(1e-1).init, jax.random.key(0), max_walks=4)
    jstep = jreplica_train_step(lambda p, b: (jnp.sum((p["w"] - b) ** 2), {}), jadamw(1e-1))
    rs = init_replicas(lambda k: {"w": prng.normal(k, (3,), partitionable=PART)},
                       adamw(1e-1).init, prng.key(0)[None], 4)
    step = replica_train_step(_toy_loss, adamw(1e-1))
    targets = np.arange(4, dtype=np.float32)[:, None] * np.ones(3, np.float32)
    active = np.array([True, True, False, True])
    start = rs.params["w"].clone()
    for _ in range(3):
        jrs, jl = jstep(jrs, jnp.asarray(targets), jnp.asarray(active))
        rs, tl = step(rs, torch.from_numpy(targets)[None], torch.from_numpy(active)[None])
        np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    np.testing.assert_allclose(rs.params["w"][0].numpy(), np.asarray(jrs.params["w"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(rs.opt_state.nu["w"][0].numpy(),
                               np.asarray(jrs.opt_state.nu["w"]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(rs.steps[0].numpy(), np.asarray(jrs.steps))
    np.testing.assert_array_equal(rs.opt_state.step[0].numpy(), np.asarray(jrs.opt_state.step))
    assert torch.equal(rs.params["w"][0, 2], start[0, 2])


def test_replicas_carried_across_from_jax():
    """A reference ReplicaSet (adamw state included) crosses bitwise,
    with and without the batch axis; a wrong shape raises."""
    jcfg = jget_smoke_config("paper_rwsgd", num_layers=1, d_model=32, d_ff=64, vocab_size=64,
                             num_heads=2, num_kv_heads=2, head_dim=16)
    jm = JModel(jcfg)
    jrs = jinit_replicas(jm.init, jadamw(1e-2).init, jax.random.key(1), max_walks=3)
    arrays = _flat({"params": jrs.params, "opt_state": {"step": jrs.opt_state.step,
                                                         "mu": jrs.opt_state.mu,
                                                         "nu": jrs.opt_state.nu},
                    "steps": jrs.steps})
    cfg = dataclasses.replace(get_smoke_config("paper_rwsgd"), **{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    rs = convert.replicas_from_arrays(arrays, cfg, "cpu")
    assert rs.steps.shape == (1, 3) and rs.params["layers"]["attn"]["wq"].shape[:3] == (1, 3, 1)
    for path, a in _flat({"params": jrs.params}).items():
        node = rs.params
        for part in path.split(".")[1:]:
            node = node[part]
        np.testing.assert_array_equal(node[0].numpy(), a, err_msg=path)
    batched = convert.replicas_from_arrays({k: v[None] for k, v in arrays.items()}, cfg, "cpu")
    for x, y in zip(tree_leaves(batched), tree_leaves(rs)):
        assert torch.equal(x, y)
    bad = dict(arrays, **{"params.embed": arrays["params.embed"][:, :2]})
    with pytest.raises(ValueError, match="embed"):
        convert.replicas_from_arrays(bad, cfg, "cpu")
    assert isinstance(convert.task_from_arrays(np.zeros((4, 4)), 1.0, "cpu"), SyntheticTask)
