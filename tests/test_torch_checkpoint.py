"""The port's checkpoint layer and the payload's durable runs.

Contract under test, on the CPU:
  * ``save_pytree`` / ``load_pytree`` round-trip the port's trees
    bitwise — a full zoo ``SimState`` (bloom columns, mobile Pac-Man
    positions, churn masks, int16 histograms, int64 key words) and an
    RW-SGD payload carry (replicas, AdamW moments, step counters) — each
    leaf back on its template's device with its dtype;
  * every shape or dtype drift is named in one CheckpointMismatchError;
    bf16 leaves store as float32 and come back exact, the one exemption;
  * writes are atomic: a writer dying mid-write (array file or metadata)
    never shadows the previous snapshot and leaves no temp file;
  * ``save_walk_snapshot`` writes one walk's replica;
  * an RW-SGD payload ensemble (the paper-rwsgd smoke model) run in
    segments is bitwise its straight run, losses and replicas included,
    and so is a payload run killed at a boundary and resumed; the straight
    run's integers are bitwise the reference's ensemble of the same
    walks (a payload never touches the walks' streams).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.api import Experiment as JExperiment  # noqa: E402
from repro.core import FailureConfig as JFailureConfig  # noqa: E402
from repro.core import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.graphs import random_regular_graph  # noqa: E402
from repro_torch.api import Experiment, ResultStore  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointMismatchError,
    load_pytree,
    save_pytree,
    save_walk_snapshot,
)
from repro_torch.checkpoint import checkpoint as ckpt_mod  # noqa: E402
from repro_torch.core import FailureConfig, ProtocolConfig  # noqa: E402
from repro_torch.core.outputs import RecordedOutputs  # noqa: E402
from repro_torch.graphs import make_graph  # noqa: E402
from repro_torch.utils.faults import FaultPlan, Kill, SimulatedKill  # noqa: E402

PART = bool(jax.config.jax_threefry_partitionable)
N, DEG, STEPS, SEEDS, BASE_KEY = 24, 4, 24, 2, 7
PROTO = dict(z0=3, max_walks=6, rt_bins=32, protocol_start=6, eps=1.8)
CHURN = dict(burst_times=(9, 17), burst_sizes=(2, 1), p_node_fail=0.02, p_node_recover=0.3,
             p_link_fail=0.03, p_link_recover=0.4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graph():
    return make_graph("regular", N, seed=3, degree=DEG)


def _payload():
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import make_markov_task
    from repro_torch.models import Model
    from repro_torch.optim import RwSgdPayload, adamw

    cfg = get_smoke_config("paper_rwsgd")
    return RwSgdPayload(Model(cfg), adamw(3e-3), make_markov_task(cfg.vocab_size, device="cpu"),
                        max_walks=PROTO["max_walks"], local_batch=1, seq_len=8)


@pytest.fixture(scope="module")
def payload_plan(graph):
    return Experiment(graph=graph, protocol=ProtocolConfig(**PROTO, estimator_impl="auto"),
                      failures=FailureConfig(**CHURN), steps=STEPS, payload=_payload(),
                      device="cpu", partitionable=PART).plan()


@pytest.fixture(scope="module")
def payload_straight(payload_plan):
    return payload_plan.ensemble(SEEDS, BASE_KEY)


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, RecordedOutputs):
        return list(tree)
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tensors(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _tensors(v)]
    return []


def assert_bitwise(want, got, label):
    a, b = _tensors(want), _tensors(got)
    assert len(a) == len(b) and a, f"{label}: {len(a)} leaves against {len(b)}"
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape, f"{label}: leaf {i}"
        assert x.device == y.device, f"{label}: leaf {i} on {y.device}"
        if x.dtype.is_floating_point:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), f"{label}: leaf {i} differs"


def _snap(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# round trips
# ---------------------------------------------------------------------------


def test_full_simstate_checkpoint_roundtrip(graph, tmp_path):
    """The complete carry of a zoo run — bloom columns, mobile Pac-Man
    positions, churn masks, the int16 histogram, the key words — survives
    save_pytree / load_pytree bitwise, with its structure."""
    pcfg = ProtocolConfig(**PROTO, algorithm="decafork+", walk_variant="bloom", bloom_bits=64)
    fcfg = FailureConfig(**CHURN, pacman_nodes=(2, 11), pacman_mobile=True,
                         edge_cut_times=(5,), edge_cut_thresholds=(12,))
    state, _ = Experiment(graph=graph, protocol=pcfg, failures=fcfg, steps=12,
                          device="cpu").run(BASE_KEY)
    assert state.walks.bloom is not None and state.pacman_pos is not None
    assert state.rts.hist.dtype == torch.int16 and state.key.dtype == torch.int64
    path = str(tmp_path / "state")
    save_pytree(path, state)
    restored = load_pytree(path, state)
    assert type(restored) is type(state) and restored.walks.prev is None
    assert_bitwise(state, restored, "SimState round-trip")


def test_payload_carry_checkpoint_roundtrip(graph, tmp_path):
    """Replica params, AdamW moments and step counters round-trip exactly
    (the payload carry is what makes a killed training run resumable)."""
    plan = Experiment(graph=graph, protocol=ProtocolConfig(**PROTO), steps=3,
                      payload=_payload(), device="cpu").plan()
    (_state, replicas), _ = plan.run(BASE_KEY)
    path = str(tmp_path / "carry")
    save_pytree(path, replicas, metadata={"step": 3})
    restored = load_pytree(path, replicas)
    assert_bitwise(replicas, restored, "payload carry round-trip")
    assert json.loads(_snap(path + ".meta.json")) == {"step": 3}


def test_save_walk_snapshot(graph, tmp_path):
    """One walk's replica: slot s of trajectory row b, with its metadata."""
    params = {"w": torch.arange(24, dtype=torch.float32).reshape(2, 3, 4),
              "b": torch.arange(6, dtype=torch.int32).reshape(2, 3)}
    path = str(tmp_path / "walk")
    save_walk_snapshot(path, params, walk_slot=2, step=17, row=1)
    got = load_pytree(path, {"w": torch.zeros(4), "b": torch.zeros((), dtype=torch.int32)})
    assert torch.equal(got["w"], params["w"][1, 2]) and int(got["b"]) == 5
    assert json.loads(_snap(path + ".meta.json")) == {"walk_slot": 2, "row": 1, "step": 17}


def test_load_pytree_rejects_shape_and_dtype_drift(tmp_path):
    """CheckpointMismatchError names EVERY mismatching leaf — a drifted
    schema must never silently reinterpret arrays."""
    path = str(tmp_path / "ck")
    save_pytree(path, {"a": torch.zeros(3), "b": torch.zeros((2, 2), dtype=torch.int32),
                       "c": torch.zeros(4)})
    like = {"a": torch.zeros(4),  # shape drift
            "b": torch.zeros((2, 2), dtype=torch.int16),  # dtype drift
            "c": torch.zeros(4)}  # fine
    with pytest.raises(CheckpointMismatchError) as ei:
        load_pytree(path, like)
    msg = str(ei.value)
    assert "a" in msg and "shape" in msg and "b" in msg and "dtype" in msg
    assert len(ei.value.mismatches) == 2
    with pytest.raises(KeyError):
        load_pytree(path, {"zz": torch.zeros(1)})
    np_like = {"a": np.zeros(3, np.float32), "b": np.zeros((2, 2), np.int32),
               "c": np.zeros(4, np.float32)}
    assert isinstance(load_pytree(path, np_like)["b"], np.ndarray)


def test_load_pytree_bf16_exemption_still_exact(tmp_path):
    """bf16 leaves store as float32 (exact) and cast back (exact) — the
    one sanctioned dtype mismatch; anything else still raises."""
    path = str(tmp_path / "bf")
    w = torch.arange(8, dtype=torch.bfloat16) / 3
    save_pytree(path, {"w": w})
    with np.load(path + ".npz") as data:
        assert data["w"].dtype == np.float32
    out = load_pytree(path, {"w": torch.zeros(8, dtype=torch.bfloat16)})
    assert out["w"].dtype == torch.bfloat16 and torch.equal(out["w"], w)
    with pytest.raises(CheckpointMismatchError):
        load_pytree(path, {"w": torch.zeros(8, dtype=torch.float16)})


# ---------------------------------------------------------------------------
# atomic writes
# ---------------------------------------------------------------------------


def test_partial_write_never_shadows_previous_snapshot(tmp_path, monkeypatch):
    """A writer that dies mid-write (np.savez fails after emitting partial
    bytes) leaves the previous snapshot byte-identical and loadable, and no
    temp debris behind."""
    path = str(tmp_path / "ckpt")
    tree = {"a": torch.arange(6, dtype=torch.float32), "b": torch.ones((2, 3))}
    save_pytree(path, tree, metadata={"step": 1})
    good_npz, good_meta = _snap(path + ".npz"), _snap(path + ".meta.json")

    def dying_savez(f, **arrays):
        f.write(b"PARTIAL GARBAGE")
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod.np, "savez", dying_savez)
    with pytest.raises(OSError, match="disk full"):
        save_pytree(path, {"a": torch.zeros(6), "b": torch.zeros((2, 3))}, metadata={"step": 2})
    monkeypatch.undo()
    assert _snap(path + ".npz") == good_npz and _snap(path + ".meta.json") == good_meta
    assert not [f for f in os.listdir(tmp_path) if ".tmp-" in f]
    assert_bitwise(tree, load_pytree(path, tree), "previous snapshot")


def test_partial_metadata_write_keeps_previous_meta(tmp_path, monkeypatch):
    """The array write succeeding but the metadata write dying must not
    leave a torn .meta.json either."""
    path = str(tmp_path / "ckpt")
    save_pytree(path, {"x": torch.arange(3)}, metadata={"v": 1})
    good_meta = _snap(path + ".meta.json")
    real = ckpt_mod._atomic_write

    def dying_meta(p, write_fn):
        if p.endswith(".meta.json"):
            def torn(f):
                f.write(b'{"v":')
                raise OSError("crash")

            return real(p, torn)
        return real(p, write_fn)

    monkeypatch.setattr(ckpt_mod, "_atomic_write", dying_meta)
    with pytest.raises(OSError, match="crash"):
        save_pytree(path, {"x": torch.arange(3)}, metadata={"v": 2})
    monkeypatch.undo()
    assert _snap(path + ".meta.json") == good_meta
    json.loads(_snap(path + ".meta.json"))


def test_atomic_write_replaces_only_on_success(tmp_path):
    path = str(tmp_path / "f.bin")
    ckpt_mod._atomic_write(path, lambda f: f.write(b"v1"))
    assert _snap(path) == b"v1"
    ckpt_mod._atomic_write(path, lambda f: f.write(b"v2-longer"))
    assert _snap(path) == b"v2-longer"

    def die(f):
        f.write(b"half")
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError):
        ckpt_mod._atomic_write(path, die)
    assert _snap(path) == b"v2-longer"
    assert os.listdir(tmp_path) == ["f.bin"]


# ---------------------------------------------------------------------------
# the payload through segments and a kill
# ---------------------------------------------------------------------------


def test_payload_segmented_bitwise(payload_plan, payload_straight):
    """An RW-SGD ensemble in segments is bitwise the straight run — the
    losses and every payload output included — and the straight run's
    integers are the reference's ensemble of the same walks."""
    got = payload_plan.ensemble_segmented(SEEDS, BASE_KEY, segment_steps=7)
    assert_bitwise(payload_straight, got, "payload segmented")
    ref = JExperiment(graph=random_regular_graph(N, DEG, seed=3),
                      protocol=JProtocolConfig(**PROTO, estimator_impl="compare",
                                               round_impl="unfused"),
                      failures=JFailureConfig(**CHURN), steps=STEPS,
                      outputs="full").ensemble(SEEDS, BASE_KEY)
    rec, learn = payload_straight
    for f in ("z", "forks", "terms", "failures", "fork_parent", "terminated"):
        np.testing.assert_array_equal(getattr(rec, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    assert bool((learn.trained.sum() > 0).item())


def test_payload_kill_resume_bitwise(payload_plan, payload_straight, tmp_path):
    """Killed at its second boundary and run again with the store, a
    training run resumes from the snapshot (replicas, moments and the
    losses so far) and ends bitwise the straight run; the snapshot's
    carry holds the replicas."""
    store = ResultStore(tmp_path / "store")
    fp = FaultPlan().skip("segment.boundary", 1).at("segment.boundary", Kill())
    with pytest.raises(SimulatedKill), fp.active():
        payload_plan.ensemble_segmented(SEEDS, BASE_KEY, segment_steps=8, store=store)
    (key,) = os.listdir(tmp_path / "store" / "segments")[0:1]
    (skey,) = os.listdir(tmp_path / "store" / "segments" / key)
    done, snap = store.latest_segment(skey)
    state, replicas = snap["carry"]
    assert done == 16 and int(state.t[0]) == 16
    assert replicas.params and replicas.steps.shape == (SEEDS, PROTO["max_walks"])
    got = payload_plan.ensemble_segmented(SEEDS, BASE_KEY, segment_steps=8, store=store)
    assert_bitwise(payload_straight, got, "payload kill + resume")
    assert store.segment_steps_on_disk(skey) == []
