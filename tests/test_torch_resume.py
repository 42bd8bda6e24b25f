"""Durable segmented execution in the port: bitwise segments and resume.

Contract under test, on the CPU (the kernels' plain versions):
  * ``run_segmented`` / ``ensemble_segmented`` / ``sweep_stacked(
    segment_steps=)`` are bitwise the port's straight call — every
    recorded field and the final state — for DecAFork, DecAFork+,
    MissingPerson and ``none`` under churny failures, and for a bloom
    walk against mobile Pac-Men and an edge cut (uneven last segments
    included); the straight calls' integers and final carries are bitwise
    the reference's ``Plan.run`` (n 24, W 10, 36 steps; the reference's
    ``ensemble`` and ``sweep`` are held in ``test_torch_checkpoint.py``
    and ``test_torch_store.py``);
  * a segment replays the straight run's cache slot: no new slot;
  * a SimulatedKill at any segment boundary, then the same call with the
    store, is bitwise the uninterrupted run, also under another
    ``segment_steps``; a torn latest snapshot falls back to the one
    before it.

No test here calls the reference's segmented entry points: they add slots to
the reference's process-wide cache (its own ``test_resume.py`` holds its
segmented path to its straight one).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.api import Experiment as JExperiment  # noqa: E402
from repro.core import FailureConfig as JFailureConfig  # noqa: E402
from repro.core import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.graphs import random_regular_graph  # noqa: E402
from repro_torch.api import Experiment, ResultStore, cache_stats  # noqa: E402
from repro_torch.api import plan as plan_mod  # noqa: E402
from repro_torch.core import FailureConfig, ProtocolConfig  # noqa: E402
from repro_torch.core import simulator as sim  # noqa: E402
from repro_torch.core.outputs import RecordedOutputs  # noqa: E402
from repro_torch.graphs import make_graph  # noqa: E402
from repro_torch.sweep import Scenario  # noqa: E402
from repro_torch.utils.faults import FaultPlan, Kill, SimulatedKill, Torn  # noqa: E402

PART = bool(jax.config.jax_threefry_partitionable)
N, DEG, W, Z0, STEPS, SEEDS, BASE_KEY = 24, 4, 10, 5, 36, 2, 7
INT_FIELDS = ("z", "forks", "terms", "failures", "fork_parent", "terminated")
CARRY = ("t", "walks.pos", "walks.active", "walks.track", "walks.prev", "walks.bloom",
         "last_seen", "rts.hist", "rts.total", "byz_state", "graph.node_up",
         "graph.edge_up", "theta_hist", "pacman_pos")
# the port's DecAFork rows take the whole_round kernel's path ("auto"); its
# oracle in the reference is the unfused round on the node-sum family
KERNEL = dict(estimator_impl="auto")
ORACLE = dict(estimator_impl="compare", round_impl="unfused")
CHURN = dict(burst_times=(9, 23), burst_sizes=(3, 2), p_node_fail=0.02, p_node_recover=0.3,
             p_link_fail=0.03, p_link_recover=0.4)
# the zoo's kitchen sink: churn, mobile Pac-Men and a scheduled cut
ZOO = dict(CHURN, pacman_nodes=(2, 11), pacman_mobile=True, pacman_hop_prob=0.5,
           edge_cut_times=(15,), edge_cut_thresholds=(12,))
ALGS = {
    "none": (dict(algorithm="none"), CHURN, {}),
    "missingperson": (dict(algorithm="missingperson", eps_mp=12.0), CHURN, {}),
    "decafork": (dict(eps=1.8), CHURN, "fused"),
    "decafork+": (dict(algorithm="decafork+", eps=1.8, eps2=6.0), CHURN, "fused"),
    "bloom": (dict(algorithm="decafork+", eps=1.8, eps2=6.0, walk_variant="bloom",
                   bloom_bits=64), ZOO, "unfused"),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graph():
    g = make_graph("regular", N, seed=3, degree=DEG)
    np.testing.assert_array_equal(np.asarray(g.neighbors),
                                  np.asarray(random_regular_graph(N, DEG, seed=3).neighbors))
    return g


def _cfgs(name, port=True):
    pkw, fkw, path = ALGS[name]
    P, F = (ProtocolConfig, FailureConfig) if port else (JProtocolConfig, JFailureConfig)
    extra = (KERNEL if port else ORACLE) if path == "fused" else (
        ORACLE if path == "unfused" else {})
    return P(**dict(z0=Z0, max_walks=W, rt_bins=32, protocol_start=8, **pkw, **extra)), F(**fkw)


def _plan(graph, name="decafork", **kw):
    pcfg, fcfg = _cfgs(name)
    return Experiment(graph=graph, protocol=pcfg, failures=fcfg, steps=STEPS, outputs="full",
                      device="cpu", partitionable=PART, **kw).plan()


def _ref(name):
    pcfg, fcfg = _cfgs(name, port=False)
    plan = JExperiment(graph=random_regular_graph(N, DEG, seed=3), protocol=pcfg,
                       failures=fcfg, steps=STEPS, outputs="full").plan()
    return plan.run(BASE_KEY)


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
        if x.dtype.is_floating_point:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), f"{label}: leaf {i} differs"


def _get(state, path):
    for part in path.split("."):
        state = getattr(state, part, None)
    return state


def assert_reference(port_rec, ref_rec, label, port_state=None, ref_state=None):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(port_rec, f).numpy(),
                                      np.asarray(getattr(ref_rec, f)), err_msg=f"{label}: {f}")
    np.testing.assert_allclose(port_rec.theta_mean.numpy(), np.asarray(ref_rec.theta_mean),
                               rtol=1e-6, atol=1e-6, err_msg=f"{label}: theta_mean")
    for path in CARRY if port_state is not None else ():
        got, want = _get(port_state, path), _get(ref_state, path)
        assert (got is None) == (want is None), f"{label}: {path}"
        if got is not None:
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want),
                                          err_msg=f"{label}: final {path}")


# ---------------------------------------------------------------------------
# segmented == straight, bitwise; straight == the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(ALGS))
def test_segmented_run_bitwise_per_algorithm(graph, name):
    """``run_segmented`` is bitwise ``run`` (13 does not divide 36: an
    uneven last segment), and ``run``'s integers and final carry are the
    reference's ``Plan.run``; the bloom walk carries ``prev`` / ``bloom``
    and the mobile Pac-Men their positions across every boundary."""
    plan = _plan(graph, name)
    want_path = ALGS[name][2] or "unfused"
    assert plan.decision.impl == want_path, plan.decision.reason
    s_ref, r_ref = plan.run(BASE_KEY)
    s_seg, r_seg = plan.run_segmented(BASE_KEY, segment_steps=13)
    assert_bitwise(r_ref, r_seg, f"{name}: outputs")
    assert_bitwise(s_ref, s_seg, f"{name}: final state")
    j_state, j_rec = _ref(name)
    assert_reference(r_ref, j_rec, f"{name} vs reference", s_ref, j_state)


def test_segmented_ensemble_bitwise(graph):
    plan = _plan(graph)
    want = plan.ensemble(SEEDS, BASE_KEY)
    got = plan.ensemble_segmented(SEEDS, BASE_KEY, segment_steps=17)
    assert_bitwise(want, got, "ensemble")


def test_segment_replays_the_straight_runs_slot(graph, monkeypatch):
    """A segmented run after a straight one of the same structure makes no
    cache slot: the segment length is not in the signature. Each segment
    is one runner call from the carried state, filling its columns of
    the run's own outputs."""
    plan = _plan(graph, "decafork+")
    plan.ensemble(SEEDS, BASE_KEY)
    entries = cache_stats()["entries"]
    calls = []
    real = sim.RoundRunner.run

    def counting(self, state, setup, carry=None, rounds=None, outputs=None, start=0):
        calls.append((start, rounds, outputs is None))
        return real(self, state, setup, carry, rounds, outputs, start)

    monkeypatch.setattr(sim.RoundRunner, "run", counting)
    plan.ensemble_segmented(SEEDS, BASE_KEY, segment_steps=10)
    assert cache_stats()["entries"] == entries
    assert calls == [(0, 10, True), (10, 10, False), (20, 10, False), (30, 6, False)]
    sig = plan._signature("ensemble", plan.pcfg, plan.fcfg, plan.decision, SEEDS)
    assert ("ensemble", sig) in plan_mod._EXECUTABLES
    assert not any("seg" in str(part) for part in sig)
    with pytest.raises(ValueError, match="segment_steps"):
        plan.ensemble_segmented(SEEDS, segment_steps=0)


def test_segmented_sweep_bitwise_and_store_interchange(graph, tmp_path):
    """Segmented sweeps land under the SAME content key as straight ones
    (warm hits interchange) and clear their snapshots on completion."""
    pcfg, fcfg = _cfgs("decafork")
    plan = _plan(graph)
    scens = [Scenario(f"e{e}", dataclasses.replace(pcfg, eps=e), fcfg) for e in (0.9, 1.8)]
    ref = plan.sweep_stacked(scens, seeds=SEEDS, base_key=1)
    store = ResultStore(tmp_path / "store")
    got = plan.sweep_stacked(scens, seeds=SEEDS, base_key=1, store=store, segment_steps=15)
    assert_bitwise(ref, got, "segmented sweep")
    before = store.hits
    warm = plan.sweep_stacked(scens, seeds=SEEDS, base_key=1, store=store)
    assert_bitwise(ref, warm, "warm interchange")
    assert store.hits == before + 1
    seg_root = tmp_path / "store" / "segments"
    assert not seg_root.exists() or not [p for p in seg_root.rglob("*") if p.is_file()]


# ---------------------------------------------------------------------------
# kill and resume
# ---------------------------------------------------------------------------


def _sweep(graph, name="decafork"):
    pcfg, fcfg = _cfgs(name)
    scens = [Scenario(f"e{e}", dataclasses.replace(pcfg, eps=e), fcfg) for e in (0.9, 1.8)]
    return _plan(graph, name), scens


@pytest.mark.parametrize("boundary", [0, 1, 2])
def test_kill_at_any_boundary_then_resume_is_bitwise(graph, tmp_path, boundary):
    """A SimulatedKill at the k-th boundary (its snapshot on disk), then
    the same call: it resumes from that snapshot and ends bitwise the
    uninterrupted run."""
    plan, scens = _sweep(graph)
    ref = plan.sweep_stacked(scens, seeds=SEEDS, base_key=1)
    store = ResultStore(tmp_path / "store")
    fp = FaultPlan().skip("segment.boundary", boundary).at("segment.boundary", Kill())
    with pytest.raises(SimulatedKill), fp.active():
        plan.sweep_stacked(scens, seeds=SEEDS, base_key=1, store=store, segment_steps=10)
    assert fp.fired
    group = plan._group(scens, SEEDS, 1)
    key = store.sweep_key(group["sig"], graph, group["configs"], SEEDS, plan_mod._as_key(1, "cpu"))
    assert store.segment_steps_on_disk(key)[0] == 10 * (boundary + 1)
    resumed = plan.sweep_stacked(scens, seeds=SEEDS, base_key=1, store=store, segment_steps=10)
    assert_bitwise(ref, resumed, f"kill at boundary {boundary} + resume")


def test_resume_is_chunking_independent(graph, tmp_path):
    """Snapshots are named by steps done, not by segment length: a run
    killed under segment_steps=9 resumes bitwise under 15."""
    plan, scens = _sweep(graph, "decafork+")
    ref = plan.sweep_stacked(scens, seeds=SEEDS, base_key=2)
    store = ResultStore(tmp_path / "store")
    fp = FaultPlan().skip("segment.boundary", 1).at("segment.boundary", Kill())
    with pytest.raises(SimulatedKill), fp.active():
        plan.sweep_stacked(scens, seeds=SEEDS, base_key=2, store=store, segment_steps=9)
    resumed = plan.sweep_stacked(scens, seeds=SEEDS, base_key=2, store=store, segment_steps=15)
    assert_bitwise(ref, resumed, "cross-chunking resume")


def test_run_segmented_kill_resume(graph, tmp_path):
    """The single-trajectory surface resumes bitwise too, final state
    included."""
    plan = _plan(graph, "missingperson")
    s_ref, r_ref = plan.run(BASE_KEY)
    store = ResultStore(tmp_path / "store")
    fp = FaultPlan().skip("segment.boundary", 1).at("segment.boundary", Kill())
    with pytest.raises(SimulatedKill), fp.active():
        plan.run_segmented(BASE_KEY, segment_steps=10, store=store)
    s_got, r_got = plan.run_segmented(BASE_KEY, segment_steps=10, store=store)
    assert_bitwise(r_ref, r_got, "run resume: outputs")
    assert_bitwise(s_ref, s_got, "run resume: final state")


def test_torn_snapshot_falls_back_to_previous(graph, tmp_path):
    """A torn latest snapshot (killed mid-write, a pre-atomic file at the
    final path) falls back to the previous boundary's snapshot, and the
    resumed run still ends bitwise."""
    plan, scens = _sweep(graph, "none")
    ref = plan.sweep_stacked(scens[:1], seeds=SEEDS, base_key=3)
    store = ResultStore(tmp_path / "store")
    # let the first snapshot (npz + meta) land, tear the second's npz
    fp = FaultPlan().skip("checkpoint.write", 2).at("checkpoint.write", Torn(keep_bytes=40))
    with pytest.raises(SimulatedKill), fp.active():
        plan.sweep_stacked(scens[:1], seeds=SEEDS, base_key=3, store=store, segment_steps=9)
    resumed = plan.sweep_stacked(scens[:1], seeds=SEEDS, base_key=3, store=store,
                                 segment_steps=9)
    assert store.misses >= 2  # the straight get and the torn snapshot
    assert_bitwise(ref, resumed, "torn snapshot + resume")


def test_latest_segment_skips_torn_and_deeper_snapshots(tmp_path):
    """``latest_segment``: a torn newest file falls back to the next older
    loadable snapshot; snapshots deeper than max_steps are ignored; keep-2
    prunes; clear drops them all."""
    store = ResultStore(tmp_path / "store")
    snap = {"carry": torch.arange(4, dtype=torch.int32), "recorded": None}
    for done in (5, 10, 20):
        store.put_segment("k" * 64, done, snap)
    assert store.segment_steps_on_disk("k" * 64) == [20, 10]  # keep the newest 2
    fp = FaultPlan().at("checkpoint.write", Torn(keep_bytes=16))
    with pytest.raises(SimulatedKill), fp.active():
        store.put_segment("k" * 64, 30, snap)
    steps_done, got = store.latest_segment("k" * 64)
    assert steps_done == 20 and got["recorded"] is None
    assert torch.equal(got["carry"], torch.arange(4, dtype=torch.int32))
    assert store.latest_segment("k" * 64, max_steps=15)[0] == 10
    store.clear_segments("k" * 64)
    assert store.latest_segment("k" * 64) is None
