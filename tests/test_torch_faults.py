"""Chaos suite of the port's host-level fault harness
(``repro_torch.utils.faults``), against the port's own sites.

Every named site in ``SITES`` is exercised, and every injected failure
must yield a correct retry or a clean per-future error — never a hang
(every wait carries a timeout) and never a silently wrong result
(recovered paths are compared bitwise with an undisturbed run).

Site coverage:
  ``service.run_group``   the retry / exhaustion / split tests below;
  ``store.get``           the read-fault test below;
  ``store.put``           the write-behind test below;
  ``segment.boundary``    the kill-and-resume tests (``test_torch_resume.py``)
                          and the matrix below;
  ``checkpoint.write``    the torn-write tests (``test_torch_resume.py``)
                          and the matrix below.
The port's plan is its own: a plan activated in the JAX package's copy
does not fire here.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import Experiment, ResultStore  # noqa: E402
from repro_torch.api.service import (  # noqa: E402
    DeadlineExceededError,
    ExperimentService,
    default_retryable,
)
from repro_torch.core import FailureConfig, ProtocolConfig  # noqa: E402
from repro_torch.core.outputs import RecordedOutputs  # noqa: E402
from repro_torch.graphs import make_graph  # noqa: E402
from repro_torch.sweep import Scenario  # noqa: E402
from repro_torch.utils import faults  # noqa: E402
from repro_torch.utils.faults import (  # noqa: E402
    Delay,
    FaultPlan,
    Kill,
    PermanentFault,
    Raise,
    SimulatedKill,
    Torn,
    TransientFault,
    fault_point,
)

N, W, Z0, STEPS, SEEDS, BASE_KEY = 24, 10, 5, 30, 2, 7
WAIT = 120.0  # every blocking call is bounded: a hang is a failure


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graph():
    return make_graph("regular", N, seed=3, degree=4)


def _pcfg(**kw):
    base = dict(algorithm="decafork", z0=Z0, max_walks=W, rt_bins=32, protocol_start=8,
                eps=1.8, estimator_impl="auto")
    base.update(kw)
    return ProtocolConfig(**base)


def _scen(name, **kw):
    fcfg = kw.pop("fcfg", FailureConfig())
    return Scenario(name, _pcfg(**kw), fcfg)


def _exp(graph):
    return Experiment(graph=graph, steps=STEPS, outputs="scalars", scenarios=[_scen("base")],
                      device="cpu")


def _service(graph, **kw):
    kw.setdefault("store", None)
    kw.setdefault("autostart", False)
    kw.setdefault("backoff", 0.0)
    return ExperimentService(_exp(graph), **kw)


def assert_bitwise(want, got, label):
    a = list(want) if isinstance(want, RecordedOutputs) else [want]
    b = list(got) if isinstance(got, RecordedOutputs) else [got]
    assert len(a) == len(b), label
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32) if x.is_floating_point() else x,
                           y.view(torch.int32) if y.is_floating_point() else y), label


# ---------------------------------------------------------------------------
# FaultPlan mechanics
# ---------------------------------------------------------------------------


def test_fault_point_is_noop_without_active_plan():
    assert fault_point("store.get") is None
    assert fault_point("checkpoint.write", tearable=True) is None


def test_plan_fifo_targets_kth_invocation_and_counts_hits():
    plan = FaultPlan().skip("store.get", 2).at("store.get", Raise(TransientFault("boom")))
    with plan.active():
        fault_point("store.get")
        fault_point("store.get")
        with pytest.raises(TransientFault, match="boom"):
            fault_point("store.get")
        fault_point("store.get")  # queue drained: back to a no-op
    assert plan.hits["store.get"] == 4
    assert plan.pending("store.get") == 0
    assert [s for s, _ in plan.fired] == ["store.get"]


def test_plan_deactivates_on_exit_and_nests():
    outer, inner = FaultPlan(), FaultPlan()
    with outer.active():
        with inner.active():
            fault_point("store.put")
        fault_point("store.put")
    fault_point("store.put")
    assert inner.hits == {"store.put": 1}
    assert outer.hits == {"store.put": 1}
    # a plan activated in the reference's module is not the port's
    ref_faults = pytest.importorskip("repro.utils.faults")
    ref_plan = ref_faults.FaultPlan().at("store.put", Raise(TransientFault("no")))
    with ref_plan.active():
        assert fault_point("store.put") is None
    assert ref_plan.pending("store.put") == 1


def test_torn_at_non_tearable_site_raises():
    plan = FaultPlan().at("store.get", Torn())
    with plan.active(), pytest.raises(RuntimeError, match="non-tearable"):
        fault_point("store.get")


def test_kill_is_a_base_exception():
    with pytest.raises(SimulatedKill):
        try:
            Kill().fire("segment.boundary")
        except Exception:  # a best-effort handler must NOT swallow a kill
            pytest.fail("SimulatedKill was caught by `except Exception`")


def test_delay_just_sleeps():
    plan = FaultPlan().at("store.put", Delay(0.01))
    t0 = time.monotonic()
    with plan.active():
        assert fault_point("store.put") is None
    assert time.monotonic() - t0 >= 0.01


def test_default_retryable_classification():
    assert default_retryable(TransientFault("x"))
    assert default_retryable(OSError("disk"))
    assert default_retryable(TimeoutError("slow"))
    assert not default_retryable(PermanentFault("x"))
    assert not default_retryable(ValueError("bad config"))


# ---------------------------------------------------------------------------
# service retry / degradation / deadline
# ---------------------------------------------------------------------------


def test_transient_fault_retries_then_succeeds_bitwise(graph):
    svc = _service(graph, retries=2)
    ref = svc.plan.sweep([_scen("a"), _scen("b", eps=0.9)], seeds=SEEDS, base_key=BASE_KEY)
    plan = FaultPlan().at("service.run_group", Raise(TransientFault("blip")))
    with plan.active():
        fut = svc.submit([_scen("a"), _scen("b", eps=0.9)], seeds=SEEDS, base_key=BASE_KEY)
        svc.flush(timeout=WAIT)
    got = fut.result(timeout=WAIT)
    assert svc.stats["retries"] == 1 and svc.stats["splits"] == 0
    for name in ("a", "b"):
        assert_bitwise(ref[name], got[name], f"retried result {name}")
    svc.close()


def test_retries_exhausted_fails_cleanly_service_survives(graph):
    svc = _service(graph, retries=1)
    # retries=1: two attempts, both faulted; one member, nothing to split
    plan = FaultPlan().at("service.run_group", Raise(TransientFault("1")),
                          Raise(TransientFault("2")))
    with plan.active():
        fut = svc.submit([_scen("a")], seeds=SEEDS, base_key=BASE_KEY)
        svc.flush(timeout=WAIT)
        with pytest.raises(TransientFault):
            fut.result(timeout=WAIT)
    ok = svc.submit([_scen("a")], seeds=SEEDS, base_key=BASE_KEY)
    svc.flush(timeout=WAIT)
    ref = svc.plan.sweep([_scen("a")], seeds=SEEDS, base_key=BASE_KEY)
    assert_bitwise(ref["a"], ok.result(timeout=WAIT)["a"], "post-failure submission")
    svc.close()


def test_permanent_fault_never_retries(graph):
    svc = _service(graph, retries=3)
    plan = FaultPlan().at("service.run_group", Raise(PermanentFault("no")))
    with plan.active():
        fut = svc.submit([_scen("a")], seeds=SEEDS, base_key=BASE_KEY)
        svc.flush(timeout=WAIT)
        with pytest.raises(PermanentFault):
            fut.result(timeout=WAIT)
    assert svc.stats["retries"] == 0
    svc.close()


def test_injected_group_fault_splits_and_members_recover(graph):
    """A non-retryable fault on a 2-member group splits it; both members
    then succeed on their own, bitwise."""
    svc = _service(graph, retries=0)
    scens = [_scen("a"), _scen("b", eps=0.9)]
    ref = svc.plan.sweep(scens, seeds=SEEDS, base_key=BASE_KEY)
    plan = FaultPlan().at("service.run_group", Raise(PermanentFault("grp")))
    with plan.active():
        fut = svc.submit(scens, seeds=SEEDS, base_key=BASE_KEY)
        svc.flush(timeout=WAIT)
        got = fut.result(timeout=WAIT)
    assert svc.stats["splits"] == 1
    for name in ("a", "b"):
        assert_bitwise(ref[name], got[name], f"split recovery {name}")
    svc.close()


def test_poisoned_scenario_fails_only_its_own_future(graph):
    """The natural poison: a z0 > max_walks scenario whose z0 is an array
    coalesces (z0 is no static field) but fails validation when the group
    stacks. The co-batched innocent submission still succeeds, bitwise."""
    svc = _service(graph)
    good = _scen("good")
    poisoned = Scenario("bad", _pcfg(z0=np.asarray(W + 5)), FailureConfig())
    ref = svc.plan.sweep([good], seeds=SEEDS, base_key=BASE_KEY)
    fut_good = svc.submit([good], seeds=SEEDS, base_key=BASE_KEY)
    fut_bad = svc.submit([poisoned], seeds=SEEDS, base_key=BASE_KEY)
    svc.flush(timeout=WAIT)
    assert svc.stats["splits"] == 1
    assert_bitwise(ref["good"], fut_good.result(timeout=WAIT)["good"], "innocent submission")
    with pytest.raises(ValueError, match="max_walks"):
        fut_bad.result(timeout=WAIT)
    svc.close()


def test_submission_deadline_exceeded(graph):
    svc = _service(graph)
    fut = svc.submit([_scen("a")], seeds=SEEDS, base_key=BASE_KEY, timeout=0.0)
    time.sleep(0.005)
    svc.flush(timeout=WAIT)
    with pytest.raises(DeadlineExceededError):
        fut.result(timeout=WAIT)
    svc.close()


# ---------------------------------------------------------------------------
# store faults: degrade, never take the caller down
# ---------------------------------------------------------------------------


def test_store_get_fault_degrades_to_recompute_bitwise(graph, tmp_path):
    store = ResultStore(tmp_path / "store")
    plan = _exp(graph).plan()
    scens = [_scen("a")]
    ref = plan.sweep_stacked(scens, seeds=SEEDS, base_key=1, store=store)
    misses = store.misses
    fp = FaultPlan().at("store.get", Raise(OSError("flaky disk")))
    with fp.active():
        got = plan.sweep_stacked(scens, seeds=SEEDS, base_key=1, store=store)
    assert store.misses == misses + 1  # the read fault counted as a miss
    assert_bitwise(ref, got, "recompute under a store.get fault")


def test_snapshot_writebehind_fault_degrades_with_warning(graph, tmp_path):
    """A failing snapshot write costs only durability (a warning), never
    correctness or the run itself."""
    store = ResultStore(tmp_path / "store")
    plan = _exp(graph).plan()
    scens = [_scen("a")]
    ref = plan.sweep_stacked(scens, seeds=SEEDS, base_key=1)
    fp = FaultPlan().at("store.put", Raise(OSError("disk full")))
    with fp.active(), pytest.warns(UserWarning, match="write-behind"):
        got = plan.sweep_stacked(scens, seeds=SEEDS, base_key=1, store=store, segment_steps=10)
    assert_bitwise(ref, got, "segmented run under a store.put fault")


# ---------------------------------------------------------------------------
# the chaos matrix: every documented site is real and exercised
# ---------------------------------------------------------------------------


def test_every_documented_site_is_hit_by_one_durable_service_run(graph, tmp_path):
    """One durable service run (segments + a store + a retried transient)
    passes through EVERY site in ``faults.SITES``."""
    store = ResultStore(tmp_path / "store")
    svc = _service(graph, store=store, segment_steps=10, retries=1)
    fp = FaultPlan().at("service.run_group", Raise(TransientFault("once")))
    with fp.active():
        fut = svc.submit([_scen("a")], seeds=SEEDS, base_key=BASE_KEY)
        svc.flush(timeout=WAIT)
        got = fut.result(timeout=WAIT)
    assert set(faults.SITES) <= set(fp.hits), f"unhit sites: {set(faults.SITES) - set(fp.hits)}"
    assert fp.hits["segment.boundary"] == 3 and svc.stats["retries"] == 1
    ref = svc.plan.sweep([_scen("a")], seeds=SEEDS, base_key=BASE_KEY)
    assert_bitwise(ref["a"], got["a"], "durable service run")
    svc.close(timeout=WAIT)


def test_sites_tuple_matches_module_doc():
    assert faults.SITES == (
        "checkpoint.write", "store.get", "store.put", "service.run_group", "segment.boundary",
    )
    for site in faults.SITES:
        assert f"``{site}``" in faults.__doc__
