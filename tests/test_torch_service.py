"""The port's ExperimentService: a coalescing submission queue.

Contract under test, on the CPU:
  * K submissions spanning G static structures run as exactly G runner
    runs (``sweep_stacked`` calls), however many callers contributed;
  * coalescing is bitwise-invisible: every caller's rows equal a private
    ``Plan.sweep`` of only their scenarios under the same seeds and key;
  * differing seeds or base keys never coalesce;
  * futures stream per-group results in completion order; errors reach
    exactly the touching futures;
  * the background worker delivers the same rows under concurrent
    submitters, survives its own death (futures fail, the service drains
    inline) and closes deterministically;
  * ``store="env"`` is the default, and the retry jitter comes from the
    service's own seeded generator.
"""
import random
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import Experiment, ExperimentService, SubmissionFuture  # noqa: E402
from repro_torch.api import cache_stats  # noqa: E402
from repro_torch.api.service import ServiceClosedError  # noqa: E402
from repro_torch.core import FailureConfig, ProtocolConfig  # noqa: E402
from repro_torch.core import simulator as sim  # noqa: E402
from repro_torch.core.outputs import RecordedOutputs  # noqa: E402
from repro_torch.graphs import make_graph  # noqa: E402
from repro_torch.sweep import Scenario  # noqa: E402
from repro_torch.utils.faults import (  # noqa: E402
    Delay,
    FaultPlan,
    Kill,
    Raise,
    SimulatedKill,
    TransientFault,
)

N, W, Z0, STEPS, SEEDS, BASE_KEY = 24, 10, 5, 40, 2, 7
WAIT = 120.0


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
    base = dict(algorithm="decafork", z0=Z0, max_walks=W, rt_bins=32, protocol_start=10,
                eps=1.8, estimator_impl="auto")
    base.update(kw)
    return ProtocolConfig(**base)


def _scen(name, **kw):
    fcfg = kw.pop("fcfg", FailureConfig())
    return Scenario(name, _pcfg(**kw), fcfg)


def _exp(graph, **kw):
    return Experiment(graph=graph, steps=STEPS, outputs="scalars", scenarios=[_scen("base")],
                      device="cpu", **kw)


def assert_bitwise(want, got, label):
    a, b = list(want), list(got)
    assert isinstance(got, RecordedOutputs) and len(a) == len(b), label
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32) if x.is_floating_point() else x,
                           y.view(torch.int32) if y.is_floating_point() else y), label


def _count_runs(monkeypatch):
    calls = []
    real = sim.RoundRunner.run

    def counting(self, *a, **kw):
        calls.append(self)
        return real(self, *a, **kw)

    monkeypatch.setattr(sim.RoundRunner, "run", counting)
    return calls


# ---------------------------------------------------------------------------
# coalescing: K submissions, G static structures, G runner runs
# ---------------------------------------------------------------------------


def test_submissions_coalesce_into_one_run_per_structure(graph, monkeypatch):
    """Five rows from three callers spanning TWO static structures
    (rt_bins 48 vs 64) run as exactly two runner runs on at most two new
    cache slots."""
    calls = _count_runs(monkeypatch)
    svc = ExperimentService(_exp(graph), store=None, autostart=False)
    f1 = svc.submit([_scen("a1", rt_bins=48, eps=1.6), _scen("a2", rt_bins=48, eps=2.0)],
                    seeds=SEEDS, base_key=BASE_KEY)
    f2 = svc.submit([_scen("b1", rt_bins=48, eps=2.4)], seeds=SEEDS, base_key=BASE_KEY)
    f3 = svc.submit([_scen("c1", rt_bins=64), _scen("c2", rt_bins=48, eps=1.9)],
                    seeds=SEEDS, base_key=BASE_KEY)
    before = cache_stats()["entries"]
    svc.flush()
    assert len(calls) == 2 and calls[0] is not calls[1]  # exactly G = 2
    assert svc.stats["batches"] == 2
    assert svc.stats["coalesced"] == 4  # the four rt_bins=48 rows shared
    assert cache_stats()["entries"] - before <= 2
    assert all(f.done() for f in (f1, f2, f3))
    assert isinstance(f1, SubmissionFuture) and list(f1.result().names) == ["a1", "a2"]
    svc.close()


def test_coalesced_results_bitwise_equal_private_sweep(graph):
    """A caller's coalesced rows are bitwise a private Plan.sweep of ONLY
    their scenarios: strangers sharing the batch are invisible."""
    mine = [_scen("mine1", eps=1.7), _scen("mine2", eps=2.1)]
    stranger = [_scen("other1", eps=2.5), _scen("other2", eps=1.9),
                _scen("other3", fcfg=FailureConfig(burst_times=(15,), burst_sizes=(2,)))]
    exp = _exp(graph)
    svc = ExperimentService(exp, store=None, autostart=False)
    f_mine = svc.submit(mine, seeds=SEEDS, base_key=BASE_KEY)
    f_other = svc.submit(stranger, seeds=SEEDS, base_key=BASE_KEY)
    svc.flush()
    res = f_mine.result()
    ref = exp.plan().sweep(mine, seeds=SEEDS, base_key=BASE_KEY)
    for name in ("mine1", "mine2"):
        assert_bitwise(ref[name], res[name], f"coalesced vs private: {name}")
    assert f_other.result().names == ("other1", "other2", "other3")
    assert svc.stats["batches"] == 1 and svc.stats["coalesced"] == 5
    svc.close()


def test_differing_seeds_or_base_key_never_coalesce(graph):
    svc = ExperimentService(_exp(graph), store=None, autostart=False)
    svc.submit([_scen("s1")], seeds=SEEDS, base_key=BASE_KEY)
    svc.submit([_scen("s2")], seeds=SEEDS + 1, base_key=BASE_KEY)
    svc.submit([_scen("s3")], seeds=SEEDS, base_key=BASE_KEY + 1)
    svc.submit([_scen("s4")], seeds=SEEDS, base_key=torch.tensor([0, BASE_KEY]))  # == BASE_KEY
    svc.flush()
    assert svc.stats["batches"] == 3 and svc.stats["coalesced"] == 2
    svc.close()


# ---------------------------------------------------------------------------
# futures: streaming, ordering, errors
# ---------------------------------------------------------------------------


def test_future_streams_per_group_results(graph):
    """A mixed submission yields scenarios per group as each group's run
    finishes (first-seen group order); ``result()`` restores submission
    order."""
    svc = ExperimentService(_exp(graph), store=None, autostart=False)
    fut = svc.submit([_scen("slow", rt_bins=64), _scen("fast1", rt_bins=48),
                      _scen("fast2", rt_bins=48, eps=2.2)], seeds=SEEDS)
    svc.flush()
    streamed = list(fut.stream())
    assert [name for name, _outs, _pay in streamed] == ["slow", "fast1", "fast2"]
    assert all(pay is None for _n, _o, pay in streamed)
    assert fut.result().names == ("slow", "fast1", "fast2")
    svc.close()


def test_submit_validates_eagerly(graph):
    svc = ExperimentService(_exp(graph), store=None, autostart=False)
    with pytest.raises(ValueError, match="at least one scenario"):
        svc.submit([], seeds=SEEDS)
    with pytest.raises(ValueError, match="duplicate scenario names"):
        svc.submit([_scen("dup"), _scen("dup")], seeds=SEEDS)
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit([_scen("late")], seeds=SEEDS)


def test_group_error_propagates_to_touching_futures_only(graph):
    """An invalid scenario (an array z0 defers the capacity check to
    stacking) poisons exactly the futures that share its batch; disjoint
    groups still deliver."""
    import numpy as np

    bad = Scenario("bad", _pcfg(z0=np.asarray(W + 5)), FailureConfig())
    svc = ExperimentService(_exp(graph), store=None, autostart=False)
    f_bad = svc.submit([bad], seeds=SEEDS)
    f_ok = svc.submit([_scen("ok", rt_bins=64)], seeds=SEEDS)
    svc.flush()
    with pytest.raises(ValueError, match="max_walks"):
        f_bad.result()
    with pytest.raises(ValueError, match="max_walks"):
        list(f_bad.stream())
    assert f_ok.result().names == ("ok",)
    svc.close()


def test_result_timeout_reports_progress(graph, monkeypatch):
    """result(timeout=) raises while the batch is in flight and resolves
    once it lands."""
    svc = ExperimentService(_exp(graph), store=None, autostart=True, linger=0.0)
    release = threading.Event()
    real = svc.plan.sweep_stacked

    def slow(*a, **kw):
        release.wait(60)
        return real(*a, **kw)

    monkeypatch.setattr(svc.plan, "sweep_stacked", slow)
    fut = svc.submit([_scen("s")], seeds=SEEDS)
    with pytest.raises(TimeoutError, match="0/1 scenarios"):
        fut.result(timeout=0.1)
    release.set()
    assert fut.result(timeout=WAIT).names == ("s",)
    svc.close()


# ---------------------------------------------------------------------------
# the background worker
# ---------------------------------------------------------------------------


def test_threaded_submitters_coalesce_and_match(graph):
    """Concurrent submitters against the live worker: every caller gets
    its own bitwise rows, and the runs number fewer than the submissions
    (the linger window coalesced some)."""
    exp = _exp(graph)
    ref = exp.plan().sweep([_scen(f"t{i}", eps=1.5 + 0.1 * i) for i in range(6)],
                           seeds=SEEDS, base_key=BASE_KEY)
    svc = ExperimentService(exp, store=None, autostart=True, linger=0.25)
    futures = [None] * 6
    start = threading.Barrier(6)

    def caller(i):
        start.wait()
        futures[i] = svc.submit([_scen(f"t{i}", eps=1.5 + 0.1 * i)], seeds=SEEDS,
                                base_key=BASE_KEY)

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, fut in enumerate(futures):
        assert_bitwise(ref[f"t{i}"], fut.result(timeout=WAIT)[f"t{i}"], f"threaded t{i}")
    assert svc.stats["submissions"] == 6 and svc.stats["batches"] < 6
    svc.close()


def test_concurrent_submitters_with_transient_faults(graph):
    """Chaos under concurrency: submitter threads race a worker that takes
    transient hits; every future resolves correctly."""
    svc = ExperimentService(_exp(graph), store=None, autostart=True, retries=3, linger=0.005,
                            backoff=0.0)
    scens = [_scen("a"), _scen("b", eps=0.9)]
    ref = svc.plan.sweep(scens, seeds=SEEDS, base_key=BASE_KEY)
    fp = FaultPlan().at("service.run_group", Raise(TransientFault("x")), Delay(0.002),
                        Raise(TransientFault("y")))
    results, errors = {}, []

    def submitter(i):
        try:
            results[i] = svc.submit(scens, seeds=SEEDS, base_key=BASE_KEY).result(timeout=WAIT)
        except BaseException as exc:  # noqa: BLE001 - recorded for the assert
            errors.append(exc)

    with fp.active():
        threads = [threading.Thread(target=submitter, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
            assert not t.is_alive(), "submitter hung"
    assert not errors, f"submitters failed: {errors!r}"
    for i, got in results.items():
        for name in ("a", "b"):
            assert_bitwise(ref[name], got[name], f"concurrent submitter {i}/{name}")
    svc.close(timeout=WAIT)


def test_worker_kill_fails_futures_and_service_drains_inline(graph):
    """A kill inside the worker's group run: the touching future errors
    (no hang), and flush and later submissions drain inline past the dead
    thread."""
    svc = ExperimentService(_exp(graph), store=None, autostart=True, linger=0.0, backoff=0.0)
    fp = FaultPlan().at("service.run_group", Kill())
    with fp.active():
        fut = svc.submit([_scen("a")], seeds=SEEDS, base_key=BASE_KEY)
        with pytest.raises(SimulatedKill):
            fut.result(timeout=WAIT)
    deadline = time.monotonic() + WAIT
    while svc._worker_alive() is not None:
        assert time.monotonic() < deadline, "worker did not die"
        time.sleep(0.005)
    ok = svc.submit([_scen("a")], seeds=SEEDS, base_key=BASE_KEY)
    svc.flush(timeout=WAIT)
    ref = svc.plan.sweep([_scen("a")], seeds=SEEDS, base_key=BASE_KEY)
    assert_bitwise(ref["a"], ok.result(timeout=WAIT)["a"], "submission after worker death")
    svc.close(timeout=WAIT)


def test_close_resolves_pending_and_post_close_submit_raises(graph):
    svc = ExperimentService(_exp(graph), store=None, autostart=False)
    fut = svc.submit([_scen("a")], seeds=SEEDS, base_key=BASE_KEY)
    svc.close(timeout=WAIT)
    assert fut.done()  # the final drain ran it
    fut.result(timeout=WAIT)
    with pytest.raises(ServiceClosedError, match="closed"):
        svc.submit([_scen("a")], seeds=SEEDS, base_key=BASE_KEY)
    svc.close(timeout=WAIT)  # idempotent


def test_close_is_deterministic_with_live_worker(graph):
    svc = ExperimentService(_exp(graph), store=None, autostart=True)
    futs = [svc.submit([_scen("a")], seeds=SEEDS, base_key=BASE_KEY) for _ in range(3)]
    svc.close(timeout=WAIT)
    for fut in futs:
        assert fut.done()
        fut.result(timeout=WAIT)
    with pytest.raises(ServiceClosedError):
        svc.submit([_scen("a")], seeds=SEEDS, base_key=BASE_KEY)


def test_service_run_convenience_and_context_manager(graph):
    with ExperimentService(_exp(graph), store=None, autostart=False) as svc:
        res = svc.run([_scen("one")], seeds=SEEDS, base_key=BASE_KEY)
        assert res.names == ("one",)


def test_env_store_default_and_seeded_jitter(graph, tmp_path, monkeypatch):
    """``store="env"`` (the default) opens ``$REPRO_RESULT_STORE``; a
    second submission is a warm hit that runs nothing. The backoff jitter
    comes from the service's own seeded ``random.Random``."""
    monkeypatch.setenv("REPRO_RESULT_STORE", str(tmp_path / "env"))
    svc = ExperimentService(_exp(graph), autostart=False)
    assert svc.store is not None and svc.store.root == str(tmp_path / "env")
    assert svc._rng.random() == random.Random(0).random()
    first = svc.run([_scen("a")], seeds=SEEDS, base_key=BASE_KEY)
    calls = _count_runs(monkeypatch)
    again = svc.run([_scen("a")], seeds=SEEDS, base_key=BASE_KEY)
    assert calls == [] and svc.store.hits == 1
    assert_bitwise(first["a"], again["a"], "store-warm resubmission")
    svc.close()


def test_threads_share_cached_runners_under_stress(graph):
    """More threads than cores, a short switch interval: submitters race
    the worker, and direct callers race each other on the same cached
    runner. Each runner run holds its lock, so every row is bitwise its
    own sequential run, and the service's counters lose no update."""
    import sys

    exp = Experiment(graph=graph, protocol=_pcfg(), steps=12, outputs="scalars", device="cpu")
    keys = list(range(10))
    want = {k: exp.ensemble(2, base_key=k) for k in keys}
    svc = ExperimentService(exp, store=None, autostart=True, linger=0.0)
    got, errors = {}, []
    start = threading.Barrier(len(keys))

    def worker(k):
        try:
            start.wait(WAIT)
            if k % 2:
                got[k] = exp.plan().ensemble(2, base_key=k)
            else:
                scen = Scenario(f"k{k}", exp.protocol, exp.failures)
                got[k] = svc.submit([scen], seeds=2, base_key=k).result(WAIT)[f"k{k}"]
        except BaseException as exc:  # noqa: BLE001 - recorded for the assert
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in keys]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert not any(t.is_alive() for t in threads), "a caller hung"
    finally:
        sys.setswitchinterval(interval)
        svc.close(timeout=WAIT)
    assert not errors, errors
    for k in keys:
        assert_bitwise(want[k], got[k], f"caller {k}")
    assert svc.stats["submissions"] == len(keys) // 2 == svc.stats["scenarios"]
