"""The port's compiled execution on the CPU: the Plan's executable cache
(the counterpart of ``tests/test_api.py``'s compile-cache tests) and the
runners a CUDA graph replays, which run eagerly here through the same
static buffers.

  - re-running a structure with new keys, thresholds, schedules or a
    fresh Plan opens no new slot, and its results equal a fresh eager
    run (the numeric leaves were copied in, not frozen);
  - a static field (``rt_bins``) opens exactly one slot; a mixed sweep
    one per group; ``cache_stats`` has its documented shape;
  - a runner's run equals ``simulator.run_rounds`` bitwise, outputs and
    final carry, for a fused group, MissingPerson and ``auto_eps``, at a
    step count that is not a round number, also when it records in
    chunks that do not divide it, and its results do not alias the
    buffers a later run overwrites;
  - a captured graph's kernel nodes count as launches of the wrapper
    whose device function they run;
  - the decode loop through ``DecodeGraph`` equals the eager loop, and a
    model keeps only its most recently used decode loops.

n = 24, W = 16, B = 64, 37 steps, 3 seeds; no JAX.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import api  # noqa: E402
from repro_torch.api import Experiment, cache_stats  # noqa: E402
from repro_torch.api import plan as plan_mod  # noqa: E402
from repro_torch.core import simulator as sim  # noqa: E402
from repro_torch.core.failures import FailureConfig  # noqa: E402
from repro_torch.core.outputs import FULL  # noqa: E402
from repro_torch.core.protocol import ProtocolConfig  # noqa: E402
from repro_torch.graphs import make_graph  # noqa: E402
from repro_torch.sweep import Scenario  # noqa: E402
from repro_torch.utils import prng  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

STEPS, SEEDS = 37, 3
BASE = dict(z0=6, max_walks=16, rt_bins=64, protocol_start=10)
FCFG = FailureConfig(burst_times=(15,), burst_sizes=(2,), p_fail=0.01)
CASES = {
    "fused": (ProtocolConfig(eps=2.0, estimator_impl="auto", **BASE), FCFG),
    "missingperson": (ProtocolConfig("missingperson", eps_mp=12.0, **BASE), FCFG),
    "auto_eps": (ProtocolConfig("decafork+", eps=3.0, eps2=7.57, auto_eps=True,
                                estimator_impl="pallas", auto_min_samples=3, **BASE),
                 FailureConfig(burst_times=(20,), burst_sizes=(3,), p_node_fail=0.02,
                               p_node_recover=0.3)),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: under xdist the workers share the
    cores, and a torch thread per core slows many small ops a
    hundredfold."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def graph():
    return make_graph("erdos_renyi", 24, seed=0)


@pytest.fixture(autouse=True)
def fresh_cache():
    plan_mod.clear_cache()
    yield
    plan_mod.clear_cache()


def _pcfg(alg="decafork", **kw):
    return ProtocolConfig(alg, **{**BASE, "eps": 2.0, **kw})


def _exp(graph, pcfg=None, fcfg=FCFG, **kw):
    return Experiment(graph=graph, protocol=pcfg or _pcfg(), failures=fcfg, steps=STEPS,
                      device="cpu", **kw)


def _eager_ensemble(exp, seeds, base_key, spec=None):
    """The same ensemble through the eager round loop."""
    plan = exp.plan()
    keys = prng.split(prng.key(base_key), seeds)
    _final, rec = sim.run_core(keys, plan._setup(seeds), spec or plan.spec, plan.decision)
    return rec


def _same(a, b):
    a, b = tree_leaves(tuple(a)), tree_leaves(tuple(b))
    return len(a) == len(b) > 0 and all(torch.equal(x, y) for x, y in zip(a, b))


def test_plan_reuse_opens_no_new_slot(graph):
    """Repeated run / ensemble / sweep_stacked of one structure: no new
    slot across calls, re-planned Experiments and new numeric values; the
    re-runs equal fresh eager runs, so the new values took effect."""
    exp = _exp(graph)
    plan = exp.plan()
    plan.run(key=0)
    plan.ensemble(SEEDS, base_key=0)
    plan.sweep_stacked([(_pcfg(eps=e), FCFG) for e in (1.6, 2.0, 2.4)], seeds=SEEDS)
    assert cache_stats()["entries"] == 3  # one per mode

    plan.run(key=1)
    exp.plan().run(key=3)
    other = _exp(graph, _pcfg(eps=2.2, protocol_start=5),
                 FailureConfig(burst_times=(12,), burst_sizes=(1,), p_fail=0.02))
    got = other.ensemble(SEEDS, base_key=4)
    assert _same(got, _eager_ensemble(other, SEEDS, 4))
    stacked = plan.sweep_stacked([(_pcfg(eps=e), FCFG) for e in (1.5, 1.9, 2.3)],
                                 seeds=SEEDS, base_key=5)
    assert _same(stacked.map(lambda v: v[2]),
                 _eager_ensemble(_exp(graph, _pcfg(eps=2.3)), SEEDS, 5))
    assert cache_stats()["entries"] == 3


def test_static_field_change_opens_one_new_slot(graph):
    """``rt_bins`` re-captures exactly once; going back hits the old slot."""
    base = _exp(graph)
    base.ensemble(SEEDS)
    n0 = cache_stats()["entries"]
    changed = _exp(graph, _pcfg(rt_bins=32))
    changed.ensemble(SEEDS)
    assert cache_stats()["entries"] == n0 + 1
    base.ensemble(SEEDS, base_key=9)
    got = changed.ensemble(SEEDS, base_key=9)
    assert cache_stats()["entries"] == n0 + 1
    assert _same(got, _eager_ensemble(changed, SEEDS, 9))


def test_mixed_groups_one_slot_each(graph):
    """A mixed sweep opens one slot per static group; re-running it, with
    another key or its rows permuted, adds nothing."""
    fc = FailureConfig(burst_times=(20,), burst_sizes=(2,))
    scenarios = [
        Scenario("dfk/1.6", _pcfg(eps=1.6), fc),
        Scenario("mp", _pcfg("missingperson", eps_mp=12.0), fc),
        Scenario("dfk/2.0", _pcfg(eps=2.0), fc),
    ]
    exp = Experiment(graph=graph, scenarios=scenarios, steps=STEPS, device="cpu")
    first = exp.sweep(seeds=SEEDS)
    assert cache_stats()["entries"] == 2  # decafork, missingperson
    again = exp.plan().sweep(list(reversed(scenarios)), seeds=SEEDS)
    exp.sweep(seeds=SEEDS, base_key=1)
    assert cache_stats()["entries"] == 2
    for s in scenarios:
        assert _same(first[s.name], again[s.name])


def test_cache_stats_shape(graph):
    st = cache_stats()
    assert st == {"entries": 0, "graphs_captured": 0, "by_mode": {}}
    _exp(graph).ensemble(SEEDS)
    _exp(graph).run()
    st = api.cache_stats()
    assert set(st) == {"entries", "graphs_captured", "by_mode"}
    assert st["entries"] == 2
    assert st["graphs_captured"] == sum(st["by_mode"].values())
    assert set(st["by_mode"]) == {"ensemble", "run"}
    assert st["graphs_captured"] == 0  # the CPU runs eagerly: nothing is captured


def test_plan_signature_keys():
    """Static structure changes the signature; numeric leaves do not."""
    def sig(pcfg, fcfg=FCFG, **kw):
        d = sim.round_impl_decision(pcfg, fcfg)
        args = dict(batch=3, device="cpu", partitionable=True, decision=d)
        args.update(kw)
        return plan_mod.plan_signature(
            "ensemble", 24, 8, STEPS, pcfg, plan_mod._schedule_lens(fcfg), FULL,
            fcfg.static_fields, **args)

    base = sig(_pcfg())
    assert sig(_pcfg(eps=2.7, z0=5, protocol_start=3)) == base
    assert sig(_pcfg(), FailureConfig(burst_times=(3,), burst_sizes=(1,), p_fail=0.3)) == base
    assert sig(_pcfg(rt_bins=32)) != base
    assert sig(_pcfg(fork_prob=0.2)) != base
    assert sig(_pcfg(), FailureConfig()) != base  # no burst: another schedule length
    assert sig(_pcfg(), batch=4) != base
    assert sig(_pcfg(), partitionable=False) != base
    hash(base)


@pytest.mark.parametrize("case", sorted(CASES))
def test_runner_is_the_eager_loop(graph, case):
    """A runner's run equals ``run_rounds`` bitwise, recorded outputs and
    final carry; a second run with other keys and thresholds reuses the
    buffers and equals its own eager run, and leaves the first run's
    results untouched."""
    pcfg, fcfg = CASES[case]
    plan = _exp(graph, pcfg, fcfg, outputs="full").plan()
    setup = plan._setup(SEEDS)
    runner = sim.RoundRunner(setup, FULL, plan.decision)
    results = []
    for key, eps in ((0, pcfg.eps), (1, pcfg.eps + 0.5)):
        setup = sim.make_setup(graph, [dataclasses.replace(pcfg, eps=eps)] * SEEDS,
                               [fcfg] * SEEDS, STEPS, "cpu")
        keys = prng.split(prng.key(key), SEEDS)
        want = sim.run_rounds(sim.init_state(keys, setup), setup, STEPS, FULL, plan.decision)
        got = runner.run(sim.init_state(keys, setup), setup)
        assert _same(tuple(got[0]), tuple(want[0])), f"{case}: final carry"
        assert _same(got[1], want[1]), f"{case}: recorded outputs"
        assert got[1].z.shape == (SEEDS, STEPS)
        results.append((got, want))
    (first, want0), _ = results
    assert _same(first[1], want0[1]) and _same(tuple(first[0]), tuple(want0[0]))
    assert int(want0[1].forks.sum()) > 0  # the rules fired
    assert runner.captures == 0


def test_runner_refuses_another_structure(graph):
    plan = _exp(graph).plan()
    runner = sim.RoundRunner(plan._setup(SEEDS), plan.spec, plan.decision)
    setup = plan._setup(SEEDS + 1)
    keys = prng.split(prng.key(0), SEEDS + 1)
    with pytest.raises(ValueError, match="signature missed a shape"):
        runner.run(sim.init_state(keys, setup), setup)


@pytest.mark.parametrize("arch", ["yi_6b", "mamba2_1_3b"])
def test_decode_graph_is_the_eager_loop(arch):
    """``generate`` (the DecodeGraph loop, eager on the CPU) equals
    ``generate_eager``: greedy, and sampled with an EOS early exit; a
    second call of the same signature reuses its DecodeGraph."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import generate, generate_eager
    from repro_torch.models import Model

    cfg = get_smoke_config(arch)
    model = Model(cfg)
    params = model.init(prng.key(0), "cpu")
    toks = {"tokens": torch.as_tensor(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)), dtype=torch.int32)}
    got, stats = generate(model, params, toks, 6)
    want, wstats = generate_eager(model, params, toks, 6)
    assert torch.equal(got, want) and stats["decode_steps"] == wstats["decode_steps"] == 5
    again, _ = generate(model, params, toks, 6)
    assert torch.equal(again, want) and len(model.decode_graphs) == 1
    kw = dict(temperature=0.8, key=prng.key(7))
    sampled, _ = generate(model, params, toks, 10, **kw)
    eos = int(sampled[0, 1])
    for every in (1, 0):
        got, stats = generate(model, params, toks, 10, eos_id=eos, eos_check_every=every, **kw)
        want, wstats = generate_eager(model, params, toks, 10, eos_id=eos, eos_check_every=every,
                                      **kw)
        assert torch.equal(got, want)
        assert stats["decode_steps"] == wstats["decode_steps"]
        assert stats.keys() == wstats.keys()


@pytest.mark.parametrize("case", sorted(CASES))
def test_runner_records_in_chunks(graph, case, monkeypatch):
    """With a recording chunk that does not divide the run (8 rounds for
    37), a runner keeps chunk-sized buffers only and its run still equals
    ``run_rounds`` bitwise."""
    monkeypatch.setattr(sim, "RECORD_CHUNK", 8)
    pcfg, fcfg = CASES[case]
    plan = _exp(graph, pcfg, fcfg, outputs="full").plan()
    setup = plan._setup(SEEDS)
    runner = sim.RoundRunner(setup, FULL, plan.decision)
    assert all(b.shape[:2] == (SEEDS, 8) for b in runner.recorded)
    keys = prng.split(prng.key(1), SEEDS)
    want = sim.run_rounds(sim.init_state(keys, setup), setup, STEPS, FULL, plan.decision)
    got = runner.run(sim.init_state(keys, setup), setup)
    assert _same(tuple(got[0]), tuple(want[0])) and _same(got[1], want[1])
    assert got[1].z.shape == (SEEDS, STEPS)


def test_launches_per_replay_reads_device_function_names():
    """A captured graph's kernel nodes count as launches of the wrapper
    whose device function they run (C++ names as compiled, mangled, or
    plain for ``extern "C"``), one per node; other kernels count for no
    wrapper."""
    from repro_torch.kernels import flash_attention, ssd_intra_chunk, theta_sums, whole_round
    from repro_torch.kernels.capture import launches_per_replay, runs_symbol

    names = (["_Z18whole_round_kernel5Round"]
             + ["_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11FillFunctorIiEE"] * 3
             + ["_Z12flash_kernelILi32EEvPKfS1_S1_Pfiiiiiif",
                "_Z17flash_sm90_kernelILi128EEv14CUtensorMap_stS0_S0_P13__nv_bfloat16iiiif",
                "_Z13scores_kernelPK13__nv_bfloat16S1_Pfii", "theta_sums_kernel",
                "_Z19my_scores_kernel_v2Pf"])
    assert launches_per_replay(names) == {whole_round: 1, flash_attention: 2,
                                          ssd_intra_chunk: 1, theta_sums: 1}
    assert launches_per_replay(names[1:4]) == {}
    assert not runs_symbol("_Z19whole_round_kernel2v", "whole_round_kernel")


def test_decode_graphs_keep_the_most_recent():
    """A model keeps ``DECODE_GRAPHS`` decode loops, dropping the least
    recently used; a kept loop decodes another prompt of its shape as the
    eager loop does (its static cache refilled by each prefill)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import Model

    cfg = get_smoke_config("yi_6b")
    model = Model(cfg)
    params = model.init(prng.key(0), "cpu")
    rng = np.random.default_rng(2)

    def toks():
        return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 12)),
                                          dtype=torch.int32)}

    first = toks()
    serve.generate(model, params, first, 3)
    for new in range(4, 4 + serve.DECODE_GRAPHS):
        serve.generate(model, params, toks(), new)
    assert len(model.decode_graphs) == serve.DECODE_GRAPHS
    assert [s[3] for s in model.decode_graphs] == list(range(4, 4 + serve.DECODE_GRAPHS))
    for batch in (first, toks()):  # a recent loop, another prompt
        got, _ = serve.generate(model, params, batch, 5)
        want, _ = serve.generate_eager(model, params, batch, 5)
        assert torch.equal(got, want)
    assert list(model.decode_graphs)[-1][3] == 5
