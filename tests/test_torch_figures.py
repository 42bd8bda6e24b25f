"""The port's figure drivers of Figs. 1, 2, 3, 5 and 7 and
``theory_bounds`` (``repro_torch.figures``; all on the default regular
graph, n 100, d 8) against the reference's figure scripts
(``benchmarks/``, read, never run) and the live JAX package on the CPU.

  - each driver's scenario list (names, config fields, graphs) equals the
    list its reference script's ``run()`` builds from ``repro``'s
    configs, at the reference's constants and at the tiny setting (80
    steps, 2 seeds, decisions from step 20, bursts at 40 / 60, Fig. 3's
    Byzantine node from step 30, Fig. 7's crash and Pac-Man at step 40);
    the port adds only its execution fields (``estimator_impl``);
  - at the tiny setting, each driver's integer metrics (forks, terms,
    max_z, min_z_post, reaction_median, survival_rate, overshoot, mean_z
    from the integer Z) equal ``benchmarks/common.py``'s metrics of the
    reference's trajectories on the node-sum oracle's round
    (``estimator_impl="compare", round_impl="unfused"``), one reference
    ensemble per scenario; the port runs its kernels' path;
    ``theory_bounds``' bounds are equal;
  - the command line: ``fig8`` runs at a tiny override, results go to
    ``--out``.

Figs. 4 and 6 and ``auto_eps`` are in ``test_torch_figures_cases.py``,
Fig. 9 in ``test_torch_zoo.py`` and ``test_torch_zoo_grid.py``.
"""
import dataclasses
import json
import os
import sys

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
if ROOT not in sys.path:  # the reference's figure scripts live in benchmarks/
    sys.path.insert(0, ROOT)

import benchmarks.common as bc  # noqa: E402
from benchmarks import fig5_epsilon as rfig5  # noqa: E402
from benchmarks import fig7_topology as rfig7  # noqa: E402
import repro.api as japi  # noqa: E402
from repro.core import FailureConfig as JFailureConfig  # noqa: E402
from repro.core import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.core import theory as jth  # noqa: E402
from repro.graphs import arrival_rate_estimate, return_rate_estimate  # noqa: E402
from repro.sweep import Scenario as JScenario  # noqa: E402
from repro_torch.figures import (  # noqa: E402
    common, fig1_burst, fig2_probabilistic, fig3_byzantine, fig5_epsilon, fig7_topology,
    run as cli, theory_bounds,
)

PART = bool(jax.config.jax_threefry_partitionable)
# the tiny setting: every driver's run() takes these overrides
TINY = dict(steps=80, seeds=2, proto_start=20)
BURSTS = (40, 60)
ORACLE = dict(estimator_impl="compare", round_impl="unfused")
EXECUTION = ("estimator_impl", "round_impl")
INT_METRICS = ("forks", "terms", "max_z", "min_z_post", "reaction_median", "survival_rate",
               "mean_z", "overshoot")
EXTRA = {"fig3": dict(byz_at=30), "fig7": dict(crash_at=40)}
DRIVERS = {"fig1": fig1_burst, "fig2": fig2_probabilistic, "fig3": fig3_byzantine,
           "fig5": fig5_epsilon, "fig7": fig7_topology, "theory": theory_bounds}
# drivers that schedule bursts (Figs. 3 and 7 read them only for the
# reaction metric)
WITH_BURSTS = ("fig1", "fig2", "fig5", "theory")


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


def use_constants(monkeypatch, tiny: bool) -> None:
    """Set the reference scripts' module constants to the tiny setting or
    leave their defaults."""
    if not tiny:
        return
    for mod in (bc, rfig7):
        monkeypatch.setattr(mod, "PROTO_START", TINY["proto_start"])
    monkeypatch.setattr(bc, "STEPS", TINY["steps"])
    monkeypatch.setattr(bc, "BURSTS", BURSTS)
    monkeypatch.setattr(rfig7, "CRASH_AT", EXTRA["fig7"]["crash_at"])


def reference_lists(name: str, tiny: bool) -> list:
    """``[(graph, [Scenario])]`` of driver ``name`` as its reference
    script's ``run()`` builds it (``benchmarks/<figure>.py``), at the
    constants :func:`use_constants` set."""
    start = bc.PROTO_START
    g = bc.default_graph()
    fcfg = bc.burst_failures()
    byz_at = EXTRA["fig3"]["byz_at"] if tiny else start + 1000
    byz = JFailureConfig(byzantine_node=0, p_byz=0.001, byz_start_time=byz_at)
    return {
        "fig1": lambda: [(g, [bc.scenario(f"fig1/{alg}", alg, fcfg)
                              for alg in ("missingperson", "decafork", "decafork+")])],
        "fig2": lambda: [(g, [bc.scenario(f"fig2/{alg}/pf={pf}", alg,
                                          bc.burst_failures(p_fail=pf, p_fail_start=start))
                              for pf in (0.001, 0.0002) for alg in ("decafork", "decafork+")])],
        "fig3": lambda: [(g, [bc.scenario("fig3/decafork", "decafork", byz),
                              bc.scenario("fig3/decafork/eps=2.5", "decafork", byz, eps=2.5),
                              bc.scenario("fig3/decafork+", "decafork+", byz)])],
        "fig5": lambda: [(g, [bc.scenario(f"fig5/eps={eps}", "decafork", fcfg, eps=eps)
                              for eps in rfig5.EPS_GRID])],
        "fig7": lambda: [(g, [bc.scenario(f"fig7/{alg}/{tag}", alg, f)
                              for alg in ("decafork", "decafork+", "none")
                              for tag, f in rfig7.topology_failures()])],
        "theory": lambda: [(g, [JScenario("theory/decafork", bc.pcfg_for("decafork"),
                                          bc.burst_failures())])],
    }[name]()


def tiny_overrides(name: str) -> dict:
    """The keyword overrides of ``run()`` that put driver ``name`` at the
    tiny setting."""
    return dict(TINY, bursts=BURSTS, **EXTRA.get(name, {}))


def port_list(name: str, tiny: bool) -> list:
    """Driver ``name``'s ``scenarios()`` at the tiny setting or its
    defaults."""
    if not tiny:
        return DRIVERS[name].scenarios()
    skip = ("steps", "seeds") if name in WITH_BURSTS else ("steps", "seeds", "bursts")
    return DRIVERS[name].scenarios(
        **{k: v for k, v in tiny_overrides(name).items() if k not in skip})


def run_tiny(name, out, monkeypatch):
    """Driver ``name``'s ``run()`` on the CPU at the tiny setting, drawing
    with the reference's threefry bit layout."""
    monkeypatch.setattr(common, "PARTITIONABLE", PART)
    return DRIVERS[name].run(verbose=False, device="cpu", out=str(out), **tiny_overrides(name))


def fields(cfg) -> dict:
    """A config's fields as plain Python values (tuples for arrays)."""
    return {f.name: (tuple(np.asarray(v).reshape(-1).tolist())
                     if not isinstance(v := getattr(cfg, f.name), (str, type(None)))
                     and np.ndim(v) else (v.item() if hasattr(v, "item") else v))
            for f in dataclasses.fields(cfg)}


def assert_lists_match(got, want) -> None:
    assert len(got) == len(want)
    for (g, scen), (jg, jscen) in zip(got, want):
        np.testing.assert_array_equal(g.neighbors, jg.neighbors)
        np.testing.assert_array_equal(g.degrees, jg.degrees)
        assert [s.name for s in scen] == [s.name for s in jscen]
        for s, js in zip(scen, jscen):
            pf, jpf = fields(s.pcfg), fields(js.pcfg)
            assert {k: v for k, v in pf.items() if k not in EXECUTION} == \
                {k: v for k, v in jpf.items() if k not in EXECUTION}, s.name
            assert fields(s.fcfg) == fields(js.fcfg), s.name
            # the port's execution choice: the kernels' node-sum family
            assert jpf["estimator_impl"] == "gather"
            assert pf["estimator_impl"] == ("pallas" if s.pcfg.auto_eps else "auto")


_ROWS = {}  # (graph, protocol, failures) -> the reference's outputs, for the process


def reference_outputs(graph, pcfg, fcfg, steps, seeds):
    """The reference ensemble of one scenario on the oracle's round (the
    port's configs carried across field by field). The reference's sweep
    row i is bitwise its ensemble i, and ensembles of one static group
    share one compiled program, so scenarios that several drivers share
    compile once."""
    jp = JProtocolConfig(**{**dataclasses.asdict(pcfg), **ORACLE})
    jf = JFailureConfig(**dataclasses.asdict(fcfg))
    key = (graph.neighbors.tobytes(), repr(jp), repr(jf), steps, seeds)
    if key not in _ROWS:
        _ROWS[key] = japi.Experiment(graph=graph, protocol=jp, failures=jf,
                                     steps=steps).ensemble(seeds)
    return _ROWS[key]


def reference_rows(groups, monkeypatch) -> list:
    """``benchmarks/common.py``'s metrics (its ``EnsembleResult`` at the
    tiny setting) of the reference's trajectories of the port driver's
    own ``groups``."""
    monkeypatch.setattr(bc, "PROTO_START", TINY["proto_start"])
    monkeypatch.setattr(bc, "STEPS", TINY["steps"])
    rows = []
    for g, scen in groups:
        for s in scen:
            o = reference_outputs(g, s.pcfg, s.fcfg, TINY["steps"], TINY["seeds"])
            r = bc.EnsembleResult(s.name, np.asarray(o.z), 0.0, int(np.asarray(o.forks).sum()),
                                  int(np.asarray(o.terms).sum()))
            rows.append({"name": s.name, **r.metrics(bursts=BURSTS), "forks": r.forks,
                         "terms": r.terms})
    return rows


def assert_int_metrics(got, want) -> None:
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for g, w in zip(got, want):
        for k in INT_METRICS:
            assert g[k] == w[k], (g["name"], k, g[k], w[k])


@pytest.mark.parametrize("tiny", [False, True], ids=["reference-constants", "tiny"])
@pytest.mark.parametrize("name", list(DRIVERS))
def test_scenario_lists_match_the_reference_scripts(name, tiny, monkeypatch):
    use_constants(monkeypatch, tiny)
    assert_lists_match(port_list(name, tiny), reference_lists(name, tiny))


@pytest.mark.parametrize("name", ["fig1", "fig2", "fig3", "fig5", "fig7"])
def test_sweep_driver_integer_metrics_match_jax(name, tmp_path, monkeypatch):
    got = run_tiny(name, tmp_path, monkeypatch)
    want = reference_rows(port_list(name, True), monkeypatch)
    assert_int_metrics(got, want)
    saved = json.load(open(tmp_path / f"{DRIVERS[name].__name__.split('.')[-1]}.json"))
    assert [r["name"] for r in saved["rows"]] == [r["name"] for r in got]
    assert saved["meta"]["torch_version"] and "jax_version" not in saved["meta"]
    assert sum(r["forks"] for r in want) > 0


def test_theory_bounds_match_jax(tmp_path, monkeypatch):
    """The driver's bounds at a coarser split grid and a shorter horizon
    of Thm. 2, and Cor. 3 at 60 steps instead of 500 (quadratic in its
    steps; the bound functions themselves are held equal in
    test_torch_theory.py)."""
    import functools

    monkeypatch.setattr(theory_bounds, "reaction_time_bound",
                        functools.partial(theory_bounds.reaction_time_bound, eps_prime_grid=4,
                                          horizon=3000))
    recursion = theory_bounds.overshoot_recursion
    monkeypatch.setattr(theory_bounds, "overshoot_recursion",
                        lambda **kw: recursion(**{**kw, "steps": 60}))
    [got] = run_tiny("theory", tmp_path, monkeypatch)
    groups = port_list("theory", True)
    want = reference_rows(groups, monkeypatch)
    assert_int_metrics([dict(got["metrics"], name="theory/decafork", forks=got["forks"],
                             terms=got["terms"])], want)
    g = groups[0][0]
    rates = jth.Rates(lambda_r=float(return_rate_estimate(g).mean()),
                      lambda_a=float(arrival_rate_estimate(g)))
    t_bound = jth.reaction_time_bound(d_failed=5, r_forked=0, k_remaining=bc.Z0 - 5, t_d=0.0,
                                      eps=2.0, p=1.0 / bc.Z0, rates=rates, delta=0.05,
                                      eps_prime_grid=4, horizon=3000)
    oc = jth.overshoot_recursion(z_after_failure=bc.Z0 - 5, d_failed=5, t_d=0.0, steps=60,
                                 eps=2.0, p=1.0 / bc.Z0, rates=rates)
    assert got["thm2_first_fork_bound"] == float(t_bound)
    assert got["cor3_z_bound_at_500"] == float(oc[-1])


def test_command_line(tmp_path, capsys, monkeypatch):
    # fig8 (the RW-SGD payload) runs through the command line at a tiny
    # override: 6 rounds, 1 seed, on one torch thread (under xdist the
    # workers share the cores, and torch's thread per core then slows its
    # many small ops a hundredfold)
    import torch

    from repro_torch.figures import fig8_learning

    monkeypatch.setattr(fig8_learning, "STEPS", 6)
    monkeypatch.setattr(fig8_learning, "SEEDS", 1)
    monkeypatch.setattr(common, "PARTITIONABLE", PART)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert cli.main(["fig8", "--device", "cpu", "--out", str(tmp_path)]) == 0
    finally:
        torch.set_num_threads(threads)
    assert len(json.load(open(tmp_path / "fig8_learning.json"))["rows"]) == 9
    with pytest.raises(SystemExit):
        cli.main(["fig42", "--device", "cpu"])
    assert set(cli.BENCHES) == {"fig1", "fig2", "fig3", "fig4", "fig5", "fig6", "fig7", "fig8",
                                "fig9", "theory", "auto_eps"}
    assert common.OUT_DIR == "figures_out"
    path = common.save_result("probe", [{"name": "x"}], out=str(tmp_path))
    assert json.load(open(path))["meta"]["device_name"]
