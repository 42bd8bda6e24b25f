"""The port's per-graph figure drivers (``repro_torch.figures``): Fig. 4
(regular graphs of n 50, 100, 200), Fig. 6 (regular, complete,
Erdos-Renyi, power-law) and ``auto_eps`` (self-calibrating thresholds
against the hand-tuned eps on those graphs), against the reference's
figure scripts (``benchmarks/``, read, never run) and the live JAX
package on the CPU, as ``test_torch_figures.py`` holds the others:

  - each driver's scenario list at the reference's constants and at the
    tiny setting (80 steps, 2 seeds, decisions from step 20, the auto
    runs' from step 30, bursts at 40 / 60);
  - at the tiny setting, the integer metrics against
    ``benchmarks/common.py``'s metrics of the reference's trajectories on
    the node-sum oracle's round (``estimator_impl="compare",
    round_impl="unfused"``), one reference ensemble per scenario (the
    auto_eps tuned runs are Fig. 4's and Fig. 6's scenarios and reuse
    their programs). The port's tuned runs take the whole_round kernel's
    path, its auto runs the theta_sums kernel's.
"""
import dataclasses
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
from benchmarks import auto_eps as rauto  # noqa: E402
from benchmarks import fig4_nodes as rfig4  # noqa: E402
from benchmarks import fig6_graphs as rfig6  # noqa: E402
import repro.api as japi  # noqa: E402
from repro.core import FailureConfig as JFailureConfig  # noqa: E402
from repro.core import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.graphs import make_graph as jmake_graph  # noqa: E402
from repro.sweep import Scenario as JScenario  # noqa: E402
from repro_torch.figures import auto_eps, common, fig4_nodes, fig6_graphs  # noqa: E402

PART = bool(jax.config.jax_threefry_partitionable)
# the tiny setting: every driver's run() takes these overrides
TINY = dict(steps=80, seeds=2, proto_start=20)
BURSTS = (40, 60)
ORACLE = dict(estimator_impl="compare", round_impl="unfused")
EXECUTION = ("estimator_impl", "round_impl")
INT_METRICS = ("forks", "terms", "max_z", "min_z_post", "reaction_median", "survival_rate",
               "mean_z", "overshoot")
AUTO_START = 30  # the auto runs' decisions, tiny setting
DRIVERS = {"fig4": fig4_nodes, "fig6": fig6_graphs, "auto_eps": auto_eps}


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
    if tiny:
        monkeypatch.setattr(bc, "PROTO_START", TINY["proto_start"])
        monkeypatch.setattr(bc, "STEPS", TINY["steps"])
        monkeypatch.setattr(bc, "BURSTS", BURSTS)


def reference_lists(name: str, tiny: bool) -> list:
    """``[(graph, [Scenario])]`` of driver ``name`` as its reference
    script's ``run()`` builds it (``benchmarks/<figure>.py``), at the
    constants :func:`use_constants` set."""
    if name == "fig4":
        return [(jmake_graph("regular", n, seed=0, degree=8),
                 [bc.scenario(f"fig4/n={n}", "decafork", bc.burst_failures(), eps=eps)])
                for n, eps in rfig4.EPS_BY_N.items()]
    if name == "fig6":
        return [(jmake_graph(fam, 100, seed=0, **kw),
                 [JScenario(f"fig6/{fam}", bc.pcfg_for("decafork", eps=eps),
                            bc.burst_failures())])
                for fam, kw, eps in rfig6.FAMILIES]
    auto_start = AUTO_START if tiny else 1200
    return [(jmake_graph(fam, n, seed=0, **kw), [
        JScenario(f"auto_eps/tuned/{fam}-{n}",
                  bc.pcfg_for("decafork", eps=rauto.TUNED_EPS[(fam, n)]), bc.burst_failures()),
        JScenario(f"auto_eps/auto/{fam}-{n}",
                  bc.pcfg_for("decafork+", auto_eps=True, protocol_start=auto_start),
                  bc.burst_failures())]) for fam, n, kw in rauto.SWEEP]


def tiny_overrides(name: str) -> dict:
    """The keyword overrides of ``scenarios()`` that put driver ``name`` at
    the tiny setting."""
    kw = dict(proto_start=TINY["proto_start"], bursts=BURSTS)
    return dict(kw, auto_start=AUTO_START) if name == "auto_eps" else kw


def port_list(name: str, tiny: bool) -> list:
    return DRIVERS[name].scenarios(**tiny_overrides(name)) if tiny else \
        DRIVERS[name].scenarios()


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


@pytest.mark.parametrize("name", list(DRIVERS))
def test_per_graph_driver_integer_metrics_match_jax(name, tmp_path, monkeypatch):
    monkeypatch.setattr(common, "PARTITIONABLE", PART)
    got = DRIVERS[name].run(verbose=False, device="cpu", out=str(tmp_path), steps=TINY["steps"],
                            seeds=TINY["seeds"], **tiny_overrides(name))
    want = reference_rows(port_list(name, True), monkeypatch)
    assert_int_metrics(got, want)
    assert sum(r["forks"] for r in want) > 0
    if name == "auto_eps":
        assert any(r["name"].startswith("auto_eps/auto/") and r["forks"] > 0 for r in want)
