"""Fig. 8's driver (``repro_torch.figures.fig8_learning``: RW-SGD
learning under failure) against the reference's script
(``benchmarks/fig8_learning.py``, read, never run) and the live JAX
package, on the CPU.

  - the scenario grid equals the script's at its reduced (300 steps) and
    paper (``BENCH_FULL``: 900 steps) settings; the port adds only its
    execution field (``estimator_impl``);
  - the payload equals the script's: model config, optimizer, sizes, the
    task's logits within 1e-5 (an XLA / torch ulp in ``u @ v``);
  - one group (DecAFork+, three failure regimes, 2 seeds, 20 rounds,
    decisions from step 6 and failures at step 10) against the
    reference's sweep on the node-sum oracle's round
    (``estimator_impl="compare", round_impl="unfused"``) with the
    script's payload and its task's logits carried across: integers and
    ``trained`` bitwise, ``mean_loss`` in every round within 1e-3 (the
    bound and its basis are ``tests/test_torch_payload.py``'s), and the
    driver's row metrics of the group: ``trained_final`` and
    ``survival_rate`` equal, the loss means within 1e-3;
  - the driver at a tiny override writes its rows and opens at most one
    executable-cache slot per protocol group.
"""
import dataclasses
import json
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
if ROOT not in sys.path:  # the reference's figure scripts live in benchmarks/
    sys.path.insert(0, ROOT)

from benchmarks import fig8_learning as rfig8  # noqa: E402
from repro.api import Experiment as JExperiment  # noqa: E402
from repro.core import FailureConfig as JFailureConfig  # noqa: E402
from repro.core import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.graphs import random_regular_graph  # noqa: E402
from repro.sweep import Scenario as JScenario  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import Experiment  # noqa: E402
from repro_torch.figures import common, fig8_learning  # noqa: E402
from repro_torch.optim import RwSgdPayload  # noqa: E402

PART = bool(jax.config.jax_threefry_partitionable)
ORACLE = dict(estimator_impl="compare", round_impl="unfused")
EXECUTION = ("estimator_impl", "round_impl")
GROUP = dict(steps=20, seeds=2, proto_start=6, fail_at=10)
LOSS_BOUND = 1e-3
INT_FIELDS = ("z", "forks", "terms", "failures", "fork_parent", "terminated")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file: under xdist each worker shares the
    machine's cores with the others, and torch's default of one thread
    per core oversubscribes them (the results do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fields(cfg) -> dict:
    """A config's fields as plain Python values (tuples for arrays)."""
    return {f.name: (tuple(np.asarray(v).reshape(-1).tolist())
                     if not isinstance(v := getattr(cfg, f.name), (str, type(None)))
                     and np.ndim(v) else (v.item() if hasattr(v, "item") else v))
            for f in dataclasses.fields(cfg)}


def reference_scenarios(monkeypatch, steps, proto_start, fail_at) -> list:
    """The script's grid as its ``run()`` builds it, at the given
    constants."""
    monkeypatch.setattr(rfig8, "PROTO_START", proto_start)
    monkeypatch.setattr(rfig8, "FAIL_AT", fail_at)
    return [JScenario(f"fig8/{alg}/{tag}", rfig8._pcfg(alg), fcfg)
            for alg in rfig8.ALGS for tag, fcfg in rfig8.failure_regimes()]


@pytest.mark.parametrize("steps", [300, 900], ids=["reduced", "paper"])
def test_scenarios_match_reference(monkeypatch, steps):
    want = reference_scenarios(monkeypatch, steps, steps // 3, steps // 2)
    [(g, scen)] = fig8_learning.scenarios(steps=steps)
    np.testing.assert_array_equal(g.neighbors, random_regular_graph(48, 6, seed=0).neighbors)
    assert [s.name for s in scen] == [s.name for s in want]
    for s, js in zip(scen, want):
        pf, jpf = fields(s.pcfg), fields(js.pcfg)
        assert {k: v for k, v in pf.items() if k not in EXECUTION} == \
            {k: v for k, v in jpf.items() if k not in EXECUTION}, s.name
        assert fields(s.fcfg) == fields(js.fcfg), s.name
        assert pf["estimator_impl"] == "auto"
    assert (fig8_learning.STEPS, fig8_learning.SEEDS) == (rfig8.STEPS, rfig8.SEEDS)


def test_payload_matches_reference():
    jp = rfig8.build_payload()
    p = fig8_learning.build_payload(device="cpu")
    assert dataclasses.asdict(p.model.cfg) == dataclasses.asdict(jp.model.cfg)
    assert p.optimizer.signature == jp.optimizer.signature
    assert (p.max_walks, p.local_batch, p.seq_len, p.train_every) == (
        jp.max_walks, jp.local_batch, jp.seq_len, jp.train_every)
    np.testing.assert_allclose(p.task.logits.numpy(), np.asarray(jp.task.logits), rtol=0,
                               atol=1e-5)
    assert abs(p.task.entropy - jp.task.entropy) < 1e-5


def test_group_against_reference_sweep():
    """One protocol group of the grid, the port's captured path's
    configuration against the reference's oracle round."""
    g = GROUP
    [(graph, scen)] = fig8_learning.scenarios(steps=g["steps"], proto_start=g["proto_start"],
                                              fail_at=g["fail_at"])
    scen = [s for s in scen if s.pcfg.algorithm == "decafork+"]
    jp = rfig8.build_payload()
    p = fig8_learning.build_payload(device="cpu")
    payload = RwSgdPayload(p.model, p.optimizer,
                           convert.task_from_arrays(np.asarray(jp.task.logits), jp.task.entropy,
                                                    "cpu"),
                           max_walks=p.max_walks, local_batch=p.local_batch, seq_len=p.seq_len)
    res = Experiment(graph=graph, scenarios=scen, steps=g["steps"], payload=payload, device="cpu",
                     partitionable=PART).sweep(seeds=g["seeds"])
    jscen = [(JProtocolConfig(**{**dataclasses.asdict(s.pcfg), **ORACLE}),
              JFailureConfig(**dataclasses.asdict(s.fcfg))) for s in scen]
    jouts, jlearn = JExperiment(graph=random_regular_graph(48, 6, seed=0), scenarios=jscen,
                                steps=g["steps"], payload=jp).plan().sweep_stacked(
        seeds=g["seeds"])
    for i, s in enumerate(scen):
        outs, learn = res[s.name], res.payload(s.name)
        for f in INT_FIELDS:
            np.testing.assert_array_equal(getattr(outs, f).numpy(),
                                          np.asarray(getattr(jouts, f)[i]), err_msg=f"{s.name}: {f}")
        np.testing.assert_array_equal(learn.trained.numpy(), np.asarray(jlearn.trained[i]))
        np.testing.assert_allclose(learn.mean_loss.numpy(), np.asarray(jlearn.mean_loss[i]),
                                   rtol=0, atol=LOSS_BOUND, err_msg=s.name)
        got = fig8_learning.row(s.name, outs.z.numpy(), learn.trained.numpy(),
                                learn.mean_loss.numpy(), g["fail_at"])
        want = fig8_learning.row(s.name, np.asarray(jouts.z[i]), np.asarray(jlearn.trained[i]),
                                 np.asarray(jlearn.mean_loss[i]), g["fail_at"])
        assert got["trained_final"] == want["trained_final"]
        assert got["survival_rate"] == want["survival_rate"]
        for k in ("loss_pre_failure", "loss_final"):
            assert abs(got[k] - want[k]) < LOSS_BOUND, (s.name, k)
    assert int(sum(res[s.name].forks.sum() for s in scen)) > 0


def test_driver_at_a_tiny_override(tmp_path, monkeypatch, capsys):
    """The whole grid, 12 rounds x 1 seed: nine rows, one new cache slot
    per protocol group at most, the result file written."""
    monkeypatch.setattr(common, "PARTITIONABLE", PART)
    rows = fig8_learning.run(device="cpu", out=str(tmp_path), steps=12, seeds=1)
    assert [r["name"] for r in rows] == [f"fig8/{a}/{t}" for a in fig8_learning.ALGS
                                         for t in ("burst", "pacman", "churn")]
    saved = json.load(open(tmp_path / "fig8_learning.json"))
    assert saved["new_cache_slots"] <= 3 and saved["steps"] == 12 and len(saved["rows"]) == 9
    assert all(r["loss_final"] is None or np.isfinite(r["loss_final"]) for r in rows)
    assert "fig8/none/churn" in capsys.readouterr().out
