"""The readers of the program's own trace (``program_trace``) on a
hand-made record, and the threefry blocks a round of the tiny cells
hashes against ``counts.words_drawn`` (eagerly on the CPU, from the
captured rounds on a card)."""
import importlib.util

import pytest

from simbench import counts, harness, program_trace
from simbench.tests import tiny
from simbench.tests.conftest import CHECKOUT

READ = {
    "threefry_share": program_trace.threefry_share,
    "node_gap_share": program_trace.node_gap_share,
    "threefry_blocks_per_round": program_trace.threefry_blocks_per_round,
}


def _metric(name):
    path = CHECKOUT / "simbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"m_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def hand_made():
    # the first runner's window stalled once: its mean gap 0.9 ms, its median round's 0.6
    runners = [dict(algorithm="missingperson", rows=50, span_ms=3.3, gap_ms=0.9, median_gap_ms=0.6,
                    threefry_ms=1.2, threefry_blocks=308_550),
               dict(algorithm="decafork", rows=50, span_ms=2.0, gap_ms=0.4, median_gap_ms=0.4,
                    threefry_ms=1.3, threefry_blocks=110_250)]
    return dict(device="cuda", program=dict(runners=runners))


@pytest.mark.parametrize("kind", ["sweep", "production"])
@pytest.mark.parametrize("name,want", [("threefry_share", 50.0), ("node_gap_share", 20.0),
                                       ("threefry_blocks_per_round", 418_800.0)])
def test_readers_sum_over_the_runners(kind, name, want):
    assert _metric(f"{name}.{kind}")(hand_made()) == pytest.approx(want)


def test_readers_give_none_without_the_program_trace():
    for read in READ.values():
        assert read(dict(device="cuda", program=None)) is None
    rec = dict(device="cpu", cell="paper-fig5-eps-grid")
    assert all(read(rec) is None for read in READ.values()) and rec["program"] is None


def blocks_wanted(cell) -> int:
    run = harness.Run(cell, "cpu")
    shape = harness.shape_of(cell.config)
    total = 0
    for idxs in run.groups:
        alg = run.params[idxs[0]][1]["algorithm"]
        total += sum(counts.words_drawn(shape, alg)) * len(idxs) * run.seeds
    return total


@pytest.mark.parametrize("make", [tiny.paper, tiny.production], ids=["paper", "production"])
def test_eager_rounds_hash_the_blocks_the_semantics_draw(make):
    """A study of two rounds less a study of one: one round of every group."""
    from repro_torch.utils import trace

    got = []
    for steps in (1, 2):
        run = harness.Run(make(steps), "cpu")
        with trace.Tracer() as tracer:
            run.study(harness.study_key(5, 0))
        got.append(tracer.read()["counters"]["threefry_blocks"])
    assert got[1] - got[0] == blocks_wanted(make())


@pytest.mark.cuda
@pytest.mark.parametrize("make", [tiny.paper, tiny.production], ids=["paper", "production"])
def test_traced_cell_on_the_card(card, make):
    """The captured rounds' count, and the shares of a profiled window."""
    from repro_torch.api import plan as plan_mod

    plan_mod.clear_cache()
    prog = program_trace.trace_cell(make(), 2**31 + 99, 1, 1e-3, program_trace._tools())
    plan_mod.clear_cache()
    rec = dict(device=card, program=prog)
    assert program_trace.threefry_blocks_per_round(rec) == blocks_wanted(make())
    assert 0 < program_trace.threefry_share(rec) < 100
    assert 0 <= program_trace.node_gap_share(rec) < 100
    for r in prog["runners"]:
        assert abs(r["accounted"] - 1) <= 0.01
    assert prog["counters"]["threefry_blocks"] > 0 and prog["busy_s"] <= prog["window_s"]
