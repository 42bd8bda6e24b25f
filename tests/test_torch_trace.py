"""The port's tracer (``repro_torch.utils.trace``) on the CPU, and its stage
map of a captured round on a card:

  - spans nest with parent, trace and thread ids and self time, time
    themselves always, and are kept only while a Tracer is active;
  - a round's outputs and state are bitwise the same with and without an
    active Tracer, fused and unfused;
  - ``threefry_blocks`` of one eager round equals its closed form (the
    six streams' keys, the bursts', the topology's split and the decision
    split, plus one block per word drawn) for DecAFork, fused and
    unfused, and for MissingPerson (n 12, degree 4, W 8, 4 rows, one
    burst);
  - a study through ``Plan.sweep_group`` records its host spans and counts;
  - stage assignment, device attribution (:func:`trace.attribute`), gap
    naming and the anchors' clock map as pure functions on synthetic
    graphs, operations and marks, with the refusals of a misaligned
    window and of a graph that is not a chain.

On a card (``-m cuda``): a tiny captured runner's stage map covers every
device node, its ``whole_round`` stage runs the whole_round kernels, its
counts equal the closed form, ``round_stages`` accounts for every profiled
operation, and a Tracer marks the replays on the host clock.
"""
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.api import Experiment  # noqa: E402
from repro_torch.api import plan as plan_mod  # noqa: E402
from repro_torch.core import simulator as sim  # noqa: E402
from repro_torch.core.failures import FailureConfig  # noqa: E402
from repro_torch.core.outputs import FULL  # noqa: E402
from repro_torch.core.protocol import ProtocolConfig  # noqa: E402
from repro_torch.graphs import make_graph  # noqa: E402
from repro_torch.sweep import Scenario  # noqa: E402
from repro_torch.utils import prng, trace  # noqa: E402
from repro_torch.utils.tree import tree_clone, tree_leaves  # noqa: E402

N, DEG, W, ROWS, K = 12, 4, 8, 4, 1
FCFG = FailureConfig(burst_times=(3,), burst_sizes=(2,), p_fail=0.05, p_node_fail=0.05,
                     p_node_recover=0.3, p_link_fail=0.05, p_link_recover=0.4)
CASES = {
    "decafork-fused": ProtocolConfig(eps=2.0, z0=4, max_walks=W, rt_bins=32,
                                     estimator_impl="auto", round_impl="fused"),
    "decafork-unfused": ProtocolConfig("decafork+", eps=2.0, eps2=5.0, z0=4, max_walks=W,
                                       rt_bins=32, estimator_impl="compare",
                                       round_impl="unfused"),
    "missingperson": ProtocolConfig("missingperson", eps_mp=5.0, z0=4, max_walks=W, rt_bins=32),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: under xdist the workers share the
    cores, and a torch thread per core slows many small ops a
    hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def blocks_per_round(algorithm: str) -> int:
    """One trajectory's threefry blocks a round: keys (6 streams x 2
    folds), a fold per burst, the topology's 4-way split, the DecAFork
    decision split; then a block per word: hop and probabilistic failure
    (W each), the bursts' (K x W), the Byzantine word, node (2n) and edge
    (2nD) uniforms, and the decision's (DecAFork 2W, MissingPerson W x W)."""
    keys = 12 + K + 4 + (0 if algorithm == "missingperson" else 2)
    words = 2 * W + K * W + 1 + 2 * N + 2 * N * DEG
    words += W * W if algorithm == "missingperson" else 2 * W
    return keys + words


def setup_state(pcfg, device="cpu"):
    graph = make_graph("regular", N, seed=0, degree=DEG)
    setup = sim.make_setup(graph, [pcfg] * ROWS, [FCFG] * ROWS, 20, device)
    keys = prng.split(prng.key(7, device=device), ROWS)
    return setup, sim.init_state(keys, setup)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


def test_spans_nest_with_ids_and_self_time():
    with trace.Tracer() as tracer:
        with trace.span("study", index=3) as outer:
            with trace.span("a"):
                time.sleep(0.002)
            with trace.span("b"):
                with trace.span("c"):
                    time.sleep(0.001)
        with trace.span("next"):
            pass
    spans = {s["name"]: s for s in tracer.read()["spans"]}
    assert set(spans) == {"study", "a", "b", "c", "next"}
    study = spans["study"]
    assert study["parent"] is None and study["trace"] == study["id"]
    assert study["attrs"] == {"index": 3}
    assert spans["a"]["parent"] == spans["b"]["parent"] == study["id"]
    assert spans["c"]["parent"] == spans["b"]["id"]
    assert {spans[k]["trace"] for k in "abc"} == {study["id"]}
    assert spans["next"]["trace"] == spans["next"]["id"] != study["id"]
    assert len({s["thread"] for s in spans.values()}) == 1
    kids = spans["a"]["dur_ns"] + spans["b"]["dur_ns"]
    assert study["self_ns"] == study["dur_ns"] - kids
    assert spans["b"]["self_ns"] == spans["b"]["dur_ns"] - spans["c"]["dur_ns"]
    assert spans["a"]["self_ns"] == spans["a"]["dur_ns"] >= 2_000_000
    assert outer.seconds == study["dur_ns"] / 1e9


def test_spans_time_themselves_but_are_kept_only_by_an_active_tracer():
    idle = trace.Tracer()
    with trace.span("alone") as s:
        time.sleep(0.001)
    assert s.seconds >= 0.001 and s.id is None
    assert idle.read()["spans"] == [] and trace.active() is None
    with idle:
        assert trace.active() is idle
        with pytest.raises(RuntimeError):
            trace.Tracer().start()
        with pytest.raises(RuntimeError):
            idle.read()
    assert trace.active() is None
    with trace.span("after"):
        pass
    assert idle.read()["spans"] == [] and idle.read()["counters"] == {}


# ---------------------------------------------------------------------------
# rounds: outputs unchanged, blocks counted
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["decafork-fused", "decafork-unfused"])
def test_outputs_are_bitwise_the_same_under_a_tracer(case):
    setup, state = setup_state(CASES[case])
    plain = sim.run_rounds(tree_clone(state), setup, 6, FULL)  # rounds update state in place
    with trace.Tracer() as tracer:
        traced = sim.run_rounds(tree_clone(state), setup, 6, FULL)
    assert tracer.read()["counters"]["threefry_blocks"] > 0
    for a, b in zip(tree_leaves(plain[0]) + list(plain[1]),
                    tree_leaves(traced[0]) + list(traced[1])):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("case", list(CASES))
def test_threefry_blocks_of_a_round_match_the_closed_form(case):
    pcfg = CASES[case]
    setup, state = setup_state(pcfg)
    with trace.Tracer() as tracer:
        sim.protocol_step(state, setup)
        sim.protocol_step(state, setup)
    assert tracer.read()["counters"] == {
        "threefry_blocks": 2 * ROWS * blocks_per_round(pcfg.algorithm)}


def test_a_study_records_its_host_spans_and_counts():
    scen = [Scenario(f"e{e}", ProtocolConfig(eps=e, z0=4, max_walks=W, rt_bins=32,
                                             estimator_impl="auto"), FCFG) for e in (1.5, 2.5)]
    exp = Experiment(graph=make_graph("regular", N, seed=0, degree=DEG), scenarios=scen,
                     steps=5, device="cpu")
    plan = exp.plan()
    plan_mod.clear_cache()
    with trace.Tracer() as tracer:
        plan.sweep_group(scen, seeds=2)
    read = tracer.read()
    spans = read["spans"]
    by = {s["id"]: s for s in spans}

    def path(s):
        names = [s["name"]]
        while s["parent"] is not None:
            s = by[s["parent"]]
            names.append(s["name"])
        return "/".join(reversed(names))

    paths = {path(s) for s in spans}
    assert {"sweep_group", "sweep_group/keys", "sweep_group/make_setup",
            "sweep_group/init_carry", "sweep_group/run", "sweep_group/run/copy_in",
            "sweep_group/run/chunk", "sweep_group/run/chunk/replay",
            "sweep_group/run/chunk/copy_out", "sweep_group/run/clone_out"} == paths
    assert len({s["trace"] for s in spans}) == 1
    # the keys' split (2), init_state's split and randint (4 x (2 + 2 + 2 W)), then 5 rounds
    rows = 2 * 2
    init = 2 + rows * (2 + 2 + 2 * W)
    assert read["counters"]["threefry_blocks"] == init + 5 * rows * blocks_per_round("decafork")
    assert api.runners() and all(r.graph is None and r.capture_s is None
                                 for r in api.runners())
    plan_mod.clear_cache()


# ---------------------------------------------------------------------------
# pure functions: stages, attribution, gaps, clocks
# ---------------------------------------------------------------------------


def test_assign_stages_on_a_synthetic_graph():
    # a -> b -> c -> d -> e, with f beside d (depends on c) and e on both
    preds = {"a": [], "b": ["a"], "c": ["b"], "d": ["c"], "f": ["c"], "e": ["d", "f"]}
    order = list("abcdfe")
    # captured: a; keys { b; threefry { c } }; draws { d, f }; e. Each mark is
    # (the frontier at a boundary, the path open before it)
    marks = [(("a",), "r"), (("b",), "r/keys"), (("c",), "r/keys/threefry"), (("c",), "r/keys"),
             (("c",), "r"), (("d", "f"), "r/draws"), (("e",), "r")]
    got = trace.assign_stages(preds, order, marks, "r")
    assert got == {"a": "r", "b": "r/keys", "c": "r/keys/threefry", "d": "r/draws",
                   "f": "r/draws", "e": "r"}
    nodes = [trace.Node(got[n], "kernel" if n != "f" else "memset", None, None) for n in order]
    table = trace.stage_table(nodes, {"r/keys/threefry": {"threefry_blocks": 24}})
    assert table["r/draws"] == {"nodes": 2, "kernel_nodes": 1}
    assert table["r/keys/threefry"] == {"nodes": 1, "kernel_nodes": 1, "threefry_blocks": 24}


NODES = [("round/keys/threefry", "kernel", None), ("round/keys/threefry", "kernel", None),
         ("round/keys", "kernel", None), ("round/whole_round", "memset", None),
         ("round/whole_round", "kernel", "whole_round_kernel"), ("round", "memcpy", None)]
# one round's ops (µs from the round's start) and names
ROUND = [(0, 2, "k0"), (3, 5, "k1"), (5, 6, "k2"), (8, 9, "memset32"),
         (9, 19, "whole_round_kernel(Round)"), (20, 21, "Memcpy DtoD (Device -> Device)")]


def synthetic_ops(rounds, period=30.0):
    return [(s + r * period, e + r * period, name) for r in range(rounds) for s, e, name in ROUND]


def test_attribute_gives_stage_self_device_and_gap_times():
    got = trace.attribute(NODES, synthetic_ops(2), 2)
    assert got["rounds"] == 2 and got["device_ops"] == 12
    assert got["span_ms"] == pytest.approx(21e-3)
    assert got["gap_ms"] == got["median_gap_ms"] == pytest.approx(4e-3)  # before nodes 1, 3, 5
    assert got["launch_gap_ms"] == pytest.approx(9e-3)  # 21 -> 30
    assert got["accounted"] == pytest.approx(1.0)
    st = got["stages"]
    assert st["round/keys/threefry"] == pytest.approx(
        dict(self_ms=4e-3, kernel_ms=4e-3, gap_ms=1e-3, device_ms=5e-3))
    assert st["round/keys"] == pytest.approx(
        dict(self_ms=1e-3, kernel_ms=1e-3, gap_ms=0.0, device_ms=6e-3))
    assert st["round/whole_round"] == pytest.approx(
        dict(self_ms=11e-3, kernel_ms=10e-3, gap_ms=2e-3, device_ms=11e-3))
    assert st["round"] == pytest.approx(
        dict(self_ms=1e-3, kernel_ms=0.0, gap_ms=1e-3, device_ms=21e-3))
    total = sum(s["self_ms"] + s["gap_ms"] for s in st.values())
    assert total == pytest.approx(got["span_ms"])


def test_attribute_takes_the_median_round_s_gaps_beside_the_mean():
    ops = synthetic_ops(3)
    ops[7:] = [(s + 300.0, e + 300.0, n) for s, e, n in ops[7:]]  # round 1 stalls 300 µs
    got = trace.attribute(NODES, ops, 3)
    assert got["gap_ms"] == pytest.approx(4e-3 + 0.1)
    assert got["median_gap_ms"] == pytest.approx(4e-3)
    assert got["largest_gaps"][0][:3] == (pytest.approx(301.0), 1, 1)  # 1 µs + the stall


@pytest.mark.parametrize("fault", ["count", "kind", "name", "overlap"])
def test_attribute_refuses_a_misaligned_window(fault):
    ops = synthetic_ops(2)
    if fault == "count":
        ops = ops[:-1]
    elif fault == "kind":
        ops[3], ops[5] = (ops[3][0], ops[3][1], ops[5][2]), (ops[5][0], ops[5][1], ops[3][2])
    elif fault == "name":
        ops[4] = (ops[4][0], ops[4][1], "another_kernel")
    else:
        ops[1] = (ops[1][0] - 2.5, ops[1][1], ops[1][2])  # starts inside k0
    with pytest.raises(trace.MisalignedWindow):
        trace.attribute(NODES, ops, 2)


def test_a_leading_round_absorbs_the_records_a_window_loses_at_its_start():
    ops = synthetic_ops(3)
    assert trace.last_rounds(ops, 6, 2, 1) == ops[6:]
    assert trace.last_rounds(ops[4:], 6, 2, 1) == ops[6:]  # 4 of the first round lost
    assert trace.last_rounds(ops[6:], 6, 2, 0) == ops[6:]
    for bad in (ops[7:], ops + ops[:1]):  # a kept round lost one; one op too many
        with pytest.raises(trace.MisalignedWindow):
            trace.last_rounds(bad, 6, 2, 1)


def test_round_stages_refuses_a_graph_that_is_not_a_chain():
    class Graph:
        chain, nodes = False, []

    class Runner:
        graph, chunk = Graph(), 8

    with pytest.raises(ValueError, match="chain"):
        trace.round_stages(Runner(), 2)
    Runner.graph = None
    with pytest.raises(ValueError, match="captured"):
        trace.round_stages(Runner(), 2)


def test_anchor_conversion_and_gap_naming():
    # the host saw 1,000,100 ns where the device saw 1.0 ms: 100 ns of drift
    to_host = trace.host_clock([(5_000, 0.0), (1_005_100, 1.0)])
    assert to_host(0.0) == 5_000 and to_host(1.0) == 1_005_100
    assert to_host(0.5) == pytest.approx(5_000 + 500_050)
    marks = [(100, 200), (150, 300), (500, 600)]
    gaps = trace.device_gaps(marks, 0, 1000)
    assert gaps == [(0, 100), (300, 500), (600, 1000)]
    spans = [dict(id=1, parent=None, name="study", start_ns=0, end_ns=700),
             dict(id=2, parent=1, name="run", start_ns=90, end_ns=700),
             dict(id=3, parent=2, name="copy_out", start_ns=310, end_ns=480)]
    named = trace.name_gaps(gaps, spans)
    assert named == [(0, 100, "study"), (300, 200, "study/run/copy_out"),
                     (600, 400, "caller")]


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a captured round exists only on the card")
    return "cuda"


def captured_runner(pcfg, steps=20):
    plan_mod.clear_cache()
    exp = Experiment(graph=make_graph("regular", N, seed=0, degree=DEG), protocol=pcfg,
                     failures=FCFG, steps=steps, device="cuda")
    plan = exp.plan()
    plan.ensemble(ROWS, base_key=7)
    (runner,) = api.runners()
    return plan, runner


FUSED_STAGES = {"round", "round/keys", "round/keys/threefry", "round/draws",
                "round/draws/threefry", "round/gates", "round/gates/threefry",
                "round/whole_round", "round/slots", "round/commit"}
UNFUSED_STAGES = {"round", "round/keys", "round/keys/threefry", "round/topology",
                  "round/topology/threefry", "round/hop", "round/hop/threefry",
                  "round/failures", "round/failures/threefry", "round/observation",
                  "round/decisions", "round/decisions/threefry", "round/slots", "round/commit"}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["decafork-fused", "missingperson"])
def test_captured_stage_map_covers_every_device_node(card, case):
    pcfg = CASES[case]
    _, runner = captured_runner(pcfg)
    g = runner.graph
    assert g.chain and g.root == "round"
    assert all(nd.path == "round" or nd.path.startswith("round/") for nd in g.nodes)
    assert sum(r["nodes"] for r in g.stages.values()) == len(g.nodes)
    assert sum(r["kernel_nodes"] for r in g.stages.values()) == g.kernel_nodes
    assert g.counts == {"threefry_blocks": ROWS * blocks_per_round(pcfg.algorithm)}
    assert set(g.stages) == (FUSED_STAGES if case == "decafork-fused" else UNFUSED_STAGES)
    ported = [nd for nd in g.nodes if nd.symbol]
    if case == "decafork-fused":
        assert ported and {nd.path for nd in ported} == {"round/whole_round"}
        assert "whole_round_kernel" in {nd.symbol for nd in ported}
    else:  # MissingPerson's unfused round launches no kernel of the port
        assert not ported
    devices = sum(nd.kind in trace.DEVICE_KINDS for nd in g.nodes)
    out = trace.round_stages(runner, 3)
    assert out["device_ops"] == 3 * devices and abs(out["accounted"] - 1) <= 0.01
    assert out["threefry_ms"] > 0 and out["threefry_blocks"] == g.counts["threefry_blocks"]
    total = sum(st["self_ms"] + st["gap_ms"] for st in out["stages"].values())
    assert total == pytest.approx(out["span_ms"], rel=0.01)
    if case == "decafork-fused":
        assert out["stages"]["round/whole_round"]["kernel_ms"] > 0
    plan_mod.clear_cache()


@pytest.mark.cuda
def test_tracer_marks_replays_on_the_host_clock(card):
    pcfg = CASES["decafork-fused"]
    plan, runner = captured_runner(pcfg, steps=40)
    with trace.Tracer() as tracer:
        with trace.span("study"):
            plan.ensemble(ROWS, base_key=8)
            torch.cuda.synchronize()  # the replays end inside the span
    read = tracer.read()
    assert len(read["replays"]) == 1 and read["replays"][0]["times"] == 40
    assert 0 < read["busy_s"] <= read["window_s"]
    assert abs(read["drift_ns"]) < 0.01 * read["window_s"] * 1e9
    (study,) = [s for s in read["spans"] if s["name"] == "study"]
    (replay,) = [s for s in read["spans"] if s["name"] == "replay"]
    mark = read["replays"][0]
    assert replay["start_ns"] - 1e6 <= mark["start_ns"] <= mark["end_ns"] <= study["end_ns"] + 1e6
    init = ROWS + ROWS * (2 + 2 + 2 * W)
    assert read["counters"]["threefry_blocks"] == init + 40 * runner.graph.counts[
        "threefry_blocks"]
    gap_names = {g["name"] for g in read["idle_gaps"]}
    assert gap_names and all(n == "caller" or n.startswith("study") for n in gap_names)
    plan_mod.clear_cache()
