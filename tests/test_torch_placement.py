"""Sweep rows over several devices (``repro_torch.api.placement``): a
group's scenarios in contiguous blocks, one per device, each block
through its own runner (in a host thread of its own on cards),
gathered in the reference's row order.

The device list comes from ``placement._visible_devices``; here it is
monkeypatched to the CPU repeated 2 or 4 times (the card test repeats
``cuda:0``). A spread sweep must be bitwise the one-device sweep on
every field, final state included; ``"sharded"`` with a scenario count
the devices do not divide raises the reference's error
(``src/repro/api/placement.py``), ``"auto"`` then stays on one device,
and ``"local"`` never spreads."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import Experiment, Placement, ResultStore, cache_stats  # noqa: E402
from repro_torch.api import placement  # noqa: E402
from repro_torch.api import plan as plan_mod  # noqa: E402
from repro_torch.core import FailureConfig, ProtocolConfig  # noqa: E402
from repro_torch.graphs import make_graph  # noqa: E402
from repro_torch.sweep import Scenario  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

STEPS, SEEDS = 40, 2  # decisions from round 20, the burst at 30
BASE = dict(z0=6, max_walks=16, rt_bins=64, protocol_start=20, estimator_impl="auto")
CHURN = FailureConfig(burst_times=(30,), burst_sizes=(3,), p_fail=0.01, p_node_fail=0.02,
                      p_node_recover=0.3, p_link_fail=0.02, p_link_recover=0.4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_cache():
    plan_mod.clear_cache()
    yield
    plan_mod.clear_cache()


@pytest.fixture(scope="module")
def graph():
    return make_graph("erdos_renyi", 24, seed=0)


@pytest.fixture(scope="module")
def one_group(graph):
    """Four DecAFork scenarios under churn on one device: (final state,
    outputs) of ``sweep_group``."""
    return _group(graph, _eps_grid(4))


@pytest.fixture(scope="module")
def one_mixed(graph):
    return Experiment(graph=graph, scenarios=_mixed(), steps=STEPS, outputs="full",
                      device="cpu").sweep(seeds=SEEDS)


def _eps_grid(k=4):
    return [Scenario(f"eps={e}", ProtocolConfig(eps=e, **BASE), CHURN)
            for e in (1.8, 2.0, 2.25, 2.5, 2.75, 3.0)[:k]]


def _mixed():
    plus = dict(BASE, algorithm="decafork+", eps2=7.57)
    return _eps_grid(4) + [
        Scenario("plus3", ProtocolConfig(eps=3.0, **plus), CHURN),
        Scenario("plus4", ProtocolConfig(eps=4.0, **plus), FailureConfig()),
        Scenario("mp25", ProtocolConfig("missingperson", eps_mp=25.0, **BASE), CHURN),
        Scenario("mp40", ProtocolConfig("missingperson", eps_mp=40.0, **BASE), CHURN),
    ]


def _spread_over(monkeypatch, k):
    monkeypatch.setattr(placement, "_visible_devices", lambda device: [torch.device("cpu")] * k)


def _blocks():
    """The cache slots of spread blocks: their (index, count)."""
    return sorted(sig[-1][1:] for (_mode, sig) in plan_mod._EXECUTABLES
                  if isinstance(sig[-1], tuple) and sig[-1][:1] == ("shard",))


def _same(a, b, label):
    xs, ys = tree_leaves(tuple(a)), tree_leaves(tuple(b))
    assert len(xs) == len(ys) and xs, label
    for i, (x, y) in enumerate(zip(xs, ys)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{label}: leaf {i}"


def _group(graph, scen, **kw):
    exp = Experiment(graph=graph, scenarios=scen, steps=STEPS, outputs="full", device="cpu",
                     **kw)
    state, rec = exp.plan().sweep_group(scen, seeds=SEEDS)
    return tuple(state), tuple(rec)


@pytest.mark.parametrize("k", [2, 4])
def test_spread_group_is_bitwise_the_one_device_group(graph, one_group, monkeypatch, k):
    """Four DecAFork scenarios under churn over ``cpu`` x k: the final
    state (every field, the graph state and key included) and every
    recorded output bitwise the one-device batch; one slot per block."""
    _spread_over(monkeypatch, k)
    got = _group(graph, _eps_grid(4), placement="sharded")
    _same(got[0], one_group[0], f"x{k}: final state")
    _same(got[1], one_group[1], f"x{k}: outputs")
    assert _blocks() == [(i, k) for i in range(k)]
    assert cache_stats()["graphs_captured"] == 0


@pytest.mark.parametrize("k,policy", [(2, "sharded"), (4, "auto")])
def test_mixed_sweep_spreads_each_group_it_can(graph, one_mixed, monkeypatch, k, policy):
    """A mixed list (four DecAFork, two DecAFork+, two MissingPerson)
    through ``sweep``: every scenario's rows bitwise the one-device
    sweep. Over 2 devices every group spreads; over 4 under ``"auto"``
    only the four-scenario group does, the pairs stay on one device."""
    scen, one = _mixed(), one_mixed
    _spread_over(monkeypatch, k)
    got = Experiment(graph=graph, scenarios=scen, steps=STEPS, outputs="full", device="cpu",
                     placement=policy).sweep(seeds=SEEDS)
    assert got.names == one.names
    for s in scen:
        _same(got[s.name], one[s.name], s.name)
    want = [(i, 2) for i in range(2)] * 3 if k == 2 else [(i, 4) for i in range(4)]
    assert _blocks() == sorted(want)


def test_sharded_raises_the_reference_error_when_the_count_does_not_divide(graph, monkeypatch):
    """Three scenarios over 4 devices: ``"sharded"`` raises, with the
    reference's message (its ``Placement.place`` on a 4-device data
    axis, reached here by stubbing its device count and mesh)."""
    from repro.api import placement as ref_placement
    from repro.launch import mesh as ref_mesh

    monkeypatch.setattr(ref_placement.jax, "device_count", lambda: 4)
    monkeypatch.setattr(ref_mesh, "make_local_mesh", lambda: None)
    monkeypatch.setattr(ref_mesh, "data_axis_size", lambda mesh: 4)
    with pytest.raises(ValueError) as ref:
        ref_placement.Placement.SHARDED.place((), (), 3)
    _spread_over(monkeypatch, 4)
    with pytest.raises(ValueError) as got:
        Placement.SHARDED.devices(torch.device("cpu"), 3)
    assert str(got.value) == str(ref.value)
    exp = Experiment(graph=graph, scenarios=_eps_grid(3), steps=STEPS, device="cpu",
                     placement="sharded")
    with pytest.raises(ValueError, match="do not divide the data axis"):
        exp.sweep(seeds=SEEDS)


def test_auto_stays_on_one_device_when_the_count_does_not_divide(graph, monkeypatch):
    _spread_over(monkeypatch, 4)
    assert Placement.AUTO.devices(torch.device("cpu"), 3) == [torch.device("cpu")]
    _group(graph, _eps_grid(3), placement="auto")
    assert _blocks() == [] and cache_stats()["entries"] == 1


def test_local_never_spreads(graph, one_group, monkeypatch):
    _spread_over(monkeypatch, 4)
    assert Placement.LOCAL.devices(torch.device("cpu"), 4) == [torch.device("cpu")]
    _same(_group(graph, _eps_grid(4), placement="local"), one_group, "local over 4")
    assert _blocks() == []


def test_one_visible_device_keeps_every_policy_local():
    """Without a stub the CPU is one device: every policy keeps the rows
    on it, at any scenario count."""
    cpu = torch.device("cpu")
    assert placement._visible_devices(cpu) == [cpu]
    for policy in ("auto", "sharded", "local"):
        for count in (1, 3, 4):
            assert Placement(policy).devices(cpu, count) == [cpu]


def test_a_cuda_experiment_sees_every_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert placement._visible_devices(torch.device("cuda")) == [
        torch.device("cuda", i) for i in range(3)]
    assert Placement.AUTO.devices(torch.device("cuda"), 6) == [
        torch.device("cuda", i) for i in range(3)]
    assert Placement.AUTO.devices(torch.device("cuda"), 4) == [torch.device("cuda")]


def test_spread_segmented_sweep_with_a_store(graph, one_group, monkeypatch, tmp_path):
    """Segments and a store through the spread blocks: the segmented
    sweep is bitwise the straight one-device sweep, each block keeps its
    own snapshots (cleared at the end), and a second call is a store
    hit that runs nothing."""
    scen = _eps_grid(4)
    one = [v.reshape((4, SEEDS) + v.shape[1:]) for v in one_group[1]]
    _spread_over(monkeypatch, 2)
    store = ResultStore(str(tmp_path / "store"))
    spread = Experiment(graph=graph, scenarios=scen, steps=STEPS, outputs="full", device="cpu",
                        placement="sharded").plan()
    got = spread.sweep_stacked(seeds=SEEDS, segment_steps=15, store=store)
    _same(got, one, "segmented spread sweep")
    assert not list((tmp_path / "store" / "segments").rglob("*.npz"))
    entries = cache_stats()["entries"]
    again = spread.sweep_stacked(seeds=SEEDS, store=store)
    _same(again, one, "store hit")
    assert store.hits == 1 and cache_stats()["entries"] == entries


def test_placement_policy_values():
    assert Placement.resolve(None) is Placement.AUTO
    assert Placement.resolve("local") == Placement.LOCAL
    with pytest.raises(ValueError, match="unknown placement policy"):
        Placement("everywhere")
    with pytest.raises(TypeError):
        Placement.resolve(3)
