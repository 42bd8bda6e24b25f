"""The port's ResultStore: content-addressed, disk-backed sweep results.

Contract under test, on the CPU:
  * a store-warm ``sweep_stacked`` returns the stored tensors bitwise,
    making no runner slot and running no round; ``Plan.sweep`` and
    ``Experiment.sweep`` thread ``store=`` through every group;
  * a store-warm re-run in a FRESH process (a subprocess) is bitwise and
    its executable cache stays empty;
  * keys are content hashes: the base key, the seed count, a scenario's
    config value, the graph, the device type and the threefry layout
    each change the key; ``cuda`` and ``cuda:0`` share one; segments do
    not enter it;
  * an identity-keyed payload refuses to persist
    (UnstableSignatureError); a payload with a signature persists its
    outputs' NamedTuple;
  * corrupt or half-missing entries count as misses;
  * the mixed sweep stored and loaded here is, in its integers, bitwise
    the reference's ``sweep`` of the same scenarios.
"""
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.api import Experiment as JExperiment  # noqa: E402
from repro.core import FailureConfig as JFailureConfig  # noqa: E402
from repro.core import ProtocolConfig as JProtocolConfig  # noqa: E402
from repro.graphs import random_regular_graph  # noqa: E402
from repro.sweep import Scenario as JScenario  # noqa: E402
from repro_torch.api import Experiment, ResultStore, cache_stats  # noqa: E402
from repro_torch.api import plan as plan_mod  # noqa: E402
from repro_torch.api.store import UnstableSignatureError, canonical_token  # noqa: E402
from repro_torch.core import FailureConfig, ProtocolConfig  # noqa: E402
from repro_torch.core import simulator as sim  # noqa: E402
from repro_torch.core.outputs import FULL, RecordedOutputs  # noqa: E402
from repro_torch.graphs import make_graph  # noqa: E402
from repro_torch.sweep import Scenario  # noqa: E402

PART = bool(jax.config.jax_threefry_partitionable)
N, W, Z0, STEPS, SEEDS, BASE_KEY = 24, 10, 5, 40, 2, 7
# name -> (protocol fields, failure fields); the port's DecAFork rows take
# the whole_round kernel's path, the reference's its unfused oracle
SCEN = {
    "calm": (dict(eps=1.8), {}),
    "burst": (dict(eps=2.1), dict(burst_times=(15, 30), burst_sizes=(2, 1))),
    "mp": (dict(algorithm="missingperson", eps_mp=15.0), dict(burst_times=(15,),
                                                             burst_sizes=(3,))),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graph():
    return make_graph("regular", N, seed=3, degree=4)


def _scenarios(port=True, names=("calm", "burst")):
    P, F, S = (ProtocolConfig, FailureConfig, Scenario) if port else (
        JProtocolConfig, JFailureConfig, JScenario)
    out = []
    for name in names:
        pkw, fkw = SCEN[name]
        fused = pkw.get("algorithm", "decafork") == "decafork"
        impl = (dict(estimator_impl="auto") if port else
                dict(estimator_impl="compare", round_impl="unfused")) if fused else {}
        out.append(S(name, P(z0=Z0, max_walks=W, rt_bins=32, protocol_start=10, **pkw, **impl),
                     F(**fkw)))
    return out


def _exp(graph, **kw):
    kw.setdefault("scenarios", _scenarios())
    return Experiment(graph=graph, steps=STEPS, outputs="scalars", device="cpu",
                      partitionable=PART, **kw)


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, RecordedOutputs):
        return list(tree)
    if isinstance(tree, tuple):
        return [x for v in tree for x in _tensors(v)]
    return []


def _digest(tree) -> str:
    h = hashlib.sha256()
    for t in _tensors(tree):
        a = t.numpy()
        h.update(str(a.dtype).encode() + str(a.shape).encode() + a.tobytes())
    return h.hexdigest()


def _no_rounds(monkeypatch):
    calls = []
    monkeypatch.setattr(sim.RoundRunner, "run", lambda *a, **k: calls.append(a))
    return calls


# ---------------------------------------------------------------------------
# same-process warm hits
# ---------------------------------------------------------------------------


def test_store_warm_hit_skips_execution_and_matches(graph, tmp_path, monkeypatch):
    store = ResultStore(tmp_path / "store")
    plan = _exp(graph).plan()
    cold = plan.sweep_stacked(seeds=SEEDS, base_key=BASE_KEY, store=store)
    assert store.puts == 1 and store.misses == 1
    entries = cache_stats()["entries"]
    calls = _no_rounds(monkeypatch)
    warm = plan.sweep_stacked(seeds=SEEDS, base_key=BASE_KEY, store=store)
    assert store.hits == 1 and calls == []  # no round ran...
    assert cache_stats()["entries"] == entries  # ...and no slot was made
    assert isinstance(warm, RecordedOutputs) and warm._fields == cold._fields
    assert _digest(warm) == _digest(cold)
    # Plan.sweep and Experiment.sweep thread the store through each group
    res = _exp(graph).plan().sweep(seeds=SEEDS, base_key=BASE_KEY, store=store)
    assert store.hits == 2 and res.names == ("calm", "burst") and calls == []
    res = _exp(graph).sweep(seeds=SEEDS, base_key=BASE_KEY, store=str(tmp_path / "store"),
                            segment_steps=5)
    assert _digest(res["burst"]) == _digest(cold.map(lambda v: v[1])) and calls == []


def test_store_key_is_content_addressed(graph):
    plan = _exp(graph).plan()
    store = ResultStore("unused-keys-only")
    group = plan._group(_scenarios(), SEEDS, BASE_KEY)

    def key(sig=group["sig"], g=graph, cfg=group["configs"], seeds=SEEDS, base=BASE_KEY):
        return store.sweep_key(sig, g, cfg, seeds, plan_mod._as_key(base, "cpu"))

    base = key()
    assert key() == base  # deterministic
    assert key(seeds=SEEDS + 1) != base
    assert key(base=BASE_KEY + 1) != base
    calm, burst = _scenarios()
    other = plan._group([calm, burst._replace(pcfg=dataclasses.replace(burst.pcfg, eps=2.11))],
                        SEEDS, BASE_KEY)
    assert other["sig"] == group["sig"] and key(cfg=other["configs"]) != base  # one value
    assert key(g=make_graph("regular", N, seed=4, degree=4)) != base
    sig = list(group["sig"])
    dev = [i for i, c in enumerate(sig) if isinstance(c, torch.device)]
    assert len(dev) == 1
    on = lambda d: key(sig=tuple(sig[:dev[0]] + [torch.device(d)] + sig[dev[0] + 1:]))  # noqa: E731
    assert on("cpu") == base and on("cuda") != base and on("cuda") == on("cuda:0")
    assert sig[13] is PART  # the threefry layout
    layout = tuple(sig[:13] + [not PART] + sig[14:])
    assert key(sig=layout) != base


def test_canonical_token_encodes_the_ports_signature(graph):
    from repro_torch.core.payload import Payload

    assert canonical_token(torch.device("cuda", 0)) == canonical_token(torch.device("cuda"))
    decision = sim.RoundDecision("fused", "kernel", "why")
    assert canonical_token(decision) == "RoundDecision(impl='fused',backend='kernel',reason='why')"
    assert canonical_token(FULL).startswith("OutputSpec(fields=('z',")

    class Anon(Payload):  # no signature(): identity-hashed
        pass

    with pytest.raises(UnstableSignatureError, match="Payload.signature"):
        canonical_token(plan_mod.payload_key(Anon()))
    with pytest.raises(UnstableSignatureError):
        canonical_token(object())


def test_unstable_payload_refuses_persistence(graph, tmp_path):
    from repro_torch.core.payload import Payload

    class Anon(Payload):
        pass

    exp = _exp(graph, payload=Anon())
    with pytest.raises(UnstableSignatureError):
        exp.plan().sweep_stacked(seeds=SEEDS, store=ResultStore(tmp_path))


def test_payload_outputs_persist(graph, tmp_path, monkeypatch):
    """A payload with a signature stores its outputs' NamedTuple and gets
    it back as one, bitwise."""
    from repro_torch.data import make_markov_task
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import Model
    from repro_torch.optim import RwSgdPayload, adamw

    cfg = ModelConfig(name="tiny", arch_type="dense", num_layers=1, d_model=16, d_ff=32,
                      vocab_size=32, num_heads=2, num_kv_heads=2, head_dim=8, dtype="float32")
    payload = RwSgdPayload(Model(cfg), adamw(1e-2), make_markov_task(32, device="cpu"),
                           max_walks=W, local_batch=1, seq_len=4)
    exp = Experiment(graph=graph, scenarios=_scenarios(), steps=4, payload=payload,
                     device="cpu")
    store = ResultStore(tmp_path / "store")
    cold = exp.plan().sweep_stacked(seeds=1, store=store)
    calls = _no_rounds(monkeypatch)
    rec, learn = exp.plan().sweep_stacked(seeds=1, store=store)
    assert calls == [] and type(learn) is type(cold[1]) and learn.loss.shape == (2, 1, 4, W)
    assert _digest((rec, learn)) == _digest(cold)


def test_corrupt_entries_degrade_to_misses(graph, tmp_path):
    store = ResultStore(tmp_path / "store")
    plan = _exp(graph).plan()
    plan.sweep_stacked(seeds=SEEDS, base_key=BASE_KEY, store=store)
    (key,) = [f[: -len(".meta.json")] for sub in os.listdir(store.root)
              for f in os.listdir(os.path.join(store.root, sub)) if f.endswith(".meta.json")]
    _base, npz, meta = store._paths(key)
    assert key in store
    with open(npz, "wb") as f:
        f.write(b"not a zipfile")
    assert store.get(key) is None  # corrupt npz: a miss, not an error
    plan.sweep_stacked(seeds=SEEDS, base_key=BASE_KEY, store=store)  # re-put
    assert store.get(key) is not None
    with open(meta) as f:
        doc = json.load(f)
    doc["schema"]["cls"] = ["repro.core.simulator", "SimState"]  # a foreign class
    doc["schema"]["kind"] = "namedtuple"
    with open(meta, "w") as f:
        json.dump(doc, f)
    assert store.get(key) is None
    os.remove(meta)
    assert key not in store and store.get(key) is None  # half-missing entry: a miss


def test_store_resolve_and_env(graph, tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_RESULT_STORE", raising=False)
    assert ResultStore.resolve(None) is None and ResultStore.resolve("env") is None
    store = ResultStore(tmp_path)
    assert ResultStore.resolve(store) is store
    assert ResultStore.resolve(tmp_path).root == str(tmp_path)
    monkeypatch.setenv("REPRO_RESULT_STORE", str(tmp_path / "env"))
    assert ResultStore.resolve("env").root == str(tmp_path / "env")
    with pytest.raises(TypeError):
        ResultStore.resolve(3)
    _exp(graph).sweep(seeds=1, store="env")
    assert os.listdir(tmp_path / "env")


def test_mixed_sweep_store_roundtrip_matches_reference(graph, tmp_path):
    """A mixed sweep (DecAFork rows with different burst schedules, and
    MissingPerson) through the store: the stored and loaded rows are the
    straight ones, and their integers are the reference's sweep."""
    names = ("calm", "burst", "mp")
    exp = _exp(graph, scenarios=_scenarios(names=names))
    store = ResultStore(tmp_path / "store")
    cold = exp.sweep(seeds=SEEDS, base_key=BASE_KEY, store=store)
    warm = exp.sweep(seeds=SEEDS, base_key=BASE_KEY, store=store)
    assert store.hits == 2 and store.puts == 2  # two groups
    ref = JExperiment(graph=random_regular_graph(N, 4, seed=3), steps=STEPS, outputs="scalars",
                      scenarios=_scenarios(port=False, names=names)).sweep(
                          seeds=SEEDS, base_key=BASE_KEY)
    for name in names:
        assert _digest(cold[name]) == _digest(warm[name])
        for f in ("z", "forks", "terms", "failures"):
            np.testing.assert_array_equal(getattr(warm[name], f).numpy(),
                                          np.asarray(getattr(ref[name], f)), err_msg=f"{name} {f}")
        np.testing.assert_allclose(warm[name].theta_mean.numpy(), np.asarray(ref[name].theta_mean),
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# fresh-process warm hit
# ---------------------------------------------------------------------------

_CHILD = textwrap.dedent(
    """
    import hashlib, json, sys
    import torch
    from repro_torch.api import Experiment, ResultStore, cache_stats
    from repro_torch.core import FailureConfig, ProtocolConfig
    from repro_torch.graphs import make_graph
    from repro_torch.sweep import Scenario

    N, W, Z0, STEPS, SEEDS, BASE_KEY = 24, 10, 5, 40, 2, 7
    spec = json.loads(sys.argv[1])
    scenarios = [Scenario(name, ProtocolConfig(**p), FailureConfig(**f))
                 for name, p, f in spec["scenarios"]]
    plan = Experiment(graph=make_graph("regular", N, seed=3, degree=4), steps=STEPS,
                      outputs="scalars", device="cpu", scenarios=scenarios,
                      partitionable=spec["part"]).plan()
    store = ResultStore.from_env()
    result = plan.sweep_stacked(seeds=SEEDS, base_key=BASE_KEY, store=store)
    h = hashlib.sha256()
    for t in result:
        a = t.numpy()
        h.update(str(a.dtype).encode() + str(a.shape).encode() + a.tobytes())
    print(json.dumps({"digest": h.hexdigest(), "hits": store.hits, "misses": store.misses,
                      "entries": cache_stats()["entries"],
                      "jax": "jax" in sys.modules, "repro": "repro" in sys.modules}))
    """
)


def test_fresh_process_store_hit_bitwise_no_slot(graph, tmp_path):
    """A second PROCESS re-running the same study answers from disk:
    bitwise the same tensors, and its executable cache stays empty."""
    store = ResultStore(tmp_path / "store")
    cold = _exp(graph).plan().sweep_stacked(seeds=SEEDS, base_key=BASE_KEY, store=store)
    spec = {"part": PART, "scenarios": [
        (s.name, dataclasses.asdict(s.pcfg), dataclasses.asdict(s.fcfg)) for s in _scenarios()]}
    env = dict(os.environ, REPRO_RESULT_STORE=store.root)
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep * bool(env.get("PYTHONPATH")) + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(spec)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["hits"] == 1 and report["misses"] == 0
    assert report["entries"] == 0  # the child made no runner
    assert not report["jax"] and not report["repro"]
    assert report["digest"] == _digest(cold)
