"""Each CUDA kernel of the port against its plain PyTorch version on the
card: the round kernels bitwise at small and paper shapes, the attention
and SSD kernels within the reference kernel tests' tolerances (2e-4 f32
attention, 3e-2 bf16 attention, 3e-4 SSD), and the smoke models served
with and without the kernels. Needs an NVIDIA GPU: every test here is
marked ``cuda`` and skips elsewhere. It imports no JAX, so it runs on a
machine with torch and nvcc only (``--noconftest``: the test package's
conftest imports JAX):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.graphs import make_graph  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    flash_attention,
    flash_attention_plain,
    round_update,
    round_update_plain,
    ssd_intra_chunk,
    ssd_intra_chunk_plain,
    theta_sums,
    theta_sums_plain,
    whole_round,
    whole_round_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels only build and run on the card")
    return torch.device("cuda")


def _observation(rng, batch, n, C, B, W, t, dev):
    ls = rng.integers(-1, t, (batch, n, C)).astype(np.int32)
    hist = np.floor(rng.random((batch, n, B)) * 3).astype(np.int16)
    total = hist.sum(2, dtype=np.int32)
    pos = rng.integers(0, n, (batch, W)).astype(np.int32)
    track = rng.integers(0, C, (batch, W)).astype(np.int32)
    active = rng.random((batch, W)) < 0.8
    rows = np.take_along_axis(ls, pos[..., None], 1)  # (batch, W, C)
    prev = np.take_along_axis(rows, track[..., None], 2)[..., 0]
    r = (t - prev).astype(np.int32)
    valid = active & (prev != -1) & (r >= 1)
    upd = np.where(active, t, -1).astype(np.int32)
    tt = np.full((batch,), t, np.int32)
    assert C * total.max() < 2**24  # the node-sum's exact-integer condition
    return [torch.as_tensor(a, device=dev) for a in (ls, hist, total, pos, track, r, valid, upd, tt)]


def _assert_same(got, want):
    for g, w in zip(got, want):
        g, w = g.cpu(), w.cpu()
        if g.dtype.is_floating_point:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)


@pytest.mark.parametrize("batch,n,C,B,W", [
    (2, 19, 16, 64, 16),
    (50, 100, 64, 1024, 64),
    (2, 19, 100, 1000, 16),  # two-byte loads (B not a multiple of 8); more columns than preloaded
    (2, 100, 64, 2048, 64),  # two segments of 1,024 bins
])
def test_cuda_observation_kernels_bitwise(cuda, batch, n, C, B, W):
    x = _observation(np.random.default_rng(n), batch, n, C, B, W, 70, cuda)
    before = (round_update.launches, theta_sums.launches)
    _assert_same(round_update(*[a.clone() for a in x]), round_update_plain(*[a.clone() for a in x]))
    args = (x[0], x[1], x[2], x[8])
    _assert_same((theta_sums(*args),), (theta_sums_plain(*args),))
    assert (round_update.launches, theta_sums.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("plus", [False, True])
@pytest.mark.parametrize("batch,n,W,C,B,K,crowded", [
    pytest.param(2, 19, 16, 16, 64, 2, False, id="2-19-16-16-64"),
    pytest.param(50, 100, 64, 64, 1024, 2, False, id="50-100-64-64-1024"),
    pytest.param(4, 100, 50, 64, 1024, 2, False, id="W50"),  # W not a multiple of 32
    pytest.param(4, 100, 64, 64, 1024, 2, True, id="crowded"),  # every walk starts on 3 nodes
    pytest.param(2, 100, 64, 64, 2048, 2, False, id="B2048"),
    pytest.param(2, 2000, 64, 64, 1024, 2, False, id="n2000"),
    pytest.param(4, 100, 64, 64, 1024, 3, False, id="K3"),  # more bursts than the kernel prefetches
    pytest.param(2, 2000, 1100, 1100, 64, 2, False, id="W1100"),  # more slots than threads
])
def test_cuda_whole_round_bitwise(cuda, plus, batch, n, W, C, B, K, crowded):
    _whole_round_case(cuda, plus, make_graph("regular", n + n % 2, seed=0, degree=4),
                      batch, W, C, B, K, crowded, np.random.default_rng(n + plus))


@pytest.mark.parametrize("plus", [False, True])
@pytest.mark.parametrize("family,kw", [
    pytest.param("complete", {}, id="complete-D99"),  # Fig. 6's complete graph: four chunks
    pytest.param("erdos_renyi", dict(p=0.4), id="er-D54"),  # ragged rows of 29-54: two chunks
])
def test_cuda_whole_round_wide_rows_bitwise(cuda, plus, family, kw):
    """Rows wider than 32 neighbours: the hop's chunk loop past the first
    32 (``csrc/whole_round.cu::avail_bits``), at n 100."""
    g = make_graph(family, 100, seed=0, **kw)
    assert g.max_degree > 32
    _whole_round_case(cuda, plus, g, 8, 64, 64, 1024, 2, False, np.random.default_rng(7 + plus))


def _whole_round_case(cuda, plus, g, batch, W, C, B, K, crowded, rng):
    n, D = g.n, g.max_degree
    x = _observation(rng, batch, n, C, B, W, 70, cuda)
    if crowded:  # many slots share a row: theta is computed once per distinct row
        x[3] = torch.as_tensor(rng.choice([3, 5, 8], (batch, W)).astype(np.int32), device=cuda)
    to = lambda a: torch.as_tensor(a, device=cuda)  # noqa: E731
    f32 = lambda *s: to(rng.random(s).astype(np.float32))  # noqa: E731
    params_f = np.tile(np.array([0.05, 0.1, 0.1, 0.3, 0.4, 7.0, 8.0, 0.5], np.float32), (batch, 1))
    params_i = np.tile(np.array([70, 2, 4, 1], np.int32), (batch, 1))
    args = [
        x[0], x[1], x[2], to(rng.random((batch, n)) < 0.85), to(rng.random((batch, n, D)) < 0.85),
        x[3], to(np.tile(np.arange(W, dtype=np.int32), (batch, 1))), to(rng.random((batch, W)) < 0.8),
        to(g.neighbors.astype(np.int32)), to(g.degrees.astype(np.int32)),
        f32(batch, W), f32(batch, W), f32(batch, W), f32(batch, W), f32(batch, K, W),
        to(rng.integers(0, 4, (batch, K)).astype(np.int32)), f32(batch, n), f32(batch, n),
        to(rng.random((batch, n)) < 0.05), f32(batch, n, D), f32(batch, n, D),
        to(params_f), to(params_i),
    ]
    before = whole_round.launches
    _assert_same(whole_round(*[a.clone() for a in args], decafork_plus=plus),
                 whole_round_plain(*[a.clone() for a in args], plus))
    assert whole_round.launches == before + 1


def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    x = _observation(np.random.default_rng(0), 1, 19, 16, 64, 16, 70, cuda)
    with pytest.raises(TypeError):
        theta_sums(x[0], x[1].to(torch.int32), x[2], x[8])  # hist must be int16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,D,window", [
    (2, 128, 4, 4, 32, 0), (2, 256, 8, 2, 64, 96), (1, 7, 4, 2, 32, 0),
    (1, 512, 32, 4, 128, 0), (1, 256, 4, 1, 256, 96),
    # shorter than, equal to and ragged against the bf16 kernel's 128-row
    # query tile and 64-key tiles; GQA ratios 1, 4, 8; window edges inside
    # a key tile (96, 100); every head dim
    (2, 64, 8, 8, 64, 0), (1, 384, 8, 1, 128, 100), (2, 512, 16, 4, 256, 96),
    (1, 128, 8, 1, 32, 100), (1, 384, 4, 4, 256, 0), (2, 64, 4, 1, 128, 0),
    # against the f32 kernel's tiles (32 or 64 rows of G heads x M / G
    # positions; 32- or 64-key tiles, split over key groups in the 32-row
    # tile): S ragged against both (100), shorter than one (7), one key
    # tile (64), many (384); GQA ratios 1, 2, 8 and 64 (more heads than a
    # CTA's rows: two head chunks); windows 96 and 100 inside a key tile;
    # every head dim
    (1, 100, 8, 4, 32, 0), (2, 100, 16, 2, 64, 96), (1, 384, 8, 4, 128, 96),
    (1, 7, 8, 1, 256, 0), (1, 64, 2, 1, 32, 100), (2, 384, 4, 2, 64, 100),
    (1, 100, 8, 8, 128, 0), (1, 64, 64, 1, 32, 0), (4, 512, 32, 4, 128, 0),
])
def test_cuda_flash_attention_matches_plain(cuda, dtype, B, S, H, KV, D, window):
    rng = np.random.default_rng(S + D + window)
    q, k, v = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32).to(cuda, dtype)
               for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    before = flash_attention.launches
    got = flash_attention(q, k, v, window=window)
    assert flash_attention.launches == before + 1 and got.dtype == dtype
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), flash_attention_plain(q, k, v, window).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,nc,Q,H,P,N", [
    (2, 2, 64, 2, 16, 8), (1, 3, 20, 2, 16, 8), (2, 2, 256, 8, 64, 128),
    # against the kernel's tiles: Q 192 (three 64-row query tiles: a pair
    # and a middle tile alone), P 128 (two 64-row halves of p, MAX_HEAD_DIM),
    # N 8 and N 24 (below and ragged against the 8-step and the 128-column
    # state slice), odd P (4-byte copies), Q 300 with N 200 (two slices),
    # and mamba2-1.3b's head count at one chunk
    (1, 2, 192, 4, 64, 32), (1, 1, 256, 4, 128, 128), (1, 1, 128, 2, 64, 8),
    (1, 2, 100, 3, 40, 24), (1, 1, 64, 2, 7, 5), (1, 1, 300, 2, 128, 200),
    (1, 1, 256, 64, 64, 128),
    # against the f32 kernel's tiles (64 x 64 outputs, 32 time steps a
    # stage): Q equal to one stage (32), ragged against the query tile
    # (96) and against both and not a multiple of 4 (130: 4-byte copies);
    # P 7, 40, 128; N 5, 200; H 64 at Q 256
    (1, 2, 32, 4, 64, 64), (1, 1, 96, 2, 40, 200), (1, 2, 130, 3, 7, 5),
    (2, 1, 256, 64, 128, 5),
])
def test_cuda_ssd_intra_chunk_matches_plain(cuda, dtype, B, nc, Q, H, P, N):
    x, da, b, c = _ssd_inputs(np.random.default_rng(Q + H), cuda, B, nc, Q, H, P, N, dtype)
    before = ssd_intra_chunk.launches
    got = ssd_intra_chunk(x, da, b, c)
    assert ssd_intra_chunk.launches == before + 1
    for g, w in zip(got, ssd_intra_chunk_plain(x, da, b, c)):
        torch.testing.assert_close(g, w, rtol=3e-4, atol=3e-4)


def _ssd_inputs(rng, dev, B, nc, Q, H, P, N, dtype):
    f = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32, device=dev)  # noqa: E731
    x = f(B, nc, Q, H, P)
    steps = torch.nn.functional.softplus(f(B, nc, Q, H)) * -torch.exp(f(H))
    da = torch.cumsum(steps, dim=2).contiguous()
    return x, da, f(B, nc, Q, N).to(dtype), f(B, nc, Q, N).to(dtype)


def test_cuda_ssd_intra_chunk_f32_bitwise_at_mamba2_1_3b(cuda):
    """At mamba2-1.3b's prefill shape the f32 kernel sums in the plain
    version's order and rounds its weights as it does: y and the states
    are bitwise equal (the float32 serving gate rests on it)."""
    args = _ssd_inputs(np.random.default_rng(0), cuda, 4, 2, 256, 64, 64, 128, torch.float32)
    for g, w in zip(ssd_intra_chunk(*args), ssd_intra_chunk_plain(*args)):
        assert torch.equal(g, w)


def test_cuda_model_kernels_raise_instead_of_falling_back(cuda):
    q = torch.zeros((1, 128, 4, 48), device=cuda)  # a head dim the kernel is not built for
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, q, q)
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    x = torch.zeros((1, 1, 32, 2, 256), device=cuda)  # P beyond the kernel's 128
    da = torch.zeros((1, 1, 32, 2), device=cuda)
    b = torch.zeros((1, 1, 32, 8), device=cuda)
    with pytest.raises(ValueError, match="P <="):
        ssd_intra_chunk(x, da, b, b)


@pytest.mark.parametrize("arch", ["yi_6b", "mamba2_1_3b"])
def test_cuda_serve_smoke_config_through_the_kernels(cuda, arch):
    """The smoke model served on the card with ``use_pallas``: every layer's
    prefill launches the kernel once, and the logits agree with the same
    weights run through plain torch on the card."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import Model
    from repro_torch.utils import prng

    cfg = get_smoke_config(arch, use_pallas=True, ssd_chunk=32)
    model, plain = Model(cfg), Model(dataclasses.replace(cfg, use_pallas=False))
    params = model.init(prng.key(0), cuda)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 64)),
                           dtype=torch.int32, device=cuda)
    kern = flash_attention if arch == "yi_6b" else ssd_intra_chunk
    before = kern.launches
    last, _ = model.prefill(params, {"tokens": toks})
    assert kern.launches == before + cfg.num_layers
    want, _ = plain.prefill(params, {"tokens": toks})
    torch.testing.assert_close(last, want, rtol=2e-4, atol=2e-4)
    gen, stats = generate(model, params, {"tokens": toks}, 4)
    assert gen.shape == (2, 4) and stats["decode_steps"] == 3


def test_cuda_mixed_sweep_matches_cpu(cuda):
    """A small mixed sweep (MissingPerson, ``none``, a DecAFork eps pair,
    DecAFork+) on the card equals the same sweep on the CPU bitwise in its
    integer outputs; the DecAFork group's rounds launch whole_round once
    each, for both of its scenarios' rows at once."""
    from repro_torch.api import Experiment
    from repro_torch.api import plan as plan_mod
    from repro_torch.core import FailureConfig, ProtocolConfig
    from repro_torch.sweep import Scenario

    steps, base = 60, dict(z0=6, max_walks=16, rt_bins=64, protocol_start=20,
                           estimator_impl="auto")
    bursts = FailureConfig(burst_times=(30,), burst_sizes=(3,))
    scen = [
        Scenario("mp", ProtocolConfig(algorithm="missingperson", eps_mp=25.0, **base), bursts),
        Scenario("none", ProtocolConfig(algorithm="none", **base), bursts),
        Scenario("eps=1.8", ProtocolConfig(eps=1.8, **base), bursts),
        Scenario("eps=2.5", ProtocolConfig(eps=2.5, **base), FailureConfig()),
        Scenario("plus", ProtocolConfig(algorithm="decafork+", eps=3.0, eps2=7.57, **base),
                 FailureConfig(p_fail=0.01)),
    ]
    g = make_graph("regular", 40, seed=0, degree=4)
    runs = {}
    plan_mod.clear_cache()  # each group captures here, its warm-up one real round
    try:
        for dev in ("cpu", cuda):
            exp = Experiment(graph=g, scenarios=scen, steps=steps, outputs="full", device=dev)
            before = whole_round.launches
            runs[str(dev)] = exp.sweep(seeds=3)
            launches = whole_round.launches - before
    finally:
        plan_mod.clear_cache()
    assert launches == 2 * (steps + 1)  # the DecAFork and DecAFork+ groups
    for s in scen:
        got, want = runs["cuda"][s.name], runs["cpu"][s.name]
        for f in ("z", "forks", "terms", "failures", "fork_parent", "terminated"):
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), (s.name, f)
        torch.testing.assert_close(got.theta_mean.cpu(), want.theta_mean, rtol=1e-6, atol=1e-6)


def test_cuda_zoo_grid_matches_cpu(cuda):
    """A small zoo grid (the four defenses against the four attacks on a
    24-node community graph) on the card equals the same grid on the CPU
    bitwise in its integer outputs; every group runs unfused, launching
    round_update once per round (and once in its capture's warm-up
    round) and whole_round never."""
    from repro_torch.api import Experiment
    from repro_torch.api import plan as plan_mod

    steps, n = 60, 24
    cfg = {"experiment": "zoo", "n": n, "steps": steps, "outputs": "full",
           "graph_kwargs": {"k_bridges": 2},
           "protocol": dict(algorithm="decafork+", eps=3.0, eps2=7.57, estimator_impl="auto",
                            **CAPTURE_BASE),
           "defenses": ("uniform", "jump", "biased", "bloom"),
           "attacks": ("none", ("mobile_pacman", {"hop_prob": 0.5, "start": 20}),
                       ("multi_pacman", {"nodes": (0, n // 2), "start": 20}),
                       ("edge_cut", {"time": 20, "threshold": n // 2}))}
    runs = {}
    plan_mod.clear_cache()
    try:
        for dev in ("cpu", cuda):
            exp = Experiment.from_config({**cfg, "device": dev})
            groups = len(exp.plan().groups())
            assert not any(d.fused for _, _, d in exp.plan().round_decisions())
            before = (whole_round.launches, round_update.launches)
            runs[str(dev)] = exp.sweep(seeds=3)
            grew = (whole_round.launches - before[0], round_update.launches - before[1])
    finally:
        plan_mod.clear_cache()
    assert grew == (0, groups * (steps + 1))
    for name in runs["cpu"].names:
        got, want = runs["cuda"][name], runs["cpu"][name]
        for f in ("z", "forks", "terms", "failures", "fork_parent", "terminated"):
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), (name, f)
        torch.testing.assert_close(got.theta_mean.cpu(), want.theta_mean, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# captured execution: rounds and decode replayed as CUDA graphs
# ---------------------------------------------------------------------------

CAPTURE_BASE = dict(z0=6, max_walks=16, rt_bins=64, protocol_start=10)


def _capture_cases():
    import dataclasses

    from repro_torch.core import FailureConfig, ProtocolConfig

    fc = FailureConfig(burst_times=(15,), burst_sizes=(2,), p_fail=0.01, byzantine_node=2,
                       p_byz=0.05, p_node_fail=0.02, p_node_recover=0.3, p_link_fail=0.02,
                       p_link_recover=0.4, pacman_node=4, pacman_start_time=20)
    return {
        "fused": (ProtocolConfig(eps=2.0, estimator_impl="auto", **CAPTURE_BASE), fc,
                  whole_round),
        "missingperson": (ProtocolConfig("missingperson", eps_mp=12.0, **CAPTURE_BASE), fc,
                          None),
        "auto_eps": (ProtocolConfig("decafork+", eps=3.0, eps2=7.57, auto_eps=True,
                                    estimator_impl="pallas", auto_min_samples=3,
                                    **CAPTURE_BASE), fc, theta_sums),
        # the zoo: unfused rounds through the round_update kernel
        "bloom": (ProtocolConfig("decafork+", eps=3.0, eps2=7.57, walk_variant="bloom",
                                 bloom_bits=32, estimator_impl="auto", **CAPTURE_BASE),
                  dataclasses.replace(fc, edge_cut_times=(12,), edge_cut_thresholds=(12,)),
                  round_update),
        "mobile_pacman": (ProtocolConfig("decafork+", eps=3.0, eps2=7.57, walk_variant="jump",
                                         p_jump=0.2, estimator_impl="auto", **CAPTURE_BASE),
                          dataclasses.replace(fc, pacman_mobile=True, pacman_nodes=(7,),
                                              pacman_hop_prob=0.5, pacman_start_time=5),
                          round_update),
    }


def _equal_trees(a, b, label):
    from repro_torch.utils.tree import tree_leaves

    a, b = tree_leaves(tuple(a)), tree_leaves(tuple(b))
    assert len(a) == len(b) and a, label
    for x, y in zip(a, b):
        x, y = x.cpu(), y.cpu()
        if x.dtype.is_floating_point:  # bitwise, theta_mean included
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), label


def _device_launches(fn):
    """Kernel wrapper name -> launches of its kernel that the device
    recorded (torch.profiler's CUDA events) while ``fn`` ran."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import KERNELS

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    assert events, "the profiler saw no device kernel"
    out = {}
    for k in KERNELS:
        pat = re.compile("|".join(rf"\b{s}\b" for s in k.symbols))
        out[k.__name__] = sum(e.count for e in events if pat.search(e.key))
    return out


@pytest.mark.parametrize("case", ["fused", "missingperson", "auto_eps", "bloom",
                                  "mobile_pacman"])
def test_cuda_captured_run_is_the_eager_run(cuda, case):
    """A captured run equals the eager loop bitwise (integers, final carry,
    theta_mean, the zoo's Bloom filters and Pac-Man positions), twice with
    other keys and thresholds through one capture. The captured graph
    holds the kernel once per round (whole_round for the fused group,
    theta_sums for auto_eps, round_update for the zoo's unfused groups,
    no kernel for MissingPerson); its counter grows by the replayed rounds, plus
    the capture's one warm-up round, and the device records as many
    launches as the counter adds per replayed round."""
    import dataclasses

    from repro_torch.core import simulator as sim
    from repro_torch.core.outputs import FULL
    from repro_torch.kernels import KERNELS
    from repro_torch.utils import prng

    pcfg, fcfg, kern = _capture_cases()[case]
    g = make_graph("erdos_renyi", 24, seed=0)
    # the zoo's rounds hold up to ~3,100 kernel nodes: 25 of them stay
    # well below the ~110,000 records a profiler window kept on the card
    steps, seeds = (25 if case in ("bloom", "mobile_pacman") else 37), 3
    runner = None
    for key, eps in ((0, pcfg.eps), (1, pcfg.eps + 0.5)):
        p = dataclasses.replace(pcfg, eps=eps)
        setup = sim.make_setup(g, [p] * seeds, [fcfg] * seeds, steps, cuda)
        decision = sim.round_impl_decision(p, fcfg)
        assert decision.fused == (case == "fused")
        keys = prng.split(prng.key(key, device=cuda), seeds)
        want = sim.run_rounds(sim.init_state(keys, setup), setup, steps, FULL, decision)
        runner = runner or sim.RoundRunner(setup, FULL, decision)
        warmup = int(runner.graph is None)  # the capture's one real round
        before = {k.__name__: k.launches for k in KERNELS}
        got = runner.run(sim.init_state(keys, setup), setup)
        grew = {k.__name__: k.launches - before[k.__name__] for k in KERNELS}
        assert grew == {k.__name__: (steps + warmup if k is kern else 0) for k in KERNELS}
        _equal_trees(got[0], want[0], f"{case}: final carry")
        _equal_trees(got[1], want[1], f"{case}: recorded outputs")
    assert runner.captures == 1
    assert runner.graph.per_replay == ({kern: 1} if kern is not None else {})
    want = {k.__name__: (steps if k is kern else 0) for k in KERNELS}
    for _ in range(3):  # the profiler can drop records under load: a short window repeats
        before = {k.__name__: k.launches for k in KERNELS}
        seen = _device_launches(lambda: runner.run(sim.init_state(keys, setup), setup))
        assert {k.__name__: k.launches - before[k.__name__] for k in KERNELS} == want
        if seen == want:
            break
    assert seen == want


def test_cuda_second_run_captures_nothing_and_never_syncs(cuda):
    """Through the Plan's cache: a re-run of one structure with new keys,
    eps and a fresh Plan opens no slot and captures no graph, and its
    replays issue no host synchronisation."""
    import dataclasses

    from repro_torch.api import Experiment, cache_stats
    from repro_torch.api import plan as plan_mod
    from repro_torch.core import simulator as sim
    from repro_torch.utils import prng

    pcfg, fcfg, _ = _capture_cases()["fused"]
    g = make_graph("erdos_renyi", 24, seed=0)
    plan_mod.clear_cache()
    try:
        Experiment(graph=g, protocol=pcfg, failures=fcfg, steps=37, device=cuda).ensemble(3)
        st = cache_stats()
        assert st["entries"] == 1 and st["graphs_captured"] == 1
        exp = Experiment(graph=g, protocol=dataclasses.replace(pcfg, eps=2.6), failures=fcfg,
                         steps=37, device=cuda)
        exp.ensemble(3, base_key=5)
        assert cache_stats() == st
        plan = exp.plan()
        setup = plan._setup(3)
        (runner,) = plan_mod._EXECUTABLES.values()
        state = sim.init_state(prng.split(prng.key(9, device=cuda), 3), setup)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            runner.run(state, setup)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert cache_stats() == st
    finally:
        plan_mod.clear_cache()


@pytest.mark.parametrize("arch", ["yi_6b", "mamba2_1_3b"])
def test_cuda_captured_decode_tokens_equal_eager(cuda, arch):
    """The captured decode loop's tokens equal the eager loop's, greedy
    and sampled with an EOS exit, and one signature captures once."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import generate, generate_eager
    from repro_torch.models import Model
    from repro_torch.utils import prng

    cfg = get_smoke_config(arch, use_pallas=True, ssd_chunk=32)
    model = Model(cfg)
    params = model.init(prng.key(0), cuda)
    toks = {"tokens": torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 64)),
                                      dtype=torch.int32, device=cuda)}
    for _ in range(2):
        got, stats = generate(model, params, toks, 8)
        want, wstats = generate_eager(model, params, toks, 8)
        assert torch.equal(got, want) and stats["decode_steps"] == wstats["decode_steps"] == 7
    assert len(model.decode_graphs) == 1
    kw = dict(temperature=0.8, key=prng.key(7, device=cuda))
    sampled, _ = generate(model, params, toks, 10, **kw)
    eos = int(sampled[0, 1])
    got, stats = generate(model, params, toks, 10, eos_id=eos, eos_check_every=1, **kw)
    want, wstats = generate_eager(model, params, toks, 10, eos_id=eos, eos_check_every=1, **kw)
    assert torch.equal(got, want) and stats["decode_steps"] == wstats["decode_steps"]


# ---------------------------------------------------------------------------
# the RW-SGD payload on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plus", [False, True])
@pytest.mark.parametrize("batch,n,D,W,B", [
    pytest.param(4, 64, 8, 16, 512, id="paper-rwsgd"),  # chip_smoke.py phase 10 (a)
    pytest.param(12, 48, 6, 12, 256, id="fig8"),  # Fig. 8's groups at BENCH_FULL
])
def test_cuda_whole_round_at_payload_shapes(cuda, plus, batch, n, D, W, B):
    """whole_round bitwise its plain version at the payload paths' shapes:
    regular graphs of degree 8 and 6 (rows narrower than the wide-row
    cases), W 16 and 12."""
    _whole_round_case(cuda, plus, make_graph("regular", n, seed=0, degree=D), batch, W, W, B,
                      1, False, np.random.default_rng(n + D + plus))


def _payload_case(cuda, steps=30, seeds=3):
    """A DecAFork+ group whose round is fused (whole_round), a burst at
    step 14 so forks copy replicas, and a 1-layer d 32 RW-SGD payload."""
    from repro_torch.core import FailureConfig, ProtocolConfig
    from repro_torch.core import simulator as sim
    from repro_torch.data import make_markov_task
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import Model
    from repro_torch.optim import RwSgdPayload, adamw

    cfg = ModelConfig(name="tiny", arch_type="dense", num_layers=1, d_model=32, d_ff=64,
                      vocab_size=64, num_heads=2, num_kv_heads=2, head_dim=16, dtype="float32")
    payload = RwSgdPayload(Model(cfg), adamw(1e-2), make_markov_task(64, rank=4, device=cuda),
                           max_walks=10, local_batch=1, seq_len=8)
    pcfg = ProtocolConfig("decafork+", z0=5, max_walks=10, rt_bins=32, protocol_start=8,
                          eps=1.6, eps2=6.0, estimator_impl="auto")
    fcfg = FailureConfig(burst_times=(14,), burst_sizes=(2,))
    setup = sim.make_setup(make_graph("regular", 24, seed=3, degree=4), [pcfg] * seeds,
                           [fcfg] * seeds, steps, cuda)
    decision = sim.round_impl_decision(pcfg, fcfg)
    assert decision.fused
    return payload, setup, decision


def test_cuda_payload_captured_round_is_the_eager_round(cuda):
    """One captured round (protocol round, replica copies, forward,
    backward and AdamW) replayed per round equals the eager loop bitwise:
    StepOutputs, final state, replicas, losses; whole_round launches once
    per round plus the capture's warm-up round. The backward issues no
    atomic float sum (``transformer.replica_losses``), so this holds."""
    from repro_torch.core import simulator as sim
    from repro_torch.core.outputs import FULL
    from repro_torch.utils import prng

    payload, setup, decision = _payload_case(cuda)
    keys = prng.split(prng.key(2, device=cuda), 3)
    carry = sim.init_payload(keys, setup, payload)
    want = sim.run_rounds(sim.init_state(keys, setup), setup, 30, FULL, decision,
                          payload=payload, carry=carry)
    runner = sim.RoundRunner(setup, FULL, decision, payload)
    before = whole_round.launches
    got = runner.run(sim.init_state(keys, setup), setup, sim.init_payload(keys, setup, payload))
    assert whole_round.launches - before == 30 + 1 and runner.captures == 1
    _equal_trees(got[0], want[0], "final state and replicas")
    _equal_trees(tuple(got[1][0]), tuple(want[1][0]), "StepOutputs")
    _equal_trees(got[1][1], want[1][1], "payload outputs")
    assert int(got[1][0].forks.sum()) > 0 and int(got[1][1].trained.sum()) > 0


def test_cuda_payload_runs_are_bitwise_run_to_run(cuda):
    """The same run twice through one capture, and once through a second
    runner (its own capture), is bitwise the same: losses, replicas."""
    from repro_torch.core import simulator as sim
    from repro_torch.core.outputs import FULL
    from repro_torch.utils import prng

    payload, setup, decision = _payload_case(cuda)
    keys = prng.split(prng.key(4, device=cuda), 3)
    runs = []
    first = sim.RoundRunner(setup, FULL, decision, payload)
    for runner in (first, first, sim.RoundRunner(setup, FULL, decision, payload)):
        runs.append(runner.run(sim.init_state(keys, setup), setup,
                               sim.init_payload(keys, setup, payload)))
    for other in runs[1:]:
        _equal_trees(other[0], runs[0][0], "final state and replicas")
        _equal_trees(other[1][1], runs[0][1][1], "payload outputs")
