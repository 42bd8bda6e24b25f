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
    # the served families' prefills: hymba-1.5b (G 5, D 64: 12 positions x
    # 5 heads in the f32 kernel's 64-row tile), dbrx-132b (G 6, D 128),
    # musicgen-large (G 1, D 64), qwen2-vl-2b (G 6, S 1,536: vision + text)
    (4, 512, 25, 5, 64, 0), (4, 512, 48, 8, 128, 0), (4, 512, 32, 32, 64, 0),
    (2, 1536, 12, 2, 128, 0),
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
    # hymba-1.5b's prefill: N 16, one ragged state slice in the bf16 kernel
    (4, 2, 256, 50, 64, 16),
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


FAMILIES = ("dbrx_132b", "deepseek_v2_236b", "hymba_1_5b", "musicgen_large", "qwen2_vl_2b")


def _family_case(cuda, arch, b=2, s=64, **over):
    """A smoke model of ``arch`` on the card with its weights (seed 0) and
    a prefill batch (``s`` counts the vlm's vision prefix)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import random_batch_like
    from repro_torch.models import Model
    from repro_torch.models.model import batch_spec
    from repro_torch.utils import prng

    if arch == "hymba_1_5b":
        over.setdefault("ssd_chunk", 32)
    cfg = get_smoke_config(arch, **over)
    model = Model(cfg)
    params = model.init(prng.key(0), cuda)
    batch = random_batch_like(batch_spec(cfg, b, s, "prefill"), prng.key(1), device=cuda)
    batch["tokens"] = batch["tokens"] % cfg.vocab_size
    return cfg, model, params, batch


@pytest.mark.parametrize("arch", FAMILIES)
def test_cuda_serve_families_through_the_kernels(cuda, arch):
    """Each served family's smoke model on the card with ``use_pallas``:
    flash_attention (every family but MLA's, whose prefill runs the plain
    attention, as in the reference) and ssd_intra_chunk (hybrid) launch
    once per layer in a prefill; the logits agree with plain torch on the
    card and with the CPU within 2e-4, and the greedy tokens equal the
    CPU's."""
    import dataclasses

    from repro_torch.launch.serve import generate
    from repro_torch.models import Model
    from repro_torch.utils import prng

    cfg, model, params, batch = _family_case(cuda, arch, use_pallas=True)
    L = cfg.num_layers
    want = {flash_attention: 0 if cfg.use_mla else L,
            ssd_intra_chunk: L if cfg.arch_type == "hybrid" else 0}
    before = {k: k.launches for k in want}
    last, _ = model.prefill(params, batch)
    assert {k: k.launches - before[k] for k in want} == want
    plain = Model(dataclasses.replace(cfg, use_pallas=False))
    torch.testing.assert_close(last, plain.prefill(params, batch)[0], rtol=2e-4, atol=2e-4)
    cpu_params = model.init(prng.key(0), "cpu")
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    cpu_last, _ = model.prefill(cpu_params, cpu_batch)
    torch.testing.assert_close(last.cpu(), cpu_last, rtol=2e-4, atol=2e-4)
    gen, stats = generate(model, params, batch, 6)
    cpu_gen, _ = generate(model, cpu_params, cpu_batch, 6)
    assert torch.equal(gen.cpu(), cpu_gen) and stats["decode_steps"] == 5


@pytest.mark.parametrize("arch,over", [("dbrx_132b", {}), ("deepseek_v2_236b", {}),
                                       ("deepseek_v2_236b", dict(mla_absorb=True)),
                                       ("dbrx_132b", dict(moe_groups=2, capacity_factor=0.5))])
def test_cuda_moe_decode_captures_and_is_the_eager_decode(cuda, arch, over):
    """The MoE decode step (routing, sort, dispatch, expert products,
    combine) captures as a CUDA graph (a host synchronisation would fail
    the capture) and its replay's logits and cache are bitwise the eager
    step's, which is bitwise itself from run to run; generate's captured
    loop gives the eager loop's tokens."""
    from repro_torch.launch.serve import expand_cache, generate, generate_eager

    cfg, model, params, batch = _family_case(cuda, arch, use_pallas=True, **over)
    last, cache = model.prefill(params, batch)
    tok = {"tokens": torch.argmax(last, dim=-1).to(torch.int32)}

    def fresh():
        return expand_cache(model, cache, 64 + 8)

    eager = [model.decode_step(params, fresh(), tok) for _ in range(2)]
    for a, b in zip(eager[0][1]["layers"].values(), eager[1][1]["layers"].values()):
        assert torch.equal(a, b)
    assert torch.equal(eager[0][0], eager[1][0])
    static = fresh()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # warm-up outside the capture
        model.decode_step(params, expand_cache(model, cache, 64 + 8), tok)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        logits, _ = model.decode_step(params, static, tok)
    expand_cache(model, cache, 64 + 8, out=static)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(logits, eager[0][0])
    for name, t in static["layers"].items():
        assert torch.equal(t, eager[0][1]["layers"][name]), name
    got, stats = generate(model, params, batch, 8)
    want, wstats = generate_eager(model, params, batch, 8)
    assert torch.equal(got, want) and stats["decode_steps"] == wstats["decode_steps"] == 7


@pytest.mark.parametrize("arch", ["hymba_1_5b", "musicgen_large", "qwen2_vl_2b"])
def test_cuda_family_captured_decode_tokens_equal_eager(cuda, arch):
    """The hybrid, codebook and vision-prefix decode loops: captured
    tokens equal the eager loop's, greedy and sampled (codebook tokens
    (B, new, nq), with no EOS freeze)."""
    from repro_torch.launch.serve import generate, generate_eager
    from repro_torch.utils import prng

    cfg, model, params, batch = _family_case(cuda, arch, use_pallas=True)
    for kw in ({}, {}, dict(temperature=0.8, key=prng.key(7, device=cuda))):
        got, stats = generate(model, params, batch, 8, **kw)
        want, wstats = generate_eager(model, params, batch, 8, **kw)
        assert torch.equal(got, want) and stats["decode_steps"] == wstats["decode_steps"] == 7
    assert len(model.decode_graphs) == 2  # greedy and sampled; the second greedy call reused


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


# ---------------------------------------------------------------------------
# durable execution and the service on the card
# ---------------------------------------------------------------------------


def _durable_experiment(cuda, steps=37, **kw):
    from repro_torch.api import Experiment

    pcfg, fcfg, _ = _capture_cases()["fused"]
    return Experiment(graph=make_graph("erdos_renyi", 24, seed=0), protocol=pcfg, failures=fcfg,
                      steps=steps, outputs="full", device=cuda, **kw)


def test_cuda_segmented_ensemble_is_the_straight_one_without_a_capture(cuda):
    """A segmented cuda ensemble is bitwise the straight one, replays the
    straight run's captured round (no new slot, no new graph) and
    launches whole_round once per round it replays: no warm-up round."""
    from repro_torch.api import cache_stats
    from repro_torch.api import plan as plan_mod

    plan_mod.clear_cache()
    try:
        plan = _durable_experiment(cuda).plan()
        want = plan.ensemble(3, base_key=4)
        st = cache_stats()
        assert st["graphs_captured"] == 1
        before = whole_round.launches
        got = plan.ensemble_segmented(3, base_key=4, segment_steps=10)
        assert whole_round.launches - before == 37
        assert cache_stats() == st
        assert all(t.is_cuda for t in got)
        _equal_trees(got, want, "segmented vs straight on cuda")
    finally:
        plan_mod.clear_cache()


def test_cuda_store_roundtrip_returns_cuda_tensors(cuda, tmp_path):
    """A store-warm sweep on cuda returns cuda tensors bitwise the cold
    run's, running no round; the CPU's key is another key."""
    from repro_torch.api import ResultStore
    from repro_torch.sweep import Scenario

    exp = _durable_experiment(cuda)
    scen = [Scenario("a", exp.protocol, exp.failures)]
    store = ResultStore(tmp_path / "store")
    cold = exp.plan().sweep_stacked(scen, seeds=2, store=store)
    before = whole_round.launches
    warm = exp.plan().sweep_stacked(scen, seeds=2, store=store)
    assert store.hits == 1 and whole_round.launches == before
    assert all(t.is_cuda for t in warm)
    _equal_trees(warm, cold, "store round trip on cuda")
    cpu = _durable_experiment("cpu").plan()
    cpu_group = cpu._group(scen, 2, 0)
    cuda_group = exp.plan()._group(scen, 2, 0)
    assert store.sweep_key(cpu_group["sig"], exp.graph, cpu_group["configs"], 2,
                           torch.tensor([0, 0])) != \
        store.sweep_key(cuda_group["sig"], exp.graph, cuda_group["configs"], 2,
                        torch.tensor([0, 0]))


def test_cuda_service_worker_captures_while_the_caller_launches(cuda):
    """The service's worker thread captures a new slot while the calling
    thread keeps launching CUDA work and synchronising on it (a matmul,
    a round kernel, ``.item()``): under CUDA's ``thread_local`` capture
    mode neither breaks the other, and the rows are bitwise a private
    sweep."""
    import dataclasses

    from repro_torch.api import ExperimentService
    from repro_torch.api import plan as plan_mod
    from repro_torch.core import simulator as sim
    from repro_torch.sweep import Scenario

    capturing = {"now": False, "seen": 0}
    real = sim.Captured

    class Watched(real):
        def __init__(self, *a, **kw):
            capturing["now"] = True
            try:
                super().__init__(*a, **kw)
            finally:
                capturing["now"] = False

    plan_mod.clear_cache()
    sim.Captured = Watched
    try:
        exp = _durable_experiment(cuda, steps=29)
        scen = [Scenario(f"e{e}", dataclasses.replace(exp.protocol, eps=e), exp.failures)
                for e in (1.8, 2.4)]
        svc = ExperimentService(exp, store=None, autostart=True, linger=0.0)
        fut = svc.submit(scen, seeds=3)
        x = _observation(np.random.default_rng(1), 2, 19, 16, 64, 16, 70, cuda)
        a = torch.randn(512, 512, device=cuda)
        while not fut.done():
            b = a @ a
            theta_sums(x[0], x[1], x[2], x[8])
            assert torch.isfinite(b.sum()).item()
            capturing["seen"] += capturing["now"]
        got = fut.result(timeout=120)
        svc.close()
        assert capturing["seen"] > 0, "no caller work ran during the worker's capture"
        want = exp.plan().sweep(scen, seeds=3)
        for name in ("e1.8", "e2.4"):
            _equal_trees(got[name], want[name], f"service row {name}")
    finally:
        sim.Captured = real
        plan_mod.clear_cache()


def test_cuda_two_threads_share_a_cached_runner(cuda):
    """Two threads run one cached runner at once with different keys: its
    lock serialises the runs, so each result is bitwise its own run's."""
    import threading

    from repro_torch.api import cache_stats
    from repro_torch.api import plan as plan_mod

    plan_mod.clear_cache()
    try:
        plan = _durable_experiment(cuda).plan()
        want = {k: plan.ensemble(3, base_key=k) for k in (1, 2)}
        assert cache_stats()["entries"] == 1
        got, errors = {}, []
        start = threading.Barrier(2)

        def worker(k):
            try:
                start.wait()
                got[k] = [plan.ensemble(3, base_key=k) for _ in range(3)]
            except BaseException as exc:  # noqa: BLE001 - recorded for the assert
                errors.append(exc)

        threads = [threading.Thread(target=worker, args=(k,)) for k in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not errors, errors
        for k in (1, 2):
            for i, rec in enumerate(got[k]):
                _equal_trees(rec, want[k], f"thread {k} run {i}")
        assert cache_stats()["entries"] == 1
    finally:
        plan_mod.clear_cache()


def _sharded_case(n, degree, seed, rounds):
    """A regular graph's starting step state with random topology masks
    (about 15 % of nodes and 20 % of links down, links symmetric), and the
    one-shard run of ``rounds`` rounds on the CPU (DecAFork+, decisions
    from round 50)."""
    from repro_torch.core.distributed import (ShardedGraph, init_sharded_state,
                                              make_sharded_step, run_sharded)
    from repro_torch.core.protocol import ProtocolConfig
    from repro_torch.graphs.state import mirror_indices
    from repro_torch.utils import prng

    g = make_graph("regular", n, seed=seed, degree=degree)
    rng = np.random.default_rng(seed)
    edge = rng.random(g.neighbors.shape) > 0.2
    i, k = np.nonzero(g.neighbors > np.arange(n)[:, None])
    edge[g.neighbors[i, k], mirror_indices(g)[i, k]] = edge[i, k]
    graph = ShardedGraph(torch.as_tensor(g.neighbors), torch.as_tensor(g.degrees),
                         torch.as_tensor(rng.random(n) > 0.15), torch.as_tensor(edge))
    pcfg = ProtocolConfig(algorithm="decafork+", z0=16, max_walks=64, eps=4.0, eps2=11.0,
                          rt_bins=512, protocol_start=50)
    state = init_sharded_state(n, pcfg, prng.key(seed))
    cpu, z = run_sharded(make_sharded_step(None, ("data",), n, pcfg),
                         type(state)(*(x.clone() for x in state)), graph, rounds)
    return state, graph, pcfg, cpu, z


def _same_state(got, want_state, want_z):
    assert torch.equal(got["z"], want_z)
    for f in want_state._fields:
        assert torch.equal(getattr(got["state"], f), getattr(want_state, f)), f


def test_cuda_sharded_step_nccl_world_1_is_the_cpu_step(cuda):
    """The node-sharded step over NCCL at world size 1 on the card: 200
    rounds bitwise the one-shard step on the CPU (integers, and the
    float32 counts of ``hist`` / ``total``)."""
    from repro_torch.launch.sharded import spawn_run

    state, graph, pcfg, cpu, z = _sharded_case(1024, 8, 3, 200)
    got = spawn_run(state, graph, pcfg, 200, world=1, device="cuda", backend="nccl")
    _same_state(got, cpu, z)
    assert z.min() != z.max()  # decisions happened


def test_cuda_sharded_step_gloo_world_2_is_world_1(cuda):
    """Two ranks on the one card over gloo (NCCL refuses two ranks on one
    device) with CUDA tensors: bitwise the NCCL world-size-1 run."""
    from repro_torch.launch.sharded import spawn_run

    state, graph, pcfg, _, _ = _sharded_case(1024, 8, 4, 200)
    one = spawn_run(state, graph, pcfg, 200, world=1, device="cuda", backend="nccl")
    two = spawn_run(state, graph, pcfg, 200, world=2, device="cuda", backend="gloo")
    _same_state(two, one["state"], one["z"])
