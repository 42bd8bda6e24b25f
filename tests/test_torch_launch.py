"""The port's planning layer against the JAX package on the CPU:
``configs/shapes.py``, ``launch/sharding.py`` (every spec of every
architecture's parameters, AdamW moments, batches and decode caches, on
the production meshes (16, 16) and (2, 16, 16), FSDP on and off),
``launch/roofline.py`` (the analytic FLOPs and active parameters; the
H100's constants) and ``launch/dryrun.py`` on the meta device under the
fake process group.

The reference's specs are computed on ``repro.utils.compat.abstract_mesh``
meshes (sharding needs only axis sizes), the port's on ``{axis: size}``
mappings; a spec matches when ``PartitionSpec(*port_spec)`` equals the
reference's. The fake process group is process-wide state, so the
DTensor placements and the dry run (``--all`` at one layer of every
architecture: depth repeats the same layer code, and the whole depth
takes minutes here; and ``--protocol``) run in one subprocess, started
before the first test.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.model import batch_spec as jbatch_spec  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.utils.compat import abstract_mesh  # noqa: E402
from repro.utils.tree import tree_flatten_with_paths  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.launch import roofline, sharding  # noqa: E402
from repro_torch.launch.dryrun import meta_params  # noqa: E402
from repro_torch.models.model import Model, batch_spec  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
MESHES = {"pod256": ((16, 16), ("data", "model")),
          "pod512": ((2, 16, 16), ("pod", "data", "model"))}

PROBE = r"""
import json, math, sys
import torch, torch.distributed as dist
from torch.distributed.tensor import distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, sharding as shd
from repro_torch.launch.mesh import make_production_mesh

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
mesh = make_production_mesh(device_type="cpu")
out = {"local": {}}
for arch in ("yi_6b", "dbrx_132b", "hymba_1_5b"):
    params = dryrun.meta_params(get_config(arch, num_layers=2))
    specs = shd.params_shardings(params, mesh, fsdp=arch == "dbrx_132b")
    nbytes = 0
    for path, leaf in shd.leaves_with_paths(params):
        spec = shd.spec_at(specs, path)
        dt = distribute_tensor(leaf, mesh, shd.placements(spec, mesh))
        local = tuple(dt.to_local().shape)
        assert dt.to_local().device.type == "meta" and tuple(dt.shape) == tuple(leaf.shape)
        assert local == shd.local_shape(spec, tuple(leaf.shape), mesh), (path, local, spec)
        nbytes += math.prod(local) * leaf.element_size()
    out["local"][arch] = [nbytes, dryrun.rank_bytes(params, specs, mesh)]
print(json.dumps(out), flush=True)
out_dir = sys.argv[1]
dryrun.main(["--all", "--set", "num_layers=1", "--out", out_dir])
dryrun.main(["--protocol", "--out", out_dir])
dryrun.main(["--arch", "dbrx-132b", "--shape", "train_4k", "--multi-pod", "--fsdp",
             "--microbatches", "4", "--set", "num_layers=1", "--set", "_bf16_moments=True",
             "--tag", "_fsdp", "--out", out_dir])
"""


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


@pytest.fixture(scope="module", autouse=True)
def probe(tmp_path_factory):
    """The subprocess: DTensor local shapes, then the dry run."""
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable, "-c", PROBE, str(out)], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    result = {}

    def wait():
        if not result:
            stdout, stderr = proc.communicate(timeout=240)
            result.update(rc=proc.returncode, stdout=stdout, stderr=stderr, out=out)
        return result

    yield wait
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _ref_mesh(name):
    return abstract_mesh(*MESHES[name])


def _port_mesh(name):
    return dict(zip(MESHES[name][1], MESHES[name][0]))


def _same_specs(port_tree, port_specs, ref_specs, what):
    """Every leaf's spec equals the reference's at the same path."""
    ref = {p: s.spec for p, s in tree_flatten_with_paths(ref_specs)}
    got = {p: sharding.spec_at(port_specs, p) for p, _ in sharding.leaves_with_paths(port_tree)}
    assert set(got) == set(ref), what
    for p, spec in got.items():
        assert P(*spec) == ref[p], (what, p, spec, ref[p])


@pytest.fixture(scope="module")
def ref_params():
    """The reference's parameter shapes of every architecture."""
    return {a: jax.eval_shape(JModel(jget_config(a)).init, jax.random.key(0)) for a in ARCH_IDS}


def test_shapes_and_adjust_config_match_reference():
    """``SHAPES``, the window, and ``adjust_config`` for every arch x shape
    (the sliding-window ring for ``long_500k``, remat for training)."""
    assert shapes.LONG_CONTEXT_WINDOW == jshapes.LONG_CONTEXT_WINDOW
    assert list(shapes.SHAPES) == list(jshapes.SHAPES)
    for name, s in shapes.SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(jshapes.SHAPES[name])
        for arch in ARCH_IDS:
            got = shapes.adjust_config(get_config(arch), s)
            want = jshapes.adjust_config(jget_config(arch), jshapes.SHAPES[name])
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (arch, name)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_param_and_opt_specs_match_reference(ref_params, mesh, fsdp):
    """``params_shardings`` and ``opt_shardings`` (AdamW's step and
    moments) of every architecture's parameters."""
    for arch in ARCH_IDS:
        p_shapes = ref_params[arch]
        params = meta_params(get_config(arch))
        rsh = jsharding.params_shardings(p_shapes, _ref_mesh(mesh), fsdp=fsdp)
        psh = sharding.params_shardings(params, _port_mesh(mesh), fsdp=fsdp)
        _same_specs(params, psh, rsh, f"{arch} params")
        o_shapes = jax.eval_shape(jadamw(1e-4).init, p_shapes)
        state = adamw(1e-4).init(params)
        _same_specs(state, sharding.opt_shardings(state, _port_mesh(mesh), psh, fsdp=fsdp),
                    jsharding.opt_shardings(o_shapes, _ref_mesh(mesh), rsh, fsdp=fsdp),
                    f"{arch} opt")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_cache_specs_match_reference(mesh):
    """``batch_shardings`` of every arch x shape's batch, and
    ``cache_shardings`` of the decode shapes' caches (batch 128, and the
    batch-1 long context whose ring shards its window instead)."""
    for arch in ARCH_IDS:
        for name, s in shapes.SHAPES.items():
            cfg = shapes.adjust_config(get_config(arch), s)
            jcfg = jshapes.adjust_config(jget_config(arch), jshapes.SHAPES[name])
            seq = s.seq_len if s.mode != "decode" else 1
            b = batch_spec(cfg, s.global_batch, seq, s.mode)
            _same_specs(b, sharding.batch_shardings(b, _port_mesh(mesh)),
                        jsharding.batch_shardings(jbatch_spec(jcfg, s.global_batch, seq, s.mode),
                                                  _ref_mesh(mesh)), f"{arch} {name} batch")
            if s.mode != "decode":
                continue
            cache = Model(cfg).init_cache(s.global_batch, s.seq_len, device="meta")
            jcache = jax.eval_shape(lambda: JModel(jcfg).init_cache(s.global_batch, s.seq_len))
            _same_specs(cache, sharding.cache_shardings(cache, _port_mesh(mesh), cfg),
                        jsharding.cache_shardings(jcache, _ref_mesh(mesh), jcfg),
                        f"{arch} {name} cache")


def test_roofline_counts_and_h100_constants():
    """``analytic_model_flops`` and ``active_param_count`` equal the
    reference's for every arch x shape; the peaks are the H100 SXM's,
    with no TPU constant left; ``analyze``'s terms divide by them."""
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        assert roofline.active_param_count(cfg) == jroofline.active_param_count(jcfg)
        for s in shapes.SHAPES.values():
            assert (roofline.analytic_model_flops(cfg, s.global_batch, s.seq_len, s.mode)
                    == jroofline.analytic_model_flops(jcfg, s.global_batch, s.seq_len, s.mode))
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 450e9)
    tpu = {jroofline.PEAK_FLOPS, jroofline.HBM_BW, jroofline.ICI_BW}
    assert not tpu & {v for v in vars(roofline).values() if isinstance(v, float)}
    rep = roofline.analyze({"flops": 989e12, "bytes accessed": 3.35e12 * 2},
                           coll_total=450e9 * 3, n_chips=256, model_flops=989e12 * 256 * 0.5)
    assert (rep.compute_s, rep.memory_s, rep.collective_s) == (1.0, 2.0, 3.0)
    assert rep.bottleneck == "collective" and rep.useful_ratio == 0.5


def test_collective_bytes_from_placements_rule():
    """The rule of ``roofline``'s docstring on granite-8b's smoke config:
    data parallelism alone all-reduces every gradient (2x, per
    microbatch); FSDP gathers each data-sharded weight and
    reduce-scatters its gradient; tensor parallelism all-reduces the
    activations after each row-parallel product and the vocab-sharded
    lookup, and in training each column-parallel group's input gradient;
    a serving step on one data rank moves no gradient."""
    import dataclasses as dc

    from repro_torch.configs import get_smoke_config

    cfg = dc.replace(get_smoke_config("granite_8b"), dtype="bfloat16")
    params = meta_params(cfg)
    nbytes = sum(t.numel() * t.element_size() for _, t in sharding.leaves_with_paths(params))
    dp = {"data": 4, "model": 1}
    got = roofline.collective_bytes_from_placements(
        cfg, params, sharding.params_shardings(params, dp), dp, mode="train", batch=8, seq=16,
        microbatches=2)
    assert got["all-reduce"] == got["total"] == 2 * nbytes * 2
    specs = sharding.params_shardings(params, dp, fsdp=True)
    got = roofline.collective_bytes_from_placements(cfg, params, specs, dp, mode="train",
                                                    batch=8, seq=16)
    gathered = sum(t.numel() * t.element_size() for p, t in sharding.leaves_with_paths(params)
                   if any(e == "data" for e in sharding.spec_at(specs, p)))
    assert got["all-gather"] == gathered and got["reduce-scatter"] == gathered / 4
    assert got["all-reduce"] == 2 * (nbytes - gathered)
    tp = {"data": 1, "model": 4}
    L, act = cfg.num_layers, 8 * 16 * cfg.d_model * 2  # tokens x d_model, bf16
    got = roofline.collective_bytes_from_placements(
        cfg, params, sharding.params_shardings(params, tp), tp, mode="prefill", batch=8, seq=16)
    # 6 heads do not divide over 4: attention replicates, only down and embed split
    assert got["all-reduce"] == got["total"] == 2 * act * (L + 1)
    got = roofline.collective_bytes_from_placements(
        cfg, params, sharding.params_shardings(params, tp), tp, mode="train", batch=8, seq=16)
    assert got["all-reduce"] == 2 * act * ((L + 1) + L + 1)  # + gate / up's input; unembed


def test_placements_give_the_byte_counts_local_shapes(probe):
    """Under the fake process group at 256 ranks, a DTensor built from
    ``placements`` on a meta tensor holds, on a rank, the local shape
    ``local_shape`` computes (and the dry run's byte count assumes)."""
    res = probe()
    assert res["rc"] == 0, res["stderr"][-3000:]
    local = json.loads(res["stdout"].splitlines()[0])["local"]
    for arch, (summed, counted) in local.items():
        assert summed == counted > 0, arch


@pytest.mark.parametrize("shape", list(shapes.SHAPES))
def test_dryrun_all_writes_ok_records(probe, shape):
    """``dryrun --all`` on pod256 (one layer of each architecture): an
    ``ok`` record for every architecture, with per-rank bytes, FLOPs,
    collective bytes and H100 roofline terms."""
    res = probe()
    assert res["rc"] == 0, res["stderr"][-3000:]
    for arch in ARCH_IDS:
        rec = json.load(open(res["out"] / f"{arch}__{shape}__pod256.json"))
        assert rec["ok"], rec.get("error")
        assert rec["memory"]["params_bytes"] > 0 and rec["cost_full"]["flops"] > 0
        assert 1.0 <= rec["model_split"] <= 16.0  # the model axis splits weights <= 16 ways
        rl = rec["roofline"]
        assert rl["compute_s"] == rl["flops"] / 989e12
        assert rl["collective_s"] == rl["coll_bytes"] / 450e9
        assert rl["bottleneck"] in ("compute", "memory", "collective")
        if shapes.SHAPES[shape].mode == "train":  # float32 moments of bf16 (or f32) weights
            assert rec["memory"]["opt_bytes"] >= 2 * rec["memory"]["params_bytes"] + 4


def test_dryrun_protocol_record(probe):
    """``dryrun --protocol``: the node-sharded step at n 131,072 on
    pod256, its node tables split over the 16 data ranks, and its two
    int32 all-reduces of 2 x W a round counted from the dispatcher."""
    res = probe()
    assert res["rc"] == 0, res["stderr"][-3000:]
    rec = json.load(open(res["out"] / "protocol_decafork__pod256.json"))
    assert rec["ok"], rec.get("error")
    n_local, W, bins, D = 131072 // 16, 64, 512, 16
    node = n_local * (W * 4 + bins * 4 + 4 + D * 4 + 4 + D)
    rep = 4 + W * 4 + W + W * 4 + 8 * 2 + 131072
    assert rec["memory"]["argument_bytes"] == node + rep
    # the proposals (W int32) and the decisions (2W int32), over one group
    assert rec["coll_full"]["all-reduce"] == rec["coll_full"]["total"] == 2 * (4 * W + 8 * W)


def test_dryrun_multi_pod_fsdp_record(probe):
    """The flags of a planning run: pod512, FSDP, 4 microbatches and
    bfloat16 moments (``--set _bf16_moments=True``) on dbrx-132b: the
    record keeps them, the moments take the bytes of the bf16 weights
    twice (and of the float32 router once: its bf16 moments are half its
    size), and each FSDP weight gather is 32 (the data ranks) of its
    gradient's reduce-scattered shards."""
    res = probe()
    assert res["rc"] == 0, res["stderr"][-3000:]
    rec = json.load(open(res["out"] / "dbrx_132b__train_4k__pod512_fsdp.json"))
    assert rec["ok"], rec.get("error")
    assert (rec["mesh"], rec["fsdp"], rec["microbatches"]) == ("pod512", True, 4)
    assert rec["overrides"] == {"num_layers": 1, "_bf16_moments": True}
    mem = rec["memory"]
    router = 6144 * 16 * 4 // 32  # (d, E) float32 over the 32 data ranks (FSDP)
    assert mem["opt_bytes"] == 2 * (mem["params_bytes"] - router) + router + 4
    coll = rec["coll_full"]
    # a weight gathered over the 32 data ranks is 32 of its gradient's shards
    assert coll["reduce-scatter"] > 0 and coll["all-gather"] == 32 * coll["reduce-scatter"]
