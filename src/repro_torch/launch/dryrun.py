"""Multi-pod dry run on the meta device: every (arch x input shape x mesh)
of the production meshes, planned against the H100's peaks (the port of
``repro.launch.dryrun``).

For each combination, with no device memory (every tensor lives on
torch's ``meta`` device) and one process standing for every rank
(torch's fake process group, ``torch.testing._internal.distributed.
fake_pg``, at 256 or 512 ranks, the ``launch/mesh.py`` production mesh):

  - the placement of every tensor (``launch/sharding.py``'s specs, as
    DTensor placements on the mesh): each rank's bytes of parameters,
    optimizer state, batch and decode cache, read from the local shapes
    of DTensors built on meta tensors (and held to the specs' own
    arithmetic);
  - the FLOPs of one train / prefill / decode step by
    ``torch.utils.flop_counter.FlopCounterMode`` over the step run on
    meta tensors, and the bytes its operators read and write. A rank runs
    the step on its share of the batch (the batch spec's data-axis split)
    and its share of the products that the model axis splits: the step is
    run at that local batch and its counts divided by ``model_split``,
    the parameters' count over their per-rank count along the model axis
    (16 where every weight splits over a 16-way axis, less where some
    replicate, as mamba2-1.3b's vocabulary does);
  - per-rank collective bytes from the placements
    (``roofline.collective_bytes_from_placements``), and the roofline.

Two differences from the reference, which AOT-compiles each step with
XLA: the Python layer loop runs every layer, so the counts need no
single-block correction (the reference lowers one block apart because
XLA counts a scanned body once); and a meta run has no compiler's
buffer plan, so the reference's ``temp_bytes`` (XLA's temporaries) has
no counterpart and is not reported.

Results are written as JSON under ``dryrun_out/`` (ignored by git).

Usage (CPU only; nothing is allocated):
  python -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--force]
  python -m repro_torch.launch.dryrun --protocol           # paper-technique step
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, canonical, get_config
from repro_torch.configs.shapes import SHAPES, adjust_config
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import (
    analytic_model_flops,
    analyze,
    collective_bytes_from_placements,
)
from repro_torch.launch.train import make_train_step
from repro_torch.models.model import Model, batch_spec
from repro_torch.models.transformer import param_shapes
from repro_torch.optim import adamw

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "dryrun_out")
META = torch.device("meta")


# ---------------------------------------------------------------------------
# The mesh under the fake process group
# ---------------------------------------------------------------------------


def production_mesh(multi_pod: bool):
    """The production mesh (256 or 512 ranks) under torch's fake process
    group, started here (and restarted at the other size) unless a group
    of that size is running."""
    world = 512 if multi_pod else 256
    if dist.is_initialized() and dist.get_world_size() != world:
        dist.destroy_process_group()
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def rank_bytes(tree, specs, mesh) -> int:
    """One rank's bytes of ``tree`` (meta tensors) placed by ``specs``:
    each leaf as a DTensor on ``mesh`` from ``sharding.placements``, its
    local shape held to ``sharding.local_shape``."""
    from torch.distributed.tensor import distribute_tensor

    total = 0
    for path, leaf in shd.leaves_with_paths(tree):
        spec = shd.spec_at(specs, path)
        if not isinstance(leaf, torch.Tensor):  # a TensorSpec
            leaf = torch.empty(leaf.shape, dtype=leaf.dtype, device=META)
        local = tuple(distribute_tensor(leaf, mesh, shd.placements(spec, mesh)).to_local().shape)
        want = shd.local_shape(spec, tuple(leaf.shape), mesh)
        if local != want:
            raise AssertionError(f"{path}: the DTensor holds {local} a rank, the spec {want}")
        total += math.prod(local) * leaf.element_size()
    return total


# ---------------------------------------------------------------------------
# Counting one step on meta tensors
# ---------------------------------------------------------------------------


class OpBytes(TorchDispatchMode):
    """Bytes every operator reads and writes (its tensor arguments and
    results; views and allocations move nothing), and the result bytes
    of each ``c10d`` collective by kind."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.collectives: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.name()
        if name.startswith("c10d::"):  # the result's bytes, as the reference counts them
            kind = name.split("::")[1].split(".")[0]
            self.collectives[kind] = self.collectives.get(kind, 0) + _nbytes(out)
        elif not (func.is_view or "empty" in name or "view" in name or name == "aten::detach"):
            self.bytes += _nbytes((args, kwargs, out))
        return out


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in pytree_leaves(tree)
               if isinstance(t, torch.Tensor))


def count_step(fn, *args):
    """(FLOPs, operator bytes, collective bytes by kind) of ``fn(*args)``."""
    with FlopCounterMode(display=False) as flops, OpBytes() as moved:
        fn(*args)
    return flops.get_total_flops(), moved.bytes, moved.collectives


def meta_params(cfg):
    """A ``Model.params_tree`` of meta tensors: the leaves
    ``transformer.param_shapes`` lists, layer leaves stacked (L, ...)."""
    tree: dict = {}
    for name, (shape, dtype) in param_shapes(cfg).items():
        parts = name.split(".")
        if parts[0] == "layers":
            if parts[1] != "0":
                continue
            parts, shape = ["layers"] + parts[2:], (cfg.num_layers,) + shape
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.empty(shape, dtype=dtype, device=META)
    return tree


def model_split(params, specs, mesh) -> float:
    """How far the model axis splits the parameters: their count over
    the count one rank holds when only the 'model' axis divides them."""
    sizes = shd.mesh_sizes(mesh)
    full = local = 0
    for path, leaf in shd.leaves_with_paths(params):
        spec = shd.spec_at(specs, path)
        model_only = tuple("model" if "model" in shd.axes_of(e) else None for e in spec)
        full += leaf.numel()
        local += math.prod(shd.local_shape(model_only, tuple(leaf.shape), sizes))
    return full / local


def _meta_batch(spec):
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=META) for k, s in spec.items()}


# ---------------------------------------------------------------------------
# Full-step plan
# ---------------------------------------------------------------------------


def build_full(
    arch: str,
    shape_name: str,
    mesh,
    microbatches: int = 1,
    fsdp: bool = False,
    overrides: dict | None = None,
):
    """The step's model, meta tensors, placements and a thunk running it
    at one rank's batch: a dict with ``cfg``, ``model``, ``params`` and
    ``param_specs``, ``trees`` (name -> (a tree, its specs) for
    ``params``, ``opt``, ``batch`` and ``cache``, what a rank holds),
    ``local_batch`` and ``run``."""
    shape = SHAPES[shape_name]
    cfg_overrides = {k: v for k, v in (overrides or {}).items() if not k.startswith("_")}
    cfg = adjust_config(get_config(arch, **cfg_overrides), shape)
    model = Model(cfg)
    sizes = shd.mesh_sizes(mesh)
    params = meta_params(cfg)
    p_sh = shd.params_shardings(params, mesh, fsdp=fsdp)
    trees = {"params": (params, p_sh)}
    dsize = shd.shard_factor(shd.data_axes(mesh), sizes)
    B = shape.global_batch
    local_b = B // dsize if B % dsize == 0 and B >= dsize else B

    if shape.mode == "train":
        moment_dtype = torch.bfloat16 if (overrides or {}).get("_bf16_moments") else torch.float32
        opt = adamw(1e-4, moment_dtype=moment_dtype)
        opt_state = opt.init(params)
        trees["opt"] = (opt_state, shd.opt_shardings(opt_state, mesh, p_sh, fsdp=fsdp))
        b_spec = batch_spec(cfg, B, shape.seq_len, "train")
        step = make_train_step(model, opt, microbatches=microbatches)
        local = _meta_batch(batch_spec(cfg, local_b, shape.seq_len, "train"))

        def run():
            step(params, opt_state, local)
    elif shape.mode == "prefill":
        b_spec = batch_spec(cfg, B, shape.seq_len, "prefill")
        module = Model.params_from_tree(params)
        local = _meta_batch(batch_spec(cfg, local_b, shape.seq_len, "prefill"))

        def run():
            model.prefill(module, local)
    else:  # decode
        cache = model.init_cache(B, shape.seq_len, device=META)
        trees["cache"] = (cache, shd.cache_shardings(cache, mesh, cfg))
        b_spec = batch_spec(cfg, B, 1, "decode")
        module = Model.params_from_tree(params)
        local_cache = model.init_cache(local_b, shape.seq_len, device=META)
        local = _meta_batch(batch_spec(cfg, local_b, 1, "decode"))

        def run():
            model.decode_step(module, local_cache, local)
    trees["batch"] = (b_spec, shd.batch_shardings(b_spec, mesh))
    return dict(cfg=cfg, model=model, params=params, param_specs=p_sh, trees=trees,
                local_batch=local_b, run=run)


# ---------------------------------------------------------------------------
# Protocol (paper technique) distributed step
# ---------------------------------------------------------------------------


def build_protocol(mesh, n_nodes: int = 131072, max_walks: int = 64, bins: int = 512):
    """The node-sharded protocol step at the reference's production size:
    (the step, its twelve arguments at one rank's shapes on meta, their
    global shapes and specs, the config)."""
    from repro_torch.core.distributed import make_sharded_step
    from repro_torch.core.protocol import ProtocolConfig

    pcfg = ProtocolConfig(
        algorithm="decafork+", z0=16, max_walks=max_walks, eps=4.0, eps2=11.0,
        rt_bins=bins,
    )
    axes = shd.data_axes(mesh)
    step = make_sharded_step(mesh, axes, n_nodes, pcfg)
    n_local = n_nodes // shd.shard_factor(axes, shd.mesh_sizes(mesh))
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    W, max_deg = max_walks, 16
    node = (axes,)  # node tables: rows over the data axes
    args = {  # name: (global shape, dtype, spec)
        "t": ((), i32, ()), "pos": ((W,), i32, ()), "active": ((W,), b8, ()),
        "track": ((W,), i32, ()), "last_seen": ((n_nodes, W), i32, node),
        "hist": ((n_nodes, bins), f32, node), "total": ((n_nodes,), f32, node),
        "key": ((2,), torch.int64, ()), "neighbors": ((n_nodes, max_deg), i32, node),
        "degrees": ((n_nodes,), i32, node), "node_up": ((n_nodes,), b8, ()),
        "edge_up": ((n_nodes, max_deg), b8, node),
    }
    local = [torch.zeros((n_local,) + s[1:] if spec else s, dtype=dt, device=META)
             for s, dt, spec in args.values()]
    tree = {k: torch.empty(s, dtype=dt, device=META) for k, (s, dt, _) in args.items()}
    specs = {k: spec for k, (_, _, spec) in args.items()}
    return step, local, (tree, specs), pcfg


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


def run_one(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    out_dir: str,
    force: bool = False,
    microbatches: int = 1,
    tag: str = "",
    fsdp: bool = False,
    overrides: dict | None = None,
):
    mesh_name = "pod512" if multi_pod else "pod256"
    slug = f"{canonical(arch)}__{shape_name}__{mesh_name}{tag}"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, slug + ".json")
    if os.path.exists(path) and not force:
        print(f"[skip] {slug} (exists)")
        with open(path) as f:
            return json.load(f)
    t0 = time.time()
    rec = {
        "arch": canonical(arch),
        "shape": shape_name,
        "mesh": mesh_name,
        "microbatches": microbatches,
        "fsdp": fsdp,
        "overrides": overrides or {},
        "ok": False,
    }
    try:
        mesh = production_mesh(multi_pod)
        sizes = shd.mesh_sizes(mesh)
        n_chips = math.prod(sizes.values())
        plan = build_full(arch, shape_name, mesh, microbatches, fsdp=fsdp, overrides=overrides)
        cfg = plan["cfg"]
        memory = {f"{k}_bytes": rank_bytes(t, s, mesh) for k, (t, s) in plan["trees"].items()}
        memory["total_bytes"] = sum(memory.values())
        rec["memory"] = memory
        flops, moved, _ = count_step(plan["run"])
        split = model_split(plan["params"], plan["param_specs"], mesh)
        rec["model_split"] = split
        rec["cost_full"] = {"flops": flops / split, "bytes accessed": moved / split}
        shape = SHAPES[shape_name]
        seq = shape.seq_len if shape.mode != "decode" else 1
        coll = collective_bytes_from_placements(
            cfg, plan["params"], plan["param_specs"], sizes, mode=shape.mode,
            batch=shape.global_batch, seq=seq, microbatches=microbatches)
        rec["coll_full"] = coll
        mf = analytic_model_flops(cfg, shape.global_batch, shape.seq_len, shape.mode)
        report = analyze(rec["cost_full"], coll["total"], n_chips, mf)
        rec["roofline"] = report.to_dict()
        rec["params"] = cfg.param_count()
        rec["local_batch"] = plan["local_batch"]
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record the failure, don't die
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["seconds"] = round(time.time() - t0, 1)
    with open(path, "w") as f:
        json.dump(rec, f, indent=2, default=float)
    status = "ok" if rec["ok"] else "FAIL"
    rl = rec.get("roofline", {})
    print(
        f"[{status}] {slug} {rec['seconds']}s "
        f"bottleneck={rl.get('bottleneck','-')} "
        f"mem={rec.get('memory',{}).get('total_bytes',0)/2**30:.1f}GiB"
    )
    return rec


def run_protocol(multi_pod: bool, out_dir: str, force: bool = False):
    mesh_name = "pod512" if multi_pod else "pod256"
    slug = f"protocol_decafork__{mesh_name}"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, slug + ".json")
    if os.path.exists(path) and not force:
        print(f"[skip] {slug}")
        with open(path) as f:
            return json.load(f)
    t0 = time.time()
    rec = {"arch": "protocol_decafork", "mesh": mesh_name, "ok": False}
    try:
        mesh = production_mesh(multi_pod)
        step, local, (tree, specs), _ = build_protocol(mesh)
        rec["memory"] = {"argument_bytes": rank_bytes(tree, specs, mesh)}
        rec["memory"]["total_bytes"] = rec["memory"]["argument_bytes"]
        flops, moved, coll = count_step(step, *local)
        rec["cost_full"] = {"flops": flops, "bytes accessed": moved}
        # the step's own collectives, as the dispatcher saw them (an
        # all-reduce twice, the reference's weight)
        kinds = {"allreduce_": "all-reduce", "allgather_": "all-gather",
                 "reduce_scatter_": "reduce-scatter", "alltoall_": "all-to-all"}
        rec["coll_full"] = {v: 0.0 for v in kinds.values()}
        for k, nbytes in coll.items():
            kind = kinds.get(k, k)
            rec["coll_full"][kind] = rec["coll_full"].get(kind, 0.0) + nbytes * (
                2.0 if kind == "all-reduce" else 1.0)
        rec["coll_full"]["total"] = sum(rec["coll_full"].values())
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["seconds"] = round(time.time() - t0, 1)
    with open(path, "w") as f:
        json.dump(rec, f, indent=2, default=float)
    print(f"[{'ok' if rec['ok'] else 'FAIL'}] {slug} {rec['seconds']}s")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--protocol", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--fsdp", action="store_true",
                    help="ZeRO-style param/opt sharding over the data axes")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="ModelConfig overrides, e.g. --set mla_absorb=True "
                         "(--set _bf16_moments=True: bfloat16 AdamW moments)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=os.path.abspath(OUT_DIR))
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        if v in ("True", "False"):
            overrides[k] = v == "True"
        else:
            try:
                overrides[k] = int(v)
            except ValueError:
                try:
                    overrides[k] = float(v)
                except ValueError:
                    overrides[k] = v

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    if args.protocol:
        for mp in meshes:
            run_protocol(mp, args.out, force=args.force)
        return

    combos = []
    if args.all:
        for a in ARCH_IDS:
            for s in SHAPES:
                combos.append((a, s))
    else:
        combos.append((args.arch, args.shape))

    n_fail = 0
    for a, s in combos:
        for mp in meshes:
            rec = run_one(
                a, s, mp, args.out,
                force=args.force,
                microbatches=args.microbatches,
                tag=args.tag,
                fsdp=args.fsdp,
                overrides=overrides,
            )
            n_fail += 0 if rec["ok"] else 1
    print(f"done; failures={n_fail}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
