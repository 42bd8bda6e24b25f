"""Roofline analysis of the dry run (the port of
``repro.launch.roofline``), against one NVIDIA H100 SXM's peaks.

Three terms per (arch x shape x mesh), all in seconds, per rank:

  compute    = FLOPs / 989e12          [bf16 dense tensor-core peak]
  memory     = HBM bytes / 3.35e12     [HBM3 bandwidth]
  collective = collective bytes / 450e9  [NVLink 4, one direction]

The peaks are the H100 SXM data sheet's: 989 TFLOP/s of dense bf16 on the
tensor cores and 3.35 TB/s of HBM3, the peaks ``chip_smoke.py``'s bounds
use; and 900 GB/s of NVLink 4 per GPU (18 links), counted as 450 GB/s in
each direction. A 256- or 512-rank mesh spans nodes of eight GPUs, whose
links between nodes (InfiniBand NDR, 400 Gb/s = 50 GB/s a GPU) are nine
times slower: the collective term is the NVLink bound, a lower bound
like the other two.

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` and
collective bytes from the compiled HLO, and corrects XLA's count of a
scanned layer body (counted once). The port has neither: the dry run
(``launch/dryrun.py``) counts FLOPs with ``torch.utils.flop_counter``
over the Python layer loop (every layer counted), bytes over its
operators, and collective bytes from the placements of its tensors:

``collective_bytes_from_placements`` counts, per rank, the result bytes
of each collective the specs imply (the reference's rule for parsed HLO:
the result size of every collective op, an all-reduce twice for its
reduce-scatter + all-gather ring):

  all-gather      every parameter sharded over a data axis (FSDP): its
                  gathered size (only its model-axis split left), once
                  per forward pass (train: per microbatch);
  reduce-scatter  train: the gradient of each such parameter, its local
                  shard's size, per microbatch;
  all-reduce      train: the gradient of every other parameter, 2x its
                  local size, per microbatch (when the data axes have
                  more than one rank); and tensor parallelism: 2x the
                  local activations (tokens x d_model in the model's
                  dtype) for each product whose weight shards its
                  contracted dimension over 'model' (the row-parallel
                  ``wo``, 2-D ``down``, ``out_proj``, and a vocab-sharded
                  ``embed``'s lookup) in every forward pass (twice with
                  remat), and in training for each group of products
                  that shards its output over 'model' and shares an
                  input (q / k / v; ``gate`` / ``up``; ``in_proj``; the
                  vocab-sharded ``unembed``): their input's gradient;
  all-to-all      expert-parallel MoE (experts sharded over 'model'):
                  the local tokens' top-k copies (tokens x k x d_model)
                  to their experts and back, per forward pass, and again
                  in the backward pass.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping

from repro_torch.launch.sharding import (
    axes_of,
    data_axes,
    leaves_with_paths,
    local_shape,
    shard_factor,
    spec_at,
)
from repro_torch.models.transformer import torch_dtype

# ---- NVIDIA H100 SXM constants (per GPU; data sheet) ------------------------
PEAK_FLOPS = 989e12  # bf16 dense, tensor cores
HBM_BW = 3.35e12  # bytes/s, HBM3
LINK_BW = 450e9  # bytes/s, NVLink 4 (900 GB/s both directions)

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


@dataclasses.dataclass
class RooflineReport:
    flops: float  # per-device
    hbm_bytes: float  # per-device
    coll_bytes: float  # per-device
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float  # analytic 6*N*D (global)
    useful_ratio: float  # model_flops / (flops * chips)

    def to_dict(self):
        return dataclasses.asdict(self)


def analyze(
    costs: dict,
    coll_total: float,
    n_chips: int,
    model_flops: float,
) -> RooflineReport:
    flops = float(costs.get("flops", 0.0))
    hbm = float(costs.get("bytes accessed", 0.0))
    compute_s = flops / PEAK_FLOPS
    memory_s = hbm / HBM_BW
    coll_s = coll_total / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    bottleneck = max(terms, key=terms.get)
    total_flops = flops * n_chips
    return RooflineReport(
        flops=flops,
        hbm_bytes=hbm,
        coll_bytes=coll_total,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=coll_s,
        bottleneck=bottleneck,
        model_flops=model_flops,
        useful_ratio=(model_flops / total_flops) if total_flops else 0.0,
    )


def analytic_model_flops(cfg, batch: int, seq: int, mode: str) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (forward), N = active params."""
    n_active = active_param_count(cfg)
    tokens = batch * seq if mode in ("train", "prefill") else batch * 1
    mult = 6.0 if mode == "train" else 2.0
    return mult * n_active * tokens


def active_param_count(cfg) -> int:
    """Active (per-token) parameter count: MoE counts top-k + shared only."""
    n = cfg.param_count()
    if cfg.arch_type != "moe":
        return n
    d, e, fe, L = cfg.d_model, cfg.moe_num_experts, cfg.moe_d_ff, cfg.num_layers
    all_routed = L * e * 3 * d * fe
    active_routed = L * cfg.moe_top_k * 3 * d * fe
    return n - all_routed + active_routed


# row-parallel products: a weight whose contracted (input) dimension is
# sharded over 'model' leaves a partial sum; name -> that dimension of the
# unstacked weight
_ROW_PARALLEL = {"wo": 0, "down": 0, "out_proj": 0}
# column-parallel products, which shard their output over 'model', by the
# input they share: name -> (group, the output dimension)
_COL_PARALLEL = {"wq": ("qkv", 1), "wk": ("qkv", 1), "wv": ("qkv", 1), "wuq": ("q", 1),
                 "wuk": ("kv", 1), "wuv": ("kv", 1), "gate": ("mlp", 1), "up": ("mlp", 1),
                 "in_proj": ("ssm", 1)}


def collective_bytes_from_placements(cfg, params, specs, sizes: Mapping[str, int], *,
                                     mode: str, batch: int, seq: int,
                                     microbatches: int = 1) -> Dict[str, float]:
    """Per-rank collective bytes by kind that the placements of one step
    imply (the rule in the module docstring). ``params``: the
    ``Model.params_tree`` (meta tensors will do), ``specs`` its
    ``sharding.params_shardings``, ``sizes`` the mesh's {axis: size};
    ``batch`` x ``seq`` the global tokens of the step (``seq`` 1 for a
    decode step). Returns the reference's dict: bytes per kind,
    ``total`` and ``ops`` (collectives issued)."""
    out = {k: 0.0 for k in _COLLECTIVES}
    ops = {k: 0 for k in _COLLECTIVES}

    def add(kind, nbytes, times):
        if nbytes and times:
            out[kind] += float(nbytes) * times
            ops[kind] += times

    dp = data_axes(sizes)
    dsize = shard_factor(dp, sizes)
    tp = sizes.get("model", 1) > 1
    train = mode == "train"
    passes = microbatches if train else 1  # weight gathers and gradient sums
    fwd = (2 if cfg.remat else 1) if train else 1  # forward passes (remat recomputes)
    b_local = batch // dsize if batch % dsize == 0 and batch >= dsize else batch
    elem = torch_dtype(cfg).itemsize
    act = b_local * seq * cfg.d_model * elem  # local activations
    col_groups = set()
    for path, leaf in leaves_with_paths(params):
        spec = spec_at(specs, path)
        shape = tuple(leaf.shape)
        size = leaf.element_size()
        local = math.prod(local_shape(spec, shape, sizes)) * size
        if dsize > 1 and any(a in dp for e in spec for a in axes_of(e)):
            model_only = tuple(tuple(a for a in axes_of(e) if a not in dp) or None for e in spec)
            add("all-gather", math.prod(local_shape(model_only, shape, sizes)) * size, passes)
            add("reduce-scatter", local, passes if train else 0)
        elif dsize > 1 and train:
            add("all-reduce", 2 * local, passes)
        parts = path.split("/")
        name, stacked = parts[-1], parts[0] == "layers"
        layers = shape[0] if stacked else 1
        dims = spec[1:] if stacked else spec
        nd = len(shape) - (1 if stacked else 0)

        def on_model(d):
            return tp and d < len(dims) and "model" in axes_of(dims[d])

        if name == "embed":  # (V, d), or (nq, V, d) with codebooks
            add("all-reduce", 2 * act, fwd if on_model(nd - 2) else 0)
        elif name == "unembed":  # (d, V), or (nq, d, V)
            add("all-reduce", 2 * act, 1 if train and on_model(nd - 1) else 0)
        elif "moe" in parts and nd == 3:
            if name == "gate" and on_model(0):  # a dispatch and a combine per layer
                moved = b_local * seq * cfg.moe_top_k * cfg.d_model * elem
                add("all-to-all", 2 * moved, layers * (fwd + (1 if train else 0)))
        elif name in _ROW_PARALLEL and on_model(_ROW_PARALLEL[name]):
            add("all-reduce", 2 * act, layers * fwd)
        elif name in _COL_PARALLEL and train and on_model(_COL_PARALLEL[name][1]):
            group = (path.rsplit("/", 1)[0], _COL_PARALLEL[name][0])
            if group not in col_groups:
                col_groups.add(group)
                add("all-reduce", 2 * act, layers)
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    out["ops"] = float(sum(ops.values()))
    return out
