"""Divisibility-aware sharding policy (the port of
``repro.launch.sharding``).

One declarative rule table maps parameter names to partition-spec
templates; every templated dimension is checked for divisibility against
the mesh and falls back to replication when it doesn't divide (hymba's 25
heads, mamba2's 50280 vocab, ...). Parameters under the stacked
``layers/`` prefix (``Model.params_tree``'s (L, ...) layer leaves) get a
leading unsharded layer dimension automatically.

A spec is a plain tuple with one entry per leading tensor dimension, equal
entry by entry to the reference's ``PartitionSpec``: ``None`` (not
sharded), an axis name, or a tuple of axis names (sharded over their
product, major first); ``()`` replicates. ``placements`` turns one into
the DTensor ``Shard`` / ``Replicate`` list of a ``DeviceMesh``, the
counterpart of the reference's ``NamedSharding``. Meshes are
``launch/mesh.py``'s ``DeviceMesh``es, read through ``axis_sizes``; every
function here also takes a plain ``{axis: size}`` mapping, since specs
need only the sizes. The reference's ``with_shardings`` (shardings
attached to abstract arrays for AOT lowering) has no counterpart: the
port lowers nothing ahead of time.

Conventions (MaxText-style):
  vocab, heads, d_ff, experts  -> 'model'
  batch                        -> ('pod','data')   [replicated if B=1]
  sequence                     -> unsharded, except the decode KV ring of
                                  batch-1 long-context, which shards its
                                  window over the data axes instead.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

from repro_torch.launch.mesh import axis_sizes

M = "model"

# name -> {ndim: spec template}
PARAM_RULES: Dict[str, Dict[int, tuple]] = {
    "embed": {2: (M, None), 3: (None, M, None)},
    "unembed": {2: (None, M), 3: (None, None, M)},
    "vision_proj": {2: (None, M)},
    # attention
    "wq": {3: (None, M, None)},
    "wk": {3: (None, M, None)},
    "wv": {3: (None, M, None)},
    "wo": {3: (M, None, None)},
    # MLA
    "wdq": {2: (None, M)},
    "wuq": {3: (None, M, None)},
    "wdkv": {2: (None, None)},
    "wkr": {2: (None, None)},
    "wuk": {3: (None, M, None)},
    "wuv": {3: (None, M, None)},
    # swiglu (2-D) and moe experts (3-D, expert-parallel)
    "gate": {2: (None, M), 3: (M, None, None)},
    "up": {2: (None, M), 3: (M, None, None)},
    "down": {2: (M, None), 3: (M, None, None)},
    "router": {2: (None, None)},
    # ssm
    "in_proj": {2: (None, M)},
    "conv_w": {2: (None, M)},
    "out_proj": {2: (M, None)},
}


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or a ``{axis: size}`` mapping."""
    return dict(mesh) if isinstance(mesh, Mapping) else axis_sizes(mesh)


def data_axes(mesh) -> tuple:
    """Axes that shard the batch: ('pod','data') on multi-pod meshes."""
    return tuple(a for a in mesh_sizes(mesh) if a in ("pod", "data"))


def axes_of(entry) -> tuple:
    """The axis names of one spec entry (``None``, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_factor(entry, sizes: Mapping[str, int]) -> int:
    """How many pieces one spec entry cuts its dimension into."""
    out = 1
    for a in axes_of(entry):
        out *= sizes[a]
    return out


def _check_divisible(spec: tuple, shape: tuple, mesh) -> tuple:
    sizes = mesh_sizes(mesh)
    fixed = []
    for dim, ax in enumerate(spec):
        if ax is None:
            fixed.append(None)
            continue
        size = shard_factor(ax, sizes)
        fixed.append(ax if shape[dim] % size == 0 and shape[dim] >= size else None)
    return tuple(fixed)


def spec_for_param(path: str, shape: tuple, mesh) -> tuple:
    name = path.split("/")[-1]
    rule = PARAM_RULES.get(name)
    in_stack = "/layers/" in f"/{path}/"
    nd = len(shape) - (1 if in_stack else 0)
    if rule is None or nd not in rule:
        return ()  # replicate (norm scales, small vectors, A_log, ...)
    template = rule[nd]
    if in_stack:
        template = (None,) + tuple(template)
    return _check_divisible(tuple(template), shape, mesh)


def _add_fsdp(spec: tuple, path: str, shape: tuple, mesh) -> tuple:
    """ZeRO/FSDP extension: additionally shard the largest
    still-replicated dim of every >=2-D parameter over the data axes, so
    parameter / optimizer state divides by the full rank count instead
    of the model axis alone (per-layer weight all-gathers and gradient
    reduce-scatters, ``roofline.collective_bytes_from_placements``)."""
    dp = data_axes(mesh)
    size = shard_factor(dp, mesh_sizes(mesh))
    nd = len(shape)
    full = tuple(spec) + (None,) * (nd - len(tuple(spec)))
    in_stack = "/layers/" in f"/{path}/"
    start = 1 if in_stack else 0
    if nd - start < 2:
        return full  # skip 1-D (norms, biases): negligible bytes
    best = None
    for i in range(start, nd):
        if full[i] is None and shape[i] % size == 0 and shape[i] >= size:
            if best is None or shape[i] > shape[best]:
                best = i
    if best is None:
        return full
    new = list(full)
    new[best] = dp if len(dp) > 1 else dp[0]
    return tuple(new)


def map_with_paths(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree's leaves (anything with a ``shape``:
    tensors, ``model.TensorSpec``s), keeping its structure (dicts,
    NamedTuples such as ``OptState``, tuples); paths '/'-joined as the
    reference's ``tree_flatten_with_paths`` writes them."""
    def sub(name):
        return f"{path}/{name}" if path else str(name)

    if hasattr(tree, "shape"):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, sub(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[map_with_paths(fn, v, sub(n)) for n, v in zip(tree._fields, tree)])
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_paths(fn, v, sub(i)) for i, v in enumerate(tree))
    return tree


def leaves_with_paths(tree) -> list:
    """``[(path, leaf)]`` of a tree's leaves, as :func:`map_with_paths`
    visits them."""
    out = []
    map_with_paths(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def spec_at(specs, path: str) -> tuple:
    """The spec at ``path`` of a tree of specs (as :func:`map_with_paths`
    builds them)."""
    for k in path.split("/") if path else ():
        if hasattr(specs, "_fields"):
            specs = getattr(specs, k)
        elif isinstance(specs, dict):
            specs = specs[k]
        else:
            specs = specs[int(k)]
    return specs


def params_shardings(param_shapes: Any, mesh, fsdp: bool = False) -> Any:
    """The spec of every leaf of a ``Model.params_tree`` (tensors of any
    device, meta included, or anything with a ``shape``)."""
    def one(path, leaf):
        spec = spec_for_param(path, tuple(leaf.shape), mesh)
        return _add_fsdp(spec, path, tuple(leaf.shape), mesh) if fsdp else spec

    return map_with_paths(one, param_shapes)


def opt_shardings(opt_shapes: Any, mesh, params_sh: Any = None, fsdp: bool = False) -> Any:
    """Moments mirror parameter shardings; scalars (the step) replicate."""

    def one(path, leaf):
        if len(leaf.shape) == 0:
            return ()
        # path like 'mu/<param path>' or 'nu/...'
        sub = path.split("/", 1)[1] if "/" in path else path
        spec = spec_for_param(sub, tuple(leaf.shape), mesh)
        return _add_fsdp(spec, sub, tuple(leaf.shape), mesh) if fsdp else spec

    return map_with_paths(one, opt_shapes)


def batch_shardings(batch_spec_tree: Any, mesh) -> Any:
    """Shard the leading batch dim over (pod, data) where divisible."""
    dp = data_axes(mesh)
    size = shard_factor(dp, mesh_sizes(mesh))

    def one(_path, leaf):
        shape = tuple(leaf.shape)
        if len(shape) >= 1 and shape[0] % size == 0 and shape[0] >= size:
            return (dp,) + (None,) * (len(shape) - 1)
        return ()

    return map_with_paths(one, batch_spec_tree)


def cache_shardings(cache_shapes: Any, mesh, cfg=None) -> Any:
    """Decode-cache shardings.

    Layer-stacked leaves are (L, B, ...). Batch shards over (pod,data)
    when divisible; for batch-1 long-context the KV ring/time dimension
    shards over the data axes instead; KV heads / compressed dims shard
    over 'model' when divisible.
    """
    sizes = mesh_sizes(mesh)
    dp = data_axes(mesh)
    dsize = shard_factor(dp, sizes)
    msize = sizes[M]

    def one(path: str, leaf):
        name = path.split("/")[-1]
        shp = tuple(leaf.shape)
        if name in ("k", "v"):  # (L, B, T, KV, hd)
            kv_ax = M if shp[3] % msize == 0 else None
            if shp[1] % dsize == 0:
                return (None, dp, None, kv_ax, None)
            t_ax = dp if shp[2] % dsize == 0 else None
            return (None, None, t_ax, kv_ax, None)
        if name in ("ckv", "krope"):  # (L, B, T, r)
            if shp[1] % dsize == 0:
                return (None, dp, None, None)
            t_ax = dp if shp[2] % dsize == 0 else None
            return (None, None, t_ax, None)
        if name == "state":  # (L, B, H, P, N)
            b_ok = shp[1] % dsize == 0
            h_ax = M if shp[2] % msize == 0 else None
            return (None, dp if b_ok else None, h_ax, None, None)
        if name == "conv":  # (L, B, K-1, conv_dim)
            b_ok = shp[1] % dsize == 0
            c_ax = M if shp[3] % msize == 0 else None
            return (None, dp if b_ok else None, None, c_ax)
        if name == "cache_positions":  # (B, T)
            if shp[0] % dsize == 0:
                return (dp, None)
            t_ax = dp if shp[1] % dsize == 0 else None
            return (None, t_ax)
        if name == "next_pos":  # (B,)
            return (dp if shp[0] % dsize == 0 else None,)
        return ()

    return map_with_paths(one, cache_shapes)


def local_shape(spec: tuple, shape: tuple, mesh) -> tuple:
    """The shape one rank holds of a tensor of ``shape`` placed by
    ``spec`` (each sharded dimension divided by its axes' product)."""
    sizes = mesh_sizes(mesh)
    out = list(shape)
    for dim, entry in enumerate(spec):
        out[dim] //= shard_factor(entry, sizes)
    return tuple(out)


def placements(spec: tuple, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``),
    one per mesh dimension: ``Shard(d)`` where the spec shards tensor
    dimension d over that mesh axis, else ``Replicate()``. A dimension
    sharded over several axes splits over them in mesh order (major
    first), as the reference's tuple entries do."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, entry in enumerate(spec) if name in axes_of(entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out
