"""Trees of tensors: the state, rows and caches a captured runner keeps
at fixed addresses (tensors inside NamedTuples, tuples and dicts; a
``None`` leaf holds nothing). The counterpart of the JAX package's
``utils/tree.py`` for what the port needs."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def tree_leaves(tree) -> list:
    """The tensors of ``tree``, depth first; a dict's in key order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in tree_leaves(v)]
    return []


def tree_clone(tree):
    """A copy of ``tree`` with every tensor cloned."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [tree_clone(v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return tree


def copy_into(static, values) -> None:
    """Copy the tensors of ``values`` into those of ``static``, a tree of
    the same structure, shapes and dtypes (a runner's fixed buffers);
    anything else raises."""
    dst, src = tree_leaves(static), tree_leaves(values)
    if len(dst) != len(src):
        raise ValueError("a run's inputs do not match the runner's static structure")
    for d, s in zip(dst, src):
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(
                f"a run's input {tuple(s.shape)} {s.dtype} does not match the runner's "
                f"static input {tuple(d.shape)} {d.dtype}: its signature missed a shape"
            )
        d.copy_(s)


def tree_map(fn, tree, *rest):
    """``fn`` applied to the tensors of ``tree`` (and the matching
    tensors of ``rest``, trees of the same structure); dicts, tuples and
    NamedTuples keep their structure, ``None`` stays ``None``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest]) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [tree_map(fn, v, *[r[i] for r in rest]) for i, v in enumerate(tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return tree


def tree_replace(like, leaves):
    """``like``'s structure with its tensors replaced, in
    :func:`tree_leaves` order, by ``leaves``."""
    return _replace(like, iter(leaves))


def _replace(t, it):
    # a module-level recursion: a nested recursive closure is a reference
    # cycle, which would keep ``leaves`` (and the tensors in it) alive until
    # the cyclic garbage collector runs
    if isinstance(t, torch.Tensor):
        return next(it)
    if isinstance(t, dict):
        return {k: _replace(t[k], it) for k in sorted(t)}
    if isinstance(t, tuple):
        vals = [_replace(v, it) for v in t]
        return type(t)(*vals) if hasattr(t, "_fields") else tuple(vals)
    return t


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic)) or (
        isinstance(x, (bool, int, float)) and not isinstance(x, str))


def _children(tree):
    """``[(name, child)]`` of a NamedTuple (fields), dataclass instance
    (fields), tuple or list (indices) or dict (sorted keys); None for
    anything else."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    return None


def tree_flatten_with_paths(tree, prefix: str = "") -> list:
    """``[(path, leaf)]`` of ``tree``'s tensors, arrays and numbers in
    :func:`tree_leaves` order, paths '/'-joined (NamedTuple and dataclass
    fields by name, tuple and list items by index, dict keys); ``None``
    and strings hold nothing."""
    if _is_leaf(tree):
        return [(prefix, tree)]
    kids = _children(tree)
    if kids is None:
        return []
    out = []
    for name, child in kids:
        out.extend(tree_flatten_with_paths(child, f"{prefix}/{name}" if prefix else name))
    return out


def tree_unflatten_like(like, leaves):
    """``like``'s structure with its leaves (as :func:`tree_flatten_with_paths`
    lists them) replaced, in order, by ``leaves``."""
    return _unflatten(like, iter(leaves))


def _unflatten(t, it):  # module-level, as _replace, so no cycle holds ``leaves``
    if _is_leaf(t):
        return next(it)
    kids = _children(t)
    if kids is None:
        return t
    vals = [_unflatten(c, it) for _, c in kids]
    if isinstance(t, dict):
        return dict(zip([k for k in sorted(t)], vals))
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*vals)
    if isinstance(t, (tuple, list)):
        return type(t)(vals)
    return dataclasses.replace(t, **{name: v for (name, _), v in zip(kids, vals)})
