"""Trees of tensors: the state, rows and caches a captured runner keeps
at fixed addresses (tensors inside NamedTuples, tuples and dicts; a
``None`` leaf holds nothing). The counterpart of the JAX package's
``utils/tree.py`` for what the port needs."""
from __future__ import annotations

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
    it = iter(leaves)

    def build(t):
        if isinstance(t, torch.Tensor):
            return next(it)
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, tuple):
            vals = [build(v) for v in t]
            return type(t)(*vals) if hasattr(t, "_fields") else tuple(vals)
        return t

    return build(like)
