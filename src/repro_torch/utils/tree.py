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
