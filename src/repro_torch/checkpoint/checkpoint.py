"""Minimal pytree checkpointing (npz + path-keyed leaves), the port of
the JAX package's ``checkpoint/checkpoint.py``.

A forked walk *is* a live checkpoint copy — the same serialization
snapshots a walk's model replica so a restarted node can re-enter the
system (``save_walk_snapshot``), and the durable-execution layer
(``repro_torch.api.plan`` segment snapshots, ``repro_torch.api.store``)
rides the same two functions.

Trees are the port's: NamedTuples (``SimState``, ``WalkState``,
``GraphState``, a payload's carry), dataclasses, tuples, lists, dicts,
with tensors, numpy arrays or numbers as leaves and ``None`` holding
nothing. Tensors are copied to the host for the npz; ``load_pytree``
puts each leaf back on its ``like`` leaf's device with its dtype.

Writes are atomic (same-directory temp + fsync + ``os.replace``); loads
are *checked*: every leaf must match the ``like`` template's path, shape
AND dtype, or :class:`CheckpointMismatchError` names every offender — a
stale snapshot with a drifted schema must never silently reinterpret
arrays. The one sanctioned dtype mismatch is the bfloat16 round-trip:
npz cannot hold bfloat16, so bf16 leaves are stored as float32 (exact —
f32 is a superset) and cast back on load (exact — the values are bf16
representable).

The reference also encodes typed JAX PRNG keys (``key_data`` in the
npz, re-wrapped on load). The port's keys are plain int64 tensors of
threefry word pairs (``utils/prng.py``), ordinary leaves here, so that
encoding has no counterpart.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.utils.faults import SimulatedKill, fault_point
from repro_torch.utils.tree import tree_flatten_with_paths, tree_map, tree_unflatten_like

__all__ = [
    "CheckpointMismatchError",
    "save_pytree",
    "load_pytree",
    "save_walk_snapshot",
]


class CheckpointMismatchError(ValueError):
    """A snapshot's leaves disagree with the expected structure.

    Raised by :func:`load_pytree` when any stored leaf's shape or dtype
    differs from the ``like`` template — the error message lists every
    mismatching leaf path with the stored vs expected spec.
    """

    def __init__(self, path: str, mismatches: list):
        self.path = path
        self.mismatches = list(mismatches)
        lines = "\n  ".join(self.mismatches)
        super().__init__(
            f"checkpoint {path!r} does not match the expected structure "
            f"({len(self.mismatches)} leaf mismatch(es)):\n  {lines}"
        )


def _atomic_write(path: str, write_fn) -> None:
    """Write via a same-directory temp file + ``os.replace``.

    A crash (or raised exception) mid-write leaves at worst an orphaned
    ``*.tmp-*`` file — the previous snapshot at ``path`` stays intact,
    and readers never observe a half-written file.

    Fault site ``checkpoint.write`` fires before anything touches disk;
    a scheduled :class:`~repro_torch.utils.faults.Torn` action makes this
    writer behave like its pre-atomic ancestor dying mid-write: the
    final path gets a truncated prefix of the payload, then the
    "process" dies (:class:`~repro_torch.utils.faults.SimulatedKill`).
    Readers must survive that file.
    """
    torn = fault_point("checkpoint.write", tearable=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        if torn is not None:
            with open(tmp, "rb") as f:
                prefix = f.read(torn.keep_bytes)
            with open(path, "wb") as f:  # deliberately non-atomic
                f.write(prefix)
            raise SimulatedKill("checkpoint.write")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _host_array(leaf) -> np.ndarray:
    """A leaf as a host numpy array (bf16 tensors as float32)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:  # npz can't hold bfloat16
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


_NP_DTYPES: dict = {}


def _expected(ref) -> tuple:
    """``(shape, numpy dtype)`` a stored leaf must have to load into
    ``ref`` (a bf16 tensor is stored as float32)."""
    if isinstance(ref, torch.Tensor):
        dt = ref.dtype
        if dt not in _NP_DTYPES:
            _NP_DTYPES[dt] = np.dtype(np.float32) if dt == torch.bfloat16 else \
                torch.empty((), dtype=dt).numpy().dtype
        return tuple(ref.shape), _NP_DTYPES[dt]
    a = np.asarray(ref)
    return tuple(a.shape), a.dtype


def _restore(arr: np.ndarray, ref):
    """``arr`` as a leaf like ``ref``: a tensor on ``ref``'s device with
    its dtype, an array of its dtype, or a number of its type."""
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device=ref.device, dtype=ref.dtype)
    if isinstance(ref, np.ndarray):
        return arr.astype(ref.dtype)
    return type(ref)(arr.item())


def save_pytree(path: str, tree: Any, metadata: dict | None = None) -> None:
    arrays = {p: _host_array(leaf) for p, leaf in tree_flatten_with_paths(tree)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    # np.savez appends ".npz" to bare string paths; match that name, but
    # stage both files through a temp + os.replace so a crash mid-write
    # never shadows the previous good snapshot with a corrupt one.
    npz_path = path if path.endswith(".npz") else path + ".npz"
    _atomic_write(npz_path, lambda f: np.savez(f, **arrays))
    if metadata is not None:
        blob = json.dumps(metadata, indent=2, default=str).encode()
        _atomic_write(path + ".meta.json", lambda f: f.write(blob))


def load_pytree(path: str, like: Any) -> Any:
    """Restore into the structure of ``like``.

    Every leaf is validated against its template: a missing path raises
    ``KeyError``; any shape OR dtype drift raises
    :class:`CheckpointMismatchError` listing every mismatching leaf
    (bf16 templates accept the documented float32 npz encoding and are
    cast back exactly). Tensor leaves come back on their template's
    device.
    """
    npz_path = path if path.endswith(".npz") else path + ".npz"
    with np.load(npz_path) as data:
        leaves, mismatches = [], []
        for p, ref in tree_flatten_with_paths(like):
            if p not in data:
                raise KeyError(f"checkpoint missing leaf {p!r}")
            arr = data[p]
            shape, dtype = _expected(ref)
            if tuple(arr.shape) != shape:
                mismatches.append(f"{p}: stored shape {tuple(arr.shape)} != expected {shape}")
                continue
            if arr.dtype != dtype:
                mismatches.append(f"{p}: stored dtype {arr.dtype} != expected {dtype}")
                continue
            leaves.append(_restore(arr, ref))
        if mismatches:
            raise CheckpointMismatchError(npz_path, mismatches)
    return tree_unflatten_like(like, leaves)


def save_walk_snapshot(path: str, replica_params: Any, walk_slot: int, step: int, *,
                       row: int = 0) -> None:
    """One walk's replica: slot ``walk_slot`` of trajectory row ``row``
    of the port's (batch, W, ...) replica leaves (the reference's
    replicas have no trajectory axis)."""
    snap = tree_map(lambda x: x[row, walk_slot], replica_params)
    save_pytree(path, snap, metadata={"walk_slot": walk_slot, "row": row, "step": step})
