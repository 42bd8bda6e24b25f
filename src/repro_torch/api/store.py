"""Disk-backed result persistence for Plans, the port of the JAX
package's ``api/store.py``.

The executable cache (``repro_torch.api.plan``) makes repeated studies
cheap *within* one process; this module makes them free *across*
processes: a :class:`ResultStore` caches the results of
``Plan.sweep_stacked`` calls on disk, keyed by a **stable content hash**
of everything that determines the answer —

    (a namespace token for this package, the plan signature (the device
     type and the threefry layout included), the graph's adjacency,
     every scenario's config values, the seed count, the base key words)

— so a store-warm re-run in a fresh process returns bitwise-identical
tensors without making a runner, capturing a graph or running a round.
The namespace token keeps a directory the JAX package wrote from ever
answering the port (and the other way round). The device type is in the
key because the port's float outputs differ between cuda and the CPU in
the last bits (``theta_mean``), so a CPU result never answers a cuda
call. Keys need every signature component to be *stable* (primitives,
tuples, NamedTuples, dataclasses of primitives, ``torch.device``):
payload-carrying sweeps are storable exactly when the payload declares
:meth:`~repro_torch.core.payload.Payload.signature`.

Serialization rides ``repro_torch.checkpoint`` (npz + atomic temp-file +
``os.replace`` writes, so a crash mid-write never corrupts a previously
stored result); the tree *structure* — ``RecordedOutputs`` fields,
NamedTuples (``SimState``, payload outputs and carries), nesting — is
recorded as a JSON schema in the sidecar ``.meta.json`` and rebuilt on
load, leaf dtypes restored exactly, tensors on the caller's device.

Point a store at a directory explicitly (``ResultStore(path)``), or set
the ``REPRO_RESULT_STORE`` environment variable and let
``ResultStore.from_env()`` / the
:class:`~repro_torch.api.service.ExperimentService` default pick it up.
Unreadable or half-missing entries are treated as misses, never as
errors.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.core.outputs import RecordedOutputs
from repro_torch.utils.faults import fault_point

__all__ = ["ResultStore", "UnstableSignatureError", "canonical_token"]

ENV_VAR = "REPRO_RESULT_STORE"

_SCHEMA_VERSION = 1
_NAMESPACE = b"repro_torch-sweep-v1\x00"


class UnstableSignatureError(ValueError):
    """A plan-signature component has no stable cross-process encoding
    (typically a payload without :meth:`Payload.signature`)."""


# ---------------------------------------------------------------------------
# stable tokens: signature tuples -> canonical strings
# ---------------------------------------------------------------------------


def canonical_token(obj: Any) -> str:
    """Canonical string for a static-signature component.

    Accepts the primitives / tuples / NamedTuples / dataclasses a
    :func:`~repro_torch.api.plan.plan_signature` is built from, and a
    ``torch.device`` (its type only: ``cuda`` and ``cuda:0`` are one
    key); anything else (an identity-hashed payload object, a callable)
    raises :class:`UnstableSignatureError` — the store must never key
    results on ``id()``.
    """
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return repr(obj)
    if isinstance(obj, torch.device):
        return f"device({obj.type!r})"
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        fields = ",".join(f"{f}={canonical_token(v)}" for f, v in zip(obj._fields, obj))
        return f"{type(obj).__qualname__}({fields})"
    if isinstance(obj, (tuple, list)):
        inner = ",".join(canonical_token(x) for x in obj)
        return f"({inner})"
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        fields = ",".join(
            f"{f.name}={canonical_token(getattr(obj, f.name))}"
            for f in dataclasses.fields(obj)
        )
        return f"{type(obj).__qualname__}({fields})"
    raise UnstableSignatureError(
        f"signature component {obj!r} has no stable cross-process encoding; "
        "results carrying it cannot be persisted. For payloads, implement "
        "Payload.signature() (a stable static-config tuple) to enable the "
        "result store."
    )


def _value_token(v: Any) -> str:
    """A config field's value: numbers and tuples canonically, arrays and
    tensors (a deferred-validation ``z0``, say) by their values."""
    if isinstance(v, (torch.Tensor, np.ndarray, np.generic)):
        a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        return f"array({a.dtype},{a.shape},{a.tolist()!r})"
    if isinstance(v, (tuple, list)):
        return "(" + ",".join(_value_token(x) for x in v) + ")"
    return canonical_token(v)


def _hash_configs(h, configs) -> None:
    """Fold every field value of every scenario's (protocol, failure)
    config into a hash."""
    for cfg in configs:
        h.update(type(cfg).__qualname__.encode())
        for f in dataclasses.fields(cfg):
            h.update(f"{f.name}={_value_token(getattr(cfg, f.name))};".encode())


def _hash_arrays(h, arrays) -> None:
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a))
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())


# ---------------------------------------------------------------------------
# structure schema: describe / rebuild result trees
# ---------------------------------------------------------------------------


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _describe(obj: Any, leaves: list) -> dict:
    """Flatten ``obj`` into ``leaves`` (host tensors) and return a
    JSON-able schema that :func:`_rebuild` inverts. Handles the trees
    Plans produce: ``RecordedOutputs``, NamedTuples (``SimState``,
    payload outputs and carries), tuples / lists / dicts, ``None`` and
    tensor leaves."""
    if obj is None:
        return {"kind": "none"}
    if isinstance(obj, RecordedOutputs):
        return {
            "kind": "recorded",
            "fields": list(obj._fields),
            "children": [_describe(v, leaves) for v in obj],
        }
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # NamedTuple
        cls = type(obj)
        return {
            "kind": "namedtuple",
            "cls": [cls.__module__, cls.__qualname__],
            "children": [_describe(v, leaves) for v in obj],
        }
    if isinstance(obj, (tuple, list)):
        return {
            "kind": "tuple" if isinstance(obj, tuple) else "list",
            "children": [_describe(v, leaves) for v in obj],
        }
    if isinstance(obj, dict):
        keys = sorted(obj)
        return {
            "kind": "dict",
            "keys": keys,
            "children": [_describe(obj[k], leaves) for k in keys],
        }
    t = torch.as_tensor(obj).detach()
    leaves.append(t)
    return {"kind": "leaf", "dtype": _dtype_name(t.dtype), "shape": list(t.shape)}


def _rebuild(schema: dict, leaves) -> Any:
    kind = schema["kind"]
    if kind == "none":
        return None
    if kind == "leaf":
        return next(leaves)
    children = [_rebuild(c, leaves) for c in schema["children"]]
    if kind == "recorded":
        return RecordedOutputs(tuple(schema["fields"]), tuple(children))
    if kind == "namedtuple":
        module, qualname = schema["cls"]
        if module.split(".")[0] != "repro_torch":
            raise ValueError(f"stored structure names {module}.{qualname}, not a "
                             "repro_torch class")
        cls = importlib.import_module(module)
        for part in qualname.split("."):
            cls = getattr(cls, part)
        return cls(*children)
    if kind == "tuple":
        return tuple(children)
    if kind == "list":
        return children
    if kind == "dict":
        return dict(zip(schema["keys"], children))
    raise ValueError(f"unknown schema kind {kind!r}")


def _leaf_templates(schema: dict, out: list, device) -> None:
    """Empty shape/dtype templates on ``device`` in flatten order, for
    ``load_pytree``'s checked restore (dtypes restored exactly,
    including the bfloat16 -> float32 npz round-trip)."""
    kind = schema["kind"]
    if kind == "leaf":
        out.append(torch.empty(tuple(schema["shape"]), dtype=getattr(torch, schema["dtype"]),
                               device=device))
    elif kind != "none":
        for c in schema.get("children", ()):
            _leaf_templates(c, out, device)


def _load(base: str, device) -> Any:
    """The tree stored at ``base`` (``.npz`` + ``.meta.json``), tensors on
    ``device``; raises on anything unreadable."""
    with open(base + ".meta.json") as f:
        meta = json.load(f)
    schema = meta["schema"]
    like: list = []
    _leaf_templates(schema, like, device)
    leaves = load_pytree(base + ".npz", like)
    return _rebuild(schema, iter(leaves))


def _save(base: str, tree: Any, meta: dict) -> None:
    leaves: list = []
    meta = dict(meta, schema=_describe(tree, leaves))
    save_pytree(base, leaves, metadata=meta)


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


class ResultStore:
    """Content-addressed, disk-backed Plan result cache (module docstring).

    Layout: ``<root>/<key[:2]>/<key>.npz`` (the leaves, written
    atomically) + ``<key>.meta.json`` (structure schema + provenance).
    ``hits`` / ``misses`` / ``puts`` count this instance's traffic.
    """

    def __init__(self, root):
        self.root = os.path.abspath(os.fspath(root))
        self.hits = 0
        self.misses = 0
        self.puts = 0

    # -- construction ------------------------------------------------------

    @classmethod
    def from_env(cls) -> "ResultStore | None":
        """The store named by ``$REPRO_RESULT_STORE``, or None if unset."""
        root = os.environ.get(ENV_VAR, "").strip()
        return cls(root) if root else None

    @classmethod
    def resolve(cls, store) -> "ResultStore | None":
        """Normalize a ``store=`` argument: None stays None, ``"env"``
        reads :data:`ENV_VAR`, a path string opens that directory, a
        ResultStore passes through."""
        if store is None or isinstance(store, cls):
            return store
        if store == "env":
            return cls.from_env()
        if isinstance(store, (str, os.PathLike)):
            return cls(store)
        raise TypeError(
            f"store must be None, 'env', a directory path or a ResultStore; "
            f"got {store!r}"
        )

    # -- keys --------------------------------------------------------------

    def sweep_key(self, signature: tuple, graph, configs, seeds: int, key) -> str:
        """The content hash of one ``sweep_stacked`` call (or one
        segmented run): the namespace, the stable plan signature, the
        graph's adjacency, every config value of ``configs`` (the
        scenarios' protocol and failure configs), the seed count and the
        base key's two words."""
        h = hashlib.sha256()
        h.update(_NAMESPACE)
        h.update(canonical_token(signature).encode())
        _hash_arrays(h, (np.asarray(graph.neighbors, np.int32),
                         np.asarray(graph.degrees, np.int32)))
        _hash_configs(h, configs)
        h.update(f"seeds={int(seeds)}".encode())
        words = torch.as_tensor(key, dtype=torch.int64).reshape(-1).tolist()
        h.update(f"key={words}".encode())
        return h.hexdigest()

    def _paths(self, key: str) -> tuple:
        base = os.path.join(self.root, key[:2], key)
        return base, base + ".npz", base + ".meta.json"

    def __contains__(self, key: str) -> bool:
        _, npz, meta = self._paths(key)
        return os.path.exists(npz) and os.path.exists(meta)

    # -- IO ----------------------------------------------------------------

    def get(self, key: str, device="cpu"):
        """The stored result tree for ``key`` with its tensors on
        ``device``, or None on a miss. Corrupt/partial entries (e.g. from
        a dead writer on a pre-atomic checkpoint layer) count as misses —
        and so does ANY read failure (fault site ``store.get``): a flaky
        store must degrade to recomputation, never take the caller
        down."""
        base, _npz, _meta = self._paths(key)
        try:
            fault_point("store.get")
            result = _load(base, device)
        except Exception:  # unreadable/corrupt/mismatched entry == miss
            self.misses += 1
            return None
        self.hits += 1
        return result

    def put(self, key: str, result: Any, extra_meta: dict | None = None):
        """Persist a result tree under ``key`` (atomic: readers see the
        old entry or the new one, never a torn write). Fault site
        ``store.put`` fires before any IO."""
        fault_point("store.put")
        base, _npz, _meta = self._paths(key)
        _save(base, result, dict(extra_meta or {}, schema_version=_SCHEMA_VERSION, key=key))
        self.puts += 1
        return key

    # -- segment snapshots (durable execution write-behind) ----------------
    #
    # A segmented run (``Plan.*_segmented`` / ``sweep_stacked(
    # segment_steps=...)``) persists, at each segment boundary, one
    # SELF-CONTAINED snapshot: the trajectory carry after ``steps_done``
    # rounds plus every recorded output so far. Snapshots are keyed by
    # the SAME content key as the final result and named by their step
    # count, so resume is segmentation-independent: a killed process
    # restarts from the deepest loadable snapshot whatever chunking it
    # now runs with. Older snapshots double as fallbacks for a torn
    # latest write; ``keep`` bounds how many stay on disk.

    def _segment_dir(self, key: str) -> str:
        return os.path.join(self.root, "segments", key[:2], key)

    def _segment_base(self, key: str, steps_done: int) -> str:
        return os.path.join(self._segment_dir(key), f"seg_{steps_done:07d}")

    def segment_steps_on_disk(self, key: str) -> list:
        """Step counts of the on-disk snapshots for ``key``, descending
        (no validation — :meth:`latest_segment` does the checked load)."""
        out = []
        try:
            for name in os.listdir(self._segment_dir(key)):
                if name.startswith("seg_") and name.endswith(".npz"):
                    try:
                        out.append(int(name[4:-4]))
                    except ValueError:
                        continue
        except OSError:
            return []
        return sorted(set(out), reverse=True)

    def put_segment(self, key: str, steps_done: int, snapshot: Any,
                    extra_meta: dict | None = None, keep: int = 2) -> None:
        """Write-behind one segment snapshot (atomic; fault site
        ``store.put``). Keeps the newest ``keep`` snapshots, pruning the
        rest — the previous one survives as the fallback for a torn
        latest write."""
        fault_point("store.put")
        meta = dict(extra_meta or {}, schema_version=_SCHEMA_VERSION, key=key,
                    steps_done=int(steps_done))
        _save(self._segment_base(key, steps_done), snapshot, meta)
        self.puts += 1
        for stale in self.segment_steps_on_disk(key)[keep:]:
            self._drop_segment(key, stale)

    def latest_segment(self, key: str, max_steps: int | None = None, device="cpu"):
        """The deepest loadable snapshot for ``key``: ``(steps_done,
        snapshot)`` with its tensors on ``device``, or None.
        Corrupt/torn/mismatched snapshots are skipped (falling back to
        the next-older one), and any snapshot deeper than ``max_steps``
        is ignored — a stale deeper run must not leak into a shorter
        one."""
        for steps_done in self.segment_steps_on_disk(key):
            if max_steps is not None and steps_done > max_steps:
                continue
            try:
                fault_point("store.get")
                snapshot = _load(self._segment_base(key, steps_done), device)
            except Exception:  # torn/corrupt snapshot: fall back
                self.misses += 1
                continue
            self.hits += 1
            return steps_done, snapshot
        return None

    def clear_segments(self, key: str) -> None:
        """Drop every segment snapshot for ``key`` (the run completed —
        its final result owns the key now)."""
        for steps_done in self.segment_steps_on_disk(key):
            self._drop_segment(key, steps_done)

    def _drop_segment(self, key: str, steps_done: int) -> None:
        base = self._segment_base(key, steps_done)
        for suffix in (".npz", ".meta.json"):
            try:
                os.remove(base + suffix)
            except OSError:
                pass

    def __repr__(self):
        return (
            f"ResultStore({self.root!r}, hits={self.hits}, "
            f"misses={self.misses}, puts={self.puts})"
        )

