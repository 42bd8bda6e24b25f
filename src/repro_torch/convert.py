"""Carry state, configs and weights across from the JAX package.

What crosses is the simulator state and its configs, so a trajectory
started in the reference can continue in the port; a model's
parameters, so the port serves the reference's weights; and the RW-SGD
payload's carry (a ``ReplicaSet``: replicas, optimizer state, step
counters) and its ``SyntheticTask``, so a payload run starts from the
reference's exact weights and data (the task's ``u @ v`` product can
differ by an ulp between XLA and torch, which ``categorical``'s argmax
sees). The JAX side
exports a ``SimState`` or a param pytree as a flat dict of numpy arrays
(dotted paths; the typed key as its ``key_data`` uint32 pair; bfloat16
leaves as ``ml_dtypes.bfloat16`` arrays); these functions read such
dicts and plain field dicts, and import nothing of JAX.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core import estimator as est
from repro_torch.core import walkers as wlk
from repro_torch.core.distributed import ShardedGraph, ShardedProtocolState
from repro_torch.core.failures import FailureConfig
from repro_torch.core.protocol import ProtocolConfig
from repro_torch.core.simulator import SimState
from repro_torch.graphs.state import GraphState
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import ModelParams
from repro_torch.data.synthetic import SyntheticTask
from repro_torch.models.transformer import param_shapes
from repro_torch.optim.optimizers import OptState
from repro_torch.optim.rw_sgd import ReplicaSet

# field path -> (dtype, rank of one trajectory's array)
STATE_FIELDS = {
    "t": (torch.int32, 0),
    "walks.pos": (torch.int32, 1),
    "walks.active": (torch.bool, 1),
    "walks.track": (torch.int32, 1),
    "last_seen": (torch.int32, 2),
    "rts.hist": (torch.int16, 2),
    "rts.total": (torch.int32, 1),
    "byz_state": (torch.bool, 0),
    "key": (torch.int64, 1),
    "graph.node_up": (torch.bool, 1),
    "graph.edge_up": (torch.bool, 2),
    "theta_hist": (torch.float32, 2),
    # the zoo's columns, present only where the run carries them (a walk
    # variant's memory, a mobile Pac-Man's positions)
    "walks.prev": (torch.int32, 1),
    "walks.bloom": (torch.bool, 2),
    "pacman_pos": (torch.int32, 1),
}
OPTIONAL_FIELDS = ("walks.prev", "walks.bloom", "pacman_pos")


def state_from_arrays(arrays: Mapping[str, np.ndarray], device) -> SimState:
    """The port's batched ``SimState`` from an exported reference state.

    ``arrays`` maps every path of :data:`STATE_FIELDS` to a numpy array
    (those of :data:`OPTIONAL_FIELDS` where the state has them), either
    of one trajectory or with a leading batch axis (all fields alike).
    Observation rows beyond the graph's ``n`` (the reference's kernel
    padding) are cut off.
    """
    missing = [f for f in STATE_FIELDS if f not in arrays and f not in OPTIONAL_FIELDS]
    if missing:
        raise KeyError(f"exported state lacks {missing}")
    batched = np.ndim(arrays["t"]) == 1
    n = np.shape(arrays["graph.node_up"])[-1]
    out = {}
    for f, (dtype, rank) in STATE_FIELDS.items():
        if f not in arrays:
            out[f] = None
            continue
        a = np.asarray(arrays[f])
        if f == "key":
            a = a.astype(np.uint32).astype(np.int64)
        if not batched:
            a = a[None]
        if a.ndim != rank + 1:
            raise ValueError(f"{f}: expected rank {rank + 1} with the batch axis, got {a.ndim}")
        if f in ("last_seen", "rts.hist", "rts.total"):
            a = a[:, :n]
        out[f] = torch.as_tensor(np.array(a, copy=True), device=device).to(dtype)
    return SimState(
        t=out["t"],
        walks=wlk.WalkState(
            pos=out["walks.pos"], active=out["walks.active"], track=out["walks.track"],
            prev=out["walks.prev"], bloom=out["walks.bloom"],
        ),
        last_seen=out["last_seen"],
        rts=est.ReturnTimeState(hist=out["rts.hist"], total=out["rts.total"]),
        byz_state=out["byz_state"],
        key=out["key"],
        graph=GraphState(node_up=out["graph.node_up"], edge_up=out["graph.edge_up"]),
        theta_hist=out["theta_hist"],
        pacman_pos=out["pacman_pos"],
    )


def _plain(v):
    """A numpy array or scalar as the Python value a config field holds."""
    a = np.asarray(v)
    if a.ndim == 0:
        return a.item()
    return tuple(a.reshape(-1).tolist())


def protocol_config(fields: Mapping) -> ProtocolConfig:
    """``ProtocolConfig`` from a plain field dict (numpy leaves allowed)."""
    return ProtocolConfig(**{k: (v if v is None or isinstance(v, str) else _plain(v))
                             for k, v in fields.items()})


def failure_config(fields: Mapping) -> FailureConfig:
    """``FailureConfig`` from a plain field dict (numpy leaves allowed)."""
    return FailureConfig(**{k: _plain(v) for k, v in fields.items()})


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """A numpy leaf as a tensor; bfloat16 (``ml_dtypes``) crosses as its
    raw 16-bit words."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a.view(np.int16), copy=True))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


# the node-sharded step's twelve arguments, in the reference's order, and
# their dtypes in the port
SHARDED_STEP_ARGS = {
    "t": torch.int32, "pos": torch.int32, "active": torch.bool, "track": torch.int32,
    "last_seen": torch.int32, "hist": torch.float32, "total": torch.float32,
    "key": torch.int64, "neighbors": torch.int32, "degrees": torch.int32,
    "node_up": torch.bool, "edge_up": torch.bool,
}


def sharded_step_from_arrays(args, device) -> tuple[ShardedProtocolState, ShardedGraph]:
    """The port's step state and graph from the reference sharded step's
    twelve arguments as numpy arrays, in its order (the typed key as its
    ``key_data`` uint32 pair)."""
    if len(args) != len(SHARDED_STEP_ARGS):
        raise ValueError(f"the sharded step takes {len(SHARDED_STEP_ARGS)} arguments; "
                         f"got {len(args)}")
    out = []
    for (name, dtype), a in zip(SHARDED_STEP_ARGS.items(), args):
        a = np.asarray(a)
        if name == "key":
            a = a.astype(np.uint32).astype(np.int64)
        out.append(_tensor(a, device).to(dtype))
    return ShardedProtocolState(*out[:8]), ShardedGraph(*out[8:])


def sharded_step_to_arrays(state: ShardedProtocolState, graph: ShardedGraph) -> tuple:
    """The inverse: the twelve arguments as numpy arrays in the
    reference's dtypes (the key as its uint32 word pair)."""
    out = [x.cpu().numpy() for x in (*state, *graph)]
    out[7] = out[7].astype(np.uint32)
    return tuple(out)


def model_params_from_arrays(arrays: Mapping[str, np.ndarray], cfg: ModelConfig, device) -> ModelParams:
    """The port's ``ModelParams`` from a reference param pytree flattened
    to numpy: dotted paths (``"embed"``, ``"layers.attn.wq"``, ...), the
    layer leaves stacked on a leading (L, ...) axis as ``Model.init``
    builds them. The paths, shapes and dtypes must be exactly those the
    port's ``Model(cfg).init`` draws (``param_shapes``; checked)."""
    want = param_shapes(cfg)
    L = cfg.num_layers
    top, layers = {}, [{} for _ in range(L)]
    seen = set()
    for path, a in arrays.items():
        parts = path.split(".")
        if parts[0] == "layers":
            a = np.asarray(a)
            if a.shape[:1] != (L,):
                raise ValueError(f"{path}: expected a leading layer axis of {L}, got {a.shape}")
            for i in range(L):
                name = ".".join(["layers", str(i)] + parts[1:])
                _put(layers[i], parts[1:], _tensor(a[i], device))
                seen.add(name)
        else:
            _put(top, parts, _tensor(a, device))
            seen.add(path)
    if seen != set(want):
        raise KeyError(f"param paths differ from the port's: missing {sorted(set(want) - seen)}, "
                       f"unexpected {sorted(seen - set(want))}")
    params = ModelParams(top, layers)
    for name, t in params.state_dict().items():
        shape, dtype = want[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
    return params


def _put(tree: dict, parts, value) -> None:
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value


def params_tree_from_arrays(arrays: Mapping[str, np.ndarray], cfg: ModelConfig, device,
                            lead: tuple = (), check_dtype: bool = True) -> dict:
    """A ``Model.params_tree`` dict from a reference param pytree
    flattened to numpy (dotted paths, layer leaves stacked (L, ...)),
    each leaf with the leading axes ``lead`` (a replica stack's (W,) or
    (batch, W)); paths, shapes and dtypes are checked against what
    ``Model(cfg).init`` draws (dtypes only with ``check_dtype``:
    optimizer moments may be bfloat16)."""
    want = {}
    for name, (shape, dtype) in param_shapes(cfg).items():
        parts = name.split(".")
        if parts[0] == "layers":
            want[".".join(["layers"] + parts[2:])] = ((cfg.num_layers,) + shape, dtype)
        else:
            want[name] = (shape, dtype)
    if set(arrays) != set(want):
        raise KeyError(f"param paths differ from the port's: missing "
                       f"{sorted(set(want) - set(arrays))}, unexpected "
                       f"{sorted(set(arrays) - set(want))}")
    tree: dict = {}
    for path, a in arrays.items():
        t = _tensor(a, device)
        shape, dtype = want[path]
        if tuple(t.shape) != tuple(lead) + shape or (check_dtype and t.dtype != dtype):
            raise ValueError(f"{path}: expected {tuple(lead) + shape} {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        _put(tree, path.split("."), t)
    return tree


def replicas_from_arrays(arrays: Mapping[str, np.ndarray], cfg: ModelConfig,
                         device) -> ReplicaSet:
    """The port's ``ReplicaSet`` from a reference ``ReplicaSet``
    flattened to numpy: ``params.<path>``, ``opt_state.step``,
    ``opt_state.mu.<path>`` / ``opt_state.nu.<path>`` (absent for plain
    SGD) and ``steps``, every leaf with the slot axis (W, ...) of one
    trajectory or the batch and slot axes (batch, W, ...)."""
    steps = np.asarray(arrays["steps"])
    lead = steps.shape if steps.ndim == 2 else (1,) + steps.shape
    fix = (lambda a: np.asarray(a)) if steps.ndim == 2 else (lambda a: np.asarray(a)[None])

    def group(prefix, check_dtype=False):
        sub = {k[len(prefix):]: fix(v) for k, v in arrays.items() if k.startswith(prefix)}
        return params_tree_from_arrays(sub, cfg, device, lead, check_dtype) if sub else ()

    return ReplicaSet(
        params=group("params.", check_dtype=True),
        opt_state=OptState(
            step=_tensor(fix(arrays["opt_state.step"]), device).to(torch.int32),
            mu=group("opt_state.mu."), nu=group("opt_state.nu.")),
        steps=_tensor(fix(steps), device).to(torch.int32),
    )


def task_from_arrays(logits: np.ndarray, entropy: float, device) -> SyntheticTask:
    """A reference ``SyntheticTask`` (its (V, V) logits and entropy)."""
    return SyntheticTask(logits=_tensor(np.asarray(logits, np.float32), device),
                         entropy=float(entropy))
