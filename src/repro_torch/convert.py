"""Carry state, configs and weights across from the JAX package.

What crosses is the simulator state and its configs, so a trajectory
started in the reference can continue in the port, and a model's
parameters, so the port serves the reference's weights. The JAX side
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
from repro_torch.core.failures import FailureConfig
from repro_torch.core.protocol import ProtocolConfig
from repro_torch.core.simulator import SimState
from repro_torch.graphs.state import GraphState
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import ModelParams
from repro_torch.models.transformer import param_shapes

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
}


def state_from_arrays(arrays: Mapping[str, np.ndarray], device) -> SimState:
    """The port's batched ``SimState`` from an exported reference state.

    ``arrays`` maps every path of :data:`STATE_FIELDS` to a numpy array,
    either of one trajectory or with a leading batch axis (all fields
    alike). Observation rows beyond the graph's ``n`` (the reference's
    kernel padding) are cut off.
    """
    missing = [f for f in STATE_FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"exported state lacks {missing}")
    batched = np.ndim(arrays["t"]) == 1
    n = np.shape(arrays["graph.node_up"])[-1]
    out = {}
    for f, (dtype, rank) in STATE_FIELDS.items():
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
            pos=out["walks.pos"], active=out["walks.active"], track=out["walks.track"]
        ),
        last_seen=out["last_seen"],
        rts=est.ReturnTimeState(hist=out["rts.hist"], total=out["rts.total"]),
        byz_state=out["byz_state"],
        key=out["key"],
        graph=GraphState(node_up=out["graph.node_up"], edge_up=out["graph.edge_up"]),
        theta_hist=out["theta_hist"],
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
