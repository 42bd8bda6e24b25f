"""Device meshes over ``torch.distributed`` (counterpart of the JAX
package's ``launch/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh``: one rank per
device, laid out row-major over named axes. Building one needs a process
group of the mesh's size: these functions never start one (the caller
does, with its own backend, store, rank and world size). The production
meshes (256 ranks per pod) can only be built on one host under the fake
process group (``torch.testing._internal.distributed.fake_pg``).
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = [
    "axis_sizes",
    "data_axes",
    "data_axis_size",
    "make_local_mesh",
    "make_mesh",
    "make_production_mesh",
    "model_axis_size",
]


def make_mesh(shape, axes, device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over every rank of the current
    process group (its world size must be the product of ``shape``)."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    shape, axes = tuple(shape), tuple(axes)
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {math.prod(shape)} ranks; "
                         f"the process group has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks for multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_local_mesh(model_axis: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """``("data", "model")`` over the process group's world size."""
    n = dist.get_world_size() if dist.is_initialized() else 0
    if n % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide {n} ranks")
    return make_mesh((n // model_axis, model_axis), ("data", "model"), device_type)


def axis_sizes(mesh: DeviceMesh) -> dict:
    """Axis name -> size (the JAX mesh's ``shape`` mapping)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def data_axes(mesh: DeviceMesh) -> tuple:
    """Axes that shard the batch: ('pod','data') on multi-pod meshes."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def model_axis_size(mesh: DeviceMesh) -> int:
    return axis_sizes(mesh).get("model", 1)


def data_axis_size(mesh: DeviceMesh) -> int:
    sizes = axis_sizes(mesh)
    out = 1
    for a in data_axes(mesh):
        out *= sizes[a]
    return out
