"""Entry points of the port: serving (``launch.serve``), the device
meshes (``launch.mesh``) and the node-sharded protocol step over several
processes (``launch.sharded``)."""
from repro_torch.launch.mesh import (
    data_axes,
    data_axis_size,
    make_local_mesh,
    make_production_mesh,
    model_axis_size,
)

__all__ = [
    "data_axes",
    "data_axis_size",
    "make_local_mesh",
    "make_production_mesh",
    "model_axis_size",
]
