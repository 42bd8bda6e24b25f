"""Entry points of the port: serving (``launch.serve``), training
(``launch.train``), the device meshes (``launch.mesh``), the node-sharded
protocol step over several processes (``launch.sharded``), and planning
runs on the production meshes (``launch.sharding``, ``launch.roofline``,
``launch.dryrun``)."""
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
