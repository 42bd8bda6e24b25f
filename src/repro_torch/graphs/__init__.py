"""Graphs: numpy generators and the live topology masks."""
from repro_torch.graphs.generators import (
    GRAPH_FAMILIES,
    Graph,
    community_graph,
    complete_graph,
    erdos_renyi_graph,
    make_graph,
    power_law_graph,
    random_regular_graph,
    ring_graph,
    torus_graph,
)
from repro_torch.graphs.state import (
    GraphState,
    availability,
    availability_rows,
    init_graph_state,
    mirror_indices,
)

__all__ = [
    "GRAPH_FAMILIES",
    "Graph",
    "GraphState",
    "availability",
    "availability_rows",
    "community_graph",
    "complete_graph",
    "erdos_renyi_graph",
    "init_graph_state",
    "make_graph",
    "mirror_indices",
    "power_law_graph",
    "random_regular_graph",
    "ring_graph",
    "torus_graph",
]
