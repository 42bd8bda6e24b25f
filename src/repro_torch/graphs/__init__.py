"""Graphs: numpy generators, spectral quantities and the live topology
masks."""
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
from repro_torch.graphs.spectral import (
    arrival_rate_estimate,
    cover_time_estimate,
    expected_return_times,
    mixing_time_bound,
    return_rate_estimate,
    spectral_gap,
    stationary_distribution,
    transition_matrix,
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
    "arrival_rate_estimate",
    "availability",
    "availability_rows",
    "community_graph",
    "complete_graph",
    "cover_time_estimate",
    "erdos_renyi_graph",
    "expected_return_times",
    "init_graph_state",
    "make_graph",
    "mirror_indices",
    "mixing_time_bound",
    "power_law_graph",
    "random_regular_graph",
    "return_rate_estimate",
    "ring_graph",
    "spectral_gap",
    "stationary_distribution",
    "torus_graph",
    "transition_matrix",
]
