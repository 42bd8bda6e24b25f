"""node_rounds_per_s: trajectory-rounds x the graph's nodes over the window."""
from simbench.readers import traj_rounds


def read(record):
    return traj_rounds(record) * record["n"]
