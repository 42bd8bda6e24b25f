"""traj_rounds_per_s: rows x rounds of the completed studies over the window."""
from simbench.readers import traj_rounds


def read(record):
    return traj_rounds(record)
