"""kernels_per_round.sweep: the captured rounds' kernel nodes, summed over runners."""
from simbench.readers import kernels_per_round


def read(record):
    return kernels_per_round(record)
