"""node_gap_share.sweep: a captured round's span between its graph nodes' operations, in %."""
from simbench.program_trace import node_gap_share


def read(record):
    return node_gap_share(record)
