"""threefry_share.sweep: the threefry stages' device time over a captured round's span, in %."""
from simbench.program_trace import threefry_share


def read(record):
    return threefry_share(record)
