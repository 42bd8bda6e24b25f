"""round_mfu.production: a round's own work at the peaks over its device time, in %."""
from simbench.readers import round_mfu


def read(record):
    return round_mfu(record)
