"""threefry_blocks_per_round.production: the threefry blocks a round hashes, from the capture."""
from simbench.program_trace import threefry_blocks_per_round


def read(record):
    return threefry_blocks_per_round(record)
