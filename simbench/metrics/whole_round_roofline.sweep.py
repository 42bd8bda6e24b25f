"""whole_round_roofline.sweep: whole_round's bound from shapes over its device time, in %."""
from simbench.readers import whole_round_roofline


def read(record):
    return whole_round_roofline(record)
