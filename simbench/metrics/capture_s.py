"""capture_s: the seconds of every runner's warm-up and capture (RoundRunner.capture_s)."""
from simbench.readers import capture_s


def read(record):
    return capture_s(record)
