"""device_idle.production: the device's idle share of the profiled replays, in %."""
from simbench.readers import device_idle


def read(record):
    return device_idle(record)
