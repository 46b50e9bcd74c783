"""The share of a unit's wall time (the untraced window's) in which no
operation ran on the device (the profiled units' busy time), in %."""

from perfbench import readers


def read(run):
    return readers.idle(run)
