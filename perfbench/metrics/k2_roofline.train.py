"""K2's share of its roofline per train step, in %."""

from perfbench import readers


def read(run):
    return readers.roofline(run, readers.K2, "k2_work")
