"""K1's share of its roofline: the bound of its calls per unit at the
cell's shapes over its measured device time per unit, in %."""

from perfbench import readers


def read(run):
    return readers.roofline(run, readers.K1, "k1_work")
