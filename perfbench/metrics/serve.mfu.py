"""The model's FLOPs per unit (the plain reference's matmuls and convs,
counted on the meta device, plus the scan's analytic work) at the
window's rate, over the card's fp32 peak, in %."""

from perfbench import readers


def read(run):
    return readers.mfu(run)
