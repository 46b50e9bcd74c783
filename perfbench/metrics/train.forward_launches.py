"""Kernel launches per train step inside the program's ``train.forward``
span: the forward, the loss and the Jaccard counts of each micro-batch."""

from perfbench import spans


def read(run):
    return spans.launches(run, "train.forward")
