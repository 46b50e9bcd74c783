"""Kernel launches per train step inside the program's ``train.backward``
span: each micro-batch's backward, which autograd's device thread launches
while the main thread holds the span."""

from perfbench import spans


def read(run):
    return spans.launches(run, "train.backward")
