"""Kernel launches per train step inside the program's
``train.optimizer`` span: the gradients' reduction, the global-norm clip
and AdamW."""

from perfbench import spans


def read(run):
    return spans.launches(run, "train.optimizer")
