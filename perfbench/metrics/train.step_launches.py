"""Kernel launches per train step inside the program's ``train.step``
span: an eager step's every launch, or a replayed step's graph launch
and what surrounds it (a graph launch counts once)."""

from perfbench import spans


def read(run):
    return spans.launches(run, "train.step")
