"""Kernel launches per LM request inside the program's ``lm.forward`` span:
the eager prefill of a generation request, or a scoring request's forward
with its head."""

from perfbench import spans


def read(run):
    return spans.launches(run, "lm.forward")
