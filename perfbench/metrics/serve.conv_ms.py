"""Device ms per serving request in which cuDNN's conv and layout kernels
(the Mix-FFN's 3-D depthwise conv most of it) ran: the union of their
intervals, since a conv's per-group kernels run at once on several
streams."""

from perfbench import readers


def read(run):
    return readers.per_unit_union_ms(run, readers.CONV)
