"""Host ms per serving request in the program's ``graph.key`` span: the
key ``GraphedCall`` builds before each replay (the inputs' signatures and
every weight tensor's address, shape, strides and dtype)."""

from perfbench import spans


def read(run):
    return spans.host_ms(run, "graph.key")
