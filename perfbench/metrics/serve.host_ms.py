"""Per request: the window's wall ms per request minus the ms per profiled
request in which a kernel ran (the replay's device time; copies not
counted): the host's part of a request, the copy-in, the copy-out and the
loop included."""

from perfbench import readers, trace


def read(run):
    p, wall = run.profile, readers.unit_s(run)
    if p is None or not p.units or wall is None:
        return None
    ks = readers.kernels(p)
    if not ks:
        return None
    return (wall - trace.union((s, e) for _, s, e, _ in ks) / p.units) * 1e3
