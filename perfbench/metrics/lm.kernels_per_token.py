"""Device kernels launched in the profiled requests per new token."""

from perfbench import readers


def read(run):
    p = run.profile
    if p is None or not p.tokens:
        return None
    n = len(readers.kernels(p))
    return n / p.tokens if n else None
