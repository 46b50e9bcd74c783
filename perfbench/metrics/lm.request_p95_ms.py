"""95th percentile of the latency of the window's LM requests, ms."""

from perfbench import harness


def read(run):
    lat = run.window.latencies
    return harness.percentile(lat, 95) * 1e3 if lat else None
