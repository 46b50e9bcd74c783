"""Host ms from calling the train step until it returns, mean over the
window's steps: how far the host runs ahead of the card."""


def read(run):
    lat = run.window.latencies
    return 1e3 * sum(lat) / len(lat) if lat else None
