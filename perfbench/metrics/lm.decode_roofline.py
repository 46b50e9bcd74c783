"""The decode step's share of its memory roofline: the bytes a step must
move (the cell's ``decode_bytes``: the weights a step reads, the K/V cache
read and written, the recurrent states read and written) over the
card's bandwidth, over the device ms per step: each replay of the decode
graph in the profiled requests, from its first kernel's start to its last
kernel's end in the trace (``drivers/jamba_generate.py::replay_seconds``),
in %."""


def read(run):
    info = run.info
    if run.peaks is None or "decode_bytes" not in info \
            or not info.get("decode_ms"):
        return None
    return 100.0 * info["decode_bytes"] / run.peaks[0] * 1e3 \
        / info["decode_ms"]
