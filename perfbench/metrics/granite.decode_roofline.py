"""The decode step's share of its memory roofline: the bytes a step must
move (``granite_program.decode_bytes``: the weights outside the routed
experts, the shared experts and routers among them, the distinct routed
experts the window's steps chose (``moe.EXPERTS_READ``), the K/V cache read,
the Mamba-2 conv and ssm states read and written) over the card's
bandwidth, over the device ms per step: each replay of the decode graph in
the profiled requests, from its first kernel's start to its last kernel's
end in the trace (``drivers/jamba_generate.py::replay_seconds``), in %."""


def read(run):
    info = run.info
    if run.peaks is None or "decode_bytes" not in info \
            or not info.get("decode_ms"):
        return None
    return 100.0 * info["decode_bytes"] / run.peaks[0] * 1e3 \
        / info["decode_ms"]
