"""The analytic FLOPs of a generation request of a hybrid LM (the cell's
``request_flops``: every projection, causal attention, the scan) at the
window's requests per second, over the card's dense bf16 peak (989.4
TFLOP/s on the H100 SXM), in %."""


def read(run):
    w, info = run.window, run.info
    if "bf16_peak" not in info or "flops_per_unit" not in info \
            or not w.units:
        return None
    return (100.0 * info["flops_per_unit"] * w.units / w.seconds
            / info["bf16_peak"])
