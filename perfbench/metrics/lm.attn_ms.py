"""Device ms per profiled request of the kernels launched inside the
program's ``lm.attn`` spans (each attention branch of the eager prefill:
its projections, rotary positions, SDPA, the K/V cache write and o_proj),
matched to their launches by correlation id (``drivers/granite_generate.
py::span_device_seconds``).  None where the program opens no such span."""


def read(run):
    return run.info.get("attn_ms")
