"""Device ms per profiled request of the kernels launched inside the
program's ``lm.ssm`` spans (each Mamba-2 mixer's recurrence in the eager
prefill: the scan and the preparation of its arguments), matched to their
launches by correlation id (``drivers/granite_generate.py::
span_device_seconds``): the time of the scan whatever kernel computes it.
None where the program opens no such span."""


def read(run):
    return run.info.get("ssm_ms")
