"""Train steps run as the replay of a captured step, over all train steps
of the process (``train/loop.py``'s ``REPLAYED_STEPS`` and ``STEPS``:
set-up's and the late ones included), in %.  None where no step ran, or
where the program has no such counters."""

import sys


def read(run):
    loop = sys.modules.get("vivim_tpu_torch.train.loop")
    steps = getattr(loop, "STEPS", 0)
    replayed = getattr(loop, "REPLAYED_STEPS", None)
    if not steps or replayed is None:
        return None
    return 100.0 * replayed / steps
