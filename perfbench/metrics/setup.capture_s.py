"""Host seconds the program spent capturing CUDA graphs, warm-up calls
included (``cuda_graphs.CAPTURE_S``): set-up paid once per shape.  None
where nothing was captured, or where the program has no such counter."""

import sys


def read(run):
    graphs = sys.modules.get("vivim_tpu_torch.utils.cuda_graphs")
    if graphs is None or not getattr(graphs, "CAPTURES", 0):
        return None
    return getattr(graphs, "CAPTURE_S", None)
