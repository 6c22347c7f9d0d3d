"""``mfu.train``: the model FLOPs of the window's train items, counted from the
configuration's shapes (``h100bench/work/model_flops.py``), over the window's
span at the H100's bf16 peak, in %."""

from h100bench.readers import mfu


def read(run):
    return mfu(run)
