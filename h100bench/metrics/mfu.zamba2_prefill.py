"""``mfu.zamba2_prefill``: the model FLOPs of the window's zamba2 prefill items,
counted from the configuration's shapes (``h100bench/work/zamba2_flops.py``:
the Mamba blocks, the 13 sites' products and attention's causal half, the
head), over the window's span at the H100's bf16 peak, in %."""

from h100bench.readers import mfu


def read(run):
    return mfu(run)
