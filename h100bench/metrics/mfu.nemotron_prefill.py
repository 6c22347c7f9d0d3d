"""``mfu.nemotron_prefill``: the model FLOPs of the window's nemotron_h prefill
items, counted from the configuration's shapes (``h100bench/work/nemotron_flops.py``:
the 23 Mamba blocks, the 23 MoE layers' router, active experts and shared
expert, the 6 attention layers' products and their causal half, the head),
over the window's span at the H100's bf16 peak, in %."""

from h100bench.readers import mfu


def read(run):
    return mfu(run)
