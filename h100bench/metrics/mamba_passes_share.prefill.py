"""``mamba_passes_share.prefill``: the device seconds charged to the span
``mamba.block`` itself, over all the window's device seconds, in %
(``h100bench/spans.py``).  Its own passes: the norms, the causal conv,
silu, softplus, the gating, the D skip and the casts and copies between
them; its projections and its scan have spans of their own.  Left out
unless the window holds one ``mamba.block`` a scan call the benchmark
made."""

from h100bench.spans import share


def read(run):
    return share(run, "mamba_passes_share.prefill", "mamba.block", "self_s",
                 run.work.get("ssd_scan_calls"))
