"""``mamba_passes_share.train``: the device seconds charged to the span
``mamba.block`` itself, over all the window's device seconds, in %
(``h100bench/spans.py``): the block's own passes in the forward, in
remat's recompute, and in the backward that autograd links to them;
its projections and its scan (forward and backward) have spans of their
own.  Left out unless the window holds one ``mamba.block`` a scan call the
benchmark made (the forward's and the recompute's)."""

from h100bench.spans import share


def read(run):
    return share(run, "mamba_passes_share.train", "mamba.block", "self_s",
                 run.work.get("ssd_scan_calls"))
