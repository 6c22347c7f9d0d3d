"""``ssd_backward_share.train``: the device seconds charged to the span
``ssd_scan.backward`` and to what it holds, over all the window's device
seconds, in % (``h100bench/spans.py``): the SSD scan's backward, whatever
computes it.  Left out unless the window holds one span a layer a step,
and ``SSDScan.backward_calls`` counted the set-up's and the window's."""

from h100bench.spans import backward_counted, share


def read(run):
    calls = len(run.items) * run.ctx.widths["n_layers"]
    if not backward_counted(run):
        return None
    return share(run, "ssd_backward_share.train", "ssd_scan.backward", "total_s", calls)
