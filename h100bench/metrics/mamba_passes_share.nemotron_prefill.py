"""``mamba_passes_share.nemotron_prefill``: the device seconds charged to
the span ``mamba.block`` itself, over all the window's device seconds, in %
(``h100bench/spans.py``): the fused passes of the 23 Mamba blocks in eight
B/C groups and their residual adds; the projections and the scan have spans
of their own.  Left out unless the window holds one ``mamba.block`` a scan
call the benchmark made."""

from h100bench.spans import share


def read(run):
    return share(run, "mamba_passes_share.nemotron_prefill", "mamba.block", "self_s",
                 run.work.get("ssd_scan_calls"))
