"""``adamw_share.train``: the device seconds charged to the span
``adamw.update`` (global norm, clipping and every leaf's update), over all
the window's device seconds, in % (``h100bench/spans.py``).  Left out
unless the window holds one span a step."""

from h100bench.spans import share


def read(run):
    return share(run, "adamw_share.train", "adamw.update", "total_s", len(run.items))
