"""``shared_block_share.zamba2_prefill``: the device seconds charged to the
span ``zamba2.shared_block`` and to what it holds (the concat, the norms,
attention, the MLP, the adapter, the site's linear), over all the window's
device seconds, in % (``h100bench/spans.py``).  Left out unless the window
holds one span a shared-block call the port counted in it
(``models.zamba2.shared_block.calls``, read by the driver's ``work``)."""

from h100bench.spans import share


def read(run):
    return share(run, "shared_block_share.zamba2_prefill", "zamba2.shared_block", "total_s",
                 run.work.get("shared_block_calls"))
