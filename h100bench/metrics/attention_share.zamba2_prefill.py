"""``attention_share.zamba2_prefill``: the device seconds charged to the span
``flash_attention`` and to what it holds (``models.common.flash_attention``,
one call a site), over all the window's device seconds, in %
(``h100bench/spans.py``).  Left out unless the window holds one span a
shared-block call the port counted in it (``models.zamba2.shared_block.calls``,
read by the driver's ``work``)."""

from h100bench.spans import share


def read(run):
    return share(run, "attention_share.zamba2_prefill", "flash_attention", "total_s",
                 run.work.get("shared_block_calls"))
