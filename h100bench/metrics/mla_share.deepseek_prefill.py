"""``mla_share.deepseek_prefill``: the device seconds charged to the span
``mla.attention`` and to what it holds (a whole MLA block: its norm, the
low-rank q and kv projections and their norms, the rope, the k assembly, the
flash kernel, W_o and the residual), over all the window's device seconds,
in % (``h100bench/spans.py``).  Left out unless the window holds one span an
MLA block the port counted in it (``models.deepseek_v3.mla.calls``, read by
the driver's ``work``)."""

from h100bench.spans import share


def read(run):
    return share(run, "mla_share.deepseek_prefill", "mla.attention", "total_s",
                 run.work.get("mla_calls"))
