"""``moe_share.deepseek_prefill``: the device seconds charged to the span
``deepseek.moe`` and to what it holds (a whole MoE layer on the card's held
experts: its norm, the router with its group limit, the dispatch, the
grouped GEMMs, the combine, the shared expert, the residual), over all the
window's device seconds, in % (``h100bench/spans.py``).  Left out unless the
window holds one span an MoE layer call the port counted in it
(``models.moe_dropless.calls``, read by the driver's ``work``)."""

from h100bench.spans import share


def read(run):
    return share(run, "moe_share.deepseek_prefill", "deepseek.moe", "total_s",
                 run.work.get("moe_calls"))
