"""``moe_share.nemotron_prefill``: the device seconds charged to the span
``nemotron_h.moe`` and to what it holds (a whole MoE layer: its norm, the
router, the dispatch, the routed experts, the combine, the shared expert),
over all the window's device seconds, in % (``h100bench/spans.py``).  Left
out unless the window holds one span an MoE layer call the port counted in it
(``models.moe_dropless.calls``, read by the driver's ``work``)."""

from h100bench.spans import share


def read(run):
    return share(run, "moe_share.nemotron_prefill", "nemotron_h.moe", "total_s",
                 run.work.get("moe_calls"))
