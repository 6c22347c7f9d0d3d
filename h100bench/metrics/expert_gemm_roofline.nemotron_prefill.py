"""``expert_gemm_roofline.nemotron_prefill``: the least time of the window's
routed expert products (``h100bench/work/moe_groups.py``, over the routes the
port counted: ``models.moe_dropless.routed_rows``), over the device seconds
charged to the span ``moe.experts`` and to what it holds (the up and down
products and relu²), in %.  The span is read, not kernel names, so the
grouped GEMM's own name does not matter.  Left out unless the window holds
one span an MoE layer call the port counted in it."""

from h100bench.spans import of_run


def read(run):
    calls = run.work.get("moe_calls")
    ps = of_run(run)
    if ps is None or not calls:
        return None
    count, seconds, _ = ps.spans.get("moe.experts", (0, 0.0, 0.0))
    if count != calls or seconds <= 0:
        run.ctx.log(f"[spans] expert_gemm_roofline.nemotron_prefill: {count} moe.experts spans "
                    f"in the window, {calls} calls made; left out")
        return None
    run.ctx.log(f"[spans] moe.experts {seconds / calls * 1e3:.5f} ms a call over "
                f"{run.work['moe_routed_rows'] // calls} routes; bound "
                f"{run.work['moe_experts_bound_s'] / calls * 1e3:.5f} ms")
    return 100.0 * run.work["moe_experts_bound_s"] / seconds
