"""``mla_attention_roofline.deepseek_prefill``: the least time of the window's
MLA attention calls at the tensor cores' bf16 peak (``h100bench/work/
deepseek_flops.py``: 2 B H L (L + 1) / 2 (192 + 128) FLOP a call, Q K^T at
192 and P V at 128 over the causal half), over the device seconds charged to
the span ``flash_attention`` (the flash kernel at (192, 128), one launch a
call), in %.  Left out unless the window holds one ``flash_attention`` span
a launch that ``flash_attn_cuda.launches`` counted in it, and as many
launches of the kernel ``flash_fwd_bf16`` in the trace."""

from h100bench.spans import of_run

KERNEL = "flash_fwd_bf16"


def read(run):
    calls = run.work.get("flash_calls")
    ps = of_run(run)
    if ps is None or not calls:
        return None
    count, seconds, _ = ps.spans.get("flash_attention", (0, 0.0, 0.0))
    launched, kernel_s = run.trace.matching(KERNEL)
    if count != calls or launched != calls or seconds <= 0:
        run.ctx.log(f"[spans] mla_attention_roofline.deepseek_prefill: {count} flash_attention "
                    f"spans and {launched} {KERNEL} launches in the window, {calls} counted; "
                    f"left out")
        return None
    run.ctx.log(f"[spans] flash_attention {seconds / calls * 1e3:.5f} ms a call ({KERNEL} "
                f"{kernel_s / calls * 1e3:.5f} ms); bound "
                f"{run.work['flash_bound_s'] / calls * 1e3:.5f} ms")
    return 100.0 * run.work["flash_bound_s"] / seconds
