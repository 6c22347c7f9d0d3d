"""What the per-layer metric files share: shares of the peak and of a
kernel's roofline, the device's idle share.  Each returns None where the
traced run has nothing to read, so the metric is left out of the line."""

from __future__ import annotations

from typing import Dict, Optional

from h100bench.work.roofline import PEAK


def mfu(run, dtype: str = "bfloat16") -> Optional[float]:
    """The model FLOPs of the window's items over its span at the peak, in %."""
    flops = run.work.get("model_flops")
    if not flops or run.span_s <= 0:
        return None
    return 100.0 * flops / (run.span_s * PEAK[dtype])


def device_idle(run) -> Optional[float]:
    """The share of the traced window in which no kernel or copy ran, in %."""
    if run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def kernel_roofline(run, kernels: Dict[str, int], work_key: str) -> Optional[float]:
    """The least time of the window's calls (``run.work[work_key +
    "_bound_s"]``) over the device time of the kernels a call launches
    (``kernels``: each name and its launches a call), in %.

    The calls are those the benchmark made (``run.work[work_key +
    "_calls"]``).  The port's launch counter ``run.counters[work_key]``
    has to have counted them, and the trace has to hold each kernel that
    many times its launches a call; otherwise the kernels' time is not
    that of these calls, and nothing is returned."""
    calls = run.work.get(work_key + "_calls")
    if not calls:
        return None
    counted = run.counters.get(work_key)
    seconds, recorded = 0.0, {}
    for k in kernels:
        recorded[k], s = run.trace.matching(k)
        seconds += s
    run.ctx.log(f"[trace] {work_key}: {calls} calls made, counter {counted}, recorded {recorded}; "
                f"{seconds / calls * 1e3:.5f} ms a call")
    if counted != calls or any(recorded[k] != calls * n for k, n in kernels.items()):
        run.ctx.log(f"[trace] {work_key}: the launches do not match the calls; no roofline")
        return None
    return 100.0 * run.work[work_key + "_bound_s"] / seconds
