"""The traced run's device trace, reduced to what the per-layer metrics read.

``torch.profiler`` records the window with CPU and CUDA activity.  Its
raw kineto events are read directly (``prof.events()`` builds a tree of
every event, which takes minutes at millions of launches).  Device
activity is every CUDA event that is not a user annotation: kernels,
copies and memsets.  The benchmark's own ``record_function`` spans
(:data:`SPANS`) label what the host was doing, and the ``window`` span
marks the measured window in the profiler's clock.
"""

from __future__ import annotations

import bisect
import contextlib
from typing import Dict, List, Optional, Tuple

import torch

#: the benchmark's spans around its calls into the program
SPANS = ("prefill", "train_step", "to_host")
WINDOW = "window"
TOP = 10


def span(name: str, on: bool):
    """A ``record_function`` span when tracing, else nothing."""
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


class Trace:
    """Device intervals and host spans of one traced window.

    ``busy_s``: seconds in which some device activity ran (the union of
    the intervals) inside the window; ``window_s``: the window's length;
    ``kernels``: ``{name: (count, seconds)}``; ``breakdown``: the device
    operations that took most time and the idle time by the host span it
    fell in."""

    def __init__(self, device: List[Tuple[int, int, str]], spans: List[Tuple[int, int, str]],
                 window: Tuple[int, int]):
        w0, w1 = window
        self.window_s = (w1 - w0) / 1e9
        self.kernels: Dict[str, Tuple[int, float]] = {}
        for s, e, name in device:
            n, t = self.kernels.get(name, (0, 0.0))
            self.kernels[name] = (n + 1, t + (e - s) / 1e9)
        merged: List[List[int]] = []
        for s, e, _ in sorted(device):
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) / 1e9
        spans = sorted(spans)
        starts = [s for s, _, _ in spans]
        self.idle: Dict[str, float] = {}
        prev = w0
        for s, e in merged + [[w1, w1]]:
            if s > prev:
                self._idle(spans, starts, prev, s)
            prev = max(prev, e)

    def _idle(self, spans, starts, a: int, b: int) -> None:
        """Adds the idle interval [a, b) to the host spans it overlaps; what
        no span covers is the benchmark's own ``loop``."""
        k = max(0, bisect.bisect_right(starts, a) - 1)
        covered = 0
        while k < len(spans) and spans[k][0] < b:
            lo, hi = max(a, spans[k][0]), min(b, spans[k][1])
            if hi > lo:
                name = spans[k][2]
                self.idle[name] = self.idle.get(name, 0.0) + (hi - lo) / 1e9
                covered += hi - lo
            k += 1
        if b - a > covered:
            self.idle["loop"] = self.idle.get("loop", 0.0) + (b - a - covered) / 1e9

    def matching(self, token: str) -> Tuple[int, float]:
        """Count and seconds of the device activities whose name holds ``token``."""
        n = t = 0
        for name, (c, s) in self.kernels.items():
            if token in name:
                n, t = n + c, t + s
        return n, t

    def breakdown(self) -> Dict[str, list]:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[name[:160], s] for name, (_, s) in ops],
                "idle_gaps": [[label, s] for label, s in gaps]}


class Profiler:
    """Profiles a window; :meth:`trace` reduces it after it has closed."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        return False

    def trace(self) -> Optional[Trace]:
        from torch.autograd import DeviceType

        cuda = DeviceType.CUDA
        device, spans, window = [], [], None
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                if not e.is_user_annotation():
                    s = e.start_ns()
                    device.append((s, s + e.duration_ns(), e.name()))
            elif e.is_user_annotation():
                name = e.name()
                if name == WINDOW:
                    window = (e.start_ns(), e.end_ns())
                elif name in SPANS:
                    spans.append((e.start_ns(), e.end_ns(), name))
        if window is None:
            return None
        return Trace(device, spans, window)
