"""The program's spans in the traced window, with the device's time charged to them.

The port records ``record_function`` spans at its layer boundaries
(``repro_torch.spans``: ``model.prefill``, ``model.loss``,
``mamba.block``, ``mamba.in_proj``, ``mamba.out_proj``, ``ssd_scan``,
``ssd_scan.backward``, ``adamw.update``) whenever a profiler records.
They share the profiler's clock with the device's activity.  Every
user annotation that is not the benchmark's own (``trace.SPANS``,
``trace.WINDOW``) is a program span.  Each device activity in the window
is charged through the CUDA runtime or driver call that launched it
(their ``correlation_id``):

1. to the innermost program span that encloses the launch on the
   launching thread;
2. otherwise, where the launch lies in an ``autograd::engine::
   evaluate_function:`` event (the backward of a forward op), to the
   innermost program span that enclosed the forward op of that event's
   ``(fwd_thread_id, sequence_nr)`` on its thread; that op is the last
   forward op recorded with that pair, since the op that creates an
   autograd node takes the number and moves the thread's counter on;
3. otherwise to nothing (unattributed).

So the backward of a block's passes counts to ``mamba.block``, that of
its projections to ``mamba.in_proj`` / ``mamba.out_proj``, although
autograd runs them on another thread.  The events are read once, and no
tree of them is built: a thread's spans and autograd events nest, and a
lookup walks up from the last one that starts before the time asked.

The harness hands a per-layer reader the run, not the profiler: the
reduction finds the live ``trace.Profiler`` in the caller's frames
(``harness.run_cell`` holds it while the readers run), reduces its events
once, and keeps the result on the run.
"""

from __future__ import annotations

import bisect
import sys
import time
import types
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from h100bench.trace import SPANS, WINDOW, Profiler, Trace

EVALUATE = "autograd::engine::evaluate_function:"
#: the spans of the projections and of the scan, logged beside each share
PROJECTIONS = ("mamba.in_proj", "mamba.out_proj")
SCAN = "ssd_scan"
SCAN_KERNELS = ("ssd_scan_cb_kernel", "ssd_scan_kernel")


class Nest:
    """Intervals of one thread that nest (spans, autograd events), each
    with its parent: the innermost one holding a time is found from the
    last that starts at or before it, walking up."""

    def __init__(self, items: List[Tuple[int, int, object]]):
        items.sort(key=lambda it: (it[0], -it[1]))
        self.starts = [s for s, _, _ in items]
        self.ends = [e for _, e, _ in items]
        self.data = [d for _, _, d in items]
        self.parent: List[int] = []
        stack: List[int] = []
        for i, (s, e) in enumerate(zip(self.starts, self.ends)):
            while stack and self.ends[stack[-1]] <= s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def innermost(self, t: int) -> int:
        """The index of the innermost interval holding ``t``, or -1."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.ends[i] < t:
            i = self.parent[i]
        return i


class ProgramSpans:
    """The window's program spans and the device seconds charged to them.

    ``spans``: ``{name: (count, total_s, self_s)}``, the count of spans
    that start in the window; ``self_s`` the device seconds charged to
    the span itself, ``total_s`` those charged to it or to a span nested
    in it.  ``device_s``: the summed duration of the window's device
    activities (each clipped to the window), the shares' common base:
    the spans' ``self_s`` and ``unattributed_s`` add up to it.  ``idle``:
    the benchmark's idle split (``trace.Trace``'s rule), where the part of
    a gap that fell in a benchmark span goes to the innermost program span
    that enclosed the launch ending the gap, if there is one; its sum is
    the benchmark's."""

    def __init__(self, device: List[Tuple[int, int, str, int]],
                 bench: List[Tuple[int, int, str]], window: Tuple[int, int],
                 program: List[Tuple[int, int, str, int]],
                 launches: Dict[int, Tuple[int, int]],
                 evaluate: List[Tuple[int, int, int, int, int]],
                 forward: Dict[Tuple[int, int], int]):
        w0, w1 = window
        by_thread: Dict[int, List] = {}
        for s, e, name, th in program:
            by_thread.setdefault(th, []).append((s, e, name))
        self._spans = {th: Nest(v) for th, v in by_thread.items()}
        by_thread = {}
        for s, e, th, fwd_th, seq in evaluate:
            by_thread.setdefault(th, []).append((s, e, (fwd_th, seq)))
        evals = {th: Nest(v) for th, v in by_thread.items()}

        counts: Dict[str, int] = {}
        for s, _, name, _ in program:
            if w0 <= s <= w1:
                counts[name] = counts.get(name, 0) + 1
        charged: Dict[Tuple[int, int], float] = {}  # (thread, span index) -> seconds
        self.device_s = self.unattributed_s = 0.0
        for s, e, _, corr in device:
            d = (min(e, w1) - max(s, w0)) / 1e9
            if d <= 0:
                continue
            self.device_s += d
            at = self.charge(launches.get(corr), evals, forward)
            if at is None:
                self.unattributed_s += d
            else:
                charged[at] = charged.get(at, 0.0) + d

        total: Dict[str, float] = {}
        self_s: Dict[str, float] = {}
        for (th, i), d in charged.items():
            nest = self._spans[th]
            self_s[nest.data[i]] = self_s.get(nest.data[i], 0.0) + d
            seen = set()
            while i >= 0:
                name = nest.data[i]
                if name not in seen:
                    seen.add(name)
                    total[name] = total.get(name, 0.0) + d
                i = nest.parent[i]
        self.spans = {n: (counts.get(n, 0), total.get(n, 0.0), self_s.get(n, 0.0))
                      for n in sorted(set(counts) | set(total))}
        self.idle = self._idle(device, bench, window, launches)

    def charge(self, launch: Optional[Tuple[int, int]], evals: Dict[int, Nest],
               forward: Dict[Tuple[int, int], int]) -> Optional[Tuple[int, int]]:
        """``(thread, span index)`` that a launch at ``(time, thread)`` is charged to."""
        if launch is None:
            return None
        t, th = launch
        i = self.enclosing(t, th)
        if i >= 0:
            return th, i
        nest = evals.get(th)
        k = nest.innermost(t) if nest else -1
        if k < 0:
            return None
        fwd_th, seq = nest.data[k]
        t_fwd = forward.get((fwd_th, seq))
        if t_fwd is None:
            return None
        i = self.enclosing(t_fwd, fwd_th)
        return (fwd_th, i) if i >= 0 else None

    def enclosing(self, t: int, th: int) -> int:
        nest = self._spans.get(th)
        return nest.innermost(t) if nest else -1

    def _idle(self, device, bench, window, launches) -> Dict[str, float]:
        """The idle split of :class:`trace.Trace` (its own rule, gap by gap),
        benchmark spans relabelled by the program span of each gap's ending
        launch."""
        w0, w1 = window
        bench = sorted(bench)
        starts = [s for s, _, _ in bench]
        merged: List[List] = []  # [start, end, correlation id of the first activity]
        for s, e, _, corr in sorted(device):
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e, corr])
        idle: Dict[str, float] = {}
        prev = w0
        for s, e, corr in merged + [[w1, w1, None]]:
            if s > prev:
                gap = types.SimpleNamespace(idle={})
                Trace._idle(gap, bench, starts, prev, s)
                launch = launches.get(corr)
                i = self.enclosing(*launch) if launch else -1
                label = self._spans[launch[1]].data[i] if i >= 0 else None
                for name, sec in gap.idle.items():
                    name = label if label and name != "loop" else name
                    idle[name] = idle.get(name, 0.0) + sec
            prev = max(prev, e)
        return idle

    def share(self, name: str, field: str) -> Optional[float]:
        """``field`` (``"total_s"`` or ``"self_s"``) of ``name`` over ``device_s``, in %."""
        if self.device_s <= 0:
            return None
        _, total, self_ = self.spans.get(name, (0, 0.0, 0.0))
        return 100.0 * (total if field == "total_s" else self_) / self.device_s


def reduce(events: Iterable) -> Optional[ProgramSpans]:
    """:class:`ProgramSpans` of a profile's kineto events (one pass), or
    None where they hold no window span."""
    device, bench, program, evaluate = [], [], [], []
    launches: Dict[int, Tuple[int, int]] = {}
    forward: Dict[Tuple[int, int], int] = {}
    window = None
    cuda = torch.autograd.DeviceType.CUDA
    for e in events:
        if e.device_type() == cuda:  # as trace.Profiler.trace reads the device
            if not e.is_user_annotation():
                s = e.start_ns()
                device.append((s, s + e.duration_ns(), e.name(), e.correlation_id()))
            continue
        if e.is_user_annotation():
            name = e.name()
            if name == WINDOW:
                window = (e.start_ns(), e.end_ns())
            elif name in SPANS:
                bench.append((e.start_ns(), e.end_ns(), name))
            else:
                program.append((e.start_ns(), e.end_ns(), name, e.start_thread_id()))
            continue
        name = e.name()
        if is_launch(name):
            launches[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
            continue
        seq = e.sequence_nr()
        if seq < 0:
            continue
        if name.startswith(EVALUATE):
            evaluate.append((e.start_ns(), e.end_ns(), e.start_thread_id(), e.fwd_thread_id(), seq))
        elif e.fwd_thread_id() == 0:  # a forward op (a backward node's own record has one)
            key = (e.start_thread_id(), seq)
            s = e.start_ns()
            if forward.get(key, -1) < s:
                forward[key] = s
    if window is None:
        return None
    return ProgramSpans(device, bench, window, program, launches, evaluate, forward)


def is_launch(name: str) -> bool:
    """A CUDA runtime or driver call (``cudaLaunchKernel``, ``cuLaunchKernel``,
    ``cudaMemcpyAsync``, ...): the host side of a device activity, which
    shares its ``correlation_id``.  (Read from the name: the kineto events
    of torch 2.11 have no ``activity_type``.)"""
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def live_profiler() -> Optional[Profiler]:
    """The :class:`trace.Profiler` a caller's frame holds, if any."""
    f = sys._getframe(1)
    while f is not None:
        for v in f.f_locals.values():
            if isinstance(v, Profiler):
                return v
        f = f.f_back
    return None


def of_run(run) -> Optional[ProgramSpans]:
    """The run's :class:`ProgramSpans`, reduced once and kept on the run."""
    if "program_spans" in vars(run):
        return run.program_spans
    prof = live_profiler()
    ps = None
    if prof is None:
        run.ctx.log("[spans] no live profiler: no program spans")
    else:
        t0 = time.perf_counter()
        ps = reduce(prof._prof.profiler.kineto_results.events())
        if ps is not None:
            top = sorted(ps.idle.items(), key=lambda kv: -kv[1])[:5]
            run.ctx.log(f"[spans] reduced in {time.perf_counter() - t0:.3f} s: device "
                        f"{ps.device_s:.6f} s, unattributed {ps.unattributed_s:.6f} s; "
                        f"(count, total_s, self_s) {ps.spans}; idle by program span {top}")
    run.program_spans = ps
    return ps


def share(run, metric: str, name: str, field: str, calls: Optional[int]) -> Optional[float]:
    """``name``'s ``field`` over the window's device seconds, in %, or None
    (logged) where the window's count of ``name`` is not ``calls``, the
    calls the benchmark made.  Logs the rest of the split beside it."""
    ps = of_run(run)
    if ps is None or not calls:
        return None
    count = ps.spans.get(name, (0, 0.0, 0.0))[0]
    if count != calls:
        run.ctx.log(f"[spans] {metric}: {count} {name} spans in the window, {calls} calls made; "
                    f"left out")
        return None
    value = ps.share(name, field)
    if value is None:
        return None
    proj = sum(ps.share(p, "total_s") for p in PROJECTIONS)
    n_scan, scan_s, _ = ps.spans.get(SCAN, (0, 0.0, 0.0))
    kern_n = kern_s = 0
    for k in SCAN_KERNELS:
        n, s = run.trace.matching(k)
        kern_n, kern_s = kern_n + n, kern_s + s
    run.ctx.log(
        f"[spans] {metric} {value:.4f}% ({name} {field}); rest: {SCAN} "
        f"{ps.share(SCAN, 'total_s'):.4f}%, projections {proj:.4f}%, unattributed "
        f"{100.0 * ps.unattributed_s / ps.device_s:.4f}%; {SCAN} span "
        f"{scan_s / max(n_scan, 1) * 1e3:.5f} ms a call ({n_scan} calls), kernels by name "
        f"{kern_s / max(n_scan, 1) * 1e3:.5f} ms a call ({kern_n} launches)")
    return value


def backward_counted(run) -> bool:
    """Whether the port's ``SSDScan.backward_calls`` counted every backward
    of the process's training steps (the set-up's ``checked_steps`` and the
    window's, a layer each; one run is one process), read from the loaded
    module; logged where it did not."""
    ops = sys.modules.get("repro_torch.kernels.ssd_scan.ops")
    counted = getattr(getattr(ops, "SSDScan", None), "backward_calls", None)
    steps = run.ctx.traffic.get("checked_steps", 0) + len(run.items)
    want = steps * run.ctx.widths["n_layers"]
    if counted != want:
        run.ctx.log(f"[spans] SSDScan.backward_calls {counted}, {steps} steps of "
                    f"{run.ctx.widths['n_layers']} layers made; left out")
    return counted == want
