"""The program spans' reduction (``h100bench/spans.py``) and its readers,
on synthetic profiler events: what each device activity is charged to,
the shares' base, the idle split, the benchmark's own reduction left as
it was, and each reader left out where the spans disagree with the calls
made."""

from __future__ import annotations

import types

import pytest
import torch

from h100bench.tests.bench_root import REPO

from h100bench import harness, readers, spans  # noqa: E402  (bench_root puts the paths in place)
from h100bench.trace import Profiler, Trace  # noqa: E402

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
MAIN, AUTOGRAD = 1, 2
US = 1000  # ns


class Ev:
    """A kineto event as the reductions read it."""

    def __init__(self, name, start, end, device=CPU, annotation=False, corr=0, thread=MAIN,
                 seq=-1, fwd_thread=0):
        self._v = dict(name=name, start_ns=start * US, end_ns=end * US,
                       duration_ns=(end - start) * US, device_type=device,
                       is_user_annotation=annotation, correlation_id=corr, start_thread_id=thread,
                       sequence_nr=seq, fwd_thread_id=fwd_thread)

    def __getattr__(self, key):
        v = self._v[key]
        return lambda: v


def span(name, start, end, thread=MAIN):
    return Ev(name, start, end, annotation=True, thread=thread)


def kernel(name, start, end, corr):
    return Ev(name, start, end, device=CUDA, corr=corr)


def launch(t, corr, thread=MAIN):
    return Ev("cudaLaunchKernel", t, t + 1, corr=corr, thread=thread)


def benchmark_events():
    """The window and the benchmark's spans, kernels with their launches,
    and a GPU-side annotation (which is not device activity)."""
    return [
        span("window", 0, 1000), span("train_step", 0, 600), span("to_host", 600, 1000),
        kernel("k_scan", 200, 210, 1), kernel("k_pass", 210, 230, 2),
        kernel("k_head", 230, 235, 3), kernel("k_bwd_mul", 700, 740, 4),
        kernel("k_bwd_scan", 740, 800, 5), kernel("k_stray", 850, 860, 6),
        kernel("k_lost", 900, 905, 99),
        Ev("mamba.block", 200, 235, device=CUDA, annotation=True),
    ]


def program_events():
    """The program's spans, launches, forward ops and autograd events: a
    forward on the main thread, its backward on autograd's thread."""
    return [
        span("model.loss", 0, 100), span("mamba.block", 10, 60), span("ssd_scan", 20, 30),
        launch(25, 1), launch(40, 2), launch(5, 3),
        # seq 7: an op of model.loss, then the mul of the block that creates node 7
        Ev("aten::to", 4, 6, seq=7), Ev("aten::mul", 45, 50, seq=7),
        Ev("autograd::engine::evaluate_function: MulBackward0", 300, 320, thread=AUTOGRAD,
           seq=7, fwd_thread=MAIN),
        Ev("MulBackward0", 302, 318, thread=AUTOGRAD, seq=7, fwd_thread=MAIN),
        launch(305, 4, AUTOGRAD),
        Ev("autograd::engine::evaluate_function: SSDScanBackward", 390, 510, thread=AUTOGRAD,
           seq=8, fwd_thread=MAIN),
        span("ssd_scan.backward", 400, 500, AUTOGRAD), launch(450, 5, AUTOGRAD),
        # a launch in an autograd event whose forward op was never recorded
        Ev("autograd::engine::evaluate_function: AddBackward0", 520, 530, thread=AUTOGRAD,
           seq=40, fwd_thread=MAIN), launch(525, 6, AUTOGRAD),
    ]


def events():
    return benchmark_events() + program_events()


def test_charged_to_the_innermost_span_on_the_launching_thread():
    ps = spans.reduce(events())
    assert ps.spans["ssd_scan"] == (1, pytest.approx(10e-6), pytest.approx(10e-6))
    # the block's own pass (20 us), its mul's backward (40 us), its scan (10 us)
    assert ps.spans["mamba.block"] == (1, pytest.approx(70e-6), pytest.approx(60e-6))
    assert ps.spans["model.loss"] == (1, pytest.approx(75e-6), pytest.approx(5e-6))


def test_backward_linked_through_the_forward_ops_sequence_number():
    """The backward mul lies in no span on autograd's thread: it goes to
    the span of the last forward op with its (thread, sequence number),
    the block's mul, not model.loss's earlier op; the backward node's own
    record is no forward op; a span on autograd's thread comes first."""
    ps = spans.reduce(events())
    assert ps.spans["ssd_scan.backward"] == (1, pytest.approx(60e-6), pytest.approx(60e-6))
    without = [e for e in events() if e.name() != "aten::mul"]
    ps = spans.reduce(without)
    # node 7's creator missing: the mul's backward goes to model.loss's op
    assert ps.spans["mamba.block"][2] == pytest.approx(20e-6)
    assert ps.spans["model.loss"][2] == pytest.approx(45e-6)


def test_unattributed_activity():
    """No launch recorded, a launch in no span and no autograd event's
    reach, a launch whose forward op is unknown: none is charged."""
    ps = spans.reduce(events())
    assert ps.unattributed_s == pytest.approx(15e-6)  # k_stray and k_lost
    extra = events() + [kernel("k_free", 950, 960, 7), launch(700, 7)]
    assert spans.reduce(extra).unattributed_s == pytest.approx(25e-6)


def test_shares_add_up_to_the_device_seconds():
    ps = spans.reduce(events())
    assert ps.device_s == pytest.approx(150e-6)
    assert all(self_s <= total_s + 1e-15 for _, total_s, self_s in ps.spans.values())
    assert sum(s for _, _, s in ps.spans.values()) + ps.unattributed_s == pytest.approx(
        ps.device_s)
    shares = sum(ps.share(n, "self_s") for n in ps.spans)
    assert shares + 100 * ps.unattributed_s / ps.device_s == pytest.approx(100.0)


def test_device_time_is_clipped_to_the_window():
    ps = spans.reduce(events() + [kernel("k_late", 990, 1010, 1)])
    assert ps.spans["ssd_scan"][1] == pytest.approx(20e-6)
    assert ps.device_s == pytest.approx(160e-6)


def _trace(evs) -> Trace:
    prof = Profiler()
    prof._prof = types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=types.SimpleNamespace(events=lambda: evs)))
    return prof.trace()


def test_idle_gaps_keep_their_sum_and_name_the_program_span():
    """Each gap's part in a benchmark span goes to the program span that
    launched the activity ending it; what no span covers stays ``loop``;
    the sum is window_s - busy_s with or without the program's events."""
    before, after = _trace(benchmark_events()), spans.reduce(events())
    gap = before.window_s - before.busy_s
    assert sum(before.idle.values()) == pytest.approx(gap)
    assert sum(spans.reduce(benchmark_events()).idle.values()) == pytest.approx(gap)
    assert sum(after.idle.values()) == pytest.approx(gap)
    assert spans.reduce(benchmark_events()).idle == pytest.approx(before.idle)
    # [0, 200) ends at k_scan, launched in ssd_scan; the rest has no program span
    assert after.idle == pytest.approx({"ssd_scan": 200e-6, "train_step": 365e-6,
                                        "to_host": 285e-6})
    loop = benchmark_events()[1:] + [span("window", -50, 1000)]
    assert spans.reduce(loop + program_events()).idle["loop"] == pytest.approx(50e-6)


def test_the_benchmarks_reduction_is_unchanged_by_the_programs_events():
    """busy_s, window_s, kernels, idle and the accepted readers read the
    same with the program's spans, launches and autograd events added."""
    a, b = _trace(benchmark_events()), _trace(events())
    assert (a.busy_s, a.window_s, a.kernels, a.idle) == (b.busy_s, b.window_s, b.kernels,
                                                         b.idle)
    assert a.breakdown() == b.breakdown()
    ctx = harness.Context(REPO, {}, {}, {}, {}, 1, torch.device("cpu"), True, log=lambda s: None)
    for tr in (a, b):
        run = harness.Run(ctx, [], 1.0, {"ssd_scan_calls": 1, "ssd_scan_bound_s": 5e-6,
                                         "model_flops": 1e9}, {"ssd_scan": 1}, tr)
        assert readers.device_idle(run) == pytest.approx(100 * (1 - 0.000150 / 0.001))
        assert readers.kernel_roofline(run, {"k_scan": 1}, "ssd_scan") == pytest.approx(50.0)


# ------------------------------------------------------------------ readers --

def _read(metric, evs, items, work, traffic=None, counted=None, monkeypatch=None):
    """``metric``'s reader over ``evs``, with a live profiler in this frame."""
    from repro_torch.kernels.ssd_scan import ops

    if counted is not None:
        monkeypatch.setattr(ops.SSDScan, "backward_calls", counted)
    prof = Profiler()  # noqa: F841  (found in this frame by spans.live_profiler)
    prof._prof = types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=types.SimpleNamespace(events=lambda: evs)))
    tr = prof.trace()
    logs = []
    ctx = harness.Context(REPO, {}, {}, {"n_layers": 1}, traffic or {}, 1, torch.device("cpu"),
                          True, log=logs.append)
    run = harness.Run(ctx, [harness.Item(0.0, 1.0, 1)] * items, 1.0, work, {}, tr)
    reader = harness.load_module(REPO / "h100bench" / "metrics" / f"{metric}.py",
                                 f"test_metric_{metric.replace('.', '_')}")
    return reader.read(run), logs


def _train_step_events(steps):
    """``steps`` windows' worth of one training step each (one layer)."""
    evs = [span("window", 0, 1000 * steps)]
    for k in range(steps):
        o = 1000 * k
        evs += [span("model.loss", o, o + 100), span("mamba.block", o + 10, o + 60),
                span("ssd_scan", o + 20, o + 30), launch(o + 25, 10 * k + 1),
                kernel("ssd_scan_kernel", o + 200, o + 210, 10 * k + 1),
                span("mamba.block", o + 300, o + 350, AUTOGRAD),
                span("ssd_scan", o + 310, o + 320, AUTOGRAD),
                span("ssd_scan.backward", o + 400, o + 500, AUTOGRAD),
                launch(o + 450, 10 * k + 2, AUTOGRAD),
                kernel("k_bwd", o + 500, o + 560, 10 * k + 2),
                span("adamw.update", o + 600, o + 700), launch(o + 650, 10 * k + 3),
                kernel("k_adam", o + 650, o + 680, 10 * k + 3)]
    return evs


@pytest.mark.parametrize("metric,want", [
    ("mamba_passes_share.train", 0.0), ("ssd_backward_share.train", 60.0),
    ("adamw_share.train", 30.0)])
def test_readers_read_their_spans(metric, want, monkeypatch):
    """Two steps of one layer, 100 us of device a step: the scan 10 (in the
    block), the backward 60, AdamW 30; the block's own passes none."""
    got, logs = _read(metric, _train_step_events(2), 2, {"ssd_scan_calls": 4},
                      {"checked_steps": 3}, counted=5, monkeypatch=monkeypatch)
    assert got == pytest.approx(want)
    assert any("rest: ssd_scan 10.0000%, projections 0.0000%, unattributed 0.0000%" in line
               for line in logs), logs


MISMATCHES = [(m, case) for m in ("mamba_passes_share.train", "ssd_backward_share.train",
                                  "adamw_share.train")
              for case in ("a call more", "no program spans")]
MISMATCHES.append(("ssd_backward_share.train", "counter off"))


@pytest.mark.parametrize("metric,case", MISMATCHES)
def test_readers_leave_out_a_count_mismatch(metric, case, monkeypatch):
    """Each reader returns None (and logs it) where the window's spans do
    not count the calls made, or the port recorded no span (the parent
    commit's program), or the backward's counter disagrees."""
    evs, items, counted = _train_step_events(2), 2, 5
    if case == "a call more":
        items = 3
    if case == "no program spans":
        evs = [e for e in evs if not e.is_user_annotation() or e.name() == "window"]
    if case == "counter off":
        counted = 4
    got, logs = _read(metric, evs, items, {"ssd_scan_calls": 2 * items}, {"checked_steps": 3},
                      counted=counted, monkeypatch=monkeypatch)
    assert got is None and any("left out" in line for line in logs), logs


def test_prefill_reader_and_no_live_profiler():
    evs = [span("window", 0, 1000), span("model.prefill", 0, 100),
           span("mamba.block", 10, 60), span("ssd_scan", 20, 30), launch(25, 1), launch(40, 2),
           kernel("ssd_scan_kernel", 200, 210, 1), kernel("k_pass", 210, 240, 2)]
    got, _ = _read("mamba_passes_share.prefill", evs, 1, {"ssd_scan_calls": 1})
    assert got == pytest.approx(75.0)
    ctx = harness.Context(REPO, {}, {}, {}, {}, 1, torch.device("cpu"), True, log=lambda s: None)
    run = harness.Run(ctx, [], 1.0, {"ssd_scan_calls": 1}, {}, _trace(evs))
    assert spans.of_run(run) is None and spans.share(run, "m", "mamba.block", "self_s", 1) is None
