#!/usr/bin/env python3
"""Smoke run of the torch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and ``nvcc``; without a card, or without the
repository beside it, it exits non-zero before printing any result.
Phases, each on lines of its own; any failure exits non-zero:

1. card: ``nvidia-smi`` name and power limit, and the torch device;
2. build: the s2d-conv, decode-attention and SSD-scan kernels compiled
   from ``csrc/s2d_conv.cu``, ``csrc/decode_attn.cu`` and
   ``csrc/ssd_scan.cu``, one ``nvcc`` each, started together (seconds of
   each);
3. kernel: each kernel against its plain version on the card.
   s2d-conv (``ref.s2d_conv_ref``): at the ``tests/test_kernels.py``
   shapes and at every pointwise variant layer the ``multicam_heavy`` @
   ``6k_1ws2os`` plans select, for batches 1 and 8 in f32 and bf16;
   tolerances: f32 max|d| <= 1e-4 max|ref| (split-TF32 products summed in
   another order), bf16 <= 2e-2 max|ref| (bf16 output rounding); then
   each main-path GEMM's launch plan (tile, split, blocks) and the
   kernel's time at every split the planner weighs.  Decode attention
   (``ref.decode_attention``): at the ``tests/test_kernels.py`` shapes
   and at the serving shapes of llama3.2-1b (B=8, L=2048, H=32, Hkv=8,
   Dh=64) and gemma-7b (B=8, L=2048, H=16, Hkv=16, Dh=256) with 256 and
   2048 valid positions, in f32 and bf16, the grid sized from the valid
   length as the serving path sizes it from ``pos + 1``; tolerances: f32
   |d| <= 1e-5 + 1e-4 |ref| (another summation order), bf16 max|d| <=
   2e-2 max|ref| (both versions round the softmax weights to bf16, the
   kernel before normalising them).
   SSD scan (``ref.ssd_chunked``): at the ``tests/test_kernels.py`` shapes
   in f32 and bf16 (x, B, C in the dtype; log_a, dt f32, as the model
   feeds them), and at the prefill path's shape (Bt=8, L=4096, H=64,
   P=64, N=128, Q=256) in the model's dtypes and in all-f32; tolerances:
   f32 max|d| < 1e-5 max|ref| at the test shapes (``tests/test_kernels.py``'s),
   1e-4 at the prefill shape (the cumsum of 256 log-decays, taken in
   another order, moves each exp(cum_i - cum_j) by up to ~1e-5
   relative), bf16 output 2e-2 max|ref| (bf16 rounding of y).
   Device times (CUDA-graph replay) of the kernel, the plain version and
   one library call (``torch.matmul`` on the reshaped views;
   ``scaled_dot_product_attention(..., enable_gqa=True)`` on transposed
   copies of the valid positions: yardsticks the port never calls; no
   single PyTorch call computes the SSD scan), the bound max(bytes /
   3.35 TB/s, operations / peak; for s2d-conv in f32 the faster of the
   CUDA cores and split TF32, three products at the TF32 peak; for the
   SSD scan the products it needs: the causal half, and C Bᵀ once per
   batch row and chunk, not per head, its f32 products at the faster of
   the CUDA cores and split TF32, beside the CUDA-core-only figure of
   earlier runs), and the kernel wrapper's cost per call when launched
   back to back from Python.  At the prefill shape, the device kernels of
   an SSD call (``torch.profiler`` over four calls: must be 2, C Bᵀ and
   the scan, each recorded in three or four of the calls, as the profiler
   may drop a window's first event) and each one's time.  At the serving shapes
   the decode kernel and SDPA are also timed cold (calls taking turns
   over copies of the cache twice the 50 MB L2), and the kernels line
   takes those; at the serving shape, the device kernels of one decode
   call (``torch.profiler``: must be 1) and the cold time of every
   split of the cache (1 to 8 blocks a cluster) beside the planner's;
4. main paths, each with its launch count set to 0 just before and read
   just after:
   (i) ``simulate_batch`` on the card for (a) ``multicam_heavy`` @
   ``6k_1ws2os``, terastal, default arrivals, 8 seeds, 1.0 s and (b)
   ``saturation_5x`` @ ``4k_1ws2os``, terastal, poisson, 32 seeds, 0.1 s;
   then the pointwise variant layers of the models that applied variants
   in (a) run through ``run_pointwise_variants`` (the s2d-conv kernel).
   Every lane's fingerprint must equal the host ``simulate(engine="soa")``,
   (a) must apply variants, and the variant outputs must match the plain
   version.  Then one pass of the variant layers under ``torch.profiler``
   (device time, device ops, the kernel's share), and the engine runs
   cell (b) again under it: the device's busy share of the first run's
   wall, and device ops per loop iteration;
   (ii) serving: ``repro_torch.launch.serve`` at the published widths of
   ``llama3.2-1b`` in bf16 (16 layers, d_model 2048, 32 heads over 8 KV
   heads, vocab 128256), batch 8, a 2048-position cache, 256 greedy
   tokens: ``serve.run``'s two halves, ``load`` and ``decode``, so that
   the weights, built once, serve the replay too.  The decode kernel must
   run 16 x 256 times.  The same steps are then replayed through the
   plain attention, fed the kernel run's tokens; every step's logits
   must agree within rms|d| <= 5e-2 rms|ref| and max|d| <= 0.1 max|ref|
   (bf16: the kernel keeps the softmax weights in f32, the plain version
   rounds them, and the difference compounds over layers and steps).
   Beside the plain replay runs a planted fault, the kernel without the
   newest position (its valid length one short from step 1 on), whose gap
   to the plain replay is read against the same limit and printed, not
   held.  Then the
   decode loop runs once more under ``torch.profiler``: the device's busy
   share of the first run's wall, device ops per step, and the decode
   kernel's share of device time;
   (iii) ssm prefill: after the llama weights are freed, ``serve.load`` of
   ``mamba2-1.3b`` at its published widths in bf16 (48 layers, d_model
   2048, d_inner 4096, 64 heads of 64, N=128, chunk 256, vocab 50280,
   tied embeddings) and ``model.prefill(params, {"tokens": ...})`` on B=8
   prompts of L=4096 tokens drawn from a numpy seed (``prefill_32k``,
   B=32 L=32768, cut to B=8 L=4096).  The SSD kernel must run exactly 48
   times.  The same prefill is replayed with ``ssd_scan`` swapped for the
   plain ``ssd_chunked``, and once more with a planted fault (the kernel
   with the state dropped at every chunk boundary, so no inter-chunk
   C S term); the last-position logits of each are read against the
   plain replay.  In bf16 that is a reading, not a check: the two sound
   runs differ by some 4% of the logits (their f32 scans are summed in
   another order, which flips the bf16 rounding of a few outputs per
   layer, and the bf16 residual stream carries each flip through 48
   random layers), and the planted fault moves them by about as much.
   The check is in f32, on the same weights and two of the prompts: the
   kernel within 1e-4 of max|ref| and rms|ref| of the plain replay (f32
   summation order only), the planted fault outside that limit.  Then a
   timed prefill (ms, prompt tokens/s, peak memory) and one under
   ``torch.profiler`` (the device's busy share, the kernel's share of
   device time);
   (iv) ssm decode: ``serve.decode`` of the same model, B=8, 256 greedy
   tokens: no SSD or decode-attention launch (the recurrent step uses
   no kernel); ms/token, tokens/s, and under ``torch.profiler`` the busy
   share and device ops per step.  Then the JAX package's cross-path
   check (``tests/test_model_consistency.py::test_decode_matches_train_forward``)
   at full width and, as there, in f32: one 512-token prompt (two
   chunks) through ``decode_step`` token by token against
   ``model.prefill`` on the same tokens; the last logits within that
   test's |d| <= 2e-4 + 2e-3 |ref|;
   (v) the paper's method (no kernel of the port; the counts must stay
   0): Algorithm 1 (``core/budget_torch``) on the card for every model
   of every catalog scenario on its own platforms, one call each and
   each cell's models as one padded batch, ``rho`` and ``feasible`` equal
   to the numpy ``budget.distribute_budgets`` and budgets within rtol
   1e-5 (the total is summed in another order), with us per call and the
   device ops of one call; the Terastal round (``core/scheduler_torch``,
   one CUDA graph per bucket): ``simulate(engine="soa",
   round_kernel="jax")`` of ``saturation_5x`` @ ``4k_1ws2os``, 0.3 s,
   for each backfill mode, fingerprint-equal to ``round_kernel="python"``,
   its device rounds by NJ bucket (reaching 64), and at states of the
   NJ-16 and NJ-64 buckets the graph replay, the eager ops on the card
   and on the host equal, with us per round beside the host's vectorized
   and scalar rounds and device ops per round (``torch.profiler``); the
   campaign stack: ``Campaign(engine="batch").run()`` of PERF.md's cells
   (a) and (b) with fcfs, edf, dream and terastal over seeds 0-7, every
   ``TrialResult`` field but ``wall_s`` equal to the host ``soa`` grid's,
   trials/s; and ``run_adaptive`` on the batched engine with a journal,
   equal to the host sampler and resumed from its journal with no trial
   run again;
5. the ``{"kernels": [...]}`` line, then the card line, then
   ``{"ok": true, "device": {...}}`` as the last line.

All rows also go to ``chiprun_out/chip_smoke.json``.
"""

import dataclasses
import itertools
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BPS = 3.35e12                      # H100 SXM data sheet
L2_BYTES = 50e6                        # H100 SXM data sheet
PEAK = {"float32": 67e12, "bfloat16": 989e12,   # f32 CUDA cores; bf16 dense tensor
        "tf32": 495e12}                          # dense TF32 tensor
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TEST_SHAPES = [  # (B, H, W, C, K, g), tests/test_kernels.py
    (2, 8, 8, 16, 32, 2), (1, 16, 16, 64, 64, 2), (2, 12, 12, 36, 72, 3),
    (1, 8, 8, 256, 128, 2), (1, 4, 4, 512, 512, 2),
]
DECODE_SHAPES = [  # (B, L, H, Hkv, Dh, valid): tests/test_kernels.py, then serving
    (2, 64, 8, 2, 16, 64), (1, 128, 4, 4, 32, 81), (3, 256, 16, 8, 64, 256),
    (1, 64, 8, 1, 128, 11), (8, 2048, 32, 8, 64, 256), (8, 2048, 32, 8, 64, 2048),
    (8, 2048, 16, 16, 256, 256), (8, 2048, 16, 16, 256, 2048),  # gemma-7b's heads
]
SSD_SHAPES = [  # (Bt, L, H, P, N, Q): tests/test_kernels.py, then the prefill path
    (2, 64, 4, 8, 16, 16), (1, 128, 2, 64, 128, 32), (2, 32, 8, 16, 8, 32),
    (1, 64, 1, 128, 64, 64), (8, 4096, 64, 64, 128, 256),
]
# SSD scan vs ssd_chunked, max|d| / max|ref|: f32 at the test shapes (test_kernels.py),
# f32 at the prefill shape (cumsum of 256 log-decays in another order), bf16 output
SSD_TOL = {"float32": 1e-5, "float32@prefill": 1e-4, "bfloat16": 2e-2}
SERVE = dict(arch="llama3.2-1b", batch=8, ctx=2048, tokens=256)
# logits, kernel run vs plain replay, at every step: rms|d| <= 5e-2 rms|ref| and
# max|d| <= 0.1 max|ref|.  The two runs differ by bf16 rounding of the softmax
# weights, which compounds over 16 layers and over the steps' cached keys and
# values.  A planted fault (the kernel without the newest position) is replayed
# beside it and read against the same limit, as a reading: it does not fail the run.
SERVE_TOL = dict(rms=5e-2, max=0.1)
SSM = dict(arch="mamba2-1.3b", batch=8, prompt=4096, tokens=256, check_prompt=512)
# last-position logits, f32 kernel prefill vs the plain-ssd_chunked replay (see
# docstring)
PREFILL_F32_TOL = dict(rms=1e-4, max=1e-4)
# (v) the paper's method.  Budgets vs numpy: tests/test_budget.py's rtol (the
# card sums the reference total in another order than numpy).
BUDGET_RTOL = 1e-5
MODES = ("ef", "paper", "positive")
SCHEDULERS = ("fcfs", "edf", "dream", "terastal")
# every block round of this trial on the device round; 0.3 s is the shortest
# duration whose ready queue reaches the NJ-64 bucket (it peaks at 145)
ROUND_CELL = dict(scenario="saturation_5x", platform="4k_1ws2os", duration=0.3)
# PERF.md section 4's cells (a) and (b), 4 schedulers x seeds 0-7 each: (a) at
# 0.1 s (~4,000 engine iterations in all), (b) cut to 0.02 s (~6,600; at 0.1 s
# ~13,000), so that the host-paced engine (3-10 ms an iteration) fits
CAMPAIGN_CELLS = [
    ("a", "multicam_heavy", "6k_1ws2os", "periodic", 0.1),
    ("b", "saturation_5x", "4k_1ws2os", "poisson", 0.02),
]
ADAPTIVE_CELL = ("a", "multicam_heavy", "6k_1ws2os", "poisson", 0.02)
# last logits, token-by-token decode vs prefill of a 512-token prompt, f32:
# tests/test_model_consistency.py's assert_allclose(atol, rtol)
CROSS_TOL = dict(atol=2e-4, rtol=2e-3)


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(*parts):
    print(*parts, flush=True)


def paced_ms(torch, fn, reps=50, warm=5):
    """Mean time of one ``fn`` call launched back to back from Python
    (CUDA events around ``reps`` calls): what a caller pays per call when
    the host, not the card, sets the pace."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(torch, fn, reps=50, warm=3):
    """Mean device time of one ``fn`` call: ``reps`` calls captured in one
    CUDA graph and replayed, so no host launch gap separates them (inputs
    stay warm in L2 between calls)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warm):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def event_ms(torch, fn, reps=3, warm=1):
    """Mean device time of one ``fn`` call timed with CUDA events around
    ``reps`` calls launched from Python: for calls of many milliseconds,
    whose launch gaps are negligible and whose intermediates are too large
    to keep for a graph."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def cold_graph_ms(torch, calls, reps=50):
    """``graph_ms`` of calls that take turns over ``calls``, each reading
    its own copy of the inputs: with copies together larger than the L2
    cache, every call finds its inputs in device memory, as a layer of
    the serving loop finds its cache between the weight products."""
    turn = itertools.cycle(calls)
    return graph_ms(torch, lambda: next(turn)(), reps)


def device_activity(torch, fn):
    """``{name: (count, device_ms)}``: the device activities (kernels,
    copies) that ``torch.profiler`` records over one call of ``fn``,
    summed by name.  The raw event list is read rather than
    ``prof.events()``, whose per-event tree building takes minutes at the
    engine's millions of launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            n, ms = by_name.get(e.name(), (0, 0.0))
            by_name[e.name()] = (n + 1, ms + e.duration_ns() / 1e6)
    return by_name


def logits_gap(got, ref):
    """(max|d| / max|ref|, rms|d| / rms|ref|, argmax agreement) of two logit tensors."""
    d = (got - ref).float()
    ref = ref.float()
    return ((d.abs().max() / ref.abs().max()).item(),
            (d.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()).item(),
            (got.argmax(-1) == ref.argmax(-1)).float().mean().item())


def bound(t_bytes, t_ops):
    """Least time (ms) for work whose bytes take ``t_bytes`` at the HBM
    rate and whose operations take ``t_ops`` at the type's peak."""
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def floor_times(x, w, out):
    """(ms over HBM, ms at peak) for one call: every input read once and
    the output written once; 2*M*Cv*Kv operations.  An f32-accurate
    product takes the faster of the CUDA cores and split TF32 (three
    products at the TF32 peak)."""
    nbytes = (x.numel() + w.numel() + out.numel()) * x.element_size()
    ops = 2.0 * (x.numel() // w.shape[0]) * w.shape[0] * w.shape[1]
    dn = str(x.dtype).split(".")[1]
    t_ops = ops / PEAK[dn]
    if dn == "float32":
        t_ops = min(t_ops, 3 * ops / PEAK["tf32"])
    return nbytes / HBM_BPS * 1e3, t_ops * 1e3


def _trial_fields(t):
    """A TrialResult as JSON, without ``wall_s`` and the engine (NaN == NaN)."""
    d = dataclasses.asdict(t)
    d.pop("wall_s")
    d["spec"].pop("engine")
    return json.dumps(d, sort_keys=True)


def paper_method(torch, report):
    """Phase (v): Algorithm 1, the Terastal round and the campaign stack on the card."""
    import collections

    from repro_torch.core import (
        SATURATION_SCENARIOS, Campaign, SamplerConfig, engine_soa, make_scheduler,
        run_adaptive, scheduler_torch, simulate,
    )
    from repro_torch.core import campaign as campaign_mod
    from repro_torch.core.budget import distribute_budgets
    from repro_torch.core.budget_torch import (
        distribute_budgets_batch, distribute_budgets_torch, pack_levels,
    )
    from repro_torch.core.workload import SCENARIO_CATALOGS
    from repro_torch.costmodel.maestro import PLATFORMS

    out = report["paper"] = {}

    # 1. Algorithm 1: every model of every catalog scenario on its own
    # platforms, one call each, then each cell's models as one padded batch
    worst = [0.0]

    def check(feasible, rho, budgets, ref, what):
        if bool(feasible) != ref.feasible or rho.tolist() != ref.rho.tolist():
            fail(f"budgets of {what}: feasible/rho differ from the numpy reference")
        if ref.feasible:
            rel = float(np.max(np.abs(budgets.cpu().numpy() - ref.budgets) / ref.budgets))
            worst[0] = max(worst[0], rel)
            if rel > BUDGET_RTOL:
                fail(f"budgets of {what}: relative difference {rel:.3e} > {BUDGET_RTOL}")

    distribute_budgets_torch(*pack_levels(np.array([[2.0, 1.0]])), 1.5, device="cuda")
    single_s, batch_s, host_s, batch_m = [], [], [], []
    n_models = n_infeasible = 0
    biggest = None
    for cat, scenarios in SCENARIO_CATALOGS.items():
        for name, sc in scenarios.items():
            for plat in sc.platform_names:
                plans, _ = sc.plans(PLATFORMS[plat])
                models = [(p.lat, p.deadline) for p in plans]
                refs = []
                for m, (lat, dl) in enumerate(models):
                    t0 = time.perf_counter()
                    refs.append(distribute_budgets(lat, dl))
                    host_s.append(time.perf_counter() - t0)
                    packed, R = pack_levels(lat)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = distribute_budgets_torch(packed, R, dl, device="cuda")
                    res.rho.cpu()
                    single_s.append(time.perf_counter() - t0)
                    check(res.feasible, res.rho, res.budgets, refs[m], f"{name}@{plat} model {m}")
                    n_models += 1
                    n_infeasible += not refs[m].feasible
                    if biggest is None or lat.shape[0] > biggest[0].shape[0]:
                        biggest = (lat, dl)
                M, L = len(models), max(lat.shape[0] for lat, _ in models)
                r_max = max(int(pack_levels(lat)[1].max()) for lat, _ in models)
                levels_b = np.zeros((M, L, r_max))
                R_b = np.ones((M, L), np.int32)
                mask_b = np.zeros((M, L), bool)
                for m, (lat, _) in enumerate(models):
                    n = lat.shape[0]
                    levels_b[m, :n], R_b[m, :n] = pack_levels(lat, r_max)
                    mask_b[m, :n] = True
                deadlines = np.array([dl for _, dl in models])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = distribute_budgets_batch(levels_b, R_b, deadlines, mask_b, device="cuda")
                res.rho.cpu()
                batch_s.append(time.perf_counter() - t0)
                batch_m.append(M)
                for m, (lat, _) in enumerate(models):
                    n = lat.shape[0]
                    check(res.feasible[m], res.rho[m, :n], res.budgets[m, :n], refs[m],
                          f"{name}@{plat} model {m}, batched")
    big_packed, big_R = pack_levels(biggest[0])
    dev = device_activity(torch, lambda: distribute_budgets_torch(
        big_packed, big_R, biggest[1], device="cuda").rho.cpu())
    out["budget"] = b = dict(
        models=n_models, infeasible=n_infeasible, cells=len(batch_s), rtol=BUDGET_RTOL,
        max_rel_diff=worst[0], us_per_call=float(np.mean(single_s)) * 1e6,
        median_us_per_call=float(np.median(single_s)) * 1e6,
        batched_us_per_cell=float(np.mean(batch_s)) * 1e6, models_per_cell=float(np.mean(batch_m)),
        numpy_us_per_call=float(np.mean(host_s)) * 1e6, largest_layers=int(biggest[0].shape[0]),
        device_ops_largest=sum(n for n, _ in dev.values()),
    )
    say("[budget] {models} catalog models ({infeasible} infeasible) in {cells} cells: rho and "
        "feasible equal to numpy, budgets within rtol {rtol} (largest relative difference "
        "{max_rel_diff:.3e}); us per call {us_per_call:.1f} (median {median_us_per_call:.1f}), "
        "batched {batched_us_per_cell:.1f} per cell of {models_per_cell:.1f} models, numpy "
        "{numpy_us_per_call:.1f}; device ops of one call on the largest model ({largest_layers} "
        "layers): {device_ops_largest}".format(**b))

    # 2. the Terastal round: every block round of a saturation trial on the
    # device round (a CUDA graph per bucket), each backfill mode
    cell = ROUND_CELL
    plans, tasks = SATURATION_SCENARIOS[cell["scenario"]].plans(PLATFORMS[cell["platform"]])
    n_acc = plans[0].platform.n_acc
    seen = collections.Counter()
    states = {16: [], 64: []}
    recorded = engine_soa._jax_round

    def recording(B, now, busy, idle_mask, n_acc_, mode, device=None):
        bucket = scheduler_torch.bucket_nj(B.n)
        seen[bucket] += 1
        # states near the top of the bucket, spread over the trial
        if (bucket in states and mode == "ef" and len(states[bucket]) < 8
                and B.n > 3 * bucket // 4 and seen[bucket] % 7 == 0):
            states[bucket].append((B.clone(), now, list(busy), idle_mask))
        return recorded(B, now, busy, idle_mask, n_acc_, mode, device)

    say(f"[round] cut: duration {cell['duration']} s, seed 0")
    out["round_trials"] = []
    engine_soa._jax_round = recording
    try:
        for mode in MODES:
            sched = make_scheduler(f"terastal(backfill_mode={mode})")
            calls = scheduler_torch.terastal_round.calls
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = simulate(plans, tasks, cell["duration"], sched, seed=0, engine="soa",
                           round_kernel="jax", device="cuda")
            wall = time.perf_counter() - t0
            n_dev = scheduler_torch.terastal_round.calls - calls
            t0 = time.perf_counter()
            want = simulate(plans, tasks, cell["duration"], sched, seed=0, engine="soa",
                            round_kernel="python")
            py_wall = time.perf_counter() - t0
            if got.fingerprint() != want.fingerprint():
                fail(f"{cell['scenario']} {mode}: the device round's fingerprint != the python round's")
            line = dict(mode=mode, device_rounds=n_dev, rounds=got.rounds, wall_s=wall,
                        python_wall_s=py_wall, us_per_device_round=wall / max(n_dev, 1) * 1e6)
            out["round_trials"].append(line)
            say("[round] {s} @ {p} {d} s terastal({mode}): {device_rounds} device rounds of "
                "{rounds} rounds in {wall_s:.3f} s ({us_per_device_round:.1f} us a round, the "
                "trial's host work included); python round {python_wall_s:.3f} s; fingerprints "
                "equal".format(s=cell["scenario"], p=cell["platform"], d=cell["duration"], **line))
    finally:
        engine_soa._jax_round = recorded
    buckets = sorted(seen)
    say(f"[round] device rounds by NJ bucket: {dict(sorted(seen.items()))}")
    if max(buckets) < 64:
        fail(f"the device rounds reached NJ bucket {max(buckets)}, not 64")

    def stage(B, now, busy, idle_mask, device):
        n = B.n
        perm = np.argsort(B.rid_arr[:n])
        return scheduler_torch.pack_arrays(
            B.vdl_arr[:n][perm], B.vdl_next_arr[:n][perm], B.next_min_arr[:n][perm],
            B.lat_arr[:, :n].T[perm], B.latv_arr[:, :n].T[perm],
            np.array([b if b > now else now for b in busy]),
            np.array([bool(idle_mask >> k & 1) for k in range(n_acc)]), device=device)

    def per_call_us(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e6

    out["round_buckets"] = []
    for bucket, sts in states.items():
        if not sts:
            fail(f"no device round was recorded in the NJ-{bucket} bucket")
        for B, now, busy, idle_mask in sts:
            n_idle = bin(idle_mask).count("1")
            ref = engine_soa._kern_terastal(B, now, busy, idle_mask, n_idle, "ef")
            if engine_soa._jax_round(B, now, busy, idle_mask, n_acc, "ef", "cuda") != ref:
                fail(f"NJ {B.n}: the device round's assignments != the python round's")
            inp = stage(B, now, busy, idle_mask, "cuda")
            graph = [t.cpu() for t in scheduler_torch.terastal_round(inp, mode="ef")]
            eager = [t.cpu() for t in scheduler_torch._round(inp, "ef")]
            host = scheduler_torch._round(stage(B, now, busy, idle_mask, "cpu"), "ef")
            if not all(torch.equal(a, b) and torch.equal(a, c)
                       for a, b, c in zip(graph, eager, host)):
                fail(f"NJ {B.n}: graph replay, eager card and host rounds differ")
        k = len(sts)
        args = [(B, now, busy, idle_mask, bin(idle_mask).count("1")) for B, now, busy, idle_mask in sts]
        inps = [stage(B, now, busy, idle_mask, "cuda") for B, now, busy, idle_mask, _ in args]
        dev = device_activity(torch, lambda: [engine_soa._jax_round(
            B, now, busy, idle_mask, n_acc, "ef", "cuda") for B, now, busy, idle_mask, _ in args])
        line = dict(
            bucket=bucket, states=k, nj=[B.n for B, *_ in args],
            device_round_us=per_call_us(lambda: [engine_soa._jax_round(
                B, now, busy, idle_mask, n_acc, "ef", "cuda")
                for B, now, busy, idle_mask, _ in args], 25) / k,
            eager_card_round_us=per_call_us(lambda: [scheduler_torch.device_get(
                scheduler_torch._round(inp, "ef")) for inp in inps], 3) / k,
            host_vec_round_us=per_call_us(lambda: [engine_soa._kern_terastal_vec(
                B, now, busy, idle_mask, n_idle, "ef") for B, now, busy, idle_mask, n_idle in args],
                200) / k,
            host_scalar_round_us=per_call_us(lambda: [engine_soa._kern_terastal(
                B, now, busy, idle_mask, n_idle, "ef") for B, now, busy, idle_mask, n_idle in args],
                200) / k,
            device_ops_per_round=sum(n for n, _ in dev.values()) / k,
            device_us_per_round=sum(ms for _, ms in dev.values()) / k * 1e3,
        )
        out["round_buckets"].append(line)
        say("[round] NJ-{bucket} bucket ({states} states, NJ {nj}): device round {device_round_us:.1f} "
            "us (staging, graph replay and fetch), eager on the card {eager_card_round_us:.1f} us, "
            "host vectorized round {host_vec_round_us:.1f} us, host scalar round "
            "{host_scalar_round_us:.1f} us; {device_ops_per_round:.1f} device ops and "
            "{device_us_per_round:.1f} us of device time a round; graph, eager and host outputs "
            "equal".format(**line))

    # 3. the campaign stack: Campaign.run on the batched engine for each cell
    # of PERF.md section 4, held field for field against the host soa grid
    out["campaigns"] = []
    for label, scen, plat, arrival, dur in CAMPAIGN_CELLS:
        if dur != 0.1:
            say(f"[campaign] ({label}) cut: duration {dur} s (from 0.1 s)")
        say(f"[campaign] ({label}) cut: seeds 0-7")
        camp = Campaign(scenarios=(scen,), platforms=(plat,), schedulers=SCHEDULERS,
                        arrivals=(arrival,), seeds=tuple(range(8)), duration=dur, engine="batch")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = camp.run(device="cuda")
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = dataclasses.replace(camp, engine="soa").run(parallel=False)
        host_wall = time.perf_counter() - t0
        if [_trial_fields(t) for t in res.trials] != [_trial_fields(t) for t in host.trials]:
            fail(f"campaign ({label}): batch results != the host soa grid's")
        line = dict(cell=label, scenario=scen, platform=plat, arrival=arrival, duration=dur,
                    trials=len(res.trials), wall_s=wall, trials_per_s=len(res.trials) / wall,
                    host_soa_wall_s=host_wall,
                    released=sum(t.released for t in res.trials),
                    variants_applied=sum(t.variants_applied for t in res.trials))
        out["campaigns"].append(line)
        say("[campaign] ({cell}) {scenario} @ {platform} {arrival} {duration} s, 4 schedulers x 8 "
            "seeds, engine=batch: {trials} trials in {wall_s:.3f} s = {trials_per_s:.3f} trials/s "
            "(host soa grid {host_soa_wall_s:.3f} s); {released} requests released, {variants_applied} "
            "variants applied; every result equal to the host soa grid's".format(**line))

    # the sequential sampler with a journal on the batched engine, then
    # resumed from the journal with nothing run again
    journal = ROOT / "chiprun_out" / "sampler_journal.jsonl"
    journal.parent.mkdir(exist_ok=True)
    journal.unlink(missing_ok=True)
    label, scen, plat, arrival, dur = ADAPTIVE_CELL
    say(f"[campaign] run_adaptive cut: duration {dur} s")
    say("[campaign] run_adaptive cut: seeds 0-3, edf and terastal")
    camp = Campaign(scenarios=(scen,), platforms=(plat,), schedulers=("edf", "terastal"),
                    arrivals=(arrival,), seeds=(0, 1, 2, 3), duration=dur, engine="batch")
    cfg = SamplerConfig(min_seeds=2)
    t0 = time.perf_counter()
    ad = run_adaptive(camp, cfg, journal=str(journal), device="cuda")
    wall = time.perf_counter() - t0
    host = run_adaptive(dataclasses.replace(camp, engine="soa"), cfg, parallel=False)
    if ([_trial_fields(t) for t in ad.trials] != [_trial_fields(t) for t in host.trials]
            or [v.winner for v in ad.verdicts] != [v.winner for v in host.verdicts]):
        fail("run_adaptive on the batched engine != the host soa sampler")
    batch_fn = campaign_mod.run_trial_batch

    def no_rerun(*args, **kwargs):
        fail("run_adaptive re-ran a trial that its journal holds")

    campaign_mod.run_trial_batch = no_rerun
    try:
        again = run_adaptive(camp, cfg, journal=str(journal), device="cuda")
    finally:
        campaign_mod.run_trial_batch = batch_fn
    if [_trial_fields(t) for t in again.trials] != [_trial_fields(t) for t in ad.trials]:
        fail("run_adaptive resumed from its journal gave other results")
    out["adaptive"] = a = dict(cell=label, scenario=scen, platform=plat, duration=dur,
                               trials=len(ad.trials), rounds=ad.rounds, cap=ad.n_trials_cap,
                               wall_s=wall, verdicts=[v.winner for v in ad.verdicts])
    say("[campaign] run_adaptive ({cell}) {scenario} @ {platform} {duration} s, edf vs terastal, "
        "seeds 0-3, engine=batch, journal: {trials} of {cap} trials in {rounds} looks, {wall_s:.3f} s, "
        "verdicts {verdicts}; equal to the host soa sampler; resumed from the journal with no "
        "trial run again".format(**a))


def main():
    import torch
def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        fail(f"src/repro_torch not found beside {Path(__file__).name}: run it "
             "from the root of a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.core import (
        SATURATION_SCENARIOS, SCENARIOS, make_scheduler, simulate, simulate_batch,
    )
    from repro_torch.core.simulator import make_arrival_process
    from repro_torch.core.variant_exec import (
        pointwise_variants, run_pointwise_variants, variant_inputs,
    )
    from repro_torch.costmodel.maestro import PLATFORMS
    from repro_torch.kernels.decode_attn import kernel as dec_kernel
    from repro_torch.kernels.decode_attn.ops import gqa_decode_attention
    from repro_torch.kernels.decode_attn.ref import decode_attention
    from repro_torch.kernels.s2d_conv import kernel as s2d_kernel
    from repro_torch.kernels.s2d_conv.ref import s2d_conv_ref
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    from repro_torch.launch import serve
    from repro_torch.models import mamba2, transformer
    from repro_torch.models.model_api import build_model

    # the plain version and the library yardstick compute in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}

    # ---- 1. card -----------------------------------------------------------
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        fail(f"nvidia-smi did not run: {e}")
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed ({smi.returncode}): {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    say(f"[card] {card}")
    say(f"[card] torch {torch.__version__} cuda {torch.version.cuda} device {kind} x{count}")
    report["card"] = card
    report["device"] = kind

    # ---- 2. build: one nvcc per source, started together --------------------
    def timed_build(mod):
        t0 = time.perf_counter()
        lib = mod.build(verbose=True)
        return lib, time.perf_counter() - t0

    kernel_mods = {"s2d_conv": s2d_kernel, "decode_attn": dec_kernel, "ssd_scan": ssd_kernel}
    with ThreadPoolExecutor(len(kernel_mods)) as pool:
        futures = {name: pool.submit(timed_build, mod) for name, mod in kernel_mods.items()}
        built = {name: f.result() for name, f in futures.items()}
    report["build_s"] = {}
    for name, mod in kernel_mods.items():
        mod.load()
        lib, build_s = built[name]
        say(f"[build] {name} {lib.name} built and loaded in {build_s:.2f} s")
        report["build_s"][name] = build_s

    # ---- 3. kernel against its plain version --------------------------------
    mc_plans, _ = SCENARIOS["multicam_heavy"].plans(PLATFORMS["6k_1ws2os"])
    main_layers = [v for p in mc_plans for v in pointwise_variants(p)]
    if not main_layers:
        fail("multicam_heavy plans select no pointwise variant layers")
    shapes = {}  # (H, W, C, K, g) -> label, test shapes first
    for _, H, W, C, K, g in TEST_SHAPES:
        shapes.setdefault((H, W, C, K, g), f"test[{H}x{W}x{C}->{K},g{g}]")
    for v in main_layers:
        shapes.setdefault((v.H, v.W, v.C, v.K, v.gamma), v.name)
    rng = np.random.default_rng(0)
    rows = []
    for (H, W, C, K, g), label in shapes.items():
        for batch in (1, 8):
            x32 = torch.from_numpy(rng.standard_normal((batch, H, W, C), dtype=np.float32)).cuda()
            w32 = torch.from_numpy(rng.standard_normal((C // (g * g), K // (g * g)),
                                                       dtype=np.float32)).cuda()
            for dtype in (torch.float32, torch.bfloat16):
                x, w = x32.to(dtype), w32.to(dtype)
                got = s2d_kernel.s2d_conv_cuda(x, w, g)
                ref = s2d_conv_ref(x, w, g)
                torch.cuda.synchronize()
                if got.shape != ref.shape or not bool(torch.isfinite(got.float()).all()):
                    fail(f"s2d_conv {label} B={batch} {dtype}: bad output {tuple(got.shape)}")
                err = (got.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                dn = str(dtype).split(".")[1]
                ok = err <= TOL[dn] * scale
                xm = x.reshape(-1, w.shape[0])
                row = dict(
                    shape=label, B=batch, dtype=dn, x=list(x.shape), w=list(w.shape),
                    max_abs_err=err, max_abs_ref=scale, tol=TOL[dn] * scale, ok=ok,
                    kernel_ms=graph_ms(torch, lambda: s2d_kernel.s2d_conv_cuda(x, w, g)),
                    plain_ms=graph_ms(torch, lambda: s2d_conv_ref(x, w, g)),
                    library_ms=graph_ms(torch, lambda: torch.matmul(xm, w)),
                    call_ms=paced_ms(torch, lambda: s2d_kernel.s2d_conv_cuda(x, w, g)),
                )
                row["t_bytes_ms"], row["t_ops_ms"] = floor_times(x, w, got)
                row["bound_ms"], row["bound_by"] = bound(row["t_bytes_ms"], row["t_ops_ms"])
                row["main_path"] = label in {v.name for v in main_layers}
                rows.append(row)
                say("[kernel] s2d_conv {shape} B={B} {dtype} x={x} w={w} "
                    "max_abs_err={max_abs_err:.3e} tol={tol:.3e} kernel_ms={kernel_ms:.5f} "
                    "plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} "
                    "bound_ms={bound_ms:.5f} ({bound_by}) call_ms={call_ms:.5f} "
                    "ok={ok}".format(**row))
                if not ok:
                    fail(f"s2d_conv {label} B={batch} {dn}: max|d| {err} > {TOL[dn]} * {scale}")
    say(f"[kernel] {len(rows)} comparisons within tolerance; "
        f"launches while comparing = {s2d_kernel.s2d_conv_cuda.launches}")
    report["kernel_rows"] = rows
    # the launch plan of each main-path GEMM (B=1)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gemms = {}
    for v in main_layers:
        g2 = v.gamma * v.gamma
        gemms.setdefault((v.H * v.W * g2, v.C // g2, v.K // g2), []).append(v.name)
    # and the kernel's time at every split the planner weighs (B=1, warm L2)
    report["s2d_plans"] = []
    for (M, Cv, Kv), names in gemms.items():
        x32 = torch.from_numpy(rng.standard_normal((1, M, 1, Cv), dtype=np.float32)).cuda()
        w32 = torch.from_numpy(rng.standard_normal((Cv, Kv), dtype=np.float32)).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            x, w = x32.to(dtype), w32.to(dtype)
            plan = s2d_kernel.plan_s2d(M, Cv, Kv, dtype, n_sm)
            line = dict(M=M, Cv=Cv, Kv=Kv, dtype=str(dtype).split(".")[1], layers=names,
                        tile=[s2d_kernel.TILE_M, s2d_kernel.TILE_N, plan.tile_k],
                        slabs=plan.slabs, split=plan.split, blocks=plan.blocks, sms=n_sm,
                        ms_by_split={S: graph_ms(torch, lambda S=S: s2d_kernel.s2d_conv_cuda(
                            x, w, 1, split=S)) for S in s2d_kernel.SPLITS if S <= plan.slabs})
            report["s2d_plans"].append(line)
            say("[plan] s2d_conv {M}x{Cv}x{Kv} {dtype} ({n} layers): tile {tile}, {slabs} slabs, "
                "split {split}, {blocks} blocks on {sms} SMs; ms by split ".format(
                    n=len(names), **line)
                + " ".join(f"{S}:{ms:.5f}" for S, ms in line["ms_by_split"].items()))

    dec_rows = []
    for B, L, H, Hkv, Dh, valid in DECODE_SHAPES:
        q32, k32, v32 = (
            torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()
            for shape in ((B, 1, H, Dh), (B, L, Hkv, Dh), (B, L, Hkv, Dh))
        )
        pos = valid - 1
        vl = torch.full((B,), valid, dtype=torch.int32, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
            q3 = q[:, 0]
            got = dec_kernel.decode_attn_cuda(q3, k, v, vl, bound=valid)[:, None]
            ref = decode_attention(q, k, v, pos)
            torch.cuda.synchronize()
            if got.shape != ref.shape or not bool(torch.isfinite(got.float()).all()):
                fail(f"decode_attn B={B} L={L} valid={valid} {dtype}: bad output")
            d = (got.float() - ref.float()).abs()
            err = d.max().item()
            scale = ref.float().abs().max().item()
            dn = str(dtype).split(".")[1]
            if dtype == torch.float32:
                ok = bool((d <= 1e-5 + 1e-4 * ref.abs()).all())
                tol = 1e-5 + 1e-4 * scale
            else:
                tol = TOL["bfloat16"] * scale
                ok = err <= tol
            # the library yardstick: [B, H, 1, Dh] against the valid positions, transposed
            qt = q.transpose(1, 2)
            kt = k[:, :valid].transpose(1, 2).contiguous()
            vt = v[:, :valid].transpose(1, 2).contiguous()
            sdpa = torch.nn.functional.scaled_dot_product_attention
            row = dict(
                shape=f"B{B}.L{L}.H{H}.Hkv{Hkv}.Dh{Dh}", B=B, L=L, H=H, Hkv=Hkv, Dh=Dh,
                valid=valid, dtype=dn,
                splits=dec_kernel.plan_splits(B, Hkv, valid, 2 * Dh * q.element_size(), n_sm),
                max_abs_err=err, max_abs_ref=scale, tol=tol, ok=ok,
                kernel_ms=graph_ms(torch, lambda: dec_kernel.decode_attn_cuda(q3, k, v, vl,
                                                                              bound=valid)),
                plain_ms=graph_ms(torch, lambda: decode_attention(q, k, v, pos)),
                library_ms=graph_ms(torch, lambda: sdpa(qt, kt, vt, enable_gqa=True)),
                call_ms=paced_ms(torch, lambda: gqa_decode_attention(q, k, v, pos, vl)),
            )
            nbytes = (q.numel() + 2 * B * valid * Hkv * Dh + got.numel()) * q.element_size()
            if (B, L) == (SERVE["batch"], SERVE["ctx"]):
                # serving shapes: also cold-L2, on copies of the cache twice the L2 in all
                n_copies = int(-(-2 * L2_BYTES // nbytes))
                copies = [(k.clone(), v.clone()) for _ in range(n_copies)]
                row["cold_ms"] = cold_graph_ms(torch, [
                    lambda kc=kc, vc=vc: dec_kernel.decode_attn_cuda(q3, kc, vc, vl, bound=valid)
                    for kc, vc in copies])
                if (H, Dh, dn) == (32, 64, "bfloat16"):
                    # llama3.2-1b's heads: the device kernels of one call, and
                    # the cold time of every split beside the planner's
                    dev = device_activity(torch, lambda: dec_kernel.decode_attn_cuda(
                        q3, k, v, vl, bound=valid))
                    row["device_kernels_per_call"] = sum(n for n, _ in dev.values())
                    row["cold_ms_by_splits"] = {S: cold_graph_ms(torch, [
                        lambda kc=kc, vc=vc, S=S: dec_kernel.decode_attn_cuda(q3, kc, vc, vl,
                                                                                splits=S)
                        for kc, vc in copies]) for S in range(1, dec_kernel.MAX_SPLIT + 1)}
                    say(f"[plan] decode_attn {row['shape']} valid={valid} {dn}: device kernels "
                        f"per call {row['device_kernels_per_call']} ({sorted(dev)}); planner "
                        f"splits {row['splits']}; cold ms by splits "
                        + " ".join(f"{S}:{ms:.5f}" for S, ms in row["cold_ms_by_splits"].items()))
                    if row["device_kernels_per_call"] != 1:
                        fail(f"one decode_attn call ran {row['device_kernels_per_call']} device "
                             "kernels, not 1")
                copies = [(kc[:, :valid].transpose(1, 2).contiguous(),
                           vc[:, :valid].transpose(1, 2).contiguous()) for kc, vc in copies]
                row["library_cold_ms"] = cold_graph_ms(torch, [
                    lambda kc=kc, vc=vc: sdpa(qt, kc, vc, enable_gqa=True)
                    for kc, vc in copies])
                del copies
            row["t_bytes_ms"] = nbytes / HBM_BPS * 1e3
            row["t_ops_ms"] = 4.0 * B * H * valid * Dh / PEAK[dn] * 1e3
            row["bound_ms"], row["bound_by"] = bound(row["t_bytes_ms"], row["t_ops_ms"])
            dec_rows.append(row)
            cold = (" cold_ms={cold_ms:.5f} library_cold_ms={library_cold_ms:.5f}"
                    .format(**row) if "cold_ms" in row else "")
            say("[kernel] decode_attn {shape} valid={valid} {dtype} splits={splits} "
                "max_abs_err={max_abs_err:.3e} tol={tol:.3e} kernel_ms={kernel_ms:.5f} "
                "plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} "
                "bound_ms={bound_ms:.5f} ({bound_by}) call_ms={call_ms:.5f}".format(**row)
                + cold + f" ok={ok}")
            if not ok:
                fail(f"decode_attn {row['shape']} valid={valid} {dn}: max|d| {err} > tol {tol}")
    say(f"[kernel] {len(dec_rows)} decode_attn comparisons within tolerance; "
        f"launches while comparing = {dec_kernel.decode_attn_cuda.launches}")
    report["decode_rows"] = dec_rows

    ssd_rows = []
    for Bt, L, H, Pd, N, Q in SSD_SHAPES:
        prefill_shape = (Bt, L) == (SSM["batch"], SSM["prompt"])
        f32 = np.float32
        x32, la, B32, C32, dt = (torch.from_numpy(np.ascontiguousarray(a, dtype=f32)).cuda() for a in (
            rng.standard_normal((Bt, L, H, Pd), dtype=f32),
            -np.abs(rng.standard_normal((Bt, L, H), dtype=f32)) * 0.3,
            rng.standard_normal((Bt, L, N), dtype=f32), rng.standard_normal((Bt, L, N), dtype=f32),
            np.logaddexp(rng.standard_normal((Bt, L, H), dtype=f32), f32(0))))
        for dtype in (torch.float32, torch.bfloat16):
            # x, B, C in the dtype; log_a and dt f32, as the model feeds them
            x, B, C = x32.to(dtype), B32.to(dtype), C32.to(dtype)
            got = ssd_kernel.ssd_scan_cuda(x, la, B, C, dt, Q)
            ref = ssd_chunked(x, la, B, C, dt, Q)
            torch.cuda.synchronize()
            if got.shape != ref.shape or not bool(torch.isfinite(got.float()).all()):
                fail(f"ssd_scan {(Bt, L, H, Pd, N, Q)} {dtype}: bad output")
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            dn = str(dtype).split(".")[1]
            tol = SSD_TOL[dn + ("@prefill" if prefill_shape and dn == "float32" else "")] * scale
            ok = err <= tol
            reps = 5 if prefill_shape else 50
            row = dict(
                shape=f"Bt{Bt}.L{L}.H{H}.P{Pd}.N{N}.Q{Q}", Bt=Bt, L=L, H=H, P=Pd, N=N, Q=Q,
                dtype=dn, max_abs_err=err, max_abs_ref=scale, tol=tol, ok=ok,
                kernel_ms=graph_ms(torch, lambda: ssd_kernel.ssd_scan_cuda(x, la, B, C, dt, Q),
                                   reps),
                plain_ms=(event_ms(torch, lambda: ssd_chunked(x, la, B, C, dt, Q))
                          if prefill_shape else
                          graph_ms(torch, lambda: ssd_chunked(x, la, B, C, dt, Q))),
                library_ms=None,  # no single PyTorch call computes the SSD scan
                call_ms=paced_ms(torch, lambda: ssd_scan(x, la, B, C, dt, Q), reps, 1),
            )
            nbytes = (2 * x.numel() * x.element_size() + (B.numel() + C.numel()) * B.element_size()
                      + (la.numel() + dt.numel()) * la.element_size())
            # the products the function needs, causal half only (Q(Q+1)/2 pairs j <= i):
            # C B^T once per (b, chunk), as B and C are shared by the heads, at the
            # inputs' type (bf16 products are exact in f32); scores xdt, C S and the
            # state update per (b, h, chunk) in f32 (xdt and the decays are f32).  An
            # f32-accurate product runs at the faster of the CUDA cores and split TF32
            # (three products at the TF32 peak; two for C S where C is bf16, exact in
            # TF32); the CUDA-core-only figure is the bound that earlier versions of
            # this script printed.
            n_chunks = Bt * (L // Q)
            ops_cb = n_chunks * Q * (Q + 1) * N
            ops_cs = n_chunks * H * 2 * Q * N * Pd
            ops_f32 = n_chunks * H * (Q * (Q + 1) * Pd + 2 * Q * N * Pd) + ops_cs
            f32_s = min(1 / PEAK["float32"], 3 / PEAK["tf32"])
            cs_s = min(1 / PEAK["float32"], 2 / PEAK["tf32"]) if dn == "bfloat16" else f32_s
            row["t_bytes_ms"] = nbytes / HBM_BPS * 1e3
            row["t_ops_ms"] = (ops_cb * (1 / PEAK[dn] if dn == "bfloat16" else f32_s)
                               + (ops_f32 - ops_cs) * f32_s + ops_cs * cs_s) * 1e3
            row["bound_ms"], row["bound_by"] = bound(row["t_bytes_ms"], row["t_ops_ms"])
            row["cuda_core_bound_ms"] = max(
                row["t_bytes_ms"], (ops_cb / PEAK[dn] + ops_f32 / PEAK["float32"]) * 1e3)
            row["main_path"] = prefill_shape
            ssd_rows.append(row)
            say("[kernel] ssd_scan {shape} {dtype} max_abs_err={max_abs_err:.3e} tol={tol:.3e} "
                "kernel_ms={kernel_ms:.5f} plain_ms={plain_ms:.5f} library_ms=None "
                "bound_ms={bound_ms:.5f} ({bound_by}) cuda_core_bound_ms={cuda_core_bound_ms:.5f} "
                "call_ms={call_ms:.5f} ok={ok}".format(**row))
            if not ok:
                fail(f"ssd_scan {row['shape']} {dn}: max|d| {err} > tol {tol}")
            if prefill_shape:
                # the device kernels of a call (C B^T, then the scan), over four calls:
                # the profiler may drop a window's first events, so each kernel must be
                # recorded in three or four of them, and is timed by its mean
                calls = 4
                dev = device_activity(torch, lambda: [
                    ssd_kernel.ssd_scan_cuda(x, la, B, C, dt, Q) for _ in range(calls)])
                row["device_kernels_per_call"] = len(dev)
                row["device_launches_by_kernel"] = {k: n for k, (n, _) in dev.items()}
                row["device_ms_by_kernel"] = {k: ms / n for k, (n, ms) in dev.items()}
                say(f"[plan] ssd_scan {row['shape']} {dn}: device kernels per call "
                    f"{row['device_kernels_per_call']}: " + "; ".join(
                        f"{k[:70]} {ms:.5f} ms ({dev[k][0]} of {calls} calls recorded)"
                        for k, ms in row["device_ms_by_kernel"].items()))
                if len(dev) != 2 or any(not calls - 1 <= n <= calls for n, _ in dev.values()):
                    fail(f"{calls} ssd_scan calls ran device kernels {dev}, not 2 a call")
        del x32, la, B32, C32, dt, x, B, C, got, ref
    say(f"[kernel] {len(ssd_rows)} ssd_scan comparisons within tolerance; "
        f"launches while comparing = {ssd_kernel.ssd_scan_cuda.launches}")
    report["ssd_rows"] = ssd_rows

    # ---- 4. main paths ------------------------------------------------------
    # (i) the batched-trial engine and the variant layers
    cells = [
        ("a", SCENARIOS["multicam_heavy"], "6k_1ws2os", None, 8, 1.0),
        ("b", SATURATION_SCENARIOS["saturation_5x"], "4k_1ws2os", "poisson", 32, 0.1),
    ]
    s2d_kernel.s2d_conv_cuda.launches = 0
    dec_kernel.decode_attn_cuda.launches = 0
    ssd_kernel.ssd_scan_cuda.launches = 0
    runs = []
    for name, scen, plat, arrival, n_seeds, dur in cells:
        plans, tasks = scen.plans(PLATFORMS[plat])
        procs = None
        if arrival is not None:
            proc = make_arrival_process(arrival)
            procs = [t.arrival or proc for t in tasks]
        seeds = list(range(n_seeds))
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = simulate_batch(plans, tasks, dur, make_scheduler("terastal"), seeds,
                             processes=procs, device="cuda", stats=stats)
        wall = time.perf_counter() - t0
        runs.append((name, scen, plat, plans, tasks, procs, seeds, dur, res, stats, wall))
    # the variant layers of the models that applied variants in (a)
    _, _, _, a_plans, _, _, _, _, a_res, _, _ = runs[0]
    applied = sorted({m for r in a_res for m, s in r.per_model.items() if s.variants_applied})
    run_layers = [v for m in applied for v in pointwise_variants(a_plans[m])]
    t0 = time.perf_counter()
    outs = run_pointwise_variants([a_plans[m] for m in applied], device="cuda")
    torch.cuda.synchronize()
    var_wall = time.perf_counter() - t0
    launches = s2d_kernel.s2d_conv_cuda.launches
    say(f"[main] counts read after the main path: s2d_conv launches = {launches}, "
        f"decode_attn launches = {dec_kernel.decode_attn_cuda.launches}, "
        f"ssd_scan launches = {ssd_kernel.ssd_scan_cuda.launches}")
    if launches == 0:
        fail("the main path launched the s2d_conv kernel no time")

    # checks (after the counts were read; these launches are not counted)
    report["main"] = []
    for name, scen, plat, plans, tasks, procs, seeds, dur, res, stats, wall in runs:
        va = [sum(s.variants_applied for s in r.per_model.values()) for r in res]
        for s, r in zip(seeds, res):
            want = simulate(plans, tasks, dur, make_scheduler("terastal"), seed=s,
                            processes=procs, engine="soa").fingerprint()
            if r.fingerprint() != want:
                fail(f"cell ({name}) seed {s}: batch fingerprint != host soa")
        if name == "a" and min(va) <= 0:
            fail(f"cell (a) lanes applied no variants: {va}")
        it = stats["iterations"]
        line = dict(cell=name, scenario=scen.name, platform=plat, seeds=len(seeds),
                    duration=dur, wall_s=wall, trials_per_s=len(seeds) / wall,
                    iterations=it, max_it=stats["max_it"], us_per_iteration=wall / it * 1e6,
                    variants_applied=va, fingerprints_equal_soa=True)
        report["main"].append(line)
        say("[main] ({cell}) {scenario} @ {platform} terastal B={seeds} {duration} s: "
            "wall={wall_s:.3f} s trials/s={trials_per_s:.3f} iterations={iterations} "
            "(bound {max_it}) us/iteration={us_per_iteration:.1f} variants_applied={variants_applied} "
            "fingerprints == host soa".format(**line))
    max_err = 0.0
    for v, x, w in variant_inputs(run_layers, device="cuda"):
        out = outs[v.name]
        ref = s2d_conv_ref(x, w, v.gamma)
        if out.shape != (1, v.H, v.W, v.K) or not bool(torch.isfinite(out).all()):
            fail(f"variant layer {v.name}: bad output {tuple(out.shape)}")
        err = (out - ref).abs().max().item()
        if err > TOL["float32"] * ref.abs().max().item():
            fail(f"variant layer {v.name}: max|d| {err} vs plain")
        max_err = max(max_err, err)
    say(f"[main] {len(run_layers)} pointwise variant layers of models {applied} ran in "
        f"{var_wall * 1e3:.3f} ms wall; outputs match the plain version (max|d| {max_err:.3e})")

    # where the variant layers' time goes: one pass under torch.profiler
    dev = device_activity(torch, lambda: run_pointwise_variants(
        [a_plans[m] for m in applied], device="cuda"))
    dev_ms = sum(ms for _, ms in dev.values())
    n_dev = sum(n for n, _ in dev.values())
    s2d_ms = sum(ms for name, (_, ms) in dev.items() if "s2d_conv" in name)
    s2d_n = sum(n for name, (n, _) in dev.items() if "s2d_conv" in name)
    top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:5]
    report["variant_where"] = vw = dict(
        layers=len(run_layers), wall_ms=var_wall * 1e3, device_ms=dev_ms, device_ops=n_dev,
        device_busy_share=dev_ms / (var_wall * 1e3) if n_dev else None,
        s2d_conv_ms=s2d_ms, s2d_conv_kernels=s2d_n,
        s2d_conv_share=s2d_ms / dev_ms if n_dev else None,
        top_device=[dict(name=k, ops=n, ms=ms) for k, (n, ms) in top],
    )
    if n_dev:
        say("[where] variant layers: wall={wall_ms:.3f} ms; device busy {device_ms:.4f} ms = "
            "{device_busy_share:.4f} of the wall; {device_ops} device ops; s2d_conv "
            "{s2d_conv_ms:.4f} ms in {s2d_conv_kernels} kernels = {s2d_conv_share:.4f} of device "
            "time".format(**vw))
        for d in vw["top_device"]:
            say(f"[where]   {d['ms']:.4f} ms in {d['ops']} x {d['name'][:100]}")
    else:
        say("[where] variant layers: device time not measured "
            "(torch.profiler recorded no device activity)")

    # where the engine's time goes: cell (b) once more, under
    # torch.profiler; the profiler's own host cost stretches only this
    # run, so the device busy share is taken over the unprofiled run's wall
    _, _, _, b_plans, b_tasks, b_procs, b_seeds, b_dur, _, b_stats, b_wall = runs[1]
    dev = device_activity(torch, lambda: simulate_batch(
        b_plans, b_tasks, b_dur, make_scheduler("terastal"), b_seeds,
        processes=b_procs, device="cuda"))
    it = b_stats["iterations"]
    dev_ms = sum(ms for _, ms in dev.values())
    n_dev = sum(n for n, _ in dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:5]
    report["where"] = where = dict(
        cell="b", iterations=it, wall_ms=b_wall * 1e3, device_ms=dev_ms, device_ops=n_dev,
        device_ops_per_iteration=n_dev / it,
        device_busy_share=dev_ms / (b_wall * 1e3) if n_dev else None,
        top_device=[dict(name=k, ops=n, ms=ms) for k, (n, ms) in top],
    )
    if n_dev:
        say("[where] (b): wall={wall_ms:.3f} ms over {iterations} iterations; "
            "device busy {device_ms:.3f} ms = {device_busy_share:.4f} of the wall; "
            "{device_ops} device ops ({device_ops_per_iteration:.1f} per iteration)"
            .format(**where))
        for d in where["top_device"]:
            say(f"[where]   {d['ms']:.3f} ms in {d['ops']} x {d['name'][:100]}")
    else:
        say("[where] (b): device time not measured "
            "(torch.profiler recorded no device activity)")

    # (ii) serving: llama3.2-1b at its published widths, bf16, through
    # serve.run's two halves so that the replay below reuses the weights
    arch, batch, ctx, n_tok = SERVE["arch"], SERVE["batch"], SERVE["ctx"], SERVE["tokens"]
    t0 = time.perf_counter()
    model, params = serve.load(arch, reduced=False, device="cuda", seed=0)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cfg = model.cfg
    if (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.dtype) != (16, 2048, 32, 8, 64, 8192, 128256,
                                                      "bfloat16"):
        fail(f"{arch} is not at its published widths: {cfg}")
    serve_heads = (cfg.n_heads, cfg.resolved_head_dim)
    kept = []  # every step's logits, for the replay
    decode_step = model.decode_step

    def keep_logits(p, t, c, pos):
        logits, c = decode_step(p, t, c, pos)
        kept.append(logits)
        return logits, c

    model.decode_step = keep_logits
    s2d_kernel.s2d_conv_cuda.launches = 0
    dec_kernel.decode_attn_cuda.launches = 0
    ssd_kernel.ssd_scan_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = serve.decode(model, params, tokens=n_tok, batch=batch, ctx=ctx)
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    dec_launches = dec_kernel.decode_attn_cuda.launches
    model.decode_step = decode_step
    say(f"[serve] counts read after the serving path: decode_attn launches = {dec_launches}, "
        f"s2d_conv launches = {s2d_kernel.s2d_conv_cuda.launches}, "
        f"ssd_scan launches = {ssd_kernel.ssd_scan_cuda.launches}")
    if dec_launches != cfg.n_layers * n_tok:
        fail(f"the serving path launched the decode kernel {dec_launches} times, "
             f"not {cfg.n_layers} x {n_tok}")

    # checks (after the counts were read): shape, ids, finite logits, then the
    # same steps through the plain attention, fed the kernel run's tokens
    if tuple(seq.shape) != (batch, n_tok) or len(kept) != n_tok:
        fail(f"serve returned {tuple(seq.shape)} ids and {len(kept)} logits")
    if not bool(((seq >= 0) & (seq < cfg.vocab_size)).all()):
        fail("serve returned ids outside the vocabulary")
    kernel_attention = transformer.gqa_decode_attention

    def plain_attention(q, k, v, pos, valid_len=None):
        return decode_attention(q, k, v, pos)

    # a planted fault: the kernel with the last valid position (the newest
    # token's own key and value) dropped from step 1 on, replayed beside the
    # plain one on the same tokens and read against the same limit
    def fault_attention(q, k, v, pos, valid_len=None):
        vl = torch.full((q.shape[0],), pos, dtype=torch.int32, device=q.device).clamp(min=1)
        return dec_kernel.decode_attn_cuda(q[:, 0], k, v, vl, bound=pos + 1)[:, None]

    stats, fault_stats, agree = [], [], 0
    try:
        cache = model.init_cache(batch, ctx)
        fault_cache = model.init_cache(batch, ctx)
        tok = torch.zeros((batch,), dtype=torch.int32, device="cuda")
        for i in range(n_tok):
            transformer.gqa_decode_attention = plain_attention
            ref, cache = model.decode_step(params, tok, cache, i)
            transformer.gqa_decode_attention = fault_attention
            bad, fault_cache = model.decode_step(params, tok, fault_cache, i)
            d = kept[i] - ref
            stats.append(torch.stack([d.abs().max(), ref.abs().max(),
                                      d.pow(2).mean().sqrt(), ref.pow(2).mean().sqrt()]))
            fd = bad - ref
            fault_stats.append(torch.stack([fd.abs().max(), fd.pow(2).mean().sqrt()]))
            agree += int((ref.argmax(-1) == seq[:, i]).sum())
            tok = seq[:, i]
    finally:
        transformer.gqa_decode_attention = kernel_attention
    del fault_cache
    if dec_kernel.decode_attn_cuda.launches != dec_launches + cfg.n_layers * n_tok:
        fail("the plain replay launched the decode kernel, or the faulty one did not")
    if not all(bool(torch.isfinite(lg).all()) for lg in kept):
        fail("serve produced non-finite logits")
    d_max, r_max, d_rms, r_rms = torch.stack(stats).cpu().numpy().T
    rel_max, rel_rms = d_max / r_max, d_rms / r_rms
    f_max, f_rms = torch.stack(fault_stats).cpu().numpy().T
    f_rel_max, f_rel_rms = f_max / r_max, f_rms / r_rms
    fault_inside = bool((f_rel_max <= SERVE_TOL["max"]).all() and (f_rel_rms <= SERVE_TOL["rms"]).all())
    for name, rel in (("max", rel_max), ("rms", rel_rms)):
        if not (rel <= SERVE_TOL[name]).all():
            i = int(np.argmax(rel))
            fail(f"serve step {i}: logits {name}|d| = {rel[i]:.4f} of {name}|ref| "
                 f"> {SERVE_TOL[name]}")
    del kept
    report["serve"] = serve_line = dict(
        arch=arch, batch=batch, ctx=ctx, tokens=n_tok, dtype=cfg.dtype, load_s=load_s,
        wall_s=serve_wall, ms_per_token=serve_wall / n_tok * 1e3,
        tokens_per_s=batch * n_tok / serve_wall, launches=dec_launches,
        logits_max_abs_err=float(d_max.max()), logits_max_abs_ref=float(r_max.max()),
        worst_max_rel=float(rel_max.max()), worst_max_rel_step=int(np.argmax(rel_max)),
        worst_rms_rel=float(rel_rms.max()), worst_rms_rel_step=int(np.argmax(rel_rms)),
        median_rms_rel=float(np.median(rel_rms)), argmax_agree=agree / (batch * n_tok),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        fault_worst_max_rel=float(f_rel_max.max()), fault_worst_rms_rel=float(f_rel_rms.max()),
        fault_median_max_rel=float(np.median(f_rel_max)),
        fault_median_rms_rel=float(np.median(f_rel_rms)), fault_inside_limit=fault_inside,
    )
    say("[serve] {arch} {dtype} B={batch} ctx={ctx} {tokens} tokens: load={load_s:.2f} s "
        "wall={wall_s:.3f} s ms/token={ms_per_token:.3f} tokens/s={tokens_per_s:.1f}; "
        "plain replay: logits max|d| {logits_max_abs_err:.4e} (max|ref| "
        "{logits_max_abs_ref:.3f}); worst step max|d|/max|ref| {worst_max_rel:.4f} (step "
        "{worst_max_rel_step}), rms|d|/rms|ref| {worst_rms_rel:.4f} (step "
        "{worst_rms_rel_step}, median {median_rms_rel:.4f}); argmax agrees "
        "{argmax_agree:.4f}".format(**serve_line))
    say("[serve] planted fault (the kernel without the newest position) vs the plain replay: "
        "worst step max|d|/max|ref| {fault_worst_max_rel:.4f} (median {fault_median_max_rel:.4f}), "
        "rms|d|/rms|ref| {fault_worst_rms_rel:.4f} (median {fault_median_rms_rel:.4f}); sound "
        "kernel {worst_max_rel:.4f}, {worst_rms_rel:.4f}; limits max {tol_max}, rms {tol_rms}: "
        "the fault reads {where} the limit".format(
            tol_max=SERVE_TOL["max"], tol_rms=SERVE_TOL["rms"],
            where="inside" if fault_inside else "outside", **serve_line))

    # where the serving time goes: the decode loop once more, under torch.profiler
    dev = device_activity(torch, lambda: serve.decode(model, params, tokens=n_tok,
                                                      batch=batch, ctx=ctx))
    dev_ms = sum(ms for _, ms in dev.values())
    n_dev = sum(n for n, _ in dev.values())
    dec_ms = sum(ms for name, (_, ms) in dev.items() if "decode_attn" in name)
    top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:6]
    report["serve_where"] = where = dict(
        steps=n_tok, wall_ms=serve_wall * 1e3, device_ms=dev_ms, device_ops=n_dev,
        device_ops_per_step=n_dev / n_tok,
        device_busy_share=dev_ms / (serve_wall * 1e3) if n_dev else None,
        decode_attn_ms=dec_ms, decode_attn_share=dec_ms / dev_ms if n_dev else None,
        top_device=[dict(name=k, ops=n, ms=ms) for k, (n, ms) in top],
    )
    if n_dev:
        say("[where] serve: wall={wall_ms:.3f} ms over {steps} steps; device busy "
            "{device_ms:.3f} ms = {device_busy_share:.4f} of the wall; {device_ops} device "
            "ops ({device_ops_per_step:.1f} per step); decode_attn {decode_attn_ms:.3f} ms = "
            "{decode_attn_share:.4f} of device time".format(**where))
        for d in where["top_device"]:
            say(f"[where]   {d['ms']:.3f} ms in {d['ops']} x {d['name'][:100]}")
    else:
        say("[where] serve: device time not measured "
            "(torch.profiler recorded no device activity)")

    # (iii) ssm prefill: mamba2-1.3b at its published widths, bf16, after the
    # llama weights are freed
    del model, params, cache, seq
    torch.cuda.empty_cache()
    arch, Bp, Lp = SSM["arch"], SSM["batch"], SSM["prompt"]
    t0 = time.perf_counter()
    model, params = serve.load(arch, reduced=False, device="cuda", seed=0)
    torch.cuda.synchronize()
    ssm_load_s = time.perf_counter() - t0
    cfg = model.cfg
    if (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
            cfg.ssm_chunk, cfg.vocab_size, cfg.tie_embeddings, cfg.dtype) != (
            48, 2048, 4096, 64, 64, 128, 256, 50280, True, "bfloat16"):
        fail(f"{arch} is not at its published widths: {cfg}")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (Bp, Lp), dtype=np.int64)).cuda()
    batch_in = {"tokens": toks}
    s2d_kernel.s2d_conv_cuda.launches = 0
    dec_kernel.decode_attn_cuda.launches = 0
    ssd_kernel.ssd_scan_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = model.prefill(params, batch_in)
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    ssd_launches = ssd_kernel.ssd_scan_cuda.launches
    say(f"[prefill] counts read after the prefill path: ssd_scan launches = {ssd_launches}, "
        f"decode_attn launches = {dec_kernel.decode_attn_cuda.launches}, "
        f"s2d_conv launches = {s2d_kernel.s2d_conv_cuda.launches}")
    if ssd_launches != cfg.n_layers:
        fail(f"the prefill path launched the SSD kernel {ssd_launches} times, not {cfg.n_layers}")

    # checks (after the counts were read): shape, finite, then the same prefill
    # with the plain ssd_chunked in place of the kernel
    if tuple(logits.shape) != (Bp, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        fail(f"prefill returned {tuple(logits.shape)} logits, or non-finite ones")
    kernel_scan = mamba2.ssd_scan

    def prefill_with(scan, m, p, inp):
        mamba2.ssd_scan = scan
        try:
            return m.prefill(p, inp)
        finally:
            mamba2.ssd_scan = kernel_scan

    def plain_scan(x, la, B, C, dt, chunk):
        return ssd_chunked(x, la, B, C, dt, chunk)

    # a planted fault: the kernel with the state dropped at every chunk boundary
    # (no inter-chunk C S term), each chunk scanned as a row of its own
    def state_dropped(x, la, B, C, dt, chunk):
        n = x.shape[0] * (x.shape[1] // chunk)
        rows = [t.contiguous().reshape(n, chunk, *t.shape[2:]) for t in (x, la, B, C, dt)]
        return ssd_kernel.ssd_scan_cuda(*rows, chunk).reshape(x.shape)

    ref = prefill_with(plain_scan, model, params, batch_in)
    torch.cuda.synchronize()
    if ssd_kernel.ssd_scan_cuda.launches != ssd_launches:
        fail("the plain prefill replay launched the SSD kernel")
    # bf16: read, not held to a limit (see docstring)
    rel_max, rel_rms, agree = logits_gap(logits, ref)
    bad_max, bad_rms, _ = logits_gap(prefill_with(state_dropped, model, params, batch_in), ref)
    del ref
    # the same weights in f32 (kept for the decode check below), two prompts: the
    # kernel within the limit of the plain replay, the planted fault outside it
    f32_model = build_model(dataclasses.replace(cfg, dtype="float32"), "cuda")
    f32_params = f32_model.init(torch.Generator(device="cuda").manual_seed(0))
    f32_in = {"tokens": toks[:2]}
    ref32 = prefill_with(plain_scan, f32_model, f32_params, f32_in)
    f32_max, f32_rms, _ = logits_gap(f32_model.prefill(f32_params, f32_in), ref32)
    bad32_max, bad32_rms, _ = logits_gap(
        prefill_with(state_dropped, f32_model, f32_params, f32_in), ref32)
    del ref32
    say(f"[prefill] vs the plain replay, max|d|/max|ref| and rms|d|/rms|ref|: bf16 kernel "
        f"{rel_max:.4e} {rel_rms:.4e}, bf16 planted fault {bad_max:.4e} {bad_rms:.4e}; f32 kernel "
        f"{f32_max:.3e} {f32_rms:.3e}, f32 planted fault {bad32_max:.3e} {bad32_rms:.3e}")
    if not (f32_max <= PREFILL_F32_TOL["max"] and f32_rms <= PREFILL_F32_TOL["rms"]):
        fail(f"f32 prefill logits vs the plain replay: max|d|/max|ref| {f32_max:.3e}, "
             f"rms|d|/rms|ref| {f32_rms:.3e} (limits {PREFILL_F32_TOL})")
    if bad32_max <= PREFILL_F32_TOL["max"] and bad32_rms <= PREFILL_F32_TOL["rms"]:
        fail(f"the f32 prefill limits {PREFILL_F32_TOL} pass the planted fault "
             f"(max {bad32_max:.3e}, rms {bad32_rms:.3e})")
    # steady state: a timed prefill, its peak memory, then one under torch.profiler
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(params, batch_in)
    torch.cuda.synchronize()
    pre_wall = time.perf_counter() - t0
    dev = device_activity(torch, lambda: model.prefill(params, batch_in))
    dev_ms = sum(ms for _, ms in dev.values())
    n_dev = sum(n for n, _ in dev.values())
    ssd_ms = sum(ms for name, (_, ms) in dev.items() if "ssd_scan" in name)
    top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:6]
    report["prefill"] = pre_line = dict(
        arch=arch, batch=Bp, prompt=Lp, dtype=cfg.dtype, load_s=ssm_load_s,
        first_wall_s=first_wall, wall_s=pre_wall, ms_per_prefill=pre_wall * 1e3,
        prompt_tokens_per_s=Bp * Lp / pre_wall, launches=ssd_launches,
        logits_max_rel=rel_max, logits_rms_rel=rel_rms, argmax_agree=agree,
        fault_logits_max_rel=bad_max, fault_logits_rms_rel=bad_rms,
        f32_fault_logits_max_rel=bad32_max, f32_fault_logits_rms_rel=bad32_rms,
        f32_logits_max_rel=f32_max, f32_logits_rms_rel=f32_rms,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        device_ms=dev_ms, device_ops=n_dev,
        device_busy_share=dev_ms / (pre_wall * 1e3) if n_dev else None,
        ssd_scan_ms=ssd_ms, ssd_scan_share=ssd_ms / dev_ms if n_dev else None,
        top_device=[dict(name=k, ops=n, ms=ms) for k, (n, ms) in top],
    )
    say("[prefill] {arch} {dtype} B={batch} L={prompt}: load={load_s:.2f} s first={first_wall_s:.3f} s "
        "ms/prefill={ms_per_prefill:.3f} prompt tokens/s={prompt_tokens_per_s:.1f} "
        "peak={peak_mem_gb:.2f} GB; plain replay: logits max|d|/max|ref| {logits_max_rel:.4e}, "
        "rms|d|/rms|ref| {logits_rms_rel:.4e}, argmax agrees {argmax_agree:.4f}; in f32: "
        "max {f32_logits_max_rel:.3e}, rms {f32_logits_rms_rel:.3e}".format(**pre_line))
    if n_dev:
        say("[where] prefill: device busy {device_ms:.3f} ms = {device_busy_share:.4f} of the wall; "
            "{device_ops} device ops; ssd_scan {ssd_scan_ms:.3f} ms = {ssd_scan_share:.4f} of "
            "device time".format(**pre_line))
        for d in pre_line["top_device"]:
            say(f"[where]   {d['ms']:.3f} ms in {d['ops']} x {d['name'][:100]}")
    else:
        say("[where] prefill: device time not measured "
            "(torch.profiler recorded no device activity)")

    # (iv) ssm decode: the O(1) recurrent step, which launches no kernel
    n_tok = SSM["tokens"]
    s2d_kernel.s2d_conv_cuda.launches = 0
    dec_kernel.decode_attn_cuda.launches = 0
    ssd_kernel.ssd_scan_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = serve.decode(model, params, tokens=n_tok, batch=Bp, ctx=n_tok)
    torch.cuda.synchronize()
    ssm_wall = time.perf_counter() - t0
    counts = (ssd_kernel.ssd_scan_cuda.launches, dec_kernel.decode_attn_cuda.launches)
    say(f"[decode] counts read after the ssm decode path: ssd_scan launches = {counts[0]}, "
        f"decode_attn launches = {counts[1]}")
    if counts != (0, 0):
        fail(f"the ssm decode path launched kernels: ssd_scan, decode_attn = {counts}")
    if tuple(seq.shape) != (Bp, n_tok) or not bool(((seq >= 0) & (seq < cfg.vocab_size)).all()):
        fail(f"ssm decode returned {tuple(seq.shape)} ids, or ids outside the vocabulary")
    dev = device_activity(torch, lambda: serve.decode(model, params, tokens=n_tok, batch=Bp,
                                                      ctx=n_tok))
    dev_ms = sum(ms for _, ms in dev.values())
    n_dev = sum(n for n, _ in dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:6]
    # the JAX package's cross-path check at full width, in f32 as there: one
    # prompt of two chunks, token by token through decode_step, against prefill
    Lc = SSM["check_prompt"]
    ctoks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, Lc), dtype=np.int64)).cuda()
    pre = f32_model.prefill(f32_params, {"tokens": ctoks})
    cache = f32_model.init_cache(1, Lc)
    for i in range(Lc):
        step_logits, cache = f32_model.decode_step(f32_params, ctoks[:, i], cache, i)
    c_max, c_rms, c_agree = logits_gap(step_logits, pre)
    c_excess = ((step_logits - pre).abs() - CROSS_TOL["rtol"] * pre.abs()).max().item()
    del f32_model, f32_params, cache
    report["ssm_decode"] = sd_line = dict(
        arch=arch, batch=Bp, tokens=n_tok, dtype=cfg.dtype, wall_s=ssm_wall,
        ms_per_token=ssm_wall / n_tok * 1e3, tokens_per_s=Bp * n_tok / ssm_wall,
        ssd_scan_launches=counts[0], decode_attn_launches=counts[1],
        device_ms=dev_ms, device_ops=n_dev, device_ops_per_step=n_dev / n_tok,
        device_busy_share=dev_ms / (ssm_wall * 1e3) if n_dev else None,
        top_device=[dict(name=k, ops=n, ms=ms) for k, (n, ms) in top],
        cross_prompt=Lc, cross_max_rel=c_max, cross_rms_rel=c_rms, cross_argmax_agree=c_agree,
        cross_max_excess=c_excess,
    )
    say("[decode] {arch} {dtype} B={batch} {tokens} tokens: wall={wall_s:.3f} s "
        "ms/token={ms_per_token:.3f} tokens/s={tokens_per_s:.1f}; f32 decode vs prefill of a "
        "{cross_prompt}-token prompt: max|d|/max|ref| {cross_max_rel:.4e}, rms|d|/rms|ref| "
        "{cross_rms_rel:.4e}, max(|d| - rtol |ref|) {cross_max_excess:.3e}, argmax agrees "
        "{cross_argmax_agree:.1f}".format(**sd_line))
    if n_dev:
        say("[where] ssm decode: device busy {device_ms:.3f} ms = {device_busy_share:.4f} of the "
            "wall; {device_ops} device ops ({device_ops_per_step:.1f} per step)".format(**sd_line))
        for d in sd_line["top_device"]:
            say(f"[where]   {d['ms']:.3f} ms in {d['ops']} x {d['name'][:100]}")
    else:
        say("[where] ssm decode: device time not measured "
            "(torch.profiler recorded no device activity)")
    if not bool(torch.isfinite(step_logits).all()):
        fail("the ssm decode produced non-finite logits")
    if c_excess > CROSS_TOL["atol"]:
        fail(f"f32 decode vs prefill of a {Lc}-token prompt: |d| exceeds "
             f"{CROSS_TOL['atol']} + {CROSS_TOL['rtol']} |ref| by {c_excess:.3e}")

    # (v) the paper's method: no kernel of the port on this path
    s2d_kernel.s2d_conv_cuda.launches = 0
    dec_kernel.decode_attn_cuda.launches = 0
    ssd_kernel.ssd_scan_cuda.launches = 0
    t0 = time.perf_counter()
    paper_method(torch, report)
    counts = (s2d_kernel.s2d_conv_cuda.launches, dec_kernel.decode_attn_cuda.launches,
              ssd_kernel.ssd_scan_cuda.launches)
    say(f"[paper] counts read after phase (v): s2d_conv, decode_attn, ssd_scan launches = "
        f"{counts}; phase (v) took {time.perf_counter() - t0:.1f} s")
    if counts != (0, 0, 0):
        fail(f"phase (v) launched kernels of the port: {counts}")

    # ---- 5. kernels line -----------------------------------------------------
    # the main path's work: its variant layers once each, B=1, f32
    main_rows = {r["shape"]: r for r in rows if r["B"] == 1 and r["dtype"] == "float32"}
    sel = [main_rows[shapes[(v.H, v.W, v.C, v.K, v.gamma)]] for v in run_layers]
    bound_ms, bound_by = bound(sum(r["t_bytes_ms"] for r in sel),
                               sum(r["t_ops_ms"] for r in sel))
    entry = dict(
        name="s2d_conv", route="cuda", source="src/repro_torch/csrc/s2d_conv.cu",
        replaces="src/repro/kernels/s2d_conv/kernel.py:24",
        launches=launches, max_abs_err=max_err,
        ms=sum(r["kernel_ms"] for r in sel),
        plain_ms=sum(r["plain_ms"] for r in sel),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=sum(r["library_ms"] for r in sel),
    )
    # decode attention at the serving shape with the full cache valid, bf16; the
    # kernel and SDPA cold-L2, as a layer of the serving loop meets its cache
    (main,) = [r for r in dec_rows if (r["B"], r["L"], (r["H"], r["Dh"]), r["valid"], r["dtype"])
               == (batch, ctx, serve_heads, ctx, "bfloat16")]
    dec_entry = dict(
        name="decode_attn", route="cuda", source="src/repro_torch/csrc/decode_attn.cu",
        replaces="src/repro/kernels/decode_attn/kernel.py:24",
        launches=dec_launches, max_abs_err=main["max_abs_err"],
        ms=main["cold_ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=main["library_cold_ms"],
    )
    # the SSD scan at the prefill path's shape in the model's dtypes
    (main,) = [r for r in ssd_rows if r["main_path"] and r["dtype"] == "bfloat16"]
    ssd_entry = dict(
        name="ssd_scan", route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:27",
        launches=ssd_launches, max_abs_err=main["max_abs_err"],
        ms=main["kernel_ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=None,
    )
    report["kernels"] = [entry, dec_entry, ssd_entry]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    say(json.dumps({"kernels": report["kernels"]}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
