#!/usr/bin/env python3
"""Smoke run of the torch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and ``nvcc``; without a card, or without the
repository beside it, it exits non-zero before printing any result.
Phases, each on lines of its own; any failure exits non-zero:

1. card: ``nvidia-smi`` name and power limit, and the torch device;
2. build: the s2d-conv and decode-attention kernels compiled from
   ``csrc/s2d_conv.cu`` and ``csrc/decode_attn.cu``, one ``nvcc`` each,
   started together (seconds of each);
3. kernel: each kernel against its plain version on the card.
   s2d-conv (``ref.s2d_conv_ref``): at the ``tests/test_kernels.py``
   shapes and at every pointwise variant layer the ``multicam_heavy`` @
   ``6k_1ws2os`` plans select, for batches 1 and 8 in f32 and bf16;
   tolerances: f32 max|d| <= 1e-4 max|ref| (another accumulation order),
   bf16 <= 2e-2 max|ref| (bf16 output rounding).  Decode attention
   (``ref.decode_attention``): at the ``tests/test_kernels.py`` shapes
   and at the serving shape (B=8, L=2048, H=32, Hkv=8, Dh=64) with 256
   and 2048 valid positions, in f32 and bf16; tolerances: f32
   |d| <= 1e-5 + 1e-4 |ref| (another summation order), bf16 max|d| <=
   2e-2 max|ref| (the plain version rounds the softmax weights to bf16).
   Device times (CUDA-graph replay) of the kernel, the plain version and
   one library call (``torch.matmul`` on the reshaped views;
   ``scaled_dot_product_attention(..., enable_gqa=True)`` on transposed
   copies of the valid positions: yardsticks the port never calls), the
   bound max(bytes / 3.35 TB/s, operations / peak), and the kernel
   wrapper's cost per call when launched back to back from Python.  At
   the serving shapes the decode kernel and SDPA are also timed cold
   (calls taking turns over copies of the cache twice the 50 MB L2), and
   the kernels line takes those;
4. main paths, each with its launch count set to 0 just before and read
   just after:
   (i) ``simulate_batch`` on the card for (a) ``multicam_heavy`` @
   ``6k_1ws2os``, terastal, default arrivals, 8 seeds, 1.0 s and (b)
   ``saturation_5x`` @ ``4k_1ws2os``, terastal, poisson, 32 seeds, 0.1 s;
   then the pointwise variant layers of the models that applied variants
   in (a) run through ``run_pointwise_variants`` (the s2d-conv kernel).
   Every lane's fingerprint must equal the host ``simulate(engine="soa")``,
   (a) must apply variants, and the variant outputs must match the plain
   version.  Then the engine runs cell (b) again under ``torch.profiler``:
   the device's busy share of the first run's wall, and device ops per
   loop iteration;
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
   Then the
   decode loop runs once more under ``torch.profiler``: the device's busy
   share of the first run's wall, device ops per step, and the decode
   kernel's share of device time;
5. the ``{"kernels": [...]}`` line, then the card line, then
   ``{"ok": true, "device": {...}}`` as the last line.

All rows also go to ``chiprun_out/chip_smoke.json``.
"""

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
PEAK = {"float32": 67e12, "bfloat16": 989e12}  # f32 CUDA cores; bf16 dense tensor
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TEST_SHAPES = [  # (B, H, W, C, K, g), tests/test_kernels.py
    (2, 8, 8, 16, 32, 2), (1, 16, 16, 64, 64, 2), (2, 12, 12, 36, 72, 3),
    (1, 8, 8, 256, 128, 2), (1, 4, 4, 512, 512, 2),
]
DECODE_SHAPES = [  # (B, L, H, Hkv, Dh, valid): tests/test_kernels.py, then serving
    (2, 64, 8, 2, 16, 64), (1, 128, 4, 4, 32, 81), (3, 256, 16, 8, 64, 256),
    (1, 64, 8, 1, 128, 11), (8, 2048, 32, 8, 64, 256), (8, 2048, 32, 8, 64, 2048),
]
SERVE = dict(arch="llama3.2-1b", batch=8, ctx=2048, tokens=256)
# logits, kernel run vs plain replay, at every step: rms|d| <= 5e-2 rms|ref| and
# max|d| <= 0.1 max|ref|.  The two runs differ by bf16 rounding of the softmax
# weights, which compounds over 16 layers and over the steps' cached keys and
# values; a wrong kernel (a head, a position, a split) changes logits by O(1).
SERVE_TOL = dict(rms=5e-2, max=0.1)


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


def bound(t_bytes, t_ops):
    """Least time (ms) for work whose bytes take ``t_bytes`` at the HBM
    rate and whose operations take ``t_ops`` at the type's peak."""
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def floor_times(x, w, out):
    """(ms over HBM, ms at peak) for one call: every input read once and
    the output written once; 2*M*Cv*Kv operations."""
    nbytes = (x.numel() + w.numel() + out.numel()) * x.element_size()
    ops = 2.0 * (x.numel() // w.shape[0]) * w.shape[0] * w.shape[1]
    return nbytes / HBM_BPS * 1e3, ops / PEAK[str(x.dtype).split(".")[1]] * 1e3


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
    from repro_torch.launch import serve
    from repro_torch.models import transformer

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

    kernel_mods = {"s2d_conv": s2d_kernel, "decode_attn": dec_kernel}
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
            got = dec_kernel.decode_attn_cuda(q3, k, v, vl)[:, None]
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
                valid=valid, dtype=dn, splits=dec_kernel.default_splits(q.device, B, Hkv, L),
                max_abs_err=err, max_abs_ref=scale, tol=tol, ok=ok,
                kernel_ms=graph_ms(torch, lambda: dec_kernel.decode_attn_cuda(q3, k, v, vl)),
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
                    lambda kc=kc, vc=vc: dec_kernel.decode_attn_cuda(q3, kc, vc, vl)
                    for kc, vc in copies])
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

    # ---- 4. main paths ------------------------------------------------------
    # (i) the batched-trial engine and the variant layers
    cells = [
        ("a", SCENARIOS["multicam_heavy"], "6k_1ws2os", None, 8, 1.0),
        ("b", SATURATION_SCENARIOS["saturation_5x"], "4k_1ws2os", "poisson", 32, 0.1),
    ]
    s2d_kernel.s2d_conv_cuda.launches = 0
    dec_kernel.decode_attn_cuda.launches = 0
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
        f"decode_attn launches = {dec_kernel.decode_attn_cuda.launches}")
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
    kept = []  # every step's logits, for the replay
    decode_step = model.decode_step

    def keep_logits(p, t, c, pos):
        logits, c = decode_step(p, t, c, pos)
        kept.append(logits)
        return logits, c

    model.decode_step = keep_logits
    s2d_kernel.s2d_conv_cuda.launches = 0
    dec_kernel.decode_attn_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = serve.decode(model, params, tokens=n_tok, batch=batch, ctx=ctx)
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    dec_launches = dec_kernel.decode_attn_cuda.launches
    model.decode_step = decode_step
    say(f"[serve] counts read after the serving path: decode_attn launches = {dec_launches}, "
        f"s2d_conv launches = {s2d_kernel.s2d_conv_cuda.launches}")
    if dec_launches != cfg.n_layers * n_tok:
        fail(f"the serving path launched the decode kernel {dec_launches} times, "
             f"not {cfg.n_layers} x {n_tok}")

    # checks (after the counts were read): shape, ids, finite logits, then the
    # same steps through the plain attention, fed the kernel run's tokens
    if tuple(seq.shape) != (batch, n_tok) or len(kept) != n_tok:
        fail(f"serve returned {tuple(seq.shape)} ids and {len(kept)} logits")
    if not bool(((seq >= 0) & (seq < cfg.vocab_size)).all()):
        fail("serve returned ids outside the vocabulary")
    plain_attention = transformer.gqa_decode_attention
    transformer.gqa_decode_attention = (
        lambda q, k, v, pos, valid_len=None: decode_attention(q, k, v, pos))
    stats, agree = [], 0
    try:
        cache = model.init_cache(batch, ctx)
        tok = torch.zeros((batch,), dtype=torch.int32, device="cuda")
        for i in range(n_tok):
            ref, cache = model.decode_step(params, tok, cache, i)
            d = kept[i] - ref
            stats.append(torch.stack([d.abs().max(), ref.abs().max(),
                                      d.pow(2).mean().sqrt(), ref.pow(2).mean().sqrt()]))
            agree += int((ref.argmax(-1) == seq[:, i]).sum())
            tok = seq[:, i]
    finally:
        transformer.gqa_decode_attention = plain_attention
    if dec_kernel.decode_attn_cuda.launches != dec_launches:
        fail("the plain replay launched the decode kernel")
    if not all(bool(torch.isfinite(lg).all()) for lg in kept):
        fail("serve produced non-finite logits")
    d_max, r_max, d_rms, r_rms = torch.stack(stats).cpu().numpy().T
    rel_max, rel_rms = d_max / r_max, d_rms / r_rms
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
    )
    say("[serve] {arch} {dtype} B={batch} ctx={ctx} {tokens} tokens: load={load_s:.2f} s "
        "wall={wall_s:.3f} s ms/token={ms_per_token:.3f} tokens/s={tokens_per_s:.1f}; "
        "plain replay: logits max|d| {logits_max_abs_err:.4e} (max|ref| "
        "{logits_max_abs_ref:.3f}); worst step max|d|/max|ref| {worst_max_rel:.4f} (step "
        "{worst_max_rel_step}), rms|d|/rms|ref| {worst_rms_rel:.4f} (step "
        "{worst_rms_rel_step}, median {median_rms_rel:.4f}); argmax agrees "
        "{argmax_agree:.4f}".format(**serve_line))

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
    (main,) = [r for r in dec_rows if (r["B"], r["L"], r["H"], r["valid"], r["dtype"])
               == (batch, ctx, cfg.n_heads, ctx, "bfloat16")]
    dec_entry = dict(
        name="decode_attn", route="cuda", source="src/repro_torch/csrc/decode_attn.cu",
        replaces="src/repro/kernels/decode_attn/kernel.py:24",
        launches=dec_launches, max_abs_err=main["max_abs_err"],
        ms=main["cold_ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=main["library_cold_ms"],
    )
    report["kernels"] = [entry, dec_entry]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    say(json.dumps({"kernels": report["kernels"]}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
