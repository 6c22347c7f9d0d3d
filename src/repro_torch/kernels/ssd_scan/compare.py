"""Time variant sources of ``csrc/ssd_scan.cu`` against each other on the card.

    python -m repro_torch.kernels.ssd_scan.compare a.cu b.cu ... [--rounds 3] [--reps 20]

Each source is built with ``nvcc`` as the kernel is (in parallel) and bound
through :func:`kernel.ssd_scan_cuda`.  At mamba2-1.3b's prefill shape
(Bt=8, L=4096, H=64, P=64, N=128, Q=256), in bf16 and in f32, every
variant's output is held against the first one's, and its mean time a
call in a CUDA-graph replay is taken in turns (the variants in order, then
in reverse), ``rounds`` times, so a drift of the card's pace falls on all
of them alike.  Prints the card's name and power limit, a line a variant,
and one JSON object as the last line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.kernels.nvcc import CudaLibrary
from repro_torch.kernels.ssd_scan import kernel

PREFILL = (8, 4096, 64, 64, 128, 256)  # Bt, L, H, P, N, Q


def _inputs(seed: int, dtype: torch.dtype):
    """chip_smoke.py's SSD distributions, drawn on the card; log_a, dt f32."""
    Bt, L, H, P, N, _ = PREFILL
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    x, B, C = n(Bt, L, H, P), n(Bt, L, N), n(Bt, L, N)
    log_a = -n(Bt, L, H).abs() * 0.3
    dt = torch.nn.functional.softplus(n(Bt, L, H))
    return x.to(dtype), log_a, B.to(dtype), C.to(dtype), dt


def _graph_ms(fn, reps: int) -> float:
    fn()  # outside capture: builds, loads and sets the kernel's attributes
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="+", help="variant sources of ssd_scan.cu")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else "nvidia-smi: no output")
    libs = [CudaLibrary(str(Path(s).resolve()), kernel._bind) for s in args.sources]
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs))
    default_load = kernel.load
    rows = []
    try:
        for dtype in (torch.bfloat16, torch.float32):
            ins = _inputs(args.seed, dtype)
            Q = PREFILL[-1]
            outs, ms = [], [[] for _ in libs]
            for lib in libs:
                kernel.load = lib.load
                outs.append(kernel.ssd_scan_cuda(*ins, Q).float())
            for _ in range(args.rounds):
                for order in (range(len(libs)), reversed(range(len(libs)))):
                    for i in order:
                        kernel.load = libs[i].load
                        ms[i].append(_graph_ms(lambda: kernel.ssd_scan_cuda(*ins, Q), args.reps))
            scale = outs[0].abs().max().item()
            for src, out, t in zip(args.sources, outs, ms):
                row = dict(source=src, dtype=str(dtype).split(".")[1], ms=t,
                           mean_ms=sum(t) / len(t),
                           max_abs_diff_vs_first=(out - outs[0]).abs().max().item(),
                           max_abs_first=scale)
                rows.append(row)
                print("[compare] {source} {dtype} mean_ms={mean_ms:.5f} "
                      "max|d| vs first={max_abs_diff_vs_first:.3e} ms={ms}".format(**row))
            del ins, outs
    finally:
        kernel.load = default_load
    print(json.dumps({"shape": PREFILL, "rounds": args.rounds, "reps": args.reps,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
