"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 h100bench/run.py --workload mamba2-1.3b.prefill-4k --seed 7 --seconds 30 --trace 0

From the root of a checkout.  Set-up (the port's kernels built or loaded
from ``src/repro_torch/csrc/build/``, weights and inputs made on the
card from ``--seed``, every shape of the cell warmed), then ``--seconds``
of closed-loop items, then the comparison with the float32 reference.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics), ``device`` (and
``breakdown`` when traced), and last ``checks``, each compared number
beside its limit, which also end standard error.  Exits 2 without a
result where there is no CUDA card or fewer than the cell asks for, and
3 where the process holds a JAX module once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# caches of the program at fixed paths inside the checkout (the nvcc-built
# kernels go to src/repro_torch/csrc/build/, the port's own fixed path)
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from h100bench import harness

    chips = harness.context(ROOT, args.workload, args.seed, "cpu", False).cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # the loop dispatches; no CPU op needs threads
    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t_start=T_START,
                           log=lambda s: print(s, flush=True))
    bad = harness.forbidden_modules()
    if bad:
        print(f"the process holds {bad} after the window; no result", file=sys.stderr)
        return 3
    for name, v in out["checks"].items():
        print(f"[checks] {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
