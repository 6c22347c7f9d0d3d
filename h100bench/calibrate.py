"""Readings that set a cell's limits, on the card at the cell's own size.

    python3 h100bench/calibrate.py --workload mamba2-1.3b.train-2k \\
        --seeds 11 12 13 --control 3 --faults half_batch labels_unshifted

For each seed, in one process: the cell's set-up, as many items as the
comparison needs (one prefill; the training cell's checked steps, which
are part of its set-up), then the comparison with the reference, as a
run makes it: the sound reading.
The first ``--control`` seeds also read the control (the reference in
float8 in the program's place); each of ``--faults`` is planted
underneath the timed path (:mod:`h100bench.faults`) on the first three
seeds.  Each reading is a JSON line on standard output.  The benchmark's
runs never run this.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import argparse  # noqa: E402

import torch  # noqa: E402

from h100bench import faults, harness  # noqa: E402


def reading(ctx, drv, control: bool):
    """The sound (or faulted) numbers of one seed, and the control's."""
    t0 = time.perf_counter()
    st = drv.setup(ctx)
    for i in range(drv.check_items(ctx)):
        drv.item(ctx, st, i)
    out = {"run": drv.check(ctx, st)}
    if control:
        out["control"] = drv.control(ctx, st)
    return out, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    plan = [(s, "sound") for s in args.seeds]
    plan += [(s, f) for f in args.faults for s in args.seeds[:3]]
    for seed, what in plan:
        ctx = harness.context(ROOT, args.workload, seed, args.device, False,
                              log=lambda s: print(s, file=sys.stderr, flush=True))
        drv = harness.driver(ctx)
        if what == "sound":
            nums, secs = reading(ctx, drv, seed in args.seeds[: args.control])
        else:
            with faults.planted(what):
                nums, secs = reading(ctx, drv, False)
        line = {"workload": args.workload, "seed": seed, "what": what, "numbers": nums,
                "seconds": secs}
        if torch.cuda.is_available():
            line["device"] = torch.cuda.get_device_name()
        print(json.dumps(line), flush=True)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
