"""Faults planted in zamba2's program, to read the cell's limit against them.

    python3 h100bench/zamba2_faults.py --workload zamba2-7b.prefill-4k \\
        --seeds 41 42 43 --faults groups_collapsed norm_not_grouped

Each fault is planted underneath the timed path for as long as its
context is open, on the fused route (a CUDA tensor with grad off) and on
the plain passes (the CPU) alike:

* ``adapter_of_next_site``: site i runs the MLP adapter of site i + 1;
* ``scale_inv_sqrt_dh``: attention scaled by 1/sqrt(Dh), not (Dh/2)^-1/2;
* ``groups_collapsed``: every head reads the first group's B and C;
* ``one_layer_groups_swapped``: in the middle Mamba layer alone, each
  group's heads read the other group's B and C (a partial fault);
* ``norm_not_grouped``: the gated out-norm takes one rms over d_inner.

For each seed and fault, in one process, ``calibrate.reading``: the
cell's set-up and checked item with the fault planted, then the
comparison with the reference as a run makes it.  Each reading is a JSON
line on standard output.  The benchmark's runs never run this.
"""

import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import argparse  # noqa: E402

import torch  # noqa: E402

from h100bench import calibrate, harness  # noqa: E402

FAULTS = ("adapter_of_next_site", "scale_inv_sqrt_dh", "groups_collapsed",
          "one_layer_groups_swapped", "norm_not_grouped")


def _patches(name: str, n_layers: int):
    """[(module, attribute, replacement)] of a fault."""
    from repro_torch.kernels.mamba_passes import kernel as mp
    from repro_torch.kernels.mamba_passes import ref as passes_ref
    from repro_torch.models import common, mamba2, model_api, zamba2
    from repro_torch.tree import tree_map

    if name == "adapter_of_next_site":
        build = model_api.build_model

        def build_rolled(cfg, device=None):
            model = build(cfg, device)
            f = model.prefill
            model.prefill = lambda p, b: f(dict(p, adapters=tree_map(
                lambda t: torch.roll(t, -1, dims=0), p["adapters"])), b)
            return model
        return [(model_api, "build_model", build_rolled)]
    if name == "scale_inv_sqrt_dh":
        return [(zamba2, "flash_attention",
                 lambda q, k, v, scale=None, **kw: common.flash_attention(q, k, v, **kw))]
    if name in ("groups_collapsed", "one_layer_groups_swapped"):
        scan, calls = mamba2.ssd_scan, [0]

        def planted(x, log_a, B, C, dt, chunk):
            layer, calls[0] = calls[0] % n_layers, calls[0] + 1
            if name == "groups_collapsed":
                B, C = B[:, :, :1].expand_as(B), C[:, :, :1].expand_as(C)
            elif layer == n_layers // 2:
                B, C = B.flip(2), C.flip(2)
            return scan(x, log_a, B, C, dt, chunk)
        return [(mamba2, "ssd_scan", planted)]
    if name == "norm_not_grouped":
        gate_norm = mp.gate_norm_cuda
        return [(mp, "gate_norm_cuda", lambda *a: gate_norm(*a[:7], 1)),
                (passes_ref, "gated_norm",
                 lambda cfg, p, y: passes_ref.rmsnorm(p["out_norm"], y, cfg.norm_eps))]
    raise ValueError(f"no fault {name!r}; there are {FAULTS}")


@contextlib.contextmanager
def planted(name: str, n_layers: int):
    """The port runs with fault ``name`` while this is open (``n_layers``:
    the model's Mamba layers, for the fault of one layer)."""
    patches = _patches(name, n_layers)
    kept = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    for mod, attr, new in patches:
        setattr(mod, attr, new)
    try:
        yield
    finally:
        for mod, attr, old in kept:
            setattr(mod, attr, old)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="+", choices=FAULTS, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for what in args.faults:
        for seed in args.seeds:
            ctx = harness.context(ROOT, args.workload, seed, args.device, False,
                                  log=lambda s: print(s, file=sys.stderr, flush=True))
            drv = harness.driver(ctx)
            with planted(what, ctx.widths["n_layers"]):
                nums, secs = calibrate.reading(ctx, drv, False)
            line = {"workload": args.workload, "seed": seed, "what": what, "numbers": nums,
                    "seconds": secs}
            if torch.cuda.is_available():
                line["device"] = torch.cuda.get_device_name()
            print(json.dumps(line), flush=True)
            if torch.cuda.is_available():
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
