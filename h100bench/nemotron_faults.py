"""Faults planted in nemotron_h's program, to read the cell's limits against them.

    python3 h100bench/nemotron_faults.py --workload nemotron-3-nano-30b-a3b.prefill-4k \\
        --seeds 41 42 43 --faults softmax_router bias_ignored

Each fault is planted underneath the timed path for as long as its
context is open, on the grouped route (a bf16 CUDA tensor with grad off)
and on the plain one alike:

* ``softmax_router``: the router's scores a softmax, not a sigmoid;
* ``bias_ignored``: the correction bias left out of the selection;
* ``bias_in_weights``: the correction bias added into the weights too;
* ``not_normalised``: the chosen weights not normalised;
* ``not_scaled``: the chosen weights not times routed_scaling_factor;
* ``relu_not_squared``: relu in place of relu², routed and shared experts;
* ``no_shared_expert``: the shared expert left out;
* ``capacity_drops``: a capacity of 1.25 T k / E routes an expert, the
  routes past it (in token order) dropped;
* ``one_layer_groups_swapped``: in the middle Mamba layer alone, the B/C
  groups in reverse order (``zamba2_faults``');
* ``norm_not_grouped``: the gated out-norm over all of d_inner
  (``zamba2_faults``');
* ``rotary_applied``: rotary embedding (theta 1e4) on the attention
  layers' q and k.

Two more are planted below the route, in the bf16 code the window times
alone, so that only ``layer_err_bf16`` (and the teacher-forced
``logits_err``) can see them (:data:`ROUTE_FAULTS`):

* ``ends_off_by_one``: the grouped GEMMs' group ends (``offs`` of
  ``torch._grouped_mm``, which ``moe_dropless.experts_grouped`` calls) one
  row early, so each expert's last sorted row goes through the next
  expert's weights;
* ``flash_wrong_kv_head``: a build of ``csrc/flash_attn.cu`` in which query
  head h reads KV head ``h % Hkv`` in place of ``h / (H / Hkv)``.

For each seed and fault, in one process, ``calibrate.reading``: the
cell's set-up and checked item with the fault planted, then the
comparison with the reference as a run makes it.  Each reading is a JSON
line on standard output.  The benchmark's runs never run this.
"""

import contextlib
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import argparse  # noqa: E402

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from h100bench import calibrate, harness, zamba2_faults  # noqa: E402

ROUTER = ("softmax_router", "bias_ignored", "bias_in_weights", "not_normalised", "not_scaled")
#: the faults planted above the route: the float32 program carries them too
EVERY_ROUTE = ROUTER + ("relu_not_squared", "no_shared_expert", "capacity_drops",
                        "one_layer_groups_swapped", "norm_not_grouped", "rotary_applied")
#: the faults planted in the bf16 route alone (the grouped GEMMs, the flash kernel)
ROUTE_FAULTS = ("ends_off_by_one", "flash_wrong_kv_head")
FAULTS = EVERY_ROUTE + ROUTE_FAULTS
#: the line of csrc/flash_attn.cu that maps a query head to its KV head, and its fault
FLASH_KV_HEAD = ("hk = h / (H / Hkv);", "hk = h % Hkv;")


def _router(name: str):
    """``moe_dropless.route`` with fault ``name``."""
    def route(cfg, p, x):
        logits = x.float() @ p["router"]["w"].float()
        scores = torch.softmax(logits, -1) if name == "softmax_router" else torch.sigmoid(logits)
        biased = scores if name == "bias_ignored" else scores + p["e_bias"]
        ids = torch.topk(biased, cfg.experts_per_token, dim=-1).indices
        w = (biased if name == "bias_in_weights" else scores).gather(1, ids)
        if name != "not_normalised":
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        return ids, w * (1.0 if name == "not_scaled" else cfg.routed_scaling_factor)
    return route


def _capacity_route(route):
    """``route`` whose weights are zero past each expert's capacity."""
    def capped(cfg, p, x):
        ids, w = route(cfg, p, x)
        E = cfg.n_experts
        cap = math.ceil(1.25 * ids.numel() / E)
        onehot = F.one_hot(ids.reshape(-1), E)
        rank = (torch.cumsum(onehot, 0) * onehot).sum(-1).reshape(ids.shape)
        return ids, torch.where(rank > cap, torch.zeros_like(w), w)
    return capped


def _ends_off_by_one():
    """``torch._grouped_mm`` with every group but the last ending one row
    early."""
    real = torch._grouped_mm

    def shifted(a, b, offs, **kw):
        return real(a, b, offs=torch.cat([offs[:-1] - 1, offs[-1:]]), **kw)
    return [(torch, "_grouped_mm", shifted)]


def _flash_wrong_kv_head():
    """The flash kernel's ``load`` returning a build of its source with
    :data:`FLASH_KV_HEAD` planted."""
    import tempfile

    from repro_torch.kernels.flash_attn import kernel
    from repro_torch.kernels.nvcc import CSRC, CudaLibrary

    src = (CSRC / "flash_attn.cu").read_text()
    sound, fault = FLASH_KV_HEAD
    if src.count(sound) != 1:
        raise RuntimeError(f"flash_attn.cu no longer holds {sound!r} once, to plant the fault in")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "flash_attn_wrong_kv_head.cu"
        path.write_text(src.replace(sound, fault))
        lib = CudaLibrary(str(path), kernel._bind).load()
    return [(kernel, "load", lambda: lib)]


def _patches(name: str, n_mamba: int):
    """[(module, attribute, replacement)] of a fault."""
    from repro_torch.models import common, moe_dropless, nemotron_h

    if name in ROUTER:
        return [(moe_dropless, "route", _router(name))]
    if name == "capacity_drops":
        return [(moe_dropless, "route", _capacity_route(moe_dropless.route))]
    if name == "relu_not_squared":
        return [(moe_dropless, "relu2", F.relu)]
    if name == "no_shared_expert":
        apply = moe_dropless.moe_apply

        def without(cfg, p, x, routes=None):
            down = p["shared_down"]["w"]
            return apply(cfg, dict(p, shared_down={"w": torch.zeros_like(down)}), x, routes)
        return [(moe_dropless, "moe_apply", without)]
    if name in ("one_layer_groups_swapped", "norm_not_grouped"):
        return zamba2_faults._patches(name, n_mamba)
    if name == "rotary_applied":
        def rotated(q, k, v, **kw):
            pos = torch.arange(q.shape[1], device=q.device).expand(q.shape[0], -1)
            return common.flash_attention(common.apply_rope(q, pos, 1e4),
                                          common.apply_rope(k, pos, 1e4), v, **kw)
        return [(nemotron_h, "flash_attention", rotated)]
    if name == "ends_off_by_one":
        return _ends_off_by_one()
    if name == "flash_wrong_kv_head":
        return _flash_wrong_kv_head()
    raise ValueError(f"no fault {name!r}; there are {FAULTS}")


@contextlib.contextmanager
def planted(name: str, n_mamba: int):
    """The port runs with fault ``name`` while this is open (``n_mamba``:
    the model's Mamba layers, for the fault of one layer)."""
    patches = _patches(name, n_mamba)
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
            with planted(what, ctx.widths["layer_pattern"].count("M")):
                nums, secs = calibrate.reading(ctx, drv, False)
            line = {"workload": args.workload, "seed": seed, "what": what, "numbers": nums,
                    "seconds": secs}
            if torch.cuda.is_available():
                line["device"] = torch.cuda.get_device_name()
            print(json.dumps(line), flush=True)
            del ctx, drv
            if torch.cuda.is_available():
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
