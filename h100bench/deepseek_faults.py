"""Faults planted in deepseek_v3's program, to read the cell's limits against them.

    python3 h100bench/deepseek_faults.py --workload deepseek-v3.prefill-16k \\
        --seeds 41 --faults mscale_left_out rope_not_interleaved

Each fault is planted underneath the timed path for as long as its
context is open, on the kernels' route (a bf16 CUDA tensor with grad off)
and on the plain one alike (:data:`EVERY_ROUTE`):

* ``mscale_left_out``: the softmax scale 192^-1/2, without YaRN's mscale²;
* ``rope_not_interleaved``: the rope on the halves of the rope dims as they
  come, without the release's de-interleaving of the pairs;
* ``ckv_norm_left_out``: W_kvb applied to c_kv without its RMSNorm;
* ``k_pe_not_rotated``: the rope left off the shared k_pe (q_pe keeps it);
* ``group_limit_left_out``: the top-k over all 256 biased scores, no group
  limit;
* ``bias_in_weights``: the correction bias added into the weights too;
* ``no_shared_expert``: the shared expert left out;
* ``gate_up_swapped``: every SwiGLU (routed and shared experts, the dense
  MLPs) with W_g and W_u swapped, silu(x W_u) * (x W_g);
* ``held_range_shifted``: the layer told it holds experts 1-8 where its
  weights are experts 0-7's.

One more is planted below the route, in the bf16 code the window times
alone, so that only ``layer_err_bf16`` (and the teacher-forced
``logits_err``) can see it (:data:`ROUTE_FAULTS`):

* ``flash_v_stride``: a build of ``csrc/flash_attn.cu`` whose tensor map of
  V steps from head to head by DQK (192) elements, in place of V's own head
  stride (256 in the view of W_kvb's output the model hands it).

For each seed and fault, in one process, ``calibrate.reading``: the cell's
set-up and checked item with the fault planted, then the comparison with
the reference as a run makes it.  Each reading is a JSON line on standard
output.  The benchmark's runs never run this.
"""

import contextlib
import dataclasses
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

#: the faults planted above the route: the float32 program carries them too
EVERY_ROUTE = ("mscale_left_out", "rope_not_interleaved", "ckv_norm_left_out",
               "k_pe_not_rotated", "group_limit_left_out", "bias_in_weights",
               "no_shared_expert", "gate_up_swapped", "held_range_shifted")
#: the faults planted in the bf16 route alone (the flash kernel)
ROUTE_FAULTS = ("flash_v_stride",)
FAULTS = EVERY_ROUTE + ROUTE_FAULTS
#: the tensor map of V in csrc/flash_attn.cu, and its fault
FLASH_V_MAP = ("a.svb, a.svl, a.svh, BN);", "a.svb, a.svl, DQK, BN);")


def _router(name: str):
    """``moe_dropless.route`` with fault ``name``."""
    from repro_torch.models import moe_dropless

    def route(cfg, p, x):
        scores = torch.sigmoid(x.float() @ p["router"]["w"].float())
        biased = scores + p["e_bias"]
        if name != "group_limit_left_out":
            biased = moe_dropless.group_limited(biased, cfg.n_group, cfg.topk_group)
        ids = torch.topk(biased, cfg.experts_per_token, dim=-1).indices
        w = (biased if name == "bias_in_weights" else scores).gather(1, ids)
        return ids, w / (w.sum(dim=-1, keepdim=True) + 1e-20) * cfg.routed_scaling_factor
    return route


def _kv_proj(name: str):
    """``deepseek_v3.kv_proj`` without c_kv's norm or without k_pe's rope."""
    from repro_torch.models import deepseek_v3 as ds
    from repro_torch.models.common import linear, rmsnorm

    def kv_proj(cfg, p, x, cos, sin):
        B, L, _ = x.shape
        H, nope = cfg.n_heads, cfg.qk_nope_dim
        c_kv, k_pe = torch.split(linear(p["kv_a"], x), [cfg.kv_lora_rank, cfg.qk_rope_dim], -1)
        normed = c_kv if name == "ckv_norm_left_out" else rmsnorm(p["kv_norm"], c_kv,
                                                                  cfg.norm_eps)
        kv = linear(p["kv_b"], normed).reshape(B, L, H, nope + cfg.v_head_dim)
        k_pe = k_pe.reshape(B, L, 1, cfg.qk_rope_dim)
        if name != "k_pe_not_rotated":
            k_pe = ds.rope_interleaved(k_pe, cos, sin)
        k = torch.cat([kv[..., :nope], k_pe.expand(B, L, H, cfg.qk_rope_dim)], dim=-1)
        return k, kv[..., nope:]
    return kv_proj


def _rope_halves(x, cos, sin):
    """The rope on ``x``'s halves as they come (no de-interleaving)."""
    xf = x.float()
    a, b = xf.chunk(2, dim=-1)
    c, s = cos[:, None], sin[:, None]
    return torch.cat([a * c - b * s, b * c + a * s], dim=-1).to(x.dtype)


def _flash_v_stride():
    """The flash kernel's ``load`` returning a build of its source with
    :data:`FLASH_V_MAP` planted."""
    import tempfile

    from repro_torch.kernels.flash_attn import kernel
    from repro_torch.kernels.nvcc import CSRC, CudaLibrary

    src = (CSRC / "flash_attn.cu").read_text()
    sound, fault = FLASH_V_MAP
    if src.count(sound) != 1:
        raise RuntimeError(f"flash_attn.cu no longer holds {sound!r} once, to plant the fault in")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "flash_attn_v_stride.cu"
        path.write_text(src.replace(sound, fault))
        lib = CudaLibrary(str(path), kernel._bind).load()
    return [(kernel, "load", lambda: lib)]


def _patches(name: str):
    """[(module, attribute, replacement)] of a fault."""
    from repro_torch.models import deepseek_v3 as ds
    from repro_torch.models import moe_dropless

    if name == "mscale_left_out":
        return [(ds, "softmax_scale", lambda cfg: cfg.head_dim ** -0.5)]
    if name == "rope_not_interleaved":
        return [(ds, "rope_interleaved", _rope_halves)]
    if name in ("ckv_norm_left_out", "k_pe_not_rotated"):
        return [(ds, "kv_proj", _kv_proj(name))]
    if name in ("group_limit_left_out", "bias_in_weights"):
        return [(moe_dropless, "route", _router(name))]
    if name == "gate_up_swapped":
        def swapped(u):
            g, v = u.chunk(2, dim=-1)
            return moe_dropless.glu_activation("swiglu", v, g)
        return [(moe_dropless, "swiglu", swapped)]
    apply = moe_dropless.moe_apply
    if name == "no_shared_expert":
        def without(cfg, p, x, routes=None):
            down = p["shared_down"]["w"]
            return apply(cfg, dict(p, shared_down={"w": torch.zeros_like(down)}), x, routes)
        return [(moe_dropless, "moe_apply", without)]
    if name == "held_range_shifted":
        def shifted(cfg, p, x, routes=None):
            return apply(dataclasses.replace(cfg, expert_offset=cfg.expert_offset + 1), p, x,
                         routes)
        return [(moe_dropless, "moe_apply", shifted)]
    if name == "flash_v_stride":
        return _flash_v_stride()
    raise ValueError(f"no fault {name!r}; there are {FAULTS}")


@contextlib.contextmanager
def planted(name: str):
    """The port runs with fault ``name`` while this is open."""
    patches = _patches(name)
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
            with planted(what):
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
