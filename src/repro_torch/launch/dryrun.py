"""One-card dry run: build every (arch x shape) step on ``meta`` and count it.

Port of the JAX package's ``launch/dryrun.py``.  For each cell this
builds the REAL step function (the train step: ``Model.loss``, its
gradients and ``adamw_update``; the prefill forward; one-token decode
against a ``seq_len`` cache) on the ``meta`` device, so no weight, cache
or activation is allocated, runs it once under
``torch.utils.flop_counter.FlopCounterMode`` and reports:

* ``flops``: the step's matmul FLOPs as counted (every layer: the port
  loops where the reference scans, so nothing is counted once for many),
  beside ``analytics.model_flops``' closed form (``model_flops``);
* ``argument_bytes``: the bytes of the step's arguments (weights, f32
  moments, batch or cache) and whether they fit one H100's 80 GB;
* ``argument_bytes_per_device``: the same arguments per device under the
  fitted spec trees on both production layouts (16x16 and pod2x16x16),
  the counterpart of the reference's
  ``memory_analysis().argument_size_in_bytes``;
* ``collective_bytes_est``: ``analytics.collective_bytes_est`` on the
  report's layout, an estimate (one card runs no collective, and there is
  no partitioned HLO to parse).

The kernels' wrappers send ``meta`` tensors to their plain versions,
whose products the counter sees.  ``collective_bytes`` is the
reference's HLO text parser, kept for reading the reference's dumps.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun.jsonl
"""

import argparse
import json
import re
import sys
import time
import traceback
from typing import Any, Dict, Optional, Union

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.configs.registry import ARCHS, all_cells, shape_applicable
from repro_torch.launch.analytics import collective_bytes_est, model_flops
from repro_torch.launch.mesh import P, make_production_mesh, per_device_bytes
from repro_torch.models.model_api import SHAPES, ShapeSpec, build_model, shape_spec
from repro_torch.optim.adamw import (
    OptConfig,
    init_opt_state,
    make_train_step,
    opt_state_specs,
    zero1_opt_specs,
)
from repro_torch.tree import tree_leaves

#: one H100 SXM's memory (NVIDIA data sheet: 80 GB HBM3)
H100_HBM_BYTES = 80e9

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_OP_RE = re.compile(
    r"=\s+((?:\([^)]*\)|\S+))\s+(" + "|".join(_COLLECTIVES) + r")[\.\s(]"
)


def _shape_bytes(type_str: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(type_str):
        dt, dims = m.group(1), m.group(2)
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * _DTYPE_BYTES.get(dt, 4)
    return total


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Per-device communication bytes by collective kind, from the
    post-partitioning HLO (result-shape bytes per op; see EXPERIMENTS.md
    for the convention)."""
    out: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if m:
            out[m.group(2)] += _shape_bytes(m.group(1))
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    return out


def _apply_overrides(cfg, overrides: Optional[Dict[str, Any]]):
    if not overrides:
        return cfg
    import dataclasses as _dc

    typed = {}
    for k, v in overrides.items():
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            typed[k] = v in (True, "true", "True", "1", 1)
        elif isinstance(cur, int):
            typed[k] = int(v)
        elif isinstance(cur, float):
            typed[k] = float(v)
        else:
            typed[k] = v
    return _dc.replace(cfg, **typed)


class MetaGenerator(torch.Generator):
    """A generator whose ``device`` is ``meta``: ``Model.init`` draws every
    weight on its generator's device, so with this one the parameter tree
    comes out as shapes and dtypes, allocating nothing."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def build_step(arch: str, shape_name: Union[str, ShapeSpec],
               overrides: Optional[Dict[str, Any]] = None):
    """Returns (fn, args, in_specs, out_specs_or_None), every tensor of
    ``args`` on ``meta``.  ``shape_name`` is a :data:`SHAPES` name or a
    :class:`ShapeSpec`."""
    cfg = _apply_overrides(get_config(arch), overrides)
    model = build_model(cfg, "meta")
    sh = shape_spec(shape_name)
    params = model.init(MetaGenerator())

    if sh.kind == "train":
        pspecs = model.param_specs("train")
        opt = init_opt_state(params)
        ospecs = zero1_opt_specs(pspecs, opt) if cfg.fsdp_all_axes else opt_state_specs(pspecs)
        fn = make_train_step(model.loss, OptConfig())
        batch = model.input_specs(shape_name)
        bspecs = model.batch_specs(shape_name)
        metric_specs = {"lr": P(), "grad_norm": P(), "loss": P()}
        return fn, (params, opt, batch), (pspecs, ospecs, bspecs), (pspecs, ospecs, metric_specs)

    if sh.kind == "prefill":
        pspecs = model.param_specs("serve")
        batch = model.input_specs(shape_name)
        bspecs = model.batch_specs(shape_name)
        return model.prefill, (params, batch), (pspecs, bspecs), P()

    # decode
    pspecs = model.param_specs("serve")
    inputs = model.input_specs(shape_name)
    ispecs = model.batch_specs(shape_name)
    fn = lambda p, t, c, pos: model.decode_step(p, t, c, pos)
    out_specs = (P(), ispecs["cache"])
    return (
        fn,
        (params, inputs["token"], inputs["cache"], inputs["pos"]),
        (pspecs, ispecs["token"], ispecs["cache"], ispecs["pos"]),
        out_specs,
    )


def _tensor_args(args, in_specs):
    """The tensor arguments and their specs (the decode position is an int)."""
    keep = [i for i, a in enumerate(args) if not isinstance(a, int)]
    return tuple(args[i] for i in keep), tuple(in_specs[i] for i in keep)


def count_flops(fn, args) -> float:
    """The matmul FLOPs of one call of ``fn(*args)`` (forward and, for a
    train step, backward), by ``FlopCounterMode``."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def dense_count(cfg, shape: Union[str, ShapeSpec]) -> float:
    """The matmul FLOPs of the dense family's step as the port runs it,
    from ``model_flops``' computed count less the products it does not
    run (the dry run's count must equal it):

    * ``matmul_params`` holds each block's two norm scales, which multiply
      no matrix: ``2·2·d_model·n_layers`` FLOPs a token a pass;
    * prefill: the head runs at the last position only, not at all ``L``;
    * train under remat: the loss (the head) is not rematerialised, so it
      runs 3 passes, not 4; and the recompute stops early
      (``torch.utils.checkpoint``'s non-reentrant early stop) before each
      layer's last product, ``w_down``, whose output no backward needs."""
    sh = shape_spec(shape)
    if cfg.family != "dense" or (cfg.remat and cfg.remat_policy != "full"):
        raise ValueError(f"dense_count takes the dense family under remat 'full' or none, "
                         f"not {cfg.family!r} / {cfg.remat_policy!r}")
    computed = model_flops(cfg, sh)["computed"]
    B, L, D, V = sh.global_batch, sh.seq_len, cfg.d_model, cfg.vocab_size
    norms = 2.0 * 2 * D * cfg.n_layers
    if sh.kind == "decode":
        return computed - norms * B
    T = B * L
    if sh.kind == "prefill":
        return computed - norms * T - 2.0 * V * D * B * (L - 1)
    passes = 3 + (1 if cfg.remat else 0)
    out = computed - passes * norms * T
    if cfg.remat:
        out -= 2.0 * V * D * T + cfg.n_layers * 2.0 * T * cfg.d_ff * D
    return out


def run_cell(
    arch: str,
    shape_name: Union[str, ShapeSpec],
    multi_pod: bool,
    verbose: bool = True,
    overrides: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    fn, args, in_specs, _ = build_step(arch, shape_name, overrides)
    t_build = time.time() - t0
    flops = count_flops(fn, args)
    t_count = time.time() - t0 - t_build
    cfg = _apply_overrides(get_config(arch), overrides)
    shape = shape_spec(shape_name)
    targs, tspecs = _tensor_args(args, in_specs)
    arg_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(targs))
    per_dev = {
        m.name: per_device_bytes(tspecs, targs, m)
        for m in (make_production_mesh(), make_production_mesh(multi_pod=True))
    }
    analytic = model_flops(cfg, shape)
    report = {
        "arch": arch,
        "shape": shape.name,
        "overrides": overrides or {},
        "mesh": mesh.name,
        "n_devices": mesh.size,
        "ok": True,
        "build_s": round(t_build, 1),
        "count_s": round(t_count, 1),
        "flops": flops,
        "model_flops": analytic["computed"],
        "useful_flops": analytic["useful"],
        "flops_over_model_flops": flops / analytic["computed"],
        "argument_bytes": arg_bytes,
        "fits_one_h100": arg_bytes <= H100_HBM_BYTES,
        "argument_bytes_per_device": per_dev,
        "collective_bytes_est": collective_bytes_est(cfg, shape, mesh.size),
    }
    if verbose:
        print(json.dumps(report))
        sys.stdout.flush()
    return report


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true", help="use the 2x16x16 mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL reports here")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config field overrides (perf experiments)")
    args = ap.parse_args()
    overrides = dict(kv.split("=", 1) for kv in args.set) or None
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    cells = all_cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    for arch, shape in cells:
        cfg = get_config(arch)
        if not shape_applicable(cfg, shape):
            continue
        for mp in meshes:
            try:
                report = run_cell(arch, shape, mp, overrides=overrides)
            except Exception as e:  # a failure here is a bug in our system
                failures += 1
                report = {
                    "arch": arch, "shape": shape,
                    "mesh": "pod2x16x16" if mp else "16x16",
                    "ok": False, "error": f"{type(e).__name__}: {e}",
                }
                print(json.dumps(report))
                traceback.print_exc()
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(report) + "\n")
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
