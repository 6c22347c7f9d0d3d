"""Nemotron-H prefill: prompts through the port's ``Model.prefill``, back to back.

The prefill driver's items, rate and comparison (``drivers/prefill.py``:
``item``, ``check_items``, ``end_to_end``, ``sample``, ``logits_err``) and
the hybrid driver's port-only configuration check (``drivers/hybrid_prefill.py``:
``model_config``), for nemotron_h, whose weights
(``h100bench/nemotron_inputs.py``) and float32 reference
(``h100bench/reference/nemotron_h.py``) are its own.

The comparison gives three numbers:

* ``logits_err``: the window's last logits of the checked item against the
  reference, ``check_rows`` rows at a time, each MoE layer following the
  expert ids the program chose.  The program is run once more over the item,
  one layer at a time through ``nemotron_h.layer_apply`` (the code the
  window ran, on its routes), to hand them back with each layer's input (kept
  on the host); its logits are the window's bit for bit (logged).  A
  near-tie of the k-th and the next expert that bf16 rounding flips is then
  not counted as an error;
* ``layer_err_bf16``: every layer of that run over the whole item, the
  window's own bf16 route (the SSD and pass kernels, the flash kernel, the
  grouped GEMMs), against the reference's float32 layer on the same bf16
  input, following the program's routes (:func:`layer_err_bf16`).  A fault
  in a kernel of that route shows here and in no other number but the
  teacher-forced logits: ``layer_err_f32`` runs the float32 program, which
  takes the plain routes.  The whole item, and not its first row: the
  grouped route sorts the routes by expert and then by token, so a fault at
  a group's end falls in the item's last rows;
* ``layer_err_f32``: every layer of the program's own code in float32 (that
  layer's weights cast, TF32 off; :func:`layer_err_f32`) on the program's
  bf16 input to that layer for the item's first row, against the reference's layer routing for itself but at its own
  near-ties (k-th and next biased scores within :data:`TIE`), where it
  follows the float32 program.  A fault of one layer, or of the routing,
  shows here where the teacher-forced logits cannot see it.

Each layer's number compares its addend (its output less its input), over
the largest of the reference's, and the worst layer is the number.

``work`` gives the yardsticks and the calls each per-layer guard needs:
the model FLOPs (``work/nemotron_flops.py``), the SSD calls and their
grouped floor (``work/ssd_groups.py``), and the MoE layer calls and routes
of the window, read from the port's counters (``models.moe_dropless.calls``
and ``routed_rows``) at the end of set-up and after the window, with the
least time of their routed products (``work/moe_groups.py``).
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from pathlib import Path

import torch

from h100bench import nemotron_inputs as inputs
from h100bench.harness import load_module, sync
from h100bench.reference import nemotron_h as ref
from h100bench.reference.model import exact_matmul
from h100bench.work import moe_groups, nemotron_flops, ssd_groups

_prefill = load_module(Path(__file__).with_name("prefill.py"), "h100bench_driver_prefill")
item, check_items, end_to_end = _prefill.item, _prefill.check_items, _prefill.end_to_end
sample, logits_err = _prefill.sample, _prefill.logits_err
model_config = load_module(Path(__file__).with_name("hybrid_prefill.py"),
                           "h100bench_driver_hybrid_prefill").model_config

#: a near-tie of the k-th and the (k+1)-th biased router scores: 1e-4, a
#: hundred times the float32 program's and the reference's difference of
#: scores (sums of 2688 products in other orders), a hundredth of the
#: median gap; some 1% of the route sets fall within it
TIE = 1e-4


class State:
    pass


def moe_counters():
    from repro_torch.models import moe_dropless

    return moe_dropless.calls, moe_dropless.routed_rows


def setup(ctx):
    from repro_torch.models.model_api import build_model

    t, w = ctx.traffic, ctx.widths
    st = State()
    t0 = time.perf_counter()
    st.cfg = model_config(ctx.spec)
    st.model = build_model(st.cfg, ctx.device)
    st.params = inputs.weights(w, ctx.seed, ctx.device)
    st.pool = inputs.tokens(w, ctx.seed, (t["pool"], t["batch"], t["seq_len"]), ctx.device)
    sync(ctx)
    t1 = time.perf_counter()
    st.model.prefill(st.params, {"tokens": st.pool[0]}).cpu()
    t2 = time.perf_counter()
    t_main = getattr(sys.modules.get("__main__"), "T_START", None)
    ctx.log((f"[setup] process start to set-up {t0 - t_main:.4f} s; " if t_main else "[setup] ")
            + f"weights and prompts {t1 - t0:.4f} s; warm-up prefill {t2 - t1:.4f} s")
    st.outputs = []
    st.moe_at_setup = moe_counters()
    return st


def work(ctx, st, items):
    t, w = ctx.traffic, ctx.widths
    B, L = t["batch"], t["seq_len"]
    n = len(items)
    calls = n * w["layer_pattern"].count("M")
    per_call = ssd_groups.grouped_ssd_bound_s(B, L, w["mamba_num_heads"], w["ssm_headdim"],
                                              w["ssm_state"], min(w["ssm_chunk"], L), w["dtype"],
                                              w["ssm_ngroups"])
    moe_calls, rows = (a - b for a, b in zip(moe_counters(), st.moe_at_setup))
    experts_bound = moe_calls * moe_groups.bound_s(w, rows // moe_calls, w["dtype"]) \
        if moe_calls else 0.0
    return {"model_flops": n * nemotron_flops.prefill_flops(w, B, L),
            "ssd_scan_calls": calls, "ssd_scan_bound_s": calls * per_call,
            "moe_calls": moe_calls, "moe_routed_rows": rows, "moe_experts_bound_s": experts_bound}


def check(ctx, st):
    """``logits_err`` of the window's item against the reference on the
    program's routes, ``layer_err_bf16`` of the window's layers over the
    item, and ``layer_err_f32`` of the program's layers in float32 on the
    item's first row."""
    from repro_torch.models.common import embed
    from repro_torch.models.nemotron_h import final_logits, layer_apply, layers

    b, got = sample(ctx, st)
    tokens = st.pool[b]
    t0 = time.perf_counter()
    st.routes, st.rows = [], []
    with torch.no_grad():
        h = embed(st.params["embed"], tokens)
        for kind, p in layers(st.cfg, st.params):
            st.rows.append(h.to("cpu", copy=True))
            h = layer_apply(st.cfg, p, kind, h, st.routes)
        st.rows.append(h.to("cpu", copy=True))
        again = final_logits(st.cfg, st.params, h).cpu()
        del h
    t1 = time.perf_counter()
    stats = {}
    st.want = want = reference(ctx, st.params, tokens, st.routes, stats=stats)
    t2 = time.perf_counter()
    route = layer_err_bf16(ctx, st)
    t3 = time.perf_counter()
    exact = layer_err_f32(ctx, st)
    t4 = time.perf_counter()
    rows = torch.stack(stats["rows"]).float()
    ctx.log(f"[check] item batch {b}: the program again {t1 - t0:.4f} s (max |again - window| "
            f"{float((again - got).abs().max()):.3e}); reference {t2 - t1:.4f} s; the "
            f"reference's layers {t3 - t2:.4f} s; layers in float32 {t4 - t3:.4f} s")
    ctx.log(f"[check] route sets where the reference's own choice differs from the program's: "
            f"{stats['differ']} of {stats['routes']} ({stats['differ'] / stats['routes']:.4e}); "
            f"rows an expert a layer over {ctx.traffic['check_rows']} rows: largest "
            f"{int(rows.max())}, mean {float(rows.mean()):.1f}")
    return {"logits_err": logits_err(got, want), "layer_err_bf16": route,
            "layer_err_f32": exact}


def reference(ctx, params, tokens, routes, prec="f32", stats=None):
    """The reference's last logits of ``tokens``, ``check_rows`` rows at a
    time, every MoE layer following ``routes``."""
    n = ctx.traffic["check_rows"]
    return torch.cat([ref.prefill_logits(ctx.widths, params, tokens[r:r + n], prec,
                                         [ids[r:r + n] for ids in routes], stats=stats).cpu()
                      for r in range(0, tokens.shape[0], n)])


def addend_err(got: torch.Tensor, want: torch.Tensor, h: torch.Tensor) -> float:
    """max |(got - h) - (want - h)| over max |want - h|: a layer's addend."""
    return float((got - want).abs().max() / (want - h).abs().max())


def worst_layer(ctx, st, name, err_of) -> float:
    """The largest ``err_of(l, kind, p)`` over the layers, logged with its
    layer."""
    from repro_torch.models.nemotron_h import layers

    worst, at = 0.0, -1
    for l, (kind, p) in enumerate(layers(st.cfg, st.params)):
        with torch.no_grad(), exact_matmul():
            err = err_of(l, kind, p)
        if err > worst or at < 0:
            worst, at = err, l
    ctx.log(f"[check] {name}: worst {worst:.4e} at layer {at} "
            f"({ctx.widths['layer_pattern'][at]})")
    return worst


def layer_err_bf16(ctx, st, prec="bf16"):
    """The worst layer's addend error (:func:`addend_err`, over the whole
    item) of the window's bf16 route (``prec="bf16"``: the layer's output in
    :func:`check`'s run over the item), or of the reference's own layer in
    float8 (``prec="fp8"``, the control), against the reference's float32
    layer on the same input, every MoE layer following the program's routes;
    ``check_rows`` rows at a time."""
    n = ctx.traffic["check_rows"]
    follow = {}
    for l, kind in enumerate(ref.kinds(ctx.widths)):
        if kind == "moe":
            follow[l] = st.routes[len(follow)]

    def err_of(l, kind, p):
        d = a = 0.0
        for r in range(0, st.rows[l].shape[0], n):
            h = st.rows[l][r:r + n].to(ctx.device).float()
            ids = follow[l][r:r + n] if l in follow else None
            want = ref.layer_apply(ctx.widths, kind, p, h, "f32", ids, math.inf)
            got = (st.rows[l + 1][r:r + n].to(ctx.device).float() if prec == "bf16" else
                   ref.layer_apply(ctx.widths, kind, p, h, prec, ids, math.inf))
            d = max(d, float((got - want).abs().max()))
            a = max(a, float((want - h).abs().max()))
        return d / a

    return worst_layer(ctx, st, f"layer_err_bf16 ({prec})", err_of)


def layer_err_f32(ctx, st, prec="f32"):
    """The worst layer's :func:`addend_err` of the program's layer in float32
    (``prec="f32"``), or of the reference's own in float8 (``prec="fp8"``,
    the control), against the reference's float32 layer, on the same
    inputs as :func:`layer_err_bf16`; the reference routes for itself but
    follows the float32 program on its near-ties."""
    from repro_torch.models.nemotron_h import layer_apply
    from repro_torch.tree import tree_map

    cfg32 = dataclasses.replace(st.cfg, dtype="float32")

    def err_of(l, kind, p):
        h, routes = st.rows[l][:1].to(ctx.device).float(), []
        if prec == "f32":
            got = layer_apply(cfg32, tree_map(lambda t: t.float(), p), kind, h, routes)
        else:
            got = ref.layer_apply(ctx.widths, kind, p, h, prec)
        want = ref.layer_apply(ctx.widths, kind, p, h, "f32", routes[0] if routes else None, TIE)
        return addend_err(got, want, h)

    return worst_layer(ctx, st, f"layer_err_f32 ({prec})", err_of)


def control(ctx, st):
    """The control's numbers, after :func:`check`: the reference in float8
    in the program's place."""
    b, _ = sample(ctx, st)
    low = reference(ctx, st.params, st.pool[b], st.routes, prec="fp8")
    return {"logits_err": logits_err(low, st.want),
            "layer_err_bf16": layer_err_bf16(ctx, st, prec="fp8"),
            "layer_err_f32": layer_err_f32(ctx, st, prec="fp8")}
