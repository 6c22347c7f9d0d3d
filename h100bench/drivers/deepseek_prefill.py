"""DeepSeek-V3 prefill: prompts through the port's ``Model.prefill``, back to back.

The prefill driver's items, rate and comparison (``drivers/prefill.py``:
``item``, ``check_items``, ``end_to_end``, ``sample``, ``logits_err``) and
the Nemotron-H driver's comparison scheme (``drivers/nemotron_prefill.py``:
``addend_err``, ``TIE``), for deepseek_v3 on one card's share of its
experts, whose weights (``h100bench/deepseek_inputs.py``) and float32
reference (``h100bench/reference/deepseek_v3.py``) are its own.

The configuration file's widths are asserted against the port-only
configuration (:func:`model_config`); the keys the file's ``reduced``
lists are the cut, by the release's names (``num_hidden_layers``,
``n_routed_experts``: the widths ``n_layers`` and ``n_experts_held``,
:data:`CUT`) or by the port's, and only their widths are overridden.

The comparison gives three numbers:

* ``logits_err``: the window's last logits of the checked item against the
  reference, ``check_rows`` rows at a time, each MoE layer following the
  expert ids the program chose.  The program is run once more over the item,
  one layer at a time through ``deepseek_v3.layer_apply`` (the code the
  window ran, on its routes), to hand them back with each layer's input
  (kept on the host); its logits are the window's bit for bit (logged);
* ``layer_err_bf16``: every layer of that run over the whole item, the
  window's own bf16 route (the flash kernel at (192, 128), the grouped
  GEMMs over the held experts), against the reference's float32 layer on
  the same bf16 input, following the program's routes.  A fault in a
  kernel of that route shows here and in no other number but the
  teacher-forced logits: ``layer_err_f32`` runs the float32 program, which
  takes the plain routes;
* ``layer_err_f32``: every layer of the program's own code in float32 (its
  weights cast, TF32 off) on the program's bf16 input to that layer for the
  first ``f32_positions`` positions of the item's first row (attention is
  causal and the rest acts token by token, so a layer's output there is its
  output over the whole row; the float32 program's plain attention computes
  every block, and over a whole 16k row takes most of the check), against
  the reference's layer routing for itself but,
  at its own near-ties (within the Nemotron driver's ``TIE``), following the
  float32 program.  A fault of one layer, or of the routing, shows here
  where the teacher-forced logits cannot see it.

Each layer's number compares its addend (its output less its input), over
the largest of the reference's, and the worst layer is the number.

``work`` gives the yardsticks and the calls each per-layer guard needs, read
from the port's counters at the end of set-up and after the window: the MLA
blocks (``deepseek_v3.mla.calls``), the flash kernel's launches and its
least time (``work/deepseek_flops.flash_bound_s``), the MoE layer calls
(``moe_dropless.calls``) and the routes to held experts
(``moe_dropless.held_count``, a device tensor read once here), and the model
FLOPs over those routes (``work/deepseek_flops.py``).
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from pathlib import Path

import torch

from h100bench import deepseek_inputs as inputs
from h100bench.harness import load_module, sync
from h100bench.reference import deepseek_v3 as ref
from h100bench.reference.model import exact_matmul
from h100bench.work import deepseek_flops

_prefill = load_module(Path(__file__).with_name("prefill.py"), "h100bench_driver_prefill")
item, check_items, end_to_end = _prefill.item, _prefill.check_items, _prefill.end_to_end
sample, logits_err = _prefill.sample, _prefill.logits_err
_nemotron = load_module(Path(__file__).with_name("nemotron_prefill.py"),
                        "h100bench_driver_nemotron_prefill")
addend_err, TIE = _nemotron.addend_err, _nemotron.TIE

#: the release's keys a configuration file may cut, and the port's widths they set
CUT = {"num_hidden_layers": "n_layers", "n_routed_experts": "n_experts_held"}


class State:
    pass


def model_config(spec):
    """The port-only ``DeepSeekV3Config`` of a configuration file; raises
    where the file names a width the configuration lacks, or holds another
    value where its ``reduced`` lists neither the width nor its release key."""
    from repro_torch.configs.port_only import get_port_config

    cfg = get_port_config(spec["arch"])
    if cfg.family != spec["family"]:
        raise ValueError(f"{spec['arch']} is family {cfg.family}, the file says {spec['family']}")
    cut = {CUT.get(k, k) for k in spec["reduced"]}
    over = {"dtype": spec["dtype"]}
    for k, v in spec["widths"].items():
        if not hasattr(cfg, k):
            raise ValueError(f"{spec['arch']}: the port-only configuration has no {k}")
        if k in cut:
            over[k] = v
        elif getattr(cfg, k) != v:
            raise ValueError(f"{spec['arch']}: the port has {k}={getattr(cfg, k)!r}, the "
                             f"configuration file {v!r}, and it is not cut in reduced")
    return dataclasses.replace(cfg, **over)


def counters(device):
    """(MLA blocks, flash launches, MoE layer calls, routes to held experts)
    since the process began."""
    from repro_torch.kernels.flash_attn.kernel import flash_attn_cuda
    from repro_torch.models import deepseek_v3, moe_dropless

    return (deepseek_v3.mla.calls, flash_attn_cuda.launches, moe_dropless.calls,
            moe_dropless.held_count(device))


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
    st.at_setup = counters(ctx.device)
    return st


def work(ctx, st, items):
    t, w = ctx.traffic, ctx.widths
    B, L = t["batch"], t["seq_len"]
    n = len(items)
    mla_calls, flash_calls, moe_calls, held = (
        a - b for a, b in zip(counters(ctx.device), st.at_setup))
    ctx.log(f"[work] {n} items: {mla_calls} MLA blocks, {flash_calls} flash launches, "
            f"{moe_calls} MoE layer calls, {held} routes to held experts")
    return {"model_flops": n * deepseek_flops.prefill_flops(w, B, L, 0)
            + held * deepseek_flops.routed_row_flops(w),
            "mla_calls": mla_calls, "flash_calls": flash_calls,
            "flash_bound_s": flash_calls * deepseek_flops.flash_bound_s(w, B, L, w["dtype"]),
            "moe_calls": moe_calls, "moe_held_rows": held}


def check(ctx, st):
    """``logits_err`` of the window's item against the reference on the
    program's routes, ``layer_err_bf16`` of the window's layers over the
    item, and ``layer_err_f32`` of the program's layers in float32 on the
    first ``f32_positions`` of the item's first row."""
    from repro_torch.models.common import embed
    from repro_torch.models.deepseek_v3 import final_logits, layer_apply, layers

    b, got = sample(ctx, st)
    tokens = st.pool[b]
    t0 = time.perf_counter()
    st.routes, st.rows = [], []
    with torch.no_grad():
        h = embed(st.params["embed"], tokens)
        for kind, pa, pf in layers(st.cfg, st.params):
            st.rows.append(h.to("cpu", copy=True))
            h = layer_apply(st.cfg, kind, pa, pf, h, st.routes)
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
            f"rows a held expert a layer over {ctx.traffic['check_rows']} rows: largest "
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


def worst_layer(ctx, st, name, err_of) -> float:
    """The largest ``err_of(l, kind, pa, pf)`` over the layers, logged with
    its layer."""
    from repro_torch.models.deepseek_v3 import layers

    worst, at = 0.0, -1
    for l, (kind, pa, pf) in enumerate(layers(st.cfg, st.params)):
        with torch.no_grad(), exact_matmul():
            err = err_of(l, kind, pa, pf)
        if err > worst or at < 0:
            worst, at = err, l
    ctx.log(f"[check] {name}: worst {worst:.4e} at layer {at} ({ref.kinds(ctx.widths)[at]})")
    return worst


def layer_err_bf16(ctx, st, prec="bf16"):
    """The worst layer's addend error (over the whole item) of the window's
    bf16 route (``prec="bf16"``: the layer's output in :func:`check`'s run
    over the item), or of the reference's own layer in float8 (``prec="fp8"``,
    the control), against the reference's float32 layer on the same input,
    every MoE layer following the program's routes; ``check_rows`` rows at a
    time."""
    n = ctx.traffic["check_rows"]
    follow = {}
    for l, kind in enumerate(ref.kinds(ctx.widths)):
        if kind == "moe":
            follow[l] = st.routes[len(follow)]

    def err_of(l, kind, pa, pf):
        d = a = 0.0
        for r in range(0, st.rows[l].shape[0], n):
            h = st.rows[l][r:r + n].to(ctx.device).float()
            ids = follow[l][r:r + n] if l in follow else None
            want = ref.layer_apply(ctx.widths, kind, pa, pf, h, "f32", ids, math.inf)
            got = (st.rows[l + 1][r:r + n].to(ctx.device).float() if prec == "bf16" else
                   ref.layer_apply(ctx.widths, kind, pa, pf, h, prec, ids, math.inf))
            d = max(d, float((got - want).abs().max()))
            a = max(a, float((want - h).abs().max()))
        return d / a

    return worst_layer(ctx, st, f"layer_err_bf16 ({prec})", err_of)


def layer_err_f32(ctx, st, prec="f32"):
    """The worst layer's :func:`addend_err` of the program's layer in float32
    (``prec="f32"``), or of the reference's own in float8 (``prec="fp8"``,
    the control), against the reference's float32 layer, on the first
    ``f32_positions`` of the item's first row of :func:`layer_err_bf16`'s
    inputs; the reference routes for itself but follows the float32 program
    on its near-ties."""
    from repro_torch.models.deepseek_v3 import layer_apply
    from repro_torch.tree import tree_map

    cfg32 = dataclasses.replace(st.cfg, dtype="float32")
    n = ctx.traffic["f32_positions"]

    def err_of(l, kind, pa, pf):
        h, routes = st.rows[l][:1, :n].to(ctx.device).float(), []
        if prec == "f32":
            f32 = lambda p: tree_map(lambda t: t.float(), p)  # noqa: E731
            got = layer_apply(cfg32, kind, f32(pa), f32(pf), h, routes)
        else:
            got = ref.layer_apply(ctx.widths, kind, pa, pf, h, prec)
        want = ref.layer_apply(ctx.widths, kind, pa, pf, h, "f32",
                               routes[0] if routes else None, TIE)
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
