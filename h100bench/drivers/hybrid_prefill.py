"""Hybrid prefill: zamba2 prompts through the port's ``Model.prefill``, back to back.

The prefill driver's items, rate and comparison (``drivers/prefill.py``:
``item``, ``end_to_end``, ``sample``, ``logits_err``) for a configuration
of the port-only lookup (``repro_torch.configs.port_only``): zamba2, whose
weights (``h100bench/zamba2_inputs.py``) and float32 reference
(``h100bench/reference/zamba2.py``) are its own.  The comparison gives a
second number, ``logits_err_f32``: the program's own code in float32 on
the checked item's first ``check_rows`` rows (:func:`program_f32`).  The configuration file's
widths are asserted against the port-only configuration, as
``program.model_config`` asserts them against the registry's; only keys
the file lists in ``reduced`` are overridden.

``work`` gives the yardsticks and the calls each per-layer guard needs:
the model FLOPs (``work/zamba2_flops.py``), the SSD calls and their
grouped floor (``work/ssd_groups.py``), and the shared-block calls of the
window, read from the port's counter (``models.zamba2.shared_block.calls``)
at the end of set-up and after the window.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

from h100bench import zamba2_inputs as inputs
from h100bench.harness import load_module, release, sync
from h100bench.reference import zamba2 as ref
from h100bench.work import ssd_groups, zamba2_flops

_prefill = load_module(Path(__file__).with_name("prefill.py"), "h100bench_driver_prefill")
item, check_items, end_to_end = _prefill.item, _prefill.check_items, _prefill.end_to_end
sample, logits_err = _prefill.sample, _prefill.logits_err


class State:
    pass


def model_config(spec):
    """The port-only ``ModelConfig`` of a configuration file; raises where
    the file names a width the configuration lacks or holds another value."""
    from repro_torch.configs.port_only import get_port_config

    cfg = get_port_config(spec["arch"])
    if cfg.family != spec["family"]:
        raise ValueError(f"{spec['arch']} is family {cfg.family}, the file says {spec['family']}")
    over = {"dtype": spec["dtype"]}
    for k, v in spec["widths"].items():
        if k != "head_dim" and not hasattr(cfg, k):
            raise ValueError(f"{spec['arch']}: the port-only configuration has no {k}")
        have = cfg.resolved_head_dim if k == "head_dim" else getattr(cfg, k)
        want = tuple(v) if isinstance(have, tuple) else v
        if k in spec["reduced"]:
            over[k] = want
        elif have != want:
            raise ValueError(f"{spec['arch']}: the port has {k}={have!r}, the configuration file "
                             f"{v!r}, and {k} is not listed in reduced")
    return dataclasses.replace(cfg, **over)


def shared_block_calls() -> int:
    from repro_torch.models.zamba2 import shared_block

    return shared_block.calls


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
    # run.py's clock at the start of the process: its imports and the card's context come first
    t_main = getattr(sys.modules.get("__main__"), "T_START", None)
    ctx.log((f"[setup] process start to set-up {t0 - t_main:.4f} s; " if t_main else "[setup] ")
            + f"weights and prompts {t1 - t0:.4f} s; warm-up prefill {t2 - t1:.4f} s")
    st.outputs = []
    st.sites_at_setup = shared_block_calls()
    return st


def work(ctx, st, items):
    t, w = ctx.traffic, ctx.widths
    B, L = t["batch"], t["seq_len"]
    n = len(items)
    H = w["ssm_expand"] * w["d_model"] // w["ssm_headdim"]
    calls = n * w["n_layers"]
    per_call = ssd_groups.grouped_ssd_bound_s(B, L, H, w["ssm_headdim"], w["ssm_state"],
                                              min(w["ssm_chunk"], L), w["dtype"],
                                              w["ssm_ngroups"])
    return {"model_flops": n * zamba2_flops.prefill_flops(w, B, L),
            "ssd_scan_calls": calls, "ssd_scan_bound_s": calls * per_call,
            "shared_block_calls": shared_block_calls() - st.sites_at_setup}


def check(ctx, st):
    """``logits_err`` of the window's item, and ``logits_err_f32`` of the
    program's own code in float32 on the item's first ``check_rows`` rows."""
    b, got = sample(ctx, st)
    release(ctx, st, "params", "model")
    params = inputs.weights(ctx.widths, ctx.seed, ctx.device)
    t0 = time.perf_counter()
    st.want = want = reference(ctx, params, st.pool[b])
    t1 = time.perf_counter()
    n = ctx.traffic["check_rows"]
    exact = program_f32(ctx, st.cfg, params, st.pool[b][:n])
    ctx.log(f"[check] reference over item batch {b}: {t1 - t0:.4f} s; the program in float32 "
            f"over its first {n} rows: {time.perf_counter() - t1:.4f} s")
    return {"logits_err": logits_err(got, want), "logits_err_f32": logits_err(exact, want[:n])}


def program_f32(ctx, cfg, params, tokens):
    """The program's last logits of ``tokens`` with its weights cast to
    float32 and TF32 off: the code the window ran, with none of bf16's
    rounding, so that a fault of a part of the model (one layer's groups,
    one site) shows above float32's sums in another order, where the
    window's bf16 rounding through 81 layers hides it."""
    from repro_torch.models.model_api import build_model
    from repro_torch.tree import tree_map

    params = tree_map(lambda t: t.float(), params)
    model = build_model(dataclasses.replace(cfg, dtype="float32"), ctx.device)
    with ref.exact_matmul():
        return model.prefill(params, {"tokens": tokens}).cpu()


def reference(ctx, params, tokens, prec="f32"):
    """The reference's last logits of ``tokens``, ``check_rows`` rows at a time."""
    import torch

    n = ctx.traffic["check_rows"]
    return torch.cat([ref.prefill_logits(ctx.widths, params, tokens[r:r + n], prec).cpu()
                      for r in range(0, tokens.shape[0], n)])


def control(ctx, st):
    """The control's number, after :func:`check`: the reference in float8
    in the program's place."""
    b, _ = sample(ctx, st)
    params = inputs.weights(ctx.widths, ctx.seed, ctx.device)
    low = reference(ctx, params, st.pool[b], prec="fp8")
    n = ctx.traffic["check_rows"]
    return {"logits_err": logits_err(low, st.want),
            "logits_err_f32": logits_err(low[:n], st.want[:n])}
