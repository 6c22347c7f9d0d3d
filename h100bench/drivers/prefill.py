"""Prefill: batches of prompts through ``Model.prefill``, back to back.

An item is one ``Model.prefill`` of ``batch`` prompts of ``seq_len``
tokens, timed from its dispatch to its last-position logits copied to
the host.  The prompts come from a pool of ``pool`` batches drawn from
the seed in set-up, taken in turn.  The check runs the reference over
every row of one item drawn from the seed, ``check_rows`` rows at a
time, and compares its logits.
"""

from __future__ import annotations

import random
import time

import torch

from h100bench import inputs, program
from h100bench.harness import release, sync
from h100bench.reference import model as ref
from h100bench.work import model_flops, roofline


class State:
    pass


def setup(ctx):
    t, w = ctx.traffic, ctx.widths
    st = State()
    t0 = time.perf_counter()
    st.cfg, st.model = program.build(ctx.spec, ctx.device)
    st.params = inputs.weights(w, ctx.seed, ctx.device)
    st.pool = inputs.tokens(w, ctx.seed, (t["pool"], t["batch"], t["seq_len"]), ctx.device)
    sync(ctx)
    t1 = time.perf_counter()
    st.model.prefill(st.params, {"tokens": st.pool[0]}).cpu()
    t2 = time.perf_counter()
    ctx.log(f"[setup] weights and prompts {t1 - t0:.4f} s; warm-up prefill {t2 - t1:.4f} s")
    st.outputs = []
    return st


def item(ctx, st, i):
    b = i % ctx.traffic["pool"]
    with ctx.span("prefill"):
        logits = st.model.prefill(st.params, {"tokens": st.pool[b]})
    with ctx.span("to_host"):
        st.outputs.append((b, logits.cpu()))
    return st.pool.shape[1] * st.pool.shape[2]


def check_items(ctx):
    return 1


def end_to_end(ctx, items):
    return {"prefill_tok_per_s": sum(it.tokens for it in items) / (items[-1].t1 - items[0].t0)}


def work(ctx, st, items):
    t, w = ctx.traffic, ctx.widths
    B, L = t["batch"], t["seq_len"]
    n = len(items)
    H = w["ssm_expand"] * w["d_model"] // w["ssm_headdim"]
    calls = n * w["n_layers"]
    per_call = roofline.ssd_bound_s(B, L, H, w["ssm_headdim"], w["ssm_state"],
                                    min(w["ssm_chunk"], L), w["dtype"])
    return {"model_flops": n * model_flops.prefill_flops(w, B, L),
            "ssd_scan_calls": calls, "ssd_scan_bound_s": calls * per_call}


def sample(ctx, st):
    """The item the check compares, drawn from the seed."""
    return st.outputs[random.Random(ctx.seed).randrange(len(st.outputs))]


def logits_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max())


def check(ctx, st):
    b, got = sample(ctx, st)
    release(ctx, st, "params", "model")
    params = inputs.weights(ctx.widths, ctx.seed, ctx.device)
    t0 = time.perf_counter()
    st.want = want = reference(ctx, params, st.pool[b])
    ctx.log(f"[check] reference over item batch {b}: {time.perf_counter() - t0:.4f} s")
    return {"logits_err": logits_err(got, want)}


def reference(ctx, params, tokens, prec="f32"):
    """The reference's last logits of ``tokens``, ``check_rows`` rows at a time."""
    n = ctx.traffic["check_rows"]
    return torch.cat([ref.prefill_logits(ctx.widths, params, tokens[r:r + n], prec).cpu()
                      for r in range(0, tokens.shape[0], n)])


def control(ctx, st):
    """The control's number, after :func:`check`: the reference in float8
    in the program's place."""
    b, _ = sample(ctx, st)
    params = inputs.weights(ctx.widths, ctx.seed, ctx.device)
    low = reference(ctx, params, st.pool[b], prec="fp8")
    return {"logits_err": logits_err(low, st.want)}
