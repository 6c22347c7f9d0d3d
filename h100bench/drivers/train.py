"""Training: AdamW steps of ``make_train_step(model.loss, OptConfig(...))``.

Set-up builds one training step with its model and optimizer state and
drives it through the ``checked_steps`` first steps, through the same
call and feed as the window, on batches whose rows all differ; the
window then goes on with that same object.  An item is one step, timed
from its dispatch to ``float(loss)`` on the host.  Batches come from a
pool of ``pool`` batches of ``seq_len + 1`` tokens drawn from the seed,
taken in turn, the labels the tokens shifted by one.

The check: the reference follows the checked steps from the same
weights and batches, and the run compares each step's loss, each unit's
first gradient as the optimizer took it (from the first moment after
step one: m = (1 - b1) g), and each unit's change over the checked
steps, read before the window's first step moves the parameters.  A unit
is one layer of one leaf (:func:`reference.model.leaf_units`).
"""

from __future__ import annotations

import time

import torch

from h100bench import inputs, program
from h100bench.harness import release, sync
from h100bench.reference import model as ref
from h100bench.work import model_flops, roofline


class State:
    pass


def batch(st, i):
    toks = st.pool[i % st.pool.shape[0]]
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@torch.no_grad()
def diff_norms(a, b):
    """Each unit's norm of ``a - b`` in float32."""
    return {n: float(torch.linalg.vector_norm(x.float() - y.float()))
            for (n, x), (_, y) in zip(ref.leaf_units(a), ref.leaf_units(b))}


def setup(ctx):
    from repro_torch.optim.adamw import OptConfig, init_opt_state, make_train_step

    t, w = ctx.traffic, ctx.widths
    st = State()
    t0 = time.perf_counter()
    st.cfg, st.model = program.build(ctx.spec, ctx.device)
    st.params = inputs.weights(w, ctx.seed, ctx.device)
    st.pool = inputs.tokens(w, ctx.seed, (t["pool"], t["batch"], t["seq_len"] + 1), ctx.device)
    st.opt_cfg = OptConfig(**t["opt"])
    st.opt = init_opt_state(st.params)
    st.step = make_train_step(st.model.loss, st.opt_cfg)
    sync(ctx)
    t1 = time.perf_counter()
    st.losses = []
    for k in range(t["checked_steps"]):
        st.params, st.opt, met = st.step(st.params, st.opt, batch(st, k))
        st.losses.append(float(met["loss"]))
        if k == 0:
            st.first_grad = {n: v / (1 - st.opt_cfg.b1)
                             for n, v in ref.unit_norms(st.opt.m).items()}
    t2 = time.perf_counter()
    start = inputs.weights(w, ctx.seed, ctx.device)
    st.change = diff_norms(st.params, start)
    del start
    ctx.log(f"[setup] weights and batches {t1 - t0:.4f} s; {t['checked_steps']} checked steps "
            f"{t2 - t1:.4f} s (losses {st.losses})")
    return st


def item(ctx, st, i):
    with ctx.span("train_step"):
        st.params, st.opt, met = st.step(st.params, st.opt, batch(st, ctx.traffic["checked_steps"] + i))
    with ctx.span("to_host"):
        float(met["loss"])
    return ctx.traffic["batch"] * ctx.traffic["seq_len"]


def check_items(ctx):
    return 0  # the checked steps are set-up's


def end_to_end(ctx, items):
    return {"train_tok_per_s": sum(it.tokens for it in items) / (items[-1].t1 - items[0].t0)}


def work(ctx, st, items):
    t, w = ctx.traffic, ctx.widths
    B, L = t["batch"], t["seq_len"]
    n = len(items)
    H = w["ssm_expand"] * w["d_model"] // w["ssm_headdim"]
    calls = n * 2 * w["n_layers"]  # the forward and remat's recompute
    per_call = roofline.ssd_bound_s(B, L, H, w["ssm_headdim"], w["ssm_state"],
                                    min(w["ssm_chunk"], L), w["dtype"])
    return {"model_flops": n * model_flops.train_flops(w, B, L),
            "ssd_scan_calls": calls, "ssd_scan_bound_s": calls * per_call}


def opt_dict(st):
    o = st.opt_cfg
    return {k: getattr(o, k) for k in ("lr", "warmup_steps", "total_steps", "b1", "b2", "eps",
                                       "weight_decay", "clip_norm")}


def reference(ctx, st, prec="f32"):
    n = ctx.traffic["checked_steps"]
    batches = [(b["tokens"], b["labels"]) for b in (batch(st, k) for k in range(n))]
    params = inputs.weights(ctx.widths, ctx.seed, ctx.device)
    return ref.train(ctx.widths, params, batches, opt_dict(st), prec)


def numbers(losses, first_grad, change, want):
    """The compared numbers of a run (``losses``, ``first_grad``,
    ``change``) against the reference's ``want``."""
    skip = ref.negligible(want["first_grad"])
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, want["losses"])),
            "grad_gap": ref.gaps(first_grad, want["first_grad"])[0],
            "update_gap": ref.gaps(change, want["change"], skip)[0]}


def check(ctx, st):
    release(ctx, st, "params", "opt", "step", "model")
    t0 = time.perf_counter()
    st.want = want = reference(ctx, st)
    ctx.log(f"[check] reference, {ctx.traffic['checked_steps']} steps: "
            f"{time.perf_counter() - t0:.4f} s; losses {want['losses']}")
    skip = ref.negligible(want["first_grad"])
    if skip:
        ctx.log(f"[check] units whose change is round-off (gradient under 1e-3 of the median "
                f"unit's), not compared: {skip}")
    return numbers(st.losses, st.first_grad, st.change, want)


def control(ctx, st):
    """The control's numbers, after :func:`check`: the reference in float8
    in the program's place."""
    low = reference(ctx, st, prec="fp8")
    return numbers(low["losses"], low["first_grad"], low["change"], st.want)
