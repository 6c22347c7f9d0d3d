"""Batched-trial engine on torch: B seeds of one cell as one tensor program.

Port of the JAX package's ``core/engine_batch.py``.  The whole trial
event loop runs on the device over ``[B, ...]`` lanes, one lane per
seed; the host only packs the pre-generated arrivals before and replays
the accounting after, so each returned :class:`SimResult` is
fingerprint-identical to ``simulate(..., seed=s, engine="soa")``.

From ``vmap(lax.while_loop)`` to a host loop
--------------------------------------------
The seed axis the reference ``vmap``s over is a batch dimension written
out.  ``lax.while_loop`` becomes a host loop over the body; the body is
masked per lane by that lane's own ``cond`` (``act``), which is what
``vmap`` of a while loop selects: a lane whose ``cond`` is false pops
nothing, binds nothing, runs no round and writes nothing.  The host
reads ``act.any()`` only every ``CHECK_EVERY`` iterations (a drained
lane's iterations are masked no-ops), so the loop syncs with the device
once per block of iterations instead of once per event.

How it stays bit-identical to the reference engine
--------------------------------------------------
The same exactness devices as the JAX engine:

* f64 everywhere, with the dtype passed explicitly, and no fused
  multiply-add op: every ``a + b``, ``a - b``, ``a * b`` and compare is
  one eager op, one IEEE rounding.  The loop uses only min/max/argmin
  and elementwise ops — no float sums, so no reduction order to match.
* One-hot predicated writes (``where(arange == idx, val, arr)``) instead
  of scatters, with an out-of-range index meaning "write nothing"; on
  CUDA this also avoids ``index_put`` accumulation.  The one scatter
  left, the ``[NR, LP]`` variant-sequence table, writes one element per
  lane per call, so no two writes meet.
* First-minimum ``argmin`` (slot == rid, so its first-occurrence rule is
  the rid tie-break), the (time, counter) event pop, the stage-2
  strictly-greater replacement scan, and the reference emission order
  (stage-1 pick order, then stage-2 ascending k), which fixes the finish
  counters and so how simultaneous finishes tie-break.
* ``retained_sum`` is re-accumulated on the host in completion order,
  through the same frozenset unions and ``ModelPlan.combo_retained``
  calls the reference performs, and every lane must report ``drained``
  (it consumed its horizon within the exact event-count bound).

The device-side variant-combination check keeps the reference's known
hazard: it accumulates the retained product in application order, so
with >= 3 applied variants a product within an ulp of theta could flip
(documented in the JAX module; never observed on the pinned grids).

Not in this module yet: the fault lane (``pack_fault_epochs`` and the
``faulted`` branch of the JAX program).  An active fault model raises
:class:`BatchUnsupportedError`; use ``engine="soa"`` for fault cells.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import scheduler_torch
from repro_torch.core.scheduler import (
    DreamScheduler,
    EdfScheduler,
    FcfsScheduler,
    Scheduler,
    TerastalScheduler,
)
from repro_torch.core.simulator import (
    ArrivalProcess,
    ClosedLoopClients,
    DEFAULT_ARRIVAL,
    ModelStats,
    SimResult,
    TaskSpec,
)
from repro_torch.core.variants import ModelPlan
from repro_torch.device import resolve_device

_INF = float("inf")
_F64 = torch.float64
_I64 = torch.int64

#: host loop: read the lanes' ``cond`` once per this many iterations
CHECK_EVERY = 64


class BatchUnsupportedError(ValueError):
    """A simulation axis the batched engine does not cover.

    Raised by :func:`simulate_batch` validation — never a silent
    fallback.  The message names the axis; use ``engine="soa"`` /
    ``engine="reference"`` (or ``engine="auto"``) for these cells.
    """


#: columns of the bind table after the two [NA] latency rows: what a
#: request entering layer l of model m reads (the reference's gathers
#: ``vdlr[m, l]``, ``vdlr[m, l+1]``, ``rm[m, l..l+2]``, ``minl[m, l+1]``,
#: ``factor[m, l]``, ``hasv[m, l]``, ``l+1 < nl[m]``, ``l >= nl[m]``)
_BIND_COLS = ("vdlr", "vdlr1", "rm", "rm1", "rm2", "minl1", "factor",
              "hasv", "has_next", "last")


class _Tables(NamedTuple):
    """Shared per-model tables (broadcast across the seed axis)."""

    bind: torch.Tensor    # [M, LP+1, 2*NA + len(_BIND_COLS)] per (m, l)
    factor: torch.Tensor  # [M, LP]    per-variant retained factor (pad 0)
    theta: torch.Tensor   # [M]


class _Out(NamedTuple):
    """Per-lane outputs, fetched to the host in one copy."""

    state: np.ndarray     # [B, NR] 3 completed / 4 dropped / else in flight
    missed: np.ndarray    # [B, NR] bool
    app_seq: np.ndarray   # [B, NR, LP] application order index, -1 unused
    app_cnt: np.ndarray   # [B, NR] variants applied per request
    done_seq: np.ndarray  # [B, NR] global completion order, -1 if not
    busy_t: np.ndarray    # [B, NA]
    busy_h: np.ndarray    # [B, NA]
    rounds: np.ndarray    # [B]
    drained: np.ndarray   # [B] bool — horizon fully consumed
    iterations: int       # host loop iterations run


def _build_tables(plans: Sequence[ModelPlan], device: torch.device):
    """Numpy-precompute the per-model tables; returns (tables, LP, NA)."""
    from repro_torch.core.accuracy import combo_retained_fraction

    M = len(plans)
    NA = plans[0].platform.n_acc
    LP = max(len(p.model.layers) for p in plans)
    lat = np.full((M, LP, NA), np.inf)
    latv = np.full((M, LP, NA), np.inf)
    vdlr = np.zeros((M, LP + 1))
    rm = np.zeros((M, LP + 2))
    minl = np.zeros((M, LP))
    nl = np.zeros(M, np.int64)
    factor = np.zeros((M, LP))
    hasv = np.zeros((M, LP), bool)
    theta = np.zeros(M)
    for m, p in enumerate(plans):
        L = len(p.model.layers)
        nl[m] = L
        lat[m, :L] = p.lat
        latv[m, :L] = p.lat_var
        vdlr[m, :L] = p.vdl_rel
        rm[m, : L + 1] = p.remaining_min
        minl[m, :L] = p.min_lat
        theta[m] = p.theta
        for l, v in p.variants.items():
            hasv[m, l] = True
            factor[m, l] = combo_retained_fraction((v.loss,))

    # The bind table holds, for every (m, l) with l <= LP, the values the
    # reference gathers when a request enters layer l — copied, never
    # recomputed, with out-of-range indices clamped as its gathers clamp
    # (those rows only ever feed masked writes).
    ls = np.arange(LP + 1)
    lo, hi = np.minimum(ls, LP - 1), np.minimum(ls + 1, LP - 1)
    cols = [
        vdlr[:, ls], vdlr[:, np.minimum(ls + 1, LP)],
        rm[:, ls], rm[:, ls + 1], rm[:, np.minimum(ls + 2, LP + 1)],
        minl[:, hi], factor[:, lo], hasv[:, lo],
        (ls[None, :] + 1) < nl[:, None], ls[None, :] >= nl[:, None],
    ]
    assert len(cols) == len(_BIND_COLS)
    bind = np.concatenate(
        [lat[:, lo], latv[:, lo]] + [np.asarray(c, np.float64)[:, :, None] for c in cols],
        axis=2,
    )

    def dev(a):
        return torch.from_numpy(a).to(device)

    return _Tables(bind=dev(bind), factor=dev(factor), theta=dev(theta)), LP, NA


def _g(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-lane element: ``x[b, idx[b]]`` for x ``[B, N]``, idx ``[B]``."""
    return x.gather(1, idx[:, None])[:, 0]


def _row(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-lane row: ``x[b, idx[b], :]`` for x ``[B, N, K]``, idx ``[B]``."""
    return x.gather(1, idx[:, None, None].expand(-1, 1, x.shape[2]))[:, 0]


def _run_trials(
    T: _Tables,
    at, am, d_abs, d_eps12, ne,  # [B, NR+1], [B, NR], [B, NR], [B, NR], [B]
    duration: float, max_it: int,
    *, kind: str, mode: str, use_budgets: bool, use_variants: bool,
    na: int, lp: int,
) -> _Out:
    """The whole-trial program: the masked event loop over all lanes.

    Per-request state is one cache row per slot, ``cache [B, NR, W]``:
    the original and variant latency rows, then the five per-slot
    scalars (virtual deadline, next virtual deadline, next layer's min
    latency, remaining-min, EDF key), so a bind is one predicated write
    and a pick reads its whole row with one gather."""
    NA, LP = na, lp
    B, NR = am.shape
    dev = am.device
    NRa = torch.arange(NR, device=dev)
    NAa = torch.arange(NA, device=dev)
    IMAX = torch.iinfo(_I64).max
    V0, S0 = NA, 2 * NA  # cache column offsets: variant row, scalars
    VDL, VDLN, NM, RM, EK = range(S0, S0 + 5)

    def full(shape, v, dtype=_F64):
        return torch.full(shape, v, dtype=dtype, device=dev)

    # -- the lane state (the reference's carry, one row per lane) ----------
    ai = full((B,), 0, _I64)
    it = full((B,), 0, _I64)
    cnt = full((B,), 0, _I64)
    rounds = full((B,), 0, _I64)
    done_ctr = full((B,), 0, _I64)
    state = full((B, NR), 0, _I64)
    layer = full((B, NR), 0, _I64)
    cache = full((B, NR, S0 + 5), 0.0)
    cache[:, :, :S0] = _INF
    cache[:, :, RM] = _INF
    ret = full((B, NR), 1.0)
    # flat [NR*LP] variant-sequence table plus one sentinel column that
    # masked writes land in
    app_seq = full((B, NR * LP + 1), -1, _I64)
    app_cnt = full((B, NR), 0, _I64)
    missed = full((B, NR), False, torch.bool)
    done_seq = full((B, NR), -1, _I64)
    busy = full((B, NA), 0.0)
    busy_t = full((B, NA), 0.0)
    busy_h = full((B, NA), 0.0)
    fin_t = full((B, NA), _INF)
    fin_cnt = full((B, NA), 0, _I64)
    run_req = full((B, NA), -1, _I64)
    no_var = torch.zeros(B, dtype=torch.bool, device=dev)
    inf_row = full((B, NA), _INF)

    def lanes_active():
        return (ai < ne) | (run_req >= 0).any(1)

    BC = {name: 2 * NA + j for j, name in enumerate(_BIND_COLS)}

    # ---- scheduler kernels: (valid, i, k, use_var, cost) per pick, each
    # [B, P], in reference emission order --------------------------------
    def kern_terastal(ready, idle0, now):
        c_lat = cache[:, :, :V0]
        c_latv = cache[:, :, V0:S0]
        c_vdl = cache[:, :, VDL]
        c_vdln = cache[:, :, VDLN]
        c_nm = cache[:, :, NM]
        tau0 = torch.maximum(busy, now[:, None])           # [B, NA]
        fo = c_lat + tau0[:, None, :]                      # [B, NR, NA]
        fv = c_latv + tau0[:, None, :]
        keys = c_vdl - fo.amin(2)     # stage-1 (slack, rid) sort key
        d_eps = c_vdl + 1e-15
        # +inf (no variant) fails the variant test
        ok = (fo <= d_eps[:, :, None]) | (fv <= d_eps[:, :, None])
        tau = tau0
        idle = idle0
        alive = ready
        picks = []
        # stage 1: repeated (slack, rid)-argmin over feasible slots
        for _ in range(NA):
            feas = alive & (ok & idle[:, None, :]).any(2)
            mk = torch.where(feas, keys, _INF)
            i = mk.argmin(1)
            valid = _g(mk, i) < _INF
            row = _row(cache, i)
            fo_i = _row(fo, i)                 # [B, NA], round-start tau
            fv_i = _row(fv, i)
            de_i = _g(d_eps, i)[:, None]
            vo = torch.where(idle & (fo_i <= de_i), fo_i, _INF)
            ko = vo.argmin(1)
            any_o = _g(vo, ko) < _INF    # original first (lines 4-10)
            vv = torch.where(idle & (fv_i <= de_i), fv_i, _INF)
            kv = vv.argmin(1)
            use_var = ~any_o
            k_sel = torch.where(any_o, ko, kv)
            c = _g(row, torch.where(use_var, kv + V0, ko))
            picks.append((valid, i, k_sel, use_var, c))
            hitk = (NAa == k_sel[:, None]) & valid[:, None]
            tau = torch.where(hitk, tau + c[:, None], tau)
            idle = idle & ~hitk
            alive = alive & ~((NRa == i[:, None]) & valid[:, None])
        # stage 2: backfill remaining idle accelerators, ascending k
        for k in range(NA):
            fo = c_lat + tau[:, None, :]
            f0 = fo.amin(2)                    # s* at CURRENT tau
            s_star = c_vdl - f0
            fino = fo[:, :, k]
            t = ((c_vdln - fino) - c_nm) - s_star  # Eq. 8-9
            if mode == "ef":
                okm = (fino <= f0 + 1e-15) & alive
            else:
                okm = alive
            do = torch.where(okm, t, -_INF)
            cv = c_latv[:, :, k]
            fv = c_latv + tau[:, None, :]
            finv = fv[:, :, k]
            t2 = ((c_vdln - finv) - c_nm) - s_star
            if mode == "ef":
                ok2 = (finv <= fv.amin(2) + 1e-15) & (cv < _INF)
            else:
                ok2 = cv < _INF  # latencies are finite or +inf
            dv = torch.where(ok2 & alive, t2, -_INF)
            mo = do.amax(1)
            mv = dv.amax(1)
            orig_wins = mo >= mv      # (delta, -use_var) strictly-greater
            best = torch.where(orig_wins, mo, mv)
            valid = idle[:, k] & (best > -_INF)
            if mode == "positive":
                valid = valid & (best > 0.0)
            d_sel = torch.where(orig_wins[:, None], do, dv)
            i = torch.where(d_sel == best[:, None], keys, _INF).argmin(1)
            use_var = ~orig_wins       # ties go to the earliest stage-1 key
            c = _g(torch.where(use_var[:, None], cv, c_lat[:, :, k]), i)
            picks.append((valid, i, torch.full_like(i, k), use_var, c))
            tau = torch.where((NAa == k) & valid[:, None], tau + c[:, None], tau)
            alive = alive & ~((NRa == i[:, None]) & valid[:, None])
        return picks

    def kern_greedy(ready, idle0, now):
        c_lat = cache[:, :, :V0]
        if kind == "fcfs":
            key = at[:, :NR]                       # (arrival, rid)
        elif kind == "edf":
            key = cache[:, :, EK]                  # (edf deadline, rid)
        else:  # dream
            key = (d_abs - now[:, None]) - cache[:, :, RM]  # (slack, rid)
        tau0 = torch.maximum(busy, now[:, None])   # round-start, not updated
        idle = idle0
        alive = ready
        picks = []
        for _ in range(NA):
            mk = torch.where(alive, key, _INF)
            i = mk.argmin(1)
            ok_i = _g(mk, i) < _INF
            lat_i = _row(c_lat, i)
            if kind == "dream":
                vals = torch.where(idle, tau0 + lat_i, _INF)
            else:   # fcfs/edf: lowest latency, first-min ascending k
                vals = torch.where(idle, lat_i, _INF)
            k = vals.argmin(1)
            valid = ok_i & (_g(vals, k) < _INF)
            c = _g(lat_i, k)
            picks.append((valid, i, k, no_var, c))
            idle = idle & ~((NAa == k[:, None]) & valid[:, None])
            alive = alive & ~((NRa == i[:, None]) & valid[:, None])
        return picks

    kern = kern_terastal if kind == "terastal" else kern_greedy

    iterations = 0
    while iterations < max_it:
        for _ in range(min(CHECK_EVERY, max_it - iterations)):
            iterations += 1
            act = lanes_active() & (it < max_it)
            it = it + act
            # pop: lexicographic (time, counter) min; arrivals beat
            # same-time finishes (their heap counters are always smaller)
            arr_next = _g(at, ai)
            ft_min = fin_t.amin(1)
            k_f = torch.where(fin_t == ft_min[:, None], fin_cnt, IMAX).argmin(1)
            arr_first = arr_next <= ft_min
            is_arr = arr_first & act
            is_fin = ~arr_first & act
            now = torch.where(arr_first, arr_next, ft_min)

            # slot == rid == stream index; garbage on a masked lane, so
            # clamp it into range for the gathers (its writes are masked)
            r = torch.where(arr_first, ai, _g(run_req, k_f)).clamp(0, NR - 1)
            m = _g(am, r)
            l_new = torch.where(arr_first, 0, _g(layer, r) + 1)
            bt = T.bind[m, l_new.clamp(max=LP)]   # [B, W] layer l_new of m
            done = is_fin & (bt[:, BC["last"]] > 0.5)

            hit_f = (NAa == k_f[:, None]) & is_fin[:, None]
            at_r = NRa == r[:, None]
            hit_r = at_r & act[:, None]
            hit_d = at_r & done[:, None]
            ai = ai + is_arr
            fin_t = torch.where(hit_f, _INF, fin_t)
            run_req = torch.where(hit_f, -1, run_req)
            layer = torch.where(hit_r, l_new[:, None], layer)
            state = torch.where(hit_r, torch.where(done, 3, 1)[:, None], state)
            missed = torch.where(hit_d, (now > _g(d_eps12, r))[:, None], missed)
            done_seq = torch.where(hit_d, done_ctr[:, None], done_seq)
            done_ctr = done_ctr + done

            # bind: request r becomes ready at layer l_new
            a = _g(at, r)
            dr = _g(d_abs, r)
            if use_variants:
                # LayerVariantFeasible at push time (static while ready)
                vok = (bt[:, BC["hasv"]] > 0.5) & (
                    _g(ret, r) * bt[:, BC["factor"]] >= T.theta[m]
                )
                latv_row = torch.where(vok[:, None], bt[:, NA:2 * NA], _INF)
            else:
                latv_row = inf_row
            has_next = bt[:, BC["has_next"]] > 0.5
            rm1 = dr - bt[:, BC["rm1"]]
            if use_budgets:
                vdl = a + bt[:, BC["vdlr"]]
                vdln = torch.where(has_next, a + bt[:, BC["vdlr1"]], dr)
            else:
                vdl = rm1
                vdln = torch.where(has_next, dr - bt[:, BC["rm2"]], dr)
            nm = torch.where(has_next, bt[:, BC["minl1"]], 0.0)
            row = torch.cat([
                bt[:, :NA], latv_row,
                torch.stack([vdl, vdln, nm, bt[:, BC["rm"]], rm1], 1),
            ], 1)
            hit = at_r & (act & ~done)[:, None]
            cache = torch.where(hit[:, :, None], row[:, None, :], cache)

            # batch simultaneous events before scheduling (ref: abs < 1e-15
            # against the just-popped now; empty heap -> +inf -> round runs)
            t_next = torch.minimum(_g(at, ai), fin_t.amin(1))
            do_round = ~((t_next - now).abs() < 1e-15) & act
            rounds = rounds + do_round
            ready0 = (state == 1) & do_round[:, None]
            dropm = ready0 & ((now[:, None] + cache[:, :, RM]) > d_eps12)
            state = torch.where(dropm, 4, state)   # early-drop
            missed = missed | dropm
            ready = ready0 & ~dropm
            idle = busy <= (now + 1e-15)[:, None]
            picks = kern(ready, idle, now)

            # apply emissions.  Valid picks land on distinct accelerators
            # and distinct rows, so they apply as one set of predicated
            # writes; the finish counter of a pick is cnt + (# valid picks
            # before it), an integer prefix count.
            valid, pi, pk, uv, pc = (torch.stack(x, 1) for x in zip(*picks))
            n_before = valid.cumsum(1) - valid.long()
            rem = duration - now
            rem = torch.where(rem > 0.0, rem, 0.0)[:, None]
            fin = now[:, None] + pc
            hc = torch.where(pc <= rem, pc, rem)
            hit_a = (pk[:, :, None] == NAa) & valid[:, :, None]  # [B, P, NA]
            on_a = hit_a.any(1)
            p_a = hit_a.to(torch.uint8).argmax(1)     # the pick on each acc
            fin_a = fin.gather(1, p_a)
            c_a = pc.gather(1, p_a)
            run_req = torch.where(on_a, pi.gather(1, p_a), run_req)
            fin_t = torch.where(on_a, fin_a, fin_t)
            fin_cnt = torch.where(on_a, (cnt[:, None] + n_before).gather(1, p_a),
                                  fin_cnt)
            busy = torch.where(on_a, fin_a, busy)
            busy_t = torch.where(on_a, busy_t + c_a, busy_t)
            busy_h = torch.where(on_a, busy_h + hc.gather(1, p_a), busy_h)
            hit_i = (pi[:, :, None] == NRa) & valid[:, :, None]  # [B, P, NR]
            state = torch.where(hit_i.any(1), 2, state)
            cnt = cnt + valid.sum(1)
            if kind == "terastal":
                # variant bookkeeping from the pre-round layer / app_cnt
                # of each (unique) picked row
                va = valid & uv
                l_p = layer.gather(1, pi)
                flat = torch.where(va, pi * LP + l_p, NR * LP)
                app_seq.scatter_(1, flat, app_cnt.gather(1, pi))
                hit_v = hit_i & va[:, :, None]
                on_v = hit_v.any(1)
                # (an invalid pick may name a finished row: clamp its layer)
                f_p = T.factor[am.gather(1, pi), l_p.clamp(max=LP - 1)]
                f_r = f_p.gather(1, hit_v.to(torch.uint8).argmax(1))
                app_cnt = app_cnt + on_v
                ret = torch.where(on_v, ret * f_r, ret)
        if not bool(lanes_active().any()):
            break

    drained = ~lanes_active()
    out = [state, missed, app_seq[:, : NR * LP].reshape(B, NR, LP), app_cnt,
           done_seq, busy_t, busy_h, rounds, drained]
    host = [t.cpu().numpy() for t in out]  # the host copy
    return _Out(*host, iterations=iterations)


# ------------------------------------------------------- host wrapper ----


def _validate(
    plans, tasks, scheduler, processes, policy, adm, fault_model=None
) -> None:
    """Static event-horizon validation: reject every axis whose events the
    speculative device rollout cannot cover.  Named errors, no fallback."""
    from repro_torch.core.admission import NoAdmission
    from repro_torch.core.budget_online import BudgetPolicy, StaticBudgetPolicy

    for p in plans:
        if p.dag is not None:
            raise BatchUnsupportedError(
                f"engine='batch' does not support DAG plans (model "
                f"{p.model.name!r}): sibling node entries of one request "
                "break the one-slot-per-request lane layout; use "
                "engine='soa' or engine='reference'"
            )
    if (
        fault_model is not None
        and fault_model.active
        and fault_model.interrupted == "resume"
    ):
        raise BatchUnsupportedError(
            "engine='batch' does not support fault injection with the "
            f"'resume' interrupted-work policy ({fault_model.format()!r}): "
            "partial layer progress re-times re-dispatches mid-rollout, "
            "which the pre-bound capability epochs cannot express; use "
            "engine='soa' or engine='reference'"
        )
    if fault_model is not None and fault_model.active:
        raise BatchUnsupportedError(
            "engine='batch' of the torch port does not support fault "
            f"injection yet ({fault_model.format()!r}): the fault lane "
            "(pack_fault_epochs and the faulted branch) comes in a later "
            "slice; use engine='soa' or engine='reference'"
        )
    if type(scheduler) not in (
        FcfsScheduler, EdfScheduler, DreamScheduler, TerastalScheduler
    ):
        raise BatchUnsupportedError(
            f"engine='batch' has no kernel for {type(scheduler).__name__}; "
            "custom Scheduler subclasses need the reference engine"
        )
    if type(policy) not in (StaticBudgetPolicy, BudgetPolicy):
        raise BatchUnsupportedError(
            f"engine='batch' does not support online budget policy "
            f"{type(policy).__name__}: per-event vdl mutation breaks the "
            "pre-bound virtual-deadline rows; use engine='soa'"
        )
    if policy.tick_interval > 0:
        raise BatchUnsupportedError(
            "engine='batch' does not support budget-policy tick events"
        )
    if adm is not None and type(adm) is not NoAdmission:
        raise BatchUnsupportedError(
            f"engine='batch' does not support admission policy "
            f"{type(adm).__name__}: backlog accounting is event-sequential; "
            "use engine='soa'"
        )
    for t_idx, task in enumerate(tasks):
        proc = processes[t_idx] if processes is not None else None
        proc = proc or task.arrival or DEFAULT_ARRIVAL
        if isinstance(proc, ClosedLoopClients):
            raise BatchUnsupportedError(
                "engine='batch' does not support closed-loop release "
                "coupling (ClosedLoopClients): completion-gated releases "
                "cannot be pre-generated; use engine='soa'"
            )


def simulate_batch(
    plans: Sequence[ModelPlan],
    tasks: Sequence[TaskSpec],
    duration: float,
    scheduler: Scheduler,
    seeds: Sequence[int],
    processes: Optional[Sequence[Optional[ArrivalProcess]]] = None,
    budget_policy=None,
    admission=None,
    faults=None,
    device: Union[str, torch.device, None] = None,
    stats: Optional[dict] = None,
) -> List[SimResult]:
    """Run B = ``len(seeds)`` trials of one cell as one tensor program.

    Same contract as ``simulate()`` for every supported axis — each
    returned :class:`SimResult` is fingerprint-identical to
    ``simulate(..., seed=s, engine="soa")``.  ``device`` is where the
    program runs (``cuda`` when None; a host with no card raises unless
    ``device="cpu"``).  Unsupported axes raise
    :class:`BatchUnsupportedError` (see :func:`_validate`); an undrained
    lane (the speculation bound failed — an engine bug, not a workload
    property) raises ``RuntimeError``.  When ``stats`` is a dict, the
    loop's ``iterations`` and the exact bound ``max_it`` are written
    into it.
    """
    from repro_torch.core.admission import make_admission_policy
    from repro_torch.core.budget_online import make_budget_policy
    from repro_torch.core.faults import make_fault_model
    from repro_torch.core.workload import batch_release_events

    dev = resolve_device(device)
    policy = make_budget_policy(budget_policy)
    policy.reset()
    adm = make_admission_policy(admission)
    adm.reset()
    fault_model = faults if not isinstance(faults, str) else make_fault_model(faults)
    _validate(plans, tasks, scheduler, processes, policy, adm, fault_model)

    kind = type(scheduler)
    if kind is TerastalScheduler:
        cfg = dict(
            kind="terastal", mode=scheduler.backfill_mode,
            use_budgets=scheduler.use_budgets,
            use_variants=scheduler.use_variants,
        )
    else:
        name = {FcfsScheduler: "fcfs", EdfScheduler: "edf",
                DreamScheduler: "dream"}[kind]
        cfg = dict(kind=name, mode="", use_budgets=False, use_variants=False)

    tables, LP, NA = _build_tables(plans, dev)
    deadline_by_model = np.array([p.deadline for p in plans])
    events = batch_release_events(tasks, duration, seeds, processes)
    buf, b_pad, nr_pad = scheduler_torch.pack_trials(events, deadline_by_model)

    # exact event-count bound: each loop iteration pops exactly one event,
    # and the horizon holds n_ev arrivals plus at most one finish per
    # executed layer (sum of layer counts over released requests)
    nl_by_model = np.array([len(p.model.layers) for p in plans])
    max_it = 2 + max(
        (len(t) + int(nl_by_model[m].sum()) for t, m in events), default=2
    )

    def lane(name, dtype):
        return torch.from_numpy(buf[name].astype(dtype)).to(dev)

    out = _run_trials(
        tables,
        lane("arr_t", np.float64), lane("arr_m", np.int64),
        lane("dl", np.float64), lane("dl12", np.float64),
        lane("n_ev", np.int64),
        float(duration), int(max_it),
        na=NA, lp=LP, **cfg,
    )
    if stats is not None:
        stats.update(iterations=out.iterations, max_it=int(max_it))

    drained = out.drained[: len(seeds)]
    if not drained.all():
        raise RuntimeError(
            "engine='batch' lane(s) %s did not drain their event horizon "
            "within the exact bound — engine bug" % np.flatnonzero(~drained)
        )

    results: List[SimResult] = []
    for b, (times, models) in enumerate(events):
        n = len(times)
        state = out.state[b, :n]
        missed_f = out.missed[b, :n]
        app_cnt = out.app_cnt[b, :n]
        per_model: Dict[int, ModelStats] = {t.model_idx: ModelStats() for t in tasks}
        for m in per_model:
            mm = models[:n] == m
            st = per_model[m]
            st.released = int(mm.sum())
            st.completed = int((mm & (state == 3)).sum())
            st.dropped = int((mm & (state == 4)).sum())
            st.missed = int((mm & missed_f).sum())
            # every released request ends completed, dropped, or in flight
            st.in_flight = st.released - st.completed - st.dropped
            st.variants_applied = int(app_cnt[mm].sum())
        # retained_sum: host replay in completion order, through the same
        # frozenset unions + combo_retained calls the reference performs
        done = np.flatnonzero(state == 3)
        for r in done[np.argsort(out.done_seq[b, done])]:
            m = int(models[r])
            applied = frozenset()
            seq = out.app_seq[b, r]
            order = np.flatnonzero(seq >= 0)
            for l in order[np.argsort(seq[order])]:
                applied = applied | {int(l)}
            per_model[m].retained_sum += plans[m].combo_retained(applied)
        results.append(
            SimResult(
                duration=duration,
                per_model=per_model,
                acc_busy_time=out.busy_t[b].copy(),
                scheduler_name=scheduler.name,
                acc_busy_in_horizon=out.busy_h[b].copy(),
                rounds=int(out.rounds[b]),
                faulted_spans=0,
            )
        )
    return results
