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

Fault injection (``restart`` interrupted-work policy)
-----------------------------------------------------
The reference's fault lane, in this module's layout.  A lane's fault
timeline is seed-deterministic, so the host pre-binds it as epochs
(``scheduler_torch.pack_fault_epochs``): the event stream, and per epoch
the ``[NA]`` latency multiplier (``+inf`` on a down accelerator) and the
capability-derived vdl / remaining-min / min-latency tables.  The loop
then pops four ways (arrival, then fault, then finish or ghost at equal
times), evicts or re-times the in-flight layer of a faulted accelerator
op for op as ``faults.evict_busy_adjust`` / ``retime_busy_adjust`` do
(the variant bookkeeping undone from the product saved at dispatch), and
replays each orphaned finish as a *ghost* pop, since the scalar engines'
stale heap pops still start a round.  Each round reads an epoch view of
``cache``: its latency rows times the epoch multiplier and its five
scalars gathered again from the epoch tables.  The lane is a static
branch: with no active fault model the loop runs exactly the fault-free
ops.  ``interrupted="resume"`` stays rejected, as in the reference:
fractional layer progress re-times re-dispatches mid-rollout.
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
    nl: torch.Tensor      # [M] layer counts


class _Faults(NamedTuple):
    """One call's fault timeline (``scheduler_torch.pack_fault_epochs``)."""

    fe_t: torch.Tensor     # [B, NF+1] event times, +inf pad and sentinel
    fe_acc: torch.Tensor   # [B, NF]
    fe_code: torch.Tensor  # [B, NF]   0 down / 1 up / 2 scale
    fe_val: torch.Tensor   # [B, NF]   scale factor (1 otherwise)
    n_f: torch.Tensor      # [B]
    mult_ep: torch.Tensor  # [B, NF+1, NA]         latency multiplier
    vdlr_ep: torch.Tensor  # [B, NF+1, M*(LP+1)]   vdl chains, flat per model
    rm_ep: torch.Tensor    # [B, NF+1, M*(LP+2)]   remaining-min
    minl_ep: torch.Tensor  # [B, NF+1, M*LP]       per-layer min latency


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
    evict_cnt: np.ndarray  # [B, NR] in-flight evictions (faults)
    remap_cnt: np.ndarray  # [B, NR] post-eviction re-dispatches
    fault_counts: np.ndarray  # [4] evictions, re-timings, ghost pops, undos
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

    tables = _Tables(bind=dev(bind), factor=dev(factor), theta=dev(theta), nl=dev(nl))
    return tables, LP, NA


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
    F: Optional[_Faults] = None,
    *, kind: str, mode: str, use_budgets: bool, use_variants: bool,
    na: int, lp: int,
) -> _Out:
    """The whole-trial program: the masked event loop over all lanes.

    Per-request state is one cache row per slot, ``cache [B, NR, W]``:
    the original and variant latency rows, then the five per-slot
    scalars (virtual deadline, next virtual deadline, next layer's min
    latency, remaining-min, EDF key), so a bind is one predicated write
    and a pick reads its whole row with one gather.  ``F`` turns on the
    fault lane (a static branch: ``None`` runs the fault-free ops)."""
    NA, LP = na, lp
    B, NR = am.shape
    dev = am.device
    faulted = F is not None
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
    if faulted:
        # the fault lane: epoch cursor and per-acc throttle scale; ghost
        # slots (orphaned finishes the scalar engines pop as no-ops, whose
        # pops still start rounds); the dispatch bookkeeping an eviction
        # or re-timing undoes; per-request eviction / remap counters; and
        # the lanes' totals of evictions, re-timings, ghost pops and undos
        NF = F.fe_acc.shape[1]
        NFa = torch.arange(NF, device=dev)
        fi = full((B,), 0, _I64)
        fscale = full((B, NA), 1.0)
        gh_t = full((B, NF), _INF)
        gh_cnt = full((B, NF), 0, _I64)
        gh_n = full((B,), 0, _I64)
        disp_t0 = full((B, NA), 0.0)
        disp_w = full((B, NA), 0.0)
        disp_h = full((B, NA), 0.0)
        run_uv = full((B, NA), False, torch.bool)
        run_prev_ret = full((B, NA), 1.0)
        ev_pend = full((B, NR), False, torch.bool)
        evict_cnt = full((B, NR), 0, _I64)
        remap_cnt = full((B, NR), 0, _I64)
        n_evict, n_retime, n_ghost, n_undo = (full((B,), 0, _I64) for _ in range(4))
        # per-slot gather bases into the flat per-model epoch tables
        nl_r = T.nl[am]
        base_v, base_r, base_m = am * (LP + 1), am * (LP + 2), am * LP

    def lanes_active():
        active = (ai < ne) | (run_req >= 0).any(1)
        if faulted:
            active = active | (fi < F.n_f) | (gh_t < _INF).any(1)
        return active

    BC = {name: 2 * NA + j for j, name in enumerate(_BIND_COLS)}

    def bind(cache, hit, bt, r, m):
        """Request ``r`` (of model ``m``) becomes ready at the layer whose
        bind-table row is ``bt``: its cache row, written where ``hit``."""
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
        return torch.where(hit[:, :, None], row[:, None, :], cache)

    def epoch_view(cache):
        """The cache as the current capability epoch sees it: latency rows
        times the epoch multiplier (``+inf`` on a down accelerator), the
        five scalars gathered again from the epoch tables, with the
        reference's clamps (rows not in flight read clamped garbage that
        no ready mask lets through)."""
        mult = _row(F.mult_ep, fi)                     # [B, NA]
        vdlr_f = _row(F.vdlr_ep, fi)                   # [B, M*(LP+1)]
        rm_f = _row(F.rm_ep, fi)                       # [B, M*(LP+2)]
        minl_f = _row(F.minl_ep, fi)                   # [B, M*LP]
        has_nx = (layer + 1) < nl_r
        rm_l1 = rm_f.gather(1, base_r + (layer + 1).clamp(max=LP + 1))
        if use_budgets:
            vdl_v = at[:, :NR] + vdlr_f.gather(1, base_v + layer.clamp(max=LP))
            vdln_v = torch.where(
                has_nx,
                at[:, :NR] + vdlr_f.gather(1, base_v + (layer + 1).clamp(max=LP)),
                d_abs,
            )
        else:
            vdl_v = d_abs - rm_l1
            vdln_v = torch.where(
                has_nx,
                d_abs - rm_f.gather(1, base_r + (layer + 2).clamp(max=LP + 1)),
                d_abs,
            )
        nm_v = torch.where(
            has_nx, minl_f.gather(1, base_m + (layer + 1).clamp(max=LP - 1)), 0.0
        )
        rm_v = rm_f.gather(1, base_r + layer.clamp(max=LP + 1))
        ek_v = d_abs - rm_l1
        return torch.cat([
            cache[:, :, :S0] * torch.cat([mult, mult], 1)[:, None, :],
            torch.stack([vdl_v, vdln_v, nm_v, rm_v, ek_v], 2),
        ], 2)

    # ---- scheduler kernels: (valid, i, k, use_var, cost) per pick, each
    # [B, P], in reference emission order --------------------------------
    def kern_terastal(cache, ready, idle0, now):
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

    def kern_greedy(cache, ready, idle0, now):
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
            if faulted:
                # arrival < fault < finish/ghost at equal times (the
                # reference's counters: arrivals, then faults, then
                # dynamic finishes); ghost vs finish on the stored counters
                f_next = _g(F.fe_t, fi)
                gh_min = gh_t.amin(1)
                oth = torch.minimum(ft_min, gh_min)
                arr_first = arr_next <= torch.minimum(f_next, oth)
                fault_first = ~arr_first & (f_next <= oth)
                g_i = torch.where(gh_t == gh_min[:, None], gh_cnt, IMAX).argmin(1)
                ghost_first = ~arr_first & ~fault_first & (
                    (gh_min < ft_min)
                    | ((gh_min == ft_min) & (_g(gh_cnt, g_i) < _g(fin_cnt, k_f)))
                )
                is_arr = arr_first & act
                is_fault = fault_first & act
                is_ghost = ghost_first & act
                is_fin = ~(arr_first | fault_first | ghost_first) & act
                pop_rf = is_arr | is_fin
                now = torch.where(
                    arr_first, arr_next,
                    torch.where(fault_first, f_next,
                                torch.where(ghost_first, gh_min, ft_min)),
                )
                # a ghost pop only clears its slot; it still reaches the round
                gh_t = torch.where((NFa == g_i[:, None]) & is_ghost[:, None], _INF, gh_t)
                n_ghost = n_ghost + is_ghost
            else:
                arr_first = arr_next <= ft_min
                is_arr = arr_first & act
                is_fin = ~arr_first & act
                pop_rf = act
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
            hit_r = at_r & pop_rf[:, None]
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
            cache = bind(cache, at_r & (pop_rf & ~done)[:, None], bt, r, m)

            if faulted:
                # ---- capability event (masked is_fault) -------------------
                fi_c = fi.clamp(max=NF - 1)
                fk = _g(F.fe_acc, fi_c)
                code = _g(F.fe_code, fi_c)
                val = _g(F.fe_val, fi_c)
                is_down = is_fault & (code == 0)
                is_up = is_fault & (code == 1)
                is_scale = is_fault & (code == 2)
                r_e = _g(run_req, fk)
                has_run = r_e >= 0
                # down with an in-flight layer: undo the dispatch (variant
                # bookkeeping, un-run busy time), back to ready
                ev = is_down & has_run
                r_ec = r_e.clamp(min=0)
                l_e = _g(layer, r_ec)
                m_e = _g(am, r_ec)
                undo = ev & _g(run_uv, fk)
                hit_u = (NRa == r_e[:, None]) & undo[:, None]
                # exact ret restore: the evicted variant is the request's
                # latest apply, so the product saved at dispatch undoes it
                ret = torch.where(hit_u, _g(run_prev_ret, fk)[:, None], ret)
                app_seq.scatter_(
                    1, torch.where(undo, r_ec * LP + l_e, NR * LP)[:, None], -1
                )
                app_cnt = app_cnt - hit_u.long()
                # faults.evict_busy_adjust, op for op
                t0 = _g(disp_t0, fk)
                rem0 = duration - t0
                rem0 = torch.where(rem0 > 0.0, rem0, 0.0)
                new_w = now - t0
                new_h = torch.minimum(new_w, rem0)
                dw = new_w - _g(disp_w, fk)
                dh = new_h - _g(disp_h, fk)
                at_k = NAa == fk[:, None]
                hit_e = at_k & ev[:, None]
                # scale with an in-flight layer: re-time its finish by
                # new / old scale (faults.retime_busy_adjust)
                old = _g(fscale, fk)
                changed = is_scale & has_run & (val != old)
                fin_old = _g(busy, fk)
                fin_new = now + (fin_old - now) * (val / old)
                nw2 = fin_new - t0
                nh2 = torch.minimum(nw2, rem0)
                dw2 = nw2 - _g(disp_w, fk)
                dh2 = nh2 - _g(disp_h, fk)
                hit_s = at_k & changed[:, None]
                # eviction and re-timing both orphan the old finish: it
                # becomes a ghost (a stale heap entry in the reference)
                ghost = ev | changed
                gh_hit = (NFa == gh_n[:, None]) & ghost[:, None]
                hit_dn = at_k & is_down[:, None]
                hit_up = at_k & is_up[:, None]
                gh_t = torch.where(gh_hit, _g(fin_t, fk)[:, None], gh_t)
                gh_cnt = torch.where(gh_hit, _g(fin_cnt, fk)[:, None], gh_cnt)
                gh_n = gh_n + ghost
                busy = torch.where(
                    hit_dn, _INF,
                    torch.where(hit_up, now[:, None],
                                torch.where(hit_s, fin_new[:, None], busy)),
                )
                busy_t = torch.where(
                    hit_e, busy_t + dw[:, None],
                    torch.where(hit_s, busy_t + dw2[:, None], busy_t),
                )
                busy_h = torch.where(
                    hit_e, busy_h + dh[:, None],
                    torch.where(hit_s, busy_h + dh2[:, None], busy_h),
                )
                fin_t = torch.where(
                    hit_dn, _INF, torch.where(hit_s, fin_new[:, None], fin_t)
                )
                # the re-timed finish takes the counter before the round's
                # emissions take theirs
                fin_cnt = torch.where(hit_s, cnt[:, None], fin_cnt)
                run_req = torch.where(hit_dn, -1, run_req)
                cnt = cnt + changed
                fscale = torch.where(at_k & is_scale[:, None], val[:, None], fscale)
                hit_ev = (NRa == r_e[:, None]) & ev[:, None]
                state = torch.where(hit_ev, 1, state)
                ev_pend = ev_pend | hit_ev
                evict_cnt = evict_cnt + hit_ev.long()
                disp_w = torch.where(hit_s, nw2[:, None], disp_w)
                disp_h = torch.where(hit_s, nh2[:, None], disp_h)
                fi = fi + is_fault
                n_evict = n_evict + ev
                n_retime = n_retime + changed
                n_undo = n_undo + undo
                # bind the evicted row again at its current layer, with the
                # ret left after the undo (its variant may be feasible again)
                cache = bind(cache, hit_ev, T.bind[m_e, l_e.clamp(max=LP)], r_ec, m_e)

            # batch simultaneous events before scheduling (ref: abs < 1e-15
            # against the just-popped now; empty heap -> +inf -> round runs)
            t_next = torch.minimum(_g(at, ai), fin_t.amin(1))
            if faulted:
                t_next = torch.minimum(
                    t_next, torch.minimum(_g(F.fe_t, fi), gh_t.amin(1))
                )
            do_round = ~((t_next - now).abs() < 1e-15) & act
            rounds = rounds + do_round
            # the round reads the current capability epoch's view
            view = epoch_view(cache) if faulted else cache
            ready0 = (state == 1) & do_round[:, None]
            dropm = ready0 & ((now[:, None] + view[:, :, RM]) > d_eps12)
            state = torch.where(dropm, 4, state)   # early-drop
            missed = missed | dropm
            ready = ready0 & ~dropm
            idle = busy <= (now + 1e-15)[:, None]
            picks = kern(view, ready, idle, now)

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
            hc_a = hc.gather(1, p_a)
            pi_a = pi.gather(1, p_a)
            if faulted:
                # the dispatch bookkeeping an eviction or re-timing undoes;
                # the pre-round ret is the product before this apply
                disp_t0 = torch.where(on_a, now[:, None], disp_t0)
                disp_w = torch.where(on_a, c_a, disp_w)
                disp_h = torch.where(on_a, hc_a, disp_h)
                run_uv = torch.where(on_a, uv.gather(1, p_a), run_uv)
                run_prev_ret = torch.where(on_a, ret.gather(1, pi_a), run_prev_ret)
            run_req = torch.where(on_a, pi_a, run_req)
            fin_t = torch.where(on_a, fin_a, fin_t)
            fin_cnt = torch.where(on_a, (cnt[:, None] + n_before).gather(1, p_a),
                                  fin_cnt)
            busy = torch.where(on_a, fin_a, busy)
            busy_t = torch.where(on_a, busy_t + c_a, busy_t)
            busy_h = torch.where(on_a, busy_h + hc_a, busy_h)
            hit_i = (pi[:, :, None] == NRa) & valid[:, :, None]  # [B, P, NR]
            picked = hit_i.any(1)
            state = torch.where(picked, 2, state)
            if faulted:
                # a dispatched evicted-pending request is remapped
                remap_cnt = remap_cnt + (picked & ev_pend).long()
                ev_pend = ev_pend & ~picked
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
    if faulted:
        out += [evict_cnt, remap_cnt,
                torch.stack([n_evict, n_retime, n_ghost, n_undo]).sum(1)]
    host = [t.cpu().numpy() for t in out]  # the host copy
    if not faulted:
        zero = np.zeros((B, NR), np.int64)
        host += [zero, zero, np.zeros(4, np.int64)]
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
    into it, and the lanes' totals of the fault lane's ``evictions``,
    ``retimings``, ``ghost_pops`` and ``variant_undos`` (all 0 without
    an active fault model).
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

    def lane(name, dtype, src=buf):
        return torch.from_numpy(src[name].astype(dtype)).to(dev)

    faulted = fault_model is not None and fault_model.active
    F = None
    n_spans = [0] * len(seeds)
    if faulted:
        fbuf, _, n_spans = scheduler_torch.pack_fault_epochs(
            fault_model, plans, duration, seeds, b_pad, LP
        )
        # each fault event adds at most three pops: itself, the ghost of
        # an orphaned finish, and the re-dispatched layer's new finish
        max_it += 3 * int(fbuf["n_f"].max())

        def epochs(name):
            a = fbuf[name]
            return torch.from_numpy(a.reshape(a.shape[0], a.shape[1], -1)).to(dev)

        F = _Faults(
            fe_t=lane("fe_t", np.float64, fbuf),
            fe_acc=lane("fe_acc", np.int64, fbuf),
            fe_code=lane("fe_code", np.int64, fbuf),
            fe_val=lane("fe_val", np.float64, fbuf),
            n_f=lane("n_f", np.int64, fbuf),
            mult_ep=epochs("mult_ep"), vdlr_ep=epochs("vdlr_ep"),
            rm_ep=epochs("rm_ep"), minl_ep=epochs("minl_ep"),
        )

    out = _run_trials(
        tables,
        lane("arr_t", np.float64), lane("arr_m", np.int64),
        lane("dl", np.float64), lane("dl12", np.float64),
        lane("n_ev", np.int64),
        float(duration), int(max_it), F,
        na=NA, lp=LP, **cfg,
    )
    if stats is not None:
        stats.update(iterations=out.iterations, max_it=int(max_it),
                     **dict(zip(("evictions", "retimings", "ghost_pops", "variant_undos"),
                                (int(c) for c in out.fault_counts))))

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
        evict_c = out.evict_cnt[b, :n]
        remap_c = out.remap_cnt[b, :n]
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
            st.evicted = int(evict_c[mm].sum())
            st.remapped = int(remap_c[mm].sum())
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
                faulted_spans=n_spans[b],
            )
        )
    return results
