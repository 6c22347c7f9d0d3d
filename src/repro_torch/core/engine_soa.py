"""Structure-of-arrays simulation engine — bit-identical, much faster.

The reference event loop (``repro_torch.core.simulator._simulate_reference``)
spends its time on per-event object churn: every scheduler invocation
rebuilds a :class:`SchedView` (``list(ready)`` + ``acc_busy_until.copy()``),
every decision re-derives per-request quantities (virtual deadlines,
latency rows, remaining-min sums) through NumPy scalar ops on 3-element
arrays, and the ready queue pays O(n) ``list.remove`` / ``req not in
ready`` scans.  At campaign scale (fig5-fig8 run tens of thousands of
trials) the sweeps are bound by interpreter overhead, not by the
simulated hardware.

This engine keeps the exact event semantics but restructures the state:

* per-request state lives in preallocated parallel arrays (the
  :class:`_ReadyBlock`): request slot -> deadline / remaining-min /
  latency rows / virtual deadlines / sort keys, computed once at push
  time instead of once per scheduler invocation;
* the ready set is indexed — removal is an O(1) swap-with-last, and
  membership never needs scanning;
* ``drop_hopeless`` is one masked compare over the ready block, and a
  conservative scalar guard (``_ReadyBlock.guard``) skips even that
  until the clock is within 1e-9 of the earliest possible drop;
* scheduler decisions run as specialized kernels over the block's
  cached Python floats (for n_acc ~ 3 and a handful of ready layers,
  scalar arithmetic beats tiny-ndarray dispatch by ~10x; IEEE float64
  ops are identical either way, so results match bit-for-bit).  FCFS/EDF
  placement walks a precomputed per-layer accelerator-preference order
  (``ModelPlan.acc_pref_rows``) instead of comparing latencies at all;
* uncontended request chains run in a fused loop: while exactly one
  request is outstanding and no other event interrupts (``heap[0]``
  check), each layer advances with no event-queue traffic — the same
  kernels decide placement on a single-slot block, so the decision logic
  has one source of truth.

Budget policies run natively: each request is still materialized once as
a :class:`Request` record (that is O(requests), not O(events) — the
churn the reference pays is per *invocation*), and the unchanged policy
hooks mutate ``Request.vdl_abs`` exactly as in the reference engine.
Policies must REBIND ``vdl_abs`` rather than mutate it in place (all
built-ins do): the engine detects chain updates by identity to refresh
its cached virtual-deadline scalars.  ``on_tick`` receives the ready set
in block-slot order (the reference passes insertion order; built-in
policies are per-request and order-independent) and a copy of
``acc_busy_until``.

Deep-queue fast path (saturation regime, NJ >> 16)
---------------------------------------------------
The scalar kernels above are tuned for the paper's grids (a handful of
ready layers); their per-round cost is O(NJ * n_acc) *interpreted* ops,
which dominates exactly when overload makes ready queues deep.  Above a
queue-depth threshold the engine switches representation and kernel:

* the block activates **deep mirrors** — numpy arrays (``lat_arr``,
  ``latv_arr``, ``vdl_arr``, ...) maintained *incrementally* alongside
  the scalar lists: only arrivals, finishes, and vdl-rebinds write a
  slot (push / ``_fill_vdl`` / ``swap_remove``); a scheduling round
  re-keys nothing per-slot and runs as a few C-speed vector ops;
* FCFS/EDF keep their ready order **incrementally sorted** across
  rounds (``bisect.insort`` on push, bisect-remove on pop) — exact,
  because their sort keys are static per slot — so a round walks at
  most ``n_idle`` entries instead of re-sorting NJ tuples;
* Terastal and DREAM keys depend on ``now``/tau through per-slot
  roundings, so an incrementally sorted order cannot stay bit-identical
  (ordering by the algebraically equivalent static key differs near
  float ties — a measured negative result); their deep rounds instead
  recompute keys vectorized and ``np.lexsort`` them: O(NJ log NJ) with
  C constants, against the reference's interpreted re-scan;
* Terastal stage 2 scores every (remaining layer x idle accelerator)
  pair as masked vector arithmetic with an argmax whose tie-breaking
  reproduces the reference's strictly-greater ``(delta, -use_var)``
  replacement scan.  (A per-accelerator candidate *heap* was
  considered and rejected: every backfill score depends on the
  round-local tau of *all* accelerators through ``s*``, so heap keys
  go stale on every assignment and exact revalidation costs more than
  the vectorized rescan.)
* rounds deeper than a calibrated crossover can ride the **device
  round** (``scheduler_torch.terastal_round``, the port of the JAX
  package's jitted round, whose name ``round_kernel="jax"`` keeps):
  the block mirrors stage into ``pack_arrays``'s persistent pow2
  bucket buffers (one host->device copy per field, onto the
  ``device`` given to :func:`simulate_soa`, the card when None) and
  the outputs come back in one device sync, in the exact reference
  emission order via ``assign_seq``.  Kernel choice:
  ``REPRO_ROUND_KERNEL`` in {python, jax, auto}; "auto" uses the
  device round only above :func:`round_crossover` (env
  ``REPRO_ROUND_CROSSOVER`` or :func:`set_round_crossover`; +inf when
  neither is set, and then auto == python).

Bit-parity is enforced by differential tests (``tests/test_engine_soa.py``):
every ``SimResult`` field — per-model counters, ``retained_sum`` floats,
busy-time arrays — must equal the reference engine's exactly, across
schedulers x arrival processes x budget policies, and the deep kernels
are additionally pinned against the scalar ones at every pow2 bucket
boundary (``tests/test_round_kernels.py``).

Torch port: a copy of the JAX package's ``core/engine_soa.py`` whose
device round is ``scheduler_torch.terastal_round`` (the seam keeps the
reference's names: :func:`round_crossover`, :func:`set_round_crossover`,
``_jax_mod``, ``_jax_round`` and the ``jax_min`` / ``jax_on`` dispatch)
and whose :func:`simulate_soa` takes the ``device`` that round runs on.
"""

from __future__ import annotations

import os
from bisect import bisect_left, insort
from heapq import heappop, heappush
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.budget_online import BudgetPolicy, StaticBudgetPolicy
from repro_torch.core.dag import DagRun
from repro_torch.core.scheduler import (
    DreamScheduler,
    EdfScheduler,
    FcfsScheduler,
    Request,
    Scheduler,
    TerastalScheduler,
)
from repro_torch.core.admission import AdmissionPolicy, NoAdmission
from repro_torch.core.faults import (
    FaultModel,
    degraded_work_tables,
    effective_plans,
    evict_busy_adjust,
    fault_multipliers,
    retightened_vdl,
    retime_busy_adjust,
)
from repro_torch.core.simulator import (
    ArrivalProcess,
    ModelStats,
    SimResult,
    TaskSpec,
    generate_release_events,
)
from repro_torch.core.variants import ModelPlan

#: schedulers with a SoA kernel.  Exact types only: a subclass may
#: override ``schedule()``, which the kernels bypass — ``engine="auto"``
#: falls back to the reference loop for those.
_SUPPORTED = (FcfsScheduler, EdfScheduler, DreamScheduler, TerastalScheduler)

#: policies with no per-event side effects: the fused uncontended-chain
#: loop (which skips the policy hooks entirely) engages only for these.
_INERT_POLICIES = (StaticBudgetPolicy, BudgetPolicy)

_INF = float("inf")
_NEGINF = float("-inf")
_ONE = (0,)

# ------------------------------------------------- round-kernel dispatch ----

#: Terastal round-kernel choices: "python" (scalar/vectorized kernels,
#: depth-dispatched), "jax" (force the device round,
#: ``scheduler_torch.terastal_round``, for every block round), "auto"
#: (python below :func:`round_crossover`, the device round above).
#: Per-trial override: ``simulate(round_kernel=...)`` /
#: ``TrialSpec.round_kernel``; process-wide: ``REPRO_ROUND_KERNEL``.
ROUND_KERNELS = ("auto", "python", "jax")

#: ready-queue depth at which a Terastal/DREAM round switches from the
#: scalar kernel to the vectorized one (and the block activates its deep
#: mirrors).  Calibrated on captured saturation-round states (see
#: ``benchmarks/bench_scheduler_round.py``): the vectorized round costs
#: a ~13us flat floor of numpy dispatch, which the scalar kernel crosses
#: between NJ ~ 24 and 32; by NJ >= 64 the vectorized round is 2.6-7x
#: faster and essentially depth-independent.  ``REPRO_ROUND_VEC_MIN``
#: overrides (tests use it to force either path at any depth).
VEC_MIN_NJ = 24

_round_crossover: Optional[float] = None

#: memoized (raw env string, parsed value) for :func:`round_crossover` —
#: campaign trials call it once per simulation, and every pool worker
#: re-resolves it from a fresh process, so the parse is cached on the
#: raw string (``REPRO_ROUND_CROSSOVER=inf`` in particular hits this
#: fast path instead of re-parsing per trial).
_crossover_env: Tuple[Optional[str], float] = (None, _INF)


def _vec_min() -> int:
    env = os.environ.get("REPRO_ROUND_VEC_MIN")
    return int(env) if env else VEC_MIN_NJ


def round_crossover() -> float:
    """NJ above which ``REPRO_ROUND_KERNEL=auto`` rides the device round.

    Resolution order: ``REPRO_ROUND_CROSSOVER`` env (a number, or
    ``inf``), else the value installed by :func:`set_round_crossover`,
    else +inf: no crossover is installed by default, so "auto" stays on
    the Python round.

    When the resolved value is INF, ``simulate_soa`` drops the device
    branch from its per-round dispatch entirely (``jax_on`` below):
    ``auto`` is then end-to-end identical to ``round_kernel="python"``
    and never calls the device round (pinned by
    ``tests/test_torch_round.py``)."""
    global _crossover_env
    env = os.environ.get("REPRO_ROUND_CROSSOVER")
    if env:
        raw, val = _crossover_env
        if raw != env:
            val = float(env)
            _crossover_env = (env, val)
        return val
    if _round_crossover is not None:
        return _round_crossover
    return _INF


def set_round_crossover(nj: Optional[float]) -> None:
    """Install a measured python->jax crossover depth (None clears)."""
    global _round_crossover
    _round_crossover = None if nj is None else float(nj)


_SJ = None  # lazily imported repro_torch.core.scheduler_torch (the device round)


def _jax_mod():
    """Lazy import of the device round's module, ``scheduler_torch``."""
    global _SJ
    if _SJ is None:
        from repro_torch.core import scheduler_torch

        _SJ = scheduler_torch
    return _SJ


def supports_scheduler(scheduler: Scheduler) -> bool:
    return type(scheduler) in _SUPPORTED


# ------------------------------------------------------------ ready set ----


class _ReadyBlock:
    """Indexed structure-of-arrays ready set.

    Parallel per-slot fields; removal swaps the last slot in (O(1)).
    ``min_rem_arr`` / ``dl_eps_arr`` mirror the drop-test operands as
    ndarrays so the early-drop test is a single masked compare over the
    block; ``guard`` is a conservative scalar bound (min over slots of
    the approximate drop threshold, minus a 1e-9 safety margin that
    dwarfs the ~1e-15 re-association error) below which no slot can
    possibly drop — the exact vectorized compare runs only when ``now``
    crosses it.
    """

    __slots__ = (
        "n", "cap", "req", "rid", "model", "layer", "dl", "mr",
        "lat", "latv", "vdl", "vdl_next", "next_min", "fkey", "ekey", "pref",
        "min_rem_arr", "dl_eps_arr", "guard_arr", "guard",
        # deep mirrors (None until a deep round activates them; from then
        # on maintained incrementally by push/_fill_vdl/swap_remove only)
        "deep", "rid_arr", "dl_arr", "vdl_arr", "vdl_next_arr",
        "next_min_arr", "lat_arr", "latv_arr", "okey", "order_sl", "rid2slot",
    )

    def __init__(self, cap: int = 64):
        self.n = 0
        self.cap = cap
        self.req: List[Optional[Request]] = [None] * cap
        self.rid = [0] * cap
        self.model = [0] * cap
        self.layer = [0] * cap
        self.dl = [0.0] * cap
        self.mr = [0.0] * cap
        self.lat: List[Optional[Tuple[float, ...]]] = [None] * cap
        self.latv: List[Optional[Tuple[float, ...]]] = [None] * cap
        self.vdl = [0.0] * cap
        self.vdl_next = [0.0] * cap
        self.next_min = [0.0] * cap
        self.fkey: List = [None] * cap  # (arrival, rid) — FCFS order
        self.ekey: List = [None] * cap  # (edf deadline, rid) — EDF order
        self.pref: List = [None] * cap  # per-layer accelerator preference
        self.min_rem_arr = np.zeros(cap)
        self.dl_eps_arr = np.zeros(cap)
        self.guard_arr = np.zeros(cap)
        self.guard = _INF
        self.deep = False
        self.rid_arr = None  # [cap] int64 (terastal/dream vec kernels)
        self.dl_arr = None  # [cap] (dream vec order)
        self.vdl_arr = None  # [cap] (terastal vec/jax rounds)
        self.vdl_next_arr = None
        self.next_min_arr = None
        self.lat_arr = None  # [cap, n_acc]
        self.latv_arr = None  # [cap, n_acc]; +inf rows where no variant
        self.okey = None  # the fkey/ekey list the sorted order is keyed on
        self.order_sl = None  # incrementally sorted key list (FCFS/EDF)
        self.rid2slot = None  # rid -> live slot (FCFS/EDF deep walk)

    def clone(self) -> "_ReadyBlock":
        """Deep copy of the live state — benchmark/test helper, so round
        kernels can be re-run and timed on captured mid-trial states."""
        C = _ReadyBlock(self.cap)
        for name in ("req", "rid", "model", "layer", "dl", "mr", "lat",
                     "latv", "vdl", "vdl_next", "next_min", "fkey", "ekey",
                     "pref"):
            setattr(C, name, list(getattr(self, name)))
        for name in ("min_rem_arr", "dl_eps_arr", "guard_arr"):
            setattr(C, name, getattr(self, name).copy())
        C.n = self.n
        C.guard = self.guard
        C.deep = self.deep
        for name in ("rid_arr", "dl_arr", "vdl_arr", "vdl_next_arr",
                     "next_min_arr", "lat_arr", "latv_arr"):
            arr = getattr(self, name)
            if arr is not None:
                setattr(C, name, arr.copy())
        if self.order_sl is not None:
            C.order_sl = list(self.order_sl)
            C.rid2slot = dict(self.rid2slot)
            C.okey = C.fkey if self.okey is self.fkey else C.ekey
        return C

    # -- deep-mirror activation (once per trial, on the first deep round) --

    def activate_deep_terastal(self, n_acc: int) -> None:
        cap, nb = self.cap, self.n
        self.rid_arr = np.empty(cap, np.int64)
        self.rid_arr[:nb] = self.rid[:nb]
        self.vdl_arr = np.empty(cap)
        self.vdl_arr[:nb] = self.vdl[:nb]
        self.vdl_next_arr = np.empty(cap)
        self.vdl_next_arr[:nb] = self.vdl_next[:nb]
        self.next_min_arr = np.empty(cap)
        self.next_min_arr[:nb] = self.next_min[:nb]
        # transposed [n_acc, cap]: the vectorized round reads whole
        # accelerator columns, which this layout keeps contiguous
        self.lat_arr = np.empty((n_acc, cap))
        self.latv_arr = np.empty((n_acc, cap))
        for i in range(nb):
            self.lat_arr[:, i] = self.lat[i]
            rv = self.latv[i]
            self.latv_arr[:, i] = rv if rv is not None else np.inf
        self.deep = True

    def activate_deep_dream(self) -> None:
        cap, nb = self.cap, self.n
        self.rid_arr = np.empty(cap, np.int64)
        self.rid_arr[:nb] = self.rid[:nb]
        self.dl_arr = np.empty(cap)
        self.dl_arr[:nb] = self.dl[:nb]
        self.deep = True

    def activate_deep_pref(self, use_fkey: bool) -> None:
        nb = self.n
        self.okey = self.fkey if use_fkey else self.ekey
        self.order_sl = sorted(self.okey[:nb])
        self.rid2slot = {self.rid[i]: i for i in range(nb)}
        self.deep = True

    def grow(self) -> None:
        pad = self.cap
        self.cap *= 2
        for name in ("req", "lat", "latv", "fkey", "ekey", "pref"):
            getattr(self, name).extend([None] * pad)
        for name in ("rid", "model", "layer", "dl", "mr", "vdl", "vdl_next", "next_min"):
            getattr(self, name).extend([0] * pad)
        self.min_rem_arr = np.concatenate([self.min_rem_arr, np.zeros(pad)])
        self.dl_eps_arr = np.concatenate([self.dl_eps_arr, np.zeros(pad)])
        self.guard_arr = np.concatenate([self.guard_arr, np.zeros(pad)])
        if self.rid_arr is not None:
            self.rid_arr = np.concatenate([self.rid_arr, np.empty(pad, np.int64)])
        for name in ("dl_arr", "vdl_arr", "vdl_next_arr", "next_min_arr"):
            arr = getattr(self, name)
            if arr is not None:
                setattr(self, name, np.concatenate([arr, np.empty(pad)]))
        for name in ("lat_arr", "latv_arr"):
            arr = getattr(self, name)
            if arr is not None:
                setattr(
                    self, name,
                    np.concatenate([arr, np.empty((arr.shape[0], pad))], axis=1),
                )
        # okey aliases fkey/ekey, which extend() above grew in place.

    def swap_remove(self, i: int) -> None:
        n1 = self.n - 1
        if self.deep:
            sl = self.order_sl
            if sl is not None:
                del sl[bisect_left(sl, self.okey[i])]
                del self.rid2slot[self.rid[i]]
                if i != n1:
                    self.rid2slot[self.rid[n1]] = i
            elif i != n1:
                self.rid_arr[i] = self.rid_arr[n1]
                la = self.lat_arr
                if la is not None:
                    la[:, i] = la[:, n1]
                    self.latv_arr[:, i] = self.latv_arr[:, n1]
                    self.vdl_arr[i] = self.vdl_arr[n1]
                    self.vdl_next_arr[i] = self.vdl_next_arr[n1]
                    self.next_min_arr[i] = self.next_min_arr[n1]
                else:
                    self.dl_arr[i] = self.dl_arr[n1]
        if i != n1:
            self.req[i] = self.req[n1]
            self.rid[i] = self.rid[n1]
            self.model[i] = self.model[n1]
            self.layer[i] = self.layer[n1]
            self.dl[i] = self.dl[n1]
            self.mr[i] = self.mr[n1]
            self.lat[i] = self.lat[n1]
            self.latv[i] = self.latv[n1]
            self.vdl[i] = self.vdl[n1]
            self.vdl_next[i] = self.vdl_next[n1]
            self.next_min[i] = self.next_min[n1]
            self.fkey[i] = self.fkey[n1]
            self.ekey[i] = self.ekey[n1]
            self.pref[i] = self.pref[n1]
            self.min_rem_arr[i] = self.min_rem_arr[n1]
            self.dl_eps_arr[i] = self.dl_eps_arr[n1]
            self.guard_arr[i] = self.guard_arr[n1]
        self.req[n1] = None  # release the reference
        self.n = n1
        # self.guard is left stale-low on removal; the drop path recomputes
        # it after every exact check, so staleness only costs a re-check.


# -------------------------------------------------------------- kernels ----
#
# Each kernel mirrors one Scheduler.schedule() implementation over the
# ready block, returning [(slot, acc, use_variant, latency)] in the exact
# order the reference emits assignments (the engine assigns finish-event
# push counters in that order, which fixes how simultaneous finishes tie-
# break for the rest of the run).  All comparisons/arithmetic reproduce
# the reference expressions operation-for-operation — see the inline
# notes where an algebraic shortcut is exact (first-min scans, shared
# ef_all/f0 minima, precomputed preference orders).


def _order_by(keys, n: int):
    if n == 1:
        return _ONE
    if n == 2:
        return (0, 1) if keys[0] <= keys[1] else (1, 0)
    return sorted(range(n), key=keys.__getitem__)


def _assign_pref(B: _ReadyBlock, order, idle_mask: int, n_idle: int):
    """Shared FCFS/EDF body: walk the order, place each layer on the
    first idle accelerator in its precomputed preference order (exactly
    ``min(idle, key=latency)`` — static floats, stable argsort)."""
    out = []
    for i in order:
        if not n_idle:
            break
        for k in B.pref[i]:
            if idle_mask >> k & 1:
                out.append((i, k, False, B.lat[i][k]))
                idle_mask &= ~(1 << k)
                n_idle -= 1
                break
    return out


def _kern_fcfs(B, now, busy, idle_mask, n_idle):
    return _assign_pref(B, _order_by(B.fkey, B.n), idle_mask, n_idle)


def _kern_edf(B, now, busy, idle_mask, n_idle):
    return _assign_pref(B, _order_by(B.ekey, B.n), idle_mask, n_idle)


def _dream_assign(B, order, now, busy, idle_mask, n_idle):
    # DREAM maps by earliest estimated finish with ROUND-START tau (busy
    # never changes inside a round); first minimum wins, ascending order
    lat = B.lat
    nacc = len(busy)
    out = []
    for i in order:
        if not n_idle:
            break
        row = lat[i]
        bk = -1
        bc = 0.0
        for k in range(nacc):
            if idle_mask >> k & 1:
                b = busy[k]
                f = (b if b > now else now) + row[k]
                if bk < 0 or f < bc:
                    bc, bk = f, k
        out.append((i, bk, False, row[bk]))
        idle_mask &= ~(1 << bk)
        n_idle -= 1
    return out


def _kern_dream(B, now, busy, idle_mask, n_idle):
    n = B.n
    if n == 1:
        order = _ONE
    else:
        # reference: slack = deadline_abs - now - crit_from (left-assoc);
        # the layer id totalizes ties among DAG sibling entries
        dl, mr, rid, layer = B.dl, B.mr, B.rid, B.layer
        keys = [((dl[i] - now) - mr[i], rid[i], layer[i]) for i in range(n)]
        order = _order_by(keys, n)
    return _dream_assign(B, order, now, busy, idle_mask, n_idle)


def _kern_dream_deep(B, now, busy, idle_mask, n_idle):
    """DREAM round over the deep mirrors: the slack keys are the same
    left-associated ``(dl - now) - mr`` floats computed as one vector op,
    and ``lexsort((rid, keys))`` is exactly ``sorted(key=(slack, rid))``;
    the assignment walk (<= n_idle entries) is shared with the scalar
    kernel.  The walk can stay scalar because DREAM always places every
    entry it visits, so its cost is bounded by n_idle, not NJ."""
    n = B.n
    keys = (B.dl_arr[:n] - now) - B.min_rem_arr[:n]
    order = np.lexsort((B.rid_arr[:n], keys))
    return _dream_assign(B, [int(i) for i in order[: n_idle]], now, busy,
                         idle_mask, n_idle)


def _kern_pref_deep(B, idle_mask, n_idle):
    """FCFS/EDF round over the incrementally sorted ready order: the
    shared ``_assign_pref`` walk on a lazily resolved slot order —
    nothing is re-sorted, the order was maintained at push/remove time,
    and only the entries the walk actually visits are resolved.  Exact
    at every depth: the sort keys (``fkey``/``ekey``) are static per
    slot, so the incremental order IS the per-round sorted order."""
    rid2slot = B.rid2slot
    return _assign_pref(
        B, (rid2slot[key[1]] for key in B.order_sl), idle_mask, n_idle
    )


def _solo_terastal(row, rv, vdl, vdl_next, next_min, now, busy, idle_mask, n_acc, mode):
    """Terastal round for a single ready layer, operating on scalars only
    (no block traffic).  Mirrors ``_kern_terastal`` at n == 1 — the
    differential tests pin the two paths against the reference together.
    Returns ``(acc, use_variant, latency)`` or ``None``."""
    d = vdl + 1e-15
    rng = range(n_acc)
    # ---- stage 1: original, then variant, on an idle acc meeting d_v ----
    bk = -1
    bf = 0.0
    for k in rng:
        if idle_mask >> k & 1:
            b = busy[k]
            f = (b if b > now else now) + row[k]
            if f <= d and (bk < 0 or f < bf):
                bf, bk = f, k
    if bk >= 0:
        return bk, False, row[bk]
    if rv is not None:
        for k in rng:
            if idle_mask >> k & 1:
                b = busy[k]
                f = (b if b > now else now) + rv[k]
                if f <= d and (bk < 0 or f < bf):
                    bf, bk = f, k
        if bk >= 0:
            return bk, True, rv[bk]
    # ---- stage 2: first idle acc (ascending) with an allowed backfill ----
    # tau is constant until the first assignment, which ends the round, so
    # f0 / s_star / ef_all are loop invariants here.
    b = busy[0]
    f0 = (b if b > now else now) + row[0]
    for k in range(1, n_acc):
        b = busy[k]
        f = (b if b > now else now) + row[k]
        if f < f0:
            f0 = f
    s_star = vdl - f0
    ea = None  # variant ef_all, computed lazily
    for k in rng:
        if not (idle_mask >> k & 1):
            continue
        b = busy[k]
        tk = b if b > now else now
        best_d = None
        best_v = False
        best_c = 0.0
        c = row[k]
        finish = tk + c
        if mode != "ef" or finish <= f0 + 1e-15:
            best_d = (vdl_next - finish - next_min) - s_star
            best_c = c
        if rv is not None:
            cv = rv[k]
            fv = tk + cv
            ok = True
            if mode == "ef":
                if ea is None:
                    b = busy[0]
                    ea = (b if b > now else now) + rv[0]
                    for kk in range(1, n_acc):
                        b = busy[kk]
                        f = (b if b > now else now) + rv[kk]
                        if f < ea:
                            ea = f
                ok = fv <= ea + 1e-15
            if ok:
                dv = (vdl_next - fv - next_min) - s_star
                # (delta, -use_var) strictly-greater: var never wins ties
                if best_d is None or dv > best_d:
                    best_d, best_v, best_c = dv, True, cv
        if best_d is None:
            continue
        if mode == "positive" and best_d <= 0.0:
            continue
        return k, best_v, best_c
    return None


def _kern_terastal(B, now, busy, idle_mask, n_idle, mode):
    n = B.n
    rid, lat, latv, vdl = B.rid, B.lat, B.latv, B.vdl
    nacc = len(busy)
    tau = [b if b > now else now for b in busy]
    idle = [k for k in range(nacc) if idle_mask >> k & 1]

    if n == 1:
        order = _ONE  # the sort key (best-case slack) is order-irrelevant
    else:
        # stage-1 ordering: best-case slack at round-start tau (Eq. 6-7);
        # the layer id totalizes ties among DAG sibling entries
        layer = B.layer
        keys = []
        for i in range(n):
            row = lat[i]
            f = tau[0] + row[0]
            for k in range(1, nacc):
                v = tau[k] + row[k]
                if v < f:
                    f = v
            keys.append((vdl[i] - f, rid[i], layer[i]))
        order = _order_by(keys, n)

    out = []
    remaining: List[int] = []
    for i in order:
        d = vdl[i] + 1e-15
        row = lat[i]
        # original on an idle accelerator meeting d_v (lines 4-10);
        # strict < keeps min()'s first-minimum over ascending idle order
        bk = -1
        bf = 0.0
        for k in idle:
            f = tau[k] + row[k]
            if f <= d and (bk < 0 or f < bf):
                bf, bk = f, k
        if bk >= 0:
            c = row[bk]
            out.append((i, bk, False, c))
            idle.remove(bk)
            tau[bk] += c  # round-local update (Sec. IV-C)
            continue
        rv = latv[i]  # non-None iff LayerVariantFeasible held at push time
        if rv is not None:
            bk = -1
            for k in idle:
                f = tau[k] + rv[k]
                if f <= d and (bk < 0 or f < bf):
                    bf, bk = f, k
            if bk >= 0:
                c = rv[bk]
                out.append((i, bk, True, c))
                idle.remove(bk)
                tau[bk] += c
                continue
        remaining.append(i)

    # stage 2: backfill remaining idle accelerators (lines 19-23)
    if remaining and idle:
        vdl_next, next_min = B.vdl_next, B.next_min
        for k in list(idle):
            if not remaining:
                break
            tk = tau[k]
            best_d = None
            best_r = 0
            best_i = -1
            best_v = False
            best_c = 0.0
            for i in remaining:
                row = lat[i]
                # s* with CURRENT tau (the reference recomputes per probe)
                f0 = tau[0] + row[0]
                for kk in range(1, nacc):
                    v = tau[kk] + row[kk]
                    if v < f0:
                        f0 = v
                s_star = vdl[i] - f0
                vn = vdl_next[i]
                nm = next_min[i]
                # use_var=False; ef_all of the original row IS f0
                c = row[k]
                finish = tk + c
                if mode != "ef" or finish <= f0 + 1e-15:
                    delta = (vn - finish - nm) - s_star  # Eq. 8-9
                    if best_d is None or delta > best_d or (delta == best_d and 0 > best_r):
                        best_d, best_r, best_i, best_v, best_c = delta, 0, i, False, c
                rv = latv[i]
                if rv is not None:
                    c = rv[k]
                    finish = tk + c
                    ok = True
                    if mode == "ef":
                        ea = tau[0] + rv[0]
                        for kk in range(1, nacc):
                            v = tau[kk] + rv[kk]
                            if v < ea:
                                ea = v
                        ok = finish <= ea + 1e-15
                    if ok:
                        delta = (vn - finish - nm) - s_star
                        # strictly-greater (delta, -use_var) replacement
                        if best_d is None or delta > best_d or (delta == best_d and -1 > best_r):
                            best_d, best_r, best_i, best_v, best_c = delta, -1, i, True, c
            if best_i < 0:
                continue
            if mode == "positive" and best_d <= 0.0:
                continue
            out.append((best_i, k, best_v, best_c))
            tau[k] += best_c
            remaining.remove(best_i)
    return out


def _pick_first(mask, keys, rid):
    """Index of the (keys, rid)-lexicographic minimum among ``mask`` —
    the first slot a walk over ``sorted(key=(keys[i], rid[i]))`` order
    would visit with ``mask`` true, or -1 if none is.  float key ties
    resolve through the exact rid comparison, so this equals the
    reference's stable sort without ever building the sort."""
    mk = np.where(mask, keys, _INF)
    i = int(mk.argmin())
    m = mk[i]
    if m == _INF:
        return -1
    eq = mk == m
    if np.count_nonzero(eq) > 1:
        return int(min(np.flatnonzero(eq), key=rid.__getitem__))
    return i


def _kern_terastal_vec(B, now, busy, idle_mask, n_idle, mode):
    """Vectorized Terastal round over the deep block mirrors.

    Bit-identical to ``_kern_terastal`` (pinned at every pow2 bucket
    boundary by ``tests/test_round_kernels.py``): every add/sub/compare
    is the same IEEE-f64 op, reductions are exact (min/max/compare
    introduce no rounding), and all tie-breaks reproduce the reference's
    first-minimum scans and strictly-greater replacement scans exactly
    (see ``_pick_first`` and the stage-2 tie handling).

    The round never materializes the stage-1 sort.  Key facts it leans
    on, each inherited from the reference semantics:

    * stage-1 feasibility of a slot on a still-idle accelerator is
      STATIC across the round — tau of an idle accelerator only changes
      when it gets assigned, which also removes it from ``idle`` — so
      per-accelerator finish columns are computed once;
    * feasibility only shrinks as ``idle`` shrinks, so "walk the sorted
      order forward, assign the first feasible slot" is exactly "pick
      the (slack, rid)-minimum feasible slot, repeat" — a masked argmin
      per assignment (<= n_idle of them) instead of an O(NJ log NJ)
      sort + O(NJ) walk;
    * stage-2 deltas are masked vector arithmetic over all remaining
      slots per idle accelerator, with the reference's replacement-scan
      tie-break (max delta, original beats variant, then earliest in
      stage-1 order == (slack, rid)-minimum among the tied).

    The dominant deep round (one freed accelerator, one assignment —
    >95% under saturation) therefore costs ~15 contiguous [NJ] vector
    ops, independent of how deep the queue is beyond them."""
    n = B.n
    nacc = len(busy)
    lat = B.lat_arr
    latv = B.latv_arr
    vdl = B.vdl_arr[:n]
    rid = B.rid
    tau = [b if b > now else now for b in busy]

    # per-accelerator finish columns at round-start tau; fmin/keys = the
    # stage-1 best-case slack (Eq. 6-7), shared with stage-2 tie-breaks
    fo = [lat[k, :n] + tau[k] for k in range(nacc)]
    fmin = np.minimum(fo[0], fo[1]) if nacc > 1 else fo[0]
    for k in range(2, nacc):
        fmin = np.minimum(fmin, fo[k])
    keys = vdl - fmin
    d_eps = vdl + 1e-15
    idle = [k for k in range(nacc) if idle_mask >> k & 1]
    oko = [fo[k] <= d_eps for k in idle]
    fv = [latv[k, :n] + tau[k] for k in idle]
    okv = [f <= d_eps for f in fv]  # +inf rows (no variant) fail naturally

    out = []
    alive = None  # "unassigned" mask, materialized on first assignment

    # ---- stage 1: most-urgent-first, meet virtual deadlines ------------
    while idle:
        feas = oko[0] | okv[0]
        for j in range(1, len(idle)):
            feas |= oko[j]
            feas |= okv[j]
        if alive is not None:
            feas &= alive
        i = _pick_first(feas, keys, rid)
        if i < 0:
            break
        # original first (lines 4-10), then variant (11-18); candidate
        # accelerator = first-minimum finish over ascending idle order
        bk = -1
        bj = -1
        bf = 0.0
        for j, k in enumerate(idle):
            if oko[j][i]:
                f = fo[k][i]
                if bk < 0 or f < bf:
                    bf, bk, bj = f, k, j
        if bk >= 0:
            use_var = False
            c = B.lat[i][bk]  # Python float, as the scalar kernel emits
        else:
            for j, k in enumerate(idle):
                if okv[j][i]:
                    f = fv[j][i]
                    if bk < 0 or f < bf:
                        bf, bk, bj = f, k, j
            use_var = True
            c = B.latv[i][bk]
        out.append((i, bk, use_var, c))
        tau[bk] += c  # round-local update (Sec. IV-C); bk leaves idle,
        del idle[bj], oko[bj], fv[bj], okv[bj]  # surviving columns exact
        if alive is None:
            alive = np.ones(n, bool)
        alive[i] = False

    # ---- stage 2: backfill remaining idle accelerators -----------------
    if idle and len(out) < n:
        if alive is None:
            alive = np.ones(n, bool)
        vn = B.vdl_next_arr[:n]
        nm = B.next_min_arr[:n]
        f0 = None  # min finish over ALL accs at CURRENT tau (lazy/cached,
        ev = None  # like the variant-row ev; both invalidate on assignment)
        for k in idle:
            if len(out) == n:
                break
            if f0 is None:
                f0 = lat[0, :n] + tau[0]
                for kk in range(1, nacc):
                    f0 = np.minimum(f0, lat[kk, :n] + tau[kk])
                s_star = vdl - f0
            tk = tau[k]
            fino = lat[k, :n] + tk
            t = vn - fino
            t -= nm
            t -= s_star  # Eq. 8-9: ((vn - finish) - nm) - s*, left-assoc
            if mode == "ef":
                # ef_all of the original row IS f0; variant rows guard
                # against their own earliest finish across ALL accs
                ok = fino <= f0 + 1e-15
                ok &= alive
            else:
                ok = alive
            do = np.where(ok, t, _NEGINF)
            cv = latv[k, :n]
            finv = cv + tk  # +inf where no variant -> delta = -inf below
            t2 = vn - finv
            t2 -= nm
            t2 -= s_star
            if mode == "ef":
                if ev is None:
                    ev = latv[0, :n] + tau[0]
                    for kk in range(1, nacc):
                        ev = np.minimum(ev, latv[kk, :n] + tau[kk])
                ok2 = finv <= ev + 1e-15
                ok2 &= np.isfinite(cv)
            else:
                ok2 = np.isfinite(cv)
            ok2 &= alive
            dv = np.where(ok2, t2, _NEGINF)
            mo = do.max()
            mv = dv.max()
            best = mo if mo >= mv else mv
            if best == _NEGINF:
                continue
            if mode == "positive" and best <= 0.0:
                continue
            # winner: max delta; ties prefer original over variant (the
            # strictly-greater (delta, -use_var) replacement), then the
            # earliest slot in stage-1 order among the tied
            if mo >= mv:
                d_sel = do
                use_var = False
            else:
                d_sel = dv
                use_var = True
            idxs = np.flatnonzero(d_sel == best)
            if len(idxs) == 1:
                i = int(idxs[0])
            else:
                i = int(min(idxs, key=lambda j: (keys[j], rid[j])))
            c = B.latv[i][k] if use_var else B.lat[i][k]
            out.append((i, k, use_var, c))
            tau[k] += c
            f0 = ev = None  # tau changed: recompute s*/ev for the next acc
            alive[i] = False
    return out


def _jax_round(B, now, busy, idle_mask, n_acc, mode, device=None):
    """One Terastal round on the device (``REPRO_ROUND_KERNEL=jax`` or
    NJ past the calibrated crossover), on ``device`` (the card when
    None): stage the deep mirrors into ``pack_arrays``'s persistent
    bucket buffers in ascending-rid order (stable argsort ties ==
    (slack, rid)), run ``terastal_round``, and fetch all three outputs
    in one device sync.  ``assign_seq`` restores
    the reference emission order, which fixes how simultaneous finish
    events tie-break downstream."""
    SJ = _jax_mod()
    n = B.n
    perm = np.argsort(B.rid_arr[:n])
    tau = np.array([b if b > now else now for b in busy])
    idle = np.array([bool(idle_mask >> k & 1) for k in range(n_acc)])
    inp = SJ.pack_arrays(
        B.vdl_arr[:n][perm],
        B.vdl_next_arr[:n][perm],
        B.next_min_arr[:n][perm],
        B.lat_arr[:, :n].T[perm],  # mirrors are [n_acc, cap]; pack [NJ, NA]
        B.latv_arr[:, :n].T[perm],
        tau,
        idle,
        device=device,
    )
    o = SJ.terastal_round(inp, mode=mode)
    acc, var, seq = SJ.device_get(o)
    acc = acc[:n]
    hit = np.flatnonzero(acc >= 0)
    if not hit.size:
        return []
    emit = hit[np.argsort(seq[:n][hit])]
    out = []
    for i in emit:
        slot = int(perm[i])
        k = int(acc[i])
        uv = bool(var[i])
        row = B.latv[slot] if uv else B.lat[slot]
        out.append((slot, k, uv, row[k]))
    return out


# --------------------------------------------------------------- engine ----

_ARRIVAL, _FINISH, _TICK, _FAULT = 0, 1, 2, 3  # reference kind codes


def simulate_soa(
    plans: Sequence[ModelPlan],
    tasks: Sequence[TaskSpec],
    duration: float,
    scheduler: Scheduler,
    seed: int,
    processes: Optional[Sequence[Optional[ArrivalProcess]]],
    policy: BudgetPolicy,
    round_kernel: Optional[str] = None,
    admission: Optional[AdmissionPolicy] = None,
    fault_model: Optional[FaultModel] = None,
    device=None,
) -> SimResult:
    """SoA counterpart of ``_simulate_reference`` (same contract).

    ``round_kernel`` selects the Terastal round implementation for deep
    ready queues (see :data:`ROUND_KERNELS`); ``None`` falls back to the
    ``REPRO_ROUND_KERNEL`` environment variable, then ``"auto"``.
    ``device`` is where the device round runs (the card when None;
    ``device="cpu"`` runs it on the host).

    An active ``fault_model`` forces the scalar kernels (the deep
    mirrors, the vectorized round, and the jitted round cache per-slot
    latency rows that every capability event would have to rewrite
    wholesale — even an explicit ``round_kernel="jax"`` is downgraded,
    which is bit-identical by construction, just not deep).  Fault
    events swap the hot plan tables for ``effective_plans`` copies and
    rewrite the live slot caches, so scheduling decisions match the
    reference loop float for float."""
    n_acc = plans[0].platform.n_acc
    n_plans = len(plans)
    rng_acc = range(n_acc)
    all_idle_mask = (1 << n_acc) - 1

    kind = type(scheduler)
    terastal = kind is TerastalScheduler
    if terastal:
        use_budgets = scheduler.use_budgets
        use_variants = scheduler.use_variants
        mode = scheduler.backfill_mode
        kern = kern_deep = None
    else:
        use_budgets = use_variants = False
        mode = ""
        kern = {FcfsScheduler: _kern_fcfs, EdfScheduler: _kern_edf,
                DreamScheduler: _kern_dream}[kind]
        kern_deep = _kern_dream_deep if kind is DreamScheduler else None
    need_fkey = kind is FcfsScheduler  # push-time sort keys are per-family
    need_ekey = kind is EdfScheduler
    need_pref = need_fkey or need_ekey
    policy_inert = type(policy) in _INERT_POLICIES

    # ---- round-kernel dispatch thresholds (deep-queue fast path) --------
    # "auto" (the TrialSpec default) defers to the env var, mirroring how
    # REPRO_SIM_ENGINE reaches campaign trials; an explicit python/jax
    # argument always wins.
    rk = round_kernel
    if rk is None or rk == "auto":
        rk = os.environ.get("REPRO_ROUND_KERNEL") or "auto"
    if rk not in ROUND_KERNELS:
        raise ValueError(f"unknown round kernel {rk!r} (have {ROUND_KERNELS})")
    vec_min = _vec_min()
    if terastal:
        if rk == "jax":
            jax_min = 1.0  # force the jitted round for every block round
        elif rk == "python":
            jax_min = _INF
        else:
            jax_min = round_crossover()
        deep_min = jax_min if jax_min < vec_min else vec_min
    else:
        jax_min = _INF
        deep_min = vec_min
    # crossover-INF fast path: with no finite crossover the jitted round
    # can never engage, so "auto" skips the per-round jax probe entirely
    # and is end-to-end identical to round_kernel="python" (never even
    # imports scheduler_jax — pinned by tests/test_round_kernels.py)
    jax_on = jax_min != _INF

    # hot per-plan scalar tables (cached on the plans, shared across trials)
    LAT = [p.lat_rows for p in plans]
    LATV = [p.lat_var_rows for p in plans]
    RM = [p.remaining_min_list for p in plans]
    CF = [p.crit_from_list for p in plans]  # == RM[:-1] slice on linear
    CA = [p.crit_after_list for p in plans]  # == RM[1:] slice on linear
    VDLR = [p.vdl_rel_list for p in plans]
    MINL = [p.min_lat_list for p in plans]
    SVOK = [p.single_variant_ok for p in plans]
    PREF = [p.acc_pref_rows for p in plans]
    NL = [len(p.model.layers) for p in plans]
    DEADLINE = [p.deadline for p in plans]
    LAT_NP = [p.lat for p in plans]  # ndarray rows for the deep mirrors
    LATV_NP = [p.lat_var for p in plans]

    # ---- DAG axis (``repro_torch.core.dag``) ----------------------------------
    # A DAG plan splits one logical request over sibling ready entries
    # (one per precedence-unblocked node) sharing a ``DagRun``.  The deep
    # mirrors, the vectorized round, and the jitted round are disabled
    # for the trial (their rid-keyed sort ties and per-slot drop masks
    # assume one entry per request) — the scalar kernels carry DAG sort
    # keys totalized with the node id, matching the reference schedulers.
    DAGS = [p.dag for p in plans]
    dag_present = any(d is not None for d in DAGS)

    # ---- fault axis (``repro_torch.core.faults``) -----------------------------
    # Same contract as the reference loop: capability events rebuild the
    # swappable tables above (LAT/LATV/RM/MINL/PREF) from
    # ``effective_plans`` — SVOK/NL/DEADLINE and ``plans`` keep serving
    # combo validity, budget hooks, and ``combo_retained``.  With
    # ``retighten=false`` VDLR and the admission work tables stay frozen
    # at offline values (the original fault axis); ``retighten=true``
    # re-runs the tightening kernel and re-derives the admission tables
    # on every capability event (see ``_fault_refresh``).  The
    # deep/vectorized/jitted fast paths are disabled for the whole trial
    # (their mirrors cache rows a fault event would have to rewrite
    # wholesale).
    fm = fault_model if fault_model is not None and fault_model.active else None
    faulted_spans = 0
    retighten = fm is not None and fm.retighten
    cur_chain: List[Optional[np.ndarray]] = [None] * n_plans
    if fm is not None:
        fault_events, faulted_spans = fm.timeline(n_acc, duration, seed)
        avail = [True] * n_acc
        fscale = [1.0] * n_acc
        cur_fin = [-1] * n_acc  # counter of each acc's valid finish event
        disp_start = [0.0] * n_acc  # in-flight dispatch: start time and the
        disp_w = [0.0] * n_acc  # wall / in-horizon busy amounts credited
        disp_h = [0.0] * n_acc
        run_var = [False] * n_acc  # did the running layer apply a variant
        resume = fm.interrupted == "resume"
        deep_min = _INF
        jax_min = _INF
        jax_on = False
    if dag_present:
        # simulate() gates non-static budget policies off for DAG plans
        # before either engine runs (faults now compose — the fault
        # handlers below are DAG-aware), so only the kernel dispatch
        # needs forcing here
        deep_min = _INF
        jax_min = _INF
        jax_on = False

    # per-model stat accumulators (dict built in reference order at the end)
    released = [0] * n_plans
    completed = [0] * n_plans
    missed = [0] * n_plans
    dropped = [0] * n_plans
    variants_applied = [0] * n_plans
    retained_sum = [0.0] * n_plans
    shed = [0] * n_plans
    in_flight = [0] * n_plans
    evicted = [0] * n_plans
    remapped = [0] * n_plans

    busy = [0.0] * n_acc  # acc_busy_until
    busy_t = [0.0] * n_acc  # acc_busy_time
    busy_h = [0.0] * n_acc  # horizon-clamped busy time

    # admission state — integer-ns backlog exactly as in the reference
    # (integer adds are order-independent, so the two engines' differing
    # within-round drop orders cannot produce divergent backlog values)
    adm = None if admission is None or type(admission) is NoAdmission else admission
    if adm is not None:
        adm.bind(n_acc)
    need_backlog = adm is not None and adm.needs_backlog
    backlog_ns = 0
    min_work_s = [p.crit_total for p in plans]
    work_ns = [int(round(w * 1e9)) for w in min_work_s]

    B = _ReadyBlock()

    # ---- event heap: exactly the reference's (time, counter, kind, pay) --
    # generate_release_events returns a sorted list, which IS a valid heap;
    # the counters 0..n_ev-1 match the reference's push order exactly.
    events, clients = generate_release_events(tasks, duration, seed, processes)
    cl_active = bool(clients)
    if cl_active:
        heap: List[tuple] = [
            (e[0], i, _ARRIVAL, e[1] if e[2] < 0 else (e[1], e[2], e[3]))
            for i, e in enumerate(events)
        ]
        MODEL_OF_TASK = [t.model_idx for t in tasks]
    else:
        heap = [(t, i, _ARRIVAL, m) for i, (t, m) in enumerate(events)]
    cnt = len(heap)
    if fm is not None:
        # capability events enter the heap after all arrivals and before
        # the tick, so same-timestamp ordering (arrival < fault < tick <
        # finish) is fixed by counters identically in both engines
        for fe in fault_events:
            heappush(heap, (fe.t, cnt, _FAULT, fe))
            cnt += 1
    if policy.tick_interval > 0 and heap:
        heappush(heap, (policy.tick_interval, cnt, _TICK, None))
        cnt += 1
    tick_dt = policy.tick_interval

    def push_release(client: Tuple[int, int], t: float) -> None:
        """Closed-loop gate: schedule the user's next release after its
        request left the system at ``t`` (counter parity: both engines
        call this at the same points in the same order)."""
        nonlocal cnt
        t_idx, u = client
        nxt = clients[t_idx].next_release(u, t)
        if nxt is not None:
            heappush(heap, (nxt, cnt, _ARRIVAL, (MODEL_OF_TASK[t_idx], t_idx, u)))
            cnt += 1

    running: List[Optional[Request]] = [None] * n_acc  # acc -> running request
    n_running = 0
    next_rid = 0
    rounds = 0  # scheduling rounds, reported on SimResult.rounds

    def _fill_vdl(n: int, req: Request, m: int, l: int) -> None:
        """Cache a slot's Terastal scalars (single source: tera_scalars)."""
        vdl, vdl_next, nm, rv = tera_scalars(req, m, l, RM[m])
        B.vdl[n] = vdl
        B.vdl_next[n] = vdl_next
        B.next_min[n] = nm
        B.latv[n] = rv
        if B.deep:
            B.vdl_arr[n] = vdl
            B.vdl_next_arr[n] = vdl_next
            B.next_min_arr[n] = nm
            B.latv_arr[:, n] = LATV_NP[m][l] if rv is not None else np.inf

    def push(req: Request) -> None:
        """Enter the ready set: cache every per-slot scalar the kernels
        and the vectorized drop read (constant while the slot lives)."""
        n = B.n
        if n == B.cap:
            B.grow()
        m = req.model_idx
        l = req.next_layer
        dl = req.deadline_abs
        rid = req.rid
        B.req[n] = req
        B.rid[n] = rid
        B.model[n] = m
        B.layer[n] = l
        B.dl[n] = dl
        mr = CF[m][l]
        B.mr[n] = mr
        dle = dl + 1e-12
        B.min_rem_arr[n] = mr
        B.dl_eps_arr[n] = dle
        g = dle - mr
        B.guard_arr[n] = g
        if g < B.guard:
            B.guard = g
        B.lat[n] = LAT[m][l]
        if need_pref:
            B.pref[n] = PREF[m][l]
            # keys carry the node id third: a no-op while rids are unique
            # (linear chains), a total order for DAG sibling entries —
            # mirrors the reference schedulers' (key, rid, next_layer)
            if need_fkey:
                B.fkey[n] = (req.arrival, rid, l)
            else:
                B.ekey[n] = (dl - CA[m][l], rid, l)
            if B.deep:
                insort(B.order_sl, B.okey[n])
                B.rid2slot[rid] = n
        elif terastal:
            if B.deep:
                B.rid_arr[n] = rid
                B.lat_arr[:, n] = LAT_NP[m][l]
            _fill_vdl(n, req, m, l)
        elif B.deep:  # DREAM
            B.rid_arr[n] = rid
            B.dl_arr[n] = dl
        B.n = n + 1

    def tera_scalars(req, m, l, rm):
        """(vdl, vdl_next, next_min, variant_row) for one ready layer —
        the single source of the Terastal per-slot derivation, consumed
        by the block cache (via ``_fill_vdl``), the solo fast path, and
        the fused chain loop (mirrors ``TerastalScheduler.vdl`` +
        ``_variant_ok`` exactly)."""
        dl = req.deadline_abs
        dg = DAGS[m]
        if dg is not None:
            # DAG node: virtual deadline of node l, then Eq. 8's binding
            # successor s* = first-min over succs of vdl(s) - min_lat(s)
            # (finish-independent, so the pair caches per slot) — mirrors
            # ``scheduler.binding_successor`` float for float
            va = req.vdl_abs
            if use_budgets:
                if va is not None:
                    vdl = float(va[l])
                else:
                    vdl = req.arrival + VDLR[m][l]
            else:
                vdl = dl - CA[m][l]
            minl = MINL[m]
            best = -1
            bv = 0.0
            for s in dg.succs[l]:
                if use_budgets:
                    vs = float(va[s]) if va is not None else req.arrival + VDLR[m][s]
                else:
                    vs = dl - CA[m][s]
                v = vs - minl[s]
                if best < 0 or v < bv:
                    bv, best = v, s
            if best >= 0:
                if use_budgets:
                    vdl_next = (
                        float(va[best]) if va is not None
                        else req.arrival + VDLR[m][best]
                    )
                else:
                    vdl_next = dl - CA[m][best]
                nm = minl[best]
            else:  # sink: s_f = deadline - finish (the - 0.0 is exact)
                vdl_next = dl
                nm = 0.0
            lv = LATV[m][l]
            rv = None
            if lv is not None and use_variants:
                ap = req.applied_variants
                if SVOK[m][l] if not ap else plans[m].is_valid_combo(ap | {l}):
                    rv = lv
            return vdl, vdl_next, nm, rv
        if use_budgets:
            va = req.vdl_abs
            if va is not None:
                vdl = float(va[l])
            else:
                vdl = req.arrival + VDLR[m][l]
        else:
            vdl = dl - rm[l + 1]
        if l + 1 < NL[m]:
            if use_budgets:
                va = req.vdl_abs
                if va is not None:
                    vdl_next = float(va[l + 1])
                else:
                    vdl_next = req.arrival + VDLR[m][l + 1]
            else:
                vdl_next = dl - rm[l + 2]
            nm = MINL[m][l + 1]
        else:
            vdl_next = dl
            nm = 0.0
        lv = LATV[m][l]
        rv = None
        if lv is not None and use_variants:
            ap = req.applied_variants
            if SVOK[m][l] if not ap else plans[m].is_valid_combo(ap | {l}):
                rv = lv
        return vdl, vdl_next, nm, rv

    def _activate_deep() -> None:
        """First deep round of the trial: build the kernel family's
        mirrors from the live slots; push/_fill_vdl/swap_remove maintain
        them incrementally from here on (deep stays on for the trial)."""
        if terastal:
            B.activate_deep_terastal(n_acc)
        elif need_pref:
            B.activate_deep_pref(need_fkey)
        else:
            B.activate_deep_dream()

    def _fault_refresh(now: float) -> None:
        """Rebuild the swappable plan tables from the current capability
        state and rewrite every live slot cache derived from them.  The
        deep mirrors are off under faults, so only the scalar caches —
        exactly the fields ``push`` derives from LAT/RM/MINL/PREF — need
        rewriting; ``B.guard`` is recomputed exactly (it may rise after
        an ``up`` event restores a fast column).  Under ``retighten``
        the virtual-deadline chains are re-derived from the effective
        tables and every in-flight request is re-bound (reference
        parity: ``refresh_tables`` in the scalar loop), the admission
        work tables are re-derived from degraded capacity, and the
        budget policy's ``on_capability`` hook fires last."""
        nonlocal LAT, LATV, RM, CF, CA, MINL, PREF, min_work_s, work_ns, solo
        eff = effective_plans(plans, fault_multipliers(fscale, avail))
        LAT = [p.lat_rows for p in eff]
        LATV = [p.lat_var_rows for p in eff]
        RM = [p.remaining_min_list for p in eff]
        CF = [p.crit_from_list for p in eff]
        CA = [p.crit_after_list for p in eff]
        MINL = [p.min_lat_list for p in eff]
        PREF = [p.acc_pref_rows for p in eff]
        if retighten:
            cur_chain[:] = retightened_vdl(plans, eff)
            for i in range(B.n):
                r = B.req[i]
                ch = cur_chain[r.model_idx]
                r.vdl_abs = None if ch is None else r.arrival + ch
            if solo is not None:
                ch = cur_chain[solo.model_idx]
                solo.vdl_abs = None if ch is None else solo.arrival + ch
            for r in running:
                if r is not None:
                    ch = cur_chain[r.model_idx]
                    r.vdl_abs = None if ch is None else r.arrival + ch
            if adm is not None:
                min_work_s, work_ns = degraded_work_tables(eff, duration)
                adm.bind(max(1, sum(avail)))
        g_min = _INF
        for i in range(B.n):
            m = B.model[i]
            l = B.layer[i]
            mr = CF[m][l]
            B.mr[i] = mr
            B.min_rem_arr[i] = mr
            g = B.dl_eps_arr[i] - mr
            B.guard_arr[i] = g
            if g < g_min:
                g_min = g
            B.lat[i] = LAT[m][l]
            if need_pref:
                B.pref[i] = PREF[m][l]
                if need_ekey:
                    B.ekey[i] = (B.dl[i] - CA[m][l], B.rid[i], l)
            elif terastal:
                _fill_vdl(i, B.req[i], m, l)
        B.guard = g_min
        if not policy_inert:
            # capability hook: same REBIND contract as ``on_tick`` —
            # materialize solo so the policy sees the whole ready set
            if solo is not None:
                push(solo)
                solo = None
            nb = B.n
            ready_list = B.req[:nb]
            before = [r.vdl_abs for r in ready_list]
            policy.on_capability(now, ready_list, plans, eff, np.array(busy))
            if terastal:
                for i in range(nb):
                    r = B.req[i]
                    if r.vdl_abs is not before[i]:
                        _fill_vdl(i, r, B.model[i], B.layer[i])

    # The single ready request, kept OUT of the block: most rounds see
    # exactly one ready layer, and for those the push/swap_remove round
    # trip through the block is pure overhead.  Invariant: ``solo`` is
    # only ever non-None while ``B.n == 0``; any event that would add a
    # second ready item materializes it into the block first (insertion
    # order — and therefore reference parity — is preserved because the
    # solo request always entered the ready set earlier).
    solo: Optional[Request] = None

    while heap:
        now, ecnt, ev, payload = heappop(heap)
        if ev == _ARRIVAL:
            if cl_active and type(payload) is tuple:
                m, t_idx, u = payload
                client = (t_idx, u)
            else:
                m = payload
                client = None
            req = Request(
                rid=next_rid,
                model_idx=m,
                arrival=now,
                deadline_abs=now + DEADLINE[m],
                client=client,
            )
            next_rid += 1
            dg = DAGS[m]
            if dg is not None:
                # one logical request, one rid, one shared DagRun; the
                # lowest source node is the representative admission judges
                req.next_layer = dg.sources[0]
                req.dag = DagRun.fresh(dg)
            if adm is not None and not adm.admit(req, now, backlog_ns, min_work_s[m]):
                # shed at the door: released+missed+dropped+shed, never
                # enters ready and the budget policy never sees it
                req.dropped = True
                released[m] += 1
                missed[m] += 1
                dropped[m] += 1
                shed[m] += 1
                if client is not None:
                    push_release(client, now)
            else:
                if not policy_inert:
                    policy.on_release(req, plans[m], now)
                if retighten and cur_chain[m] is not None:
                    # bind the retightened chain in force at release time;
                    # later capability events re-bind via ``_fault_refresh``
                    req.vdl_abs = now + cur_chain[m]
                released[m] += 1
                if need_backlog:
                    req.work_ns = work_ns[m]
                    backlog_ns += req.work_ns
                if solo is None and not B.n:
                    solo = req
                else:
                    if solo is not None:
                        push(solo)
                        solo = None
                    push(req)
                if dg is not None and len(dg.sources) > 1:
                    # sibling entries for the remaining source nodes,
                    # ascending — reference ready order
                    if solo is not None:
                        push(solo)
                        solo = None
                    for s in dg.sources[1:]:
                        push(
                            Request(
                                rid=req.rid,
                                model_idx=m,
                                arrival=now,
                                deadline_abs=req.deadline_abs,
                                next_layer=s,
                                client=client,
                                dag=req.dag,
                                vdl_abs=req.vdl_abs,
                                work_ns=req.work_ns,
                            )
                        )
        elif ev == _FINISH:
            k = payload
            if fm is not None and ecnt != cur_fin[k]:
                pass  # stale finish: its dispatch was evicted or re-timed
            else:
                req = running[k]
                running[k] = None
                n_running -= 1
                dr = req.dag
                if dr is not None:
                    # DAG node finish: no layer increment — the entry IS
                    # one node.  A dropped request's still-running sibling
                    # finishes as a no-op (busy time already accrued; the
                    # drop was counted once at drop time).
                    if not dr.dropped:
                        m = req.model_idx
                        dg = DAGS[m]
                        node = req.next_layer
                        dr.n_done += 1
                        if node == dg.sink:
                            # every node is an ancestor of the unique
                            # sink, so sink finish == request completion
                            req.done_time = now
                            completed[m] += 1
                            if now > req.deadline_abs + 1e-12:
                                missed[m] += 1
                            retained_sum[m] += plans[m].combo_retained(
                                dr.applied_variants
                            )
                            if need_backlog:
                                backlog_ns -= req.work_ns
                            if req.client is not None:
                                push_release(req.client, now)
                        else:
                            for s in dg.succs[node]:
                                dr.pending[s] -= 1
                                if dr.pending[s] == 0:
                                    nr = Request(
                                        rid=req.rid,
                                        model_idx=m,
                                        arrival=req.arrival,
                                        deadline_abs=req.deadline_abs,
                                        next_layer=s,
                                        applied_variants=dr.applied_variants,
                                        client=req.client,
                                        dag=dr,
                                        vdl_abs=req.vdl_abs,
                                        work_ns=req.work_ns,
                                    )
                                    if solo is None and not B.n:
                                        solo = nr
                                    else:
                                        if solo is not None:
                                            push(solo)
                                            solo = None
                                        push(nr)
                else:
                    req.next_layer += 1
                    if fm is not None:
                        req.layer_frac = 0.0
                    m = req.model_idx
                    if req.next_layer >= NL[m]:
                        req.done_time = now
                        completed[m] += 1
                        if now > req.deadline_abs + 1e-12:
                            missed[m] += 1
                        retained_sum[m] += plans[m].combo_retained(req.applied_variants)
                        if need_backlog:
                            backlog_ns -= req.work_ns
                        if req.client is not None:
                            push_release(req.client, now)
                    else:
                        if not policy_inert:
                            policy.on_layer_finish(req, plans[m], req.next_layer - 1, now)
                        if solo is None and not B.n:
                            solo = req
                        else:
                            if solo is not None:
                                push(solo)
                                solo = None
                            push(req)
        elif ev == _FAULT:
            fe = payload
            k = fe.acc
            if fe.code == "down":
                avail[k] = False
                r = running[k]
                if r is not None:
                    # undo the dispatch: variant bookkeeping, un-run busy
                    # time; carry layer progress under ``resume``; then
                    # re-enter the ready set for re-mapping (entry order
                    # matches the reference's ``ready.append``)
                    running[k] = None
                    n_running -= 1
                    dr = r.dag
                    run_dropped = dr is not None and dr.dropped
                    if run_var[k]:
                        r.applied_variants = r.applied_variants - {r.next_layer}
                        variants_applied[r.model_idx] -= 1
                        if dr is not None:
                            # retract from the shared DagRun and refresh
                            # the live siblings' snapshots (their cached
                            # scalars are rebuilt by ``_fault_refresh``)
                            dr.applied_variants = dr.applied_variants - {
                                r.next_layer
                            }
                            for i2 in range(B.n):
                                r2 = B.req[i2]
                                if r2.dag is dr:
                                    r2.applied_variants = dr.applied_variants
                            if solo is not None and solo.dag is dr:
                                solo.applied_variants = dr.applied_variants
                    fin_old = busy[k]
                    t0 = disp_start[k]
                    if resume and fin_old > t0:
                        r.layer_frac = r.layer_frac + (1.0 - r.layer_frac) * (
                            (now - t0) / (fin_old - t0)
                        )
                    else:
                        r.layer_frac = 0.0
                    dw, dh = evict_busy_adjust(t0, now, duration, disp_w[k], disp_h[k])
                    busy_t[k] += dw
                    busy_h[k] += dh
                    if not run_dropped:
                        # a dropped DagRun's evicted node is not re-mapped:
                        # the drop was already counted once at drop time
                        r.evicted_pending = True
                        evicted[r.model_idx] += 1
                        if solo is None and not B.n:
                            solo = r
                        else:
                            if solo is not None:
                                push(solo)
                                solo = None
                            push(r)
                busy[k] = _INF  # down == busy forever
                cur_fin[k] = -1
            elif fe.code == "up":
                avail[k] = True
                busy[k] = now
            else:  # scale: throttle multiplier transition
                old = fscale[k]
                fscale[k] = fe.value
                if running[k] is not None and fe.value != old:
                    # re-time the in-flight layer: remaining wall time
                    # stretches (or shrinks) by new_scale / old_scale
                    fin_old = busy[k]
                    fin_new = now + (fin_old - now) * (fe.value / old)
                    busy[k] = fin_new
                    dw, dh, disp_w[k], disp_h[k] = retime_busy_adjust(
                        disp_start[k], fin_new, duration, disp_w[k], disp_h[k]
                    )
                    busy_t[k] += dw
                    busy_h[k] += dh
                    heappush(heap, (fin_new, cnt, _FINISH, k))
                    cur_fin[k] = cnt
                    cnt += 1
            _fault_refresh(now)
        else:  # _TICK
            if solo is not None:
                push(solo)
                solo = None
            nb = B.n
            ready_list = B.req[:nb]
            before = [r.vdl_abs for r in ready_list]
            policy.on_tick(now, ready_list, plans, np.array(busy))
            if terastal:
                # a policy signals a chain update by REBINDING vdl_abs;
                # refresh the cached virtual-deadline scalars it touched
                for i in range(nb):
                    r = B.req[i]
                    if r.vdl_abs is not before[i]:
                        _fill_vdl(i, r, B.model[i], B.layer[i])
            if heap:  # keep ticking only while real events remain
                heappush(heap, (now + tick_dt, cnt, _TICK, None))
                cnt += 1

        # ---- batch simultaneous events before scheduling -----------------
        if heap and -1e-15 < heap[0][0] - now < 1e-15:
            continue

        # ---- scheduling round --------------------------------------------
        rounds += 1
        if solo is not None:
            # single-ready fast path: decide straight from the plan tables
            req = solo
            m = req.model_idx
            l = req.next_layer
            if now + CF[m][l] > req.deadline_abs + 1e-12:  # early-drop
                req.dropped = True
                if req.dag is not None:
                    # running siblings may exist: their finishes no-op
                    req.dag.dropped = True
                missed[m] += 1
                dropped[m] += 1
                if need_backlog:
                    backlog_ns -= req.work_ns
                if req.client is not None:
                    push_release(req.client, now)
                solo = None
                continue
            eps_now = now + 1e-15
            idle_mask = 0
            n_idle = 0
            for k in rng_acc:
                if busy[k] <= eps_now:
                    idle_mask |= 1 << k
                    n_idle += 1
            if not n_idle:
                continue
            if need_pref:  # FCFS/EDF: first idle accelerator by preference
                row = LAT[m][l]
                for k in PREF[m][l]:
                    if idle_mask >> k & 1:
                        c = row[k]
                        break
                use_var = False
            elif not terastal:  # DREAM: earliest estimated finish
                row = LAT[m][l]
                bk = -1
                bc = 0.0
                for k in rng_acc:
                    if idle_mask >> k & 1:
                        b = busy[k]
                        f = (b if b > now else now) + row[k]
                        if bk < 0 or f < bc:
                            bc, bk = f, k
                k = bk
                c = row[k]
                use_var = False
            else:  # Terastal: scalar single-layer round
                vdl, vdl_next, nm, rv = tera_scalars(req, m, l, RM[m])
                got = _solo_terastal(LAT[m][l], rv, vdl, vdl_next, nm,
                                     now, busy, idle_mask, n_acc, mode)
                if got is None:
                    continue  # cannot place within budget: stays solo
                k, use_var, c = got
            solo = None
            lay = l
        else:
            n = B.n
            if n and now > B.guard - 1e-9:
                # within the safety margin of the earliest possible drop:
                # run the exact masked compare (same floats as reference)
                drop_mask = now + B.min_rem_arr[:n] > B.dl_eps_arr[:n]
                if drop_mask.any():
                    dropped_clients: List[Tuple[int, int]] = []
                    if dag_present:
                        # reference drop-once semantics: one hopeless entry
                        # of a DAG request is its counted representative;
                        # every sibling entry (hopeless or not) is swept
                        # uncounted.  The dropped SET — and therefore every
                        # counter — is iteration-order independent.
                        for i in np.flatnonzero(drop_mask):
                            i = int(i)
                            r = B.req[i]
                            dr2 = r.dag
                            if dr2 is not None:
                                if dr2.dropped:
                                    continue  # sibling already counted
                                dr2.dropped = True
                            r.dropped = True
                            m = B.model[i]
                            missed[m] += 1
                            dropped[m] += 1
                            if need_backlog:
                                backlog_ns -= r.work_ns
                            if r.client is not None:
                                dropped_clients.append(r.client)
                        # sweep descending so swap_remove never moves an
                        # unexamined live slot (drop_mask indices < i stay
                        # valid throughout)
                        for i in range(n - 1, -1, -1):
                            r = B.req[i]
                            if (
                                r.dag.dropped
                                if r.dag is not None
                                else bool(drop_mask[i])
                            ):
                                r.dropped = True
                                B.swap_remove(i)
                    else:
                        for i in np.flatnonzero(drop_mask)[::-1]:
                            i = int(i)
                            r = B.req[i]
                            r.dropped = True
                            m = B.model[i]
                            missed[m] += 1
                            dropped[m] += 1
                            if need_backlog:
                                backlog_ns -= r.work_ns
                            if r.client is not None:
                                dropped_clients.append(r.client)
                            B.swap_remove(i)
                    n = B.n
                    if dropped_clients:
                        # canonical per-round release order (sorted by
                        # client): the reference drops the same SET in
                        # ready-insertion order, so both engines sort the
                        # release pushes to keep event counters identical
                        dropped_clients.sort()
                        for cl in dropped_clients:
                            push_release(cl, now)
                B.guard = float(B.guard_arr[:n].min()) if n else _INF
            if not n:
                continue
            eps_now = now + 1e-15
            idle_mask = 0
            n_idle = 0
            for k in rng_acc:
                if busy[k] <= eps_now:
                    idle_mask |= 1 << k
                    n_idle += 1
            if not n_idle:
                continue
            if n >= deep_min and not B.deep:
                _activate_deep()
            if terastal:
                if jax_on and n >= jax_min:
                    out = _jax_round(B, now, busy, idle_mask, n_acc, mode, device)
                elif B.deep and n >= vec_min:
                    out = _kern_terastal_vec(B, now, busy, idle_mask, n_idle, mode)
                else:
                    out = _kern_terastal(B, now, busy, idle_mask, n_idle, mode)
            elif B.deep:
                if kern_deep is not None and n >= vec_min:
                    out = kern_deep(B, now, busy, idle_mask, n_idle)
                elif need_pref:
                    out = _kern_pref_deep(B, idle_mask, n_idle)
                else:
                    out = kern(B, now, busy, idle_mask, n_idle)
            else:
                out = kern(B, now, busy, idle_mask, n_idle)
            if not out:
                continue
            # apply in reference order: the emit order fixes the finish-
            # event push counters (how simultaneous finishes tie-break)
            if len(out) > 1:
                for slot, k, use_var, c in out:
                    req = B.req[slot]
                    if use_var:
                        lay2 = B.layer[slot]
                        req.applied_variants = req.applied_variants | {lay2}
                        variants_applied[req.model_idx] += 1
                        dr = req.dag
                        if dr is not None:
                            # request-wide set lives on the DagRun; live
                            # sibling entries (still in the block — slots
                            # are removed after this loop) refresh their
                            # snapshot AND their cached variant row
                            dr.applied_variants = dr.applied_variants | {lay2}
                            for i2 in range(B.n):
                                r2 = B.req[i2]
                                if r2 is not req and r2.dag is dr:
                                    r2.applied_variants = dr.applied_variants
                                    _fill_vdl(i2, r2, B.model[i2], B.layer[i2])
                    if fm is not None:
                        if req.evicted_pending:
                            req.evicted_pending = False
                            remapped[req.model_idx] += 1
                        if req.layer_frac > 0.0:
                            # resume policy: only the un-executed remainder
                            # of the interrupted layer runs
                            c = c * (1.0 - req.layer_frac)
                    busy[k] = now + c
                    busy_t[k] += c
                    rem = duration - now
                    hh = c if c <= rem else (rem if rem > 0.0 else 0.0)
                    busy_h[k] += hh
                    running[k] = req
                    n_running += 1
                    heappush(heap, (now + c, cnt, _FINISH, k))
                    if fm is not None:
                        cur_fin[k] = cnt
                        run_var[k] = use_var
                        disp_start[k] = now
                        disp_w[k] = c
                        disp_h[k] = hh
                    cnt += 1
                slots = [s for s, _, _, _ in out]
                slots.sort(reverse=True)  # swap-remove must not move live slots
                for slot in slots:
                    B.swap_remove(slot)
                continue
            slot, k, use_var, c = out[0]
            req = B.req[slot]
            lay = B.layer[slot]
            B.swap_remove(slot)

        # ---- apply the single assignment; maybe enter the fused chain ----
        if use_var:
            req.applied_variants = req.applied_variants | {lay}
            variants_applied[req.model_idx] += 1
            dr = req.dag
            if dr is not None:
                dr.applied_variants = dr.applied_variants | {lay}
                for i2 in range(B.n):
                    r2 = B.req[i2]
                    if r2.dag is dr:
                        r2.applied_variants = dr.applied_variants
                        _fill_vdl(i2, r2, B.model[i2], B.layer[i2])
        if fm is not None:
            if req.evicted_pending:
                req.evicted_pending = False
                remapped[req.model_idx] += 1
            if req.layer_frac > 0.0:
                c = c * (1.0 - req.layer_frac)
        fin = now + c
        busy[k] = fin
        busy_t[k] += c
        rem = duration - now  # min(c, max(0.0, rem)) without the C calls
        hh = c if c <= rem else (rem if rem > 0.0 else 0.0)
        busy_h[k] += hh
        # -- fused uncontended chain: this request is alone in the system
        # and nothing interrupts before its layer finishes — advance it
        # layer-by-layer with no event-queue traffic.
        if (
            policy_inert
            and fm is None  # fault events must interrupt the chain
            and not dag_present  # the chain loop advances layers linearly
            and not n_running
            and not B.n
            and (not heap or heap[0][0] > fin + 1e-15)
        ):
            m = req.model_idx
            rm = RM[m]
            L = NL[m]
            fin_cnt = cnt
            cnt += 1
            alive = True
            while True:
                now = fin
                req.next_layer += 1
                l = req.next_layer
                rounds += 1  # the round at this finish timestamp
                if l >= L:  # chain complete (its empty-ready round still runs)
                    req.done_time = now
                    completed[m] += 1
                    if now > req.deadline_abs + 1e-12:
                        missed[m] += 1
                    retained_sum[m] += plans[m].combo_retained(req.applied_variants)
                    if need_backlog:
                        backlog_ns -= req.work_ns
                    if req.client is not None:
                        # counter parity: the last layer's finish consumed
                        # fin_cnt == cnt-1, so the release push takes the
                        # same counter the reference allocates for it
                        push_release(req.client, now)
                    alive = False
                    break
                if now + rm[l] > req.deadline_abs + 1e-12:  # early-drop
                    req.dropped = True
                    missed[m] += 1
                    dropped[m] += 1
                    if need_backlog:
                        backlog_ns -= req.work_ns
                    if req.client is not None:
                        push_release(req.client, now)
                    alive = False
                    break
                # decide via the shared kernels on the 1-slot scratch block
                # (all accelerators idle, tau uniform == now)
                if need_pref:
                    k = PREF[m][l][0]  # all idle: first preference wins
                    c = LAT[m][l][k]
                    use_var = False
                elif not terastal:  # DREAM, all idle: first-min of now + c_k
                    row = LAT[m][l]
                    bk = 0
                    bc = now + row[0]
                    for kk in range(1, n_acc):
                        f = now + row[kk]
                        if f < bc:
                            bc, bk = f, kk
                    k = bk
                    c = row[k]
                    use_var = False
                else:
                    vdl, vdl_next, nm, rv = tera_scalars(req, m, l, rm)
                    got = _solo_terastal(LAT[m][l], rv, vdl, vdl_next, nm,
                                         now, busy, all_idle_mask, n_acc, mode)
                    if got is None:  # cannot place within budget: leave fused
                        solo = req
                        alive = False
                        break
                    k, use_var, c = got
                    if use_var:
                        req.applied_variants = req.applied_variants | {l}
                        variants_applied[m] += 1
                fin = now + c
                busy[k] = fin
                busy_t[k] += c
                rem = duration - now
                busy_h[k] += c if c <= rem else (rem if rem > 0.0 else 0.0)
                fin_cnt = cnt
                cnt += 1
                if heap and heap[0][0] <= fin + 1e-15:
                    break  # interrupted: materialize and rejoin the loop
            if alive:
                running[k] = req
                n_running += 1
                heappush(heap, (fin, fin_cnt, _FINISH, k))
            continue
        running[k] = req
        n_running += 1
        heappush(heap, (fin, cnt, _FINISH, k))
        if fm is not None:
            cur_fin[k] = cnt
            run_var[k] = use_var
            disp_start[k] = now
            disp_w[k] = c
            disp_h[k] = hh
        cnt += 1

    # Horizon drain: a DAG request may be split over several sibling
    # entries (ready and/or running) — count the logical request once,
    # and not at all if it was already counted dropped.
    seen_runs: set = set()

    def drain_in_flight(r: Request) -> None:
        if r.dag is None:
            in_flight[r.model_idx] += 1
        elif not r.dag.dropped and id(r.dag) not in seen_runs:
            seen_runs.add(id(r.dag))
            in_flight[r.model_idx] += 1

    for i in range(B.n):
        drain_in_flight(B.req[i])
    if solo is not None:
        drain_in_flight(solo)
    for r in running:
        if r is not None:
            drain_in_flight(r)

    stats: Dict[int, ModelStats] = {t.model_idx: ModelStats() for t in tasks}
    for m in stats:
        stats[m] = ModelStats(
            released=released[m],
            completed=completed[m],
            missed=missed[m],
            dropped=dropped[m],
            retained_sum=retained_sum[m],
            variants_applied=variants_applied[m],
            shed=shed[m],
            in_flight=in_flight[m],
            evicted=evicted[m],
            remapped=remapped[m],
        )
    return SimResult(
        duration=duration,
        per_model=stats,
        acc_busy_time=np.array(busy_t),
        scheduler_name=scheduler.name,
        acc_busy_in_horizon=np.array(busy_h),
        rounds=rounds,
        faulted_spans=faulted_spans,
    )
