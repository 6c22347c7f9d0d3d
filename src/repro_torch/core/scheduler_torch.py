"""Algorithm 2 on the device, and the host-side packers (torch port).

Counterpart of the JAX package's ``scheduler_jax``: one Terastal
scheduling round over padded tensors, its host packers, and the
batched-trial packers.  The round's inputs and outputs are those of the
reference (see :class:`RoundInputs`): ``ready_mask``, ``vdl``,
``vdl_next``, ``next_min`` over the NJ ready slots, ``lat`` / ``lat_var``
``[NJ, NA]``, ``tau`` and ``idle_mask`` over the NA accelerators; out come
``assign_acc`` (-1 = unassigned), ``assign_var`` and ``assign_seq``, the
reference emission order (stage-1 assignments their sorted-order
position, stage-2 assignments ``NJ + k``, unassigned ``NJ + NA``).

Copied verbatim from the original module (numpy, no device): ``EPS``,
``NEG``, ``BACKFILL_MODES``, ``bucket_nj``, ``_buffers`` and the staging
halves of ``pack_view`` / ``pack_arrays``, and ``bucket_ev``,
``_trial_buffers``, ``pack_trials``, and the fault-epoch packer
``_FAULT_CODES`` / ``pack_fault_epochs`` (its helpers from the port's own
copy of ``faults``).  Only the final staging differs: one
``torch.tensor(..., device=...)`` per field where the original has
``jnp.asarray`` (a copy, as the host buffers are reused by the next
call).

The round, and why it is bit-identical
--------------------------------------
The round runs in float64 and uses only IEEE add, subtract and compare,
one torch op each, plus min/argmin/argmax and a stable argsort, which
are exact: no fused op (``addcmul``, ``lerp``) and no ``torch.compile``
is on its path, so every value is the one the Python schedulers compute.
The ties are the reference's: ``argsort(stable=True)`` on the best-case
slack (slots in ascending-rid order, so ties go to the lower rid),
first-minimum ``argmin`` over accelerators, and in stage 2 the
first-maximum ``argmax`` with the ``(delta, -use_var)`` rank.  Padded
slots hold ``lat = +inf`` and ``ready_mask = False``, so their slack
``vdl - inf = -inf`` is masked to ``+inf`` before the sort and no NaN is
ever selected.

Stage 1 visits the ready slots in urgency order and gives each the idle
accelerator that finishes it earliest within its virtual deadline,
original latency first, then the variant's.  The reference writes it as
a loop of NJ steps, one slot each.  Here it is a loop of NA steps, one
*assignment* each, every step testing all slots at once: an assignment
only takes an accelerator out of the idle set, so a slot that found no
candidate at one point of the scan finds none later, and the next slot
the reference assigns is therefore the first remaining slot, in urgency
order, that has a candidate under the current ``tau`` and idle set.
Each slot's test is the same ``tau + lat <= vdl + EPS`` the reference
makes, so the assignments, their accelerators, latencies and positions
are the reference's; a round costs a few hundred small device ops
however deep the ready queue.  Stage 2 is the reference's loop over the
NA accelerators.

On a CUDA device :func:`terastal_round` replays one CUDA graph per
``(NJ_pad, NA, mode)`` bucket, captured at the bucket's first round
(the reference compiles once per bucket); the graph runs the same ops
as the eager round on the host, and a capture that fails raises.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

EPS = 1e-15
NEG = -1e30

#: stage-2 guard variants of TerastalScheduler.backfill_mode (a
#: per-bucket argument of :func:`terastal_round`).
BACKFILL_MODES = ("ef", "positive", "paper")


class RoundInputs(NamedTuple):
    ready_mask: torch.Tensor  # [NJ] bool
    vdl: torch.Tensor  # [NJ] f64
    vdl_next: torch.Tensor  # [NJ] f64
    next_min: torch.Tensor  # [NJ] f64
    lat: torch.Tensor  # [NJ, NA] f64
    lat_var: torch.Tensor  # [NJ, NA] f64
    tau: torch.Tensor  # [NA] f64
    idle_mask: torch.Tensor  # [NA] bool


class RoundOutputs(NamedTuple):
    assign_acc: torch.Tensor  # [NJ] int32, -1 = none
    assign_var: torch.Tensor  # [NJ] bool
    assign_seq: torch.Tensor  # [NJ] int32 emission order; NJ + NA = unassigned


def _best_case_slack(inp: RoundInputs, tau: torch.Tensor) -> torch.Tensor:
    finish = tau[None, :] + inp.lat  # [NJ, NA]
    return inp.vdl - finish.amin(dim=1)


def _round(inp: RoundInputs, mode: str) -> RoundOutputs:
    """The round's ops, eager; :func:`terastal_round` captures these on CUDA."""
    NJ, NA = inp.lat.shape
    dev = inp.lat.device
    inf = float("inf")
    i32 = torch.int32
    slots = torch.arange(NJ, device=dev)
    accs = torch.arange(NA, device=dev)

    s_star0 = torch.where(inp.ready_mask, _best_case_slack(inp, inp.tau), inf)
    order = torch.argsort(s_star0, stable=True)  # ties -> lower slot index
    position = torch.empty_like(order).scatter_(0, order, slots)  # slot -> its place in order

    idle = inp.idle_mask
    tau = inp.tau
    acc = torch.full((NJ,), -1, dtype=i32, device=dev)
    var = torch.zeros((NJ,), dtype=torch.bool, device=dev)
    seq = torch.full((NJ,), NJ + NA, dtype=i32, device=dev)
    remaining = inp.ready_mask

    # ---------------- stage 1: one assignment a step ----------------
    d_eps = (inp.vdl + EPS)[:, None]  # the reference's d_v + EPS, per slot
    finite = torch.isfinite(inp.lat), torch.isfinite(inp.lat_var)
    for _ in range(NA):
        fits = []
        for lat_tab, fin in zip((inp.lat, inp.lat_var), finite):
            finish = tau[None, :] + lat_tab
            cand = idle[None, :] & (finish <= d_eps) & fin
            k = torch.where(cand, finish, inf).argmin(dim=1)
            fits.append((cand.any(dim=1), k, lat_tab.gather(1, k[:, None])[:, 0]))
        (ok1, k1, c1), (ok2, k2, c2) = fits
        fit_p = (remaining & (ok1 | ok2)).gather(0, order)  # in urgency order
        p = fit_p.to(i32).argmax()  # first slot that fits
        found = fit_p.gather(0, p[None])[0]
        j = order.gather(0, p[None])[0]
        use1 = ok1.gather(0, j[None])[0]
        k = torch.where(use1, k1.gather(0, j[None])[0], k2.gather(0, j[None])[0])
        c = torch.where(use1, c1.gather(0, j[None])[0], c2.gather(0, j[None])[0])
        at_j = (slots == j) & found
        at_k = (accs == k) & found
        idle = idle & ~at_k
        tau = torch.where(at_k, tau + c, tau)
        acc = torch.where(at_j, k.to(i32), acc)
        var = torch.where(at_j, ~use1, var)
        seq = torch.where(at_j, position.to(i32), seq)
        remaining = remaining & ~at_j

    # ---------------- stage 2: guarded backfill ----------------
    # python iterates ``remaining`` in STAGE-1 SORTED order (j outer,
    # original-then-variant inner), replacing only on strictly-greater
    # (delta, -use_var): permute through ``order`` and take the FIRST
    # maximum of delta, then the first maximum of the rank among them.
    rank = -(torch.arange(2 * NJ, device=dev) % 2).to(inp.lat.dtype)
    for k in range(NA):
        ef_orig = (tau[None, :] + inp.lat).amin(dim=1)
        s_star = inp.vdl - ef_orig  # [NJ] at the current tau
        scores = []
        for lat_tab in (inp.lat, inp.lat_var):
            c = lat_tab[:, k]
            finish = tau[k] + c
            allowed = remaining & torch.isfinite(c)
            if mode == "ef":
                # earliest-finish optimality guard across ALL accelerators
                ef_all = ef_orig if lat_tab is inp.lat else (tau[None, :] + lat_tab).amin(dim=1)
                allowed = allowed & (finish <= ef_all + EPS)
            s_f = inp.vdl_next - finish - inp.next_min
            scores.append(torch.where(allowed, s_f - s_star, -inf).gather(0, order))
        flat = torch.stack(scores, dim=1).reshape(-1)  # [NJ*2]
        best = flat.argmax()
        top = flat.gather(0, best[None])[0]
        best = torch.where(flat == top, rank, -inf).argmax()
        j = order.gather(0, (best // 2)[None])[0]
        use_var = (best % 2).to(torch.bool)
        have = idle[k] & torch.isfinite(top) & (top > -inf)
        if mode == "positive":
            have = have & (top > 0.0)
        c = torch.where(use_var, inp.lat_var[:, k].gather(0, j[None])[0],
                        inp.lat[:, k].gather(0, j[None])[0])
        at_k = (accs == k) & have
        at_j = (slots == j) & have
        idle = idle & ~at_k
        tau = torch.where(at_k, tau + c, tau)
        acc = torch.where(at_j, k, acc)
        var = torch.where(at_j, use_var, var)
        seq = torch.where(at_j, NJ + k, seq)
        remaining = remaining & ~at_j
    return RoundOutputs(acc, var, seq)


#: captured rounds, one per (NJ_pad, NA, mode, device): (graph, static
#: inputs, static outputs)
_GRAPHS: dict = {}


def terastal_round(inp: RoundInputs, mode: str = "ef") -> RoundOutputs:
    """One Terastal round (stage 1 + stage 2) on ``inp``'s device.

    On the host the ops run eagerly.  On a CUDA device the round of a
    ``(NJ_pad, NA, mode)`` bucket is captured into a CUDA graph at its
    first call and replayed after: the inputs are copied into the graph's
    own, and the outputs returned are copies of the graph's.  A capture
    that fails raises (no eager fallback).  ``terastal_round.calls``
    counts the rounds run."""
    if mode not in BACKFILL_MODES:
        raise ValueError(f"unknown backfill mode {mode!r} (have {BACKFILL_MODES})")
    terastal_round.calls += 1
    dev = inp.lat.device
    if dev.type != "cuda":
        return _round(inp, mode)
    key = (tuple(inp.lat.shape), mode, dev)
    entry = _GRAPHS.get(key)
    if entry is None:
        static_in = RoundInputs(*(t.clone() for t in inp))
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            _round(static_in, mode)  # warm-up outside the capture
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_out = _round(static_in, mode)
        entry = _GRAPHS[key] = (graph, static_in, static_out)
    graph, static_in, static_out = entry
    for dst, src in zip(static_in, inp):
        dst.copy_(src)
    graph.replay()
    return RoundOutputs(*(t.clone() for t in static_out))


terastal_round.calls = 0


def device_get(out: RoundOutputs) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(assign_acc, assign_var, assign_seq)`` on the host, in one copy."""
    both = torch.stack((out.assign_acc, out.assign_var.to(torch.int32), out.assign_seq))
    acc, var, seq = both.cpu().numpy()
    return acc, var.astype(bool), seq


# --------------------------------------------------------------- adapter ----


#: smallest NJ bucket; NJ pads up to the next power of two above this.
BUCKET_MIN = 4

#: persistent host-side staging buffers, one set per (NJ_pad, NA) bucket.
#: Reused across pack_view calls so a sweep over ready-queue sizes does
#: not reallocate, and ``terastal_round`` sees only O(log max_NJ)
#: distinct shapes, so it captures once per bucket instead of once per
#: ready-queue size.
_HOST_BUFFERS: dict = {}


def bucket_nj(nj: int) -> int:
    """Pad a ready-queue size to its power-of-two shape bucket."""
    if nj <= BUCKET_MIN:
        return BUCKET_MIN
    return 1 << (nj - 1).bit_length()


def _buffers(nj_pad: int, na: int):
    key = (nj_pad, na)
    buf = _HOST_BUFFERS.get(key)
    if buf is None:
        buf = {
            "ready": np.zeros(nj_pad, bool),
            "vdl": np.zeros(nj_pad),
            "vdl_next": np.zeros(nj_pad),
            "next_min": np.zeros(nj_pad),
            "lat": np.full((nj_pad, na), np.inf),
            "lat_var": np.full((nj_pad, na), np.inf),
        }
        _HOST_BUFFERS[key] = buf
    return buf


def _stage(ready, vdl, vdl_next, next_min, lat, lat_var, tau, idle, device) -> RoundInputs:
    """One host->device copy per field (a copy on the host too: the
    bucket buffers are reused by the next call)."""
    dev = resolve_device(device)
    return RoundInputs(*(torch.tensor(a, device=dev) for a in (
        ready, vdl, vdl_next, next_min, lat, lat_var, tau, idle)))


def pack_view(view, scheduler, device=None) -> Tuple[RoundInputs, list]:
    """Build RoundInputs from a SchedView + TerastalScheduler (host side)
    on ``device`` (the card when None).
    Returns (inputs, slot->request list).  ``vdl``/``vdl_next`` come from
    ``scheduler.vdl``, which prefers a request's dynamic ``vdl_abs`` state
    (online budget policies) over the frozen plan table — the device
    round needs no change for dynamic budgets.

    NJ is padded to a power-of-two shape bucket (>= ``BUCKET_MIN``) with
    persistent host buffers: padded slots have ``ready_mask=False`` (so
    stage 1 skips them and stage 2's ``remaining`` mask never admits
    them) and +inf latency rows, and ``terastal_round`` captures at most
    once per bucket per process instead of once per ready-queue size."""
    reqs = sorted(view.ready, key=lambda r: r.rid)
    NJ, NA = len(reqs), view.n_acc
    NJ_pad = bucket_nj(NJ)
    buf = _buffers(NJ_pad, NA)
    ready = buf["ready"]
    vdl = buf["vdl"]
    vdl_next = buf["vdl_next"]
    next_min = buf["next_min"]
    lat = buf["lat"]
    lat_var = buf["lat_var"]
    # reset the pad region (buffers are reused across different NJ)
    ready[:NJ] = True
    ready[NJ:] = False
    vdl[NJ:] = 0.0
    vdl_next[NJ:] = 0.0
    next_min[NJ:] = 0.0
    lat[NJ:] = np.inf
    lat_var[NJ:] = np.inf
    for i, r in enumerate(reqs):
        plan = view.plans[r.model_idx]
        l = r.next_layer
        vdl[i] = scheduler.vdl(plan, r, l)
        if l + 1 < len(plan.model.layers):
            vdl_next[i] = scheduler.vdl(plan, r, l + 1)
            next_min[i] = float(plan.lat[l + 1].min())
        else:
            vdl_next[i] = r.deadline_abs
            next_min[i] = 0.0
        lat[i] = plan.lat[l]
        if scheduler._variant_ok(plan, r, l):
            lat_var[i] = plan.lat_var[l]
        else:
            lat_var[i] = np.inf
    tau = np.array([view.tau(k) for k in range(NA)])
    idle = np.array([view.acc_busy_until[k] <= view.now + 1e-15 for k in range(NA)])
    inp = _stage(ready, vdl, vdl_next, next_min, lat, lat_var, tau, idle, device)
    return inp, reqs


def pack_arrays(
    vdl: np.ndarray,
    vdl_next: np.ndarray,
    next_min: np.ndarray,
    lat: np.ndarray,
    lat_var: np.ndarray,
    tau: np.ndarray,
    idle: np.ndarray,
    device=None,
) -> RoundInputs:
    """Stage already-vectorized per-slot arrays into the persistent
    bucket buffers — the SoA engine's deep-round path (its ready block
    keeps these exact arrays as incrementally maintained mirrors, so the
    host side of a device round is a handful of slice copies, not a
    per-request Python loop like :func:`pack_view`).  Slots must arrive
    in ascending-rid order (stable argsort ties = ``(slack, rid)``).
    One host->device staging per field onto ``device`` (the card when
    None); same pow2 NJ shape buckets."""
    NJ, NA = lat.shape
    NJ_pad = bucket_nj(NJ)
    buf = _buffers(NJ_pad, NA)
    ready = buf["ready"]
    ready[:NJ] = True
    ready[NJ:] = False
    for name, src, pad in (
        ("vdl", vdl, 0.0),
        ("vdl_next", vdl_next, 0.0),
        ("next_min", next_min, 0.0),
        ("lat", lat, np.inf),
        ("lat_var", lat_var, np.inf),
    ):
        dst = buf[name]
        dst[:NJ] = src
        dst[NJ:] = pad
    return _stage(ready, buf["vdl"], buf["vdl_next"], buf["next_min"], buf["lat"],
                  buf["lat_var"], tau, idle, device)


# ------------------------------------------- batched trial staging ----

#: persistent seed-major staging buffers for the batched-trial engine
#: (``repro_torch.core.engine_batch``), one set per (B_pad, NR_pad)
#: bucket, so a sweep sees only O(log max_B x log max_NR) distinct
#: shapes.
_TRIAL_BUFFERS: dict = {}


def _trial_buffers(b_pad: int, nr_pad: int):
    key = (b_pad, nr_pad)
    buf = _TRIAL_BUFFERS.get(key)
    if buf is None:
        buf = {
            # +1 sentinel column: the event loop peeks arr_t[ai] with
            # ai == n_ev after the last arrival; the pad is +inf so the
            # peek reads "no more arrivals" without a bounds branch.
            "arr_t": np.full((b_pad, nr_pad + 1), np.inf),
            "arr_m": np.zeros((b_pad, nr_pad), np.int32),
            "dl": np.full((b_pad, nr_pad), np.inf),
            "dl12": np.full((b_pad, nr_pad), np.inf),
            "n_ev": np.zeros(b_pad, np.int32),
        }
        _TRIAL_BUFFERS[key] = buf
    return buf


def bucket_ev(n: int) -> int:
    """Pad an event-horizon length to its shape bucket.

    Finer-grained than ``bucket_nj``: rungs at every power of two AND at
    1.5x the previous one (..., 96, 128, 192, 256, 384, ...).  The batch
    engine's per-iteration cost is linear in the padded horizon, so pow2
    rounding's worst case (~2x dead width just past a boundary) is real
    wall-clock; the extra rungs cap the waste at ~33% for one more
    compile-cache entry per size class."""
    n = max(int(n), BUCKET_MIN)
    p = 1 << (n - 1).bit_length()
    h = (p >> 1) + (p >> 2)      # 1.5 * previous pow2 rung
    return h if n <= h else p


def pack_trials(events: "list[tuple]", deadline_by_model: np.ndarray):
    """Stage B seeds' pre-generated release events into the persistent
    seed-major trial buffers (the batched counterpart of
    :func:`pack_arrays`).

    ``events`` is ``[(times, models)]`` per seed — the output of
    ``workload.batch_release_events`` — and ``deadline_by_model`` maps
    model_idx -> relative deadline.  Both the seed axis and the event
    horizon are padded to pow2 shape buckets (``bucket_nj``), so the
    batch engine's jitted program compiles once per (B, NR) bucket pair;
    pad lanes carry ``n_ev = 0`` (immediately drained) and pad slots
    ``arr_t = +inf`` (never popped).  Absolute deadlines are computed
    here with the same IEEE-f64 adds the reference engine performs per
    request (``now + plan.deadline``; ``dl12 = dl + 1e-12`` mirrors its
    inline miss/drop epsilon), so downstream comparisons are bit-equal.

    Returns ``(buf, b_pad, nr_pad)`` where ``buf`` holds the padded
    numpy arrays (views of the persistent buffers — consume before the
    next call)."""
    B = len(events)
    NR = max((len(t) for t, _ in events), default=0)
    b_pad = bucket_nj(B)
    nr_pad = bucket_ev(max(NR, 1))
    buf = _trial_buffers(b_pad, nr_pad)
    buf["arr_t"][:] = np.inf
    buf["dl"][:] = np.inf
    buf["dl12"][:] = np.inf
    buf["arr_m"][:] = 0
    buf["n_ev"][:] = 0
    for b, (times, models) in enumerate(events):
        n = len(times)
        buf["n_ev"][b] = n
        if not n:
            continue
        buf["arr_t"][b, :n] = times
        buf["arr_m"][b, :n] = models
        dl = times + deadline_by_model[models]
        buf["dl"][b, :n] = dl
        buf["dl12"][b, :n] = dl + 1e-12
    return buf, b_pad, nr_pad


_FAULT_CODES = {"down": 0, "up": 1, "scale": 2}


def pack_fault_epochs(fault_model, plans, duration, seeds, b_pad: int, lp: int):
    """Pre-bind each lane's capability timeline as time-indexed epoch
    planes for the batch engine's fault path.

    A lane's capability state is piecewise-constant between its fault
    events, so the whole timeline is NF events plus NF+1 *epochs*; this
    stages, per lane, the event stream (``fe_t``/``fe_acc``/``fe_code``/
    ``fe_val``/``n_f``) and, per epoch, every capability-derived table
    the round kernels read — the ``[NA]`` latency multiplier
    (``mult_ep``), the virtual-deadline chains (``vdlr_ep``; the
    re-tightened chains under ``retighten=true`` via
    ``faults.retightened_vdl``, the frozen offline chains otherwise),
    the remaining-min suffix sums (``rm_ep``) and per-layer min
    latencies (``minl_ep``).  All planes are replayed event-by-event
    through the exact host helpers the scalar engines call
    (``effective_plans`` / ``fault_multipliers``), so fault-time
    arithmetic is bit-identical by construction.

    The event axis is padded to a pow2 bucket (one compile per bucket);
    pad events carry ``fe_t = +inf`` (never popped) and pad epochs
    repeat the lane's final capability state (never entered).  Returns
    ``(fbuf, nf_pad, n_spans)`` with ``n_spans`` the per-seed
    intersecting-window counts for ``SimResult.faulted_spans``.
    """
    from repro_torch.core.faults import (
        effective_plans,
        fault_multipliers,
        retightened_vdl,
    )

    M = len(plans)
    NA = plans[0].platform.n_acc
    timelines = [fault_model.timeline(NA, duration, s) for s in seeds]
    NF = max((len(ev) for ev, _ in timelines), default=0)
    nf_pad = 1 << (max(NF, 1) - 1).bit_length()

    fbuf = {
        # +1 sentinel column: the loop peeks fe_t[fi] with fi == n_f
        # after the last fault; +inf reads "no more faults"
        "fe_t": np.full((b_pad, nf_pad + 1), np.inf),
        "fe_acc": np.zeros((b_pad, nf_pad), np.int32),
        "fe_code": np.zeros((b_pad, nf_pad), np.int32),
        "fe_val": np.ones((b_pad, nf_pad)),
        "n_f": np.zeros(b_pad, np.int32),
        "mult_ep": np.ones((b_pad, nf_pad + 1, NA)),
        "vdlr_ep": np.zeros((b_pad, nf_pad + 1, M, lp + 1)),
        "rm_ep": np.zeros((b_pad, nf_pad + 1, M, lp + 2)),
        "minl_ep": np.zeros((b_pad, nf_pad + 1, M, lp)),
    }

    def fill_epoch(b, e, eff, mult):
        fbuf["mult_ep"][b, e] = mult
        chains = (
            retightened_vdl(plans, eff)
            if fault_model.retighten
            else [None] * M
        )
        for m, (p, ep) in enumerate(zip(plans, eff)):
            L = len(p.model.layers)
            ch = chains[m]
            fbuf["vdlr_ep"][b, e, m, :L] = p.vdl_rel if ch is None else ch
            fbuf["rm_ep"][b, e, m, : L + 1] = ep.remaining_min
            fbuf["minl_ep"][b, e, m, :L] = ep.min_lat

    nominal = fault_multipliers([1.0] * NA, [True] * NA)
    fill_epoch(0, 0, plans, nominal)
    # broadcast the nominal epoch everywhere (pad lanes, epoch 0, and pad
    # epochs start from it; the replay below overwrites live epochs)
    for key in ("mult_ep", "vdlr_ep", "rm_ep", "minl_ep"):
        fbuf[key][:, :] = fbuf[key][0, 0]

    n_spans = []
    for b, (events, spans) in enumerate(timelines):
        n_spans.append(spans)
        fbuf["n_f"][b] = len(events)
        avail = [True] * NA
        fscale = [1.0] * NA
        for e_i, ev in enumerate(events):
            fbuf["fe_t"][b, e_i] = ev.t
            fbuf["fe_acc"][b, e_i] = ev.acc
            fbuf["fe_code"][b, e_i] = _FAULT_CODES[ev.code]
            fbuf["fe_val"][b, e_i] = ev.value if ev.code == "scale" else 1.0
            if ev.code == "down":
                avail[ev.acc] = False
            elif ev.code == "up":
                avail[ev.acc] = True
            else:
                fscale[ev.acc] = ev.value
            mult = fault_multipliers(fscale, avail)
            eff = effective_plans(plans, mult)
            fill_epoch(b, e_i + 1, eff, mult)
        # pad epochs (fi never reaches them) repeat the final state
        if len(events) < nf_pad:
            for key in ("mult_ep", "vdlr_ep", "rm_ep", "minl_ep"):
                fbuf[key][b, len(events) + 1 :] = fbuf[key][b, len(events)]
    return fbuf, nf_pad, n_spans
