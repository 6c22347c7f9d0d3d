"""Online schedulers: Terastal (Algorithm 2), FCFS, EDF, DREAM, ablations.

All policies share one interface: given a :class:`SchedView` snapshot
(ready request-layer pairs, accelerator availability, offline plans) they
return a list of :class:`Assignment` for *idle* accelerators.  The
event-driven simulator (``repro_torch.core.simulator``) invokes the scheduler
whenever an accelerator becomes idle or a request arrives, exactly as the
paper specifies, and applies the same early-drop policy to every policy
(paper Sec. IV-C last paragraph / Sec. V-A).

Fidelity notes
--------------
* FCFS / EDF follow Sec. V-A: FCFS orders ready layers by request arrival
  time; EDF by layer deadlines derived from minimum execution times; both
  map the selected layer to the idle accelerator with the lowest execution
  latency for that layer.
* DREAM is re-implemented from the DREAM paper's published mechanism
  (dynamic urgency-based priority with heterogeneity awareness), with the
  objective reduced to deadline-miss-rate per Terastal Sec. V-A.  Where
  internals are under-specified here, the approximation is confined to
  :class:`DreamScheduler` and marked ``# APPROX``.
* Terastal follows Algorithm 2 line-by-line (stage 1: best-case-slack
  order, original first then variant; stage 2: backfill by future
  potential slack gain, Eqs. 8-9).  ``use_budgets=False`` reproduces the
  "Terastal-no budgeting" ablation (EDF-style virtual deadlines);
  ``use_variants=False`` reproduces "Terastal-no variants".
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.dag import DagRun
from repro_torch.core.variants import ModelPlan


# ---------------------------------------------------------------- state ----


@dataclasses.dataclass(slots=True)
class Request:
    rid: int
    model_idx: int
    arrival: float
    deadline_abs: float
    next_layer: int = 0
    applied_variants: FrozenSet[int] = frozenset()
    done_time: Optional[float] = None
    dropped: bool = False
    # Closed-loop origin: (task_idx, user) when a ClosedLoopClients
    # release source issued this request — its completion or drop gates
    # that user's next release.  None = open-loop (pre-generated arrival).
    client: Optional[Tuple[int, int]] = None
    # Fault-axis state (repro_torch.core.faults).  ``layer_frac`` is the
    # already-executed fraction of ``next_layer`` under the ``resume``
    # interrupted-work policy (0.0 = fresh layer); ``evicted_pending``
    # marks a fault-evicted request whose next dispatch counts as a
    # re-map.  Both stay at their defaults on fault-free trials.
    layer_frac: float = 0.0
    evicted_pending: bool = False
    # Integer-ns minimum work this request was ADMITTED at (admission
    # backlog accounting).  Frozen per request so add/remove symmetry
    # survives mid-trial capability changes: under ``retighten=true``
    # the engines' work tables re-derive from degraded capacity, and a
    # request must decrement exactly what it incremented.  0 when no
    # backlog-tracking admission policy is active.
    work_ns: int = 0
    # DAG-request bookkeeping: sibling ready entries of one request (one
    # per precedence-unblocked node) share a DagRun; None = linear chain.
    # compare=False keeps entry equality keyed on (rid, next_layer, ...)
    # exactly as before the DAG axis.
    dag: Optional[DagRun] = dataclasses.field(default=None, compare=False)
    # Per-request ABSOLUTE virtual deadlines, [L].  None = the offline
    # plan's frozen ``vdl_rel`` table (the paper / seed behavior).  Online
    # budget policies (repro_torch.core.budget_online) install and mutate this;
    # budget-using schedulers read it through ``TerastalScheduler.vdl``.
    # compare=False: an ndarray in dataclass __eq__ would make equality
    # between equal requests raise instead of returning a bool.
    vdl_abs: Optional[np.ndarray] = dataclasses.field(default=None, compare=False)

    def is_finished(self, n_layers: int) -> bool:
        return self.next_layer >= n_layers


@dataclasses.dataclass(frozen=True)
class Assignment:
    req: Request
    layer: int
    acc: int
    use_variant: bool
    est_latency: float  # c_{m,l,k} (or variant) used for the decision


@dataclasses.dataclass
class SchedView:
    """Snapshot handed to a policy at invocation time ``now``.

    Virtual deadlines are carried by the ready :class:`Request` objects
    themselves (``vdl_abs`` when an online budget policy is active, the
    plan's frozen table otherwise), so one view serves both static and
    dynamic budget modes.
    """

    now: float
    ready: List[Request]  # each request exposes exactly one ready layer
    acc_busy_until: np.ndarray  # [n_acc] absolute times
    plans: Sequence[ModelPlan]

    @property
    def n_acc(self) -> int:
        return len(self.acc_busy_until)

    def tau(self, k: int) -> float:
        """Next available time of accelerator k (Eq. 4's tau_k(t))."""
        return max(self.now, float(self.acc_busy_until[k]))

    def idle_accs(self) -> List[int]:
        return [k for k in range(self.n_acc) if self.acc_busy_until[k] <= self.now + 1e-15]


class Scheduler:
    name = "base"
    uses_variants = False

    def schedule(self, view: SchedView) -> List[Assignment]:  # pragma: no cover
        raise NotImplementedError


# ------------------------------------------------------------- helpers ----


def _lat(plan: ModelPlan, layer: int, k: int) -> float:
    return float(plan.lat[layer, k])


def _assign_min_latency(
    view: SchedView, order: List[Request], idle: List[int]
) -> List[Assignment]:
    """Shared FCFS/EDF body: walk ``order``, map each ready layer to the
    idle accelerator with the lowest execution latency for that layer."""
    out: List[Assignment] = []
    idle = list(idle)
    for req in order:
        if not idle:
            break
        plan = view.plans[req.model_idx]
        l = req.next_layer
        k_star = min(idle, key=lambda k: _lat(plan, l, k))
        out.append(Assignment(req, l, k_star, False, _lat(plan, l, k_star)))
        idle.remove(k_star)
    return out


# ---------------------------------------------------------------- FCFS ----


class FcfsScheduler(Scheduler):
    name = "fcfs"

    def schedule(self, view: SchedView) -> List[Assignment]:
        # third tie element: DAG sibling entries share (arrival, rid); the
        # node id totalizes the order (no-op for linear — rids are unique)
        order = sorted(view.ready, key=lambda r: (r.arrival, r.rid, r.next_layer))
        return _assign_min_latency(view, order, view.idle_accs())


# ----------------------------------------------------------------- EDF ----


def edf_layer_deadline(plan: ModelPlan, req: Request, layer: int) -> float:
    """Layer deadline derived from minimum execution times: the request's
    absolute deadline minus the min-latency work remaining after ``layer``
    (the critical path below it, for DAG plans — ``crit_after`` is the
    exact ``remaining_min[layer + 1]`` slice on linear chains)."""
    return req.deadline_abs - plan.crit_after_list[layer]


class EdfScheduler(Scheduler):
    name = "edf"

    def schedule(self, view: SchedView) -> List[Assignment]:
        order = sorted(
            view.ready,
            key=lambda r: (
                edf_layer_deadline(view.plans[r.model_idx], r, r.next_layer),
                r.rid,
                r.next_layer,
            ),
        )
        return _assign_min_latency(view, order, view.idle_accs())


# --------------------------------------------------------------- DREAM ----


class DreamScheduler(Scheduler):
    """Heterogeneity-aware dynamic scheduler (DREAM [1], miss-rate objective).

    # APPROX — re-derived from DREAM's published mechanism with the
    objective reduced to deadline-miss-rate (paper Sec. V-A): ready layers
    are prioritized by least model-level slack (slack uses the
    heterogeneity-aware minimum remaining execution time — DREAM's
    latency-table awareness), and each is mapped eagerly to the idle
    accelerator with the earliest estimated finish.  DREAM has no
    layer-wise virtual deadlines, so it cannot reason about whether
    waiting for a preferred accelerator is safe — the "limited layer-wise
    timing insight" the Terastal paper calls out.
    """

    name = "dream"

    def schedule(self, view: SchedView) -> List[Assignment]:
        idle = view.idle_accs()
        out: List[Assignment] = []

        def slack(r: Request) -> float:
            plan = view.plans[r.model_idx]
            return r.deadline_abs - view.now - plan.crit_from_list[r.next_layer]

        for req in sorted(view.ready, key=lambda r: (slack(r), r.rid, r.next_layer)):
            if not idle:
                break
            plan = view.plans[req.model_idx]
            l = req.next_layer
            k_star = min(idle, key=lambda k: view.tau(k) + _lat(plan, l, k))
            c = _lat(plan, l, k_star)
            out.append(Assignment(req, l, k_star, False, c))
            idle.remove(k_star)
        return out


# ------------------------------------------------------------- Terastal ----


class TerastalScheduler(Scheduler):
    """Algorithm 2 with Eq. 4-9 semantics.

    ``use_budgets=False``  -> "Terastal-no budgeting" (EDF-style virtual
    deadlines derived from minimum execution times).
    ``use_variants=False`` -> "Terastal-no variants".

    ``backfill_mode`` selects the stage-2 guard (the paper's text -
    "each remaining idle accelerator is assigned the layer with the
    highest Delta-s" - is silent on whether a harmful backfill should
    still be taken; unconditional backfill measurably *hurts* Terastal
    below FCFS in several cells, so the paper's intended semantics must
    include a guard):

    * ``"ef"`` (default): a layer may be backfilled onto idle accelerator
      k only when k is earliest-finish-optimal for it across ALL
      accelerators including waiting for busy ones - i.e. idling is
      avoided exactly when it cannot help.  Work-conserving for late
      requests, and never blocks a slow accelerator with a non-preferred
      layer whose preferred accelerator frees up sooner.
    * ``"positive"``: require Delta-s > 0.
    * ``"paper"``: unconditional (the literal text), kept for ablation.
    """

    def __init__(
        self,
        use_budgets: bool = True,
        use_variants: bool = True,
        backfill_mode: str = "ef",
    ):
        assert backfill_mode in ("ef", "positive", "paper")
        self.use_budgets = use_budgets
        self.use_variants = use_variants
        self.backfill_mode = backfill_mode
        self.uses_variants = use_variants
        self.name = {
            (True, True): "terastal",
            (True, False): "terastal_no_variants",
            (False, True): "terastal_no_budgeting",
            (False, False): "terastal_no_budget_no_var",
        }[(use_budgets, use_variants)]

    # -- virtual deadline of a request's ready layer (Eq. 2) ---------------
    def vdl(self, plan: ModelPlan, req: Request, layer: int) -> float:
        if self.use_budgets:
            if req.vdl_abs is not None:  # online policy installed dynamic state
                return float(req.vdl_abs[layer])
            return req.arrival + float(plan.vdl_rel[layer])
        return edf_layer_deadline(plan, req, layer)

    def _variant_ok(self, plan: ModelPlan, req: Request, layer: int) -> bool:
        """LayerVariantFeasible: variant exists and accumulated set stays
        within the valid combination set V_m (downward-closed check)."""
        if not self.use_variants or layer not in plan.variants:
            return False
        return plan.is_valid_combo(req.applied_variants | {layer})

    def schedule(self, view: SchedView) -> List[Assignment]:
        idle: List[int] = view.idle_accs()
        if not idle:
            return []
        tau = np.array([view.tau(k) for k in range(view.n_acc)])
        out: List[Assignment] = []

        ready = list(view.ready)

        def best_case_slack(req: Request) -> float:
            plan = view.plans[req.model_idx]
            l = req.next_layer
            d_v = self.vdl(plan, req, l)
            finishes = tau + plan.lat[l]  # Eq. 4 over all k
            return float(d_v - finishes.min())  # Eq. 6-7

        # ---- stage 1: most-urgent-first, meet virtual deadlines ----------
        order = sorted(ready, key=lambda r: (best_case_slack(r), r.rid, r.next_layer))
        remaining: List[Request] = []
        for req in order:
            plan = view.plans[req.model_idx]
            l = req.next_layer
            d_v = self.vdl(plan, req, l)
            # original layer on an idle accelerator meeting d_v (lines 4-10)
            cands = [k for k in idle if tau[k] + plan.lat[l, k] <= d_v + 1e-15]
            if cands:
                k_star = min(cands, key=lambda k: tau[k] + plan.lat[l, k])
                c = _lat(plan, l, k_star)
                out.append(Assignment(req, l, k_star, False, c))
                idle.remove(k_star)
                tau[k_star] += c  # round-local update (Sec. IV-C)
                continue
            # variant on an idle accelerator meeting d_v (lines 11-18)
            if self._variant_ok(plan, req, l):
                lat_v = plan.lat_var[l]
                cands = [k for k in idle if tau[k] + lat_v[k] <= d_v + 1e-15]
                if cands:
                    k_star = min(cands, key=lambda k: tau[k] + lat_v[k])
                    c = float(lat_v[k_star])
                    out.append(Assignment(req, l, k_star, True, c))
                    idle.remove(k_star)
                    tau[k_star] += c
                    continue
            remaining.append(req)

        # ---- stage 2: backfill remaining idle accelerators (lines 19-23) -
        for k in list(idle):
            if not remaining:
                break
            best: Optional[Tuple[float, int, Request, bool, float]] = None
            for req in remaining:
                plan = view.plans[req.model_idx]
                l = req.next_layer
                s_star = best_case_slack(req)
                for use_var in (False, True):
                    if use_var:
                        if not self._variant_ok(plan, req, l):
                            continue
                        row = plan.lat_var[l]
                    else:
                        row = plan.lat[l]
                    c = float(row[k])
                    if not np.isfinite(c):
                        continue
                    finish = tau[k] + c
                    if self.backfill_mode == "ef":
                        # guard: k must be earliest-finish-optimal for this
                        # implementation across all accelerators (incl.
                        # waiting for busy ones) — idle only when it helps.
                        ef_all = float((tau + row).min())
                        if finish > ef_all + 1e-15:
                            continue
                    # Eq. 8: future potential slack for the NEXT layer.  On a DAG
                    # the "next layer" is the BINDING successor — the one
                    # with the tightest (vdl - min_lat) target, which is
                    # finish-independent (lowest node id on ties); the sink
                    # has no successor and falls back to the request
                    # deadline exactly like a linear chain's last layer.
                    if plan.dag is not None:
                        s_next = binding_successor(self, plan, req, l)
                        if s_next >= 0:
                            d_v_next = self.vdl(plan, req, s_next)
                            s_f = d_v_next - finish - plan.min_lat_list[s_next]
                        else:
                            s_f = req.deadline_abs - finish
                    elif l + 1 < len(plan.model.layers):
                        d_v_next = self.vdl(plan, req, l + 1)
                        s_f = d_v_next - finish - float(plan.lat[l + 1].min())
                    else:
                        s_f = req.deadline_abs - finish
                    delta = s_f - s_star  # Eq. 9
                    key = (delta, -int(use_var))  # prefer original on ties
                    if best is None or key > (best[0], -int(best[3])):
                        best = (delta, l, req, use_var, c)
            if best is None:
                continue
            if self.backfill_mode == "positive" and best[0] <= 0.0:
                continue
            _, l, req, use_var, c = best
            out.append(Assignment(req, l, k, use_var, c))
            tau[k] += c
            remaining.remove(req)
        return out


def binding_successor(
    sched: TerastalScheduler, plan: ModelPlan, req: Request, layer: int
) -> int:
    """The successor node whose virtual-deadline target ``vdl(s) -
    min_lat(s)`` is tightest — the one Eq. 8's future-slack term binds on
    for a DAG node.  Finish-independent (so the SoA engine can cache the
    winning ``(vdl, min_lat)`` pair per slot); lowest node id on float
    ties (the scan keeps the first minimum).  Returns -1 at the sink."""
    best = -1
    bv = 0.0
    for s in plan.dag.succs[layer]:
        v = sched.vdl(plan, req, s) - plan.min_lat_list[s]
        if best < 0 or v < bv:
            bv, best = v, s
    return best


# ---------------------------------------------------------------- registry -


def make_scheduler(name: str) -> Scheduler:
    """Build a scheduler from a name or call-spec string.

    Plain names (``"edf"``, ``"terastal"``, ablation aliases) behave as
    before; Terastal variants additionally accept keyword call-specs —
    e.g. ``"terastal(backfill_mode=paper)"`` — so campaign grids can
    sweep policy knobs without constructing instances by hand.
    """
    from repro_torch.core.specs import parse_call_spec

    name, kwargs = parse_call_spec(name.lower())
    terastal_flags = {
        "terastal": (True, True),
        "terastal_no_variants": (True, False),
        "no_variants": (True, False),
        "terastal_no_budgeting": (False, True),
        "no_budgeting": (False, True),
    }
    baselines = {"fcfs": FcfsScheduler, "edf": EdfScheduler, "dream": DreamScheduler}
    if name not in terastal_flags and name not in baselines:
        raise KeyError(f"unknown scheduler '{name}'")
    if name in baselines:
        if kwargs:
            raise KeyError(f"scheduler '{name}' takes no keyword spec arguments")
        return baselines[name]()
    return TerastalScheduler(*terastal_flags[name], **kwargs)


ALL_SCHEDULERS = (
    "fcfs",
    "edf",
    "dream",
    "terastal_no_budgeting",
    "terastal_no_variants",
    "terastal",
)
