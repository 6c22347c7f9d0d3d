"""Online virtual-budget policies: per-request budgets as runtime state.

The offline stage (Algorithm 1) freezes one ``vdl_rel`` table per model,
calibrated for periodic releases.  This module makes virtual budgets
*mutable per-request state*: every policy manipulates ``Request.vdl_abs``
(absolute per-layer virtual deadlines) through the same incremental
tightening kernel the offline algorithm uses
(:func:`repro_torch.core.budget.tighten_budgets`), re-distributing the
*remaining* deadline over the *remaining* layers.

Fidelity notes
--------------
* ``static`` is the paper: budgets are assigned offline by Algorithm 1
  and never touched again.  It leaves ``Request.vdl_abs`` unset, so the
  schedulers read the frozen ``ModelPlan.vdl_rel`` table and the
  simulator is bit-identical to the seed/PR-1 implementation (pinned by
  ``tests/test_budget_online.py``).
* ``reclaim`` — # APPROX (beyond paper): when a layer finishes ahead of
  its virtual deadline, the unused slack is pushed into the downstream
  layers' budgets by re-running the proportional distribution over the
  remaining layers at the request's *current* constraint levels (the
  kernel with ``rho0 = rho_offline``).  Slack reclamation is the
  standard bridge from static budgets to dynamic workloads in the
  real-time literature (arXiv:2505.11970, PAPERS.md); the proportional
  form is ours, chosen so ``static`` is the exact fixed point when every
  layer finishes precisely on its virtual deadline.
* ``adaptive`` — # APPROX (beyond paper): burst-gated, skew-gated
  reclamation with a staleness-repair controller.  A release-rate
  detector keeps the policy *exactly static* under the paper's periodic
  regime (and plain Poisson); inside detected bursts, reclaimed
  (tightened) milestones are applied only to layers whose
  cross-accelerator latency skew makes a mis-placement catastrophic,
  and controller ticks restore any reclaimed chain that observed
  congestion has made unattainable back to the offline kernel
  distribution.  This is the "budget re-distribution under observed
  burstiness" item from ROADMAP.md; every gate and threshold here is an
  engineering choice validated by `benchmarks/fig8_adaptive_budgets.py`,
  not from the paper.  A design fact the gates rest on (pinned by the
  ``monotone`` regression test): the static absolute chain is the
  loosest member of the re-anchoring family, so every online move is a
  *tightening* whose value depends on which placements it revokes.

Invariants (all policies, property-tested): a request's remaining
budgets always sum to at most its remaining deadline, and no layer's
budget ever falls below that layer's minimum achievable latency.  A
re-distribution that would be infeasible leaves the request's state
unchanged — the simulator's early-drop then handles it, exactly as for
static budgets.
"""

from __future__ import annotations

import collections
import inspect
from typing import Deque, Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.budget import tighten_budgets
from repro_torch.core.scheduler import Request
from repro_torch.core.variants import ModelPlan


class BudgetPolicy:
    """Hooks the event-driven simulator invokes around budget state.

    ``tick_interval == 0`` disables controller ticks; the base class is
    fully inert (no per-request state is ever created), which is exactly
    the ``static`` policy.

    Contract for implementations: a chain update must REBIND
    ``req.vdl_abs`` (assign a fresh array), never mutate the existing
    array in place.  All built-ins do; the SoA simulation engine
    (``repro_torch.core.engine_soa``) relies on object identity to detect
    which cached virtual-deadline scalars a hook invalidated, and the
    reference engine's ``reclaim``/``adaptive`` semantics (``is``
    comparisons in :meth:`AdaptiveBudgetPolicy.on_layer_finish`) already
    assume it.
    """

    name = "static"
    tick_interval: float = 0.0

    def reset(self) -> None:
        """Clear any cross-run state.  ``simulate()`` calls this before
        every run so one policy instance can be reused across seeds
        without leaking burst-detector or cache state between runs."""

    def on_release(self, req: Request, plan: ModelPlan, now: float) -> None:
        """Request released at ``now``: initialize its budget state."""

    def on_layer_finish(self, req: Request, plan: ModelPlan, layer: int, now: float) -> None:
        """Layer ``layer`` of ``req`` finished at ``now`` (request not done)."""

    def on_tick(
        self,
        now: float,
        ready: List[Request],
        plans: Sequence[ModelPlan],
        acc_busy_until: np.ndarray,
    ) -> None:
        """Periodic controller tick over the queued (ready) requests."""

    def on_capability(
        self,
        now: float,
        ready: List[Request],
        plans: Sequence[ModelPlan],
        eff_plans: Sequence[ModelPlan],
        acc_busy_until: np.ndarray,
    ) -> None:
        """Capability event at ``now`` (accelerator down/up/throttle —
        ``repro_torch.core.faults``): the fourth hook, alongside on-release /
        on-layer-finish / on-tick.  Both engines invoke it after the
        fault handler swapped its effective tables (``eff_plans`` are the
        capability-masked plan copies; ``plans`` the offline originals)
        and — under ``retighten=true`` — after the engine rebound every
        live request's ``vdl_abs`` to the re-tightened chain.  The REBIND
        contract applies here too: chain updates must assign a fresh
        array so the SoA engine's identity check catches them.  The base
        policy ignores capability events (budgets stay as they are)."""


class StaticBudgetPolicy(BudgetPolicy):
    """The paper's offline budgets, untouched at runtime."""

    name = "static"


def _rebase(
    req: Request, l0: int, now: float, budgets: np.ndarray, monotone: bool = False
) -> None:
    """Write absolute virtual deadlines for layers >= l0 from ``now``.

    ``monotone=True`` takes the elementwise max with the current chain:
    milestones only ever loosen, so stage-1 admissions can only widen
    relative to the schedule already in force.
    """
    vdl = req.vdl_abs.copy()
    chain = now + np.cumsum(budgets)
    vdl[l0:] = np.maximum(vdl[l0:], chain) if monotone else chain
    req.vdl_abs = vdl


class ReclaimBudgetPolicy(BudgetPolicy):
    """Push slack from early layer finishes into downstream budgets.

    The re-distribution re-anchors the remaining budget chain at the
    actual finish time: each downstream layer's budget grows, while the
    near-term virtual deadlines tighten relative to the stale offline
    schedule (the chain no longer starts at the missed-by-a-mile offline
    milestone).  ``spread`` in [0, 1] controls how much of the remaining
    deadline beyond the constraint-level floor flows into the budgets:
    1 = full proportional re-distribution, 0 = budgets pinned at the
    constraint levels (maximally tight — every placement that cannot
    match the constraint-level pace is pushed to the earliest-finish-
    guarded backfill stage).
    """

    name = "reclaim"

    def __init__(self, spread: float = 1.0, min_slack: float = 0.0, monotone: bool = False):
        if not 0.0 <= spread <= 1.0:
            raise ValueError(f"spread must be in [0, 1], got {spread}")
        if not 0.0 <= min_slack < 1.0:
            raise ValueError(f"min_slack must be in [0, 1), got {min_slack}")
        self.spread = float(spread)
        self.min_slack = float(min_slack)
        self.monotone = bool(monotone)

    def _has_slack(self, plan: ModelPlan) -> bool:
        """Reclaim only models whose offline schedule actually has slack:
        when minimum execution already consumes most of the deadline,
        there is nothing meaningful to reclaim and re-anchoring the
        nearly-slackless chain only tightens its milestones."""
        if self.min_slack <= 0.0:
            return True
        return 1.0 - float(plan.min_lat.sum()) / plan.deadline >= self.min_slack

    def _spread_budgets(self, res, remaining: float) -> np.ndarray:
        """Blend kernel budgets between the constraint-level floor
        (spread=0) and the full proportional distribution (spread=1)."""
        c_total = float(res.c_ref.sum())
        return res.c_ref * (1.0 + self.spread * (remaining - c_total) / c_total)

    def on_release(self, req: Request, plan: ModelPlan, now: float) -> None:
        if plan.budget.feasible:
            req.vdl_abs = req.arrival + plan.vdl_rel  # fresh array per request

    def on_layer_finish(self, req: Request, plan: ModelPlan, layer: int, now: float) -> None:
        if req.vdl_abs is None or not self._has_slack(plan):
            return
        l0 = layer + 1
        if l0 >= len(plan.model.layers):
            return
        if now >= float(req.vdl_abs[layer]) - 1e-15:
            return  # finished at/after its virtual deadline: nothing to reclaim
        remaining = req.deadline_abs - now
        res = tighten_budgets(
            plan.budget.levels[l0:],
            remaining,
            rho0=plan.budget.rho[l0:],
        )
        # always feasible: remaining exceeds the current downstream budgets,
        # each of which is at least its layer's minimum latency
        if res.feasible:
            _rebase(req, l0, now, self._spread_budgets(res, remaining), self.monotone)


class AdaptiveBudgetPolicy(ReclaimBudgetPolicy):
    """Skew-gated reclamation plus a staleness-repair controller.

    Reclamation only ever *tightens* virtual-deadline milestones relative
    to the offline schedule (the static absolute chain is the loosest
    member of the re-anchoring family — pinned by the ``monotone``
    regression test).  Whether a tighter milestone helps depends on the
    layer: it revokes stage-1 admission to the accelerators the offline
    constraint level tolerated, pushing the placement into Algorithm 2's
    earliest-finish-guarded backfill.  That is a win exactly where a
    mis-placement is expensive — layers whose cross-accelerator latency
    skew is catastrophic — and measurably a loss where second-choice
    accelerators are mildly slower but productive.  ``adaptive``
    therefore applies the reclaimed (tightened) milestones only to
    layers with ``max/min`` latency skew at least ``skew_min``; all
    other layers keep their offline milestones, with per-layer minimum
    latencies enforced across the mixed chain.

    Both moves are gated on *observed burstiness*: a detector compares
    the release rate over the last ``window`` releases against the
    long-run mean rate (both observable through ``on_release``).  While
    the recent rate stays below ``burst`` x the mean — the paper's
    periodic regime, or plain Poisson — the policy is exactly static,
    where the offline calibration is provably good.  Inside a burst the
    skew-gated reclamation engages.

    The controller tick is the repair loop: a reclaimed chain whose
    current milestone congestion has made unattainable (stale — below
    ``now`` plus the layer's fastest implementation) is restored to the
    offline kernel distribution, so requests that fell behind re-enter
    the exact triage order the offline schedule defines.
    """

    name = "adaptive"

    def __init__(
        self,
        tick: float = 0.01,
        spread: float = 1.0,
        min_slack: float = 0.0,
        skew_min: float = 10.0,
        reset_stale: bool = True,
        burst: float = 1.5,
        window: int = 32,
    ):
        super().__init__(spread=spread, min_slack=min_slack)
        if tick <= 0.0:
            raise ValueError(f"adaptive budget policy needs tick > 0, got {tick}")
        if skew_min < 1.0:
            raise ValueError(f"skew_min must be >= 1, got {skew_min}")
        if burst < 1.0:
            raise ValueError(f"burst threshold must be >= 1, got {burst}")
        if window < 2:
            raise ValueError(f"window must be >= 2 releases, got {window}")
        self.tick_interval = float(tick)
        self.skew_min = float(skew_min)
        self.reset_stale = bool(reset_stale)
        self.burst = float(burst)
        self.window = int(window)
        self.reset()

    def reset(self) -> None:
        self._recent: Deque[float] = collections.deque(maxlen=self.window)
        self._released = 0
        self._t0: Optional[float] = None

    # -- burst detector ----------------------------------------------------
    def on_release(self, req: Request, plan: ModelPlan, now: float) -> None:
        super().on_release(req, plan, now)
        if self._t0 is None:
            self._t0 = now
        self._released += 1
        self._recent.append(now)

    def bursting(self, now: float) -> bool:
        """Recent release rate exceeds ``burst`` x the long-run mean."""
        if len(self._recent) < self.window or self._t0 is None:
            return False
        elapsed = now - self._t0
        span = now - self._recent[0]
        if elapsed <= 0.0 or span <= 0.0:
            return False
        return (len(self._recent) / span) > self.burst * (self._released / elapsed)

    # -- burst-gated, skew-gated reclamation -------------------------------
    def on_layer_finish(self, req: Request, plan: ModelPlan, layer: int, now: float) -> None:
        if not self.bursting(now):
            return
        before = req.vdl_abs
        super().on_layer_finish(req, plan, layer, now)
        if req.vdl_abs is before or req.vdl_abs is None:
            return  # no reclamation happened
        # skew gate: tightened milestones only where mis-placement is
        # catastrophic; offline milestones elsewhere.  Walk the chain to
        # keep it monotone with every budget >= the layer minimum.
        l0 = layer + 1
        skew = plan.lat_skew
        static_abs = req.arrival + plan.vdl_rel
        mixed = req.vdl_abs.copy()
        prev = now
        for l in range(l0, len(mixed)):
            target = mixed[l] if skew[l] >= self.skew_min else static_abs[l]
            prev = max(target, prev + float(plan.min_lat[l]))
            mixed[l] = prev
        req.vdl_abs = mixed

    def on_tick(
        self,
        now: float,
        ready: List[Request],
        plans: Sequence[ModelPlan],
        acc_busy_until: np.ndarray,
    ) -> None:
        if not self.reset_stale:
            return
        for req in ready:
            if req.vdl_abs is None:
                continue
            plan = plans[req.model_idx]
            l0 = req.next_layer
            static0 = req.arrival + float(plan.vdl_rel[l0])
            cur = float(req.vdl_abs[l0])
            if cur >= static0 - 1e-15:
                continue  # chain is not tightened: nothing to repair
            if cur < now + float(plan.min_lat_any[l0]):
                # reclaimed milestone went stale: restore the offline
                # kernel distribution (Algorithm 1's budgets, anchored at
                # arrival) so the request rejoins the static triage order
                req.vdl_abs = req.arrival + plan.vdl_rel


BUDGET_POLICIES = {
    "static": StaticBudgetPolicy,
    "reclaim": ReclaimBudgetPolicy,
    "adaptive": AdaptiveBudgetPolicy,
}


def make_budget_policy(spec: Union[str, BudgetPolicy, None]) -> BudgetPolicy:
    """Build a :class:`BudgetPolicy` from a call-spec string.

    ``"static"``, ``"reclaim"``, ``"adaptive"``,
    ``"adaptive(tick=0.02,skew_min=5)"`` ...; instances pass through
    unchanged and ``None`` means static (the paper's offline budgets).
    """
    from repro_torch.core.specs import parse_call_spec

    if spec is None:
        return StaticBudgetPolicy()
    if isinstance(spec, BudgetPolicy):
        return spec
    name, kwargs = parse_call_spec(spec)
    if name not in BUDGET_POLICIES:
        raise KeyError(
            f"unknown budget policy '{name}' (have {sorted(BUDGET_POLICIES)})"
        )
    cls = BUDGET_POLICIES[name]
    try:
        return cls(**kwargs)
    except TypeError as e:
        params = sorted(set(inspect.signature(cls.__init__).parameters) - {"self"})
        raise ValueError(
            f"bad arguments for budget policy '{name}': {e}; "
            f"valid parameters: {params or 'none'}"
        ) from e
