"""Accelerator fault injection (platform degradation axis).

A :class:`FaultModel` attaches deterministic, seed-derived fault
processes to the platform's accelerators:

* ``down(acc=K,start=S,duration=D)`` — transient dropout: accelerator K
  is unavailable over ``[S, S+D)``;
* ``throttle(acc=K,start=S,duration=D,factor=F)`` — thermal throttling:
  K's latency column is multiplied by F over the window;
* ``permanent(acc=K,start=S)`` — K fails at S and never recovers;
* ``intermittent(acc=K,rate=R,mean_down=M)`` — a seed-derived renewal
  process: exponential time-to-failure at rate R failures/s, each outage
  exponential with mean M seconds (drawn from a PRNG stream salted away
  from the arrival streams, so adding faults never perturbs arrivals).

Fault windows resolve (per trial, via :meth:`FaultModel.timeline`) into
timestamped capability events — ``down`` / ``up`` / ``scale`` — that both
bit-parity engines merge into their event heaps exactly like arrivals.
On a ``down`` the accelerator's in-flight layer is evicted and re-enqueued
under the model's interrupted-work policy (``restart`` re-executes the
layer from scratch; ``resume`` carries the completed fraction over to the
next dispatch).  Schedulers see faults as masked / reweighted latency
columns (:func:`effective_plans`): a down accelerator is "busy forever"
and its columns are ``+inf``, a throttled one costs ``factor`` x nominal —
so Terastal's variant selection becomes the graceful-degradation lever
while FCFS/EDF/DREAM get the same masking without the variant escape
hatch.

Grid axes carry fault models as call-spec strings (picklable, printable):
a single spec, or several joined with ``+`` —
``"down(acc=0,start=0.1,duration=0.2)+throttle(acc=1,start=0.1,duration=0.3,factor=2)"``.
An ``interrupted=restart|resume`` kwarg on any component sets the
model-wide policy.  ``"none"`` (or an empty model) is the fault-free
identity and is bit-identical to the pre-fault-axis simulator.

A ``retighten=true`` kwarg (model-wide, like ``interrupted=``) turns on
fault-aware budget re-tightening and degraded-capacity admission: on
every capability event both engines re-run the Algorithm-1 tightening
kernel over the *effective* latency tables (:func:`retightened_vdl`),
rebind every live request's absolute virtual-deadline chain, and
recompute the admission layer's minimum-work estimates
(:func:`degraded_work_tables`) so ``shed_early`` / ``token_bucket``
judge against the capacity that actually exists.  With the flag off
(the default) budgets and admission stay frozen at nominal capability —
bit-identical to the original fault axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.specs import format_call_spec, parse_call_spec

FAULT_KINDS = ("down", "throttle", "permanent", "intermittent")
INTERRUPTED_POLICIES = ("restart", "resume")

# PRNG salt for intermittent fault streams; disjoint from the arrival
# salts in repro_torch.core.simulator so fault draws never shift arrivals.
_FAULT_SALT = 0x5EED_FA17


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault process on one accelerator (see module doc for kinds)."""

    kind: str
    acc: int
    start: float = 0.0
    duration: float = math.inf
    factor: float = 1.0
    rate: float = 0.0  # intermittent: failures per second
    mean_down: float = 0.0  # intermittent: mean outage length (s)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of {FAULT_KINDS}"
            )
        if not isinstance(self.acc, int) or isinstance(self.acc, bool) or self.acc < 0:
            raise ValueError(f"fault acc must be a non-negative int, got {self.acc!r}")
        for field in ("start", "duration", "factor", "rate", "mean_down"):
            v = getattr(self, field)
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                raise ValueError(f"fault {field} must be a number, got {v!r}")
            if math.isnan(v) or v < 0:
                raise ValueError(f"fault {field} must be >= 0 and not NaN, got {v!r}")
        if self.kind == "throttle" and (
            self.factor <= 0 or not math.isfinite(self.factor)
        ):
            raise ValueError(f"throttle factor must be finite and > 0, got {self.factor!r}")
        if self.kind == "intermittent":
            if not math.isfinite(self.rate) or self.rate <= 0:
                raise ValueError(
                    f"intermittent rate must be finite and > 0, got {self.rate!r}"
                )
            if not math.isfinite(self.mean_down) or self.mean_down <= 0:
                raise ValueError(
                    f"intermittent mean_down must be finite and > 0, got {self.mean_down!r}"
                )
        elif self.kind != "permanent" and not math.isfinite(self.duration):
            raise ValueError(
                f"{self.kind} duration must be finite, got {self.duration!r}"
            )

    @property
    def end(self) -> float:
        """Window end (``inf`` for permanent failures)."""
        if self.kind == "permanent":
            return math.inf
        return self.start + self.duration

    def format(self) -> str:
        kw: Dict[str, object] = {"acc": self.acc}
        if self.kind == "intermittent":
            kw.update(rate=self.rate, mean_down=self.mean_down)
        else:
            kw["start"] = self.start
            if self.kind != "permanent":
                kw["duration"] = self.duration
            if self.kind == "throttle":
                kw["factor"] = self.factor
        return format_call_spec(self.kind, kw)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One capability transition, merged into the engines' event heaps."""

    t: float
    acc: int
    code: str  # "down" | "up" | "scale"
    value: float = 1.0  # scale: the new latency multiplier


@dataclasses.dataclass(frozen=True)
class FaultModel:
    faults: Tuple[FaultSpec, ...] = ()
    interrupted: str = "restart"
    #: fault-aware budget re-tightening + degraded-capacity admission
    #: (module doc).  False = budgets/admission frozen at nominal
    #: capability, bit-identical to the original fault axis.
    retighten: bool = False

    def __post_init__(self):
        if self.interrupted not in INTERRUPTED_POLICIES:
            raise ValueError(
                f"unknown interrupted-work policy {self.interrupted!r}; "
                f"expected one of {INTERRUPTED_POLICIES}"
            )
        if not isinstance(self.retighten, bool):
            raise ValueError(
                f"retighten must be a bool, got {self.retighten!r}"
            )
        # Windows on one accelerator must be unambiguous: deterministic
        # windows pairwise disjoint (a second permanent failure — or any
        # window at/after one — "overlaps" its infinite tail), and an
        # intermittent process owns its accelerator outright (its windows
        # are seed-dependent, so static disjointness cannot be checked
        # against anything else).
        by_acc: Dict[int, List[FaultSpec]] = {}
        for f in self.faults:
            by_acc.setdefault(f.acc, []).append(f)
        for acc, specs in by_acc.items():
            if any(f.kind == "intermittent" for f in specs) and len(specs) > 1:
                raise ValueError(
                    f"accelerator {acc}: an intermittent fault cannot be "
                    "combined with other faults on the same accelerator"
                )
            windows = sorted((f.start, f.end, f.kind) for f in specs)
            for (s0, e0, k0), (s1, e1, k1) in zip(windows, windows[1:]):
                if s1 < e0:
                    what = (
                        "overlapping permanent failures"
                        if k0 == "permanent" and k1 == "permanent"
                        else f"overlapping fault windows ({k0} and {k1})"
                    )
                    raise ValueError(
                        f"accelerator {acc}: {what} — "
                        f"[{s0}, {e0}) intersects [{s1}, {e1})"
                    )

    @property
    def active(self) -> bool:
        return bool(self.faults)

    def max_acc(self) -> int:
        return max((f.acc for f in self.faults), default=-1)

    def format(self) -> str:
        if not self.faults:
            return "none"
        parts = [f.format() for f in self.faults]
        extra: Dict[str, object] = {}
        if self.interrupted != "restart":
            extra["interrupted"] = self.interrupted
        if self.retighten:
            extra["retighten"] = True
        if extra:
            head, kw = parse_call_spec(parts[0])
            kw.update(extra)
            parts[0] = format_call_spec(head, kw)
        return "+".join(parts)

    def _windows(self, spec: FaultSpec, duration: float, seed: int) -> List[Tuple[float, float]]:
        """Concrete fault windows of one spec within ``[0, duration)``."""
        if spec.kind == "intermittent":
            # Renewal process: Exp(rate) up-time, Exp(1/mean_down) outage.
            # Seeded off (salt, trial seed, accelerator) so every trial
            # seed draws an independent but reproducible outage pattern.
            rng = np.random.default_rng([_FAULT_SALT, seed, spec.acc])
            out: List[Tuple[float, float]] = []
            t = 0.0
            while True:
                t += float(rng.exponential(1.0 / spec.rate))
                if t >= duration:
                    return out
                d = float(rng.exponential(spec.mean_down))
                out.append((t, t + d))
                t += d
        if spec.start >= duration:
            return []
        return [(spec.start, spec.end)]

    def timeline(
        self, n_acc: int, duration: float, seed: int
    ) -> Tuple[List[FaultEvent], int]:
        """Resolve to ``(capability events sorted by time, n_spans)``.

        ``n_spans`` counts the fault windows intersecting the horizon
        (the trial's ``SimResult.faulted_spans``).  Closing ``up`` /
        ``scale 1.0`` events may land past the horizon — the event loops
        drain them exactly like post-horizon layer finishes.
        """
        for f in self.faults:
            if f.acc >= n_acc:
                raise ValueError(
                    f"fault acc {f.acc} out of range for a platform with "
                    f"{n_acc} accelerators"
                )
        events: List[FaultEvent] = []
        n_spans = 0
        for f in self.faults:
            throttled = f.kind == "throttle"
            for s, e in self._windows(f, duration, seed):
                n_spans += 1
                if throttled:
                    events.append(FaultEvent(s, f.acc, "scale", f.factor))
                    events.append(FaultEvent(e, f.acc, "scale", 1.0))
                else:
                    events.append(FaultEvent(s, f.acc, "down"))
                    if math.isfinite(e):
                        events.append(FaultEvent(e, f.acc, "up"))
        # Stable by time: same-timestamp events keep spec order, so both
        # engines process identical sequences (heap counters follow this
        # list order).
        events.sort(key=lambda ev: ev.t)
        return events, n_spans


def make_fault_model(
    spec: Union[str, FaultModel, None]
) -> Optional[FaultModel]:
    """``"none"`` / ``None`` -> None; a ``+``-joined call-spec string (or a
    ready FaultModel) -> a validated :class:`FaultModel`.

    Raises ``ValueError`` on unknown kinds, malformed numbers
    (negative/NaN rates or durations), overlapping windows, or an unknown
    ``interrupted=`` policy.
    """
    if spec is None or isinstance(spec, FaultModel):
        return spec if spec is not None and spec.active else None
    if not isinstance(spec, str):
        raise ValueError(f"fault spec must be a string or FaultModel, got {spec!r}")
    if spec.strip() in ("", "none"):
        return None
    faults: List[FaultSpec] = []
    interrupted: Optional[str] = None
    retighten: Optional[bool] = None
    for part in spec.split("+"):
        name, kwargs = parse_call_spec(part)
        pol = kwargs.pop("interrupted", None)
        if pol is not None:
            if interrupted is not None and pol != interrupted:
                raise ValueError(
                    f"fault spec {spec!r}: conflicting interrupted= policies "
                    f"({interrupted!r} vs {pol!r})"
                )
            interrupted = pol
        rt = kwargs.pop("retighten", None)
        if rt is not None:
            if not isinstance(rt, bool):
                raise ValueError(
                    f"fault spec {spec!r}: retighten= must be true or false, "
                    f"got {rt!r}"
                )
            if retighten is not None and rt != retighten:
                raise ValueError(
                    f"fault spec {spec!r}: conflicting retighten= values"
                )
            retighten = rt
        if name not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {name!r} in {spec!r}; expected one of "
                f"{FAULT_KINDS}"
            )
        try:
            faults.append(FaultSpec(kind=name, **kwargs))
        except TypeError as e:
            raise ValueError(f"fault spec {part!r}: {e}") from e
    return FaultModel(
        faults=tuple(faults),
        interrupted=interrupted or "restart",
        retighten=bool(retighten),
    )


# ------------------------------------------------ capability masking ----


def fault_multipliers(scale: Sequence[float], avail: Sequence[bool]) -> np.ndarray:
    """[n_acc] latency multipliers: ``scale`` where up, ``+inf`` where down."""
    return np.array(
        [s if a else math.inf for s, a in zip(scale, avail)], dtype=float
    )


def effective_plans(plans: Sequence, mult: np.ndarray) -> List:
    """Fault-adjusted copies of the offline plans.

    Original and variant latency columns are multiplied by ``mult``
    (``+inf`` masks a down accelerator), so every derived table —
    ``remaining_min`` (drop test), ``min_lat`` (backfill), EDF keys,
    FCFS/EDF placement preferences — re-derives under the degraded
    capability.  Budgets, deadlines, and accuracy losses are untouched.
    Both engines build their working tables from the same helper, so
    fault-time arithmetic is bit-identical by construction.
    """
    if np.all(mult == 1.0):
        return list(plans)
    out = []
    for p in plans:
        variants = {
            idx: dataclasses.replace(v, latencies=v.latencies * mult)
            for idx, v in p.variants.items()
        }
        out.append(dataclasses.replace(p, lat=p.lat * mult, variants=variants))
    return out


def retightened_vdl(plans: Sequence, eff_plans: Sequence) -> List[Optional[np.ndarray]]:
    """Per-model re-tightened RELATIVE virtual-deadline chains under the
    current capability (``retighten=true`` — module doc).

    Re-runs the Algorithm-1 tightening kernel over each plan's
    *effective* latency table: :func:`~repro_torch.core.budget.tighten_budgets`
    on linear chains, :func:`~repro_torch.core.budget.tighten_budgets_dag` on
    DAG plans (critical-path re-tightening over the masked tables, so
    virtual deadlines stay strictly increasing along every edge whenever
    the tightening is feasible).  Returns one entry per model:

    * ``None`` — keep the frozen offline chain.  Either capability is
      nominal for this model (``eff is plan``, the ``effective_plans``
      identity fast path, where recomputing would reproduce the offline
      chain bit-for-bit anyway) or the degraded table is infeasible even
      fully tightened (e.g. every accelerator down) — deterministically
      fall back to the offline schedule and let early-drop triage.
    * an ``[L]`` float64 array — the re-tightened relative chain; both
      engines rebind every live request to ``arrival + chain``.

    Shared by the reference, SoA, and batch engines so fault-time budget
    arithmetic is bit-identical by construction.
    """
    from repro_torch.core.budget import latency_levels, tighten_budgets, tighten_budgets_dag

    out: List[Optional[np.ndarray]] = []
    for p, ep in zip(plans, eff_plans):
        if ep is p:  # nominal capability: effective_plans identity fast path
            out.append(None)
            continue
        levels = [latency_levels(ep.lat[l]) for l in range(ep.lat.shape[0])]
        if p.dag is not None:
            res = tighten_budgets_dag(levels, p.deadline, p.dag)
        else:
            res = tighten_budgets(levels, p.deadline)
        out.append(res.virtual_deadlines if res.feasible else None)
    return out


def degraded_work_tables(
    eff_plans: Sequence, duration: float
) -> Tuple[List[float], List[int]]:
    """Admission work estimates under the current capability
    (``retighten=true``): per-model ``(min_work_s, work_ns)`` from the
    *effective* critical-path totals, replacing the frozen nominal values
    so ``shed_early`` / ``token_bucket`` judge against real capacity.

    A model with no live accelerator has ``crit_total == inf``: admission
    then rejects every release (``inf`` compares correctly in the float
    test), and its integer backlog weight is clamped to the horizon so
    ``int(round(...))`` stays finite.  At nominal capability the values
    are bit-identical to the frozen tables (same floats, same rounding).
    """
    min_work_s = [p.crit_total for p in eff_plans]
    work_ns = [
        int(round((w if math.isfinite(w) else duration) * 1e9))
        for w in min_work_s
    ]
    return min_work_s, work_ns


def evict_busy_adjust(
    t0: float, now: float, duration: float, disp_w: float, disp_h: float
) -> Tuple[float, float]:
    """Busy-time deltas when an in-flight dispatch ends early at ``now``.

    ``disp_w``/``disp_h`` are the wall / in-horizon amounts currently
    credited for the dispatch that started at ``t0``.  Shared by both
    engines so the float arithmetic matches bit-for-bit.
    """
    new_w = now - t0
    new_h = min(new_w, max(0.0, duration - t0))
    return new_w - disp_w, new_h - disp_h


def retime_busy_adjust(
    t0: float, fin_new: float, duration: float, disp_w: float, disp_h: float
) -> Tuple[float, float, float, float]:
    """Busy-time deltas (and new credited amounts) when a throttle change
    re-times an in-flight dispatch to finish at ``fin_new``."""
    new_w = fin_new - t0
    new_h = min(new_w, max(0.0, duration - t0))
    return new_w - disp_w, new_h - disp_h, new_w, new_h
