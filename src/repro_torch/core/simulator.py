"""Event-driven multi-accelerator, multi-DNN inference simulator.

Semantics follow Sec. IV of the paper exactly:

* Layer-granularity, non-preemptive jobs; decisions only at layer
  boundaries.  The scheduler is invoked whenever an accelerator becomes
  idle (layer finish) and at request arrivals.
* All accelerators share on-chip memory, so consecutive layers of one
  request may run on different accelerators with no migration penalty
  beyond what the latency model already charges.
* Per-layer latencies are deterministic constants from the offline
  profile (original and variant tables in the :class:`ModelPlan`).
* Early-drop (all policies): a request whose remaining minimum execution
  time can no longer meet its absolute deadline is dropped (counts as a
  miss) to free resources.
* Periodic tasks: request ``j`` of model ``m`` arrives at ``j / fps`` (a
  task with ``prob < 1`` fires each period with that probability — the
  Hand S/P "Prob: 0.5" entry of Table II), with relative deadline
  ``D_m = 1 / fps``.

Torch port: a copy of the JAX package's ``core/simulator.py`` whose
:func:`simulate` also takes ``device``, the torch device of the
batched engine and of the SoA engine's device round.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import os
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple, Union

if TYPE_CHECKING:  # annotation only; the runtime import is lazy in simulate()
    from repro_torch.core.admission import AdmissionPolicy
    from repro_torch.core.budget_online import BudgetPolicy
    from repro_torch.core.faults import FaultModel

import numpy as np

from repro_torch.core.dag import DagRun
from repro_torch.core.scheduler import Assignment, Request, SchedView, Scheduler
from repro_torch.core.specs import parse_call_spec
from repro_torch.core.variants import ModelPlan


# ----------------------------------------------------------- arrivals ----
#
# The seed simulator hard-coded strictly periodic releases.  Real traffic
# is not periodic (DREAM-style multi-tenant traces are bursty), and the
# Monte-Carlo campaign engine sweeps arrival models as a grid dimension,
# so arrival generation is a pluggable strategy.  All processes draw from
# ONE shared per-trial rng stream, consumed in task order — with the
# default PeriodicArrivals this makes `generate_arrivals` bit-identical
# to the seed implementation (pinned by tests/test_campaign.py).


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """Generates arrival times for one task over ``[0, duration)``.

    Subclasses are frozen dataclasses: stateless, hashable, picklable —
    one instance may be shared across tasks and process-pool workers.
    Per-task firing probability (``TaskSpec.prob``) is applied by the
    process itself, one ``rng.random()`` draw per candidate arrival, so
    thinning stays on the shared stream.
    """

    kind = "base"

    def sample(self, task: "TaskSpec", duration: float, rng: np.random.Generator) -> List[float]:
        raise NotImplementedError

    @staticmethod
    def _fires(task: "TaskSpec", rng: np.random.Generator) -> bool:
        return task.prob >= 1.0 or rng.random() < task.prob


@dataclasses.dataclass(frozen=True)
class PeriodicArrivals(ArrivalProcess):
    """Release ``j`` at ``j / fps`` (the paper's Table-II model), with
    optional uniform jitter of up to ``jitter`` periods added per release.

    ``jitter=0`` consumes the rng stream exactly like the seed
    implementation (prob draws only), so default campaigns reproduce the
    seed's per-seed results bit-for-bit.
    """

    kind = "periodic"
    jitter: float = 0.0

    def sample(self, task: "TaskSpec", duration: float, rng: np.random.Generator) -> List[float]:
        n = int(np.floor(duration * task.fps))
        # Vectorized fast paths.  Each consumes the shared rng stream in
        # exactly the per-release order of the loop below (batched
        # ``rng.random(n)`` draws the same variates as n scalar calls),
        # pinned by tests/test_campaign.py — bit-identical, just not one
        # Python iteration per release.
        if task.prob >= 1.0:
            base = np.arange(n) * task.period  # _fires short-circuits: no draws
            if self.jitter > 0.0:
                # same association as the scalar loop: (u * jitter) * period
                base = base + rng.random(n) * self.jitter * task.period
            return base.tolist()
        if self.jitter <= 0.0:
            # one thinning draw per candidate release, nothing interleaved
            fires = rng.random(n) < task.prob
            return (np.flatnonzero(fires) * task.period).tolist()
        # prob < 1 AND jitter > 0: the jitter draw happens only when the
        # thinning draw fires, so the stream interleaves data-dependently —
        # keep the scalar loop (cannot batch without changing the stream).
        out: List[float] = []
        for j in range(n):
            if self._fires(task, rng):
                out.append(j * task.period + rng.random() * self.jitter * task.period)
        return out


def _exp_stream(
    rng: np.random.Generator, scale: float, t0: float, limit: float
) -> List[float]:
    """Arrival times ``t0 + cumsum(Exp(scale))`` strictly below ``limit``,
    consuming the shared rng stream EXACTLY as the scalar loop

    .. code-block:: python

        t = t0 + rng.exponential(scale)
        while t < limit:
            out.append(t); t += rng.exponential(scale)

    i.e. one draw per arrival plus the final crossing draw.  Batched
    ``rng.exponential(scale, n)`` produces the same variates as n scalar
    calls (numpy fills the array sequentially from the bit stream, and a
    shorter batch is a prefix of a longer one), and ``np.cumsum``
    accumulates left-to-right, so the times are bit-identical.  The one
    subtlety is stopping: a batch may consume more draws than the scalar
    loop would have, so the generator state is snapshotted before each
    batch and, when the crossing lands mid-batch, rewound and re-drawn
    for exactly the right count — the stream position afterwards equals
    the scalar loop's, which matters because later tasks continue
    drawing from the same stream.  Pinned draw-for-draw (values AND
    final generator state) by ``tests/test_simulator.py``."""
    n_est = max(0.0, (limit - t0) / scale)
    chunk = int(n_est + 4.0 * n_est**0.5 + 8.0)
    out: List[float] = []
    t = t0
    while True:
        state = rng.bit_generator.state
        e = rng.exponential(scale, chunk)
        # e[0] += t then a sequential cumsum reproduces the scalar loop's
        # fl(fl(t + e0) + e1)... rounding chain exactly; the result is
        # non-decreasing, so the crossing index is a searchsorted
        e[0] += t
        ts = np.cumsum(e)
        idx = int(np.searchsorted(ts, limit))  # first ts >= limit
        if idx < chunk:
            if idx + 1 < chunk:  # scalar loop stops after draw idx+1
                rng.bit_generator.state = state
                rng.exponential(scale, idx + 1)
            out.extend(ts[:idx].tolist())
            return out
        out.extend(ts.tolist())
        t = float(ts[-1])
        chunk *= 2


@dataclasses.dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    """Homogeneous Poisson process with mean rate ``fps * rate_scale``."""

    kind = "poisson"
    rate_scale: float = 1.0

    def sample(self, task: "TaskSpec", duration: float, rng: np.random.Generator) -> List[float]:
        rate = task.fps * self.rate_scale
        out: List[float] = []
        if rate <= 0.0:
            return out
        if task.prob >= 1.0:
            # _fires short-circuits, so the stream is pure exponentials:
            # batch them (stream-identical — see _exp_stream)
            return _exp_stream(rng, 1.0 / rate, 0.0, duration)
        # prob < 1: one thinning draw interleaves after every arrival
        # below the horizon, so the raw-stream layout is data-dependent —
        # keep the scalar loop (same reasoning as PeriodicArrivals'
        # prob<1 + jitter case).
        t = rng.exponential(1.0 / rate)
        while t < duration:
            if self._fires(task, rng):
                out.append(t)
            t += rng.exponential(1.0 / rate)
        return out


@dataclasses.dataclass(frozen=True)
class MmppArrivals(ArrivalProcess):
    """Two-state Markov-modulated Poisson process (on-off bursts).

    * ``burstiness`` — ON-state rate as a multiple of the mean rate
      (``burstiness=1`` degenerates to plain Poisson).
    * ``on_fraction`` — long-run fraction of time spent in the ON state.
    * ``mean_cycle`` — mean ON+OFF cycle length in task periods.

    The OFF-state rate is solved so the long-run mean rate stays
    ``task.fps`` for every parameterization: when ``burstiness`` exceeds
    ``1/on_fraction`` (where the OFF rate would have to go negative),
    ``on_fraction`` is clamped down to ``1/burstiness`` — bursts become
    rarer rather than the offered load silently doubling, so a
    burstiness sweep measures burstiness, not overload.  Sojourn times
    are exponential, so state holding times are memoryless (a true
    MMPP, not a square wave).
    """

    kind = "mmpp"
    burstiness: float = 4.0
    on_fraction: float = 0.25
    mean_cycle: float = 20.0

    def sample(self, task: "TaskSpec", duration: float, rng: np.random.Generator) -> List[float]:
        b = max(1.0, float(self.burstiness))
        p = min(max(float(self.on_fraction), 1e-6), 1.0, 1.0 / b)
        rate_on = task.fps * b
        rate_off = task.fps * max(0.0, 1.0 - p * b) / (1.0 - p) if p < 1.0 else task.fps
        cycle = self.mean_cycle * task.period
        mean_soj = {True: p * cycle, False: (1.0 - p) * cycle}
        out: List[float] = []
        t = 0.0
        on = rng.random() < p  # start from the stationary distribution
        fast = task.prob >= 1.0  # no interleaved thinning draws
        while t < duration:
            end = min(t + rng.exponential(mean_soj[on]), duration)
            rate = rate_on if on else rate_off
            if rate > 0.0:
                if fast:
                    # per-segment batched exponentials (stream-identical;
                    # the sojourn draw above stays scalar, so segment
                    # boundaries interleave exactly as before)
                    out.extend(_exp_stream(rng, 1.0 / rate, t, end))
                else:
                    nxt = t + rng.exponential(1.0 / rate)
                    while nxt < end:
                        if self._fires(task, rng):
                            out.append(nxt)
                        nxt += rng.exponential(1.0 / rate)
            t = end
            on = not on
        return out


@dataclasses.dataclass(frozen=True)
class TraceArrivals(ArrivalProcess):
    """Replay recorded arrival times (seconds from trace start).

    ``span`` is the trace's total covered duration (defaults to the last
    timestamp); when ``cycle`` is set the trace tiles every ``span``
    seconds until the horizon.  ``prob`` thinning still applies, so a
    trace can serve several tasks with independent subsampling.
    """

    kind = "trace"
    times: Tuple[float, ...] = ()
    span: Optional[float] = None
    cycle: bool = True

    def __post_init__(self):
        # an explicit span of 0.0 used to silently fall back to the
        # trace-derived span (`if self.span` is falsy for 0.0); validate
        # instead, matching the make_arrival_process error convention
        if self.span is not None and self.span <= 0.0:
            raise ValueError(
                f"bad arguments for arrival process 'trace': span must be "
                f"> 0 seconds (or None for the trace-derived span), got "
                f"{self.span}"
            )

    def sample(self, task: "TaskSpec", duration: float, rng: np.random.Generator) -> List[float]:
        ts = sorted(float(t) for t in self.times if t >= 0.0)
        if not ts:
            return []
        span = float(self.span) if self.span is not None else max(ts[-1], task.period)
        out: List[float] = []
        rep = 0
        while True:
            base = rep * span
            if base >= duration:
                break
            for x in ts:
                t = base + x
                if t >= duration:
                    break
                if self._fires(task, rng):
                    out.append(t)
            if not self.cycle:
                break
            rep += 1
        return out


@dataclasses.dataclass(frozen=True)
class DiurnalArrivals(ArrivalProcess):
    """Inhomogeneous Poisson process with a sinusoidal rate curve — the
    compressed diurnal cycle of a serving fleet.  The instantaneous rate
    is ``fps * (1 + depth * sin(2*pi*(t/period + phase)))``; the long-run
    mean stays ``task.fps``.  Sampled by thinning against the peak rate
    (one acceptance draw per candidate), so it pre-generates like every
    other open-loop process.
    """

    kind = "diurnal"
    period: float = 4.0  # seconds per rate cycle (simulation scale)
    depth: float = 0.8  # peak-to-trough modulation, in [0, 1)
    phase: float = 0.0  # cycle fraction offset at t=0

    def __post_init__(self):
        if self.period <= 0.0:
            raise ValueError(
                f"bad arguments for arrival process 'diurnal': period must "
                f"be > 0 seconds, got {self.period}"
            )
        if not 0.0 <= self.depth < 1.0:
            raise ValueError(
                f"bad arguments for arrival process 'diurnal': depth must "
                f"be in [0, 1), got {self.depth}"
            )

    def sample(self, task: "TaskSpec", duration: float, rng: np.random.Generator) -> List[float]:
        peak = task.fps * (1.0 + self.depth)
        out: List[float] = []
        if peak <= 0.0:
            return out
        two_pi = 2.0 * np.pi
        t = rng.exponential(1.0 / peak)
        while t < duration:
            lam = task.fps * (
                1.0 + self.depth * float(np.sin(two_pi * (t / self.period + self.phase)))
            )
            if rng.random() * peak < lam and self._fires(task, rng):
                out.append(t)
            t += rng.exponential(1.0 / peak)
        return out


#: rng-stream salt for closed-loop per-user think-time streams; disjoint
#: from the shared open-loop arrival stream (seeded on the bare seed).
_CLIENT_SALT = 0x434C4F53  # "CLOS"


@dataclasses.dataclass(frozen=True)
class ClosedLoopClients(ArrivalProcess):
    """Closed-loop user pool: ``n_users`` clients that each keep exactly
    one request in flight — a release happens only after the user's
    previous request *left the system* (completed, early-dropped, or
    admission-shed) plus an exponential think time.

    This cannot be pre-generated (releases gate on completions), so both
    engines integrate it into the event loop directly via
    :func:`generate_release_events`; :meth:`sample` raises.  Each user
    draws think times from its own rng stream, which makes the two
    engines bit-identical even though they retire requests in different
    within-round orders (pinned by ``tests/test_closed_loop.py``).

    * ``session_len`` > 0 with ``respawn=False``: each user retires
      after issuing that many requests (drain; the flash-crowd shape).
      With ``respawn=True`` (default) users keep issuing forever.
    * ``stagger=True`` staggers first releases by one think time;
      ``stagger=False`` releases every user at ``start`` simultaneously
      (the flash-crowd front).
    * ``TaskSpec.fps`` still sets the relative deadline (1/fps); the
      offered rate is emergent (~ ``n_users / (think + response)``).
      ``TaskSpec.prob`` thinning does not apply to closed-loop tasks.
    """

    kind = "closed_loop"
    n_users: int = 4
    think_time: float = 0.1
    session_len: int = 0
    respawn: bool = True
    start: float = 0.0
    stagger: bool = True

    def __post_init__(self):
        if self.n_users < 1:
            raise ValueError(
                f"bad arguments for arrival process 'closed_loop': n_users "
                f"must be >= 1, got {self.n_users}"
            )
        if self.think_time <= 0.0:
            raise ValueError(
                f"bad arguments for arrival process 'closed_loop': "
                f"think_time must be > 0 seconds, got {self.think_time}"
            )
        if self.session_len < 0:
            raise ValueError(
                f"bad arguments for arrival process 'closed_loop': "
                f"session_len must be >= 0 (0 = unlimited), got {self.session_len}"
            )
        if self.start < 0.0:
            raise ValueError(
                f"bad arguments for arrival process 'closed_loop': start "
                f"must be >= 0, got {self.start}"
            )

    def sample(self, task: "TaskSpec", duration: float, rng: np.random.Generator) -> List[float]:
        raise ValueError(
            "closed-loop releases gate on completions and cannot be "
            "pre-generated; pass ClosedLoopClients as the task's arrival "
            "process to simulate() — both engines integrate it into the "
            "event loop directly (generate_release_events)"
        )

    def runtime(self, task_idx: int, seed: int, duration: float) -> "_ClientRuntime":
        return _ClientRuntime(self, task_idx, seed, duration)


class _ClientRuntime:
    """Mutable per-trial state of one closed-loop task's user pool.

    Each user draws think times from its OWN rng stream
    (``default_rng([salt, seed, task_idx, user])``): a user's next draw
    never depends on how an engine interleaves *other* users'
    completions and drops within a round, which is what keeps the two
    engines bit-identical despite their different drop orders."""

    __slots__ = ("spec", "task_idx", "duration", "rngs", "issued")

    def __init__(self, spec: ClosedLoopClients, task_idx: int, seed: int, duration: float):
        self.spec = spec
        self.task_idx = task_idx
        self.duration = duration
        self.rngs = [
            np.random.default_rng([_CLIENT_SALT, seed, task_idx, u])
            for u in range(spec.n_users)
        ]
        self.issued = [0] * spec.n_users

    def initial(self) -> List[Tuple[float, int]]:
        """[(release_time, user)] — each user's first release."""
        sp = self.spec
        out: List[Tuple[float, int]] = []
        for u in range(sp.n_users):
            t = sp.start
            if sp.stagger:
                t += float(self.rngs[u].exponential(sp.think_time))
            if t < self.duration:
                self.issued[u] += 1
                out.append((t, u))
        return out

    def next_release(self, u: int, now: float) -> Optional[float]:
        """User ``u``'s next release after its request left the system at
        ``now`` (completed, dropped, or shed); None when the session is
        over or the release would fall past the horizon."""
        sp = self.spec
        if sp.session_len > 0 and not sp.respawn and self.issued[u] >= sp.session_len:
            return None
        t = now + float(self.rngs[u].exponential(sp.think_time))
        if t >= self.duration:
            return None
        self.issued[u] += 1
        return t


@dataclasses.dataclass(frozen=True)
class _NullArrivals(ArrivalProcess):
    """Stand-in for closed-loop tasks inside ``generate_arrivals``: draws
    nothing from the shared open-loop stream and releases nothing, so the
    open-loop tasks' variates are exactly as if the closed-loop tasks
    were absent."""

    kind = "null"

    def sample(self, task: "TaskSpec", duration: float, rng: np.random.Generator) -> List[float]:
        return []


_NULL_ARRIVAL = _NullArrivals()


ARRIVAL_PROCESSES = {
    "periodic": PeriodicArrivals,
    "poisson": PoissonArrivals,
    "mmpp": MmppArrivals,
    "trace": TraceArrivals,
    "diurnal": DiurnalArrivals,
    "closed_loop": ClosedLoopClients,
}

DEFAULT_ARRIVAL = PeriodicArrivals()


def make_arrival_process(spec) -> ArrivalProcess:
    """Build an :class:`ArrivalProcess` from a call-spec string.

    ``"periodic"``, ``"periodic(jitter=0.5)"``, ``"poisson"``,
    ``"mmpp(burstiness=4,on_fraction=0.2)"`` ...; instances pass through
    unchanged and ``None`` means the default periodic process.
    """
    if spec is None:
        return DEFAULT_ARRIVAL
    if isinstance(spec, ArrivalProcess):
        return spec
    name, kwargs = parse_call_spec(spec)
    if name not in ARRIVAL_PROCESSES:
        raise KeyError(f"unknown arrival process '{name}' (have {sorted(ARRIVAL_PROCESSES)})")
    if name == "trace":
        # a bare "trace" would replay an empty times tuple — every trial
        # releasing 0 requests looks like a perfect scheduler, not an error
        raise ValueError("trace arrivals need a times tuple; construct TraceArrivals directly")
    cls = ARRIVAL_PROCESSES[name]
    try:
        return cls(**kwargs)
    except TypeError as e:
        # "mmpp(burstines=4)" would otherwise surface as a bare dataclass
        # TypeError deep inside a pool worker — name the process and its
        # valid parameters at the point of parsing instead.
        params = sorted(f.name for f in dataclasses.fields(cls))
        raise ValueError(
            f"bad arguments for arrival process '{name}': {e}; "
            f"valid parameters: {params or 'none'}"
        ) from e


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """One task entry of a workload scenario (Table II row item).

    ``arrival`` selects the release process (``None`` -> strictly
    periodic, the paper's model); ``fps`` always sets the mean rate and
    the relative deadline ``1/fps`` regardless of process.
    """

    model_idx: int
    fps: float
    prob: float = 1.0
    arrival: Optional[ArrivalProcess] = None

    @property
    def period(self) -> float:
        return 1.0 / self.fps


@dataclasses.dataclass
class ModelStats:
    """Per-model counters.  Conservation law (property-tested on both
    engines, ``tests/test_conservation.py``): every released request is
    accounted for exactly once —

        released == completed + dropped + in_flight

    with ``shed <= dropped`` (admission rejections are a kind of drop)
    and ``missed >= dropped`` (drops always miss; completions may)."""

    released: int = 0
    completed: int = 0
    missed: int = 0  # late completions + drops
    dropped: int = 0  # early-drops + admission sheds
    retained_sum: float = 0.0  # sum of retained-accuracy fractions
    variants_applied: int = 0
    # Admission-policy rejections (subset of ``dropped``): requests shed
    # at the release door, before entering the ready set.
    shed: int = 0
    # Requests still in the system (ready or running) when the event
    # stream drained — released but neither completed nor dropped.
    in_flight: int = 0
    # Fault counters (``repro_torch.core.faults``).  ``evicted`` counts in-flight
    # layer interruptions (a request can be evicted more than once);
    # ``remapped`` counts evicted requests that were subsequently
    # re-dispatched — so ``remapped <= evicted`` and eviction is never a
    # terminal state by itself (an evicted request re-enters the ready set
    # and later completes, early-drops, or drains as in_flight, keeping
    # the conservation law above intact under faults).
    evicted: int = 0
    remapped: int = 0

    @property
    def admitted(self) -> int:
        return self.released - self.shed

    @property
    def miss_rate(self) -> float:
        return self.missed / self.released if self.released else 0.0

    @property
    def mean_retained(self) -> float:
        """Mean retained-accuracy fraction over COMPLETED requests; NaN
        when the model completed nothing.  (It used to report 1.0 — at
        saturation a model that completed zero requests read as "no
        accuracy loss", silently flattering the headline metric pair.)"""
        return self.retained_sum / self.completed if self.completed else float("nan")

    @property
    def mean_norm_accuracy_loss(self) -> float:
        return 1.0 - self.mean_retained


@dataclasses.dataclass
class SimResult:
    duration: float
    per_model: Dict[int, ModelStats]
    acc_busy_time: np.ndarray
    scheduler_name: str
    # Busy time counted only up to the horizon.  Layers dispatched near
    # the horizon run past ``duration`` but ``acc_busy_time`` charges
    # their full latency, so the raw ratio can exceed 1.0; this field
    # clamps each dispatch's contribution to the time remaining before
    # the horizon.  ``None`` (externally constructed results) falls back
    # to the raw ratio.
    acc_busy_in_horizon: Optional[np.ndarray] = None
    # Scheduling rounds executed: one per distinct event timestamp after
    # simultaneous-event batching.  Per-result telemetry (both engines
    # count identically — pinned by the differential tests), so campaign
    # pool workers report real values instead of mutating module state.
    # ``None`` on externally constructed results.
    rounds: Optional[int] = None
    # Fault windows (``repro_torch.core.faults``) that intersected the horizon;
    # 0 on fault-free trials (and on externally constructed results).
    faulted_spans: int = 0

    @property
    def mean_miss_rate(self) -> float:
        """Average of per-model deadline miss rates (paper's metric)."""
        rates = [s.miss_rate for s in self.per_model.values() if s.released]
        return float(np.mean(rates)) if rates else 0.0

    def accuracy_loss_stats(
        self, plans: Sequence[ModelPlan]
    ) -> Tuple[float, int, int]:
        """``(mean_loss, models_counted, models_with_variants)``.

        The mean normalized accuracy loss over variant-bearing models
        that completed at least one request.  Zero-completion models are
        EXCLUDED from the mean and surfaced through the counts
        (``models_counted < models_with_variants`` flags the exclusion);
        when NO variant-bearing model completed anything the mean is NaN
        — never a flattering 0.0.  Report the loss jointly with
        ``models_counted`` whenever the workload can saturate."""
        with_var = [m for m, s in sorted(self.per_model.items()) if plans[m].variants]
        counted = [m for m in with_var if self.per_model[m].completed]
        mean = (
            float(np.mean([self.per_model[m].mean_norm_accuracy_loss for m in counted]))
            if counted
            else float("nan")
        )
        return mean, len(counted), len(with_var)

    def mean_accuracy_loss(self, plans: Sequence[ModelPlan]) -> float:
        """Average normalized accuracy loss across models WITH variants
        that completed at least one request; NaN when none did (see
        :meth:`accuracy_loss_stats` for the documented contract and the
        exclusion counts)."""
        return self.accuracy_loss_stats(plans)[0]

    def fingerprint(self) -> tuple:
        """Canonical exact-equality key: every observable field — busy
        arrays, clamped busy arrays, the scheduling-round count, per-model
        integer counters AND the float retained-accuracy sums.  The one
        definition the engine/kernel differential suites and the
        benchmark bit-identity gates compare, so a newly added SimResult
        field only needs to be wired in here to be pinned everywhere."""
        return (
            self.scheduler_name,
            self.rounds,
            self.acc_busy_time.tolist(),
            None if self.acc_busy_in_horizon is None
            else self.acc_busy_in_horizon.tolist(),
            {
                m: (s.released, s.completed, s.missed, s.dropped,
                    s.variants_applied, s.retained_sum, s.shed, s.in_flight,
                    s.evicted, s.remapped)
                for m, s in sorted(self.per_model.items())
            },
            self.faulted_spans,
        )

    def utilization(self, clamp: bool = True) -> np.ndarray:
        """Per-accelerator busy fraction of the horizon, in [0, 1].

        ``clamp=False`` restores the historical accounting that charges
        the full latency of every dispatched layer — including the tail
        that runs past the horizon — and can therefore exceed 1.0."""
        if clamp and self.acc_busy_in_horizon is not None:
            return self.acc_busy_in_horizon / self.duration
        return self.acc_busy_time / self.duration


_ARRIVAL, _FINISH, _TICK, _FAULT = 0, 1, 2, 3


def generate_arrivals(
    tasks: Sequence[TaskSpec],
    duration: float,
    seed: int = 0,
    processes: Optional[Sequence[Optional[ArrivalProcess]]] = None,
) -> List[Tuple[float, int]]:
    """[(arrival_time, model_idx)] honoring per-task firing probability.

    ``processes`` (one per task) overrides each task's own ``arrival``;
    either being ``None`` falls back to the strictly periodic default.
    One rng stream is consumed in task order, so the all-periodic path
    reproduces the seed implementation exactly.
    """
    rng = np.random.default_rng(seed)
    out: List[Tuple[float, int]] = []
    for t_idx, task in enumerate(tasks):
        proc = processes[t_idx] if processes is not None else None
        proc = proc or task.arrival or DEFAULT_ARRIVAL
        for t in proc.sample(task, duration, rng):
            out.append((t, task.model_idx))
    out.sort()
    return out


def generate_release_events(
    tasks: Sequence[TaskSpec],
    duration: float,
    seed: int = 0,
    processes: Optional[Sequence[Optional[ArrivalProcess]]] = None,
) -> Tuple[List[tuple], Dict[int, _ClientRuntime]]:
    """Open-loop arrivals plus closed-loop first releases, for the engines.

    Returns ``(events, clients)``.  With no closed-loop task, ``events``
    IS the ``generate_arrivals`` output (``[(t, model_idx)]`` — the
    pre-closed-loop event order, and therefore every open-loop
    fingerprint, is untouched) and ``clients`` is empty.  With
    closed-loop tasks, every event is ``(t, model_idx, task_idx, user)``
    with ``task_idx = user = -1`` marking open-loop entries; the list is
    sorted on the full tuple — a fixed tie order both engines share —
    and ``clients`` maps task_idx to the mutable :class:`_ClientRuntime`
    whose ``next_release`` the engines invoke when that task's requests
    complete, drop, or are shed.  Open-loop tasks draw from the shared
    per-trial stream exactly as if the closed-loop tasks were absent
    (their slots consume nothing)."""
    resolved: List[ArrivalProcess] = []
    for t_idx, task in enumerate(tasks):
        proc = processes[t_idx] if processes is not None else None
        resolved.append(proc or task.arrival or DEFAULT_ARRIVAL)
    clients: Dict[int, _ClientRuntime] = {}
    if not any(isinstance(p, ClosedLoopClients) for p in resolved):
        return generate_arrivals(tasks, duration, seed, processes=processes), clients
    open_procs: List[ArrivalProcess] = []
    for t_idx, proc in enumerate(resolved):
        if isinstance(proc, ClosedLoopClients):
            clients[t_idx] = proc.runtime(t_idx, seed, duration)
            open_procs.append(_NULL_ARRIVAL)
        else:
            open_procs.append(proc)
    events: List[tuple] = [
        (t, m, -1, -1)
        for t, m in generate_arrivals(tasks, duration, seed, processes=open_procs)
    ]
    for t_idx, rt in clients.items():
        m = tasks[t_idx].model_idx
        for t, u in rt.initial():
            events.append((t, m, t_idx, u))
    events.sort()
    return events, clients


def drop_hopeless(
    now: float,
    ready: List[Request],
    remaining_min: Sequence[np.ndarray],
    stats: Dict[int, ModelStats],
) -> List[Request]:
    """Early-drop (all policies, paper Sec. IV-C): drop ready requests whose
    remaining minimum execution time can no longer meet the deadline.
    Module-level so campaign-style trial runners and tests share the exact
    bookkeeping the event loop uses (mutates ``ready`` and ``stats``).
    Returns the dropped requests in ready-insertion order, so the event
    loop can settle their backlog/closed-loop obligations.

    ``remaining_min[m][l]`` is the minimum remaining work from layer
    ``l`` INCLUSIVE — ``ModelPlan.crit_from``, which on a DAG plan is the
    critical path of the sub-DAG at ``l`` (every node is an ancestor of
    the sink, so a hopeless ready node makes the whole request hopeless).
    A DAG request drops ONCE: the first hopeless node entry marks the
    shared :class:`DagRun` and returns as the request's representative;
    sibling entries are swept out of ``ready`` uncounted, and a running
    sibling's eventual finish is a no-op.
    """
    out: List[Request] = []
    any_dag_drop = False
    for req in list(ready):
        plan_idx = req.model_idx
        min_rem = float(remaining_min[plan_idx][req.next_layer])
        if now + min_rem > req.deadline_abs + 1e-12:
            dr = req.dag
            if dr is not None:
                if dr.dropped:  # sibling already dropped this round
                    req.dropped = True
                    ready.remove(req)
                    continue
                dr.dropped = True
                any_dag_drop = True
            req.dropped = True
            ready.remove(req)
            st = stats[plan_idx]
            st.missed += 1
            st.dropped += 1
            out.append(req)
    if any_dag_drop:
        # sweep sibling entries examined before their request's drop
        for req in list(ready):
            if req.dag is not None and req.dag.dropped:
                req.dropped = True
                ready.remove(req)
    return out


#: engines accepted by :func:`simulate`; "auto" picks the SoA engine for
#: the built-in scheduler classes and falls back to the reference event
#: loop for custom ``Scheduler`` subclasses (whose ``schedule()`` needs a
#: :class:`SchedView`).  REPRO_SIM_ENGINE overrides the default.
#: "batch" is the device-resident batched engine
#: (``repro_torch.core.engine_batch``) — it is NEVER auto-picked: it must be
#: requested explicitly (it jit-compiles whole-trial programs, which only
#: pays off across a seed batch), and an unsupported axis raises its
#: named ``BatchUnsupportedError`` instead of silently falling back.
SIM_ENGINES = ("auto", "soa", "reference", "batch")


def simulate(
    plans: Sequence[ModelPlan],
    tasks: Sequence[TaskSpec],
    duration: float,
    scheduler: Scheduler,
    seed: int = 0,
    processes: Optional[Sequence[Optional[ArrivalProcess]]] = None,
    budget_policy: Union["BudgetPolicy", str, None] = None,
    engine: Optional[str] = None,
    round_kernel: Optional[str] = None,
    admission: Union["AdmissionPolicy", str, None] = None,
    faults: Union["FaultModel", str, None] = None,
    device=None,
) -> SimResult:
    """``faults`` selects the accelerator fault model (a call-spec string
    like ``"down(acc=0,start=0.1,duration=0.2)"`` — several joined with
    ``+`` — a :class:`repro_torch.core.faults.FaultModel`, or ``None`` ==
    ``"none"``: fault-free, bit-identical to the pre-fault-axis
    simulator).  Fault windows resolve into capability events merged into
    the event loop: a down accelerator is busy-forever and evicts its
    in-flight layer (``restart`` | ``resume`` interrupted-work policy), a
    throttled one scales its latency column, and schedulers see the
    masked/reweighted tables; see ``repro_torch.core.faults``.

    ``admission`` selects the overload-control policy applied at every
    request release (a call-spec string like ``"shed_early(margin=1.5)"``
    / ``"token_bucket(rate=100,burst=10)"``, an instance, or ``None`` ==
    ``"none"`` — admit everything, bit-identical to the pre-admission
    simulator).  A shed request counts released + missed + dropped +
    shed and never enters the ready set; see ``repro_torch.core.admission``.

    ``budget_policy`` selects the online virtual-budget policy (a
    call-spec string like ``"reclaim"`` / ``"adaptive(tick=0.02)"``, an
    instance, or ``None`` == ``"static"`` — the paper's offline budgets,
    bit-identical to the seed simulator).  The policy is invoked at
    request release, at every non-final layer finish (slack reclamation),
    and — when it defines a positive ``tick_interval`` — at periodic
    controller tick events interleaved with the regular event stream
    (ticks see the ready queue and accelerator availability; see
    ``repro_torch.core.budget_online`` for what each policy does with them).

    ``engine`` selects the event-loop implementation: ``"soa"`` is the
    structure-of-arrays engine (``repro_torch.core.engine_soa``, several times
    faster, bit-identical — pinned by the differential tests),
    ``"reference"`` is the retained original event loop (the oracle),
    ``"auto"``/``None`` picks SoA whenever the scheduler is one of the
    built-in classes it has a kernel for.  The REPRO_SIM_ENGINE
    environment variable overrides ``None``/``"auto"`` (so a campaign —
    whose TrialSpecs carry the default ``"auto"`` — can be forced onto
    one engine without touching call sites); an explicit ``"soa"`` or
    ``"reference"`` argument always wins.

    ``round_kernel`` selects the SoA engine's Terastal round
    implementation for deep ready queues — ``"python"`` (scalar and
    vectorized kernels, depth-dispatched), ``"jax"`` (force the device
    round, ``scheduler_torch.terastal_round``), or ``"auto"``/``None``
    (python below the calibrated crossover; see
    ``engine_soa.round_crossover``).
    ``REPRO_ROUND_KERNEL`` overrides ``None``.  All choices are
    bit-identical (pinned by the differential suites); the knob exists
    for performance and for the differential tests themselves.  Ignored
    by the reference engine.

    ``device`` is the torch device of ``engine="batch"``'s trial program
    and of the SoA engine's device round (``"cuda"`` when None; pass
    ``device="cpu"`` to run them on the host).
    """
    from repro_torch.core.admission import make_admission_policy
    from repro_torch.core.budget_online import make_budget_policy
    from repro_torch.core.faults import make_fault_model

    if engine is None or engine == "auto":
        engine = os.environ.get("REPRO_SIM_ENGINE") or "auto"
    if engine not in SIM_ENGINES:
        raise ValueError(f"unknown engine {engine!r} (have {SIM_ENGINES})")
    fault_model = make_fault_model(faults)
    if engine == "batch":
        # the degenerate B=1 batch: same contract, one device program per
        # call — use engine_batch.simulate_batch directly for real batches
        from repro_torch.core import engine_batch

        return engine_batch.simulate_batch(
            plans, tasks, duration, scheduler, [seed], processes=processes,
            budget_policy=budget_policy, admission=admission,
            faults=fault_model, device=device,
        )[0]
    policy = make_budget_policy(budget_policy)
    policy.reset()  # instances may be reused across runs (e.g. seed sweeps)
    adm = make_admission_policy(admission)
    adm.reset()

    # ---- DAG-plan axis gating (repro_torch.core.dag) --------------------------
    # Precedence-aware scheduling composes with schedulers, arrivals,
    # admission, closed-loop clients, and (since the fault-aware
    # critical-path re-tightening landed) accelerator faults on both
    # scalar engines.  Online budget policies stay linear-chain only:
    # they rebase vdl chains with cumsum, which cannot express a DAG's
    # overlapping branch budgets — refuse loudly instead of silently
    # mis-simulating.
    dag_model = next((p.model.name for p in plans if p.dag is not None), None)
    if dag_model is not None:
        if policy.name != "static" or policy.tick_interval > 0:
            raise ValueError(
                f"budget policy {policy.name!r} is linear-chain only; DAG plans "
                f"(model {dag_model!r}) support only the static offline budgets"
            )

    if engine != "reference":
        from repro_torch.core import engine_soa

        supported = engine_soa.supports_scheduler(scheduler)
        if engine == "soa" and not supported:
            raise ValueError(
                f"engine='soa' has no kernel for {type(scheduler).__name__}; "
                "use engine='auto' (falls back) or engine='reference'"
            )
        if supported:
            return engine_soa.simulate_soa(
                plans, tasks, duration, scheduler, seed, processes, policy,
                round_kernel=round_kernel, admission=adm,
                fault_model=fault_model, device=device,
            )
    return _simulate_reference(
        plans, tasks, duration, scheduler, seed, processes, policy, adm,
        fault_model,
    )


def _simulate_reference(
    plans: Sequence[ModelPlan],
    tasks: Sequence[TaskSpec],
    duration: float,
    scheduler: Scheduler,
    seed: int,
    processes: Optional[Sequence[Optional[ArrivalProcess]]],
    policy: "BudgetPolicy",
    admission: "AdmissionPolicy" = None,
    fault_model: "FaultModel" = None,
) -> SimResult:
    """The original per-object event loop, retained verbatim as the
    differential oracle for the SoA engine (every optimization must stay
    bit-identical to THIS implementation)."""
    from repro_torch.core.admission import NoAdmission
    from repro_torch.core.faults import (
        degraded_work_tables,
        effective_plans,
        evict_busy_adjust,
        fault_multipliers,
        retightened_vdl,
        retime_busy_adjust,
    )

    n_acc = plans[0].platform.n_acc
    acc_busy_until = np.zeros(n_acc)
    acc_busy_time = np.zeros(n_acc)
    acc_busy_in_horizon = np.zeros(n_acc)
    stats: Dict[int, ModelStats] = {t.model_idx: ModelStats() for t in tasks}

    # Precompute hot per-plan tables once.  ``crit_from`` is the minimum
    # remaining work (critical path to the sink on DAG plans); on linear
    # chains it is the exact ``remaining_min[:-1]`` slice, so the rename
    # is bitwise inert for every pre-DAG scenario.
    n_layers = [len(p.model.layers) for p in plans]
    remaining_min = [p.crit_from for p in plans]

    # Fault state (``repro_torch.core.faults``).  ``eff_plans`` are the
    # capability-masked plan copies every scheduling decision reads; with
    # no fault model they ARE the offline plans, so the fault-off path is
    # bit-identical to the pre-fault-axis loop.  Budget-policy hooks and
    # completed-accuracy accounting keep the ORIGINAL plans (budgets and
    # losses are offline objects; faults change capability, not accuracy).
    # With ``retighten=false`` the admission work tables and every vdl
    # chain stay frozen at fault-free values (the original fault axis);
    # ``retighten=true`` re-derives both from degraded capability on
    # every capability event (see ``refresh_tables``).
    fm = fault_model if fault_model is not None and fault_model.active else None
    eff_plans = list(plans)
    faulted_spans = 0
    retighten = fm is not None and fm.retighten
    cur_chain: List[Optional[np.ndarray]] = [None] * len(plans)
    if fm is not None:
        fault_events, faulted_spans = fm.timeline(n_acc, duration, seed)
        avail = [True] * n_acc
        fscale = [1.0] * n_acc
        cur_fin = [-1] * n_acc  # counter of each acc's valid finish event
        disp_start = [0.0] * n_acc  # in-flight dispatch: start time and the
        disp_w = [0.0] * n_acc  # wall / in-horizon busy amounts credited
        disp_h = [0.0] * n_acc
        resume = fm.interrupted == "resume"

    # Admission state.  ``backlog_ns`` is the remaining minimum work of
    # admitted, not-yet-finished requests in INTEGER nanoseconds —
    # integer adds are order-independent, so the SoA engine's different
    # within-round drop order cannot produce divergent backlog values.
    adm = None if admission is None or type(admission) is NoAdmission else admission
    if adm is not None:
        adm.bind(n_acc)
    need_backlog = adm is not None and adm.needs_backlog
    backlog_ns = 0
    min_work_s = [p.crit_total for p in plans]
    work_ns = [int(round(w * 1e9)) for w in min_work_s]

    events, clients = generate_release_events(tasks, duration, seed, processes)
    heap: List[Tuple[float, int, int, object]] = []
    counter = itertools.count()
    for evt in events:
        if len(evt) == 2:
            t, payload = evt
        else:
            t, m, t_idx, u = evt
            payload = m if t_idx < 0 else (m, t_idx, u)
        heapq.heappush(heap, (t, next(counter), _ARRIVAL, payload))
    if fm is not None:
        # capability events enter the heap after all arrivals and before
        # the tick, so same-timestamp ordering (arrival < fault < tick <
        # finish) is fixed by counters identically in both engines
        for fe in fault_events:
            heapq.heappush(heap, (fe.t, next(counter), _FAULT, fe))
    if policy.tick_interval > 0 and heap:
        heapq.heappush(heap, (policy.tick_interval, next(counter), _TICK, None))

    ready: List[Request] = []
    running: Dict[int, Tuple[Request, bool]] = {}  # acc -> (req, used_variant)
    rid_counter = itertools.count()
    rounds = 0  # scheduling rounds, reported on SimResult.rounds

    def push_release(client: Tuple[int, int], t: float) -> None:
        """Schedule a closed-loop user's next release after its request
        left the system at ``t``."""
        t_idx, u = client
        nxt = clients[t_idx].next_release(u, t)
        if nxt is not None:
            heapq.heappush(
                heap,
                (nxt, next(counter), _ARRIVAL, (tasks[t_idx].model_idx, t_idx, u)),
            )

    def invoke_scheduler(now: float) -> None:
        nonlocal rounds, backlog_ns
        rounds += 1
        dropped_now = drop_hopeless(now, ready, remaining_min, stats)
        if dropped_now:
            if need_backlog:
                for r in dropped_now:
                    backlog_ns -= r.work_ns
            if clients:
                # canonical per-round release order (sorted by client):
                # both engines drop the same SET in different orders, so
                # the release pushes sort to keep event counters identical
                for r in sorted(
                    (r for r in dropped_now if r.client is not None),
                    key=lambda r: r.client,
                ):
                    push_release(r.client, now)
        if not ready:
            return
        view = SchedView(now=now, ready=list(ready), acc_busy_until=acc_busy_until.copy(), plans=eff_plans)
        for a in scheduler.schedule(view):
            if a.req not in ready:  # defensive: policy returned stale item
                continue
            if acc_busy_until[a.acc] > now + 1e-15:
                continue  # defensive: policy targeted a busy accelerator
            plan = eff_plans[a.req.model_idx]
            c = float(plan.lat_var[a.layer, a.acc]) if a.use_variant else float(plan.lat[a.layer, a.acc])
            ready.remove(a.req)
            if a.use_variant:
                a.req.applied_variants = a.req.applied_variants | {a.layer}
                stats[a.req.model_idx].variants_applied += 1
                dr = a.req.dag
                if dr is not None:
                    # the request-wide variant set lives on the shared
                    # DagRun; live sibling entries refresh so combo
                    # validity sees it from the next round on (decisions
                    # WITHIN this round were already taken from pre-round
                    # state — both engines share that quirk)
                    dr.applied_variants = dr.applied_variants | {a.layer}
                    for r in ready:
                        if r.dag is dr:
                            r.applied_variants = dr.applied_variants
            if fm is not None:
                if a.req.evicted_pending:
                    a.req.evicted_pending = False
                    stats[a.req.model_idx].remapped += 1
                if a.req.layer_frac > 0.0:
                    # resume policy: only the un-executed remainder of the
                    # interrupted layer runs (schedulers still estimate
                    # with the full row — a documented estimation error)
                    c = c * (1.0 - a.req.layer_frac)
            acc_busy_until[a.acc] = now + c
            acc_busy_time[a.acc] += c
            h = min(c, max(0.0, duration - now))
            acc_busy_in_horizon[a.acc] += h
            running[a.acc] = (a.req, a.use_variant)
            fin_cnt = next(counter)
            heapq.heappush(heap, (now + c, fin_cnt, _FINISH, a.acc))
            if fm is not None:
                cur_fin[a.acc] = fin_cnt
                disp_start[a.acc] = now
                disp_w[a.acc] = c
                disp_h[a.acc] = h

    def evict(k: int, now: float) -> None:
        """A down event interrupted acc ``k``'s in-flight layer: undo the
        dispatch (variant bookkeeping, un-run busy time), carry progress
        under ``resume``, and re-enqueue the request for re-mapping.

        DAG entries: the variant undo also retracts the node from the
        shared ``DagRun`` set (and refreshes live siblings' snapshots),
        and a request whose run was already counted dropped is NOT
        re-enqueued — its eviction is a busy-time correction only,
        mirroring how a dropped run's still-running finish is a no-op."""
        req, used_var = running.pop(k)
        dr = req.dag
        run_dropped = dr is not None and dr.dropped
        if used_var:
            req.applied_variants = req.applied_variants - {req.next_layer}
            stats[req.model_idx].variants_applied -= 1
            if dr is not None:
                dr.applied_variants = dr.applied_variants - {req.next_layer}
                for r in ready:
                    if r.dag is dr:
                        r.applied_variants = dr.applied_variants
        fin_old = float(acc_busy_until[k])
        t0 = disp_start[k]
        if resume and fin_old > t0:
            req.layer_frac = req.layer_frac + (1.0 - req.layer_frac) * (
                (now - t0) / (fin_old - t0)
            )
        else:
            req.layer_frac = 0.0
        dw, dh = evict_busy_adjust(t0, now, duration, disp_w[k], disp_h[k])
        acc_busy_time[k] += dw
        acc_busy_in_horizon[k] += dh
        if run_dropped:
            return  # drop already counted; nothing left to re-map
        req.evicted_pending = True
        stats[req.model_idx].evicted += 1
        ready.append(req)

    def refresh_tables(now: float) -> None:
        """Capability changed: swap the effective tables and — under
        ``retighten=true`` — re-run the tightening kernel, rebind every
        live request's vdl chain, and re-derive the admission work
        tables from degraded capacity.  Finishes with the capability
        hook so online budget policies observe the event."""
        nonlocal eff_plans, remaining_min, min_work_s, work_ns
        eff_plans = effective_plans(plans, fault_multipliers(fscale, avail))
        remaining_min = [p.crit_from for p in eff_plans]
        if retighten:
            cur_chain[:] = retightened_vdl(plans, eff_plans)
            for r in ready:
                ch = cur_chain[r.model_idx]
                r.vdl_abs = None if ch is None else r.arrival + ch
            for r, _ in running.values():
                ch = cur_chain[r.model_idx]
                r.vdl_abs = None if ch is None else r.arrival + ch
            if adm is not None:
                min_work_s, work_ns = degraded_work_tables(eff_plans, duration)
                adm.bind(max(1, sum(avail)))
        policy.on_capability(now, ready, plans, eff_plans, acc_busy_until)

    while heap:
        now, evt_cnt, kind, payload = heapq.heappop(heap)
        if kind == _ARRIVAL:
            if type(payload) is tuple:
                m, t_idx, u = payload
                client = (t_idx, u)
            else:
                m = payload
                client = None
            req = Request(
                rid=next(rid_counter),
                model_idx=m,
                arrival=now,
                deadline_abs=now + plans[m].deadline,
                client=client,
            )
            dag = plans[m].dag
            if dag is not None:
                # one logical request, one rid, one shared DagRun; the
                # representative entry sits at the lowest source node and
                # is the one admission judges
                req.next_layer = dag.sources[0]
                req.dag = DagRun.fresh(dag)
            if adm is not None and not adm.admit(req, now, backlog_ns, min_work_s[m]):
                # shed at the door: released+missed+dropped+shed, never
                # enters ready and the budget policy never sees it
                req.dropped = True
                st = stats[m]
                st.released += 1
                st.missed += 1
                st.dropped += 1
                st.shed += 1
                if client is not None:
                    push_release(client, now)
            else:
                policy.on_release(req, plans[m], now)
                if retighten and cur_chain[m] is not None:
                    # released into degraded capability: bind the
                    # re-tightened chain (overriding any policy install)
                    req.vdl_abs = now + cur_chain[m]
                stats[m].released += 1
                if need_backlog:
                    # the admitted work rides on the request (frozen at
                    # admission, so add/remove stays symmetric even when
                    # retighten re-derives the tables mid-trial)
                    req.work_ns = work_ns[m]
                    backlog_ns += req.work_ns
                ready.append(req)
                if dag is not None:
                    # sibling ready entries for the remaining source
                    # nodes, ascending — one per precedence-unblocked
                    # node, all sharing rid/deadline/client/DagRun
                    for s in dag.sources[1:]:
                        ready.append(
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
        elif kind == _TICK:
            policy.on_tick(now, ready, plans, acc_busy_until)
            # keep ticking only while real events remain, so the loop
            # always terminates (there is at most one tick in the heap)
            if heap:
                heapq.heappush(
                    heap, (now + policy.tick_interval, next(counter), _TICK, None)
                )
        elif kind == _FAULT:
            fe = payload
            k = fe.acc
            if fe.code == "down":
                avail[k] = False
                if k in running:
                    evict(k, now)
                acc_busy_until[k] = np.inf  # down == busy forever
                cur_fin[k] = -1
                refresh_tables(now)
            elif fe.code == "up":
                avail[k] = True
                acc_busy_until[k] = now
                refresh_tables(now)
            else:  # scale: throttle multiplier transition
                old = fscale[k]
                fscale[k] = fe.value
                if k in running and fe.value != old:
                    # re-time the in-flight layer: remaining wall time
                    # stretches (or shrinks) by new_scale / old_scale
                    fin_old = float(acc_busy_until[k])
                    fin_new = now + (fin_old - now) * (fe.value / old)
                    acc_busy_until[k] = fin_new
                    dw, dh, disp_w[k], disp_h[k] = retime_busy_adjust(
                        disp_start[k], fin_new, duration, disp_w[k], disp_h[k]
                    )
                    acc_busy_time[k] += dw
                    acc_busy_in_horizon[k] += dh
                    fin_cnt = next(counter)
                    heapq.heappush(heap, (fin_new, fin_cnt, _FINISH, k))
                    cur_fin[k] = fin_cnt
                refresh_tables(now)
        elif fm is not None and evt_cnt != cur_fin[payload]:
            pass  # stale finish: its dispatch was evicted or re-timed
        else:  # _FINISH
            acc = payload
            req, _ = running.pop(acc)
            if req.dag is not None:
                # DAG node finish: no layer increment — the entry IS one
                # node.  A dropped request's still-running sibling
                # finishes as a no-op (its busy time already accrued;
                # drop accounting happened once at drop time).
                dr = req.dag
                if not dr.dropped:
                    m = req.model_idx
                    dag = plans[m].dag
                    node = req.next_layer
                    dr.n_done += 1
                    if node == dag.sink:
                        # every node is an ancestor of the unique sink,
                        # so sink finish == request completion
                        req.done_time = now
                        st = stats[m]
                        st.completed += 1
                        if now > req.deadline_abs + 1e-12:
                            st.missed += 1
                        st.retained_sum += plans[m].combo_retained(dr.applied_variants)
                        if need_backlog:
                            backlog_ns -= req.work_ns
                        if req.client is not None:
                            push_release(req.client, now)
                    else:
                        for s in dag.succs[node]:
                            dr.pending[s] -= 1
                            if dr.pending[s] == 0:
                                ready.append(
                                    Request(
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
                                )
                if heap and abs(heap[0][0] - now) < 1e-15:
                    continue
                invoke_scheduler(now)
                continue
            req.next_layer += 1
            if fm is not None:
                req.layer_frac = 0.0
            if req.is_finished(n_layers[req.model_idx]):
                req.done_time = now
                st = stats[req.model_idx]
                st.completed += 1
                if now > req.deadline_abs + 1e-12:
                    st.missed += 1
                st.retained_sum += plans[req.model_idx].combo_retained(req.applied_variants)
                if need_backlog:
                    backlog_ns -= req.work_ns
                if req.client is not None:
                    push_release(req.client, now)
            else:
                policy.on_layer_finish(req, plans[req.model_idx], req.next_layer - 1, now)
                ready.append(req)
        # batch-process simultaneous events before scheduling
        if heap and abs(heap[0][0] - now) < 1e-15:
            continue
        invoke_scheduler(now)

    # Horizon drain: a DAG request may be split over several sibling
    # entries (ready and/or running) — count the logical request once,
    # and not at all if it was already counted dropped.
    seen_runs: set = set()

    def drain_in_flight(r: Request) -> None:
        if r.dag is None:
            stats[r.model_idx].in_flight += 1
        elif not r.dag.dropped and id(r.dag) not in seen_runs:
            seen_runs.add(id(r.dag))
            stats[r.model_idx].in_flight += 1

    for r in ready:
        drain_in_flight(r)
    for r, _ in running.values():
        drain_in_flight(r)

    return SimResult(
        duration=duration,
        per_model=stats,
        acc_busy_time=acc_busy_time,
        scheduler_name=scheduler.name,
        acc_busy_in_horizon=acc_busy_in_horizon,
        rounds=rounds,
        faulted_spans=faulted_spans,
    )
