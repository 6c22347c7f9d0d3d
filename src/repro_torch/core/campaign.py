"""Monte-Carlo simulation campaign engine.

Every scheduling claim in this repo reduces to "metric X of policy A
beats policy B over a set of (scenario, platform, arrival-model, seed)
conditions".  The seed benchmarks ground those claims in a handful of
serial `simulate()` loops with 3 seeds and strictly periodic arrivals —
too few trials for confidence intervals and zero arrival diversity.
This module turns that into a declarative campaign:

* :class:`Campaign` expands a grid of scenario x platform x theta x
  scheduler x arrival-process x seed into :class:`TrialSpec` values
  (plain strings + numbers, picklable, printable);
* :func:`run_trial` executes one spec — offline plan build (memoized
  per process), arrival generation, event-driven simulation — with a
  deterministic per-trial PRNG stream, so parallel == serial always;
* execution fans out over ``concurrent.futures.ProcessPoolExecutor``
  (the simulator is pure Python/NumPy, threads would serialize on the
  GIL), warming the plan cache in the parent first so fork()ed workers
  inherit it instead of rebuilding plans per worker;
* :class:`CampaignResult` aggregates metric distributions with
  deterministic bootstrap confidence intervals.

The default grid (periodic arrivals) reproduces the seed benchmarks
bit-for-bit — pinned by ``tests/test_campaign.py``.

Torch port: a copy of the JAX package's ``core/campaign.py`` with the
import paths moved to ``repro_torch`` (so :func:`run_trial_batch` runs
the port's batched engine).  It departs in two places only: a
``device`` keyword on :func:`run_trial`, :func:`run_trial_batch`,
:class:`TrialExecutor` and :meth:`Campaign.run`, handed to
``simulate`` / ``simulate_batch`` and to pool workers (the card when
None; specs and results stay the reference's, field for field), and
the pool spawns instead of forking once this process has initialised
CUDA.
"""

from __future__ import annotations

import concurrent.futures
import concurrent.futures.process
import dataclasses
import multiprocessing
import os
import sys
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.scheduler import ALL_SCHEDULERS, make_scheduler
from repro_torch.core.simulator import SimResult, make_arrival_process, simulate
from repro_torch.core.workload import SCENARIOS, get_scenario
from repro_torch.costmodel.maestro import PLATFORMS


# ------------------------------------------------------------- trials ----


@dataclasses.dataclass(frozen=True)
class TrialSpec:
    """One fully determined simulator run.

    All fields are strings/numbers: a spec survives pickling to pool
    workers and doubles as the row identity in result tables.  The
    ``arrival`` and ``scheduler`` fields are call-spec strings (see
    ``repro_torch.core.specs``), e.g. ``"mmpp(burstiness=4)"``.
    """

    scenario: str
    platform: str
    scheduler: str
    arrival: str = "periodic"
    seed: int = 0
    duration: float = 5.0
    theta: float = 0.90
    enable_variants: bool = True
    # Online virtual-budget policy call-spec ("static" | "reclaim" |
    # "adaptive(tick=...,beta=...)"); "static" is the paper's offline
    # budgets and reproduces the pre-policy simulator bit-for-bit.
    budget_policy: str = "static"
    # Admission/shedding policy call-spec ("none" | "shed_early(margin=...)"
    # | "token_bucket(rate=...,burst=...)"); "none" admits everything and
    # reproduces the pre-admission simulator bit-for-bit.
    admission: str = "none"
    # Simulator engine: "auto" (SoA fast path with reference fallback),
    # "soa", "reference", or "batch" — see
    # repro_torch.core.simulator.SIM_ENGINES.  The throughput benchmark pins
    # engines against each other on the same grid; results are
    # bit-identical, so this axis never changes any metric.  "batch"
    # specs are grouped by seed inside TrialExecutor and run as one
    # device program per cell (run_trial_batch) instead of per-trial
    # pool tasks; unsupported axes raise BatchUnsupportedError rather
    # than silently falling back.
    engine: str = "auto"
    # Terastal round kernel for deep ready queues: "auto" | "python" |
    # "jax" — see repro_torch.core.engine_soa.ROUND_KERNELS.  Like ``engine``,
    # bit-identical by construction (pinned by the round-kernel
    # differential tests); a perf knob, never a result knob.
    round_kernel: str = "auto"
    # Accelerator fault-model call-spec (see repro_torch.core.faults):
    # "scenario" (the default) resolves to the scenario's own
    # ``Scenario.faults`` — "none" for every pre-fault-axis catalog, so
    # existing specs stay bit-identical — while an explicit spec like
    # "down(acc=0,start=0.5,duration=1.0)" overrides it per trial.
    faults: str = "scenario"


@dataclasses.dataclass(frozen=True)
class TrialResult:
    spec: TrialSpec
    mean_miss_rate: float
    mean_accuracy_loss: float
    released: int
    completed: int
    dropped: int
    variants_applied: int
    utilization: Tuple[float, ...]
    wall_s: float
    # Scheduling rounds the trial executed (SimResult.rounds telemetry;
    # travels with the result, so pool workers report real values).
    rounds: int = 0
    # Requests shed at the admission door (subset of ``dropped``); 0 under
    # admission="none".  Defaulted so journals written before the
    # admission axis still resume cleanly.
    shed: int = 0
    # Variant-bearing models that actually completed requests — the
    # denominator behind mean_accuracy_loss (NaN when 0; see
    # SimResult.accuracy_loss_stats).  -1 on rows resumed from journals
    # written before the honest-metric fix.
    models_counted: int = -1
    # Fault-axis telemetry (0 on fault-free trials and on rows resumed
    # from journals written before the fault axis): layers evicted by
    # down events, and evicted requests later re-dispatched.
    evicted: int = 0
    remapped: int = 0

    def row(self) -> Dict:
        d = dataclasses.asdict(self.spec)
        d.update(
            mean_miss_rate=self.mean_miss_rate,
            mean_accuracy_loss=self.mean_accuracy_loss,
            released=self.released,
            completed=self.completed,
            dropped=self.dropped,
            variants_applied=self.variants_applied,
            wall_s=self.wall_s,
            rounds=self.rounds,
            shed=self.shed,
            models_counted=self.models_counted,
            evicted=self.evicted,
            remapped=self.remapped,
        )
        return d


# Offline plan construction (Algorithm 1 + variant design) dominates a
# short trial's cost and depends only on these keys — memoize per process.
# With the fork start method the parent warms this cache before creating
# the pool, so workers inherit every cell's plans for free.
_PLAN_CACHE: Dict[Tuple[str, str, float, bool], tuple] = {}


def _plans_for(scenario: str, platform: str, theta: float, enable_variants: bool):
    key = (scenario, platform, theta, enable_variants)
    if key not in _PLAN_CACHE:
        sc = get_scenario(scenario)  # paper catalog + saturation family
        _PLAN_CACHE[key] = sc.plans(
            PLATFORMS[platform], theta=theta, enable_variants=enable_variants
        )
    return _PLAN_CACHE[key]


def _resolve_faults(spec: TrialSpec) -> str:
    """Resolve a spec's fault axis: ``"scenario"`` defers to the
    scenario's own default (None -> ``"none"``), anything else is a
    fault-model call-spec passed through verbatim."""
    if spec.faults == "scenario":
        return get_scenario(spec.scenario).faults or "none"
    return spec.faults


def _warm_plan_cache(keys: Sequence[Tuple[str, str, float, bool]]) -> None:
    """Pool-worker initializer: prime ``_PLAN_CACHE`` for the campaign's
    cells at worker startup.  Fork workers inherit the parent's warm cache
    (this is then a no-op); spawn workers start from a cold interpreter
    and would otherwise each rebuild the offline plans (Algorithm 1 +
    variant design) inside their first ``run_trial``."""
    for key in keys:
        _plans_for(*key)


#: test hook (tests/test_executor_crash.py): when set, :func:`run_trial`
#: kills its process before simulating — "always" unconditionally, any
#: other value is a sentinel path killed through exactly once (the first
#: process to atomically create the file dies; every later call runs
#: normally).  Exercises the pool-crash recovery below under both fork
#: and spawn start methods; unset in production.
_CRASH_ENV = "REPRO_TRIAL_CRASH"

#: pool-crash recovery budget: how many times :class:`TrialExecutor`
#: rebuilds a broken worker pool before raising
#: :class:`ExecutorCrashError`.  Default 1 preserves the historical
#: rebuild-once semantics; raise it on flaky shared hosts where more
#: than one unrelated OOM-kill per campaign is plausible.  Rebuild n
#: waits ``min(_REBUILD_BACKOFF_CAP_S, _REBUILD_BACKOFF_BASE_S *
#: 2**(n-1))`` seconds first so a transiently-starved machine gets
#: breathing room instead of an immediate re-crash.
_RETRIES_ENV = "REPRO_EXECUTOR_RETRIES"
_REBUILD_BACKOFF_BASE_S = 0.1
_REBUILD_BACKOFF_CAP_S = 5.0


def _executor_retries() -> int:
    raw = os.environ.get(_RETRIES_ENV)
    if raw is None or not raw.strip():
        return 1
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"{_RETRIES_ENV}={raw!r}: expected a non-negative integer"
        ) from None
    if n < 0:
        raise ValueError(
            f"{_RETRIES_ENV}={raw!r}: expected a non-negative integer"
        )
    return n


def _maybe_crash() -> None:
    how = os.environ.get(_CRASH_ENV)
    if not how:
        return
    if how != "always":
        try:
            fd = os.open(how, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return
        os.close(fd)
    os._exit(1)


def run_trial(spec: TrialSpec, device=None) -> TrialResult:
    """Execute one trial: reusable by the pool, benchmarks, and tests.

    The per-trial PRNG stream is fully determined by ``spec.seed`` (the
    arrival generator seeds ``np.random.default_rng(seed)`` itself), so
    re-running a spec anywhere — serially, in a pool worker, on another
    host — yields the identical :class:`TrialResult`.
    """
    _maybe_crash()
    t0 = time.perf_counter()
    plans, tasks = _plans_for(spec.scenario, spec.platform, spec.theta, spec.enable_variants)
    # spec.arrival is the default for the cell; an entry that pins its own
    # process in the scenario definition keeps it (Scenario.plans contract).
    proc = make_arrival_process(spec.arrival)
    res: SimResult = simulate(
        plans,
        tasks,
        spec.duration,
        make_scheduler(spec.scheduler),
        seed=spec.seed,
        processes=[t.arrival or proc for t in tasks],
        budget_policy=spec.budget_policy,
        admission=spec.admission,
        engine=spec.engine,
        round_kernel=spec.round_kernel,
        faults=_resolve_faults(spec),
        device=device,
    )
    agg = {"released": 0, "completed": 0, "dropped": 0, "variants_applied": 0,
           "shed": 0, "evicted": 0, "remapped": 0}
    for st in res.per_model.values():
        agg["released"] += st.released
        agg["completed"] += st.completed
        agg["dropped"] += st.dropped
        agg["variants_applied"] += st.variants_applied
        agg["shed"] += st.shed
        agg["evicted"] += st.evicted
        agg["remapped"] += st.remapped
    loss, counted, _ = res.accuracy_loss_stats(plans)
    return TrialResult(
        spec=spec,
        mean_miss_rate=res.mean_miss_rate,
        mean_accuracy_loss=loss,
        utilization=tuple(float(u) for u in res.utilization()),
        wall_s=time.perf_counter() - t0,
        rounds=res.rounds or 0,
        models_counted=counted,
        **agg,
    )


def run_trial_batch(specs: Sequence[TrialSpec], device=None) -> List[TrialResult]:
    """Execute a seed batch of one cell as ONE device program.

    ``specs`` must be identical except for ``seed`` — one campaign cell's
    seed replicates, the exact shape ``engine="batch"`` exists for.  Each
    returned :class:`TrialResult` matches ``run_trial(spec)`` field for
    field (same metrics bit-for-bit — the batched engine is
    fingerprint-identical — and the same aggregation arithmetic); only
    ``wall_s`` differs in meaning: the batch wall clock divided evenly
    across the seeds, so campaign wall-time accounting still sums to
    reality.  Unsupported axes raise
    :class:`repro_torch.core.engine_batch.BatchUnsupportedError` — a cell that
    cannot be batched must be requested with a scalar engine, never
    silently downgraded.
    """
    from repro_torch.core.engine_batch import simulate_batch

    specs = list(specs)
    if not specs:
        return []
    base = dataclasses.replace(specs[0], seed=0)
    for sp in specs[1:]:
        if dataclasses.replace(sp, seed=0) != base:
            raise ValueError(
                "run_trial_batch needs specs identical except seed; got "
                f"{sp} vs {specs[0]}"
            )
    t0 = time.perf_counter()
    plans, tasks = _plans_for(
        base.scenario, base.platform, base.theta, base.enable_variants
    )
    proc = make_arrival_process(base.arrival)
    sims = simulate_batch(
        plans,
        tasks,
        base.duration,
        make_scheduler(base.scheduler),
        [sp.seed for sp in specs],
        processes=[t.arrival or proc for t in tasks],
        budget_policy=base.budget_policy,
        admission=base.admission,
        faults=_resolve_faults(base),
        device=device,
    )
    wall = (time.perf_counter() - t0) / len(specs)
    out: List[TrialResult] = []
    for sp, res in zip(specs, sims):
        agg = {"released": 0, "completed": 0, "dropped": 0,
               "variants_applied": 0, "shed": 0, "evicted": 0, "remapped": 0}
        for st in res.per_model.values():
            agg["released"] += st.released
            agg["completed"] += st.completed
            agg["dropped"] += st.dropped
            agg["variants_applied"] += st.variants_applied
            agg["shed"] += st.shed
            agg["evicted"] += st.evicted
            agg["remapped"] += st.remapped
        loss, counted, _ = res.accuracy_loss_stats(plans)
        out.append(TrialResult(
            spec=sp,
            mean_miss_rate=res.mean_miss_rate,
            mean_accuracy_loss=loss,
            utilization=tuple(float(u) for u in res.utilization()),
            wall_s=wall,
            rounds=res.rounds or 0,
            models_counted=counted,
            **agg,
        ))
    return out


# ---------------------------------------------------- trial execution ----


_POOL_ERRORS = (
    OSError,
    PermissionError,
    concurrent.futures.process.BrokenProcessPool,
)

_BrokenPool = concurrent.futures.process.BrokenProcessPool


class ExecutorCrashError(RuntimeError):
    """The trial worker pool crashed twice (``BrokenProcessPool``).

    One crash is survivable — a worker OOM-killed or segfaulted once —
    so :class:`TrialExecutor` rebuilds the pool and retries the
    in-flight trials.  A second crash means some trial kills its worker
    deterministically; retrying it in the parent would kill the whole
    campaign, so the executor surfaces this named error instead (run
    the offending spec with ``parallel=False`` to debug in-process)."""


class _ImmediateFuture:
    """Future-alike for the serial fallback: runs the trial at result()."""

    __slots__ = ("_spec", "_device")

    def __init__(self, spec: TrialSpec, device=None):
        self._spec = spec
        self._device = device

    def result(self) -> TrialResult:
        return run_trial(self._spec, self._device)


class TrialExecutor:
    """Streaming submit/collect executor for campaign trials.

    The process pool that used to live inside ``Campaign.run`` as a
    one-shot ``map``, refactored into a reusable resource so callers
    that do not know their trial list up front — the sequential sampler
    grows cells round by round — can keep submitting against one warm
    pool.  Semantics preserved from ``Campaign.run``:

    * fork start method when safe (workers inherit the parent's warm
      offline-plan cache), spawn otherwise, with ``_warm_plan_cache`` as
      the pool initializer primed with this campaign's cell keys;
    * any pool-unavailability error (sandbox, no ``fork``, spawn without
      an importable ``__main__``) degrades to serial execution with a
      warning, never to a crash — results are identical either way
      because trials are pure functions of their spec;
    * a pool that BREAKS mid-flight (``BrokenProcessPool`` — a worker
      was killed) is rebuilt once and the in-flight trials are retried
      in the new pool, never in the parent (a trial that kills its
      worker would kill the campaign); a second crash raises
      :class:`ExecutorCrashError`.

    The pool is created lazily on first use, so constructing an executor
    for a grid that turns out to be fully journal-cached costs nothing.
    """

    def __init__(
        self,
        cell_keys: Sequence[Tuple[str, str, float, bool]] = (),
        parallel: bool = True,
        max_workers: Optional[int] = None,
        device=None,
    ):
        self.cell_keys = list(cell_keys)
        self.device = device
        self.max_workers = max_workers or os.cpu_count() or 1
        self.parallel = parallel and self.max_workers > 1
        self._pool = None
        # pool rebuilds spent / allowed (REPRO_EXECUTOR_RETRIES, default
        # 1 — the historical rebuild-once-then-ExecutorCrashError)
        self._rebuilds = 0
        self.max_rebuilds = _executor_retries()

    # -- lifecycle ---------------------------------------------------------

    def __enter__(self) -> "TrialExecutor":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def close(self) -> None:
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown()

    def _degrade(self, err: BaseException) -> None:
        warnings.warn(f"process pool unavailable ({err!r}); running serially")
        self.parallel = False
        self.close()

    def _rebuild(self, err: BaseException) -> None:
        """A worker crash broke the pool: tear it down so the next
        ``_ensure_pool`` builds a fresh one.  Allowed ``max_rebuilds``
        times (REPRO_EXECUTOR_RETRIES, default 1) with capped
        exponential backoff between attempts — exhausting the budget
        raises :class:`ExecutorCrashError` (never degrade a crashing
        trial into the parent process)."""
        if self._rebuilds >= self.max_rebuilds:
            raise ExecutorCrashError(
                f"trial worker pool crashed again after "
                f"{self._rebuilds} rebuild(s) ({err!r}); a trial is "
                "killing its worker deterministically — run it with "
                "parallel=False to debug in-process, or raise "
                f"{_RETRIES_ENV} if the host is genuinely flaky"
            ) from err
        self._rebuilds += 1
        delay = min(
            _REBUILD_BACKOFF_CAP_S,
            _REBUILD_BACKOFF_BASE_S * 2 ** (self._rebuilds - 1),
        )
        warnings.warn(
            f"trial worker pool crashed ({err!r}); rebuilding the pool "
            f"(attempt {self._rebuilds}/{self.max_rebuilds}, backoff "
            f"{delay:.1f}s) and retrying the in-flight trials"
        )
        time.sleep(delay)
        self.close()

    def _ensure_pool(self):
        if not self.parallel:
            return None
        if self._pool is None:
            # fork is fastest (workers inherit the warm plan cache), but
            # JAX's runtime is multi-threaded and fork()ing after it
            # loads can deadlock — fall back to spawn when jax is
            # already in-process; so does a process that has
            # initialised CUDA (torch is read only if already loaded).
            methods = multiprocessing.get_all_start_methods()
            torch_mod = sys.modules.get("torch")
            cuda_up = torch_mod is not None and torch_mod.cuda.is_initialized()
            method = ("fork" if ("fork" in methods and "jax" not in sys.modules
                                 and not cuda_up) else "spawn")
            if method == "fork":
                # Warm the offline-plan cache before the pool exists so
                # lazily-created workers inherit it and skip the expensive
                # Algorithm-1 rebuild.  Spawn workers can't inherit memory
                # — the pool initializer primes each one at startup
                # instead of paying the rebuild inside its first run_trial.
                _warm_plan_cache(self.cell_keys)
            try:
                self._pool = concurrent.futures.ProcessPoolExecutor(
                    max_workers=self.max_workers,
                    mp_context=multiprocessing.get_context(method),
                    initializer=_warm_plan_cache,
                    initargs=(self.cell_keys,),
                )
            except _POOL_ERRORS as e:
                self._degrade(e)
        return self._pool

    # -- execution ---------------------------------------------------------

    def submit(self, spec: TrialSpec):
        """Schedule one trial; returns a future-alike with ``result()``."""
        pool = self._ensure_pool()
        if pool is not None:
            try:
                return pool.submit(run_trial, spec, self.device)
            except _BrokenPool as e:
                # the pool broke under an earlier submission: rebuild
                # once (raises ExecutorCrashError on the second crash)
                # and resubmit into the fresh pool
                self._rebuild(e)
                pool = self._ensure_pool()
                if pool is not None:
                    try:
                        return pool.submit(run_trial, spec, self.device)
                    except (_POOL_ERRORS + (RuntimeError,)) as e2:
                        self._degrade(e2)
            except (_POOL_ERRORS + (RuntimeError,)) as e:
                self._degrade(e)
        return _ImmediateFuture(spec, self.device)

    def run_batch(self, specs: Sequence[TrialSpec], on_result=None) -> List[TrialResult]:
        """Execute ``specs``; results come back in specs order regardless
        of completion order.  ``on_result`` (if given) fires once per
        trial in that same deterministic order — the sampler's journal
        hook, so an interrupted run leaves a clean specs-order prefix on
        disk.  A pool that breaks mid-batch is rebuilt once and the
        uncollected trials are resubmitted (results still emit in specs
        order); a second break raises :class:`ExecutorCrashError`."""
        specs = list(specs)
        # engine="batch" specs never go to the pool: the batched engine's
        # whole point is replacing process-per-trial with one in-process
        # device program per seed group.  Group by everything-but-seed in
        # first-appearance order, run each group through run_trial_batch,
        # then emit all results (pool and batch) in specs order.
        done: Dict[int, TrialResult] = {}
        groups: Dict[TrialSpec, List[int]] = {}
        for i, s in enumerate(specs):
            if s.engine == "batch":
                groups.setdefault(dataclasses.replace(s, seed=0), []).append(i)
        for idxs in groups.values():
            for i, res in zip(idxs, run_trial_batch([specs[i] for i in idxs], self.device)):
                done[i] = res
        futures = [
            None if i in done else self.submit(s) for i, s in enumerate(specs)
        ]
        results: List[TrialResult] = []
        i = 0
        while i < len(specs):
            fut = futures[i]
            if fut is None:
                res = done[i]
            else:
                try:
                    res = fut.result()
                except _BrokenPool as e:
                    # a worker crash voided every outstanding future:
                    # rebuild the pool once (second crash raises
                    # ExecutorCrashError) and resubmit the uncollected
                    # tail — never run a suspect trial in the parent
                    self._rebuild(e)
                    for j in range(i, len(specs)):
                        if futures[j] is not None:
                            futures[j] = self.submit(specs[j])
                    continue
                except _POOL_ERRORS as e:
                    self._degrade(e)
                    res = run_trial(specs[i], self.device)
            results.append(res)
            if on_result is not None:
                on_result(res)
            i += 1
        return results

    def map(self, specs: Sequence[TrialSpec], chunksize: int = 1) -> List[TrialResult]:
        """One-shot chunked map over a known grid (``Campaign.run``)."""
        specs = list(specs)
        if any(s.engine == "batch" for s in specs):
            # seed-grouped in-process path (plus pool for the rest)
            return self.run_batch(specs)
        pool = self._ensure_pool()
        while pool is not None:
            try:
                return list(pool.map(run_trial, specs, [self.device] * len(specs),
                                     chunksize=chunksize))
            except _BrokenPool as e:
                # trials are pure functions of their spec: re-mapping the
                # whole list after the one allowed rebuild is safe
                self._rebuild(e)
                pool = self._ensure_pool()
            except _POOL_ERRORS as e:
                self._degrade(e)
                pool = None
        return [run_trial(s, self.device) for s in specs]


# -------------------------------------------------------- aggregation ----


class DegenerateSampleError(ValueError):
    """A confidence interval was requested over a degenerate sample.

    Raised by :func:`bootstrap_ci` (and therefore
    :meth:`CampaignResult.aggregate`) on < 2 values: an empty sample has
    no mean and a single value has no resampling distribution, so the
    old behaviors — a silent NaN interval and a zero-width point
    interval — both read as "statistically grounded" in result tables
    while meaning nothing.  Callers that genuinely want a point estimate
    should report the mean without an interval."""


def bootstrap_ci(
    values: Sequence[float],
    n_boot: int = 1000,
    alpha: float = 0.05,
    seed: int = 0,
) -> Tuple[float, float]:
    """Percentile bootstrap CI for the mean of ``values`` (deterministic).

    Raises :class:`DegenerateSampleError` on fewer than 2 values."""
    vals = np.asarray(list(values), dtype=float)
    if vals.size < 2:
        raise DegenerateSampleError(
            f"bootstrap_ci needs >= 2 values, got {vals.size}; a "
            "degenerate sample has no resampling distribution (report "
            "the point estimate without an interval instead)"
        )
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, vals.size, size=(n_boot, vals.size))
    means = vals[idx].mean(axis=1)
    lo, hi = np.percentile(means, [100 * alpha / 2, 100 * (1 - alpha / 2)])
    return (float(lo), float(hi))


@dataclasses.dataclass
class CampaignResult:
    trials: List[TrialResult]

    def rows(self) -> List[Dict]:
        return [t.row() for t in self.trials]

    def grouped(self, by: Sequence[str]) -> "Dict[Tuple, List[TrialResult]]":
        """Trials keyed by spec fields, in first-appearance (grid) order."""
        out: Dict[Tuple, List[TrialResult]] = {}
        for t in self.trials:
            key = tuple(getattr(t.spec, f) for f in by)
            out.setdefault(key, []).append(t)
        return out

    def aggregate(
        self,
        by: Sequence[str] = ("scenario", "platform", "scheduler", "arrival"),
        metric: str = "mean_miss_rate",
        n_boot: int = 1000,
        alpha: float = 0.05,
        ci_seed: int = 0,
    ) -> List[Dict]:
        """One row per group: mean of ``metric`` + bootstrap CI over trials
        (normally the seed axis).  Group order follows the grid."""
        rows = []
        for key, ts in self.grouped(by).items():
            vals = [getattr(t, metric) for t in ts]
            lo, hi = bootstrap_ci(vals, n_boot=n_boot, alpha=alpha, seed=ci_seed)
            row = dict(zip(by, key))
            row.update(
                {
                    metric: float(np.mean(vals)),
                    f"{metric}_ci_lo": lo,
                    f"{metric}_ci_hi": hi,
                    "n_trials": len(vals),
                }
            )
            rows.append(row)
        return rows


# ------------------------------------------------------------ campaign ----


@dataclasses.dataclass
class Campaign:
    """Declarative (scenario x platform x theta x scheduler x arrival x
    budget-policy x admission x faults x seed) grid plus its executor.

    ``platforms=None`` pairs each scenario with its Table-I hardware
    settings (the Fig. 5 cells); an explicit list applies every platform
    to every scenario.  Grid expansion order is deterministic: cell,
    then theta, then scheduler, then arrival, then budget policy, then
    admission, then faults, then seed — benchmark tables depend on it.
    """

    scenarios: Sequence[str] = ()
    platforms: Optional[Sequence[str]] = None
    schedulers: Sequence[str] = ALL_SCHEDULERS
    arrivals: Sequence[str] = ("periodic",)
    budget_policies: Sequence[str] = ("static",)
    admissions: Sequence[str] = ("none",)
    seeds: Sequence[int] = (0, 1, 2)
    duration: float = 5.0
    thetas: Sequence[float] = (0.90,)
    enable_variants: bool = True
    engine: str = "auto"  # simulator engine for every trial in the grid
    round_kernel: str = "auto"  # Terastal round kernel (engine_soa.ROUND_KERNELS)
    # Fault-model axis: "scenario" defers to each scenario's own default
    # (fault-free outside FAULT_SCENARIOS); explicit call-specs compare
    # fault shapes on one workload.
    faults: Sequence[str] = ("scenario",)

    def cells(self) -> List[Tuple[str, str]]:
        # explicit names may come from either catalog (the saturation
        # family included); the default grid stays the paper's SCENARIOS
        names = list(self.scenarios) or list(SCENARIOS)
        out = []
        for name in names:
            pns = (
                self.platforms
                if self.platforms is not None
                else get_scenario(name).platform_names
            )
            for pn in pns:
                out.append((name, pn))
        return out

    def trials(self) -> List[TrialSpec]:
        out = []
        for sc, pn in self.cells():
            for theta in self.thetas:
                for sched in self.schedulers:
                    for arr in self.arrivals:
                        for pol in self.budget_policies:
                            for adm in self.admissions:
                                for flt in self.faults:
                                    for seed in self.seeds:
                                        out.append(
                                            TrialSpec(
                                                scenario=sc,
                                                platform=pn,
                                                scheduler=sched,
                                                arrival=arr,
                                                seed=int(seed),
                                                duration=self.duration,
                                                theta=theta,
                                                enable_variants=self.enable_variants,
                                                budget_policy=pol,
                                                admission=adm,
                                                engine=self.engine,
                                                round_kernel=self.round_kernel,
                                                faults=flt,
                                            )
                                        )
        return out

    def cell_keys(self) -> List[Tuple[str, str, float, bool]]:
        """Offline-plan cache keys for every cell — the pool-initializer
        payload shared by :class:`TrialExecutor` users."""
        return [
            (sc, pn, theta, self.enable_variants)
            for sc, pn in self.cells()
            for theta in self.thetas
        ]

    def run(
        self,
        parallel: bool = True,
        max_workers: Optional[int] = None,
        chunksize: Optional[int] = None,
        device=None,
    ) -> CampaignResult:
        """Execute the grid; results come back in grid order regardless of
        completion order, and parallel output equals serial output exactly
        (per-trial PRNG streams depend only on the spec).  ``device`` is
        where the trials' device work runs (the card when None)."""
        specs = self.trials()
        n_workers = max_workers or os.cpu_count() or 1
        if not parallel or n_workers <= 1 or len(specs) <= 1:
            return CampaignResult([run_trial(s, device) for s in specs])
        cs = chunksize or max(1, len(specs) // (n_workers * 4))
        with TrialExecutor(
            self.cell_keys(), parallel=True, max_workers=n_workers, device=device
        ) as ex:
            return CampaignResult(ex.map(specs, chunksize=cs))
