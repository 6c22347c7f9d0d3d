"""Sequential adaptive campaign sampler: stop cells when the CIs separate.

The fixed grids behind every headline claim (fig5/fig7/fig8) spend an
identical seed budget on cells whose verdict is obvious after three
replicates and on cells that genuinely need the full ladder.  PR 3 made
trials ~3.3x cheaper, so sampler logic — not trial cost — now bounds
campaign scale.  This module grows seed replicates per cell in rounds
and retires a cell as soon as its scheduler-vs-baseline comparison is
statistically settled:

* **Cells and pairing.**  A cell is one
  (scenario, platform, theta, scheduler, arrival, budget_policy)
  combination; cells that differ only in ``scheduler`` form a *group*.
  Within a group, every non-baseline scheduler is compared against the
  baseline (default ``terastal``) on *paired* per-seed metric
  differences — both cells replay the identical arrival realization per
  seed, so the pairing removes arrival noise from the gap estimate.

* **Stopping rule.**  After each round at ``k`` seeds, a comparison is
  declared *separated* when the paired percentile-bootstrap CI on the
  mean gap excludes zero at the Bonferroni-adjusted per-look level
  ``alpha / n_looks`` AND the exact paired t-test p-value clears the
  same level.  The naive small-``n`` percentile bootstrap is
  anticonservative (its measured false-separation rate exceeds the
  nominal alpha at n <= 8 — see ``tests/test_sampling_stats.py``); the
  t-gate restores family-wise type-I control over the whole sequential
  ladder, which the stats suite pins below the nominal alpha on null
  cells.  A comparison that never separates runs to the per-cell cap
  (the full seed ladder) and takes the fixed grid's verdict: the sign
  of the mean gap over all seeds.

* **Determinism contract.**  The trial stream per cell is the campaign's
  own PRNG-indexed seed ladder, consumed in order — the trials an
  adaptive run executes are exactly a prefix of ``Campaign.trials()``
  per cell.  Decisions are made at round barriers from seed-indexed
  prefixes of deterministic trial results, so parallel == serial ==
  fixed-grid-prefix, and with stopping disabled the sampler reproduces
  ``Campaign.run`` trial-for-trial (pinned by ``tests/test_sampling.py``).

* **Journal / resume.**  With ``journal=path`` every completed trial is
  appended to a JSON-lines file in deterministic order.  Re-running the
  same campaign+config against the journal replays the recorded prefix
  from cache (no re-execution) and continues bit-identically — the
  sampler is a pure function of trial results, and trial results are
  pure functions of their specs.

Torch port: a copy of the JAX package's ``core/sampling.py`` whose
:func:`run_adaptive` also takes ``device`` and hands it to its
:class:`TrialExecutor`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.campaign import (
    Campaign,
    CampaignResult,
    DegenerateSampleError,
    TrialExecutor,
    TrialResult,
    TrialSpec,
    bootstrap_ci,
)

#: Spec fields that identify a sampler cell (everything but the seed;
#: duration/engine are campaign-wide constants but kept for row identity).
CELL_FIELDS = ("scenario", "platform", "theta", "scheduler", "arrival", "budget_policy")
#: Cells that differ only in ``scheduler`` form a comparison group.
GROUP_FIELDS = tuple(f for f in CELL_FIELDS if f != "scheduler")


# ----------------------------------------------------- paired statistics ----


def _betacf(a: float, b: float, x: float) -> float:
    """Continued fraction for the regularized incomplete beta (NR 6.4)."""
    tiny, eps = 1e-30, 3e-14
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c, d = 1.0, 1.0 - qab * x / qap
    if abs(d) < tiny:
        d = tiny
    d = 1.0 / d
    h = d
    for m in range(1, 200):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        if abs(d) < tiny:
            d = tiny
        c = 1.0 + aa / c
        if abs(c) < tiny:
            c = tiny
        d = 1.0 / d
        h *= d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        if abs(d) < tiny:
            d = tiny
        c = 1.0 + aa / c
        if abs(c) < tiny:
            c = tiny
        d = 1.0 / d
        de = d * c
        h *= de
        if abs(de - 1.0) < eps:
            break
    return h


def betainc(a: float, b: float, x: float) -> float:
    """Regularized incomplete beta I_x(a, b) — no scipy in the image, so
    the t-test tail probability is computed from first principles."""
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    ln_bt = (
        math.lgamma(a + b)
        - math.lgamma(a)
        - math.lgamma(b)
        + a * math.log(x)
        + b * math.log(1.0 - x)
    )
    bt = math.exp(ln_bt)
    if x < (a + 1.0) / (a + b + 2.0):
        return bt * _betacf(a, b, x) / a
    return 1.0 - bt * _betacf(b, a, 1.0 - x) / b


def paired_t_pvalue(diffs: Sequence[float]) -> float:
    """Two-sided one-sample t-test p-value for mean(diffs) == 0.

    Degenerate variance (all diffs equal) is common in simulation —
    e.g. strictly periodic cells where every seed replays the identical
    arrival sequence: the gap is then *certain*, so p is 0.0 for a
    nonzero constant gap and 1.0 for an all-zero one."""
    d = np.asarray(list(diffs), dtype=float)
    if d.size < 2:
        raise DegenerateSampleError(
            f"paired_t_pvalue needs >= 2 paired differences, got {d.size}"
        )
    mean = float(d.mean())
    sd = float(d.std(ddof=1))
    if sd == 0.0:
        return 1.0 if mean == 0.0 else 0.0
    t = mean / (sd / math.sqrt(d.size))
    df = d.size - 1
    return betainc(df / 2.0, 0.5, df / (df + t * t))


def gap_separates(
    diffs: Sequence[float],
    alpha: float,
    n_boot: int = 1000,
    ci_seed: int = 0,
) -> Tuple[float, float, bool]:
    """One stopping-rule look: ``(ci_lo, ci_hi, separated)`` at level
    ``alpha`` (already Bonferroni-adjusted by the caller).

    Separation needs the paired percentile-bootstrap CI to exclude zero
    *and* the paired t-test to reject at the same level — the bootstrap
    alone under-covers at small n (measured in tests/test_sampling_stats
    .py), the t-gate keeps the false-separation rate below nominal."""
    lo, hi = bootstrap_ci(diffs, n_boot=n_boot, alpha=alpha, seed=ci_seed)
    separated = (lo > 0.0 or hi < 0.0) and paired_t_pvalue(diffs) <= alpha
    return lo, hi, separated


# ------------------------------------------------------------- sampler ----


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Stopping-rule knobs; the seed *cap* is the campaign's own ladder.

    ``alpha`` is the family-wise false-separation budget for one
    comparison across its whole sequential ladder; each look spends
    ``alpha / n_looks`` (Bonferroni), where the looks are at
    ``min_seeds, min_seeds + round_seeds, ..., cap``.  ``stopping=False``
    disables the rule entirely: every cell runs the full ladder and the
    sampler must reproduce ``Campaign.run`` exactly."""

    baseline: str = "terastal"
    metric: str = "mean_miss_rate"
    min_seeds: int = 3
    round_seeds: int = 1
    alpha: float = 0.05
    n_boot: int = 1000
    ci_seed: int = 0
    stopping: bool = True

    def __post_init__(self):
        if self.min_seeds < 2:
            raise ValueError(f"min_seeds must be >= 2, got {self.min_seeds}")
        if self.round_seeds < 1:
            raise ValueError(f"round_seeds must be >= 1, got {self.round_seeds}")
        if not 0.0 < self.alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1), got {self.alpha}")

    def looks(self, cap: int) -> List[int]:
        """Seed counts at which the stopping rule is evaluated: the
        ``min_seeds + i * round_seeds`` ladder, always ending at ``cap``."""
        if not self.stopping:
            return [cap]
        return list(range(min(self.min_seeds, cap), cap, self.round_seeds)) + [cap]


@dataclasses.dataclass(frozen=True)
class GapVerdict:
    """Outcome of one scheduler-vs-baseline comparison.

    ``reason`` records how the sampler settled it: ``"separated"`` (the
    CI rule fired), ``"invariant"`` (both cells are seed-invariant —
    every replicate reproduced the identical simulation outcome — so the
    gap is a constant and the verdict certain; retires strictly periodic
    cells early), or ``"cap"`` (ran the full ladder and took the fixed
    grid's sign-of-mean verdict)."""

    group: Tuple  # GROUP_FIELDS values
    scheduler: str
    baseline: str
    n_seeds: int  # paired replicates consumed when the verdict was reached
    mean_gap: float  # mean over seeds of metric(scheduler) - metric(baseline)
    ci_lo: float
    ci_hi: float
    separated: bool  # True: the CI stopping rule fired before the cap
    winner: str  # scheduler name with the lower metric, or "tie"
    reason: str = "cap"  # "separated" | "invariant" | "cap"

    def row(self) -> Dict:
        d = dict(zip(GROUP_FIELDS, self.group))
        d.update(
            scheduler=self.scheduler,
            baseline=self.baseline,
            n_seeds=self.n_seeds,
            mean_gap=self.mean_gap,
            ci_lo=self.ci_lo,
            ci_hi=self.ci_hi,
            separated=self.separated,
            winner=self.winner,
            reason=self.reason,
        )
        return d


@dataclasses.dataclass
class AdaptiveResult:
    """Sampler output: the executed trials (grid order), per-comparison
    verdicts, and the budget accounting against the fixed grid."""

    campaign: Campaign
    config: SamplerConfig
    trials: List[TrialResult]
    verdicts: List[GapVerdict]
    rounds: int
    n_trials_cap: int  # what the fixed grid would have run (cells x cap)

    @property
    def n_trials(self) -> int:
        return len(self.trials)

    def trials_saved(self) -> float:
        """Fraction of the fixed grid's trial budget left unspent."""
        return 1.0 - self.n_trials / self.n_trials_cap if self.n_trials_cap else 0.0

    def campaign_result(self) -> CampaignResult:
        """Adapter so every ``CampaignResult`` consumer (``aggregate``,
        ``grouped``, the figure benchmarks) works on adaptive output."""
        return CampaignResult(list(self.trials))


def _outcome(res: TrialResult) -> Tuple:
    """Everything the simulation observably produced (spec and wall time
    excluded) — the equality key behind the certain-tie fast path."""
    return (
        res.mean_miss_rate,
        res.mean_accuracy_loss,
        res.released,
        res.completed,
        res.dropped,
        res.variants_applied,
        res.utilization,
    )


def _cell_of(spec: TrialSpec) -> Tuple:
    return tuple(getattr(spec, f) for f in CELL_FIELDS)


def _group_of(cell: Tuple) -> Tuple:
    return tuple(v for f, v in zip(CELL_FIELDS, cell) if f != "scheduler")


def _sched_of(cell: Tuple) -> str:
    return cell[CELL_FIELDS.index("scheduler")]


# ------------------------------------------------------------- journal ----

_JOURNAL_FORMAT = "terastal-sampler-journal"
_JOURNAL_VERSION = 1


def _json_normalize(obj):
    """Canonical JSON value (tuples -> lists) for header comparison."""
    return json.loads(json.dumps(obj))


def _header(campaign: Campaign, config: SamplerConfig) -> Dict:
    return _json_normalize(
        {
            "format": _JOURNAL_FORMAT,
            "version": _JOURNAL_VERSION,
            "campaign": dataclasses.asdict(campaign),
            "config": dataclasses.asdict(config),
        }
    )


def _rebuilt_header(head: Dict) -> Optional[Dict]:
    """Re-serialize a stored header through the CURRENT dataclasses.

    A journal written before a default-valued field existed (e.g.
    ``Campaign.round_kernel``) stores a header without it; rebuilding
    fills the default, so such journals stay resumable — exactly when
    the resumed campaign is otherwise identical.  Returns ``None`` for
    headers the current dataclasses cannot represent (removed/renamed
    fields), which the caller treats as a genuine mismatch."""
    try:
        return _header(
            Campaign(**head["campaign"]), SamplerConfig(**head["config"])
        )
    except (KeyError, TypeError):
        return None


def _result_record(res: TrialResult) -> Dict:
    d = dataclasses.asdict(res)
    spec = d.pop("spec")
    return {"kind": "trial", "spec": spec, "result": d}


def _result_from_record(rec: Dict) -> TrialResult:
    spec = TrialSpec(**rec["spec"])
    fields = dict(rec["result"])
    fields["utilization"] = tuple(fields["utilization"])
    return TrialResult(spec=spec, **fields)


class SamplerJournal:
    """Append-only JSON-lines record of completed trials.

    Line 1 is a header binding the journal to one (campaign, config)
    pair; every further line is one completed ``TrialResult``.  Floats
    survive the round trip exactly (``json`` emits shortest round-trip
    reprs), so a resumed run continues bit-identically.  A truncated
    final line — the signature of a killed run — is ignored."""

    def __init__(self, path: str, campaign: Campaign, config: SamplerConfig):
        self.path = path
        self.header = _header(campaign, config)
        self.cache: Dict[Tuple, TrialResult] = {}
        if os.path.exists(path):
            self._load()
        # (Re)write header + every recovered record: a killed run can
        # leave a truncated final line, and appending after it would
        # corrupt the next record too — rewriting from the loaded cache
        # heals the file and costs one linear pass.
        self._fh = open(path, "w")
        self._write_line(self.header)
        for res in self.cache.values():
            self._write_line(_result_record(res))

    def _load(self) -> None:
        with open(self.path) as fh:
            lines = fh.read().splitlines()
        if not lines:
            return
        try:
            head = json.loads(lines[0])
        except json.JSONDecodeError as e:
            raise ValueError(f"journal {self.path}: unreadable header: {e}") from e
        if head.get("format") != _JOURNAL_FORMAT:
            raise ValueError(f"journal {self.path}: not a sampler journal")
        if head != self.header and _rebuilt_header(head) != self.header:
            raise ValueError(
                f"journal {self.path} was written by a different campaign/"
                "config; refusing to resume (delete it to start over)"
            )
        for line in lines[1:]:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                break  # truncated tail from a killed run: replay stops here
            if rec.get("kind") != "trial":
                continue
            res = _result_from_record(rec)
            self.cache[dataclasses.astuple(res.spec)] = res

    def _write_line(self, obj) -> None:
        self._fh.write(json.dumps(obj) + "\n")
        self._fh.flush()

    def record(self, res: TrialResult) -> None:
        key = dataclasses.astuple(res.spec)
        if key not in self.cache:
            self.cache[key] = res
            self._write_line(_result_record(res))

    def close(self) -> None:
        self._fh.close()


# ------------------------------------------------------------ main loop ----


def run_adaptive(
    campaign: Campaign,
    config: Optional[SamplerConfig] = None,
    *,
    parallel: bool = True,
    max_workers: Optional[int] = None,
    journal: Optional[str] = None,
    device=None,
) -> AdaptiveResult:
    """Run ``campaign`` through the sequential sampler (see module doc).

    The campaign's ``seeds`` ladder is both the replicate order and the
    per-cell cap; ``Campaign.run()`` on the same campaign is exactly the
    always-run-to-cap special case (``SamplerConfig(stopping=False)``
    reproduces it trial-for-trial).  ``device`` goes to every trial (the
    card when None)."""
    config = config or SamplerConfig()
    grid = campaign.trials()
    cap = len(campaign.seeds)
    if cap < 1:
        raise ValueError("campaign has no seeds")
    if config.stopping and cap < 2:
        raise DegenerateSampleError(
            "adaptive sampling needs a seed ladder of >= 2 (one seed has "
            "no paired variance); pass SamplerConfig(stopping=False) or "
            "grow Campaign.seeds"
        )

    # Cell -> its full seed-ladder spec list, in grid order.
    cell_specs: Dict[Tuple, List[TrialSpec]] = {}
    grid_index = {dataclasses.astuple(s): i for i, s in enumerate(grid)}
    for s in grid:
        cell_specs.setdefault(_cell_of(s), []).append(s)

    # Comparison topology: baseline vs every other scheduler per group.
    comparisons: List[Tuple[Tuple, str]] = []  # (group, scheduler)
    cell_by_group: Dict[Tuple, Dict[str, Tuple]] = {}
    for cell in cell_specs:
        cell_by_group.setdefault(_group_of(cell), {})[_sched_of(cell)] = cell
    if config.stopping:
        for group, scheds in cell_by_group.items():
            if config.baseline not in scheds:
                raise ValueError(
                    f"baseline scheduler {config.baseline!r} is not in the "
                    f"campaign grid for group {dict(zip(GROUP_FIELDS, group))}"
                )
            comparisons += [(group, s) for s in scheds if s != config.baseline]
        if not comparisons:
            raise ValueError(
                "nothing to compare: the grid only contains the baseline "
                f"scheduler {config.baseline!r} (add a second scheduler or "
                "pass SamplerConfig(stopping=False))"
            )

    looks = config.looks(cap)
    per_look_alpha = config.alpha / len(looks)

    jrnl = SamplerJournal(journal, campaign, config) if journal else None
    done: Dict[Tuple, List[TrialResult]] = {cell: [] for cell in cell_specs}
    undecided = dict.fromkeys(comparisons)  # insertion-ordered set
    verdicts: Dict[Tuple[Tuple, str], GapVerdict] = {}
    metric = config.metric
    rounds = 0

    def active_cells() -> List[Tuple]:
        if not config.stopping:
            return list(cell_specs)
        alive = set()
        for group, sched in undecided:
            alive.add(cell_by_group[group][sched])
            alive.add(cell_by_group[group][config.baseline])
        return [c for c in cell_specs if c in alive]

    try:
        with TrialExecutor(
            campaign.cell_keys(), parallel=parallel, max_workers=max_workers,
            device=device,
        ) as ex:
            for k in looks:
                batch = [
                    spec
                    for cell in active_cells()
                    for spec in cell_specs[cell][len(done[cell]) : k]
                ]
                if batch:
                    rounds += 1
                # Serve journal-cached trials without re-execution; run the
                # rest through the pool, journaling in deterministic order.
                fresh = [
                    s
                    for s in batch
                    if jrnl is None or dataclasses.astuple(s) not in jrnl.cache
                ]
                # engine="batch" grids: run_batch groups a cell's fresh
                # seed replicates and runs each group as one device
                # program (campaign.run_trial_batch), so every sampler
                # look rides the batched engine without special-casing
                # here; journal order is unchanged (specs order).
                executed = ex.run_batch(
                    fresh, on_result=jrnl.record if jrnl else None
                )
                by_key = {dataclasses.astuple(r.spec): r for r in executed}
                for s in batch:
                    key = dataclasses.astuple(s)
                    res = by_key.get(key) or jrnl.cache[key]
                    done[_cell_of(s)].append(res)

                if not config.stopping:
                    continue
                final = k == looks[-1]
                for group, sched in list(undecided):
                    a = done[cell_by_group[group][sched]]
                    b = done[cell_by_group[group][config.baseline]]
                    if len(a) < k or len(b) < k:  # cap shorter than min_seeds
                        continue
                    pairs = list(zip(a[:k], b[:k]))
                    diffs = [
                        getattr(x, metric) - getattr(y, metric) for x, y in pairs
                    ]
                    # Seed-invariant cells: every replicate of *each* cell
                    # produced the identical simulation outcome (the
                    # signature of strictly periodic cells whose arrival
                    # stream consumes no randomness), so the paired gap is
                    # a constant and further seeds cannot move it.  A
                    # nonzero constant gap separates via the zero-variance
                    # t-test below; a zero one is a certain tie — stop
                    # instead of spending the rest of the ladder on a CI
                    # that will stay [0, 0].
                    invariant = (
                        len({_outcome(x) for x, _ in pairs}) == 1
                        and len({_outcome(y) for _, y in pairs}) == 1
                    )
                    lo, hi, sep = gap_separates(
                        diffs,
                        alpha=per_look_alpha,
                        n_boot=config.n_boot,
                        ci_seed=config.ci_seed,
                    )
                    if sep or invariant or final:
                        mean_gap = float(np.mean(diffs))
                        winner = (
                            "tie"
                            if mean_gap == 0.0
                            else (sched if mean_gap < 0.0 else config.baseline)
                        )
                        verdicts[(group, sched)] = GapVerdict(
                            group=group,
                            scheduler=sched,
                            baseline=config.baseline,
                            n_seeds=k,
                            mean_gap=mean_gap,
                            ci_lo=lo,
                            ci_hi=hi,
                            separated=sep,
                            winner=winner,
                            reason="separated"
                            if sep
                            else ("invariant" if invariant else "cap"),
                        )
                        del undecided[(group, sched)]
                if not undecided:
                    break
    finally:
        if jrnl is not None:
            jrnl.close()

    trials = sorted(
        (r for results in done.values() for r in results),
        key=lambda r: grid_index[dataclasses.astuple(r.spec)],
    )
    return AdaptiveResult(
        campaign=campaign,
        config=config,
        trials=trials,
        verdicts=[verdicts[c] for c in comparisons],
        rounds=rounds,
        n_trials_cap=len(grid),
    )


def fixed_grid_verdicts(
    result: CampaignResult,
    baseline: str = "terastal",
    metric: str = "mean_miss_rate",
) -> List[GapVerdict]:
    """The fixed grid's winner per comparison — the reference the
    adaptive sampler's verdicts are matched against (sign of the mean
    paired gap over the full seed ladder; no CI, the fixed grid never
    computed one to decide)."""
    by_cell: Dict[Tuple, List[TrialResult]] = {}
    for t in result.trials:
        by_cell.setdefault(_cell_of(t.spec), []).append(t)
    cell_by_group: Dict[Tuple, Dict[str, Tuple]] = {}
    for cell in by_cell:
        cell_by_group.setdefault(_group_of(cell), {})[_sched_of(cell)] = cell
    out = []
    for group, scheds in cell_by_group.items():
        if baseline not in scheds:
            continue
        base = by_cell[cell_by_group[group][baseline]]
        for sched in scheds:
            if sched == baseline:
                continue
            other = by_cell[cell_by_group[group][sched]]
            diffs = [
                getattr(x, metric) - getattr(y, metric)
                for x, y in zip(other, base)
            ]
            mean_gap = float(np.mean(diffs))
            winner = (
                "tie" if mean_gap == 0.0 else (sched if mean_gap < 0.0 else baseline)
            )
            out.append(
                GapVerdict(
                    group=group,
                    scheduler=sched,
                    baseline=baseline,
                    n_seeds=len(diffs),
                    mean_gap=mean_gap,
                    ci_lo=float("nan"),
                    ci_hi=float("nan"),
                    separated=False,
                    winner=winner,
                )
            )
    return out
