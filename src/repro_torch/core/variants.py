"""Layer-variant design (paper Sec. IV-B) and the per-model offline plan.

Given a model's latency table and the Algorithm-1 budgets/constraint
levels, select latency-critical layers (those whose constraint level
excluded at least one accelerator), and for each design the minimum-gamma
S2D/D2S variant that brings the excluded accelerators' latency down to
the next constraint level or below the preferred accelerator's latency
(the paper's evaluation uses the latter criterion; gamma in {2, 3}).

The offline product is a :class:`ModelPlan`: latency tables for originals
and variants, virtual budgets, per-variant accuracy losses, and the valid
combination set ``V_m`` (all subsets whose retained accuracy >= theta_m).
Because adding a variant only ever reduces accuracy, validity is
*downward-closed*, so the scheduler's incremental membership test
``is_valid_combo(applied | {l})`` is exactly equivalent to consulting the
enumerated ``V_m`` — we provide both forms (enumeration for the paper's
figures, O(set) incremental check for the hot path).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.accuracy import combo_retained_fraction, layer_variant_loss
from repro_torch.core.budget import BudgetResult, distribute_budgets, distribute_budgets_dag
from repro_torch.core.dag import LayerDag
from repro_torch.costmodel.dnn_zoo import DnnModel
from repro_torch.costmodel.layers import LayerSpec, make_variant, variant_feasible
from repro_torch.costmodel.maestro import Dataflow, Platform, layer_latency, model_latency_table

GAMMAS = (2, 3)  # paper Sec. V-B1: gamma in {2, 3} suffices


@dataclasses.dataclass(frozen=True)
class VariantInfo:
    layer_idx: int
    gamma: int
    direction: str  # "d2s" | "s2d"
    spec: LayerSpec
    latencies: np.ndarray  # [n_acc] profiled variant latency per accelerator
    loss: float  # relative accuracy loss of this single variant
    storage_weights: int  # extra weights stored


@dataclasses.dataclass
class ModelPlan:
    """Everything the online scheduler needs about one model."""

    model: DnnModel
    platform: Platform
    deadline: float
    lat: np.ndarray  # [L, n_acc] original latencies
    budget: BudgetResult
    variants: Dict[int, VariantInfo]  # layer_idx -> variant
    theta: float  # accuracy threshold (relative to baseline)
    #: precedence structure; None == linear chain (the degenerate case,
    #: which keeps every pre-DAG code path — and its floats — untouched)
    dag: Optional[LayerDag] = None

    # ---- derived tables (cached: consumed in the simulator hot loop) -------
    @functools.cached_property
    def lat_var(self) -> np.ndarray:
        """[L, n_acc] variant latencies; +inf where no variant exists."""
        out = np.full_like(self.lat, np.inf)
        for idx, v in self.variants.items():
            out[idx] = v.latencies
        return out

    @functools.cached_property
    def min_lat(self) -> np.ndarray:
        """[L] minimum achievable latency per layer (original impl)."""
        return self.lat.min(axis=1)

    @functools.cached_property
    def min_lat_any(self) -> np.ndarray:
        """[L] minimum over original AND variant implementations."""
        return np.minimum(self.lat.min(axis=1), self.lat_var.min(axis=1))

    @functools.cached_property
    def lat_skew(self) -> np.ndarray:
        """[L] cross-accelerator latency skew (max/min) per layer."""
        return self.lat.max(axis=1) / self.lat.min(axis=1)

    @functools.cached_property
    def remaining_min(self) -> np.ndarray:
        """[L+1] sum of min original latencies of layers >= l (for drops/EDF)."""
        rm = np.zeros(len(self.model.layers) + 1)
        rm[:-1] = np.cumsum(self.min_lat[::-1])[::-1]
        return rm

    @functools.cached_property
    def vdl_rel(self) -> np.ndarray:
        """[L] relative virtual deadlines (Eq. 2): cumsum of budgets for
        linear chains (same floats as ever), the critical-path targets
        computed by ``tighten_budgets_dag`` for DAG plans."""
        return self.budget.virtual_deadlines

    @functools.cached_property
    def crit_from(self) -> np.ndarray:
        """[L] minimum remaining work from node l to request completion,
        inclusive of l: the critical path over ``min_lat`` of the
        sub-DAG rooted at l.  For linear chains this IS
        ``remaining_min[:-1]`` (the same floats — a slice, not a
        recompute — which keeps EDF/DREAM/drop decisions bit-identical
        through the refactor)."""
        if self.dag is None:
            return self.remaining_min[:-1]
        cf = np.zeros(len(self.model.layers))
        for l in reversed(self.dag.topo):
            ss = self.dag.succs[l]
            tail = max((float(cf[s]) for s in ss), default=0.0)
            cf[l] = float(self.min_lat[l]) + tail
        return cf

    @functools.cached_property
    def crit_after(self) -> np.ndarray:
        """[L] minimum work strictly after node l (0.0 at the sink):
        ``remaining_min[1:]`` for linear chains, max over successors of
        ``crit_from`` for DAGs.  EDF's per-layer deadline and Terastal's
        budget-free virtual deadline read this."""
        if self.dag is None:
            return self.remaining_min[1:]
        ca = np.zeros(len(self.model.layers))
        for l in range(len(ca)):
            ca[l] = max(
                (float(self.crit_from[s]) for s in self.dag.succs[l]),
                default=0.0,
            )
        return ca

    @functools.cached_property
    def crit_total(self) -> float:
        """Minimum end-to-end work of one request (admission work
        estimates): ``remaining_min[0]`` for linear chains, the longest
        source-to-sink path for DAGs."""
        if self.dag is None:
            return float(self.remaining_min[0])
        return max(float(self.crit_from[s]) for s in self.dag.sources)

    # ---- scalar mirrors for the SoA engine's Python-level hot loops -------
    #
    # The structure-of-arrays simulator (repro_torch.core.engine_soa) runs its
    # scheduler kernels on plain Python floats: for the tiny per-decision
    # working sets (n_acc ~ 3, a handful of ready layers) scalar arithmetic
    # beats NumPy's per-call dispatch by an order of magnitude, and IEEE
    # semantics are identical, so results stay bit-equal to the ndarray
    # reference path.  Cached once per plan; plans themselves are memoized
    # per process by the campaign layer, so every trial shares these.

    @functools.cached_property
    def lat_rows(self) -> Tuple[Tuple[float, ...], ...]:
        """[L][n_acc] original latencies as tuples of Python floats."""
        return tuple(tuple(float(x) for x in row) for row in self.lat)

    @functools.cached_property
    def lat_var_rows(self) -> Tuple[Optional[Tuple[float, ...]], ...]:
        """[L] variant latency rows (None where no variant exists)."""
        return tuple(
            tuple(float(x) for x in self.lat_var[l]) if l in self.variants else None
            for l in range(len(self.model.layers))
        )

    @functools.cached_property
    def remaining_min_list(self) -> Tuple[float, ...]:
        """[L+1] ``remaining_min`` as Python floats."""
        return tuple(float(x) for x in self.remaining_min)

    @functools.cached_property
    def vdl_rel_list(self) -> Tuple[float, ...]:
        """[L] ``vdl_rel`` as Python floats."""
        return tuple(float(x) for x in self.vdl_rel)

    @functools.cached_property
    def min_lat_list(self) -> Tuple[float, ...]:
        """[L] ``min_lat`` as Python floats (stage-2's min_k c_{l+1,k})."""
        return tuple(float(x) for x in self.min_lat)

    @functools.cached_property
    def crit_from_list(self) -> Tuple[float, ...]:
        """[L] ``crit_from`` as Python floats."""
        return tuple(float(x) for x in self.crit_from)

    @functools.cached_property
    def crit_after_list(self) -> Tuple[float, ...]:
        """[L] ``crit_after`` as Python floats."""
        return tuple(float(x) for x in self.crit_after)

    @functools.cached_property
    def acc_pref_rows(self) -> Tuple[Tuple[int, ...], ...]:
        """[L][n_acc] accelerator indices by ascending original latency
        (stable: ties keep lower index).  Walking this order and taking
        the first idle accelerator reproduces ``min(idle, key=latency)``
        exactly — the FCFS/EDF placement rule — without per-call float
        comparisons."""
        return tuple(
            tuple(int(k) for k in np.argsort(row, kind="stable")) for row in self.lat
        )

    @functools.cached_property
    def single_variant_ok(self) -> Tuple[bool, ...]:
        """[L] whether applying ONLY layer l's variant is a valid combo —
        the common ``applied_variants == frozenset()`` membership test,
        precomputed (requests that already carry variants fall back to the
        live ``is_valid_combo`` check)."""
        return tuple(
            l in self.variants and self.is_valid_combo(frozenset((l,)))
            for l in range(len(self.model.layers))
        )

    def loss_of(self, layer_idx: int) -> float:
        return self.variants[layer_idx].loss

    def combo_retained(self, combo: FrozenSet[int]) -> float:
        return combo_retained_fraction(self.variants[i].loss for i in combo)

    def is_valid_combo(self, combo: FrozenSet[int]) -> bool:
        return self.combo_retained(combo) >= self.theta

    def valid_combos(self, max_enum: int = 20) -> List[FrozenSet[int]]:
        """Enumerated V_m (paper Sec. IV-B). Exhaustive for <= max_enum
        variant layers; validity is downward-closed so enumeration by
        increasing size with pruning is exact."""
        idxs = sorted(self.variants)
        if len(idxs) > max_enum:
            raise ValueError(f"{len(idxs)} variant layers; use is_valid_combo")
        valid: List[FrozenSet[int]] = [frozenset()]
        frontier: List[FrozenSet[int]] = [frozenset()]
        while frontier:
            nxt: Set[FrozenSet[int]] = set()
            for combo in frontier:
                start = max(combo) + 1 if combo else 0
                for i in idxs:
                    if i < start or i in combo:
                        continue
                    cand = combo | {i}
                    if self.is_valid_combo(cand):
                        nxt.add(frozenset(cand))
            valid.extend(sorted(nxt, key=sorted))
            frontier = list(nxt)
        return valid

    @property
    def storage_overhead(self) -> float:
        """Extra weights stored for variants / original model weights."""
        total = self.model.total_weights
        if total == 0:
            return 0.0
        return sum(v.storage_weights for v in self.variants.values()) / total


def _design_layer_variant(
    spec: LayerSpec,
    lat_row: np.ndarray,
    levels: np.ndarray,
    rho: int,
    platform: Platform,
) -> Optional[Tuple[int, str, LayerSpec, np.ndarray]]:
    """Pick (gamma, direction) for one latency-critical layer, or None.

    Target accelerators: those excluded at constraint level rho, i.e. with
    original latency > c^{down(rho)} ... >= c^{down(1)}.  Success criterion
    (paper Sec. V-A): the variant's latency on every target accelerator is
    at or below the preferred accelerator's original latency — relaxed to
    the next constraint level if that is looser (Sec. IV-A last para).
    """
    if rho <= 0:
        return None  # no accelerator excluded; no variant needed
    c_ref = levels[rho]
    targets = [k for k in range(len(lat_row)) if lat_row[k] > c_ref + 1e-15]
    if not targets:
        return None
    preferred_lat = float(lat_row.min())
    # allow meeting the *next* level below the current one when that is
    # looser than the preferred latency (paper allows either).
    goal = max(preferred_lat, float(levels[min(rho + 1, len(levels) - 1)]))
    # direction: counteract the dataflow of the slowest excluded accelerator
    worst_k = max(targets, key=lambda k: lat_row[k])
    tgt_df = platform.accelerators[worst_k].dataflow
    direction = "d2s" if tgt_df == Dataflow.OS else "s2d"
    for gamma in GAMMAS:
        if not variant_feasible(spec, gamma, direction):
            continue
        vspec = make_variant(spec, gamma, direction)
        vlat = np.array([layer_latency(vspec, a, platform) for a in platform.accelerators])
        if all(vlat[k] <= goal + 1e-15 for k in targets) and all(
            vlat[k] < lat_row[k] for k in targets
        ):
            return gamma, direction, vspec, vlat
    return None


def build_model_plan(
    model: DnnModel,
    platform: Platform,
    deadline: float,
    theta: float = 0.90,
    enable_variants: bool = True,
) -> ModelPlan:
    """The full offline stage for one model: budgets + variant design.

    A model carrying a :class:`LayerDag` routes through the
    critical-path tightening (``distribute_budgets_dag``); linear models
    keep the exact pre-DAG path (``distribute_budgets``), bit for bit.
    """
    lat = model_latency_table(model.layers, platform)
    dag = getattr(model, "dag", None)
    if dag is not None and dag.is_linear:
        dag = None  # degenerate case: use the linear path (and its floats)
    if dag is not None:
        budget = distribute_budgets_dag(lat, deadline, dag)
    else:
        budget = distribute_budgets(lat, deadline)
    variants: Dict[int, VariantInfo] = {}
    if enable_variants and budget.feasible:
        for idx, spec in enumerate(model.layers):
            got = _design_layer_variant(
                spec, lat[idx], budget.levels[idx], int(budget.rho[idx]), platform
            )
            if got is None:
                continue
            gamma, direction, vspec, vlat = got
            loss = layer_variant_loss(model.name, spec.name, model.redundancy, gamma)
            variants[idx] = VariantInfo(
                layer_idx=idx,
                gamma=gamma,
                direction=direction,
                spec=vspec,
                latencies=vlat,
                loss=loss,
                storage_weights=vspec.weights,
            )
    return ModelPlan(
        model=model,
        platform=platform,
        deadline=deadline,
        lat=lat,
        budget=budget,
        variants=variants,
        theta=theta,
        dag=dag,
    )
