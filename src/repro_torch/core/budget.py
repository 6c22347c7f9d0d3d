"""Algorithm 1 — Offline Layer-Wise Virtual Budget Distribution.

Decomposes a model's relative deadline ``D_m`` into per-layer virtual
budgets ``b_{m,l}`` with ``sum(b) == D_m`` (Eq. 1), via per-layer
*constraint levels* ``rho`` into the decreasing list of distinct
cross-accelerator latencies.  The paper's loop: propose proportional
budgets at the current levels; while the proposal's reference total
exceeds ``D_m``, tighten the layer with the largest gap to its next-lower
latency level.  Fails iff even every layer's minimum latency does not fit.

This module is the reference (NumPy) implementation; ``budget_jax`` is a
bit-compatible ``jax.lax`` program property-tested against it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

# Latencies closer than this are treated as the same "distinct" level
# (identical accelerators produce exactly equal latencies; this guard is
# for float noise only).
_LEVEL_ATOL = 1e-12


@dataclasses.dataclass(frozen=True)
class BudgetResult:
    feasible: bool
    budgets: np.ndarray  # [L] seconds; zeros if infeasible
    rho: np.ndarray  # [L] final constraint level (0-indexed)
    levels: List[np.ndarray]  # per-layer distinct latencies, decreasing
    c_ref: np.ndarray  # [L] c^{down(rho)} used for the proportion
    #: relative virtual deadlines for DAG plans (critical-path completion
    #: targets, NOT a cumsum — set only by :func:`tighten_budgets_dag`).
    #: Linear plans leave it None and keep the exact cumsum floats.
    vdl: Optional[np.ndarray] = None

    @property
    def virtual_deadlines(self) -> np.ndarray:
        """Relative virtual deadlines: cumsum of budgets (Eq. 2 minus
        t^a) for linear chains; the topologically accumulated per-node
        targets when a DAG tightening set ``vdl`` explicitly."""
        if self.vdl is not None:
            return self.vdl
        return np.cumsum(self.budgets)


def latency_levels(lat_row: Sequence[float]) -> np.ndarray:
    """Distinct latencies of one layer across accelerators, decreasing."""
    vals = np.asarray(sorted(set(float(x) for x in lat_row), reverse=True))
    if len(vals) > 1:
        keep = [0]
        for i in range(1, len(vals)):
            if vals[keep[-1]] - vals[i] > _LEVEL_ATOL:
                keep.append(i)
        vals = vals[keep]
    return vals


def tighten_budgets(
    levels: Sequence[np.ndarray],
    deadline: float,
    rho0: Optional[Sequence[int]] = None,
) -> BudgetResult:
    """The Algorithm-1 tightening loop as a reusable incremental kernel.

    Re-distributes a (possibly *remaining*) ``deadline`` over the given
    per-layer level tables, starting from constraint levels ``rho0``
    (zeros = the offline algorithm; a request's current levels = online
    re-distribution over its remaining layers).  Propose proportional
    budgets at the current levels; while the proposal's reference total
    exceeds ``deadline``, tighten the layer with the largest gap to its
    next-lower latency level.  Fails iff even every layer's minimum
    latency does not fit.

    Tie-break: when several layers share the maximal gap, the lowest layer
    index is tightened (matches ``jnp.argmax`` semantics in budget_jax).
    """
    levels = [np.asarray(lv, dtype=np.float64) for lv in levels]
    L = len(levels)
    R = np.array([len(lv) for lv in levels])
    rho = (
        np.zeros(L, dtype=np.int64)
        if rho0 is None
        else np.asarray(rho0, dtype=np.int64).copy()
    )

    while True:
        c_ref = np.array([levels[l][rho[l]] for l in range(L)])
        c_total = float(c_ref.sum())
        if c_total <= deadline:
            budgets = deadline * c_ref / c_total
            return BudgetResult(True, budgets, rho.copy(), levels, c_ref)
        tightenable = rho < (R - 1)
        if not tightenable.any():
            return BudgetResult(
                False, np.zeros(L), rho.copy(), levels, c_ref
            )
        gaps = np.full(L, -np.inf)
        for l in range(L):
            if tightenable[l]:
                gaps[l] = levels[l][rho[l]] - levels[l][rho[l] + 1]
        l_star = int(np.argmax(gaps))
        rho[l_star] += 1


def distribute_budgets(lat_table: np.ndarray, deadline: float) -> BudgetResult:
    """Run Algorithm 1 on a [L, n_acc] latency table (offline entry point:
    build the level tables, then run the tightening kernel from level 0)."""
    lat_table = np.asarray(lat_table, dtype=np.float64)
    levels = [latency_levels(lat_table[l]) for l in range(lat_table.shape[0])]
    return tighten_budgets(levels, deadline)


def tighten_budgets_dag(
    levels: Sequence[np.ndarray],
    deadline: float,
    dag,
    rho0: Optional[Sequence[int]] = None,
) -> BudgetResult:
    """Algorithm 1 generalized to a layer DAG: distribute the deadline
    over the *critical path* instead of the layer sum.

    At the current constraint levels the earliest completion of node
    ``l`` is ``ecl[l] = max(ecl[p] for p in preds) + c_ref[l]`` (topo
    order) and the proposal's reference total is the critical-path
    length ``cp = ecl[sink]``.  Feasible iff ``cp <= deadline``: each
    node's budget is its reference latency scaled by ``deadline / cp``
    and its relative virtual deadline is ``ecl[l]`` scaled the same way
    (so virtual deadlines are strictly increasing along every edge, and
    every source-to-sink path's targets stretch proportionally —
    parallel branches get overlapping budgets, which a layer-sum cumsum
    cannot express).  While infeasible, tighten the largest-gap
    tightenable node *on a critical path* — tightening off-path nodes
    can never shorten ``cp`` — lowest node id on gap ties; fail iff no
    critical node is tightenable.

    Linear chains must NOT route through this function: ``deadline *
    cumsum(c_ref) / c_total`` differs from ``cumsum(deadline * c_ref /
    c_total)`` in the last float, and the linear pins are bit-exact.
    ``build_model_plan`` only calls it when the model carries a DAG.
    """
    levels = [np.asarray(lv, dtype=np.float64) for lv in levels]
    L = len(levels)
    if dag.n_nodes != L:
        raise ValueError(
            f"DAG has {dag.n_nodes} nodes but the latency table has {L} layers"
        )
    R = np.array([len(lv) for lv in levels])
    rho = (
        np.zeros(L, dtype=np.int64)
        if rho0 is None
        else np.asarray(rho0, dtype=np.int64).copy()
    )
    topo, preds, succs, sink = dag.topo, dag.preds, dag.succs, dag.sink

    while True:
        c_ref = np.array([levels[l][rho[l]] for l in range(L)])
        ecl = np.zeros(L)
        for l in topo:
            ps = preds[l]
            ecl[l] = (max(ecl[p] for p in ps) if ps else 0.0) + c_ref[l]
        cp = float(ecl[sink])
        if cp <= deadline:
            scale = deadline / cp
            budgets = c_ref * scale
            vdl = ecl * scale
            return BudgetResult(True, budgets, rho.copy(), levels, c_ref, vdl=vdl)
        # tail[l]: longest reference path strictly below l (0 at the sink)
        tail = np.zeros(L)
        for l in reversed(topo):
            ss = succs[l]
            if ss:
                tail[l] = max(tail[s] + c_ref[s] for s in ss)
        critical = ecl + tail >= cp - _LEVEL_ATOL
        tightenable = critical & (rho < (R - 1))
        if not tightenable.any():
            return BudgetResult(
                False, np.zeros(L), rho.copy(), levels, c_ref, vdl=np.zeros(L)
            )
        gaps = np.full(L, -np.inf)
        for l in range(L):
            if tightenable[l]:
                gaps[l] = levels[l][rho[l]] - levels[l][rho[l] + 1]
        l_star = int(np.argmax(gaps))
        rho[l_star] += 1


def distribute_budgets_dag(
    lat_table: np.ndarray, deadline: float, dag
) -> BudgetResult:
    """Offline entry point for DAG plans (critical-path Algorithm 1)."""
    lat_table = np.asarray(lat_table, dtype=np.float64)
    levels = [latency_levels(lat_table[l]) for l in range(lat_table.shape[0])]
    return tighten_budgets_dag(levels, deadline, dag)


def virtual_deadline(arrival: float, budgets: np.ndarray, layer: int) -> float:
    """Eq. 2: d^v_{j,m,l} = t^a + sum_{l'<=l} b."""
    return float(arrival + budgets[: layer + 1].sum())


def proportional_budgets_worstcase(lat_table: np.ndarray, deadline: float) -> np.ndarray:
    """Eq. 3 — the naive proportional-to-worst-case assignment (often
    infeasible on heterogeneous platforms; kept for tests/ablation)."""
    worst = np.asarray(lat_table).max(axis=1)
    return deadline * worst / worst.sum()
