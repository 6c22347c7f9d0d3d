"""Layer DAGs — precedence structure for non-linear models.

A :class:`LayerDag` attaches an explicit predecessor structure to a
model's layer list: node ``l`` may only start once every node in
``preds[l]`` has finished.  Linear chains are the degenerate case
(``preds[l] == (l-1,)``) and every consumer in the stack keeps its
original linear code path when ``plan.dag is None`` — the DAG machinery
is strictly additive, which is what keeps the pre-PR linear-chain
fingerprints bit-identical (``tests/data_pre_pr9_fingerprints.py``).

Validation (:meth:`LayerDag.validate`, run at construction) rejects
malformed specs with a :class:`DagValidationError` naming the offending
node: self-edges, unknown/out-of-range predecessor ids, duplicate
predecessors, cycles (Kahn's algorithm), multiple sinks, and nodes from
which the sink is unreachable (a "disconnected sink" — work that could
never contribute to the request completing).

The runtime side is :class:`DagRun` — one per in-flight DAG request,
shared by that request's per-node ready entries: it tracks how many
predecessors each node still waits on, how many nodes finished, the
union of applied variants, and whether the request was dropped (a drop
of any ready node drops the whole request exactly once).

The digraph idiom (topologically staged nodes with explicit predecessor
sets) follows the zigzag workload-as-digraph pattern referenced from
ROADMAP item 3.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Set, Tuple


class DagValidationError(ValueError):
    """A malformed layer-DAG spec; the message names the offending node."""


@dataclass(frozen=True)
class LayerDag:
    """Immutable precedence structure over ``n_nodes`` layers.

    ``preds[l]`` is the tuple of node ids that must finish before node
    ``l`` may start; sources have ``preds[l] == ()``.  Derived fields
    (``succs``, ``topo``, ``sources``, ``sink``) are computed once at
    construction by :meth:`validate`.
    """

    preds: Tuple[Tuple[int, ...], ...]
    succs: Tuple[Tuple[int, ...], ...] = field(default=(), compare=False)
    topo: Tuple[int, ...] = field(default=(), compare=False)
    sources: Tuple[int, ...] = field(default=(), compare=False)
    sink: int = field(default=-1, compare=False)

    def __post_init__(self):
        object.__setattr__(
            self, "preds", tuple(tuple(int(p) for p in ps) for ps in self.preds)
        )
        self.validate()

    @property
    def n_nodes(self) -> int:
        return len(self.preds)

    @property
    def is_linear(self) -> bool:
        """True iff this DAG is exactly the linear chain 0 -> 1 -> ... ."""
        return all(
            ps == (() if l == 0 else (l - 1,)) for l, ps in enumerate(self.preds)
        )

    def validate(self) -> None:
        n = len(self.preds)
        if n == 0:
            raise DagValidationError("empty DAG: no nodes")
        succs: List[List[int]] = [[] for _ in range(n)]
        for l, ps in enumerate(self.preds):
            seen: Set[int] = set()
            for p in ps:
                if p == l:
                    raise DagValidationError(f"node {l}: self-edge {l} -> {l}")
                if p < 0 or p >= n:
                    raise DagValidationError(
                        f"node {l}: unknown predecessor id {p} (have 0..{n - 1})"
                    )
                if p in seen:
                    raise DagValidationError(
                        f"node {l}: duplicate predecessor {p}"
                    )
                seen.add(p)
                succs[p].append(l)
        # Kahn's algorithm: topological order, or the cycle's witness node
        indeg = [len(ps) for ps in self.preds]
        stack = sorted((l for l in range(n) if indeg[l] == 0), reverse=True)
        topo: List[int] = []
        while stack:
            l = stack.pop()
            topo.append(l)
            for s in succs[l]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    stack.append(s)
            stack.sort(reverse=True)
        if len(topo) < n:
            witness = min(l for l in range(n) if indeg[l] > 0)
            raise DagValidationError(f"node {witness}: unreachable (cycle)")
        sinks = [l for l in range(n) if not succs[l]]
        if len(sinks) != 1:
            raise DagValidationError(
                f"node {sinks[1]}: multiple sinks {sinks} (a model completes "
                "at exactly one terminal node)"
            )
        sink = sinks[0]
        # every node must reach the sink, else its work can never count
        reach = [False] * n
        reach[sink] = True
        for l in reversed(topo):
            if not reach[l] and any(reach[s] for s in succs[l]):
                reach[l] = True
        for l in range(n):
            if not reach[l]:
                raise DagValidationError(
                    f"node {l}: disconnected from sink {sink}"
                )
        object.__setattr__(self, "succs", tuple(tuple(s) for s in succs))
        object.__setattr__(self, "topo", tuple(topo))
        object.__setattr__(
            self, "sources", tuple(l for l in range(n) if not self.preds[l])
        )
        object.__setattr__(self, "sink", sink)

    @staticmethod
    def linear(n_nodes: int) -> "LayerDag":
        return LayerDag(tuple(() if l == 0 else (l - 1,) for l in range(n_nodes)))

    def spec(self) -> str:
        """Compact edge-spec string (see ``specs.format_dag_edges``)."""
        from repro_torch.core.specs import format_dag_edges

        return format_dag_edges(self.preds)

    @staticmethod
    def from_spec(spec: str) -> "LayerDag":
        from repro_torch.core.specs import parse_dag_edges

        return LayerDag(parse_dag_edges(spec))


@dataclass
class DagRun:
    """Per-request runtime state shared by a DAG request's node entries.

    ``pending[l]`` counts unfinished predecessors of node ``l`` (a node
    becomes ready when it hits 0); ``n_done`` counts finished nodes;
    ``applied_variants`` is the union over nodes (the per-node entries
    carry snapshots refreshed by the engines on every application, so
    variant-combo validity sees the whole request); ``dropped`` makes
    the drop-once semantics explicit: the first hopeless ready node
    drops the request, sibling entries are removed, and an already
    running sibling finishes as a no-op.
    """

    pending: List[int]
    n_done: int = 0
    applied_variants: frozenset = frozenset()
    dropped: bool = False

    @staticmethod
    def fresh(dag: LayerDag) -> "DagRun":
        return DagRun(pending=[len(ps) for ps in dag.preds])
