"""Terastal as a first-class LM serving controller.

Torch port: a copy of the JAX package's ``runtime/serve_runtime.py``
that maps the paper's abstractions onto NVIDIA H100 cards:

* **Heterogeneous accelerators**  -> *partitions* of H100s of different
  width (one 16-card slice across two 8-card HGX H100 nodes, two
  single-node 8-card NVLink slices: :func:`default_partitions`).  The
  wide slice is the "preferred accelerator" for big-model decode steps
  (more FLOPs/HBM per step) while the narrow slices serve small models
  with less collective overhead — the same preferred/non-preferred
  latency structure Terastal exploits, with per-(model, partition) step
  latencies derived from the analytic roofline on the H100's constants
  (``repro_torch.launch.analytics``).
* **Layers** -> token *chunks*: generating T tokens is a chain of T/K
  non-preemptive chunk jobs, schedulable on different partitions at
  chunk boundaries (KV migration rides the interconnect; its cost is
  charged into the latency table).
* **Layer variants** -> shape-preserving reduced blocks (d_ff / gamma^2)
  with latency scaled by the active-FLOP ratio and accuracy loss from
  the calibrated proxy — exactly the paper's variant trade, generalized
  to transformer blocks.

Offline: Algorithm 1 decomposes each request deadline into chunk
budgets and selects which models get block variants.  Online:
Algorithm 2 (the *same* scheduler class as the faithful reproduction)
maps chunk jobs to partitions.  The event-driven simulator provides the
serving-loop clock, so FCFS/EDF/DREAM/Terastal are directly comparable
on LM traffic.  ``MeshPartition.n_chips`` counts cards here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.budget import distribute_budgets
from repro_torch.core.scheduler import Scheduler, make_scheduler
from repro_torch.core.simulator import (
    ArrivalProcess,
    SimResult,
    TaskSpec,
    make_arrival_process,
    simulate,
)
from repro_torch.core.variants import ModelPlan, VariantInfo
from repro_torch.costmodel.dnn_zoo import DnnModel
from repro_torch.costmodel.layers import matmul
from repro_torch.costmodel.maestro import Accelerator, Dataflow, Platform
from repro_torch.launch.analytics import HBM_BW, ICI_BW, PEAK_FLOPS, active_params, cache_bytes
from repro_torch.models.config import ModelConfig
from repro_torch.models.model_api import SHAPES, ShapeSpec


@dataclasses.dataclass(frozen=True)
class MeshPartition:
    name: str
    n_chips: int
    # effective per-step efficiency: wide slices lose more to collectives
    collective_overhead_s: float = 3e-5


def default_partitions() -> Tuple[MeshPartition, ...]:
    """Four 8-card HGX H100 nodes carved into 1 wide + 2 narrow serving
    slices: one 16-card slice across two nodes and two single-node
    8-card NVLink slices.

    Big-model chunks are ~2x slower on a narrow slice (HBM-bound weight
    streaming) while small-model chunks are slower on the wide slice,
    whose collectives cross the nodes' network — the skewed
    preferred/non-preferred structure the paper's scheduling targets.
    Each ``collective_overhead_s`` (seconds a log2 step of a decode
    step's collectives) is a modelling assumption, not measured: 5 us
    inside one node's NVLink switch, 30 us across two nodes."""
    return (
        MeshPartition("wide_2node_16", 16, collective_overhead_s=3e-5),
        MeshPartition("node_8a", 8, collective_overhead_s=5e-6),
        MeshPartition("node_8b", 8, collective_overhead_s=5e-6),
    )


def decode_chunk_latency(
    cfg: ModelConfig, part: MeshPartition, chunk_tokens: int, ctx_len: int, batch: int,
    dff_scale: float = 1.0,
) -> float:
    """Analytic per-chunk decode latency on a partition: memory term
    (weights + cache stream per token) + compute + per-step collective
    overhead.  ``dff_scale`` < 1 models a gamma-variant block."""
    n = part.n_chips
    p_active = active_params(cfg) * dff_scale
    shape = ShapeSpec("x", ctx_len, batch, "decode")
    bytes_per_step = p_active * 2 + cache_bytes(cfg, shape)
    flops_per_step = 2.0 * p_active * batch
    t_mem = bytes_per_step / (n * HBM_BW)
    t_comp = flops_per_step / (n * PEAK_FLOPS)
    t_coll = part.collective_overhead_s * np.log2(max(2, n))
    return chunk_tokens * (max(t_mem, t_comp) + t_coll)


@dataclasses.dataclass(frozen=True)
class ServingModel:
    cfg: ModelConfig
    tokens_out: int = 64  # tokens generated per request
    chunk: int = 16  # scheduling granularity (tokens)
    ctx_len: int = 2048
    batch: int = 8  # requests micro-batched per step
    redundancy: float = 0.7
    variant_gamma: int = 2


def build_serving_plan(
    sm: ServingModel,
    partitions: Sequence[MeshPartition],
    deadline: float,
    theta: float = 0.90,
    enable_variants: bool = True,
) -> ModelPlan:
    """Construct a ModelPlan whose 'layers' are decode chunks and whose
    'accelerators' are mesh partitions — the faithful Terastal machinery
    then runs unchanged on LM serving."""
    n_chunks = sm.tokens_out // sm.chunk
    cfg = sm.cfg
    # synthetic DnnModel: one matmul LayerSpec per chunk (bookkeeping only)
    layers = [
        matmul(f"chunk{i}", sm.chunk * sm.batch, cfg.d_model, cfg.d_model)
        for i in range(n_chunks)
    ]
    dnn = DnnModel(name=cfg.name, layers=layers, redundancy=sm.redundancy)
    plat = Platform(
        name="pod_partitions",
        accelerators=tuple(
            Accelerator(p.name, Dataflow.WS, p.n_chips) for p in partitions
        ),
    )
    lat = np.zeros((n_chunks, len(partitions)))
    for k, p in enumerate(partitions):
        lat[:, k] = decode_chunk_latency(cfg, p, sm.chunk, sm.ctx_len, sm.batch)
    budget = distribute_budgets(lat, deadline)
    variants: Dict[int, VariantInfo] = {}
    if enable_variants and budget.feasible:
        g2 = sm.variant_gamma**2
        # variant block: d_ff / gamma^2 => active-FLOP ratio
        p_full = active_params(cfg)
        ffn = 3 * cfg.d_model * (cfg.moe_d_ff or cfg.d_ff) * (
            cfg.experts_per_token if cfg.family == "moe" else 1
        ) * cfg.n_layers
        scale = max(0.05, (p_full - ffn * (1 - 1.0 / g2)) / p_full)
        from repro_torch.core.accuracy import layer_variant_loss

        for i in range(n_chunks):
            rho = int(budget.rho[i])
            if rho <= 0:
                continue
            vlat = np.array([
                decode_chunk_latency(cfg, p, sm.chunk, sm.ctx_len, sm.batch, dff_scale=scale)
                for p in partitions
            ])
            loss = layer_variant_loss(cfg.name, f"chunk{i}", sm.redundancy, sm.variant_gamma)
            variants[i] = VariantInfo(
                layer_idx=i,
                gamma=sm.variant_gamma,
                direction="d2s",
                spec=layers[i],
                latencies=vlat,
                loss=loss,
                storage_weights=int(ffn / g2),
            )
    return ModelPlan(
        model=dnn, platform=plat, deadline=deadline, lat=lat, budget=budget,
        variants=variants, theta=theta,
    )


def serve_workload(
    models: Sequence[ServingModel],
    rates_fps: Sequence[float],
    scheduler: str = "terastal",
    duration: float = 5.0,
    partitions: Optional[Sequence[MeshPartition]] = None,
    theta: float = 0.90,
    seed: int = 0,
    budget_policy: str = "static",
    admission: str = "none",
    arrival: Union[ArrivalProcess, str, None] = None,
) -> SimResult:
    """``budget_policy`` ("static" | "reclaim" | "adaptive(...)") selects
    the online chunk-budget policy — on LM traffic, slack reclamation
    moves unused chunk budget to later decode chunks of the same request,
    and the adaptive policy engages that reclamation only inside detected
    request bursts, repairing any chunk schedule the burst outruns back
    to the offline distribution (see ``repro_torch.core.budget_online``).

    ``admission`` ("none" | "shed_early(...)" | "token_bucket(...)") is
    the overload-control axis (``repro_torch.core.admission``); ``arrival``
    sets every model's release process — pass
    ``ClosedLoopClients(n_users=..., think_time=...)`` (or its
    ``"closed_loop(...)"`` call-spec) for closed-loop traffic where
    releases gate on completions."""
    if len(models) != len(rates_fps):
        raise ValueError(
            f"serve_workload: models and rates_fps must have the same "
            f"length, got {len(models)} models and {len(rates_fps)} rates"
        )
    partitions = partitions or default_partitions()
    plans = [
        build_serving_plan(sm, partitions, deadline=1.0 / r, theta=theta)
        for sm, r in zip(models, rates_fps)
    ]
    proc = make_arrival_process(arrival) if arrival is not None else None
    tasks = [
        TaskSpec(model_idx=i, fps=r, arrival=proc)
        for i, r in enumerate(rates_fps)
    ]
    return simulate(
        plans, tasks, duration, make_scheduler(scheduler), seed=seed,
        budget_policy=budget_policy, admission=admission,
    )
