"""First-order WS/OS dataflow latency model (MAESTRO-lite).

The Terastal paper profiles per-layer latency with MAESTRO [22] on
accelerators that differ in PE count and dataflow (Table I).  MAESTRO
itself is a closed-form data-centric cost analysis; we re-derive the two
dataflows it is used for here:

  WS (NVDLA-like [2]) — weights stationary, the PE array parallelizes the
     (K x C) filter/channel cross-product with an adder tree over C; the
     R*S*out_pixels loop runs temporally:

         cycles_WS = ceil(K*C / P) * R * S * out_pixels

  OS (ShiDianNao-like [3]) — partial sums stationary, the PE array
     parallelizes output pixels of one output map; filters/channels run
     temporally:

         cycles_OS = ceil(out_pixels / P) * K * C * R * S

  (depthwise conv has no K*C cross-product: WS parallelizes only C,
  OS is unchanged per-channel.)

These two formulas produce the paper's affinity structure exactly:
many-channel / small-map layers (late VGG) are WS-preferred by 2-8x,
large-map / few-channel layers (stem convs, depthwise) are OS-preferred,
and a d2s-variant with ratio gamma cuts OS latency by ~gamma^2
(out-pixel parallelism * gamma^2, MACs / gamma^2) — reproducing Fig. 3.

Latency adds an off-chip-traffic roofline term (128 GB/s, Table I) and a
fixed dispatch overhead; per the paper, latencies are deterministic
constants profiled offline in isolation.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.costmodel.layers import LayerKind, LayerSpec


class Dataflow(str, enum.Enum):
    WS = "ws"
    OS = "os"


@dataclasses.dataclass(frozen=True)
class Accelerator:
    name: str
    dataflow: Dataflow
    pes: int  # number of MAC units


@dataclasses.dataclass(frozen=True)
class Platform:
    """One hardware setting from Table I."""

    name: str
    accelerators: Sequence[Accelerator]
    sram_bytes: int = 8 * 1024 * 1024  # 8 MiB shared on-chip memory
    offchip_gbps: float = 128.0  # GB/s
    freq_hz: float = 1.0e9  # 1 GHz
    bytes_per_elem: int = 1  # int8 edge inference
    dispatch_overhead_s: float = 1.0e-6
    # Effective PE utilization derate: MAESTRO-profiled latencies include
    # pipeline fill, buffer stalls and NoC serialization that a first-order
    # roofline misses; 0.3 calibrates end-to-end model latencies into the
    # paper's deadline regime (Table II periods, non-trivial load).
    efficiency: float = 0.3

    @property
    def n_acc(self) -> int:
        return len(self.accelerators)


# ---- Table I hardware settings ---------------------------------------------

PLATFORMS: Dict[str, Platform] = {
    # 4K total PEs
    "4k_1ws2os": Platform(
        "4k_1ws2os",
        (
            Accelerator("WS0", Dataflow.WS, 2048),
            Accelerator("OS0", Dataflow.OS, 1024),
            Accelerator("OS1", Dataflow.OS, 1024),
        ),
    ),
    "4k_1os2ws": Platform(
        "4k_1os2ws",
        (
            Accelerator("OS0", Dataflow.OS, 2048),
            Accelerator("WS0", Dataflow.WS, 1024),
            Accelerator("WS1", Dataflow.WS, 1024),
        ),
    ),
    # 6K total PEs
    "6k_1ws2os": Platform(
        "6k_1ws2os",
        (
            Accelerator("WS0", Dataflow.WS, 2048),
            Accelerator("OS0", Dataflow.OS, 2048),
            Accelerator("OS1", Dataflow.OS, 2048),
        ),
    ),
    "6k_1os2ws": Platform(
        "6k_1os2ws",
        (
            Accelerator("OS0", Dataflow.OS, 2048),
            Accelerator("WS0", Dataflow.WS, 2048),
            Accelerator("WS1", Dataflow.WS, 2048),
        ),
    ),
}


# ---- cycle model ------------------------------------------------------------


def _cycles(spec: LayerSpec, dataflow: Dataflow, pes: int) -> float:
    if spec.kind in (LayerKind.POOL, LayerKind.ELTWISE):
        # No MACs: one ALU op per output element, fully parallel.
        return math.ceil(spec.output_elems / pes) * max(1, spec.R * spec.S)
    rs = spec.R * spec.S
    if spec.kind == LayerKind.DWCONV:
        if dataflow == Dataflow.WS:
            return math.ceil(spec.C / pes) * rs * spec.out_pixels
        return math.ceil(spec.out_pixels / pes) * spec.C * rs
    # conv / fc / matmul
    if dataflow == Dataflow.WS:
        return math.ceil(spec.K * spec.C / pes) * rs * spec.out_pixels
    return math.ceil(spec.out_pixels / pes) * spec.K * spec.C * rs


def _traffic_bytes(spec: LayerSpec, dataflow: Dataflow, pes: int, platform: Platform) -> float:
    b = platform.bytes_per_elem
    w_bytes = spec.weights * b
    i_bytes = spec.input_elems * b
    o_bytes = spec.output_elems * b
    if spec.kind in (LayerKind.POOL, LayerKind.ELTWISE):
        return i_bytes + o_bytes
    # Effective per-accelerator working buffer: half the shared SRAM pool
    # divided across accelerators (double-buffering).
    buf = platform.sram_bytes / (2 * platform.n_acc)
    if dataflow == Dataflow.WS:
        # weights stream once and stay; inputs refetched per weight tile if
        # they cannot be held in the buffer.
        n_tiles = math.ceil(max(1, spec.K * spec.C) / pes)
        i_refetch = 1 if i_bytes <= buf else min(n_tiles, math.ceil(i_bytes / buf))
        return w_bytes + i_bytes * i_refetch + o_bytes
    else:
        # inputs stream once (pixel-stationary reuse); weights refetched per
        # output tile if they cannot be held.
        n_tiles = math.ceil(spec.out_pixels / pes)
        w_refetch = 1 if w_bytes <= buf else min(n_tiles, math.ceil(w_bytes / buf))
        return i_bytes + w_bytes * w_refetch + o_bytes


def layer_latency(spec: LayerSpec, acc: Accelerator, platform: Platform) -> float:
    """Deterministic latency (seconds) of ``spec`` on ``acc`` in isolation."""
    compute_s = _cycles(spec, acc.dataflow, acc.pes) / (
        platform.freq_hz * platform.efficiency
    )
    traffic_s = _traffic_bytes(spec, acc.dataflow, acc.pes, platform) / (
        platform.offchip_gbps * 1e9
    )
    return max(compute_s, traffic_s) + platform.dispatch_overhead_s


def model_latency_table(layers: Sequence[LayerSpec], platform: Platform) -> np.ndarray:
    """latencies[L, n_acc] in seconds."""
    out = np.empty((len(layers), platform.n_acc), dtype=np.float64)
    for i, spec in enumerate(layers):
        for k, acc in enumerate(platform.accelerators):
            out[i, k] = layer_latency(spec, acc, platform)
    return out


def preferred_accelerator(spec: LayerSpec, platform: Platform) -> int:
    """Index of the lowest-latency accelerator for this layer."""
    lat = [layer_latency(spec, a, platform) for a in platform.accelerators]
    return int(np.argmin(lat))


def preferred_dataflow(spec: LayerSpec, platform: Platform) -> Dataflow:
    return platform.accelerators[preferred_accelerator(spec, platform)].dataflow


def min_latency(spec: LayerSpec, platform: Platform) -> float:
    return min(layer_latency(spec, a, platform) for a in platform.accelerators)
