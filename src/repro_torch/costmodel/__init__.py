"""MAESTRO-lite analytical cost model for heterogeneous DNN accelerators.

This subpackage is the *faithful* experimental instrument of the Terastal
reproduction: the paper evaluates with a simulator built on MAESTRO [22]
cost analysis; we re-derive a first-order WS/OS dataflow latency model that
reproduces the paper's qualitative and quantitative latency structure
(Fig. 3: late VGG11 layers 2-8x slower on OS; variants close the gap).
"""

from repro_torch.costmodel.layers import (
    LayerKind,
    LayerSpec,
    conv,
    dwconv,
    fc,
    matmul,
    pool,
    eltwise,
    make_variant,
    variant_weight_ratio,
)
from repro_torch.costmodel.maestro import (
    Accelerator,
    Dataflow,
    Platform,
    layer_latency,
    model_latency_table,
    PLATFORMS,
)

__all__ = [
    "LayerKind",
    "LayerSpec",
    "conv",
    "dwconv",
    "fc",
    "matmul",
    "pool",
    "eltwise",
    "make_variant",
    "variant_weight_ratio",
    "Accelerator",
    "Dataflow",
    "Platform",
    "layer_latency",
    "model_latency_table",
    "PLATFORMS",
]
