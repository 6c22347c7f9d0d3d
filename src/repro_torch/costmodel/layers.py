"""Layer workload descriptions and the S2D/D2S layer-variant transform.

A :class:`LayerSpec` describes the *computation* of one DNN layer in the
units the WS/OS dataflow cost model needs (Terastal paper, Sec. III):

  conv    : K filters of (R x S x C) over an (H x W x C) input, stride t.
  dwconv  : depthwise conv, one filter of (R x S) per channel C.
  fc      : fully connected = conv whose kernel covers the full input
            spatial extent (paper Sec. III last paragraph).
  matmul  : an (M x Kd) @ (Kd x N) GEMM (attention / transformer blocks),
            mapped as a 1x1 conv with M output pixels, N filters, Kd chans.
  pool / eltwise : bandwidth-bound reshaping ops (no MACs).

The variant transform implements Fig. 1 of the paper:

  forward (WS-preferred layer, target OS):
      D2S(gamma) on input:  (H, W, C)      -> (gH, gW, C/g^2)
      conv:                 K/g^2 filters of (R x S x C/g^2)
      S2D(gamma) on output: (gHo, gWo, K/g^2) -> (Ho, Wo, K)
      => weights / g^4, MACs / g^2, output-side parallelism * g^2.

  reverse (OS-preferred layer, target WS):
      S2D(gamma) on input:  (H, W, C)      -> (H/g, W/g, g^2 C)
      conv:                 g^2 K filters of (R x S x g^2 C)
      D2S(gamma) on output.
      => channel-side parallelism * g^4 (weights * g^4) — only useful for
      layers that badly under-utilize a WS array; the selection logic in
      ``repro_torch.core.variants`` only keeps variants that actually reduce the
      modeled latency on the target accelerator.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional


class LayerKind(str, enum.Enum):
    CONV = "conv"
    DWCONV = "dwconv"
    FC = "fc"
    MATMUL = "matmul"
    POOL = "pool"
    ELTWISE = "eltwise"


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer's workload. All sizes in elements (dtype handled by model)."""

    kind: LayerKind
    name: str = ""
    # conv-family parameters (also encode fc / matmul, see constructors).
    K: int = 0  # number of filters / output channels
    C: int = 0  # input channels (contraction size per spatial tap)
    R: int = 1  # filter height
    S: int = 1  # filter width
    H: int = 0  # input height
    W: int = 0  # input width
    stride: int = 1
    pad: str = "same"  # "same": Ho = ceil(H/stride); "valid": sliding window
    # variant bookkeeping
    gamma: int = 1  # 1 == original layer
    variant_dir: str = ""  # "" | "d2s" (forward) | "s2d" (reverse)

    # ---- derived geometry -------------------------------------------------
    @property
    def Ho(self) -> int:
        if self.kind in (LayerKind.FC, LayerKind.MATMUL):
            return 1
        if self.pad == "same":
            return max(1, -(-self.H // self.stride))
        return max(1, (self.H - self.R) // self.stride + 1) if self.H >= self.R else 1

    @property
    def Wo(self) -> int:
        if self.kind == LayerKind.FC:
            return 1
        if self.kind == LayerKind.MATMUL:
            return self.H  # M output "pixels" stored in H
        if self.pad == "same":
            return max(1, -(-self.W // self.stride))
        return max(1, (self.W - self.S) // self.stride + 1) if self.W >= self.S else 1

    @property
    def out_pixels(self) -> int:
        if self.kind == LayerKind.MATMUL:
            return self.H  # M
        return self.Ho * self.Wo

    @property
    def macs(self) -> int:
        if self.kind in (LayerKind.POOL, LayerKind.ELTWISE):
            return 0
        if self.kind == LayerKind.DWCONV:
            return self.C * self.R * self.S * self.out_pixels
        return self.K * self.C * self.R * self.S * self.out_pixels

    @property
    def weights(self) -> int:
        if self.kind in (LayerKind.POOL, LayerKind.ELTWISE):
            return 0
        if self.kind == LayerKind.DWCONV:
            return self.C * self.R * self.S
        return self.K * self.C * self.R * self.S

    @property
    def input_elems(self) -> int:
        if self.kind == LayerKind.MATMUL:
            return self.H * self.C  # M x Kd
        return self.H * self.W * self.C

    @property
    def output_elems(self) -> int:
        if self.kind == LayerKind.DWCONV:
            return self.C * self.out_pixels
        if self.kind in (LayerKind.POOL, LayerKind.ELTWISE):
            return self.C * self.out_pixels
        return self.K * self.out_pixels

    def with_name(self, name: str) -> "LayerSpec":
        return dataclasses.replace(self, name=name)


# ---- constructors ----------------------------------------------------------


def conv(name: str, K: int, C: int, R: int, S: int, H: int, W: int, stride: int = 1) -> LayerSpec:
    return LayerSpec(LayerKind.CONV, name, K=K, C=C, R=R, S=S, H=H, W=W, stride=stride)


def dwconv(name: str, C: int, R: int, S: int, H: int, W: int, stride: int = 1) -> LayerSpec:
    return LayerSpec(LayerKind.DWCONV, name, K=C, C=C, R=R, S=S, H=H, W=W, stride=stride)


def fc(name: str, in_features: int, out_features: int) -> LayerSpec:
    # conv whose kernel covers the full (1x1) input spatial extent.
    return LayerSpec(LayerKind.FC, name, K=out_features, C=in_features, R=1, S=1, H=1, W=1)


def matmul(name: str, M: int, N: int, Kd: int) -> LayerSpec:
    # (M x Kd) @ (Kd x N): N filters, Kd channels, M output pixels.
    return LayerSpec(LayerKind.MATMUL, name, K=N, C=Kd, R=1, S=1, H=M, W=1)


def pool(name: str, C: int, H: int, W: int, R: int = 2, S: int = 2, stride: int = 2) -> LayerSpec:
    return LayerSpec(LayerKind.POOL, name, K=C, C=C, R=R, S=S, H=H, W=W, stride=stride)


def eltwise(name: str, C: int, H: int, W: int) -> LayerSpec:
    return LayerSpec(LayerKind.ELTWISE, name, K=C, C=C, R=1, S=1, H=H, W=W, stride=1)


# ---- the layer-variant transform (paper Sec. III, Fig. 1) ------------------


def variant_feasible(spec: LayerSpec, gamma: int, direction: str = "d2s") -> bool:
    """Divisibility conditions for an exact S2D/D2S variant."""
    if gamma < 2:
        return False
    if spec.kind not in (LayerKind.CONV, LayerKind.FC, LayerKind.MATMUL):
        # Depthwise convs / pools move no channel mass; the transform does
        # not apply (each output channel depends on exactly one input chan).
        return False
    g2 = gamma * gamma
    if direction == "d2s":
        # need C and K divisible by gamma^2 (paper: "assuming C divisible")
        return spec.C % g2 == 0 and spec.K % g2 == 0
    elif direction == "s2d":
        # spatial dims must fold: H, W divisible by gamma (conv only).
        if spec.kind != LayerKind.CONV:
            return False
        return spec.H % gamma == 0 and spec.W % gamma == 0 and spec.Ho % gamma == 0 and spec.Wo % gamma == 0
    return False


def make_variant(spec: LayerSpec, gamma: int, direction: str = "d2s") -> LayerSpec:
    """Construct the variant LayerSpec for ``spec`` at ratio ``gamma``.

    ``d2s`` (forward, Fig. 1): unfold channels into space before the conv;
    the variant conv sees a (gH x gW x C/g^2) input and K/g^2 filters.
    ``s2d`` (reverse): fold space into channels; (H/g x W/g x g^2 C) input
    and g^2 K filters.
    """
    if not variant_feasible(spec, gamma, direction):
        raise ValueError(f"variant infeasible for {spec.name} gamma={gamma} dir={direction}")
    g2 = gamma * gamma
    if direction == "d2s":
        if spec.kind in (LayerKind.FC, LayerKind.MATMUL):
            # FC/matmul: the "spatial" unfolding turns one big contraction
            # into g^2 output pixels of a g^2-smaller contraction.
            M = spec.H if spec.kind == LayerKind.MATMUL else 1
            return dataclasses.replace(
                spec,
                kind=LayerKind.MATMUL,
                name=spec.name + f"@d2s{gamma}",
                K=spec.K // g2,
                C=spec.C // g2,
                H=M * g2,
                gamma=gamma,
                variant_dir="d2s",
            )
        return dataclasses.replace(
            spec,
            name=spec.name + f"@d2s{gamma}",
            K=spec.K // g2,
            C=spec.C // g2,
            H=spec.H * gamma,
            W=spec.W * gamma,
            # NOTE: stride unchanged; R,S unchanged per Fig. 1.
            gamma=gamma,
            variant_dir="d2s",
        )
    else:  # s2d
        return dataclasses.replace(
            spec,
            name=spec.name + f"@s2d{gamma}",
            K=spec.K * g2,
            C=spec.C * g2,
            H=spec.H // gamma,
            W=spec.W // gamma,
            gamma=gamma,
            variant_dir="s2d",
        )


def variant_weight_ratio(spec: LayerSpec, gamma: int, direction: str = "d2s") -> float:
    """weights(variant)/weights(original): 1/g^4 forward, g^4 reverse."""
    base = spec.weights
    if base == 0:
        return 1.0
    return make_variant(spec, gamma, direction).weights / base


def variant_storage_overhead(spec: LayerSpec, gamma: int, direction: str = "d2s") -> int:
    """Extra weights (elements) stored to keep BOTH original and variant."""
    return make_variant(spec, gamma, direction).weights
