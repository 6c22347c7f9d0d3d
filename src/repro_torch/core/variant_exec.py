"""Run the pointwise layer variants that a model's plan selects.

The scheduler decides *when* a request runs a layer as its Terastal
variant; this module runs those variants themselves, at the real widths
of the model, through the fused D2S -> 1x1 conv -> S2D kernel
(:func:`repro_torch.kernels.s2d_conv.ops.s2d_variant_conv`).  It is the
layer-variant half of the port's main path: after ``simulate_batch``
reports which models applied variants, their pointwise variant layers
run here on the card.

Only layers whose variant is the fused pointwise kind run here: 1x1
convolutions (a strided one runs on its subsampled input
``[B, Ho, Wo, C]``, which a 1x1 filter at stride s computes exactly) and
matmuls, whose M rows become an ``[B, M, 1, C]`` grid.  R x S > 1
variants go through ``s2d_variant_conv_rs`` and are not run here.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.costmodel.layers import LayerKind
from repro_torch.device import resolve_device
from repro_torch.kernels.s2d_conv.ops import s2d_variant_conv


class PointwiseVariant(NamedTuple):
    """One pointwise variant layer at its model's widths (batch 1)."""

    name: str     # "<model>.<layer>"
    H: int
    W: int
    C: int
    K: int
    gamma: int

    def x_shape(self):
        return (1, self.H, self.W, self.C)

    def w_shape(self):
        g2 = self.gamma * self.gamma
        return (self.C // g2, self.K // g2)


def pointwise_variants(plan) -> List[PointwiseVariant]:
    """The fused-pointwise variant layers of one ``ModelPlan``, in layer order."""
    out = []
    for l, v in sorted(plan.variants.items()):
        layer = plan.model.layers[l]
        g2 = v.gamma * v.gamma
        if layer.R != 1 or layer.S != 1 or layer.C % g2 or layer.K % g2:
            continue
        if layer.kind is LayerKind.MATMUL:
            hw = (layer.H, 1)
        elif layer.kind is LayerKind.CONV:
            hw = (-(-layer.H // layer.stride), -(-layer.W // layer.stride))
        else:
            continue
        out.append(PointwiseVariant(f"{plan.model.name}.{layer.name}", *hw,
                                    layer.C, layer.K, v.gamma))
    return out


def variant_inputs(
    layers: Sequence[PointwiseVariant],
    device: Union[str, torch.device, None] = None,
) -> Iterator[Tuple[PointwiseVariant, torch.Tensor, torch.Tensor]]:
    """``(layer, x, w)`` per layer, f32: activations and weights drawn in
    order from ``numpy.random.default_rng(0)`` (so the same layers always
    get the same numbers), on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    for v in layers:
        p = params_from_numpy({
            "x": rng.standard_normal(v.x_shape(), dtype=np.float32),
            "w": (rng.standard_normal(v.w_shape(), dtype=np.float32)
                  / np.sqrt(v.w_shape()[0], dtype=np.float32)),
        }, device=dev, expect={"w": v.w_shape()})
        yield v, p["x"], p["w"]


def run_pointwise_variants(
    plans: Sequence,
    device: Union[str, torch.device, None] = None,
) -> Dict[str, torch.Tensor]:
    """Run every pointwise variant layer of ``plans`` once on ``device``
    (``cuda`` when None), inputs from :func:`variant_inputs`; returns
    layer name -> output ``[1, H, W, K]``."""
    layers = [v for p in plans for v in pointwise_variants(p)]
    return {
        v.name: s2d_variant_conv(x, w, v.gamma)
        for v, x, w in variant_inputs(layers, device)
    }
