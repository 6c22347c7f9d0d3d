"""Plain torch version of the fused D2S -> pointwise conv -> S2D variant.

Port of the JAX package's ``kernels/s2d_conv/ref.py`` (the Terastal
layer variant, paper Fig. 1).  Given x: [B, H, W, C] and variant
weights w: [C/g^2, K/g^2]:

    d2s:  (B, H, W, C) -> (B, gH, gW, C/g^2)   (channels -> space)
    conv: 1x1 matmul over channels
    s2d:  (B, gH, gW, K/g^2) -> (B, H, W, K)   (space -> channels)

The reshape order is the reference's: the channel index of a pixel is
``(gy, gx, c')``.  ``F.pixel_shuffle``/``pixel_unshuffle`` work on NCHW
and order channels ``c' * g^2 + ...``, a different tensor, so they are
not used here.
"""

from __future__ import annotations

import torch


def d2s(x: torch.Tensor, gamma: int) -> torch.Tensor:
    """Depth-to-space: (B, H, W, C) -> (B, gH, gW, C/g^2)."""
    B, H, W, C = x.shape
    g = gamma
    if C % (g * g):
        raise ValueError(f"channels {C} not divisible by gamma^2 = {g * g}")
    x = x.reshape(B, H, W, g, g, C // (g * g))
    x = x.permute(0, 1, 3, 2, 4, 5)  # B, H, g, W, g, C'
    return x.reshape(B, H * g, W * g, C // (g * g))


def s2d(x: torch.Tensor, gamma: int) -> torch.Tensor:
    """Space-to-depth: (B, gH, gW, K') -> (B, H, W, K' * g^2)."""
    B, Hg, Wg, K = x.shape
    g = gamma
    if Hg % g or Wg % g:
        raise ValueError(f"spatial {Hg}x{Wg} not divisible by gamma = {g}")
    x = x.reshape(B, Hg // g, g, Wg // g, g, K)
    x = x.permute(0, 1, 3, 2, 4, 5)  # B, H, W, g, g, K
    return x.reshape(B, Hg // g, Wg // g, K * g * g)


def s2d_conv_ref(x: torch.Tensor, w: torch.Tensor, gamma: int) -> torch.Tensor:
    """x: [B, H, W, C], w: [C/g^2, K/g^2] -> [B, H, W, K].

    f32 accumulation (inputs widened to f32, one f32 product), output in
    x's dtype — the reference's ``preferred_element_type=float32``."""
    C = x.shape[3]
    Cv = w.shape[0]
    if Cv * gamma * gamma != C:
        raise ValueError(f"w rows {Cv} != C/g^2 = {C}/{gamma * gamma}")
    y = d2s(x, gamma)  # [B, gH, gW, C/g^2]
    y = torch.einsum("bhwc,ck->bhwk", y.float(), w.float())
    return s2d(y.to(x.dtype), gamma)  # [B, H, W, Kv*g^2]
