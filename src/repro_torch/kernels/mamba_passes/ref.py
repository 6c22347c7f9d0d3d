"""The Mamba block's plain passes: the body of ``models.mamba2.mamba_block_apply``.

:func:`mamba_passes` is the block as the port has run it op by op: the
rmsnorm, the input projection, the causal conv (a sum of W shifted products
in x's dtype), ``+ conv_b`` (promoting to f32), silu, softplus and ``dt·A``,
the scan, the D skip in f32, the ``silu(z)`` gate, the out rmsnorm, the
output projection and the residual add.  It is the CPU's and ``meta``'s
route, and the training route (autograd differentiates it as it is), and
the reference the kernels of :mod:`.kernel` are held to.

``scan`` is the SSD scan the caller passes (``kernels.ssd_scan.ops.ssd_scan``
from the model).  :func:`split_in_proj` and :func:`ssm_from_xbc` are shared
with the model's decode step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F

from repro_torch.models.common import linear, rmsnorm
from repro_torch.models.config import ModelConfig
from repro_torch.spans import span

Params = Dict[str, Any]


def split_in_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    Din, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    z, xbc, dt = torch.split(zxbcdt, [Din, Din + 2 * N, H], dim=-1)
    return z, xbc, dt  # xbc = conv input (x, B, C); dt: [.., H]


def ssm_from_xbc(cfg: ModelConfig, p: Params, xbc: torch.Tensor, dt_raw: torch.Tensor):
    Din, N, H, Pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    x, Bm, Cm = torch.split(xbc, [Din, N, N], dim=-1)
    Bsz, L = x.shape[0], x.shape[1]
    xh = x.reshape(Bsz, L, H, Pd)
    # jax.nn.softplus is logaddexp(x, 0); F.softplus returns x above 20,
    # where the two differ by less than x's f32 rounding
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # [B,L,H]
    A = -torch.exp(p["A_log"])  # [H]
    log_a = dt * A  # [B,L,H]
    return xh, log_a, Bm, Cm, dt


def mamba_passes(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 scan: Callable[..., torch.Tensor]) -> torch.Tensor:
    """One block over a whole sequence, x: [B, L, D] -> [B, L, D], with
    ``scan(xh, log_a, B, C, dt, chunk)`` as its SSD scan; spans
    ``mamba.in_proj`` and ``mamba.out_proj`` around its projections."""
    res = x
    h = rmsnorm(p["norm"], x, cfg.norm_eps)
    with span("mamba.in_proj"):
        zxbcdt = linear(p["in_proj"], h)
    z, xbc, dt_raw = split_in_proj(cfg, zxbcdt)
    # causal depthwise conv1d (width W) over the (x, B, C) channels; in
    # x's dtype, then + conv_b (f32) promotes to f32 as in JAX
    W, L = cfg.ssm_conv_width, xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    conv = sum(pad[:, i : i + L, :] * p["conv_w"][i] for i in range(W))
    xbc = F.silu((conv + p["conv_b"]).float()).to(x.dtype)
    xh, log_a, Bm, Cm, dt = ssm_from_xbc(cfg, p, xbc, dt_raw)
    y = scan(xh, log_a, Bm, Cm, dt, cfg.ssm_chunk)
    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(x.shape[0], x.shape[1], cfg.d_inner)
    y = y.to(x.dtype) * F.silu(z.float()).to(x.dtype)
    y = rmsnorm(p["out_norm"], y, cfg.norm_eps)
    with span("mamba.out_proj"):
        out = linear(p["out_proj"], y)
    return res + out
