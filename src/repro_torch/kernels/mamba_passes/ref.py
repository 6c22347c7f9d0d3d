"""The Mamba block's plain passes: the body of ``models.mamba2.mamba_block_apply``.

:func:`mamba_passes` is the block as the port has run it op by op: the
rmsnorm, the input projection, the causal conv (a sum of W shifted products
in x's dtype), ``+ conv_b`` (promoting to f32), silu, softplus and ``dt·A``,
the scan, the D skip in f32, the ``silu(z)`` gate, the out rmsnorm, the
output projection and the residual add.  It is the CPU's and ``meta``'s
route (autograd differentiates it as it is there), and the reference the
kernels of :mod:`.kernel`, and autograd through it the reference their
backward kernels, are held to, pass by pass (``rmsnorm``,
:func:`conv_pass`, :func:`gate_pass`).

``scan`` is the SSD scan the caller passes (``kernels.ssd_scan.ops.ssd_scan``
from the model).  :func:`split_in_proj` and :func:`ssm_from_xbc` are shared
with the model's decode step.

B and C come in ``ssm_groups(cfg)`` groups (:func:`ssm_groups`: a config's
``ssm_ngroups``, 1 where it has none, as every registry configuration):
the conv runs over ``d_inner + 2 G N`` channels, the scan takes B and C as
``[B, L, G, N]``, and the gated out-norm takes its rms over each group's
``d_inner / G`` channels (zamba2's ``Zamba2RMSNormGated``).  One group is
the block as it was: B and C ``[B, L, N]`` and one rms over d_inner.
``addend`` (zamba2's hybrid sites) enters the input norm's input and not
the residual: ``x + mixer(rmsnorm(x + addend))``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import linear, rmsnorm
from repro_torch.models.config import ModelConfig
from repro_torch.spans import span

Params = Dict[str, Any]


def ssm_groups(cfg: ModelConfig) -> int:
    """The config's number of B/C groups (``ssm_ngroups``; 1 where it has none)."""
    return getattr(cfg, "ssm_ngroups", 1)


def conv_channels(cfg: ModelConfig) -> int:
    """The conv's channels: x, then B and C of every group."""
    return cfg.d_inner + 2 * ssm_groups(cfg) * cfg.ssm_state


def split_in_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    Din, H = cfg.d_inner, cfg.ssm_nheads
    z, xbc, dt = torch.split(zxbcdt, [Din, conv_channels(cfg), H], dim=-1)
    return z, xbc, dt  # xbc = conv input (x, B, C); dt: [.., H]


def ssm_from_xbc(cfg: ModelConfig, p: Params, xbc: torch.Tensor, dt_raw: torch.Tensor):
    Din, N, H, Pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    G = ssm_groups(cfg)
    x, Bm, Cm = torch.split(xbc, [Din, G * N, G * N], dim=-1)
    Bsz, L = x.shape[0], x.shape[1]
    if G > 1:
        Bm, Cm = Bm.reshape(Bsz, L, G, N), Cm.reshape(Bsz, L, G, N)
    xh = x.reshape(Bsz, L, H, Pd)
    # jax.nn.softplus is logaddexp(x, 0); F.softplus returns x above 20,
    # where the two differ by less than x's f32 rounding
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # [B,L,H]
    A = -torch.exp(p["A_log"])  # [H]
    log_a = dt * A  # [B,L,H]
    return xh, log_a, Bm, Cm, dt


def gated_norm(cfg: ModelConfig, p: Params, y: torch.Tensor) -> torch.Tensor:
    """The out-norm of the gated ``y [.., d_inner]``: one rms over d_inner,
    or one over each of the G groups' ``d_inner / G`` channels."""
    G = ssm_groups(cfg)
    if G == 1:
        return rmsnorm(p["out_norm"], y, cfg.norm_eps)
    yg = y.float().reshape(*y.shape[:-1], G, y.shape[-1] // G)
    yg = yg * torch.rsqrt(torch.mean(yg * yg, dim=-1, keepdim=True) + cfg.norm_eps)
    return (yg.reshape(y.shape) * p["out_norm"]["scale"]).to(y.dtype)


def conv_pass(cfg: ModelConfig, p: Params, zxbcdt: torch.Tensor, dtype: torch.dtype):
    """The causal depthwise conv (width W) over the (x, B, C) columns of the
    input projection ``zxbcdt``, ``+ conv_b`` and silu, and dt: ``(xh, log_a,
    B, C, dt)`` as :func:`ssm_from_xbc` gives them.  The conv is in zxbcdt's
    dtype; ``+ conv_b`` (f32) promotes to f32 as in JAX, silu's output is
    rounded to ``dtype``."""
    _, xbc, dt_raw = split_in_proj(cfg, zxbcdt)
    W, L = cfg.ssm_conv_width, xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    conv = sum(pad[:, i : i + L, :] * p["conv_w"][i] for i in range(W))
    xbc = F.silu((conv + p["conv_b"]).float()).to(dtype)
    return ssm_from_xbc(cfg, p, xbc, dt_raw)


def gate_pass(cfg: ModelConfig, p: Params, y: torch.Tensor, xh: torch.Tensor,
              zxbcdt: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The D skip (f32) on the scan's output ``y [B, L, H, P]``, the
    ``silu(z)`` gate (z the first d_inner columns of ``zxbcdt``) in ``dtype``
    and the out-norm: the output projection's input ``[B, L, d_inner]``."""
    z = split_in_proj(cfg, zxbcdt)[0]
    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(y.shape[0], y.shape[1], cfg.d_inner)
    y = y.to(dtype) * F.silu(z.float()).to(dtype)
    return gated_norm(cfg, p, y)


def mamba_passes(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 scan: Callable[..., torch.Tensor],
                 addend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One block over a whole sequence, x: [B, L, D] -> [B, L, D], with
    ``scan(xh, log_a, B, C, dt, chunk)`` as its SSD scan; spans
    ``mamba.in_proj`` and ``mamba.out_proj`` around its projections.
    ``addend`` (x's shape), where given, is added to the input norm's
    input, in x's dtype, and not to the residual.  Its three passes are
    ``rmsnorm``, :func:`conv_pass` and :func:`gate_pass`."""
    res = x
    h = rmsnorm(p["norm"], x if addend is None else x + addend, cfg.norm_eps)
    with span("mamba.in_proj"):
        zxbcdt = linear(p["in_proj"], h)
    xh, log_a, Bm, Cm, dt = conv_pass(cfg, p, zxbcdt, x.dtype)
    y = scan(xh, log_a, Bm, Cm, dt, cfg.ssm_chunk)
    y = gate_pass(cfg, p, y, xh, zxbcdt, x.dtype)
    with span("mamba.out_proj"):
        out = linear(p["out_proj"], y)
    return res + out
