"""Mamba2 (SSD — state-space duality) mixer and model. [arXiv:2405.21060]

Port of the JAX package's ``models/mamba2.py``.  The SSD layer computes,
per head h with state size N and head dim P:

    S_t = a_t * S_{t-1} + dt_t * B_t (x) x_t        (S: [N, P])
    y_t = C_t . S_t + D * x_t,   a_t = exp(dt_t * A)

``ssd_naive`` is the step-by-step oracle; ``ssd_chunked`` is the plain
O(L * Q) blocked algorithm (intra-chunk quadratic term + inter-chunk state
recurrence), the chunk loop a Python loop where JAX scans.  Both take B and
C shared by every head (``[Bt, L, N]``, the JAX package's one group) or in
G groups (``[Bt, L, G, N]``, zamba2's ``mamba_ngroups``), head h reading
group h G / H: each group's heads are then scanned with that group's B and
C, so one group gives exactly the shared-B/C result.  The model's
prefill and training forward (:func:`mamba_block_apply`) call
``kernels.ssd_scan.ops.ssd_scan``, which sends a CUDA tensor to the
hand-written kernel (under autograd, with the plain version's gradient)
and a CPU tensor to ``ssd_chunked``: the same function.  (The JAX model
calls ``ssd_chunked`` directly although its ops docstring says the models
call through the switch; the port does what that docstring says.)  The
block's other passes (norms, causal conv, silu, gating) go through
``kernels.mamba_passes.ops``: the plain ones on the CPU, on ``meta`` and
under autograd, three hand-written kernels on a CUDA tensor with grad off.

Decode is the O(1)-per-token recurrent update on a carried (conv window,
SSM state) cache; it launches no kernel.  Layers stay stacked along a
leading ``n_layers`` axis, as in JAX, and the port loops over them;
:func:`ssm_loss` runs each block under ``maybe_remat``, as the reference's
scan body.

:func:`ssm_param_specs` and :func:`ssm_cache_specs` are the reference's
sharding trees as data, keyed as the port's trees (see
``models/transformer.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_passes.ops import mamba_passes
from repro_torch.kernels.mamba_passes.ref import conv_channels, split_in_proj, ssm_from_xbc
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.common import (
    chunked_softmax_xent,
    dtype_of,
    embed,
    init_embedding,
    init_linear,
    init_rmsnorm,
    linear,
    maybe_remat,
    rmsnorm,
)
from repro_torch.models.config import ModelConfig
from repro_torch.launch.mesh import AX_DATA, AX_MODEL
from repro_torch.launch.mesh import PartitionSpec as P
from repro_torch.models.transformer import _layer, _layers, _stack, _stack_specs
from repro_torch.spans import span

Params = Dict[str, Any]


# ------------------------------------------------------------------ SSD -----


def by_group(scan, x, log_a, B, C, dt, *args):
    """``scan`` with B and C shared by every head (``[Bt, L, N]``) as it is;
    with B and C in G groups (``[Bt, L, G, N]``, H a multiple of G) over each
    group's H / G heads with that group's B and C, the outputs joined along
    the heads.  One group is ``scan`` on the whole tensors."""
    if B.dim() == 3:
        return scan(x, log_a, B, C, dt, *args)
    G, H = B.shape[2], x.shape[2]
    if C.shape != B.shape or H % G:
        raise ValueError(f"B {tuple(B.shape)} and C {tuple(C.shape)} must be [Bt, L, G, N] "
                         f"with the {H} heads a multiple of G")
    hg = H // G
    ys = [scan(x[:, :, g * hg:(g + 1) * hg], log_a[..., g * hg:(g + 1) * hg], B[:, :, g],
               C[:, :, g], dt[..., g * hg:(g + 1) * hg], *args) for g in range(G)]
    return ys[0] if G == 1 else torch.cat(ys, dim=2)


def ssd_naive(x, log_a, B, C, dt):
    """Sequential oracle.  x: [Bt, L, H, P]; log_a: [Bt, L, H];
    B, C: [Bt, L, N] or [Bt, L, G, N] (:func:`by_group`); dt: [Bt, L, H]
    -> y: [Bt, L, H, P] (f32)."""
    if B.dim() == 4:
        return by_group(ssd_naive, x, log_a, B, C, dt)
    Bt, L, H, Pd = x.shape
    N = B.shape[-1]
    x, log_a, B, C, dt = (t.float() for t in (x, log_a, B, C, dt))
    S = torch.zeros((Bt, H, N, Pd), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        a = torch.exp(log_a[:, t])[..., None, None]  # [Bt,H,1,1]
        upd = torch.einsum("bn,bhp,bh->bhnp", B[:, t], x[:, t], dt[:, t])
        S = a * S + upd
        ys.append(torch.einsum("bn,bhnp->bhp", C[:, t], S))
    return torch.stack(ys, dim=1)  # [Bt, L, H, P]


def _segsum(log_a):
    """log_a: [..., Q] -> [..., Q, Q] with out[i, j] = sum_{j < k <= i}."""
    Q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=log_a.device))
    return torch.where(mask, d, -torch.inf)


def ssd_chunked(x, log_a, B, C, dt, chunk: int):
    """Blocked SSD (paper Listing 1 semantics), in f32, cast to x's dtype.
    Shapes as :func:`ssd_naive`."""
    if B.dim() == 4:
        return by_group(ssd_chunked, x, log_a, B, C, dt, chunk)
    Bt, L, H, Pd = x.shape
    N = B.shape[-1]
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"sequence length {L} is not a multiple of the chunk {Q}")
    nc = L // Q
    f32 = torch.float32
    xc = x.reshape(Bt, nc, Q, H, Pd).to(f32)
    lac = log_a.reshape(Bt, nc, Q, H).to(f32)
    Bc = B.reshape(Bt, nc, Q, N).to(f32)
    Cc = C.reshape(Bt, nc, Q, N).to(f32)
    dtc = dt.reshape(Bt, nc, Q, H).to(f32)
    xdt = xc * dtc[..., None]  # [Bt,nc,Q,H,P]

    # intra-chunk (quadratic) term
    seg = _segsum(lac.transpose(2, 3))  # [Bt,nc,H,Q,Q]
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)  # [Bt,nc,Q,Q]
    M = CB[:, :, None] * torch.exp(seg)  # [Bt,nc,H,Q,Q]
    y_diag = torch.einsum("bchij,bcjhp->bcihp", M, xdt)

    # per-chunk terminal states
    cum = torch.cumsum(lac, dim=2)  # [Bt,nc,Q,H]
    total = cum[:, :, -1]  # [Bt,nc,H]
    decay_to_end = torch.exp(total[:, :, None] - cum)  # [Bt,nc,Q,H]
    S_chunk = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Bc, decay_to_end, xdt)

    # inter-chunk recurrence: the state *entering* each chunk
    S = torch.zeros((Bt, H, N, Pd), dtype=f32, device=x.device)
    S_in = []
    for c in range(nc):
        S_in.append(S)
        S = torch.exp(total[:, c])[..., None, None] * S + S_chunk[:, c]
    S_in = torch.stack(S_in, dim=1)  # [Bt,nc,H,N,P]

    # inter-chunk contribution
    state_decay_in = torch.exp(cum)  # [Bt,nc,Q,H]
    y_off = torch.einsum("bcin,bchnp,bcih->bcihp", Cc, S_in, state_decay_in)

    y = (y_diag + y_off).reshape(Bt, L, H, Pd)
    return y.to(x.dtype)


# ------------------------------------------------------------- the block ----


def init_mamba_block(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> Params:
    """The JAX package's block init: random leaves drawn from ``gen`` at
    the JAX scales; ``A_log``, ``D`` and ``dt_bias`` deterministic.

    ``A_log = log(linspace(1, 16, H))`` is computed in float64 and rounded
    once to f32 (XLA's f32 ``linspace`` and ``log`` differ from the
    correctly rounded values by a few ulp)."""
    D, Din, H = cfg.d_model, cfg.d_inner, cfg.ssm_nheads
    dev = gen.device
    conv_ch = conv_channels(cfg)  # x, and B and C of every group
    d_in_proj = Din + conv_ch + H
    conv_w = torch.randn((cfg.ssm_conv_width, conv_ch), generator=gen,
                         dtype=torch.float32, device=dev)
    return {
        "norm": init_rmsnorm(D, dev),
        "in_proj": init_linear(gen, D, d_in_proj, dtype),
        "conv_w": (conv_w * 0.2).to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=torch.float32, device=dev),
        # A = -exp(A_log)
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float64,
                                          device=dev)).to(torch.float32),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.full((H,), 1e-2, dtype=torch.float32,
                                                    device=dev))),
        "out_norm": init_rmsnorm(Din, dev),
        "out_proj": init_linear(gen, Din, D, dtype,
                                scale=0.02 / max(1, 2 * cfg.n_layers) ** 0.5),
    }


def mamba_block_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
                      addend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One block over a whole sequence, x: [B, L, D] -> [B, L, D]:
    ``x + mixer(rmsnorm(x))``, or ``x + mixer(rmsnorm(x + addend))`` where
    zamba2's shared block hands an ``addend``.  Spans
    ``mamba.block`` around it, ``mamba.in_proj`` and ``mamba.out_proj``
    around its projections; the scan's own is ``ssd_scan``'s.  Its passes
    are ``kernels.mamba_passes.ops``'s: the plain ones (the CPU, ``meta``)
    or the fused kernels (a CUDA tensor; under autograd each in a Function
    whose backward is a kernel too), around :func:`ssd_scan`."""
    with span("mamba.block"):
        return mamba_passes(cfg, p, x, ssd_scan, addend)


# -------------------------------------------------------------- decode ------


def mamba_init_state(cfg: ModelConfig, batch: int, device: torch.device) -> Params:
    N, H, Pd = cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_channels(cfg)),
                            dtype=dtype_of(cfg.dtype), device=device),
        "ssm": torch.zeros((batch, H, N, Pd), dtype=torch.float32, device=device),
    }


def mamba_block_decode(cfg: ModelConfig, p: Params, x1: torch.Tensor,
                       state: Params) -> Tuple[torch.Tensor, Params]:
    """x1: [B, 1, D]; the O(1) recurrent update.  Returns the output and
    the new ``{"conv", "ssm"}`` state (new tensors, as in JAX)."""
    res = x1
    h = rmsnorm(p["norm"], x1, cfg.norm_eps)
    z, xbc, dt_raw = split_in_proj(cfg, linear(p["in_proj"], h))
    window = torch.cat([state["conv"], xbc], dim=1)  # [B, W, ch]
    conv = torch.einsum("bwc,wc->bc", window, p["conv_w"])[:, None, :]
    new_conv_state = window[:, 1:, :]
    xbc = F.silu((conv + p["conv_b"]).float()).to(x1.dtype)
    xh, log_a, Bm, Cm, dt = ssm_from_xbc(cfg, p, xbc, dt_raw)
    # single-step state update
    a = torch.exp(log_a[:, 0])[..., None, None]  # [B,H,1,1]
    upd = torch.einsum("bn,bhp,bh->bhnp", Bm[:, 0].float(), xh[:, 0].float(), dt[:, 0])
    S = a * state["ssm"] + upd
    y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].float(), S)
    y = y + p["D"][None, :, None] * xh[:, 0].float()
    y = y.reshape(x1.shape[0], 1, cfg.d_inner).to(x1.dtype)
    y = y * F.silu(z.float()).to(x1.dtype)
    y = rmsnorm(p["out_norm"], y, cfg.norm_eps)
    return res + linear(p["out_proj"], y), {"conv": new_conv_state, "ssm": S}


# ------------------------------------------------------------- full model ---


def init_ssm_model(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Weights drawn from ``gen`` on its device; blocks stacked ``[n_layers, ...]``."""
    dtype = dtype_of(cfg.dtype)
    return {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype),
        "blocks": _stack([init_mamba_block(gen, cfg, dtype) for _ in range(cfg.n_layers)]),
        "final_norm": init_rmsnorm(cfg.d_model, gen.device),
    }


def ssm_loss(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token cross-entropy through the tied head."""
    tokens, labels = batch["tokens"], batch["labels"]
    h = embed(params["embed"], tokens)
    body = maybe_remat(lambda p, x: mamba_block_apply(cfg, p, x), cfg)
    for p in _layers(params["blocks"]):
        h = body(p, h)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    # mamba2-1.3b ties embeddings (GPT-NeoX tokenizer family)
    return chunked_softmax_xent(h, params["embed"]["emb"].T, labels, chunk=cfg.logits_chunk)


def ssm_prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Forward over ``tokens [B, L]`` -> last-position logits [B, vocab] (f32).
    The final norm is per position, so only the last one is normed."""
    h = embed(params["embed"], tokens)
    for i in range(cfg.n_layers):
        h = mamba_block_apply(cfg, _layer(params["blocks"], i), h)
    h = rmsnorm(params["final_norm"], h[:, -1], cfg.norm_eps)
    # mamba2-1.3b ties embeddings (GPT-NeoX tokenizer family)
    return (h @ params["embed"]["emb"].T).float()


def ssm_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   device: torch.device) -> Params:
    """Per-layer states stacked ``[n_layers, ...]``; ``max_len`` is
    unused (the state does not grow with the sequence)."""
    per = mamba_init_state(cfg, batch, device)
    return {k: v[None].repeat((cfg.n_layers,) + (1,) * v.dim()) for k, v in per.items()}


def ssm_decode_step(
    cfg: ModelConfig,
    params: Params,
    token: torch.Tensor,  # [B] int
    cache: Params,
    pos: int,
) -> Tuple[torch.Tensor, Params]:
    """One step: next-token logits (f32) and the cache, its layers'
    states overwritten in place.  ``pos`` is unused (the state carries
    the position), as in JAX."""
    x1 = embed(params["embed"], token)[:, None, :]
    for i in range(cfg.n_layers):
        x1, new = mamba_block_decode(cfg, _layer(params["blocks"], i), x1,
                                     {"conv": cache["conv"][i], "ssm": cache["ssm"][i]})
        cache["conv"][i].copy_(new["conv"])
        cache["ssm"][i].copy_(new["ssm"])
    h = rmsnorm(params["final_norm"], x1, cfg.norm_eps)
    logits = (h[:, 0, :] @ params["embed"]["emb"].T).float()
    return logits, cache


# --------------------------------------------------------------- shardings --


def ssm_param_specs(cfg: ModelConfig, mode: str = "train") -> Params:
    if cfg.fsdp_all_axes:
        # Small-model ZeRO-1 profile: NO tensor parallelism — batch
        # data-parallel across (data, model), parameters REPLICATED (a
        # 1.3B model fits), and only the f32 optimizer moments sharded (see
        # repro_torch.optim.adamw.zero1_opt_specs).  Eliminates both the
        # per-block TP all-reduces AND the per-layer FSDP weight gathers;
        # the only collectives left are one gradient all-reduce + the
        # updated-parameter all-gather.
        block = {
            "norm": {"scale": P(None)},
            "in_proj": {"w": P(None, None)},
            "conv_w": P(None, None),
            "conv_b": P(None),
            "A_log": P(None),
            "D": P(None),
            "dt_bias": P(None),
            "out_norm": {"scale": P(None)},
            "out_proj": {"w": P(None, None)},
        }
        return {
            "embed": {"emb": P(None, None)},
            "blocks": _stack_specs(block),
            "final_norm": {"scale": P(None)},
        }
    block = {
        "norm": {"scale": P(None)},
        "in_proj": {"w": P(AX_DATA, AX_MODEL)},
        "conv_w": P(None, AX_MODEL),
        "conv_b": P(AX_MODEL),
        "A_log": P(None),
        "D": P(None),
        "dt_bias": P(None),
        "out_norm": {"scale": P(AX_MODEL)},
        "out_proj": {"w": P(AX_MODEL, AX_DATA)},
    }
    return {
        "embed": {"emb": P(AX_MODEL, AX_DATA)},
        "blocks": _stack_specs(block),
        "final_norm": {"scale": P(None)},
    }


def ssm_cache_specs(cfg: ModelConfig, seq_shard: bool = False) -> Params:
    return {
        "conv": P(None, AX_DATA, None, AX_MODEL),
        "ssm": P(None, AX_DATA, AX_MODEL, None, None),
    }
