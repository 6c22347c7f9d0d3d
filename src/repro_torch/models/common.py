"""Shared torch building blocks: norms, RoPE, GQA attention, the chunked loss, remat.

Port of the JAX package's ``models/common.py``.  Parameters are plain
dicts of tensors in the JAX layouts (``w [d_in, d_out]``, ``emb [vocab,
d]``, ``scale [d]``), made by the ``init_*`` helpers from an explicit
``torch.Generator`` on the target device (the numbers differ from
``jax.random``'s; the tests draw weights with numpy and hand the same
arrays to both packages).  Compute runs in the parameters' dtype with f32
where the JAX package uses it: norm statistics, RoPE phases, attention
scores and softmax, the GLU gate, the loss's logits.

``maybe_remat`` is the reference's activation-checkpoint policy on
``torch.utils.checkpoint``; ``shard_hint`` is the identity (one card, no
mesh).  The logical sharding axes ``AX_DATA`` / ``AX_MODEL`` are
``repro_torch.launch.mesh``'s, re-exported here as the reference
exports them.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.launch.mesh import AX_DATA, AX_MODEL  # noqa: F401 (re-exported)
from repro_torch.spans import span
from repro_torch.tree import tree_leaves

Params = Dict[str, Any]


def shard_hint(x: torch.Tensor, *entries) -> torch.Tensor:
    """The reference's sharding constraint against the ambient mesh: one
    card has no mesh, so ``x`` as it is."""
    return x


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}[name]


# matmul outputs without batch dims: the weight products (``x @ w`` reaches
# aten.mm), not attention's batched einsums (aten.bmm)
_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def maybe_remat(body: Callable, cfg) -> Callable:
    """Wrap a layer's body per the config's activation-checkpoint policy.

    ``full``: recompute everything in the backward pass (the layer's
    inputs are all it keeps).  ``dots``: keep the outputs of the matmuls
    with no batch dims (the reference's
    ``dots_with_no_batch_dims_saveable``), recompute the rest.  ``none``
    (or ``cfg.remat`` false): the body as it is.  The wrapper checkpoints
    only while autograd records, i.e. grad is enabled and some input
    requires grad; otherwise (serving's prefill) it calls the body, so
    that no device operation changes."""
    if not cfg.remat or cfg.remat_policy == "none":
        return body
    if cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"unknown remat policy {cfg.remat_policy!r}")

    def context():
        return create_selective_checkpoint_contexts(_dots_policy)

    def wrapped(*args):
        recording = torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tree_leaves(args))
        if not recording:
            return body(*args)
        if cfg.remat_policy == "dots":
            return checkpoint(body, *args, use_reentrant=False, preserve_rng_state=False,
                              context_fn=context)
        return checkpoint(body, *args, use_reentrant=False, preserve_rng_state=False)

    return wrapped


# ------------------------------------------------------------------ norms ---


def init_rmsnorm(d: int, device: torch.device) -> Params:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"]).to(x.dtype)


# ------------------------------------------------------------------- rope ---


def rope_freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def yarn_rope_freqs(dim: int, theta: float, factor: float, original_max: int, beta_fast: float,
                    beta_slow: float, device: torch.device) -> torch.Tensor:
    """YaRN's inverse frequencies [dim/2] (arXiv:2309.00071, as DeepSeek-V3's
    ``DeepseekV3YarnRotaryEmbedding`` blends them): :func:`rope_freqs`
    (``freq_extra``) on the dims that turn more than ``beta_fast`` times
    over ``original_max`` positions, the same over ``factor``
    (``freq_inter``) on those that turn fewer than ``beta_slow`` times, and
    a linear ramp between (``yarn_find_correction_range`` and
    ``yarn_linear_ramp_mask``)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra, inter = 1.0 / (theta ** exps), 1.0 / (factor * theta ** exps)

    def turns(rotations: float) -> float:  # yarn_find_correction_dim
        return dim * math.log(original_max / (rotations * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(turns(beta_fast)), 0)
    high = min(math.ceil(turns(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    extra_share = 1.0 - ramp
    return inter * (1 - extra_share) + extra * extra_share


def yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    """YaRN's attention scale ``0.1 mscale ln(factor) + 1`` (1 where
    ``factor`` <= 1), the release's ``yarn_get_mscale``."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., L, H, Dh]; positions: [..., L] (int)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)  # [Dh/2]
    ang = positions[..., :, None, None].float() * freqs  # [..., L, 1, Dh/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- attention ---


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: [B, Lq, Hkv, G, Dh]; k: [B, Lk, Hkv, Dh] -> [B, Hkv, G, Lq, Lk], f32."""
    return torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())


def naive_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """Oracle attention. q: [B, Lq, H, Dh], k/v: [B, Lk, Hkv, Dh]."""
    B, Lq, H, Dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = float(1.0 / np.sqrt(Dh))
    qg = q.reshape(B, Lq, Hkv, G, Dh)
    s = _gqa_scores(qg, k) * scale  # [B, Hkv, G, Lq, Lk]
    if causal:
        qpos = torch.arange(Lq, device=q.device) + q_offset
        kpos = torch.arange(k.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        s = torch.where(mask, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return o.reshape(B, Lq, H, Dh)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    q_chunk: int = 512,
    k_chunk: int = 1024,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Online-softmax attention with GQA, bounded memory, on two routes.

    q, k: [B, Lq or Lk, H or Hkv, Dh]; v: [B, Lk, Hkv, Dv], Dv = Dh but
    for latent attention's split heads (DeepSeek-V3: Dh 192, Dv 128); the
    output is [B, Lq, H, Dv].  ``scale`` multiplies the scores: None is
    1/sqrt(Dh); zamba2 passes (Dh/2)^-1/2.  A bf16 CUDA
    tensor with grad off goes to the Hopper kernel (``kernels/flash_attn``:
    one launch, the tiles above the causal diagonal skipped); a CPU or
    ``meta`` tensor, a float32 call, or a call that autograd records, to the
    plain version :func:`_flash_attention` (``kernels.flash_attn.ops`` holds
    the rule).
    The whole call is the span ``flash_attention`` (a flag check with no
    profiler)."""
    from repro_torch.kernels.flash_attn import ops  # the route imports this module

    with span("flash_attention"):
        return ops.flash_attention(q, k, v, causal, q_chunk, k_chunk, scale)


def _flash_attention(q, k, v, causal, q_chunk, k_chunk, scale):
    """The plain version, chunked by ``q_chunk`` and ``k_chunk``.  Lengths
    that are not a multiple of the chunk are padded (padded keys are masked
    out, padded query rows sliced off).  The JAX package's ``lax.map`` over
    query chunks and ``lax.scan`` over key chunks are Python loops here;
    ``m``, ``l`` and ``acc`` are f32, and every block is computed, the ones
    above the causal diagonal too, as in JAX."""
    B, Lq0, H, Dh = q.shape
    _, Lk0, Hkv, _ = k.shape
    Dv = v.shape[-1]
    G = H // Hkv
    q_chunk = min(q_chunk, Lq0)
    k_chunk = min(k_chunk, Lk0)
    pad_q = (-Lq0) % q_chunk
    pad_k = (-Lk0) % k_chunk
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    Lq, Lk = Lq0 + pad_q, Lk0 + pad_k
    scale = float(1.0 / np.sqrt(Dh)) if scale is None else float(scale)
    pos = torch.arange(max(Lq, Lk), device=q.device)
    out = torch.empty((B, Lq, H, Dv), dtype=q.dtype, device=q.device)
    for q0 in range(0, Lq, q_chunk):
        q_blk = q[:, q0:q0 + q_chunk].reshape(B, q_chunk, Hkv, G, Dh)
        qpos = pos[q0:q0 + q_chunk]
        m = torch.full((B, Hkv, G, q_chunk), -1e30, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, Hkv, G, q_chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, Hkv, G, q_chunk, Dv), dtype=torch.float32, device=q.device)
        for k0 in range(0, Lk, k_chunk):
            k_blk, v_blk = k[:, k0:k0 + k_chunk], v[:, k0:k0 + k_chunk]
            kp = pos[k0:k0 + k_chunk]
            s = _gqa_scores(q_blk, k_blk) * scale  # [B,Hkv,G,qc,kc] f32
            mask = kp[None, :] < Lk0  # padded keys invisible
            if causal:
                mask = mask & (qpos[:, None] >= kp[None, :])
            s = torch.where(mask, s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v_blk.dtype), v_blk)
            acc = acc * corr[..., None] + pv
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]  # [B,Hkv,G,qc,Dv]
        out[:, q0:q0 + q_chunk] = o.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, H, Dv).to(q.dtype)
    return out[:, :Lq0]


def decode_attention(
    q1: torch.Tensor,  # [B, 1, H, Dh] — the new token's query
    cache_k: torch.Tensor,  # [B, L, Hkv, Dh]
    cache_v: torch.Tensor,
    pos: int,  # index of the new token in the cache
) -> torch.Tensor:
    """Plain GQA decode attention: positions ``<= pos`` of the cache."""
    B, L, Hkv, Dh = cache_k.shape
    H = q1.shape[2]
    G = H // Hkv
    scale = float(1.0 / np.sqrt(Dh))
    qg = q1.reshape(B, 1, Hkv, G, Dh)
    s = _gqa_scores(qg, cache_k) * scale  # [B, Hkv, G, 1, L]
    mask = torch.arange(L, device=s.device) <= pos
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(cache_v.dtype), cache_v)
    return o.reshape(B, 1, H, Dh)


# ------------------------------------------------------------------ dense ---


def init_linear(gen: torch.Generator, d_in: int, d_out: int, dtype: torch.dtype,
                scale: float = 0.02) -> Params:
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32, device=gen.device)
    return {"w": (w * scale).to(dtype)}


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"]


def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype: torch.dtype) -> Params:
    e = torch.randn((vocab, d), generator=gen, dtype=torch.float32, device=gen.device)
    return {"emb": (e * 0.02).to(dtype)}


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["emb"][tokens]


# ------------------------------------------------------------------- loss ---


def _chunk_nll(h: torch.Tensor, w_out: torch.Tensor, y: torch.Tensor,
               m: torch.Tensor):
    """(sum of masked NLL, sum of the mask) over one chunk; logits in f32."""
    logits = (h @ w_out).float()  # [B, chunk, V]
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y[..., None].long())[..., 0]
    return ((lse - gold) * m).sum(), m.sum()


def chunked_softmax_xent(
    hidden: torch.Tensor,  # [B, L, D]
    w_out: torch.Tensor,  # [D, V]
    labels: torch.Tensor,  # [B, L] int
    mask: Optional[torch.Tensor] = None,  # [B, L]
    chunk: int = 1024,
) -> torch.Tensor:
    """Mean cross-entropy computed over sequence chunks so the full
    [B, L, V] logits tensor is never materialized.  The reference's
    ``lax.scan`` over the whole chunks is a loop here, the tail past the
    last whole chunk one more step, and the mean ``tot / max(cnt, 1)``."""
    B, L, D = hidden.shape
    chunk = min(chunk, L)
    n = L // chunk
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for a in [c * chunk for c in range(n)] + ([n * chunk] if L - n * chunk else []):
        b = min(a + chunk, L)
        m = (mask[:, a:b] if mask is not None
             else torch.ones((B, b - a), dtype=torch.float32, device=hidden.device))
        nll, k = _chunk_nll(hidden[:, a:b], w_out, labels[:, a:b], m)
        tot, cnt = tot + nll, cnt + k
    return tot / torch.clamp(cnt, min=1.0)


# ------------------------------------------------------------- activations --


def glu_activation(kind: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if kind == "swiglu":
        return F.silu(a.float()).to(a.dtype) * b
    if kind == "geglu":
        return F.gelu(a.float(), approximate="tanh").to(a.dtype) * b
    raise ValueError(kind)
