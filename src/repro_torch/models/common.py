"""Shared torch building blocks of the decode path: norms, RoPE, GQA attention.

Port of the parts of the JAX package's ``models/common.py`` that a dense
decode step runs.  Parameters are plain dicts of tensors in the JAX
layouts (``w [d_in, d_out]``, ``emb [vocab, d]``, ``scale [d]``), made by
the ``init_*`` helpers from an explicit ``torch.Generator`` on the target
device (the numbers differ from ``jax.random``'s; the tests draw weights
with numpy and hand the same arrays to both packages).  Compute runs in
the parameters' dtype with f32 where the JAX package uses it: norm
statistics, RoPE phases, attention scores and softmax, the GLU gate.

Not ported here: ``flash_attention`` and ``chunked_softmax_xent``
(prefill and training, a later slice); ``shard_hint`` and
``maybe_remat`` (no counterpart on one card).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}[name]


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


# ------------------------------------------------------------- activations --


def glu_activation(kind: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if kind == "swiglu":
        return F.silu(a.float()).to(a.dtype) * b
    if kind == "geglu":
        return F.gelu(a.float(), approximate="tanh").to(a.dtype) * b
    raise ValueError(kind)
