"""Plain PyTorch reference of Zamba2 as released, in float32.

Zyphra's Zamba2 (arXiv:2411.15242) as transformers' ``modeling_zamba2.py``
computes it, on the parameter trees the benchmark makes for it
(``h100bench/zamba2_inputs.py``, the port's keys and layouts).  Every step
is float32 with TF32 off, one layer at a time; it reads the configuration
file's widths, never the program's, and imports torch alone (with the
torch-only helpers of ``reference/model.py``: ``exact_matmul``, the float8
control's ``mm``, ``rmsnorm``, ``layer`` and the chunked SSD scan).

A hybrid layer (site i of ``hybrid_layer_ids``, shared block i mod
``num_mem_blocks``), with e the embedding output:

    a  = rmsnorm_2D(concat(h, e));  o = causal_attention(a) @ Wo
    t  = (gelu(gu[:F]) * gu[F:]) @ Wdown @ Wlin_i,  gu = m @ Wgu + (m @ A_i) @ B_i,
         m = rmsnorm_D(o)
    h  = h + mamba(rmsnorm_D(h + t))

Attention: q, k, v over 2 d_model, rotary embedding over the whole head
(the two halves rotated, ``rotate_half``), scores scaled by (Dh/2)^-1/2,
causal softmax.  The Mamba mixer: in_proj to z, x, B, C (G groups), dt; the
causal depthwise conv with its bias, silu; dt = softplus(dt + dt_bias);
the SSD scan with head h reading group h G / H; the D skip; the gate
y silu(z) and its rms norm over each group's d_inner / G channels.

Departures from the release, each on purpose:

* dt is not clamped below: the release's ``time_step_limit`` is null, so its
  CUDA path applies no limit; transformers' torch path clamps dt at
  ``time_step_min`` (0.001), which its CUDA path does not;
* no attention mask, no cache, no padding: every row is a whole prompt
  whose length is a multiple of the chunk, from a zero state;
* the weights are the benchmark's random ones, stored in bf16 and read
  as float32; the embedding output e is that of the float32 stream.

``prec="fp8"`` is the benchmark's control, as in ``reference/model.py``:
every product with a weight (the projections, the adapters, the site
linears and the head) takes both operands rounded to float8 e4m3;
attention's own products stay float32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from h100bench.reference.model import F32, exact_matmul, layer, mm, rmsnorm, ssd


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, L, H, Dh] rotated by position: x cos + rotate_half(x) sin, the
    frequencies theta^(-2j/Dh) repeated over both halves."""
    L, dh = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=F32, device=x.device) / dh)
    ang = torch.arange(L, dtype=F32, device=x.device)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)[None, :, None, :]  # [1, L, 1, Dh]
    half = torch.cat([-x[..., dh // 2:], x[..., : dh // 2]], dim=-1)
    return x * torch.cos(ang) + half * torch.sin(ang)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Causal softmax attention over [B, L, H, Dh], one key head per query head."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    L = q.shape[1]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    p = torch.softmax(torch.where(mask, s, -torch.inf), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def shared_block(w: Dict, params, i: int, h: torch.Tensor, e: torch.Tensor,
                 prec: str) -> torch.Tensor:
    """Site i's addend t [B, L, D] from the stream h and the embedding e."""
    b = layer(params["shared"], i % w["num_mem_blocks"])
    ad, lin = layer(params["adapters"], i), layer(params["site_linear"], i)
    B, L, _ = h.shape
    H, dh = w["n_heads"], w["head_dim"]
    a = rmsnorm(torch.cat([h, e], dim=-1), b["attn_norm"]["scale"], w["norm_eps"])
    q, k, v = (mm(a, b[n]["w"], prec).reshape(B, L, H, dh) for n in ("wq", "wk", "wv"))
    o = attention(rope(q, w["rope_theta"]), rope(k, w["rope_theta"]), v, (dh / 2) ** -0.5)
    m = rmsnorm(mm(o.reshape(B, L, H * dh), b["wo"]["w"], prec), b["mlp_norm"]["scale"],
                w["norm_eps"])
    gu = mm(m, b["w_gate_up"]["w"], prec) + mm(mm(m, ad["down"]["w"], prec), ad["up"]["w"], prec)
    g, u = gu.chunk(2, dim=-1)
    return mm(mm(F.gelu(g) * u, b["w_down"]["w"], prec), lin["w"], prec)


def mamba_block(w: Dict, p, x: torch.Tensor, addend: Optional[torch.Tensor],
                prec: str) -> torch.Tensor:
    """x + mixer(rmsnorm(x + addend)) over x [B, L, D] (float32), from a zero state."""
    Bsz, L, _ = x.shape
    Din = w["ssm_expand"] * w["d_model"]
    N, P, Wc, G = w["ssm_state"], w["ssm_headdim"], w["ssm_conv_width"], w["ssm_ngroups"]
    H = Din // P
    h = rmsnorm(x if addend is None else x + addend, p["norm"]["scale"], w["norm_eps"])
    z, xbc, dt_raw = torch.split(mm(h, p["in_proj"]["w"], prec), [Din, Din + 2 * G * N, H],
                                 dim=-1)
    xp = F.pad(xbc, (0, 0, Wc - 1, 0))
    cw = p["conv_w"].to(F32)
    conv = sum(xp[:, i : i + L] * cw[i] for i in range(Wc)) + p["conv_b"].to(F32)
    xs, Bm, Cm = torch.split(F.silu(conv), [Din, G * N, G * N], dim=-1)
    xh = xs.reshape(Bsz, L, H, P)
    Bm, Cm = Bm.reshape(Bsz, L, G, N), Cm.reshape(Bsz, L, G, N)
    dt = F.softplus(dt_raw + p["dt_bias"].to(F32))
    log_a = dt * -torch.exp(p["A_log"].to(F32))
    hg = H // G
    y = torch.cat([ssd(xh[:, :, g * hg:(g + 1) * hg], log_a[..., g * hg:(g + 1) * hg],
                       Bm[:, :, g], Cm[:, :, g], dt[..., g * hg:(g + 1) * hg], w["ssm_chunk"])
                   for g in range(G)], dim=2)
    y = y + p["D"].to(F32)[:, None] * xh
    y = (y.reshape(Bsz, L, Din) * F.silu(z)).reshape(Bsz, L, G, Din // G)
    y = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + w["norm_eps"])
    y = y.reshape(Bsz, L, Din) * p["out_norm"]["scale"].to(F32)
    return x + mm(y, p["out_proj"]["w"], prec)


def prefill_logits(w: Dict, params, tokens: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    """Last-position logits [B, V] of ``tokens`` [B, L]."""
    if w["family"] != "zamba2":
        raise ValueError(f"this reference computes zamba2, not {w['family']!r}")
    sites = {l: i for i, l in enumerate(w["hybrid_layer_ids"])}
    with torch.no_grad(), exact_matmul():
        e = params["embed"]["emb"][tokens].to(F32)
        x = e
        for l in range(w["n_layers"]):
            t = shared_block(w, params, sites[l], x, e, prec) if l in sites else None
            x = mamba_block(w, layer(params["mamba_blocks"], l), x, t, prec)
        h = rmsnorm(x[:, -1], params["final_norm"]["scale"], w["norm_eps"])
        return mm(h, params["embed"]["emb"].T, prec)
