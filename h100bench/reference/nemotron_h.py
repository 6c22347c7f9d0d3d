"""Plain PyTorch reference of Nemotron-H as released, in float32.

NVIDIA's Nemotron-H (arXiv:2504.03624) as the release's
``modeling_nemotron_h.py`` computes Nemotron-3-Nano-30B-A3B, on the
parameter trees the benchmark makes for it (``h100bench/nemotron_inputs.py``,
the port's keys and layouts).  Every step is float32 with TF32 off; the
bf16 weights are read one layer at a time (one expert at a time in an MoE
layer), so the whole model is never held in float32.  It reads the
configuration file's widths, never the program's, and imports torch alone
(with the torch-only helpers of ``reference/model.py``: ``exact_matmul``,
the float8 control's ``mm``, ``rmsnorm``, ``layer`` and the chunked SSD
scan).

Each layer is ``h + mixer(rmsnorm(h))``, its mixer by the pattern's letter:

* ``M``, Mamba-2: in_proj to z, x, B, C (G groups), dt; the causal
  depthwise conv with its bias, silu; dt = softplus(dt + dt_bias); the SSD
  scan with head h reading group h G / H; the D skip; y silu(z) and its rms
  norm over each group's d_inner / G channels; out_proj.  d_inner is the
  heads times the head dim;
* ``*``, attention: q, k, v without bias, 32 query heads over 2 key heads
  (each key head serves 16 consecutive query heads), no position embedding,
  scores scaled by 1/sqrt(Dh), causal softmax, o_proj;
* ``E``, mixture of experts: s = sigmoid(h W_r); the top k of s + b (the
  correction bias, for selection only); weights s[ids] normalised (+1e-20)
  and times routed_scaling_factor; each chosen expert relu(h W_up)^2 W_down,
  weighted and summed; plus the shared expert relu(h S_up)^2 S_down.

Then the final norm and the untied head at the last position.

The MoE layers route for themselves, or follow given expert ids
(``follow``): everywhere (``tie=inf``, the program's routes, so that a
near-tie of the k-th and the next expert that bf16 rounding flips is not
counted as an error), or only on tokens where their own k-th and (k+1)-th
biased scores lie within ``tie`` of each other.

Departures from the release, each on purpose:

* dt is not clamped: the release's ``time_step_limit`` is (0, inf), so
  its clamp is the identity;
* the group-limited selection (``n_group``, ``topk_group``) is left out:
  both are 1, so it keeps every expert;
* no attention mask, no cache, no padding: every row is a whole prompt
  whose length is a multiple of the chunk, from a zero state;
* the weights are the benchmark's random ones, stored in bf16 (the router
  and its bias in float32) and read as float32.

``prec="fp8"`` is the benchmark's control, as in ``reference/model.py``:
every product with a weight (the projections, each expert's and the shared
expert's, and the head) takes both operands rounded to float8 e4m3;
attention's own products and the router's stay float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from h100bench.reference.model import F32, exact_matmul, layer, mm, rmsnorm, ssd

KINDS = {"M": "mamba", "*": "attn", "E": "moe"}


def kinds(w: Dict) -> List[str]:
    return [KINDS[c] for c in w["layer_pattern"]]


def layer_params(w: Dict, params, l: int):
    """``(kind, weights)`` of layer ``l``: the layer's slice of its kind's stack."""
    ks = kinds(w)
    return ks[l], layer(params[ks[l]], ks[:l].count(ks[l]))


def mamba_mixer(w: Dict, p, h: torch.Tensor, prec: str) -> torch.Tensor:
    """The Mamba-2 mixer over the normed h [B, L, D], from a zero state."""
    Bsz, L, _ = h.shape
    H, P = w["mamba_num_heads"], w["ssm_headdim"]
    Din = H * P
    N, Wc, G = w["ssm_state"], w["ssm_conv_width"], w["ssm_ngroups"]
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
    return mm(y, p["out_proj"]["w"], prec)


def attention_mixer(w: Dict, p, h: torch.Tensor, prec: str) -> torch.Tensor:
    """Causal GQA without position embedding over the normed h [B, L, D],
    one row and one key head at a time."""
    Bsz, L, _ = h.shape
    H, Hkv, dh = w["n_heads"], w["n_kv_heads"], w["head_dim"]
    q = mm(h, p["wq"]["w"], prec).reshape(Bsz, L, H, dh)
    k = mm(h, p["wk"]["w"], prec).reshape(Bsz, L, Hkv, dh)
    v = mm(h, p["wv"]["w"], prec).reshape(Bsz, L, Hkv, dh)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=h.device))
    g = H // Hkv
    o = torch.empty_like(q)
    for b in range(Bsz):
        for j in range(Hkv):
            qs = q[b, :, j * g:(j + 1) * g]  # [L, g, dh]
            s = torch.einsum("qhd,kd->hqk", qs, k[b, :, j]) / math.sqrt(dh)
            a = torch.softmax(torch.where(causal, s, -torch.inf), dim=-1)
            o[b, :, j * g:(j + 1) * g] = torch.einsum("hqk,kd->qhd", a, v[b, :, j])
    return mm(o.reshape(Bsz, L, H * dh), p["wo"]["w"], prec)


def relu2(u: torch.Tensor) -> torch.Tensor:
    return torch.relu(u) ** 2


def moe_mixer(w: Dict, p, h: torch.Tensor, prec: str, follow: Optional[torch.Tensor] = None,
              tie: float = 0.0, stats: Optional[Dict] = None) -> torch.Tensor:
    """The MoE mixer over the normed h [B, L, D].  ``follow`` ([B, L, k]
    expert ids) replaces the layer's own choice on tokens whose k-th and
    (k+1)-th biased scores lie within ``tie``; ``stats`` (a dict) gathers
    the route sets whose own choice differs from ``follow`` and the rows
    each expert received."""
    Bsz, L, D = h.shape
    E, K = w["n_experts"], w["experts_per_token"]
    x = h.reshape(-1, D)
    scores = torch.sigmoid(x @ p["router"]["w"].to(F32))
    top = torch.topk(scores + p["e_bias"].to(F32), K + 1, dim=-1)
    ids = top.indices[:, :K]
    if follow is not None:
        fol = follow.reshape(-1, K).to(ids.device)
        near = (top.values[:, K - 1] - top.values[:, K]) < tie
        if stats is not None:
            differ = (fol.sort(-1).values != ids.sort(-1).values).any(-1)
            stats["routes"] = stats.get("routes", 0) + x.shape[0]
            stats["differ"] = stats.get("differ", 0) + int(differ.sum())
        ids = torch.where(near[:, None], fol, ids)
    wts = scores.gather(1, ids)
    wts = wts / (wts.sum(-1, keepdim=True) + 1e-20) * w["routed_scaling_factor"]
    out = torch.zeros_like(x)
    counts = torch.bincount(ids.reshape(-1), minlength=E)
    if stats is not None:
        stats.setdefault("rows", []).append(counts.cpu())
    for e in torch.nonzero(counts).reshape(-1).tolist():
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        y = mm(relu2(mm(x[tok], p["w_up"][e], prec)), p["w_down"][e], prec)
        out.index_add_(0, tok, y * wts[tok, slot][:, None])
    shared = mm(relu2(mm(x, p["shared_up"]["w"], prec)), p["shared_down"]["w"], prec)
    return (out + shared).reshape(Bsz, L, D)


def layer_apply(w: Dict, kind: str, p, h: torch.Tensor, prec: str = "f32",
                follow: Optional[torch.Tensor] = None, tie: float = 0.0,
                stats: Optional[Dict] = None) -> torch.Tensor:
    """``h + mixer(rmsnorm(h))`` of one layer over h [B, L, D] (float32)."""
    x = rmsnorm(h, p["norm"]["scale"], w["norm_eps"])
    if kind == "mamba":
        return h + mamba_mixer(w, p, x, prec)
    if kind == "attn":
        return h + attention_mixer(w, p, x, prec)
    if kind == "moe":
        return h + moe_mixer(w, p, x, prec, follow, tie, stats)
    raise ValueError(kind)


def prefill_logits(w: Dict, params, tokens: torch.Tensor, prec: str = "f32",
                   routes: Optional[List[torch.Tensor]] = None, tie: float = math.inf,
                   stats: Optional[Dict] = None) -> torch.Tensor:
    """Last-position logits [B, V] of ``tokens`` [B, L].  Where ``routes``
    holds each MoE layer's ids ``[B, L, k]`` for these rows, the layers
    follow them on their near-ties within ``tie`` (everywhere by default)."""
    if w["family"] != "nemotron_h":
        raise ValueError(f"this reference computes nemotron_h, not {w['family']!r}")
    moe_i = 0
    with torch.no_grad(), exact_matmul():
        x = params["embed"]["emb"][tokens].to(F32)
        for l in range(len(w["layer_pattern"])):
            kind, p = layer_params(w, params, l)
            follow = None
            if kind == "moe" and routes is not None:
                follow, moe_i = routes[moe_i], moe_i + 1
            x = layer_apply(w, kind, p, x, prec, follow, tie, stats)
        h = rmsnorm(x[:, -1], params["final_norm"]["scale"], w["norm_eps"])
        return mm(h, params["head"]["w"], prec)
