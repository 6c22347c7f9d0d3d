"""Plain PyTorch reference of DeepSeek-V3 as released, in float32.

DeepSeek-V3 (arXiv:2412.19437) as the release's ``modeling_deepseek.py``
computes it, on the parameter trees the benchmark makes for it
(``h100bench/deepseek_inputs.py``, the port's keys and layouts).  Every step
is float32 with TF32 off; the bf16 weights are read one layer at a time (one
expert at a time in an MoE layer), so the whole model is never held in
float32.  It reads the configuration file's widths, never the program's, and
imports torch alone (with the torch-only helpers of ``reference/model.py``:
``exact_matmul``, the float8 control's ``mm``, ``rmsnorm`` and ``layer``).

Each layer is ``h = h + attn(rmsnorm(h)); h = h + ffn(rmsnorm(h))``:

* attention (``DeepseekV3Attention``): q = q_b_proj(q_a_layernorm(q_a_proj(x)))
  split into q_nope [128] and q_pe [64] a head; [c_kv | k_pe] =
  kv_a_proj_with_mqa(x); [k_nope | v] = kv_b_proj(kv_a_layernorm(c_kv)) a
  head; q_pe and the one k_pe rotated by ``apply_rotary_pos_emb`` (each
  pair (2i, 2i+1) taken apart into the halves, then ``x cos + rotate_half(x)
  sin``) with ``DeepseekV3YarnRotaryEmbedding``'s cos and sin (YaRN's
  frequencies from ``yarn_find_correction_range`` and
  ``yarn_linear_ramp_mask``, times ``mscale / mscale_all_dim``); scores
  [q_nope | q_pe] . [k_nope | k_pe] times ``softmax_scale`` = 192^-1/2
  ``yarn_get_mscale(factor, mscale_all_dim)``^2, causal softmax, times v,
  o_proj.  Computed a row, a block of heads and a block of queries at a
  time, so that a 16k row fits;
* the first ``first_k_dense`` layers' MLP: down(silu(gate(x)) * up(x));
* the MoE layers (``MoEGate``, ``noaux_tc``, and ``DeepseekV3MoE``): s =
  sigmoid(x W_r); b = s + e_score_correction_bias; each of ``n_group``
  groups scored by the sum of its top 2 of b; the best ``topk_group``
  groups kept and b set to 0 elsewhere; the top k of b; weights s[ids]
  normalised (+1e-20) and times ``routed_scaling_factor``; each chosen
  held expert's down(silu(gate(x)) * up(x)), weighted and summed; plus the
  shared expert.

Then the final norm and the untied head at the last position.

Expert parallelism, as the program: the layer holds the experts
``expert_offset`` to ``expert_offset + n_experts_held - 1`` (the weights
``w_gate_up``, ``w_down`` of those alone), routes over all ``n_experts``,
and sums the held experts' part; what the other chips' experts would add is
left out.  The MoE layers route for themselves, or follow given expert ids
(``follow``): everywhere (``tie=inf``, the program's routes) or only on
tokens where their own selection is near a tie, the k-th and (k+1)-th kept
biased scores or the ``topk_group``-th and next group scores within
``tie`` of each other.

Departures from the release, each on purpose:

* no attention mask, no cache, no padding: every row is a whole prompt
  from position 0; the rope tables are computed in float32 and not cached
  in the activations' dtype;
* the multi-token-prediction module is left out: it serves training and
  speculative decoding, not a prefill's logits;
* the weights are the benchmark's random ones, stored in bf16 (the router
  and its bias in float32) and read as float32, in place of the release's
  FP8 block-scaled ones.

``prec="fp8"`` is the benchmark's control, as in ``reference/model.py``:
every product with a weight (the projections, the MLPs', each expert's and
the shared expert's, and the head) takes both operands rounded to float8
e4m3; attention's own products and the router's stay float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from h100bench.reference.model import F32, exact_matmul, layer, mm, rmsnorm

#: query positions and heads a block of the reference's attention
Q_BLOCK, HEAD_BLOCK = 1024, 16


def kinds(w: Dict) -> List[str]:
    return ["dense" if l < w["first_k_dense"] else "moe" for l in range(w["n_layers"])]


def layer_params(w: Dict, params, l: int):
    """``(kind, attention weights, feed-forward weights)`` of layer ``l``."""
    kind = kinds(w)[l]
    return kind, layer(params["mla"], l), layer(params[kind],
                                                 l if kind == "dense" else l - w["first_k_dense"])


# ------------------------------------------------------------------- rope ---

def yarn_find_correction_dim(num_rotations, dim, base, max_position_embeddings):
    return (dim * math.log(max_position_embeddings / (num_rotations * 2 * math.pi))) / (
        2 * math.log(base))


def yarn_find_correction_range(low_rot, high_rot, dim, base, max_position_embeddings):
    low = math.floor(yarn_find_correction_dim(low_rot, dim, base, max_position_embeddings))
    high = math.ceil(yarn_find_correction_dim(high_rot, dim, base, max_position_embeddings))
    return max(low, 0), min(high, dim - 1)


def yarn_get_mscale(scale=1.0, mscale=1.0):
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_linear_ramp_mask(lo, hi, dim, device):
    if lo == hi:
        hi += 0.001
    return torch.clamp((torch.arange(dim, dtype=F32, device=device) - lo) / (hi - lo), 0, 1)


def yarn_cos_sin(w: Dict, L: int, device):
    """``DeepseekV3YarnRotaryEmbedding``'s cos and sin [L, rope] (float32)."""
    dim, base, factor = w["qk_rope_dim"], w["rope_theta"], w["rope_factor"]
    exps = torch.arange(0, dim, 2, dtype=F32, device=device) / dim
    freq_extra = 1.0 / (base ** exps)
    freq_inter = 1.0 / (factor * base ** exps)
    low, high = yarn_find_correction_range(w["rope_beta_fast"], w["rope_beta_slow"], dim, base,
                                           w["rope_original_max"])
    inv_freq_mask = 1.0 - yarn_linear_ramp_mask(low, high, dim // 2, device)
    inv_freq = freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask
    freqs = torch.outer(torch.arange(L, dtype=F32, device=device), inv_freq)
    m = yarn_get_mscale(factor, w["rope_mscale"]) / yarn_get_mscale(factor,
                                                                    w["rope_mscale_all_dim"])
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos() * m, emb.sin() * m


def rotate_half(x):
    x1, x2 = x[..., : x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def apply_rotary_pos_emb(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The release's rope on ``x [B, L, h, d]`` (positions 0..L-1): the pairs
    taken apart, then ``x cos + rotate_half(x) sin``."""
    B, L, h, d = x.shape
    x = x.reshape(B, L, h, d // 2, 2).transpose(4, 3).reshape(B, L, h, d)
    return x * cos[:, None] + rotate_half(x) * sin[:, None]


def softmax_scale(w: Dict) -> float:
    m = yarn_get_mscale(w["rope_factor"], w["rope_mscale_all_dim"])
    return (w["qk_nope_dim"] + w["qk_rope_dim"]) ** -0.5 * m * m


# -------------------------------------------------------------- attention ---

def attention(w: Dict, p, x: torch.Tensor, prec: str) -> torch.Tensor:
    """MLA over the normed x [B, L, D]."""
    Bsz, L, _ = x.shape
    H, nope, rope, dv = w["n_heads"], w["qk_nope_dim"], w["qk_rope_dim"], w["v_head_dim"]
    eps = w["norm_eps"]
    q = mm(rmsnorm(mm(x, p["q_a"]["w"], prec), p["q_norm"]["scale"], eps), p["q_b"]["w"], prec)
    q = q.reshape(Bsz, L, H, nope + rope)
    c_kv, k_pe = torch.split(mm(x, p["kv_a"]["w"], prec), [w["kv_lora_rank"], rope], dim=-1)
    kv = mm(rmsnorm(c_kv, p["kv_norm"]["scale"], eps), p["kv_b"]["w"], prec)
    kv = kv.reshape(Bsz, L, H, nope + dv)
    cos, sin = yarn_cos_sin(w, L, x.device)
    q_pe = apply_rotary_pos_emb(q[..., nope:], cos, sin)
    k_pe = apply_rotary_pos_emb(k_pe.reshape(Bsz, L, 1, rope), cos, sin)
    q = torch.cat([q[..., :nope], q_pe], dim=-1)
    k = torch.cat([kv[..., :nope], k_pe.expand(Bsz, L, H, rope)], dim=-1)
    v = kv[..., nope:]
    scale = softmax_scale(w)
    o = torch.empty((Bsz, L, H, dv), dtype=F32, device=x.device)
    for b in range(Bsz):
        for h0 in range(0, H, HEAD_BLOCK):
            hs = slice(h0, h0 + HEAD_BLOCK)
            for q0 in range(0, L, Q_BLOCK):
                q1 = min(q0 + Q_BLOCK, L)
                s = torch.einsum("qhd,khd->hqk", q[b, q0:q1, hs], k[b, :q1, hs]) * scale
                causal = (torch.arange(q0, q1, device=x.device)[:, None]
                          >= torch.arange(q1, device=x.device)[None, :])
                a = torch.softmax(torch.where(causal, s, -torch.inf), dim=-1)
                o[b, q0:q1, hs] = torch.einsum("hqk,khd->qhd", a, v[b, :q1, hs])
    return mm(o.reshape(Bsz, L, H * dv), p["o"]["w"], prec)


# ----------------------------------------------------------- feed-forward ---

def swiglu_mlp(x: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor, prec: str):
    """down(silu(gate(x)) * up(x)), ``gate_up`` [D, 2F] as [W_g | W_u]."""
    g, u = mm(x, gate_up, prec).chunk(2, dim=-1)
    return mm(F.silu(g) * u, down, prec)


def select(w: Dict, scores: torch.Tensor, bias: torch.Tensor):
    """The release's ``noaux_tc`` selection: ``(ids [T, k], near-tie margin [T])``."""
    T, E = scores.shape
    G, K = w["n_group"], w["experts_per_token"]
    b = scores + bias
    group_scores = b.view(T, G, -1).topk(2, dim=-1)[0].sum(dim=-1)
    top_g = torch.topk(group_scores, k=min(w["topk_group"] + 1, G), dim=-1)
    group_idx = top_g.indices[:, : w["topk_group"]]
    group_mask = torch.zeros_like(group_scores)
    group_mask.scatter_(1, group_idx, 1)
    score_mask = group_mask.unsqueeze(-1).expand(T, G, E // G).reshape(T, -1)
    tmp = b.masked_fill(~score_mask.bool(), 0.0)
    top = torch.topk(tmp, k=K + 1, dim=-1)
    margin = top.values[:, K - 1] - top.values[:, K]
    if w["topk_group"] < G:
        margin = torch.minimum(margin, top_g.values[:, -2] - top_g.values[:, -1])
    return top.indices[:, :K], margin


def moe(w: Dict, p, x: torch.Tensor, prec: str, follow: Optional[torch.Tensor] = None,
        tie: float = 0.0, stats: Optional[Dict] = None) -> torch.Tensor:
    """The held experts' part and the shared expert over the normed x [B, L,
    D].  ``follow`` ([B, L, k] expert ids) replaces the layer's own choice
    on tokens whose selection is within ``tie`` of a tie; ``stats`` (a
    dict) gathers the route sets whose own choice differs from ``follow``
    and the rows each held expert received."""
    Bsz, L, D = x.shape
    K, off, n = w["experts_per_token"], w["expert_offset"], w["n_experts_held"]
    xt = x.reshape(-1, D)
    scores = torch.sigmoid(xt @ p["router"]["w"].to(F32))
    ids, margin = select(w, scores, p["e_bias"].to(F32))
    if follow is not None:
        fol = follow.reshape(-1, K).to(ids.device)
        if stats is not None:
            differ = (fol.sort(-1).values != ids.sort(-1).values).any(-1)
            stats["routes"] = stats.get("routes", 0) + xt.shape[0]
            stats["differ"] = stats.get("differ", 0) + int(differ.sum())
        ids = torch.where((margin < tie)[:, None], fol, ids)
    wts = scores.gather(1, ids)
    wts = wts / (wts.sum(-1, keepdim=True) + 1e-20) * w["routed_scaling_factor"]
    out = torch.zeros_like(xt)
    counts = torch.bincount(ids.reshape(-1), minlength=w["n_experts"])[off:off + n]
    if stats is not None:
        stats.setdefault("rows", []).append(counts.cpu())
    for e in (torch.nonzero(counts).reshape(-1) + off).tolist():
        tok, slot = torch.nonzero(ids == e, as_tuple=True)
        y = swiglu_mlp(xt[tok], p["w_gate_up"][e - off], p["w_down"][e - off], prec)
        out.index_add_(0, tok, y * wts[tok, slot][:, None])
    shared = swiglu_mlp(xt, p["shared_gate_up"]["w"], p["shared_down"]["w"], prec)
    return (out + shared).reshape(Bsz, L, D)


def layer_apply(w: Dict, kind: str, pa, pf, h: torch.Tensor, prec: str = "f32",
                follow: Optional[torch.Tensor] = None, tie: float = 0.0,
                stats: Optional[Dict] = None) -> torch.Tensor:
    """One layer over h [B, L, D] (float32): attention, then the MLP or MoE."""
    eps = w["norm_eps"]
    h = h + attention(w, pa, rmsnorm(h, pa["norm"]["scale"], eps), prec)
    x = rmsnorm(h, pf["norm"]["scale"], eps)
    if kind == "dense":
        return h + swiglu_mlp(x, pf["gate_up"]["w"], pf["down"]["w"], prec)
    if kind == "moe":
        return h + moe(w, pf, x, prec, follow, tie, stats)
    raise ValueError(kind)


def prefill_logits(w: Dict, params, tokens: torch.Tensor, prec: str = "f32",
                   routes: Optional[List[torch.Tensor]] = None, tie: float = math.inf,
                   stats: Optional[Dict] = None) -> torch.Tensor:
    """Last-position logits [B, V] of ``tokens`` [B, L].  Where ``routes``
    holds each MoE layer's ids ``[B, L, k]`` for these rows, the layers
    follow them on their near-ties within ``tie`` (everywhere by default)."""
    if w["family"] != "deepseek_v3":
        raise ValueError(f"this reference computes deepseek_v3, not {w['family']!r}")
    moe_i = 0
    with torch.no_grad(), exact_matmul():
        x = params["embed"]["emb"][tokens].to(F32)
        for l in range(w["n_layers"]):
            kind, pa, pf = layer_params(w, params, l)
            follow = None
            if kind == "moe" and routes is not None:
                follow, moe_i = routes[moe_i], moe_i + 1
            x = layer_apply(w, kind, pa, pf, x, prec, follow, tie, stats)
        h = rmsnorm(x[:, -1], params["final_norm"]["scale"], w["norm_eps"])
        return mm(h, params["head"]["w"], prec)
