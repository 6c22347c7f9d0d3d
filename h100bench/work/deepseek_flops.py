"""Model FLOPs of a deepseek_v3 prefill, and the flash kernel's least time, from shapes alone.

As ``model_flops.py`` counts (a multiply-add is 2 FLOPs; only matrix
products; what the model needs, not what an implementation launches), for
DeepSeek-V3's layers on one card's share of its experts:

* every layer, a token: MLA's projections, W_qa, W_qb, W_kva, W_kvb and W_o;
  and attention's two products over the causal half, Q K^T at nope + rope
  and P V at v, at the L (L + 1) / 2 pairs a row and head;
* a dense layer, a token: the SwiGLU MLP's gate, up and down products;
* an MoE layer, a token: the router over all E experts and the shared
  expert; and a routed row (a route to a held expert, as the program counts
  them): its expert's gate, up and down products;
* the untied head at the last position.
"""

from __future__ import annotations

from typing import Dict

from h100bench.work.roofline import PEAK


def mla_proj_flops(w: Dict) -> float:
    """W_qa, W_qb, W_kva, W_kvb and W_o of one layer, one token."""
    D, H = w["d_model"], w["n_heads"]
    nope, rope, dv = w["qk_nope_dim"], w["qk_rope_dim"], w["v_head_dim"]
    Rq, Rkv = w["q_lora_rank"], w["kv_lora_rank"]
    return 2.0 * (D * Rq + Rq * H * (nope + rope) + D * (Rkv + rope) + Rkv * H * (nope + dv)
                  + H * dv * D)


def attention_flops(w: Dict, batch: int, seq: int) -> float:
    """Q K^T (nope + rope) and P V (v) of one layer over the causal half."""
    pairs = batch * w["n_heads"] * seq * (seq + 1) / 2
    return 2.0 * pairs * (w["qk_nope_dim"] + w["qk_rope_dim"] + w["v_head_dim"])


def dense_flops(w: Dict) -> float:
    """A dense layer's SwiGLU MLP, one token."""
    return 6.0 * w["d_model"] * w["d_ff"]


def moe_token_flops(w: Dict) -> float:
    """An MoE layer's router and shared expert, one token."""
    return 2.0 * w["d_model"] * w["n_experts"] + 6.0 * w["d_model"] * w["moe_shared_d_ff"]


def routed_row_flops(w: Dict) -> float:
    """One route through a held SwiGLU expert."""
    return 6.0 * w["d_model"] * w["moe_d_ff"]


def prefill_flops(w: Dict, batch: int, seq: int, held_rows: int) -> float:
    """One prefill of ``batch`` rows of ``seq`` whose MoE layers routed
    ``held_rows`` rows to held experts in all."""
    T, L, n_dense = batch * seq, w["n_layers"], w["first_k_dense"]
    mla = L * (T * mla_proj_flops(w) + attention_flops(w, batch, seq))
    ffn = n_dense * T * dense_flops(w) + (L - n_dense) * T * moe_token_flops(w)
    return (mla + ffn + held_rows * routed_row_flops(w)
            + batch * 2.0 * w["d_model"] * w["vocab_size"])


def flash_bound_s(w: Dict, batch: int, seq: int, dtype: str) -> float:
    """The least time of one layer's attention at the tensor cores' peak:
    :func:`attention_flops` (q, k, v and o, some 1.6 GB at 16k, take a
    hundredth of it at the HBM rate)."""
    return attention_flops(w, batch, seq) / PEAK[dtype]
