"""Model FLOPs of a nemotron_h prefill, from the configuration's shapes alone.

As ``model_flops.py`` counts the ssm family's (a multiply-add is 2 FLOPs;
only matrix products; what the model needs, not what an implementation
launches), for Nemotron-H's layers by its pattern:

* ``M``, a token: in_proj, the conv taps and out_proj with d_inner the Mamba
  heads times the head dim and ``d_inner + 2 G N`` conv channels; the SSD
  scan by the chunked algorithm's products, C B^T once per group and chunk
  (causal half), and per head the scores times x dt (causal half), the
  chunk's state and the C S term;
* ``*``, a token: q, k, v (GQA: the key and value heads' width), o; and
  attention's two products over the causal half (QK^T and PV at the
  L (L + 1) / 2 pairs a row and query head);
* ``E``, a token: the router, the k chosen experts' up and down products
  (the active experts only) and the shared expert's;
* the untied head at the last position.
"""

from __future__ import annotations

from typing import Dict


def mamba_proj_flops(w: Dict) -> float:
    """in_proj, the conv taps and out_proj of one block, one token."""
    D, H = w["d_model"], w["mamba_num_heads"]
    Din = H * w["ssm_headdim"]
    ch = Din + 2 * w["ssm_ngroups"] * w["ssm_state"]
    return 2.0 * D * (Din + ch + H) + 2.0 * w["ssm_conv_width"] * ch + 2.0 * Din * D


def ssd_flops(w: Dict, batch: int, seq: int) -> float:
    """The chunked SSD scan of one block over ``batch`` rows of ``seq``."""
    H, P, N, G = w["mamba_num_heads"], w["ssm_headdim"], w["ssm_state"], w["ssm_ngroups"]
    Q = min(w["ssm_chunk"], seq)
    chunks = batch * (seq // Q)
    cb = G * chunks * Q * (Q + 1) * N
    per_head = Q * (Q + 1) * P + 2 * Q * N * P + 2 * Q * N * P
    return float(cb + chunks * H * per_head)


def attn_proj_flops(w: Dict) -> float:
    """q, k, v and o of one attention layer, one token."""
    D, dh = w["d_model"], w["head_dim"]
    Aq, Akv = w["n_heads"] * dh, w["n_kv_heads"] * dh
    return 2.0 * D * (Aq + 2 * Akv) + 2.0 * Aq * D


def attention_flops(w: Dict, batch: int, seq: int) -> float:
    """QK^T and PV of one layer over the causal half, ``batch`` rows of ``seq``."""
    return 2.0 * 2 * batch * w["n_heads"] * w["head_dim"] * seq * (seq + 1) / 2


def moe_flops(w: Dict) -> float:
    """The router, the chosen experts and the shared expert of one layer, one token."""
    D, E = w["d_model"], w["n_experts"]
    return 2.0 * D * E + w["experts_per_token"] * 4.0 * D * w["moe_d_ff"] \
        + 4.0 * D * w["moe_shared_d_ff"]


def prefill_flops(w: Dict, batch: int, seq: int) -> float:
    p = w["layer_pattern"]
    T = batch * seq
    mamba = p.count("M") * (T * mamba_proj_flops(w) + ssd_flops(w, batch, seq))
    attn = p.count("*") * (T * attn_proj_flops(w) + attention_flops(w, batch, seq))
    moe = p.count("E") * T * moe_flops(w)
    return mamba + attn + moe + batch * 2.0 * w["d_model"] * w["vocab_size"]
