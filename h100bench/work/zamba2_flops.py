"""Model FLOPs of a zamba2 prefill, from the configuration's shapes alone.

As ``model_flops.py`` counts the ssm family's (a multiply-add is 2 FLOPs;
only matrix products; what the model needs, not what an implementation
launches), for Zamba2's layers:

* every layer's Mamba-2 block, a token: in_proj, the conv taps and out_proj
  over ``d_inner + 2 G N`` conv channels; the SSD scan by the chunked
  algorithm's products, C B^T once per group (``model_flops.ssd_flops`` and
  G - 1 groups' more);
* each hybrid site, a token: q, k, v over 2 d_model, o, the MLP's gate-up,
  the site's adapter (d_model -> rank -> 2 d_ff), the down projection and
  the site's linear; and attention's two products over the causal half
  (QK^T and PV at the L (L + 1) / 2 pairs a row and head);
* the tied head at the last position.

With no hybrid site and one group this is ``model_flops.prefill_flops``.
"""

from __future__ import annotations

from typing import Dict

from h100bench.work import model_flops


def _as_one_group(w: Dict) -> Dict:
    """Widths whose B/C channels are every group's: the projections' shapes."""
    return dict(w, ssm_state=w.get("ssm_ngroups", 1) * w["ssm_state"])


def mamba_proj_flops(w: Dict) -> float:
    """in_proj, the conv taps and out_proj of one block, one token."""
    return model_flops.mamba_proj_flops(_as_one_group(w))


def ssd_flops(w: Dict, batch: int, seq: int) -> float:
    """The chunked SSD scan of one block over ``batch`` rows of ``seq``."""
    Q = min(w["ssm_chunk"], seq)
    extra_cb = (w.get("ssm_ngroups", 1) - 1) * batch * (seq // Q) * Q * (Q + 1) * w["ssm_state"]
    return model_flops.ssd_flops(w, batch, seq) + extra_cb


def site_flops(w: Dict) -> float:
    """One hybrid site's matrix products but attention's, one token."""
    D, F, r = w["d_model"], w["d_ff"], w["adapter_rank"]
    A = w["n_heads"] * w["head_dim"]
    return 2.0 * (3 * 2 * D * A + A * D + D * 2 * F + D * r + r * 2 * F + F * D + D * D)


def attention_flops(w: Dict, batch: int, seq: int) -> float:
    """QK^T and PV of one site over the causal half, ``batch`` rows of ``seq``."""
    return 2.0 * 2 * batch * w["n_heads"] * w["head_dim"] * seq * (seq + 1) / 2


def prefill_flops(w: Dict, batch: int, seq: int) -> float:
    sites = len(w.get("hybrid_layer_ids", ()))
    mamba = w["n_layers"] * (batch * seq * mamba_proj_flops(w) + ssd_flops(w, batch, seq))
    shared = sites * (batch * seq * site_flops(w) + attention_flops(w, batch, seq)) if sites else 0
    return mamba + shared + batch * model_flops.head_flops(w)
