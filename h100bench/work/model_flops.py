"""Model FLOPs of a prefill and a training step, from the configuration's
shapes alone.

These count what the model needs, not what an implementation launches,
so a kernel that skips work (one that leaves out the zero upper half of
a chunk's causal scores, say) lowers the time and not the count.  A
multiply-add is 2 FLOPs; only matrix products are counted (norms,
activations and elementwise passes are left out):

* a Mamba2 block, a token: in_proj, the depthwise conv taps, out_proj;
  the SSD scan by the chunked algorithm's products (C B^T once per chunk,
  its causal half; the intra-chunk scores times x dt, causal half; the
  chunk's state and the C S term), as the benchmark's ``ssd_floor``
  counts them;
* the tied head where the port computes it: the last position of a
  prefill, every position of a training step.

A training step is three forwards (the backward twice the forward), the
recompute of ``remat`` not counted.
"""

from __future__ import annotations

from typing import Dict


def _mamba_dims(w: Dict):
    Din = w["ssm_expand"] * w["d_model"]
    H = Din // w["ssm_headdim"]
    return Din, H, w["ssm_state"], w["ssm_headdim"]


def mamba_proj_flops(w: Dict) -> float:
    """in_proj, the conv taps and out_proj of one block, one token."""
    D = w["d_model"]
    Din, H, N, _ = _mamba_dims(w)
    return 2.0 * D * (2 * Din + 2 * N + H) + 2.0 * w["ssm_conv_width"] * (Din + 2 * N) \
        + 2.0 * Din * D


def ssd_flops(w: Dict, batch: int, seq: int) -> float:
    """The chunked SSD scan of one block over ``batch`` rows of ``seq``."""
    _, H, N, P = _mamba_dims(w)
    Q = min(w["ssm_chunk"], seq)
    chunks = batch * (seq // Q)
    cb = chunks * Q * (Q + 1) * N
    per_head = Q * (Q + 1) * P + 2 * Q * N * P + 2 * Q * N * P
    return float(cb + chunks * H * per_head)


def head_flops(w: Dict) -> float:
    return 2.0 * w["d_model"] * w["vocab_size"]


def forward_flops(w: Dict, batch: int, seq: int, head_positions: int) -> float:
    """A forward over ``batch`` rows of ``seq`` tokens, the head at
    ``head_positions`` positions a row."""
    total = w["n_layers"] * (batch * seq * mamba_proj_flops(w) + ssd_flops(w, batch, seq))
    return total + batch * head_positions * head_flops(w)


def prefill_flops(w: Dict, batch: int, seq: int) -> float:
    return forward_flops(w, batch, seq, head_positions=1)


def train_flops(w: Dict, batch: int, seq: int) -> float:
    return 3 * forward_flops(w, batch, seq, head_positions=seq)
