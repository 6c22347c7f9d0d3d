"""Analytic roofline terms per (arch x shape x mesh).

Why this exists: XLA's ``compiled.cost_analysis()`` counts a ``scan``
body ONCE instead of multiplying by the trip count (verified in
tests/test_roofline.py), so for depth-scanned models the raw dry-run
FLOPs under-report by ~n_layers.  The dry-run numbers are still recorded
raw; this module supplies the corrected terms from exact closed-form
counts of the math the model performs — validated against published
parameter totals (400B / 235B / 1.3B / ...) and against cost_analysis on
small UNROLLED configs where XLA counts are exact.

Torch port: a copy of the JAX package's ``launch/analytics.py`` whose
hardware constants describe the NVIDIA H100 SXM (NVIDIA, "H100 Tensor
Core GPU" data sheet): 989 TFLOP/s dense bf16 a card, 3.35 TB/s HBM3 a
card, and NVLink 4 at 25 GB/s a link in each direction (18 links a
card).  The counting functions are the reference's, unchanged.  The
port's dry run (``repro_torch.launch.dryrun``) counts FLOPs with
``torch.utils.flop_counter.FlopCounterMode``, which sees every layer of
the port's Python loop, so there the closed-form count is checked
against an exact one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.models.config import ModelConfig
from repro_torch.models.model_api import SHAPES, ShapeSpec

# H100 SXM, NVIDIA "H100 Tensor Core GPU" data sheet
PEAK_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12  # HBM3 bytes/s per card
ICI_BW = 25e9  # NVLink 4 bytes/s per link, each direction (50 GB/s both ways)

BYTES = {"bfloat16": 2, "float32": 4}


# ------------------------------------------------------------- parameters ---


def attn_params(cfg: ModelConfig) -> int:
    dh = cfg.resolved_head_dim
    return cfg.d_model * cfg.n_heads * dh + 2 * cfg.d_model * cfg.n_kv_heads * dh + cfg.n_heads * dh * cfg.d_model


def dense_block_params(cfg: ModelConfig) -> int:
    return attn_params(cfg) + 3 * cfg.d_model * cfg.d_ff + 2 * cfg.d_model


def moe_block_params(cfg: ModelConfig) -> int:
    return (
        attn_params(cfg)
        + cfg.d_model * cfg.n_experts
        + cfg.n_experts * 3 * cfg.d_model * cfg.moe_d_ff
        + 2 * cfg.d_model
    )


def mamba_block_params(cfg: ModelConfig) -> int:
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    d_in = 2 * di + 2 * N + H
    return cfg.d_model * d_in + cfg.ssm_conv_width * (di + 2 * N) + di * cfg.d_model + 3 * H + di + cfg.d_model


def whisper_enc_block_params(cfg: ModelConfig) -> int:
    return attn_params(cfg) + 2 * cfg.d_model * cfg.d_ff + 2 * cfg.d_model


def whisper_dec_block_params(cfg: ModelConfig) -> int:
    return 2 * attn_params(cfg) + 2 * cfg.d_model * cfg.d_ff + 3 * cfg.d_model


def total_params(cfg: ModelConfig) -> int:
    emb = cfg.vocab_size * cfg.d_model
    head = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model
    f = cfg.family
    if f in ("dense", "vlm"):
        return emb + head + cfg.n_layers * dense_block_params(cfg)
    if f == "moe":
        n_moe = cfg.n_layers // cfg.moe_every
        n_dense = cfg.n_layers - n_moe
        return emb + head + n_moe * moe_block_params(cfg) + n_dense * dense_block_params(cfg)
    if f == "ssm":
        return emb + head + cfg.n_layers * mamba_block_params(cfg)
    if f == "hybrid":
        return emb + head + cfg.n_layers * mamba_block_params(cfg) + dense_block_params(cfg)
    if f == "encdec":
        return emb + head + cfg.n_encoder_layers * whisper_enc_block_params(cfg) + cfg.n_layers * whisper_dec_block_params(cfg)
    raise ValueError(f)


def active_params(cfg: ModelConfig) -> int:
    """Per-token active parameters (MoE: top-k experts only)."""
    if cfg.family != "moe":
        return total_params(cfg)
    n_moe = cfg.n_layers // cfg.moe_every
    n_dense = cfg.n_layers - n_moe
    moe_active = (
        attn_params(cfg)
        + cfg.d_model * cfg.n_experts  # router
        + cfg.experts_per_token * 3 * cfg.d_model * cfg.moe_d_ff
        + 2 * cfg.d_model
    )
    emb = cfg.vocab_size * cfg.d_model
    head = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model
    return emb + head + n_moe * moe_active + n_dense * dense_block_params(cfg)


def matmul_params(cfg: ModelConfig, active: bool = True) -> int:
    """Parameters that participate in per-token matmuls (excludes the
    embedding GATHER but includes the LM head projection)."""
    p = (active_params(cfg) if active else total_params(cfg))
    # embedding gather is not a matmul; LM head is. Tied embeddings still
    # do the head matmul.
    p -= cfg.vocab_size * cfg.d_model  # remove gather-side table
    if cfg.tie_embeddings:
        p += cfg.vocab_size * cfg.d_model  # head matmul still happens
    return p


# ------------------------------------------------------------------ flops ---


def attn_flops_fwd(cfg: ModelConfig, B: int, L: int, n_attn_layers: int) -> float:
    """Computed attention score+value FLOPs (full L^2 tiles; our flash
    computes masked tiles too)."""
    dh = cfg.resolved_head_dim
    return 4.0 * B * L * L * cfg.n_heads * dh * n_attn_layers


def _n_attn_layers(cfg: ModelConfig) -> int:
    f = cfg.family
    if f in ("dense", "vlm", "moe"):
        return cfg.n_layers
    if f == "ssm":
        return 0
    if f == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_every
    if f == "encdec":
        return cfg.n_encoder_layers + 2 * cfg.n_layers  # self + cross
    raise ValueError(f)


def ssd_flops_fwd(cfg: ModelConfig, B: int, L: int) -> float:
    """Chunked SSD: intra-chunk quadratic + state terms per mamba block."""
    if cfg.family not in ("ssm", "hybrid"):
        return 0.0
    Q = cfg.ssm_chunk
    H, P, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    di = cfg.d_inner
    per_block = (
        2.0 * B * L * Q * N  # C.B^T within chunks
        + 2.0 * B * L * Q * H * P  # M @ x
        + 4.0 * B * L * N * di  # state build + state read
    )
    return per_block * cfg.n_layers


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, float]:
    """Returns useful (6ND / 2ND) and computed (incl. attention + remat)
    global FLOPs for this cell."""
    B, L = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = B * L
        mm = 2.0 * matmul_params(cfg, active=True) * tokens  # fwd
        attn = attn_flops_fwd(cfg, B, L, _n_attn_layers(cfg)) + ssd_flops_fwd(cfg, B, L)
        if cfg.family == "encdec":
            tokens_enc = B * cfg.encoder_seq
            mm += 2.0 * whisper_enc_block_params(cfg) * cfg.n_encoder_layers * tokens_enc
        fwd = mm + attn
        # bwd = 2x fwd; remat recomputes fwd once inside bwd
        computed = fwd * (3.0 + (1.0 if cfg.remat else 0.0))
        useful = 6.0 * active_params(cfg) * tokens
        return {"useful": useful, "computed": computed}
    if shape.kind == "prefill":
        tokens = B * L
        fwd = 2.0 * matmul_params(cfg, active=True) * tokens + attn_flops_fwd(
            cfg, B, L, _n_attn_layers(cfg)
        ) + ssd_flops_fwd(cfg, B, L)
        return {"useful": 2.0 * active_params(cfg) * tokens, "computed": fwd}
    # decode: one token per sequence
    dh = cfg.resolved_head_dim
    mm = 2.0 * matmul_params(cfg, active=True) * B
    attn = 4.0 * B * L * cfg.n_heads * dh * _n_attn_layers(cfg)
    if cfg.family in ("ssm", "hybrid"):
        H, Pd, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
        attn += 4.0 * B * H * Pd * N * cfg.n_layers
        if cfg.family == "ssm":
            attn = 4.0 * B * H * Pd * N * cfg.n_layers  # no KV attention at all
    return {"useful": 2.0 * active_params(cfg) * B, "computed": mm + attn}


# ------------------------------------------------------------------ bytes ---


def cache_bytes(cfg: ModelConfig, shape: ShapeSpec) -> float:
    B, L = shape.global_batch, shape.seq_len
    dh = cfg.resolved_head_dim
    bt = 1 if cfg.kv_cache_quant else BYTES[cfg.dtype]
    f = cfg.family
    if f in ("dense", "vlm", "moe"):
        return 2.0 * cfg.n_layers * B * L * cfg.n_kv_heads * dh * bt
    if f == "ssm":
        st = cfg.n_layers * B * cfg.ssm_nheads * cfg.ssm_state * cfg.ssm_headdim * 4
        conv = cfg.n_layers * B * (cfg.ssm_conv_width - 1) * (cfg.d_inner + 2 * cfg.ssm_state) * bt
        return st + conv
    if f == "hybrid":
        n_sites = cfg.n_layers // cfg.hybrid_attn_every
        kv = 2.0 * n_sites * B * L * cfg.n_kv_heads * dh * bt
        st = cfg.n_layers * B * cfg.ssm_nheads * cfg.ssm_state * cfg.ssm_headdim * 4
        return kv + st
    if f == "encdec":
        self_kv = 2.0 * cfg.n_layers * B * L * cfg.n_kv_heads * dh * bt
        cross_kv = 2.0 * cfg.n_layers * B * cfg.encoder_seq * cfg.n_kv_heads * dh * bt
        return self_kv + cross_kv
    raise ValueError(f)


def hbm_bytes(cfg: ModelConfig, shape: ShapeSpec, n_dev: int = 256, tp: int = 16) -> float:
    """GLOBAL HBM traffic estimate for one step (divide by n_dev for the
    per-chip roofline term).

    Key subtlety: FSDP reduces *storage*, not HBM streaming — each device
    still streams its TP slice of every layer (P/tp per pass).  The
    ZeRO-1 profile (tp_eff = 1) streams full weights per device but cuts
    per-device activation traffic by tp x."""
    bt = BYTES[cfg.dtype]
    P_all = total_params(cfg)
    B, L = shape.global_batch, shape.seq_len
    tp_eff = 1 if cfg.fsdp_all_axes else tp
    dp = n_dev if cfg.fsdp_all_axes else n_dev // tp
    if shape.kind == "train":
        tokens_dev = B * L / max(1, dp)
        per_dev = (
            3.0 * P_all * bt / tp_eff  # weight stream: fwd + remat + bwd
            + 16.0 * P_all / n_dev  # f32 m/v read+write (sharded)
            + 3.0 * cfg.n_layers * tokens_dev * cfg.d_model * bt  # acts
        )
        return per_dev * n_dev
    if shape.kind == "prefill":
        tokens_dev = B * L / max(1, dp)
        per_dev = P_all * bt / tp_eff + 2.0 * cfg.n_layers * tokens_dev * cfg.d_model * bt
        return per_dev * n_dev
    # decode: weights (sharded over the full mesh in serve mode) + cache
    return active_params(cfg) * BYTES[cfg.dtype] + cache_bytes(cfg, shape)


# ------------------------------------------------------------ collectives ---


def expert_params(cfg: ModelConfig) -> int:
    if cfg.family != "moe":
        return 0
    n_moe = cfg.n_layers // cfg.moe_every
    return n_moe * cfg.n_experts * 3 * cfg.d_model * cfg.moe_d_ff


def collective_bytes_est(cfg: ModelConfig, shape: ShapeSpec, n_dev: int, tp: int = 16) -> float:
    """Per-device collective bytes per step under the IMPLEMENTED
    sharding strategy (validated against the dry-run HLO parse,
    EXPERIMENTS.md §Perf):

    * dense train: FSDP all-gather (fwd + remat-bwd) + grad
      reduce-scatter over data, plus TP all-reduces of activations per
      block (1 with ``parallel_block``, else 2).
    * moe train: experts are a2a expert-parallel (E->data, F->model) —
      weights never move; FSDP applies only to non-expert params; each
      MoE layer adds 2 token-sized a2a (fwd; 2 more bwd) + 1 expert-out
      TP all-reduce.
    * ``fsdp_all_axes`` (ZeRO-1): one grad all-reduce + updated-param
      all-gather, nothing per-layer.
    Ring collectives: wire bytes per device ~= 2(n-1)/n (AR) or
    (n-1)/n (AG/RS) x payload.
    """
    bt = BYTES[cfg.dtype]
    B, L = shape.global_batch, shape.seq_len
    dp = n_dev // tp
    P_all = total_params(cfg)
    f = cfg.family
    n_blocks = cfg.n_layers
    ar_per_block = 1 if cfg.parallel_block else 2
    out = 0.0
    if shape.kind == "train":
        if cfg.fsdp_all_axes:  # ZeRO-1
            # grad all-reduce over all devices + new-param all-gather
            out += 2.0 * (n_dev - 1) / n_dev * P_all * bt
            out += (n_dev - 1) / n_dev * P_all * bt
            return out
        tokens_dev = B * L / max(1, dp)
        P_fsdp = P_all - expert_params(cfg)
        shard = P_fsdp * bt / n_dev
        out += (2 + 1) * shard * (dp - 1)
        out += ar_per_block * n_blocks * tokens_dev * cfg.d_model * bt * 2 * (tp - 1) / tp
        if f == "moe":
            n_moe = cfg.n_layers // cfg.moe_every
            # dispatched volume scales with top-k (each token occupies k
            # expert-capacity slots)
            a2a = tokens_dev * cfg.d_model * bt * cfg.capacity_factor * cfg.experts_per_token
            # 2 a2a fwd + 2 bwd, + expert-out AR over model (fwd+bwd)
            out += n_moe * (4 * a2a + 2 * a2a * 2 * (tp - 1) / tp)
        return out
    tokens_dev = B * L / max(1, dp)
    if shape.kind == "prefill":
        out += (ar_per_block / 2 if cfg.parallel_block else 1) * 2 * n_blocks * tokens_dev * cfg.d_model * bt * (tp - 1) / tp
        if f == "moe":
            n_moe = cfg.n_layers // cfg.moe_every
            a2a = tokens_dev * cfg.d_model * bt * cfg.capacity_factor * cfg.experts_per_token
            out += n_moe * (2 * a2a + a2a * 2 * (tp - 1) / tp)
        return out
    # decode
    b_dev = max(1.0, B / max(1, dp))
    out += 2 * n_blocks * b_dev * cfg.d_model * bt * (tp - 1) / tp
    if f == "moe":
        n_moe = cfg.n_layers // cfg.moe_every
        out += n_moe * 3 * b_dev * cfg.d_model * bt
    return out


# ---------------------------------------------------------------- roofline --


@dataclasses.dataclass(frozen=True)
class Roofline:
    arch: str
    shape: str
    n_dev: int
    compute_s: float
    memory_s: float
    collective_s: float
    useful_flops: float
    computed_flops: float

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s, "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        return self.useful_flops / max(self.computed_flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Useful FLOP throughput achieved / peak, at the modeled step time
        (== MFU when compute-bound with zero waste)."""
        return self.useful_flops / (self.step_s * self.n_dev * PEAK_FLOPS)


def roofline(cfg: ModelConfig, shape_name: str, n_dev: int = 256, tp: int = 16) -> Roofline:
    shape = SHAPES[shape_name]
    fl = model_flops(cfg, shape)
    mem = hbm_bytes(cfg, shape, n_dev, tp)
    coll = collective_bytes_est(cfg, shape, n_dev, tp)
    return Roofline(
        arch=cfg.name,
        shape=shape_name,
        n_dev=n_dev,
        compute_s=fl["computed"] / (n_dev * PEAK_FLOPS),
        memory_s=mem / (n_dev * HBM_BW),
        collective_s=coll / ICI_BW,
        useful_flops=fl["useful"],
        computed_flops=fl["computed"],
    )
