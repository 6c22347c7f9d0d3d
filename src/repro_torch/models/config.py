"""Model configuration for the assigned architecture families.

One frozen dataclass covers dense / MoE / SSM / hybrid / enc-dec / VLM
backbones; family-specific fields are zero/None when unused.  Exact
configs for the ten assigned architectures live in ``repro_torch.configs``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # defaults to d_model // n_heads
    activation: str = "swiglu"  # swiglu | geglu
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # ---- MoE ----
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    moe_every: int = 1  # MoE layer every k-th block (llama4: 2)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_group_size: int = 4096  # GShard dispatch group size (tokens)

    # ---- SSM (Mamba2 / SSD) ----
    ssm_state: int = 0  # N
    ssm_headdim: int = 64  # P
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # ---- hybrid (zamba2): shared attention block every k mamba blocks ----
    hybrid_attn_every: int = 6

    # ---- enc-dec (whisper) ----
    n_encoder_layers: int = 0
    encoder_seq: int = 1500  # stub frame count

    # ---- VLM (llava) ----
    n_patches: int = 0  # prepended patch-embedding stub tokens

    # ---- numerics / compile ----
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"  # full | dots (save matmul outputs) | none
    # ---- perf knobs (EXPERIMENTS.md §Perf) ----
    parallel_block: bool = False  # PaLM-style attn+MLP in parallel: 1 TP
    #                               all-reduce per block instead of 2
    fsdp_all_axes: bool = False  # small models: pure DP/FSDP over every
    #                              mesh axis, no TP collectives at all
    kv_cache_quant: bool = False  # int8 KV cache (decode memory roofline)
    logits_chunk: int = 1024  # CE computed over seq chunks to bound memory
    attn_q_chunk: int = 512
    attn_k_chunk: int = 1024

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def reduced(self, **overrides) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        base = dict(
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            moe_d_ff=64 if self.n_experts else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=32 if self.ssm_state else 64,
            ssm_chunk=16,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            encoder_seq=32,
            n_patches=min(self.n_patches, 16),
            hybrid_attn_every=2,
            moe_group_size=64,
            logits_chunk=32,
            attn_q_chunk=16,
            attn_k_chunk=16,
            name=self.name + "-reduced",
        )
        base.update(overrides)
        return dataclasses.replace(self, **base)
