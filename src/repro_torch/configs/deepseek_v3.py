"""deepseek-v3 [deepseek_v3] — 61L d_model=7168: multi-head latent attention in every
layer (128 heads; q_lora 1536, kv_lora 512; q and k of 128 no-position + 64 rope dims,
values of 128; YaRN factor 40 over 4096 positions, beta 32 / 1, mscale 1), the first 3
layers a dense SwiGLU MLP of 18432, the other 58 MoE (256 SwiGLU experts of 2048, top-8,
sigmoid router with correction bias, 8 groups of which the best 4 are kept, scaling
2.5, one shared expert of 2048), vocab=129280, untied.  [arXiv:2412.19437;
deepseek-ai/DeepSeek-V3 config.json]

Port-only: found by ``repro_torch.configs.port_only``, not by the registry.  Every
expert is held here; the benchmark's configuration holds one card's share."""

from repro_torch.models.deepseek_v3 import DeepSeekV3Config

CONFIG = DeepSeekV3Config(
    name="deepseek-v3",
    family="deepseek_v3",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=192,
    d_ff=18432,
    vocab_size=129280,
    rope_theta=10000.0,
    norm_eps=1e-6,
    tie_embeddings=False,
    n_experts=256,
    experts_per_token=8,
    moe_d_ff=2048,
    first_k_dense=3,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    moe_shared_d_ff=2048,
    routed_scaling_factor=2.5,
    n_group=8,
    topk_group=4,
    expert_offset=0,
    n_experts_held=256,
    rope_factor=40.0,
    rope_original_max=4096,
    rope_beta_fast=32.0,
    rope_beta_slow=1.0,
    rope_mscale=1.0,
    rope_mscale_all_dim=1.0,
)
