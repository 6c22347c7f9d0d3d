"""nemotron-3-nano-30b-a3b [nemotron_h] — 52L d_model=2688 by the pattern
MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME: 23 Mamba-2 layers (64
heads of 64, so d_inner 4096; state 128, 8 B/C groups, conv 4, chunk 128), 23
MoE layers (128 relu² experts of 1856, top-6, sigmoid router with correction
bias, scaling 2.5, one shared relu² expert of 3712) and 6 NoPE GQA layers (32
query heads over 2 KV heads of 128), vocab=131072, untied.  [arXiv:2504.03624;
nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16 config.json]

Port-only: found by ``repro_torch.configs.port_only``, not by the registry."""

from repro_torch.models.nemotron_h import NemotronHConfig

CONFIG = NemotronHConfig(
    name="nemotron-3-nano-30b-a3b",
    family="nemotron_h",
    n_layers=52,
    d_model=2688,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=0,
    vocab_size=131072,
    norm_eps=1e-5,
    tie_embeddings=False,
    n_experts=128,
    experts_per_token=6,
    moe_d_ff=1856,
    ssm_state=128,
    ssm_headdim=64,
    ssm_chunk=128,
    ssm_conv_width=4,
    layer_pattern="MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME",
    mamba_num_heads=64,
    ssm_ngroups=8,
    moe_shared_d_ff=3712,
    routed_scaling_factor=2.5,
)
