"""zamba2-7b [zamba2] — 81L d_model=3584, Mamba2 (112 heads of 64, state 64,
2 B/C groups) with 13 hybrid layers over 2 alternating shared attention+MLP
blocks (32H of 224 over 2 d_model, gelu d_ff=14336, adapters of rank 128),
vocab=32000, tied.  [arXiv:2411.15242; Zyphra/Zamba2-7B-Instruct config.json]

Port-only: found by ``repro_torch.configs.port_only``, not by the registry."""

from repro_torch.models.zamba2 import Zamba2Config

CONFIG = Zamba2Config(
    name="zamba2-7b",
    family="zamba2",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=224,
    d_ff=14336,
    vocab_size=32000,
    activation="gelu",
    rope_theta=1e4,
    norm_eps=1e-5,
    tie_embeddings=True,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=256,
    ssm_conv_width=4,
    ssm_ngroups=2,
    hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    num_mem_blocks=2,
    adapter_rank=128,
)
