"""zamba2-2.7b [hybrid] — 54L d_model=2560, Mamba2 backbone +
SHARED attention block (32H, kv=32) every 6 blocks, ssm_state=64,
vocab=32000, d_ff=10240.  [arXiv:2411.15242; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=256,
    hybrid_attn_every=6,
    tie_embeddings=True,
)
