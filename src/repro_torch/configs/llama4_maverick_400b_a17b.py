"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1, interleaved MoE every 2nd
block (the public Llama-4 interleave; yields ~400B total / ~17B active).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,          # dense-block FFN width
    vocab_size=202048,
    n_experts=128,
    experts_per_token=1,
    moe_d_ff=8192,
    moe_every=2,
    rope_theta=5e5,
)
