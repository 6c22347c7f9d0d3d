"""gemma-7b [dense] — 28L d_model=3072 16H (MHA kv=16) head_dim=256,
GeGLU d_ff=24576, vocab=256000, tied embeddings.
[arXiv:2403.08295; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    activation="geglu",
    tie_embeddings=True,
)
