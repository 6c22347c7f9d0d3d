"""whisper-base [audio] — enc-dec, 6L encoder + 6L decoder, d_model=512
8H (kv=8) d_ff=2048 vocab=51865; conv frontend STUB (input_specs provides
precomputed frame embeddings).  [arXiv:2212.04356; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    n_encoder_layers=6,
    encoder_seq=1500,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    tie_embeddings=True,
)
