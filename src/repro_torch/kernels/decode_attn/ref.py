"""Oracle for the GQA decode-attention kernel (single-token query
against a KV cache) — re-exports the model-level implementation."""

from repro_torch.models.common import decode_attention

__all__ = ["decode_attention"]
