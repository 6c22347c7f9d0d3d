"""LLaVA-NeXT-style VLM backbone: prefill and decode. [llava-hf/llava-v1.6]

Port of the JAX package's ``models/vlm.py`` for serving.  The vision tower
and anyres tiling frontend is a stub there too: the caller gives
precomputed patch embeddings ``[B, n_patches, d_model]`` (post-projector).
The backbone is the dense decoder of ``models/transformer.py``: init,
cache and decode step are dense's, re-exported under the family's names.
Prefill puts the patch embeddings ahead of the token embeddings, over
positions ``0..Np + Lt - 1``; decoding reuses the dense KV-cache step
(the patch positions occupy the cache prefix), so every attention step
runs through the decode-attention kernel on the card.

Left for later slices: ``vlm_loss`` (training) and the sharding specs.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models.common import embed
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    _lm_head_w,
    dense_decode_step,
    dense_init_cache,
    forward_hidden_dense,
    init_dense_model,
)

Params = Dict[str, Any]

init_vlm_model = init_dense_model
vlm_decode_step = dense_decode_step
# the cache must hold the patch prefix + generated text
vlm_init_cache = dense_init_cache


def vlm_prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                patch_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Forward over ``patch_embeds [B, Np, D]`` (when given) followed by
    ``tokens [B, Lt]`` -> last-position logits [B, vocab] (f32)."""
    x = embed(params["embed"], tokens)
    if patch_embeds is not None:
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
    B, L = x.shape[:2]
    positions = torch.arange(L, device=x.device).expand(B, L)
    h = forward_hidden_dense(cfg, params, x, positions)
    return (h[:, -1] @ _lm_head_w(cfg, params)).float()
