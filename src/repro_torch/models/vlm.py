"""LLaVA-NeXT-style VLM backbone: prefill, decode and the loss. [llava-hf/llava-v1.6]

Port of the JAX package's ``models/vlm.py``.  The vision tower
and anyres tiling frontend is a stub there too: the caller gives
precomputed patch embeddings ``[B, n_patches, d_model]`` (post-projector).
The backbone is the dense decoder of ``models/transformer.py``: init,
cache and decode step are dense's, re-exported under the family's names.
Prefill puts the patch embeddings ahead of the token embeddings, over
positions ``0..Np + Lt - 1``; decoding reuses the dense KV-cache step
(the patch positions occupy the cache prefix), so every attention step
runs through the decode-attention kernel on the card.  Training
(:func:`vlm_loss`) prepends the patch embeddings the same way and masks
the loss to the text positions.

The sharding trees are dense's too (``vlm_param_specs``,
``vlm_cache_specs``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models.common import chunked_softmax_xent, embed
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    _lm_head_w,
    dense_cache_specs,
    dense_decode_step,
    dense_init_cache,
    dense_param_specs,
    forward_hidden_dense,
    init_dense_model,
)

Params = Dict[str, Any]

init_vlm_model = init_dense_model
vlm_param_specs = dense_param_specs
vlm_decode_step = dense_decode_step
vlm_cache_specs = dense_cache_specs
# the cache must hold the patch prefix + generated text
vlm_init_cache = dense_init_cache


def vlm_loss(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """batch: patch_embeds [B, Np, D], tokens [B, Lt], labels [B, Lt]."""
    patches, tokens, labels = batch["patch_embeds"], batch["tokens"], batch["labels"]
    B, Np, _ = patches.shape
    x_text = embed(params["embed"], tokens)
    x = torch.cat([patches.to(x_text.dtype), x_text], dim=1)
    L = x.shape[1]
    positions = torch.arange(L, device=x.device).expand(B, L)
    h = forward_hidden_dense(cfg, params, x, positions)
    # loss on text positions only
    return chunked_softmax_xent(h[:, Np:, :], _lm_head_w(cfg, params), labels,
                                chunk=cfg.logits_chunk)


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
