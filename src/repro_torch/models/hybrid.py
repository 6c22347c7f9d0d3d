"""Zamba2-style hybrid: Mamba2 backbone + one SHARED attention block
applied every ``hybrid_attn_every`` mamba blocks. [arXiv:2411.15242]

Port of the JAX package's ``models/hybrid.py`` for serving.  The shared
block's weights are reused at every application site (Zamba's
parameter-sharing trick), but each site keeps its own KV cache
(``attn_k[g]``, ``attn_v[g]``).  The Mamba blocks stay stacked
``[groups, per_group, ...]``, as in JAX, so a JAX tree converts leaf for
leaf; where JAX scans the groups, the port loops over them, the shared
block at the head of each group.

Prefill and the training loss (:func:`hybrid_loss`) run each Mamba
block's SSD scan through the SSD-scan kernel and each site's attention
through ``flash_attention``; decode runs each site's attention through the
decode-attention kernel and the Mamba blocks by their recurrent update.
The loss runs each group (the shared block, then its Mamba blocks) under
``maybe_remat``, as the reference's scan body, the shared weights taking
every site's gradient.  The decode cache is written in place
(the Mamba states too), so every block owns its tensors: none is a
broadcast view of another.

:func:`hybrid_param_specs` and :func:`hybrid_cache_specs` are the
reference's sharding trees as data, keyed as the port's trees (see
``models/transformer.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.common import (
    chunked_softmax_xent,
    dtype_of,
    embed,
    init_embedding,
    init_rmsnorm,
    maybe_remat,
    rmsnorm,
)
from repro_torch.launch.mesh import AX_DATA, AX_MODEL
from repro_torch.launch.mesh import PartitionSpec as P
from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba2 import (
    init_mamba_block,
    mamba_block_apply,
    mamba_block_decode,
    mamba_init_state,
    ssm_param_specs,
)
from repro_torch.models.transformer import (
    _attn_specs,
    _layer,
    _layers,
    _mlp_specs,
    _stack,
    _stack_specs,
    dense_block_apply,
    dense_block_decode,
    init_dense_block,
    kv_cache_spec,
    replicate_specs,
)

Params = Dict[str, Any]


def _n_groups(cfg: ModelConfig) -> int:
    if cfg.n_layers % cfg.hybrid_attn_every:
        raise ValueError(f"{cfg.n_layers} layers are not whole groups of "
                         f"{cfg.hybrid_attn_every}")
    return cfg.n_layers // cfg.hybrid_attn_every


def init_hybrid_model(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Weights drawn from ``gen`` on its device, with the JAX package's
    scales; Mamba blocks stacked ``[groups, per_group, ...]``."""
    dtype = dtype_of(cfg.dtype)
    ng, per = _n_groups(cfg), cfg.hybrid_attn_every
    return {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype),
        "mamba_blocks": _stack([_stack([init_mamba_block(gen, cfg, dtype) for _ in range(per)])
                                for _ in range(ng)]),
        "shared_attn": init_dense_block(gen, cfg, dtype),  # ONE set of weights
        "final_norm": init_rmsnorm(cfg.d_model, gen.device),
    }


def _mamba(params: Params, g: int, i: int) -> Params:
    return _layer(_layer(params["mamba_blocks"], g), i)


def hybrid_loss(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token cross-entropy through the tied head."""
    tokens, labels = batch["tokens"], batch["labels"]
    B, L = tokens.shape
    x = embed(params["embed"], tokens)
    positions = torch.arange(L, device=tokens.device).expand(B, L)

    def group(shared, p_group, h):
        h = dense_block_apply(cfg, shared, h, positions)  # shared weights
        for pb in _layers(p_group):
            h = mamba_block_apply(cfg, pb, h)
        return h

    body = maybe_remat(group, cfg)
    for p_group in _layers(params["mamba_blocks"]):
        x = body(params["shared_attn"], p_group, x)
    h = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return chunked_softmax_xent(h, params["embed"]["emb"].T, labels, chunk=cfg.logits_chunk)


def hybrid_prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Forward over ``tokens [B, L]`` -> last-position logits [B, vocab] (f32).
    The final norm is per position, so only the last one is normed."""
    B, L = tokens.shape
    h = embed(params["embed"], tokens)
    positions = torch.arange(L, device=tokens.device).expand(B, L)
    shared = params["shared_attn"]
    for g in range(_n_groups(cfg)):
        h = dense_block_apply(cfg, shared, h, positions)  # shared weights
        for i in range(cfg.hybrid_attn_every):
            h = mamba_block_apply(cfg, _mamba(params, g, i), h)
    h = rmsnorm(params["final_norm"], h[:, -1], cfg.norm_eps)
    return (h @ params["embed"]["emb"].T).float()


def hybrid_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device: torch.device) -> Params:
    """A KV cache per attention site ``[groups, B, max_len, Hkv, Dh]`` and a
    Mamba state per block ``[groups, per_group, ...]``, each its own memory."""
    ng, per = _n_groups(cfg), cfg.hybrid_attn_every
    shape = (ng, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    dt = dtype_of(cfg.dtype)
    m = mamba_init_state(cfg, batch, device)
    return {
        "attn_k": torch.zeros(shape, dtype=dt, device=device),
        "attn_v": torch.zeros(shape, dtype=dt, device=device),
        **{k: v[None, None].repeat((ng, per) + (1,) * v.dim()) for k, v in m.items()},
    }


def hybrid_decode_step(
    cfg: ModelConfig,
    params: Params,
    token: torch.Tensor,  # [B] int
    cache: Params,
    pos: int,
) -> Tuple[torch.Tensor, Params]:
    """One step: next-token logits (f32) and the cache, its KV caches and
    Mamba states overwritten in place.  The decode kernel's ``valid_len``
    is made once here for all attention sites."""
    B = token.shape[0]
    x1 = embed(params["embed"], token)[:, None, :]
    shared = params["shared_attn"]
    valid_len = torch.full((B,), pos + 1, dtype=torch.int32, device=token.device)
    for g in range(_n_groups(cfg)):
        x1, _, _ = dense_block_decode(cfg, shared, x1, cache["attn_k"][g], cache["attn_v"][g],
                                      pos, valid_len)
        for i in range(cfg.hybrid_attn_every):
            x1, new = mamba_block_decode(cfg, _mamba(params, g, i), x1,
                                         {"conv": cache["conv"][g, i], "ssm": cache["ssm"][g, i]})
            cache["conv"][g, i].copy_(new["conv"])
            cache["ssm"][g, i].copy_(new["ssm"])
    h = rmsnorm(params["final_norm"], x1, cfg.norm_eps)
    logits = (h[:, 0, :] @ params["embed"]["emb"].T).float()
    return logits, cache


# --------------------------------------------------------------- shardings --


def hybrid_param_specs(cfg: ModelConfig, mode: str = "train") -> Params:
    mamba_block = ssm_param_specs(cfg, mode)["blocks"]  # stacked once
    specs = _hybrid_specs_inner(cfg, mamba_block)
    if cfg.fsdp_all_axes and mode == "train":
        return replicate_specs(specs)
    return specs


def _hybrid_specs_inner(cfg: ModelConfig, mamba_block) -> Params:
    return {
        "embed": {"emb": P(AX_MODEL, AX_DATA)},
        "mamba_blocks": _stack_specs(mamba_block),
        "shared_attn": {
            "attn_norm": {"scale": P(None)},
            "attn": _attn_specs(),
            "mlp_norm": {"scale": P(None)},
            "mlp": _mlp_specs(),
        },
        "final_norm": {"scale": P(None)},
    }


def hybrid_cache_specs(cfg: ModelConfig, seq_shard: bool = False) -> Params:
    attn = kv_cache_spec(cfg, seq_shard)
    bdim = None if seq_shard else AX_DATA
    return {
        "attn_k": attn,
        "attn_v": attn,
        "conv": P(None, None, bdim, None, AX_MODEL),
        "ssm": P(None, None, bdim, AX_MODEL, None, None),
    }
