"""Dense decoder-only transformer (llama / qwen / gemma / mistral families).

Port of the JAX package's ``models/transformer.py``: the forward over a
whole sequence (``flash_attention``), the training loss
(:func:`dense_loss`) and one decode step (the decode-attention kernel).
Layers stay *stacked* along a leading ``n_layers`` axis, as in JAX, so a
JAX parameter tree converts leaf for leaf (``convert.params_from_numpy``);
where JAX scans the stack, the port loops over its layers (each stacked
leaf unbound once, :func:`_layers`), the layer's body under
``maybe_remat`` as the reference's scan body is.  The hybrid family
reuses the dense block (``dense_block_apply``, ``dense_block_decode``) as
its shared attention block.

The ``*_specs`` functions are the reference's sharding trees as data
(``repro_torch.launch.mesh.PartitionSpec`` leaves over the logical axes
``AX_DATA`` / ``AX_MODEL``), keyed as the port's parameter and cache
trees: the dry run fits them to the production layouts to count
per-device bytes; one card shards nothing.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels.decode_attn.ops import gqa_decode_attention
from repro_torch.launch.mesh import AX_DATA, AX_MODEL
from repro_torch.launch.mesh import PartitionSpec as P
from repro_torch.models.common import (
    apply_rope,
    chunked_softmax_xent,
    dtype_of,
    embed,
    flash_attention,
    glu_activation,
    init_embedding,
    init_linear,
    init_rmsnorm,
    linear,
    maybe_remat,
    rmsnorm,
)
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_map

Params = Dict[str, Any]


# ----------------------------------------------------------------- blocks ---


def init_attn(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> Params:
    dh = cfg.resolved_head_dim
    return {
        "wq": init_linear(gen, cfg.d_model, cfg.n_heads * dh, dtype),
        "wk": init_linear(gen, cfg.d_model, cfg.n_kv_heads * dh, dtype),
        "wv": init_linear(gen, cfg.d_model, cfg.n_kv_heads * dh, dtype),
        "wo": init_linear(gen, cfg.n_heads * dh, cfg.d_model, dtype,
                          scale=0.02 / max(1, 2 * cfg.n_layers) ** 0.5),
    }


def init_mlp(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             d_ff: Optional[int] = None) -> Params:
    d_ff = d_ff or cfg.d_ff
    return {
        "w_gate": init_linear(gen, cfg.d_model, d_ff, dtype),
        "w_up": init_linear(gen, cfg.d_model, d_ff, dtype),
        "w_down": init_linear(gen, d_ff, cfg.d_model, dtype,
                              scale=0.02 / max(1, 2 * cfg.n_layers) ** 0.5),
    }


def init_dense_block(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> Params:
    return {
        "attn_norm": init_rmsnorm(cfg.d_model, gen.device),
        "attn": init_attn(gen, cfg, dtype),
        "mlp_norm": init_rmsnorm(cfg.d_model, gen.device),
        "mlp": init_mlp(gen, cfg, dtype),
    }


def attn_apply_train(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """Causal self-attention over a whole sequence, x: [B, L, D]."""
    B, L, D = x.shape
    dh = cfg.resolved_head_dim
    q = linear(p["wq"], x).reshape(B, L, cfg.n_heads, dh)
    k = linear(p["wk"], x).reshape(B, L, cfg.n_kv_heads, dh)
    v = linear(p["wv"], x).reshape(B, L, cfg.n_kv_heads, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=True, q_chunk=cfg.attn_q_chunk, k_chunk=cfg.attn_k_chunk)
    return linear(p["wo"], o.reshape(B, L, cfg.n_heads * dh))


def mlp_apply(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    a = linear(p["w_gate"], x)
    b = linear(p["w_up"], x)
    return linear(p["w_down"], glu_activation(cfg.activation, a, b))


def dense_block_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
    if cfg.parallel_block:
        # PaLM-style parallel formulation: both branches read the same input
        a = attn_apply_train(cfg, p["attn"], rmsnorm(p["attn_norm"], x, cfg.norm_eps), positions)
        m = mlp_apply(cfg, p["mlp"], rmsnorm(p["mlp_norm"], x, cfg.norm_eps))
        return x + a + m
    x = x + attn_apply_train(cfg, p["attn"], rmsnorm(p["attn_norm"], x, cfg.norm_eps), positions)
    x = x + mlp_apply(cfg, p["mlp"], rmsnorm(p["mlp_norm"], x, cfg.norm_eps))
    return x


# -------------------------------------------------------- decode (1 token) --


KV_QUANT_SCALE = 32.0  # int8 KV cache: symmetric, fixed scale


def _kv_quant(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.float() * KV_QUANT_SCALE), -127, 127).to(torch.int8)


def _kv_dequant(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (x.float() * (1.0 / KV_QUANT_SCALE)).to(dtype)


def attn_apply_decode(
    cfg: ModelConfig,
    p: Params,
    x1: torch.Tensor,  # [B, 1, D]
    cache_k: torch.Tensor,  # [B, Lmax, Hkv, Dh]
    cache_v: torch.Tensor,
    pos: int,
    valid_len: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token's attention at ``pos``; returns ``(out, cache_k, cache_v)``.

    The new key and value are written into the caches *in place* at
    ``pos`` (JAX's ``dynamic_update_slice`` returns new caches; the
    returned caches here are the tensors passed in).  Attention goes
    through ``kernels.decode_attn.ops.gqa_decode_attention``, where the
    JAX model calls ``models.common.decode_attention``: the same
    function (the JAX package wraps its Pallas kernel for exactly this
    call site but never wired it into the model).  ``valid_len`` is the
    kernel's ``[B]`` ``pos + 1`` (see the wrapper)."""
    B = x1.shape[0]
    dh = cfg.resolved_head_dim
    q = linear(p["wq"], x1).reshape(B, 1, cfg.n_heads, dh)
    k = linear(p["wk"], x1).reshape(B, 1, cfg.n_kv_heads, dh)
    v = linear(p["wv"], x1).reshape(B, 1, cfg.n_kv_heads, dh)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x1.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.kv_cache_quant:
        # int8 cache: 1 byte per element in the cache, dequantised for attention
        cache_k[:, pos] = _kv_quant(k[:, 0])
        cache_v[:, pos] = _kv_quant(v[:, 0])
        dt = x1.dtype
        o = gqa_decode_attention(q, _kv_dequant(cache_k, dt), _kv_dequant(cache_v, dt),
                                 pos, valid_len)
    else:
        cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
        cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
        o = gqa_decode_attention(q, cache_k, cache_v, pos, valid_len)
    return linear(p["wo"], o.reshape(B, 1, cfg.n_heads * dh)), cache_k, cache_v


def dense_block_decode(cfg, p, x1, cache_k, cache_v, pos, valid_len=None):
    a, ck, cv = attn_apply_decode(cfg, p["attn"], rmsnorm(p["attn_norm"], x1, cfg.norm_eps),
                                  cache_k, cache_v, pos, valid_len)
    x1 = x1 + a
    x1 = x1 + mlp_apply(cfg, p["mlp"], rmsnorm(p["mlp_norm"], x1, cfg.norm_eps))
    return x1, ck, cv


# ------------------------------------------------------------- full model ---


def _stack(trees):
    """Stack a list of equal-structure param trees along a new leading axis
    (one tree: a view of its own leaves, so a model cut to one layer or
    group holds its weights once, not twice, while they are stacked)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return first.unsqueeze(0) if len(trees) == 1 else torch.stack(trees)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked param tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _layers(tree):
    """Every layer of a stacked param tree, in order (views, no copy).

    Each stacked leaf is unbound once, so that a backward stacks its
    layers' gradients once (``unbind``'s backward); indexing the leaf layer
    by layer (:func:`_layer`) would make each layer's backward allocate a
    gradient of the whole stacked leaf."""
    if isinstance(tree, dict):
        per = {k: _layers(v) for k, v in tree.items()}
        n = len(next(iter(per.values())))
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return torch.unbind(tree)


def init_dense_model(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Weights drawn from ``gen`` on its device, with the JAX package's
    scales; blocks stacked ``[n_layers, ...]``."""
    dtype = dtype_of(cfg.dtype)
    params = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype),
        "blocks": _stack([init_dense_block(gen, cfg, dtype) for _ in range(cfg.n_layers)]),
        "final_norm": init_rmsnorm(cfg.d_model, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab_size, dtype)
    return params


def _lm_head_w(cfg: ModelConfig, params: Params) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"]["emb"].T
    return params["lm_head"]["w"]


def forward_hidden_dense(cfg: ModelConfig, params: Params, x: torch.Tensor,
                         positions: torch.Tensor) -> torch.Tensor:
    """Embedding-space input [B, L, D] -> final hidden states, layer by layer."""
    body = maybe_remat(lambda p, h: dense_block_apply(cfg, p, h, positions), cfg)
    for p in _layers(params["blocks"]):
        x = body(p, x)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def dense_loss(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` ([B, L] each)."""
    tokens, labels = batch["tokens"], batch["labels"]
    B, L = tokens.shape
    x = embed(params["embed"], tokens)
    positions = torch.arange(L, device=tokens.device).expand(B, L)
    h = forward_hidden_dense(cfg, params, x, positions)
    return chunked_softmax_xent(h, _lm_head_w(cfg, params), labels, chunk=cfg.logits_chunk)


def dense_prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Forward over ``tokens [B, L]`` -> last-position logits [B, vocab] (f32)."""
    B, L = tokens.shape
    x = embed(params["embed"], tokens)
    positions = torch.arange(L, device=tokens.device).expand(B, L)
    h = forward_hidden_dense(cfg, params, x, positions)
    return (h[:, -1] @ _lm_head_w(cfg, params)).float()


def dense_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                     device: torch.device) -> Params:
    dh = cfg.resolved_head_dim
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, dh)
    dt = torch.int8 if cfg.kv_cache_quant else dtype_of(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def dense_decode_step(
    cfg: ModelConfig,
    params: Params,
    token: torch.Tensor,  # [B] int — current token ids
    cache: Params,
    pos: int,
) -> Tuple[torch.Tensor, Params]:
    """One serving step: consume ``token`` at ``pos``, return next-token
    logits (f32) and the cache, updated in place.  ``pos`` is a Python
    int, so no layer waits on the device for it; the kernel's
    ``valid_len`` is made once here for all layers."""
    B = token.shape[0]
    x1 = embed(params["embed"], token)[:, None, :]  # [B,1,D]
    valid_len = torch.full((B,), pos + 1, dtype=torch.int32, device=token.device)
    for i in range(cfg.n_layers):
        x1, _, _ = dense_block_decode(cfg, _layer(params["blocks"], i), x1,
                                      cache["k"][i], cache["v"][i], pos, valid_len)
    h = rmsnorm(params["final_norm"], x1, cfg.norm_eps)
    logits = (h[:, 0, :] @ _lm_head_w(cfg, params)).float()
    return logits, cache


# --------------------------------------------------------------- shardings --


def _attn_specs() -> Params:
    return {
        "wq": {"w": P(AX_DATA, AX_MODEL)},
        "wk": {"w": P(AX_DATA, AX_MODEL)},
        "wv": {"w": P(AX_DATA, AX_MODEL)},
        "wo": {"w": P(AX_MODEL, AX_DATA)},
    }


def _mlp_specs() -> Params:
    return {
        "w_gate": {"w": P(AX_DATA, AX_MODEL)},
        "w_up": {"w": P(AX_DATA, AX_MODEL)},
        "w_down": {"w": P(AX_MODEL, AX_DATA)},
    }


def _stack_specs(tree: Params) -> Params:
    """Prepend the stacked layer axis (unsharded) to every leaf spec (the
    reference's ``_stack``; :func:`_stack` here stacks tensors)."""
    return tree_map(lambda s: P(None, *s), tree)


def replicate_specs(tree: Params) -> Params:
    """ZeRO-1 profile: every parameter replicated (optimizer moments are
    sharded separately via repro_torch.optim.adamw.zero1_opt_specs)."""
    return tree_map(lambda s: P(*([None] * len(s))), tree)


def dense_param_specs(cfg: ModelConfig, mode: str = "train") -> Params:
    """PartitionSpec tree matching init_dense_model's params.

    ``train``: FSDP over (pod, data) x TP over model.
    ``serve``: weights sharded over BOTH axes (no optimizer state, small
    batch; maximal weight distribution keeps giant models resident)."""
    block = {
        "attn_norm": {"scale": P(None)},
        "attn": _attn_specs(),
        "mlp_norm": {"scale": P(None)},
        "mlp": _mlp_specs(),
    }
    specs = {
        "embed": {"emb": P(AX_MODEL, AX_DATA)},
        "blocks": _stack_specs(block),
        "final_norm": {"scale": P(None)},
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = {"w": P(AX_DATA, AX_MODEL)}
    if cfg.fsdp_all_axes and mode == "train":
        return replicate_specs(specs)
    return specs


TP_SIZE = 16  # model-axis size of both production meshes (fixed by target)


def kv_cache_spec(cfg: ModelConfig, seq_shard: bool, extra_lead: int = 0) -> P:
    """Cache sharding for [*, B, L, Hkv, Dh]: shard heads over `model`
    when divisible by the TP width, else shard the sequence dim; batch
    goes to the data axis unless batch==1 (seq_shard), in which case the
    sequence takes the data axis too."""
    lead = (None,) * (1 + extra_lead)
    heads_ok = cfg.n_kv_heads % TP_SIZE == 0
    if seq_shard:
        if heads_ok:
            return P(*lead, None, AX_DATA, AX_MODEL, None)
        return P(*lead, None, ("pod", "data", "model"), None, None)
    if heads_ok:
        return P(*lead, AX_DATA, None, AX_MODEL, None)
    return P(*lead, AX_DATA, AX_MODEL, None, None)


def dense_cache_specs(cfg: ModelConfig, seq_shard: bool = False) -> Params:
    spec = kv_cache_spec(cfg, seq_shard)
    return {"k": spec, "v": spec}
