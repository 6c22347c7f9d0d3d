"""Whisper-style encoder-decoder backbone: prefill, decode and the loss. [arXiv:2212.04356]

Port of the JAX package's ``models/whisper.py``.  The audio
conv frontend is a stub there too: the caller gives precomputed frame
embeddings ``[B, T_frames, d_model]``.  The encoder runs bidirectional
self-attention over the frames; the decoder causal self-attention, then
cross-attention to the encoder output; plain (non-gated) GELU MLPs.  RoPE
is applied in the encoder and in the decoder's self-attention, not in
cross-attention, as in the reference.  The blocks stay stacked
(``enc_blocks``, ``dec_blocks``: ``[n_layers, ...]``), as in JAX, so a JAX
tree converts leaf for leaf; where JAX scans the stack, the port loops,
each layer under ``maybe_remat`` as the reference's scan body.

Prefill runs every attention through ``flash_attention``.  Decode runs
both attentions of each decoder layer through the decode-attention kernel:
self-attention over the positions ``0..pos`` of the layer's KV cache,
written in place; cross-attention over all ``encoder_seq`` positions of
the cross K/V that :func:`encdec_prefill_cross` writes once (into the
cache, in place) and decode only reads.  A step builds the kernel's two
``valid_len`` tensors once (``pos + 1`` and ``encoder_seq``) for all layers.

:func:`encdec_param_specs` and :func:`encdec_cache_specs` are the
reference's sharding trees as data, keyed as the port's trees (see
``models/transformer.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attn.ops import gqa_decode_attention
from repro_torch.models.common import (
    apply_rope,
    chunked_softmax_xent,
    dtype_of,
    embed,
    flash_attention,
    init_embedding,
    init_linear,
    init_rmsnorm,
    linear,
    maybe_remat,
    rmsnorm,
)
from repro_torch.models.config import ModelConfig
from repro_torch.launch.mesh import AX_DATA, AX_MODEL
from repro_torch.launch.mesh import PartitionSpec as P
from repro_torch.models.transformer import (
    _attn_specs,
    _layer,
    _layers,
    _stack,
    _stack_specs,
    attn_apply_decode,
    init_attn,
    kv_cache_spec,
    replicate_specs,
)

Params = Dict[str, Any]


def init_gelu_mlp(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> Params:
    return {
        "w1": init_linear(gen, cfg.d_model, cfg.d_ff, dtype),
        "w2": init_linear(gen, cfg.d_ff, cfg.d_model, dtype,
                          scale=0.02 / max(1, 2 * cfg.n_layers) ** 0.5),
    }


def gelu_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = linear(p["w1"], x)
    return linear(p["w2"], F.gelu(h.float(), approximate="tanh").to(x.dtype))


def init_cross_attn(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> Params:
    return init_attn(gen, cfg, dtype)  # same shapes: wq, wk, wv, wo


def _mha(cfg: ModelConfig, p: Params, xq: torch.Tensor, xkv: torch.Tensor, causal: bool,
         rope: bool) -> torch.Tensor:
    B, Lq, _ = xq.shape
    Lk = xkv.shape[1]
    dh = cfg.resolved_head_dim
    q = linear(p["wq"], xq).reshape(B, Lq, cfg.n_heads, dh)
    k = linear(p["wk"], xkv).reshape(B, Lk, cfg.n_kv_heads, dh)
    v = linear(p["wv"], xkv).reshape(B, Lk, cfg.n_kv_heads, dh)
    if rope:
        q = apply_rope(q, torch.arange(Lq, device=xq.device).expand(B, Lq), cfg.rope_theta)
        k = apply_rope(k, torch.arange(Lk, device=xq.device).expand(B, Lk), cfg.rope_theta)
    o = flash_attention(q, k, v, causal=causal, q_chunk=cfg.attn_q_chunk,
                        k_chunk=cfg.attn_k_chunk)
    return linear(p["wo"], o.reshape(B, Lq, cfg.n_heads * dh))


def init_enc_block(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> Params:
    return {
        "attn_norm": init_rmsnorm(cfg.d_model, gen.device),
        "attn": init_attn(gen, cfg, dtype),
        "mlp_norm": init_rmsnorm(cfg.d_model, gen.device),
        "mlp": init_gelu_mlp(gen, cfg, dtype),
    }


def init_dec_block(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> Params:
    return {
        "self_norm": init_rmsnorm(cfg.d_model, gen.device),
        "self_attn": init_attn(gen, cfg, dtype),
        "cross_norm": init_rmsnorm(cfg.d_model, gen.device),
        "cross_attn": init_cross_attn(gen, cfg, dtype),
        "mlp_norm": init_rmsnorm(cfg.d_model, gen.device),
        "mlp": init_gelu_mlp(gen, cfg, dtype),
    }


def init_encdec_model(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Weights drawn from ``gen`` on its device, with the JAX package's
    scales; encoder and decoder blocks stacked ``[n_layers, ...]``."""
    dtype = dtype_of(cfg.dtype)
    return {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype),
        "enc_blocks": _stack([init_enc_block(gen, cfg, dtype)
                              for _ in range(cfg.n_encoder_layers)]),
        "dec_blocks": _stack([init_dec_block(gen, cfg, dtype) for _ in range(cfg.n_layers)]),
        "enc_norm": init_rmsnorm(cfg.d_model, gen.device),
        "final_norm": init_rmsnorm(cfg.d_model, gen.device),
    }


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor) -> torch.Tensor:
    """frames: [B, T_enc, D] (stub frontend output) -> encoder states."""

    def layer(p, h):
        hn = rmsnorm(p["attn_norm"], h, cfg.norm_eps)
        h = h + _mha(cfg, p["attn"], hn, hn, causal=False, rope=True)
        return h + gelu_mlp(p["mlp"], rmsnorm(p["mlp_norm"], h, cfg.norm_eps))

    body = maybe_remat(layer, cfg)
    h = frames
    for p in _layers(params["enc_blocks"]):
        h = body(p, h)
    return rmsnorm(params["enc_norm"], h, cfg.norm_eps)


def decoder_hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   enc: torch.Tensor) -> torch.Tensor:

    def layer(p, enc, h):
        hn = rmsnorm(p["self_norm"], h, cfg.norm_eps)
        h = h + _mha(cfg, p["self_attn"], hn, hn, causal=True, rope=True)
        h = h + _mha(cfg, p["cross_attn"], rmsnorm(p["cross_norm"], h, cfg.norm_eps), enc,
                     causal=False, rope=False)
        return h + gelu_mlp(p["mlp"], rmsnorm(p["mlp_norm"], h, cfg.norm_eps))

    body = maybe_remat(layer, cfg)
    h = embed(params["embed"], tokens)
    for p in _layers(params["dec_blocks"]):
        h = body(p, enc, h)
    return rmsnorm(params["final_norm"], h, cfg.norm_eps)


def encdec_loss(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token cross-entropy of the decoder over ``batch["tokens"]``
    after the encoder over ``batch["frames"]``, through the tied head."""
    enc = encode(cfg, params, batch["frames"])
    h = decoder_hidden(cfg, params, batch["tokens"], enc)
    return chunked_softmax_xent(h, params["embed"]["emb"].T, batch["labels"],
                                chunk=cfg.logits_chunk)


def encdec_prefill(cfg: ModelConfig, params: Params, frames: torch.Tensor,
                   tokens: torch.Tensor) -> torch.Tensor:
    """Encoder over ``frames [B, T, D]``, decoder over ``tokens [B, L]`` ->
    last-position logits [B, vocab] (f32)."""
    enc = encode(cfg, params, frames)
    h = decoder_hidden(cfg, params, tokens, enc)
    return (h[:, -1] @ params["embed"]["emb"].T).float()


def encdec_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device: torch.device) -> Params:
    """Self-attention KV caches ``[n_layers, B, max_len, Hkv, Dh]`` and the
    cross K/V ``[n_layers, B, encoder_seq, Hkv, Dh]`` (zero until
    :func:`encdec_prefill_cross` writes them)."""
    dh = cfg.resolved_head_dim
    dt = dtype_of(cfg.dtype)
    nl, hkv = cfg.n_layers, cfg.n_kv_heads
    zeros = lambda L: torch.zeros((nl, batch, L, hkv, dh), dtype=dt, device=device)  # noqa: E731
    return {"k": zeros(max_len), "v": zeros(max_len),
            "xk": zeros(cfg.encoder_seq), "xv": zeros(cfg.encoder_seq)}


def encdec_prefill_cross(cfg: ModelConfig, params: Params, enc: torch.Tensor,
                         cache: Params) -> Params:
    """Each decoder layer's cross K/V from the encoder states, written into
    ``cache["xk"]`` / ``cache["xv"]`` in place (JAX returns a new cache);
    returns the cache."""
    B, T, _ = enc.shape
    dh = cfg.resolved_head_dim
    for i in range(cfg.n_layers):
        p = _layer(params["dec_blocks"], i)["cross_attn"]
        cache["xk"][i].copy_(linear(p["wk"], enc).reshape(B, T, cfg.n_kv_heads, dh))
        cache["xv"][i].copy_(linear(p["wv"], enc).reshape(B, T, cfg.n_kv_heads, dh))
    return cache


def encdec_decode_step(
    cfg: ModelConfig,
    params: Params,
    token: torch.Tensor,  # [B] int
    cache: Params,
    pos: int,
) -> Tuple[torch.Tensor, Params]:
    """One step: next-token logits (f32) and the cache, its self-attention
    KV caches written in place at ``pos``."""
    B = token.shape[0]
    dh = cfg.resolved_head_dim
    T = cache["xk"].shape[2]
    x1 = embed(params["embed"], token)[:, None, :]
    self_len = torch.full((B,), pos + 1, dtype=torch.int32, device=token.device)
    cross_len = torch.full((B,), T, dtype=torch.int32, device=token.device)
    for i in range(cfg.n_layers):
        p = _layer(params["dec_blocks"], i)
        # causal self-attention against the cache
        a, _, _ = attn_apply_decode(cfg, p["self_attn"], rmsnorm(p["self_norm"], x1, cfg.norm_eps),
                                    cache["k"][i], cache["v"][i], pos, self_len)
        x1 = x1 + a
        # cross-attention against the precomputed encoder K/V (full visibility)
        hn = rmsnorm(p["cross_norm"], x1, cfg.norm_eps)
        q = linear(p["cross_attn"]["wq"], hn).reshape(B, 1, cfg.n_heads, dh)
        o = gqa_decode_attention(q, cache["xk"][i], cache["xv"][i], T - 1, cross_len)
        x1 = x1 + linear(p["cross_attn"]["wo"], o.reshape(B, 1, cfg.n_heads * dh))
        x1 = x1 + gelu_mlp(p["mlp"], rmsnorm(p["mlp_norm"], x1, cfg.norm_eps))
    h = rmsnorm(params["final_norm"], x1, cfg.norm_eps)
    logits = (h[:, 0, :] @ params["embed"]["emb"].T).float()
    return logits, cache


# --------------------------------------------------------------- shardings --


def encdec_param_specs(cfg: ModelConfig, mode: str = "train") -> Params:
    mlp = {"w1": {"w": P(AX_DATA, AX_MODEL)}, "w2": {"w": P(AX_MODEL, AX_DATA)}}
    enc_block = {
        "attn_norm": {"scale": P(None)},
        "attn": _attn_specs(),
        "mlp_norm": {"scale": P(None)},
        "mlp": mlp,
    }
    dec_block = {
        "self_norm": {"scale": P(None)},
        "self_attn": _attn_specs(),
        "cross_norm": {"scale": P(None)},
        "cross_attn": _attn_specs(),
        "mlp_norm": {"scale": P(None)},
        "mlp": mlp,
    }
    specs = {
        "embed": {"emb": P(AX_MODEL, AX_DATA)},
        "enc_blocks": _stack_specs(enc_block),
        "dec_blocks": _stack_specs(dec_block),
        "enc_norm": {"scale": P(None)},
        "final_norm": {"scale": P(None)},
    }
    if cfg.fsdp_all_axes and mode == "train":
        return replicate_specs(specs)
    return specs


def encdec_cache_specs(cfg: ModelConfig, seq_shard: bool = False) -> Params:
    spec = kv_cache_spec(cfg, seq_shard)
    # cross K/V has encoder_seq (1500) length: the dry run's fitted specs
    # drop non-divisible axes
    return {"k": spec, "v": spec, "xk": spec, "xv": spec}
