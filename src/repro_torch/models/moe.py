"""Mixture-of-Experts transformer (llama4-maverick, qwen3-moe families): prefill, decode, loss.

Port of the JAX package's ``models/moe.py``.  Routing is the reference's
GShard/Switch-style dense dispatch with groups: tokens are
split into groups of ``moe_group_size``, and each group dispatches into
per-expert capacity buffers through one-hot products: iterative top-k by
``argmax`` (the first index on ties), capacity priority by (k, token),
gates renormalised over the chosen experts, tokens past an expert's
capacity dropped.  The products are plain ``torch.einsum`` calls, as the
JAX package leaves them to XLA; its ``shard_hint`` calls are the identity
on one card and are left out.

llama4-maverick interleaves dense and MoE blocks (``moe_every = 2``);
qwen3-moe is MoE in every block.  The MoE blocks stay stacked
``[groups, ...]`` and the dense ones ``[groups, per_group, ...]``, as in
JAX, so a JAX tree converts leaf for leaf; where JAX scans the groups,
the port loops over them, the dense blocks of a group ahead of its MoE
block, each group under ``maybe_remat`` as the reference's scan body.
The loss (:func:`moe_loss`) adds ``router_aux_weight`` times the groups'
mean load-balance loss to the cross-entropy.  Decode runs every block's
attention through the decode-attention kernel, one ``valid_len`` a step
for all blocks.  As in the reference, the decode step's dense dispatch
reads every expert's weights, whichever experts the batch's tokens chose.

:func:`moe_param_specs` and :func:`moe_cache_specs` are the reference's
sharding trees as data, keyed as the port's trees (see
``models/transformer.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (
    chunked_softmax_xent,
    dtype_of,
    embed,
    glu_activation,
    init_embedding,
    init_linear,
    init_rmsnorm,
    maybe_remat,
    rmsnorm,
)
from repro_torch.launch.mesh import AX_DATA, AX_MODEL
from repro_torch.launch.mesh import PartitionSpec as P
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    _attn_specs,
    _layer,
    _layers,
    _lm_head_w,
    _stack,
    _stack_specs,
    attn_apply_decode,
    attn_apply_train,
    dense_block_apply,
    dense_block_decode,
    dense_param_specs,
    init_attn,
    init_dense_block,
    kv_cache_spec,
)

Params = Dict[str, Any]


# ------------------------------------------------------------------ layer ---


def _expert_bank(gen: torch.Generator, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
    """``[E, ...]`` normal weights times ``scale``, drawn in f32 one expert
    at a time and cast, so that the f32 bank never exists whole (llama4's
    is 21.5 GB in f32).  On ``meta`` (the dry run) there is nothing to
    draw: the bank is its shape."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    if out.device.type == "meta":
        return out
    for e in range(shape[0]):
        w = torch.randn(shape[1:], generator=gen, dtype=torch.float32, device=gen.device)
        out[e] = (w * scale).to(dtype)
    return out


def init_moe_layer(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> Params:
    E, D, F_ = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    s = 0.02
    router = torch.randn((D, E), generator=gen, dtype=torch.float32, device=gen.device) * s
    return {
        "router": {"w": router},
        "w_gate": _expert_bank(gen, (E, D, F_), s, dtype),
        "w_up": _expert_bank(gen, (E, D, F_), s, dtype),
        "w_down": _expert_bank(gen, (E, F_, D), s / max(1, 2 * cfg.n_layers) ** 0.5, dtype),
    }


def _capacity(cfg: ModelConfig, group_tokens: int) -> int:
    c = int(group_tokens * cfg.experts_per_token * cfg.capacity_factor / cfg.n_experts)
    return max(4, -(-c // 4) * 4)


def moe_topk(cfg: ModelConfig, gates: torch.Tensor):
    """Iterative top-k over ``gates [G,S,E]`` with per-k expert one-hots:
    ``(gates, one-hots, indices)`` of the K choices, each a list, first
    choice first."""
    E, K = cfg.n_experts, cfg.experts_per_token
    g = gates
    sel_gate, sel_onehot, sel_idx = [], [], []
    for k in range(K):
        idx = torch.argmax(g, dim=-1)  # [G,S], the first maximum
        oh = F.one_hot(idx, E).float()  # [G,S,E]
        sel_gate.append((g * oh).sum(-1))
        sel_onehot.append(oh)
        sel_idx.append(idx)
        g = g * (1.0 - oh)
    return sel_gate, sel_onehot, sel_idx


def moe_dispatch(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor):
    """x: [G, S, D] -> (dispatch [G,S,E,C], combine [G,S,E,C], aux_loss)."""
    G, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    C = _capacity(cfg, S)
    logits = x.float() @ router_w  # [G,S,E]
    gates = torch.softmax(logits, dim=-1)
    sel_gate, sel_onehot, _ = moe_topk(cfg, gates)

    # capacity positions: priority by (k, token), earlier k first; dispatch and
    # combine summed in place (the terms are [G,S,E,C], 5.4 GB for qwen3-moe's
    # prefill at B=8, L=4096)
    dispatch = torch.zeros((G, S, E, C), dtype=torch.float32, device=x.device)
    combine = torch.zeros((G, S, E, C), dtype=torch.float32, device=x.device)
    gate_sum = sum(sel_gate)
    counts = torch.zeros((G, E), dtype=torch.float32, device=x.device)
    for k in range(K):
        oh = sel_onehot[k]  # [G,S,E]
        pos_in_e = torch.cumsum(oh, dim=1) - oh + counts[:, None, :]  # [G,S,E]
        counts = counts + oh.sum(dim=1)
        keep = (pos_in_e < C) * oh  # [G,S,E]
        pos = (pos_in_e * keep).sum(-1)  # [G,S] (0 when dropped)
        pos_oh = F.one_hot(pos.long(), C).float()  # [G,S,C]
        d_k = keep[..., None] * pos_oh[:, :, None, :]  # [G,S,E,C]
        dispatch.add_(d_k)
        gate_k = sel_gate[k] / torch.clamp(gate_sum, min=1e-9)  # renormalised
        combine.addcmul_(d_k, gate_k[..., None, None])
        del d_k

    # load-balance auxiliary loss (Switch): E * sum_e f_e * p_e
    me = gates.mean(dim=1)  # [G,E] mean router prob
    ce = sel_onehot[0].mean(dim=1)  # [G,E] fraction routed (top-1 proxy)
    aux = (E * (me * ce).sum(-1)).mean()
    return dispatch, combine, aux


def moe_ffn_apply(cfg: ModelConfig, p: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, L, D] -> (y, aux_loss)."""
    B, L, D = x.shape
    T = B * L
    S = min(cfg.moe_group_size, T)
    G = T // S
    if G * S != T:
        raise ValueError(f"tokens {T} not divisible by group {S}")
    xg = x.reshape(G, S, D)
    dispatch, combine, aux = moe_dispatch(cfg, p["router"]["w"], xg)
    dtype = x.dtype
    expert_in = torch.einsum("gsec,gsd->gecd", dispatch.to(dtype), xg)
    del dispatch
    a = torch.einsum("gecd,edf->gecf", expert_in, p["w_gate"])
    b = torch.einsum("gecd,edf->gecf", expert_in, p["w_up"])
    h = glu_activation(cfg.activation, a, b)
    expert_out = torch.einsum("gecf,efd->gecd", h, p["w_down"])
    y = torch.einsum("gsec,gecd->gsd", combine.to(dtype), expert_out)
    return y.reshape(B, L, D), aux


def init_moe_block(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> Params:
    return {
        "attn_norm": init_rmsnorm(cfg.d_model, gen.device),
        "attn": init_attn(gen, cfg, dtype),
        "mlp_norm": init_rmsnorm(cfg.d_model, gen.device),
        "moe": init_moe_layer(gen, cfg, dtype),
    }


def moe_block_apply(cfg: ModelConfig, p: Params, x: torch.Tensor, positions: torch.Tensor):
    if cfg.parallel_block:
        a = attn_apply_train(cfg, p["attn"], rmsnorm(p["attn_norm"], x, cfg.norm_eps), positions)
        y, aux = moe_ffn_apply(cfg, p["moe"], rmsnorm(p["mlp_norm"], x, cfg.norm_eps))
        return x + a + y, aux
    x = x + attn_apply_train(cfg, p["attn"], rmsnorm(p["attn_norm"], x, cfg.norm_eps), positions)
    y, aux = moe_ffn_apply(cfg, p["moe"], rmsnorm(p["mlp_norm"], x, cfg.norm_eps))
    return x + y, aux


def moe_block_decode(cfg, p, x1, cache_k, cache_v, pos, valid_len=None):
    a, ck, cv = attn_apply_decode(cfg, p["attn"], rmsnorm(p["attn_norm"], x1, cfg.norm_eps),
                                  cache_k, cache_v, pos, valid_len)
    x1 = x1 + a
    y, _ = moe_ffn_apply(cfg, p["moe"], rmsnorm(p["mlp_norm"], x1, cfg.norm_eps))
    return x1 + y, ck, cv


# ------------------------------------------------------------- full model ---


def _n_groups(cfg: ModelConfig) -> int:
    if cfg.n_layers % cfg.moe_every:
        raise ValueError(f"{cfg.n_layers} layers are not whole groups of {cfg.moe_every}")
    return cfg.n_layers // cfg.moe_every


def init_moe_model(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Weights drawn from ``gen`` on its device, with the JAX package's
    scales; MoE blocks stacked ``[groups, ...]``, dense blocks (where
    ``moe_every > 1``) ``[groups, per_group, ...]``."""
    dtype = dtype_of(cfg.dtype)
    ng, nd = _n_groups(cfg), cfg.moe_every - 1
    params = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype),
        "moe_blocks": _stack([init_moe_block(gen, cfg, dtype) for _ in range(ng)]),
        "final_norm": init_rmsnorm(cfg.d_model, gen.device),
        "lm_head": init_linear(gen, cfg.d_model, cfg.vocab_size, dtype),
    }
    if nd:
        params["dense_blocks"] = _stack([_stack([init_dense_block(gen, cfg, dtype)
                                                 for _ in range(nd)]) for _ in range(ng)])
    return params


def forward_hidden_moe(cfg: ModelConfig, params: Params, x: torch.Tensor,
                       positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embedding-space input [B, L, D] -> (final hidden states, mean aux loss)."""
    ng, nd = _n_groups(cfg), cfg.moe_every - 1

    def group(p_moe, p_dense, h):
        for pd in _layers(p_dense) if nd else ():
            h = dense_block_apply(cfg, pd, h, positions)
        return moe_block_apply(cfg, p_moe, h, positions)

    body = maybe_remat(group, cfg)
    dense = _layers(params["dense_blocks"]) if nd else [{}] * ng
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p_moe, p_dense in zip(_layers(params["moe_blocks"]), dense):
        x, a = body(p_moe, p_dense, x)
        aux = aux + a
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux / ng


def moe_loss(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Cross-entropy plus ``router_aux_weight`` times the load-balance loss."""
    tokens, labels = batch["tokens"], batch["labels"]
    B, L = tokens.shape
    x = embed(params["embed"], tokens)
    positions = torch.arange(L, device=tokens.device).expand(B, L)
    h, aux = forward_hidden_moe(cfg, params, x, positions)
    ce = chunked_softmax_xent(h, _lm_head_w(cfg, params), labels, chunk=cfg.logits_chunk)
    return ce + cfg.router_aux_weight * aux


def moe_prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Forward over ``tokens [B, L]`` -> last-position logits [B, vocab] (f32)."""
    B, L = tokens.shape
    x = embed(params["embed"], tokens)
    positions = torch.arange(L, device=tokens.device).expand(B, L)
    h, _ = forward_hidden_moe(cfg, params, x, positions)
    return (h[:, -1] @ _lm_head_w(cfg, params)).float()


def moe_init_cache(cfg: ModelConfig, batch: int, max_len: int, device: torch.device) -> Params:
    """A KV cache per MoE block ``[groups, B, max_len, Hkv, Dh]`` and per
    dense block ``[groups, per_group, B, max_len, Hkv, Dh]``."""
    dh = cfg.resolved_head_dim
    dt = dtype_of(cfg.dtype)
    ng, nd = _n_groups(cfg), cfg.moe_every - 1
    row = (batch, max_len, cfg.n_kv_heads, dh)
    cache = {"moe_k": torch.zeros((ng,) + row, dtype=dt, device=device),
             "moe_v": torch.zeros((ng,) + row, dtype=dt, device=device)}
    if nd:
        cache["dense_k"] = torch.zeros((ng, nd) + row, dtype=dt, device=device)
        cache["dense_v"] = torch.zeros((ng, nd) + row, dtype=dt, device=device)
    return cache


def moe_decode_step(
    cfg: ModelConfig,
    params: Params,
    token: torch.Tensor,  # [B] int
    cache: Params,
    pos: int,
) -> Tuple[torch.Tensor, Params]:
    """One step: next-token logits (f32) and the cache, updated in place."""
    ng, nd = _n_groups(cfg), cfg.moe_every - 1
    x1 = embed(params["embed"], token)[:, None, :]
    valid_len = torch.full((token.shape[0],), pos + 1, dtype=torch.int32, device=token.device)
    for g in range(ng):
        for i in range(nd):
            x1, _, _ = dense_block_decode(cfg, _layer(_layer(params["dense_blocks"], g), i), x1,
                                          cache["dense_k"][g, i], cache["dense_v"][g, i], pos,
                                          valid_len)
        x1, _, _ = moe_block_decode(cfg, _layer(params["moe_blocks"], g), x1,
                                    cache["moe_k"][g], cache["moe_v"][g], pos, valid_len)
    h = rmsnorm(params["final_norm"], x1, cfg.norm_eps)
    logits = (h[:, 0, :] @ _lm_head_w(cfg, params)).float()
    return logits, cache


# --------------------------------------------------------------- shardings --


def moe_param_specs(cfg: ModelConfig, mode: str = "train") -> Params:
    # 2D expert sharding in BOTH modes: experts -> DATA axis (expert
    # parallelism on the same axis tokens are sharded on, so dispatch
    # lowers to token-sized all-to-alls), d_ff -> model axis (TP within
    # each expert).  Weights stay put and tokens move.
    moe = {
        "router": {"w": P(None, None)},
        "w_gate": P(AX_DATA, None, AX_MODEL),
        "w_up": P(AX_DATA, None, AX_MODEL),
        "w_down": P(AX_DATA, AX_MODEL, None),
    }
    moe_block = {
        "attn_norm": {"scale": P(None)},
        "attn": _attn_specs(),
        "mlp_norm": {"scale": P(None)},
        "moe": moe,
    }
    specs = {
        "embed": {"emb": P(AX_MODEL, AX_DATA)},
        "moe_blocks": _stack_specs(moe_block),
        "final_norm": {"scale": P(None)},
        "lm_head": {"w": P(AX_DATA, AX_MODEL)},
    }
    if cfg.moe_every > 1:
        dense_block = dense_param_specs(cfg, mode)["blocks"]  # already stacked once
        specs["dense_blocks"] = _stack_specs(dense_block)
    return specs


def moe_cache_specs(cfg: ModelConfig, seq_shard: bool = False) -> Params:
    spec = kv_cache_spec(cfg, seq_shard)
    out = {"moe_k": spec, "moe_v": spec}
    if cfg.moe_every > 1:
        dspec = kv_cache_spec(cfg, seq_shard, extra_lead=1)
        out["dense_k"] = dspec
        out["dense_v"] = dspec
    return out
