"""Nemotron-H as released: Mamba-2, NoPE attention and dropless MoE layers in one stack.

NVIDIA's Nemotron-H family (arXiv:2504.03624; the layer equations of the
release's ``modeling_nemotron_h.py``), as Nemotron-3-Nano-30B-A3B runs it.
``layer_pattern`` (the release's ``hybrid_override_pattern``) gives each
layer's mixer: ``M`` a Mamba-2 block, ``E`` a mixture of experts, ``*``
attention.  Every layer is pre-norm with a residual add:

    h = h + mixer(rmsnorm(h))

* ``M``: ``mamba2.mamba_block_apply`` (the fused passes and the SSD kernel
  on a CUDA tensor with grad off) with ``mamba_num_heads`` heads of
  ``ssm_headdim``, so ``d_inner`` is their product and not ``ssm_expand``
  times d_model, and ``ssm_ngroups`` groups of B and C (the gated out-norm
  over each group's ``d_inner / G`` channels);
* ``*``: causal GQA of ``n_heads`` query heads over ``n_kv_heads`` key heads
  of ``head_dim``, no bias, scores scaled by 1/sqrt(head_dim), and no
  position embedding (NoPE: the release's attention applies no rotary
  embedding), through ``common.flash_attention``;
* ``E``: ``moe_dropless.moe_apply``: sigmoid router with the correction
  bias, ``n_experts`` relu² experts of ``moe_d_ff``, top ``experts_per_token``,
  and a shared relu² expert of ``moe_shared_d_ff``; span ``nemotron_h.moe``
  around the whole layer.

Then the final norm and the untied head at the last position.  The JAX
package has no such family, so it lives in the port alone, as
``models/zamba2.py`` does (:class:`NemotronHConfig`,
``configs.nemotron_3_nano_30b_a3b``, found by ``configs.port_only``).

Leaves are stacked by kind: ``mamba`` ``[#M, ...]`` (``mamba2``'s block,
its own pre-norm inside), ``attn`` ``[#*, ...]``, ``moe`` ``[#E, ...]``
(the routed experts' ``w_up [E, D, F]`` and ``w_down [E, F, D]``, the
float32 router and correction bias, the shared expert).  :func:`layer_apply`
runs one layer of either kind, and the prefill loops over the pattern with
it.  There is no loss, no decode (it waits for CUDA graphs) and there are
no sharding specs (one card): those entry points raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models import moe_dropless
from repro_torch.models.common import (
    dtype_of,
    embed,
    flash_attention,
    init_embedding,
    init_linear,
    init_rmsnorm,
    linear,
    rmsnorm,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba2 import init_mamba_block, mamba_block_apply
from repro_torch.models.transformer import _layer, _stack
from repro_torch.spans import span

Params = Dict[str, Any]

KINDS = {"M": "mamba", "*": "attn", "E": "moe"}
NO_LOSS = ("nemotron_h has no training loss: the benchmark prefills it, and a training step of "
           "the whole model needs some 505 GB")
NO_DECODE = "nemotron_h has no decode: its decode cell waits for CUDA graphs"
NO_SPECS = ("nemotron_h has no sharding specs: the port runs it on one card, and the JAX "
            "package, whose spec trees the port keeps, has no nemotron_h family")


@dataclasses.dataclass(frozen=True)
class NemotronHConfig(ModelConfig):
    """``ModelConfig`` with Nemotron-H's own keys: the layer pattern, the
    Mamba heads and B/C groups, the shared expert's width and the router's
    scale, and the router's keys that ``moe_dropless`` reads: ``n_group``
    and ``topk_group`` (1 in the release: no group limit) and the first
    expert held (0: the card holds all of them).  Of ``ModelConfig``'s keys,
    ``d_ff`` is 0 (the release has no dense MLP layer) and ``activation``
    and ``ssm_expand`` are not read: the experts are relu², and
    :attr:`d_inner` comes from the Mamba heads."""
    layer_pattern: str = ""
    mamba_num_heads: int = 0
    ssm_ngroups: int = 1
    moe_shared_d_ff: int = 0
    routed_scaling_factor: float = 1.0
    n_group: int = 1
    topk_group: int = 1
    expert_offset: int = 0

    @property
    def d_inner(self) -> int:
        return self.mamba_num_heads * self.ssm_headdim

    def reduced(self, **overrides) -> "NemotronHConfig":
        """``ModelConfig.reduced`` with a pattern of each kind and heads
        that fit its widths."""
        base = dict(layer_pattern="ME*E", n_layers=4, mamba_num_heads=4, ssm_ngroups=2,
                    moe_shared_d_ff=96)
        base.update(overrides)
        return super().reduced(**base)


def layer_kinds(cfg: NemotronHConfig) -> List[str]:
    """``"mamba"``, ``"attn"`` or ``"moe"`` for each layer, from the pattern."""
    bad = sorted(set(cfg.layer_pattern) - set(KINDS))
    if bad:
        raise ValueError(f"{cfg.name}: layer pattern kinds {bad} are not among {list(KINDS)}")
    return [KINDS[c] for c in cfg.layer_pattern]


def check_config(cfg: NemotronHConfig) -> None:
    """Raise where ``cfg`` is not a Nemotron-H this module computes."""
    kinds = layer_kinds(cfg)
    problems = [
        (len(kinds) != cfg.n_layers,
         f"the pattern has {len(kinds)} layers, n_layers is {cfg.n_layers}"),
        (cfg.n_heads % cfg.n_kv_heads, f"{cfg.n_heads} query heads in {cfg.n_kv_heads} groups"),
        (cfg.mamba_num_heads % cfg.ssm_ngroups,
         f"{cfg.mamba_num_heads} Mamba heads in {cfg.ssm_ngroups} groups"),
        (not 0 < cfg.experts_per_token <= cfg.n_experts,
         f"top {cfg.experts_per_token} of {cfg.n_experts} experts"),
        (cfg.tie_embeddings, "the head is untied"),
        (cfg.d_ff, f"d_ff is {cfg.d_ff}: there is no dense MLP layer (the experts' widths are "
                   "moe_d_ff and moe_shared_d_ff)"),
    ]
    bad = [msg for failed, msg in problems if failed]
    if bad:
        raise ValueError(f"{cfg.name}: " + "; ".join(bad))


def init_nemotron_h_model(gen: torch.Generator, cfg: NemotronHConfig) -> Params:
    """Weights drawn from ``gen`` on its device at the port's scales: N(0,
    0.02) projections, the output projections (attention's, the experts' and
    the shared expert's down projections, the Mamba blocks') scaled by
    1/sqrt(2 n_layers), the router N(0, 0.02) and its correction bias N(0,
    0.01) in float32, norm scales one."""
    check_config(cfg)
    dtype, dev = dtype_of(cfg.dtype), gen.device
    D, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    E, F_, Fs = cfg.n_experts, cfg.moe_d_ff, cfg.moe_shared_d_ff
    out = 0.02 / max(1, 2 * cfg.n_layers) ** 0.5
    kinds = layer_kinds(cfg)

    def normal(shape, std, dt=dtype):
        return (torch.randn(shape, generator=gen, dtype=torch.float32, device=dev) * std).to(dt)

    def attn() -> Params:
        return {"norm": init_rmsnorm(D, dev),
                "wq": init_linear(gen, D, H * dh, dtype),
                "wk": init_linear(gen, D, Hkv * dh, dtype),
                "wv": init_linear(gen, D, Hkv * dh, dtype),
                "wo": init_linear(gen, H * dh, D, dtype, scale=out)}

    def moe() -> Params:
        return {"norm": init_rmsnorm(D, dev),
                "router": {"w": normal((D, E), 0.02, torch.float32)},
                "e_bias": normal((E,), 0.01, torch.float32),
                "w_up": normal((E, D, F_), 0.02),
                "w_down": normal((E, F_, D), out),
                "shared_up": init_linear(gen, D, Fs, dtype),
                "shared_down": init_linear(gen, Fs, D, dtype, scale=out)}

    make = {"mamba": lambda: init_mamba_block(gen, cfg, dtype), "attn": attn, "moe": moe}
    params = {"embed": init_embedding(gen, cfg.vocab_size, D, dtype)}
    for kind in KINDS.values():
        n = kinds.count(kind)
        if n:
            params[kind] = _stack([make[kind]() for _ in range(n)])
    params["final_norm"] = init_rmsnorm(D, dev)
    params["head"] = init_linear(gen, D, cfg.vocab_size, dtype)
    return params


def attention_apply(cfg: NemotronHConfig, p: Params, h: torch.Tensor) -> torch.Tensor:
    """``h + attn(rmsnorm(h))`` over ``h [B, L, D]``: causal GQA, NoPE."""
    B, L, _ = h.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    x = rmsnorm(p["norm"], h, cfg.norm_eps)
    q = linear(p["wq"], x).reshape(B, L, H, dh)
    k = linear(p["wk"], x).reshape(B, L, Hkv, dh)
    v = linear(p["wv"], x).reshape(B, L, Hkv, dh)
    o = flash_attention(q, k, v, causal=True, q_chunk=cfg.attn_q_chunk,
                        k_chunk=cfg.attn_k_chunk, scale=dh ** -0.5)
    return h + linear(p["wo"], o.reshape(B, L, H * dh))


def moe_layer_apply(cfg: NemotronHConfig, p: Params, h: torch.Tensor,
                    routes: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """``h + moe(rmsnorm(h))``; span ``nemotron_h.moe``."""
    with span("nemotron_h.moe"):
        return h + moe_dropless.moe_apply(cfg, p, rmsnorm(p["norm"], h, cfg.norm_eps), routes)


def layer_apply(cfg: NemotronHConfig, p: Params, kind: str, h: torch.Tensor,
                routes: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """One layer of ``kind`` (``"mamba"``, ``"attn"``, ``"moe"``) with its
    weights ``p`` over ``h [B, L, D]``; an MoE layer appends its expert ids
    to ``routes`` where it is a list."""
    if kind == "mamba":
        return mamba_block_apply(cfg, p, h)
    if kind == "attn":
        return attention_apply(cfg, p, h)
    if kind == "moe":
        return moe_layer_apply(cfg, p, h, routes)
    raise ValueError(kind)


def layers(cfg: NemotronHConfig, params: Params) -> List[Tuple[str, Params]]:
    """``(kind, weights)`` of every layer in order (views)."""
    seen: Dict[str, int] = {}
    out = []
    for kind in layer_kinds(cfg):
        i = seen[kind] = seen.get(kind, -1) + 1
        out.append((kind, _layer(params[kind], i)))
    return out


def final_logits(cfg: NemotronHConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    """The last position's logits [B, vocab] (f32) of the stack's output
    ``h [B, L, D]``: the final norm, then the untied head."""
    return linear(params["head"], rmsnorm(params["final_norm"], h[:, -1], cfg.norm_eps)).float()


def nemotron_h_prefill(cfg: NemotronHConfig, params: Params, tokens: torch.Tensor,
                       routes: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """Forward over ``tokens [B, L]`` -> last-position logits [B, vocab]
    (f32).  ``routes`` (a list) receives each MoE layer's expert ids, where
    given; a prefill through ``Model.prefill`` does not ask for them."""
    h = embed(params["embed"], tokens)
    for kind, p in layers(cfg, params):
        h = layer_apply(cfg, p, kind, h, routes)
    return final_logits(cfg, params, h)


def nemotron_h_loss(cfg, params, batch):
    raise NotImplementedError(NO_LOSS)


def nemotron_h_init_cache(cfg, batch, max_len, device):
    raise NotImplementedError(NO_DECODE)


def nemotron_h_decode_step(cfg, params, token, cache, pos):
    raise NotImplementedError(NO_DECODE)


def nemotron_h_param_specs(cfg, mode="train"):
    raise NotImplementedError(NO_SPECS)


def nemotron_h_cache_specs(cfg, seq_shard=False):
    raise NotImplementedError(NO_SPECS)
