"""Zamba2 as released: Mamba-2 layers, some of them hybrid, with shared attention+MLP blocks.

Zyphra's Zamba2 (arXiv:2411.15242; the layer equations of transformers'
``modeling_zamba2.py``).  Every layer is a Mamba-2 block with
``ssm_ngroups`` groups of B and C (head h reads group h G / H) and a
gated out-norm taken over each group's ``d_inner / G`` channels.  The
layers listed in ``hybrid_layer_ids`` (the sites, i = 0, 1, ...) first run
shared block ``b = i mod num_mem_blocks`` over the residual stream ``h``
and the embedding output ``e``, kept for the whole forward:

    a  = rmsnorm_2D(concat(h, e))
    o  = attn(a) @ Wo[b]        q, k, v: 2D -> H x Dh, rope over Dh, causal,
                                scores scaled by (Dh / 2)^-1/2
    m  = rmsnorm_D(o)           no residual inside the shared block
    gu = m @ Wgu[b] + (m @ A_i) @ B_i                  the site's own adapter
    t  = (gelu(gu[:F]) * gu[F:]) @ Wdown[b] @ Wlin_i   the site's own linear
    h  = h + mamba(rmsnorm_D(h + t))    t enters the norm's input, not the residual

and every other layer is ``h = h + mamba(rmsnorm_D(h))``; then the final
norm and the tied head.  gelu is exact (erf).  The JAX package has no such
family (its ``models/hybrid.py``, which the port mirrors in its own
``hybrid.py``, shares one block of plain pre-norm attention over d_model),
so this family and its configuration (:class:`Zamba2Config`,
``configs.zamba2_7b``, found by ``configs.port_only``) live in the port
alone.

Leaves are stacked: ``mamba_blocks`` ``[n_layers, ...]`` (``mamba2``'s
block, G groups), ``shared`` ``[num_mem_blocks, ...]``, ``adapters`` and
``site_linear`` ``[n_sites, ...]``.  :func:`zamba2_prefill` runs each
Mamba block through ``mamba_block_apply`` (the fused passes and the SSD
kernel on a CUDA tensor with grad off) and each site's attention through
``common.flash_attention`` (the flash kernel on a CUDA tensor with grad
off, the plain chunked version on the CPU and under autograd); span
``zamba2.shared_block`` around a whole site, whose calls
``shared_block.calls`` counts.  :func:`zamba2_loss` is the same forward
with ``chunked_softmax_xent``, for the CPU tests.  There
is no decode (the decode-attention kernel takes no head dim of 224, and a
decode cell waits for CUDA graphs) and there are no sharding specs (one
card): those entry points raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

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
    rmsnorm,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba2 import init_mamba_block, mamba_block_apply
from repro_torch.models.transformer import _layer, _layers, _stack
from repro_torch.spans import span

Params = Dict[str, Any]

NO_DECODE = ("zamba2 has no decode: the decode-attention kernel takes no head dim of 224, and "
             "its decode cell waits for CUDA graphs")
NO_SPECS = ("zamba2 has no sharding specs: the port runs it on one card, and the JAX package, "
            "whose spec trees the port keeps, has no zamba2 family")


@dataclasses.dataclass(frozen=True)
class Zamba2Config(ModelConfig):
    """``ModelConfig`` with Zamba2's own keys: the B/C groups of the Mamba
    blocks, the hybrid layers, the number of shared blocks and the adapters'
    rank.  Attention runs over ``n_heads`` heads of ``head_dim`` over 2 d_model
    (``n_heads * head_dim == 2 * d_model``), the MLP over ``d_ff``."""
    ssm_ngroups: int = 1
    hybrid_layer_ids: Tuple[int, ...] = ()
    num_mem_blocks: int = 1
    adapter_rank: int = 0

    @property
    def n_sites(self) -> int:
        return len(self.hybrid_layer_ids)

    def block_of_site(self, i: int) -> int:
        """The shared block site ``i`` runs (site i's adapter and linear are its own)."""
        return i % self.num_mem_blocks


def check_config(cfg: Zamba2Config) -> None:
    """Raise where ``cfg`` is not a Zamba2 this module computes."""
    ids = list(cfg.hybrid_layer_ids)
    problems = [
        (cfg.n_heads * cfg.resolved_head_dim != 2 * cfg.d_model,
         f"attention must span 2 d_model: {cfg.n_heads} x {cfg.resolved_head_dim} heads "
         f"against d_model {cfg.d_model}"),
        (cfg.n_kv_heads != cfg.n_heads, "zamba2's attention has one key head per query head"),
        (ids != sorted(set(ids)) or any(not 0 <= l < cfg.n_layers for l in ids),
         f"hybrid_layer_ids {ids} must be increasing layers below {cfg.n_layers}"),
        (cfg.num_mem_blocks < 1 or cfg.ssm_nheads % cfg.ssm_ngroups,
         f"{cfg.num_mem_blocks} shared blocks; {cfg.ssm_nheads} heads in {cfg.ssm_ngroups} "
         f"groups"),
        (not cfg.tie_embeddings, "the head is the tied embedding"),
    ]
    bad = [msg for failed, msg in problems if failed]
    if bad:
        raise ValueError(f"{cfg.name}: " + "; ".join(bad))


def layer_types(cfg: Zamba2Config) -> List[str]:
    """``"hybrid"`` or ``"mamba"`` for each layer (the release's ``layers_block_type``)."""
    sites = set(cfg.hybrid_layer_ids)
    return ["hybrid" if l in sites else "mamba" for l in range(cfg.n_layers)]


def init_zamba2_model(gen: torch.Generator, cfg: Zamba2Config) -> Params:
    """Weights drawn from ``gen`` on its device at the port's scales: N(0,
    0.02) projections, the output projections (attention's, the MLP's down
    projection, the Mamba blocks') scaled by 1/sqrt(2 n_layers), norm
    scales one."""
    check_config(cfg)
    dtype, dev = dtype_of(cfg.dtype), gen.device
    D, F_, r = cfg.d_model, cfg.d_ff, cfg.adapter_rank
    A = cfg.n_heads * cfg.resolved_head_dim
    out = 0.02 / max(1, 2 * cfg.n_layers) ** 0.5

    def shared() -> Params:
        return {
            "attn_norm": init_rmsnorm(2 * D, dev),
            "wq": init_linear(gen, 2 * D, A, dtype),
            "wk": init_linear(gen, 2 * D, A, dtype),
            "wv": init_linear(gen, 2 * D, A, dtype),
            "wo": init_linear(gen, A, D, dtype, scale=out),
            "mlp_norm": init_rmsnorm(D, dev),
            "w_gate_up": init_linear(gen, D, 2 * F_, dtype),
            "w_down": init_linear(gen, F_, D, dtype, scale=out),
        }

    return {
        "embed": init_embedding(gen, cfg.vocab_size, D, dtype),
        "mamba_blocks": _stack([init_mamba_block(gen, cfg, dtype) for _ in range(cfg.n_layers)]),
        "shared": _stack([shared() for _ in range(cfg.num_mem_blocks)]),
        "adapters": _stack([{"down": init_linear(gen, D, r, dtype),
                             "up": init_linear(gen, r, 2 * F_, dtype)}
                            for _ in range(cfg.n_sites)]),
        "site_linear": _stack([init_linear(gen, D, D, dtype) for _ in range(cfg.n_sites)]),
        "final_norm": init_rmsnorm(D, dev),
    }


def shared_block(cfg: Zamba2Config, params: Params, i: int, h: torch.Tensor, e: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """Site ``i``'s addend ``t [B, L, D]`` (the module docstring's equations)
    from the residual stream ``h`` and the embedding output ``e``, both
    ``[B, L, D]``; span ``zamba2.shared_block``, counted in
    ``shared_block.calls``."""
    with span("zamba2.shared_block"):
        b = _layer(params["shared"], cfg.block_of_site(i))
        ad = _layer(params["adapters"], i)
        B, L, _ = h.shape
        H, dh = cfg.n_heads, cfg.resolved_head_dim
        a = rmsnorm(b["attn_norm"], torch.cat([h, e], dim=-1), cfg.norm_eps)
        q = apply_rope(linear(b["wq"], a).reshape(B, L, H, dh), positions, cfg.rope_theta)
        k = apply_rope(linear(b["wk"], a).reshape(B, L, H, dh), positions, cfg.rope_theta)
        v = linear(b["wv"], a).reshape(B, L, H, dh)
        o = flash_attention(q, k, v, causal=True, q_chunk=cfg.attn_q_chunk,
                            k_chunk=cfg.attn_k_chunk, scale=(dh / 2) ** -0.5)
        m = rmsnorm(b["mlp_norm"], linear(b["wo"], o.reshape(B, L, H * dh)), cfg.norm_eps)
        gu = linear(b["w_gate_up"], m) + linear(ad["up"], linear(ad["down"], m))
        g, u = gu.chunk(2, dim=-1)
        t = linear(b["w_down"], F.gelu(g.float()).to(g.dtype) * u)
        shared_block.calls += 1
        return linear(_layer(params["site_linear"], i), t)


shared_block.calls = 0


def _forward(cfg: Zamba2Config, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """The residual stream after the last layer, ``[B, L, D]``."""
    B, L = tokens.shape
    e = embed(params["embed"], tokens)
    positions = torch.arange(L, device=tokens.device).expand(B, L)
    site = {l: i for i, l in enumerate(cfg.hybrid_layer_ids)}
    h = e
    for l, p in enumerate(_layers(params["mamba_blocks"])):
        t = shared_block(cfg, params, site[l], h, e, positions) if l in site else None
        h = mamba_block_apply(cfg, p, h, t)
    return h


def zamba2_prefill(cfg: Zamba2Config, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Forward over ``tokens [B, L]`` -> last-position logits [B, vocab] (f32).
    The final norm is per position, so only the last one is normed."""
    h = _forward(cfg, params, tokens)
    h = rmsnorm(params["final_norm"], h[:, -1], cfg.norm_eps)
    return (h @ params["embed"]["emb"].T).float()


def zamba2_loss(cfg: Zamba2Config, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token cross-entropy through the tied head."""
    h = rmsnorm(params["final_norm"], _forward(cfg, params, batch["tokens"]), cfg.norm_eps)
    return chunked_softmax_xent(h, params["embed"]["emb"].T, batch["labels"],
                                chunk=cfg.logits_chunk)


def zamba2_init_cache(cfg, batch, max_len, device):
    raise NotImplementedError(NO_DECODE)


def zamba2_decode_step(cfg, params, token, cache, pos):
    raise NotImplementedError(NO_DECODE)


def zamba2_param_specs(cfg, mode="train"):
    raise NotImplementedError(NO_SPECS)


def zamba2_cache_specs(cfg, seq_shard=False):
    raise NotImplementedError(NO_SPECS)
