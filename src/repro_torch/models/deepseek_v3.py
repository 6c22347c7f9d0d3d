"""DeepSeek-V3 as released: latent attention (MLA) and group-limited sigmoid-routed experts.

DeepSeek-V3 (arXiv:2412.19437; the layer equations of the release's
``modeling_deepseek.py``).  Every layer is two pre-norm residual blocks:

    h = h + mla(rmsnorm(h))
    h = h + ffn(rmsnorm(h))

* ``mla``, multi-head latent attention (:func:`mla`), over x [B, L, D]:

      q             = W_qb rmsnorm(W_qa x)             [H, nope + rope]
      [c_kv | k_pe] = W_kva x                          c_kv [kv_lora], k_pe [rope]
      [k_nope | v]  = W_kvb rmsnorm(c_kv)              [H, nope + v]
      q_pe, k_pe    = rope(q_pe), rope(k_pe)           k_pe one for all heads
      o             = softmax((q k^T) scale, causal) v, q = [q_nope | q_pe],
                      k = [k_nope | k_pe]
      out           = W_o o

  The rope dims use YaRN's blended inverse frequencies
  (``common.yarn_rope_freqs``; mscale / mscale_all_dim = 1 on cos and sin)
  in the release's interleaved layout (:func:`rope_interleaved`), and the
  softmax scale is (nope + rope)^-1/2 times ``yarn_mscale(factor,
  mscale_all_dim)`` squared (:func:`softmax_scale`).  Attention goes
  through ``common.flash_attention`` with q and k of nope + rope = 192 dims
  and v of 128: a bf16 CUDA call with grad off takes the Hopper kernel at
  (192, 128), v a strided view of W_kvb's output;
* ``ffn``: the first ``first_k_dense`` layers a dense SwiGLU MLP of
  ``d_ff`` (``moe_dropless.swiglu`` over ``[W_g | W_u]``); the others
  ``moe_dropless.moe_apply``: a float32 sigmoid router over ``n_experts``
  with the correction bias for selection only, ``n_group`` groups of which
  the ``topk_group`` best are kept, top ``experts_per_token``, the weights
  normalised and times ``routed_scaling_factor``; SwiGLU experts of
  ``moe_d_ff`` and one shared SwiGLU expert of ``moe_shared_d_ff``.  The
  layer holds the experts ``expert_offset`` to ``expert_offset +
  n_experts_held - 1`` (all of them at the published size; one card's share
  of an expert-parallel deployment in the benchmark), routes over all of
  them and computes its own experts' part.

Then the final norm and the untied head at the last position.  The JAX
package has no such family, so it lives in the port alone, as
``models/nemotron_h.py`` does (:class:`DeepSeekV3Config`,
``configs.deepseek_v3``, found by ``configs.port_only``).

Leaves are stacked: ``mla`` ``[n_layers, ...]`` (each layer's attention
and its pre-norm), ``dense`` ``[first_k_dense, ...]`` and ``moe`` ``[n_layers
- first_k_dense, ...]`` (each layer's feed-forward and its pre-norm; the
routed experts' ``w_gate_up [n, D, 2F]`` and ``w_down [n, F, D]`` of the
held experts).  Spans: ``mla.attention`` around a whole MLA block, inside it
``mla.q_proj`` and ``mla.kv_proj`` (the low-rank projections, their norms,
the rope and the k / v assembly), ``deepseek.dense_mlp`` and
``deepseek.moe`` around a whole feed-forward block.  Counter: ``mla.calls``
(MLA blocks, on the host).  There is no loss, no decode and there are no
sharding specs: those entry points raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Tuple

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
    yarn_mscale,
    yarn_rope_freqs,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import _layer, _stack
from repro_torch.spans import span

Params = Dict[str, Any]

NO_LOSS = ("deepseek_v3 has no training loss: the benchmark prefills one card's expert-parallel "
           "share, and training needs several cards")
NO_DECODE = ("deepseek_v3 has no decode: its decode cell waits for an absorbed-MLA decode kernel "
             "and CUDA graphs")
NO_SPECS = ("deepseek_v3 has no sharding specs: the port runs one card's share of it, and the JAX "
            "package, whose spec trees the port keeps, has no deepseek_v3 family")


@dataclasses.dataclass(frozen=True)
class DeepSeekV3Config(ModelConfig):
    """``ModelConfig`` with DeepSeek-V3's own keys.  ``head_dim`` is q's and
    k's (``qk_nope_dim + qk_rope_dim``), ``n_kv_heads`` is ``n_heads`` (MLA
    gives each head its own k and v), ``d_ff`` the dense layers' width and
    ``n_experts`` the router's width; the layer holds ``n_experts_held``
    experts from ``expert_offset``.  ``rope_theta`` is the rope dims' base,
    and the ``rope_*`` keys are the release's ``rope_scaling`` (YaRN)."""
    first_k_dense: int = 3
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    moe_shared_d_ff: int = 2048
    routed_scaling_factor: float = 2.5
    n_group: int = 8
    topk_group: int = 4
    expert_offset: int = 0
    n_experts_held: int = 256
    rope_factor: float = 40.0
    rope_original_max: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 1.0
    rope_mscale_all_dim: float = 1.0

    def reduced(self, **overrides) -> "DeepSeekV3Config":
        """``ModelConfig.reduced`` with one dense and one MoE layer, heads
        of 16 + 16 (q, k) and 32 (v), which the flash kernel takes, and 16
        experts in 4 groups, all held."""
        base = dict(n_layers=2, first_k_dense=1, n_heads=4, n_kv_heads=4, head_dim=32,
                    qk_nope_dim=16, qk_rope_dim=16, v_head_dim=32, q_lora_rank=32,
                    kv_lora_rank=16, n_experts=16, n_experts_held=16, experts_per_token=4,
                    n_group=4, topk_group=2, moe_shared_d_ff=64, rope_original_max=64)
        base.update(overrides)
        return super().reduced(**base)


def check_config(cfg: DeepSeekV3Config) -> None:
    """Raise where ``cfg`` is not a DeepSeek-V3 this module computes."""
    problems = [
        (cfg.head_dim != cfg.qk_nope_dim + cfg.qk_rope_dim,
         f"head_dim {cfg.head_dim} is not qk_nope_dim + qk_rope_dim"),
        (cfg.n_kv_heads != cfg.n_heads, "MLA gives every head its own k and v"),
        (cfg.qk_rope_dim % 2, f"qk_rope_dim {cfg.qk_rope_dim} is odd"),
        (not 0 <= cfg.first_k_dense <= cfg.n_layers,
         f"{cfg.first_k_dense} dense layers of {cfg.n_layers}"),
        (cfg.n_experts % cfg.n_group or cfg.n_experts // cfg.n_group < 2,
         f"{cfg.n_experts} experts in {cfg.n_group} groups of at least two"),
        (not 0 < cfg.topk_group <= cfg.n_group, f"top {cfg.topk_group} of {cfg.n_group} groups"),
        (not 0 < cfg.experts_per_token <= cfg.n_experts * cfg.topk_group // cfg.n_group,
         f"top {cfg.experts_per_token} of the kept groups' experts"),
        (not 0 <= cfg.expert_offset <= cfg.expert_offset + cfg.n_experts_held <= cfg.n_experts
         or cfg.n_experts_held < 1,
         f"experts {cfg.expert_offset} to {cfg.expert_offset + cfg.n_experts_held - 1} held of "
         f"{cfg.n_experts}"),
        (cfg.tie_embeddings, "the head is untied"),
    ]
    bad = [msg for failed, msg in problems if failed]
    if bad:
        raise ValueError(f"{cfg.name}: " + "; ".join(bad))


def init_deepseek_v3_model(gen: torch.Generator, cfg: DeepSeekV3Config) -> Params:
    """Weights drawn from ``gen`` on its device at the port's scales: N(0,
    0.02) projections, the output projections (W_o, the dense, routed and
    shared down projections) scaled by 1/sqrt(2 n_layers), the router N(0,
    0.02) and its correction bias N(0, 0.01) in float32, norm scales one."""
    check_config(cfg)
    dtype, dev = dtype_of(cfg.dtype), gen.device
    D, H = cfg.d_model, cfg.n_heads
    out = 0.02 / max(1, 2 * cfg.n_layers) ** 0.5

    def normal(shape, std, dt=dtype):
        return (torch.randn(shape, generator=gen, dtype=torch.float32, device=dev) * std).to(dt)

    def mla_layer() -> Params:
        return {"norm": init_rmsnorm(D, dev),
                "q_a": init_linear(gen, D, cfg.q_lora_rank, dtype),
                "q_norm": init_rmsnorm(cfg.q_lora_rank, dev),
                "q_b": init_linear(gen, cfg.q_lora_rank, H * cfg.head_dim, dtype),
                "kv_a": init_linear(gen, D, cfg.kv_lora_rank + cfg.qk_rope_dim, dtype),
                "kv_norm": init_rmsnorm(cfg.kv_lora_rank, dev),
                "kv_b": init_linear(gen, cfg.kv_lora_rank, H * (cfg.qk_nope_dim + cfg.v_head_dim),
                                    dtype),
                "o": init_linear(gen, H * cfg.v_head_dim, D, dtype, scale=out)}

    def dense_layer() -> Params:
        return {"norm": init_rmsnorm(D, dev),
                "gate_up": init_linear(gen, D, 2 * cfg.d_ff, dtype),
                "down": init_linear(gen, cfg.d_ff, D, dtype, scale=out)}

    def moe_layer() -> Params:
        n, F_, Fs = cfg.n_experts_held, cfg.moe_d_ff, cfg.moe_shared_d_ff
        return {"norm": init_rmsnorm(D, dev),
                "router": {"w": normal((D, cfg.n_experts), 0.02, torch.float32)},
                "e_bias": normal((cfg.n_experts,), 0.01, torch.float32),
                "w_gate_up": normal((n, D, 2 * F_), 0.02),
                "w_down": normal((n, F_, D), out),
                "shared_gate_up": init_linear(gen, D, 2 * Fs, dtype),
                "shared_down": init_linear(gen, Fs, D, dtype, scale=out)}

    n_dense = cfg.first_k_dense
    params = {"embed": init_embedding(gen, cfg.vocab_size, D, dtype),
              "mla": _stack([mla_layer() for _ in range(cfg.n_layers)])}
    if n_dense:
        params["dense"] = _stack([dense_layer() for _ in range(n_dense)])
    if cfg.n_layers > n_dense:
        params["moe"] = _stack([moe_layer() for _ in range(cfg.n_layers - n_dense)])
    params["final_norm"] = init_rmsnorm(D, dev)
    params["head"] = init_linear(gen, D, cfg.vocab_size, dtype)
    return params


def softmax_scale(cfg: DeepSeekV3Config) -> float:
    """(nope + rope)^-1/2 times YaRN's mscale squared (the release's
    ``softmax_scale`` with ``mscale_all_dim``)."""
    m = yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim)
    return cfg.head_dim ** -0.5 * m * m


def rope_tables(cfg: DeepSeekV3Config, L: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin [L, rope/2] (float32) of positions 0..L-1 at YaRN's
    frequencies, times mscale / mscale_all_dim (the release's ``_mscale``)."""
    inv = yarn_rope_freqs(cfg.qk_rope_dim, cfg.rope_theta, cfg.rope_factor,
                          cfg.rope_original_max, cfg.rope_beta_fast, cfg.rope_beta_slow, device)
    ang = torch.arange(L, dtype=torch.float32, device=device)[:, None] * inv
    m = (yarn_mscale(cfg.rope_factor, cfg.rope_mscale)
         / yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim))
    return torch.cos(ang) * m, torch.sin(ang) * m


def rope_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The release's rope on ``x [B, L, h, r]``: the pairs ``(x_2i, x_2i+1)``
    de-interleaved to ``[x_even | x_odd]`` and rotated by ``cos, sin [L,
    r/2]`` (``x cos + rotate_half(x) sin``), in float32, cast to x's dtype;
    the output keeps the de-interleaved layout, as the release's does."""
    xf = x.float()
    ev, od = xf[..., 0::2], xf[..., 1::2]
    c, s = cos[:, None], sin[:, None]
    return torch.cat([ev * c - od * s, od * c + ev * s], dim=-1).to(x.dtype)


def q_proj(cfg: DeepSeekV3Config, p: Params, x: torch.Tensor, cos, sin) -> torch.Tensor:
    """q ``[B, L, H, nope + rope]`` of the normed x: the low-rank pair, its
    norm, and the rope on the rope dims; span ``mla.q_proj``."""
    B, L, _ = x.shape
    with span("mla.q_proj"):
        q = linear(p["q_b"], rmsnorm(p["q_norm"], linear(p["q_a"], x), cfg.norm_eps))
        q = q.reshape(B, L, cfg.n_heads, cfg.head_dim)
        q[..., cfg.qk_nope_dim:] = rope_interleaved(q[..., cfg.qk_nope_dim:], cos, sin)
    return q


def kv_proj(cfg: DeepSeekV3Config, p: Params, x: torch.Tensor, cos,
            sin) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(k [B, L, H, nope + rope], v [B, L, H, v])`` of the normed x: c_kv
    and the shared k_pe from W_kva, c_kv's norm, W_kvb, the rope on k_pe
    and k assembled with k_pe broadcast over the heads; v a view of W_kvb's
    output; span ``mla.kv_proj``."""
    B, L, _ = x.shape
    H, nope = cfg.n_heads, cfg.qk_nope_dim
    with span("mla.kv_proj"):
        c_kv, k_pe = torch.split(linear(p["kv_a"], x), [cfg.kv_lora_rank, cfg.qk_rope_dim], -1)
        kv = linear(p["kv_b"], rmsnorm(p["kv_norm"], c_kv, cfg.norm_eps))
        kv = kv.reshape(B, L, H, nope + cfg.v_head_dim)
        k_pe = rope_interleaved(k_pe.reshape(B, L, 1, cfg.qk_rope_dim), cos, sin)
        k = torch.cat([kv[..., :nope], k_pe.expand(B, L, H, cfg.qk_rope_dim)], dim=-1)
    return k, kv[..., nope:]


def mla(cfg: DeepSeekV3Config, p: Params, h: torch.Tensor) -> torch.Tensor:
    """``h + mla(rmsnorm(h))`` over ``h [B, L, D]``; span ``mla.attention``,
    counted in ``mla.calls``."""
    B, L, _ = h.shape
    with span("mla.attention"):
        x = rmsnorm(p["norm"], h, cfg.norm_eps)
        cos, sin = rope_tables(cfg, L, h.device)
        q = q_proj(cfg, p, x, cos, sin)
        k, v = kv_proj(cfg, p, x, cos, sin)
        o = flash_attention(q, k, v, causal=True, q_chunk=cfg.attn_q_chunk,
                            k_chunk=cfg.attn_k_chunk, scale=softmax_scale(cfg))
        out = h + linear(p["o"], o.reshape(B, L, cfg.n_heads * cfg.v_head_dim))
    mla.calls += 1
    return out


mla.calls = 0


def dense_mlp(cfg: DeepSeekV3Config, p: Params, h: torch.Tensor) -> torch.Tensor:
    """``h + W_down swiglu(rmsnorm(h) [W_g | W_u])``; span ``deepseek.dense_mlp``."""
    with span("deepseek.dense_mlp"):
        x = rmsnorm(p["norm"], h, cfg.norm_eps)
        return h + linear(p["down"], moe_dropless.swiglu(linear(p["gate_up"], x)))


def moe_layer_apply(cfg: DeepSeekV3Config, p: Params, h: torch.Tensor,
                    routes: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """``h + moe(rmsnorm(h))``: the held experts' part and the shared
    expert; span ``deepseek.moe``."""
    with span("deepseek.moe"):
        return h + moe_dropless.moe_apply(cfg, p, rmsnorm(p["norm"], h, cfg.norm_eps), routes)


def layers(cfg: DeepSeekV3Config, params: Params) -> Iterator[Tuple[str, Params, Params]]:
    """``(kind, attention weights, feed-forward weights)`` of every layer in
    order (views); kind ``"dense"`` or ``"moe"``."""
    for l in range(cfg.n_layers):
        kind, i = ("dense", l) if l < cfg.first_k_dense else ("moe", l - cfg.first_k_dense)
        yield kind, _layer(params["mla"], l), _layer(params[kind], i)


def layer_apply(cfg: DeepSeekV3Config, kind: str, pa: Params, pf: Params, h: torch.Tensor,
                routes: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """One layer: MLA, then the dense MLP or the MoE (which appends its
    expert ids to ``routes`` where it is a list)."""
    h = mla(cfg, pa, h)
    if kind == "dense":
        return dense_mlp(cfg, pf, h)
    if kind == "moe":
        return moe_layer_apply(cfg, pf, h, routes)
    raise ValueError(kind)


def final_logits(cfg: DeepSeekV3Config, params: Params, h: torch.Tensor) -> torch.Tensor:
    """The last position's logits [B, vocab] (f32): the final norm, then the head."""
    return linear(params["head"], rmsnorm(params["final_norm"], h[:, -1], cfg.norm_eps)).float()


def deepseek_v3_prefill(cfg: DeepSeekV3Config, params: Params, tokens: torch.Tensor,
                        routes: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """Forward over ``tokens [B, L]`` -> last-position logits [B, vocab]
    (f32); ``routes`` (a list) receives each MoE layer's expert ids."""
    h = embed(params["embed"], tokens)
    for kind, pa, pf in layers(cfg, params):
        h = layer_apply(cfg, kind, pa, pf, h, routes)
    return final_logits(cfg, params, h)


def deepseek_v3_loss(cfg, params, batch):
    raise NotImplementedError(NO_LOSS)


def deepseek_v3_init_cache(cfg, batch, max_len, device):
    raise NotImplementedError(NO_DECODE)


def deepseek_v3_decode_step(cfg, params, token, cache, pos):
    raise NotImplementedError(NO_DECODE)


def deepseek_v3_param_specs(cfg, mode="train"):
    raise NotImplementedError(NO_SPECS)


def deepseek_v3_cache_specs(cfg, seq_shard=False):
    raise NotImplementedError(NO_SPECS)
