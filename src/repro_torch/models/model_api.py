"""Unified model API of the torch port: family dispatch + the shape table.

Port of the JAX package's ``models/model_api.py`` for serving.
``build_model(cfg, device)`` returns a :class:`Model` bundle:

  init(generator) -> params                  (weights drawn on the generator's device)
  prefill(params, batch) -> logits           (last-position logits, f32)
  init_cache(batch, max_len) -> cache
  decode_step(params, token, cache, pos) -> (logits, cache)   (cache updated in place)

``SHAPES`` / :class:`ShapeSpec` are the JAX package's shape kinds, as data.
The dense, ssm and hybrid families are ported, prefill and decode; the
other families, ``loss`` and the sharding specs (``param_specs``,
``cache_specs``, ``input_specs``, ``batch_specs``) come with later
slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.models import hybrid, mamba2, transformer
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

#: families not ported yet -> the ROADMAP item that ports them
NOT_PORTED = {
    "moe": "ROADMAP A6 (remaining model families: moe)",
    "encdec": "ROADMAP A6 (remaining model families: encdec)",
    "vlm": "ROADMAP A6 (remaining model families: vlm, its prefill with the patch embeddings)",
}


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable[[torch.Generator], Params]
    init_cache: Callable[[int, int], Params]
    decode_step: Callable[..., Tuple[torch.Tensor, Params]]

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Forward over ``batch["tokens"] [B, L]`` -> last-position logits
        ``[B, vocab]`` (f32).  Attention runs through ``flash_attention``,
        every Mamba block's SSD scan through ``kernels.ssd_scan.ops.ssd_scan``."""
        fam, tokens = self.cfg.family, batch["tokens"]
        if fam == "dense":
            return transformer.dense_prefill(self.cfg, params, tokens)
        if fam == "ssm":
            return mamba2.ssm_prefill(self.cfg, params, tokens)
        if fam == "hybrid":
            return hybrid.hybrid_prefill(self.cfg, params, tokens)
        raise ValueError(fam)


def build_model(cfg: ModelConfig, device: Union[str, torch.device, None] = None) -> Model:
    """The model bundle on ``device`` (the CUDA card when None)."""
    fam = cfg.family
    if fam in NOT_PORTED:
        raise NotImplementedError(
            f"family '{fam}' ({cfg.name}) is not ported to torch yet: {NOT_PORTED[fam]}"
        )
    if fam not in ("dense", "ssm", "hybrid"):
        raise ValueError(f"unknown family '{fam}'")
    dev = resolve_device(device)
    if fam == "hybrid":
        return Model(
            cfg,
            dev,
            init=lambda gen: hybrid.init_hybrid_model(gen, cfg),
            init_cache=lambda B, L: hybrid.hybrid_init_cache(cfg, B, L, dev),
            decode_step=lambda p, t, c, pos: hybrid.hybrid_decode_step(cfg, p, t, c, pos),
        )
    if fam == "ssm":
        return Model(
            cfg,
            dev,
            init=lambda gen: mamba2.init_ssm_model(gen, cfg),
            init_cache=lambda B, L: mamba2.ssm_init_cache(cfg, B, L, dev),
            decode_step=lambda p, t, c, pos: mamba2.ssm_decode_step(cfg, p, t, c, pos),
        )
    return Model(
        cfg,
        dev,
        init=lambda gen: transformer.init_dense_model(gen, cfg),
        init_cache=lambda B, L: transformer.dense_init_cache(cfg, B, L, dev),
        decode_step=lambda p, t, c, pos: transformer.dense_decode_step(cfg, p, t, c, pos),
    )
