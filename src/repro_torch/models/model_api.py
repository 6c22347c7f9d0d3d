"""Unified model API of the torch port: family dispatch + the shape table.

Port of the JAX package's ``models/model_api.py``.  ``build_model(cfg,
device)`` returns a :class:`Model` bundle for every family of the
registry (dense, moe, ssm, hybrid, encdec, vlm), with the entry points
the trainer and the serving loop share:

  init(generator) -> params                  (weights drawn on the generator's device)
  loss(params, batch) -> scalar              (training objective, f32)
  prefill(params, batch) -> logits           (last-position logits, f32)
  init_cache(batch, max_len) -> cache
  decode_step(params, token, cache, pos) -> (logits, cache)   (cache updated in place)

``prefill`` takes ``batch["tokens"]``, and ``batch["frames"]`` (encdec:
the stub frontend's frame embeddings) or ``batch["patch_embeds"]`` (vlm,
optional: the stub vision tower's patch embeddings), as the JAX
``Model.prefill`` does; ``loss`` takes the same and ``batch["labels"]``
(vlm: ``patch_embeds`` required), as ``data.pipeline.synth_batch`` draws
them.  ``SHAPES`` / :class:`ShapeSpec` are the JAX package's shape kinds,
as data.  The sharding specs (``param_specs``, ``cache_specs``,
``input_specs``, ``batch_specs``) wait for the mesh tooling.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.models import hybrid, mamba2, moe, transformer, vlm, whisper
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


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable[[torch.Generator], Params]
    loss: Callable[[Params, Dict[str, torch.Tensor]], torch.Tensor]
    init_cache: Callable[[int, int], Params]
    decode_step: Callable[..., Tuple[torch.Tensor, Params]]

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Forward over ``batch["tokens"] [B, L]`` (after ``batch["frames"]``'s
        encoder for encdec, after ``batch["patch_embeds"]`` for vlm) ->
        last-position logits ``[B, vocab]`` (f32).  Attention runs through
        ``flash_attention``, every Mamba block's SSD scan through
        ``kernels.ssd_scan.ops.ssd_scan``."""
        cfg, fam, tokens = self.cfg, self.cfg.family, batch["tokens"]
        if fam == "dense":
            return transformer.dense_prefill(cfg, params, tokens)
        if fam == "vlm":
            return vlm.vlm_prefill(cfg, params, tokens, batch.get("patch_embeds"))
        if fam == "moe":
            return moe.moe_prefill(cfg, params, tokens)
        if fam == "ssm":
            return mamba2.ssm_prefill(cfg, params, tokens)
        if fam == "hybrid":
            return hybrid.hybrid_prefill(cfg, params, tokens)
        if fam == "encdec":
            return whisper.encdec_prefill(cfg, params, batch["frames"], tokens)
        raise ValueError(fam)


#: family -> (init, loss, init_cache, decode_step) of its module
FAMILIES = {
    "dense": (transformer.init_dense_model, transformer.dense_loss,
              transformer.dense_init_cache, transformer.dense_decode_step),
    "vlm": (vlm.init_vlm_model, vlm.vlm_loss, vlm.vlm_init_cache, vlm.vlm_decode_step),
    "moe": (moe.init_moe_model, moe.moe_loss, moe.moe_init_cache, moe.moe_decode_step),
    "ssm": (mamba2.init_ssm_model, mamba2.ssm_loss, mamba2.ssm_init_cache,
            mamba2.ssm_decode_step),
    "hybrid": (hybrid.init_hybrid_model, hybrid.hybrid_loss, hybrid.hybrid_init_cache,
               hybrid.hybrid_decode_step),
    "encdec": (whisper.init_encdec_model, whisper.encdec_loss, whisper.encdec_init_cache,
               whisper.encdec_decode_step),
}


def build_model(cfg: ModelConfig, device: Union[str, torch.device, None] = None) -> Model:
    """The model bundle on ``device`` (the CUDA card when None)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family '{cfg.family}'")
    init, loss, init_cache, decode_step = FAMILIES[cfg.family]
    dev = resolve_device(device)
    return Model(
        cfg,
        dev,
        init=lambda gen: init(gen, cfg),
        loss=lambda p, b: loss(cfg, p, b),
        init_cache=lambda B, L: init_cache(cfg, B, L, dev),
        decode_step=lambda p, t, c, pos: decode_step(cfg, p, t, c, pos),
    )
