"""Unified model API of the torch port: family dispatch + the shape table.

Port of the JAX package's ``models/model_api.py``.  ``build_model(cfg,
device)`` returns a :class:`Model` bundle for every family of the
registry (dense, moe, ssm, hybrid, encdec, vlm) and for the port-only
zamba2, nemotron_h and deepseek_v3 (``configs.port_only``; no decode, no
sharding specs; nemotron_h and deepseek_v3 no loss), with the entry points
the trainer and the serving loop share:

  init(generator) -> params                  (weights drawn on the generator's device)
  loss(params, batch) -> scalar              (training objective, f32)
  prefill(params, batch) -> logits           (last-position logits, f32)
  init_cache(batch, max_len) -> cache
  decode_step(params, token, cache, pos) -> (logits, cache)   (cache updated in place)
  param_specs(mode) / cache_specs(seq_shard) / batch_specs(kind)
  input_specs(shape) -> ``meta`` tensors (no allocation)

``prefill`` takes ``batch["tokens"]``, and ``batch["frames"]`` (encdec:
the stub frontend's frame embeddings) or ``batch["patch_embeds"]`` (vlm,
optional: the stub vision tower's patch embeddings), as the JAX
``Model.prefill`` does; ``loss`` takes the same and ``batch["labels"]``
(vlm: ``patch_embeds`` required), as ``data.pipeline.synth_batch`` draws
them.  ``SHAPES`` / :class:`ShapeSpec` are the JAX package's shape kinds,
as data.  The sharding specs (``param_specs``, ``cache_specs``,
``batch_specs``) are the reference's trees as data
(``repro_torch.launch.mesh.PartitionSpec`` leaves), keyed as the port's
trees; ``input_specs`` gives a shape's inputs as ``meta`` tensors, where
the reference gives ``ShapeDtypeStruct`` stand-ins, for the dry run
(``repro_torch.launch.dryrun``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import AX_DATA
from repro_torch.launch.mesh import PartitionSpec as P
from repro_torch.models import (deepseek_v3, hybrid, mamba2, moe, nemotron_h, transformer, vlm,
                                whisper, zamba2)
from repro_torch.models.common import dtype_of
from repro_torch.models.config import ModelConfig
from repro_torch.spans import span

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


def shape_spec(shape: Union[str, ShapeSpec]) -> ShapeSpec:
    """A shape kind of :data:`SHAPES` by name, or a :class:`ShapeSpec` as it is."""
    return shape if isinstance(shape, ShapeSpec) else SHAPES[shape]


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable[[torch.Generator], Params]
    loss: Callable[[Params, Dict[str, torch.Tensor]], torch.Tensor]
    init_cache: Callable[[int, int], Params]
    decode_step: Callable[..., Tuple[torch.Tensor, Params]]
    param_specs: Callable[[str], Params]
    cache_specs: Callable[[bool], Params]

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Forward over ``batch["tokens"] [B, L]`` (after ``batch["frames"]``'s
        encoder for encdec, after ``batch["patch_embeds"]`` for vlm) ->
        last-position logits ``[B, vocab]`` (f32).  Attention runs through
        ``flash_attention``, every Mamba block's SSD scan through
        ``kernels.ssd_scan.ops.ssd_scan``; span ``model.prefill``."""
        with span("model.prefill"):
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
            if fam == "zamba2":
                return zamba2.zamba2_prefill(cfg, params, tokens)
            if fam == "nemotron_h":
                return nemotron_h.nemotron_h_prefill(cfg, params, tokens)
            if fam == "deepseek_v3":
                return deepseek_v3.deepseek_v3_prefill(cfg, params, tokens)
            if fam == "encdec":
                return whisper.encdec_prefill(cfg, params, batch["frames"], tokens)
            raise ValueError(fam)

    # ---- meta stand-ins (no allocation) -------------------------------------
    def input_specs(self, shape_name: Union[str, ShapeSpec]) -> Dict[str, Any]:
        """The inputs of ``shape_name``'s step (a :data:`SHAPES` name or a
        :class:`ShapeSpec`) as ``meta`` tensors.  The
        decode step's ``pos`` is a Python int, as the port's decode steps
        take it: the cache's last position, so the step attends over all
        ``seq_len`` positions."""
        cfg = self.cfg
        sh = shape_spec(shape_name)
        B, L = sh.global_batch, sh.seq_len
        meta = torch.device("meta")
        tok = torch.empty((B, L), dtype=torch.int32, device=meta)
        dt = dtype_of(cfg.dtype)
        if sh.kind in ("train", "prefill"):
            batch = {"tokens": tok, "labels": torch.empty((B, L), dtype=torch.int32, device=meta)}
            if cfg.family == "encdec":
                batch["frames"] = torch.empty((B, cfg.encoder_seq, cfg.d_model), dtype=dt,
                                              device=meta)
            if cfg.family == "vlm":
                batch["patch_embeds"] = torch.empty((B, cfg.n_patches, cfg.d_model), dtype=dt,
                                                    device=meta)
            if sh.kind == "prefill":
                batch.pop("labels")
            return batch
        # decode: one token step against a seq_len cache
        cache = FAMILIES[cfg.family][2](cfg, B, L, meta)
        return {
            "token": torch.empty((B,), dtype=torch.int32, device=meta),
            "cache": cache,
            "pos": L - 1,
        }

    def batch_specs(self, shape_name: Union[str, ShapeSpec]) -> Dict[str, Any]:
        """Input shardings matching input_specs."""
        cfg = self.cfg
        sh = shape_spec(shape_name)
        data = P(("data", "model") if cfg.fsdp_all_axes else AX_DATA, None)
        if sh.kind in ("train", "prefill"):
            specs = {"tokens": data}
            if sh.kind == "train":
                specs["labels"] = data
            if cfg.family == "encdec":
                specs["frames"] = P(AX_DATA, None, None)
            if cfg.family == "vlm":
                specs["patch_embeds"] = P(AX_DATA, None, None)
            return specs
        seq_shard = sh.global_batch == 1
        return {
            "token": P(None) if seq_shard else P(AX_DATA),
            "cache": self.cache_specs(seq_shard),
            "pos": P(),
        }


#: family -> (init, loss, init_cache, decode_step, param_specs, cache_specs) of its module
FAMILIES = {
    "dense": (transformer.init_dense_model, transformer.dense_loss,
              transformer.dense_init_cache, transformer.dense_decode_step,
              transformer.dense_param_specs, transformer.dense_cache_specs),
    "vlm": (vlm.init_vlm_model, vlm.vlm_loss, vlm.vlm_init_cache, vlm.vlm_decode_step,
            vlm.vlm_param_specs, vlm.vlm_cache_specs),
    "moe": (moe.init_moe_model, moe.moe_loss, moe.moe_init_cache, moe.moe_decode_step,
            moe.moe_param_specs, moe.moe_cache_specs),
    "ssm": (mamba2.init_ssm_model, mamba2.ssm_loss, mamba2.ssm_init_cache,
            mamba2.ssm_decode_step, mamba2.ssm_param_specs, mamba2.ssm_cache_specs),
    "hybrid": (hybrid.init_hybrid_model, hybrid.hybrid_loss, hybrid.hybrid_init_cache,
               hybrid.hybrid_decode_step, hybrid.hybrid_param_specs, hybrid.hybrid_cache_specs),
    "encdec": (whisper.init_encdec_model, whisper.encdec_loss, whisper.encdec_init_cache,
               whisper.encdec_decode_step, whisper.encdec_param_specs,
               whisper.encdec_cache_specs),
    "zamba2": (zamba2.init_zamba2_model, zamba2.zamba2_loss, zamba2.zamba2_init_cache,
               zamba2.zamba2_decode_step, zamba2.zamba2_param_specs, zamba2.zamba2_cache_specs),
    "nemotron_h": (nemotron_h.init_nemotron_h_model, nemotron_h.nemotron_h_loss,
                   nemotron_h.nemotron_h_init_cache, nemotron_h.nemotron_h_decode_step,
                   nemotron_h.nemotron_h_param_specs, nemotron_h.nemotron_h_cache_specs),
    "deepseek_v3": (deepseek_v3.init_deepseek_v3_model, deepseek_v3.deepseek_v3_loss,
                    deepseek_v3.deepseek_v3_init_cache, deepseek_v3.deepseek_v3_decode_step,
                    deepseek_v3.deepseek_v3_param_specs, deepseek_v3.deepseek_v3_cache_specs),
}


def build_model(cfg: ModelConfig, device: Union[str, torch.device, None] = None) -> Model:
    """The model bundle on ``device`` (the CUDA card when None)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family '{cfg.family}'")
    init, loss, init_cache, decode_step, param_specs, cache_specs = FAMILIES[cfg.family]
    dev = resolve_device(device)
    return Model(
        cfg,
        dev,
        init=lambda gen: init(gen, cfg),
        loss=lambda p, b: loss(cfg, p, b),
        init_cache=lambda B, L: init_cache(cfg, B, L, dev),
        decode_step=lambda p, t, c, pos: decode_step(cfg, p, t, c, pos),
        param_specs=lambda mode="train": param_specs(cfg, mode),
        cache_specs=lambda seq_shard=False: cache_specs(cfg, seq_shard),
    )
