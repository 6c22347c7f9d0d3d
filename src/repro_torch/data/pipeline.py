"""Deterministic synthetic data pipeline.

Port of the JAX package's ``data/pipeline.py``.  :class:`DataConfig`,
``_rng_for_step`` and :func:`synth_batch` are its numpy code as it is, so
that both packages draw equal batches for every ``(seed, step)``:
reproducible token streams (and stub frame / patch embeddings for the
audio and VLM families), a pure function of ``(seed, step)``, so that a
restarted run regenerates the same data.  :class:`Pipeline` keeps the
reference's prefetch of the next batch and yields tensors on its device:
float arrays cast to bf16 when the model's dtype is bf16 (else f32),
integer arrays as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 1234
    # multi-host slicing: this process serves rows [row_start, row_end)
    row_start: int = 0
    row_end: Optional[int] = None


def _rng_for_step(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def synth_batch(cfg: ModelConfig, dcfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Markov-ish synthetic tokens: learnable short-range structure so a
    few hundred training steps show a real loss decrease."""
    rng = _rng_for_step(dcfg.seed, step)
    B, L, V = dcfg.global_batch, dcfg.seq_len, cfg.vocab_size
    base = rng.integers(0, V, size=(B, 1), dtype=np.int64)
    drift = rng.integers(0, 17, size=(B, L), dtype=np.int64)
    tokens = (base + np.cumsum(drift, axis=1)) % V
    tokens = tokens.astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = tokens[:, 0]
    out: Dict[str, np.ndarray] = {"tokens": tokens, "labels": labels}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal((B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    row_end = dcfg.row_end if dcfg.row_end is not None else B
    return {k: v[dcfg.row_start : row_end] for k, v in out.items()}


class Pipeline:
    """Prefetching iterator over synth batches, as tensors on ``device``
    (the CUDA card when None)."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig, start_step: int = 0,
                 device: Union[str, torch.device, None] = None):
        self.cfg, self.dcfg = cfg, dcfg
        self.step = start_step
        self.device = resolve_device(device)
        self._next = self._make(self.step)

    def _make(self, step: int) -> Dict[str, torch.Tensor]:
        host = synth_batch(self.cfg, self.dcfg, step)
        dtype = torch.bfloat16 if self.cfg.dtype == "bfloat16" else torch.float32
        dev = {}
        for k, v in host.items():
            t = torch.from_numpy(v)
            dev[k] = t.to(self.device, dtype) if v.dtype == np.float32 else t.to(self.device)
        return dev

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        batch = self._next
        self.step += 1
        self._next = self._make(self.step)  # prefetch while the caller computes
        return batch
