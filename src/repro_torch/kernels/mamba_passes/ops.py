"""Public wrapper of the Mamba block's passes: the plain passes or the kernels.

``models.mamba2.mamba_block_apply`` calls :func:`mamba_passes`, which
routes by ``repro_torch.device``'s rule: the plain passes
(:func:`.ref.mamba_passes`) on :data:`PLAIN_DEVICES`; while autograd
records ``x``, the ``addend`` or a leaf of the block's parameters
(training, remat's recompute included), a Function around each kernel
whose backward is written (:func:`.kernel.mamba_passes_grad`); the kernels
(:func:`.kernel.mamba_passes_cuda`) for every other call.

The widths and the B/C groups come from the config, so every family whose
blocks call ``mamba_block_apply`` (mamba2, the hybrid family, zamba2) takes
the same route.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.device import PLAIN_DEVICES, recording
from repro_torch.kernels.mamba_passes import ref
from repro_torch.kernels.mamba_passes.kernel import mamba_passes_cuda, mamba_passes_grad
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_leaves


def mamba_passes(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
                 scan: Callable[..., torch.Tensor],
                 addend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One Mamba block over ``x [B, L, D]`` with ``scan`` as its SSD scan
    (and ``addend`` on the input norm's input, where given): the plain
    passes, the kernels under autograd or the kernels, by the rule above."""
    if x.device.type in PLAIN_DEVICES:
        return ref.mamba_passes(cfg, p, x, scan, addend)
    if recording(x, *tree_leaves(p), *(() if addend is None else (addend,))):
        return mamba_passes_grad(cfg, p, x, scan, addend)
    return mamba_passes_cuda(cfg, p, x, scan, addend)
