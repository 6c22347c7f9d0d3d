"""Public wrapper of the Mamba block's passes: the plain passes or the kernels.

``models.mamba2.mamba_block_apply`` calls :func:`mamba_passes`, which
routes a block call on what its inputs show:

* a CPU or ``meta`` tensor (:data:`PLAIN_DEVICES`) goes to the plain
  passes (:func:`.ref.mamba_passes`), the route the CPU tests hold to the
  JAX package and the dry run counts;
* so does any tensor while autograd records: grad enabled and ``x`` or a
  leaf of the block's parameters requiring grad.  That is the training
  route, remat's recompute included; the kernels have no backward;
* every other CUDA tensor goes to the kernels (:func:`.kernel.mamba_passes_cuda`),
  which launch or raise.  There is no fallback.

The widths and the B/C groups come from the config, so every family whose
blocks call ``mamba_block_apply`` (mamba2, the hybrid family, zamba2) takes
the same route.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.kernels.mamba_passes import ref
from repro_torch.kernels.mamba_passes.kernel import mamba_passes_cuda
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_leaves

#: device types routed to the plain passes; every other goes to the kernels
PLAIN_DEVICES = ("cpu", "meta")


def recording(p: Dict[str, Any], x: torch.Tensor) -> bool:
    """Whether autograd records the block: grad enabled, and ``x`` or a
    leaf of ``p`` requires grad."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in tree_leaves(p)))


def mamba_passes(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
                 scan: Callable[..., torch.Tensor],
                 addend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One Mamba block over ``x [B, L, D]`` with ``scan`` as its SSD scan
    (and ``addend`` on the input norm's input, where given): the plain
    passes or the kernels, by the rule above."""
    if x.device.type in PLAIN_DEVICES or recording(p, x):
        return ref.mamba_passes(cfg, p, x, scan, addend)
    return mamba_passes_cuda(cfg, p, x, scan, addend)
