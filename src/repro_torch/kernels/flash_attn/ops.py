"""Public route of prefill attention: the plain version or the kernel.

``models.common.flash_attention`` calls :func:`flash_attention` inside its
span, which routes by ``repro_torch.device``'s rule: the plain
``common._flash_attention`` on :data:`PLAIN_DEVICES` and while autograd
records q, k or v (training, remat's recompute included: the kernel has no
backward), and for a float32 call (the float32 checks: no workload runs
attention in float32); the bf16 kernel (:func:`.kernel.flash_attn_cuda`)
for every other call, which launches or raises.

The head dim, the groups ``H / Hkv``, the lengths and the ``causal`` flag
come from the inputs, so every family's prefill takes the same route.
``q_chunk`` and ``k_chunk`` are the plain version's; the kernel chooses
its own tiles.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import PLAIN_DEVICES, recording
from repro_torch.kernels.flash_attn.kernel import flash_attn_cuda
from repro_torch.models import common


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                    q_chunk: int, k_chunk: int, scale: Optional[float]) -> torch.Tensor:
    """Attention of ``q [B, Lq, H, Dh]`` over ``k [B, Lk, Hkv, Dh]`` and ``v
    [B, Lk, Hkv, Dv]``: the plain version or the kernel, by the rule above."""
    if q.device.type in PLAIN_DEVICES or recording(q, k, v) or q.dtype == torch.float32:
        return common._flash_attention(q, k, v, causal, q_chunk, k_chunk, scale)
    return flash_attn_cuda(q, k, v, causal, scale)
