"""Public route of prefill attention: the plain version or the kernel.

``models.common.flash_attention`` calls :func:`flash_attention` inside its
span, which routes a call on what its inputs show:

* a CPU or ``meta`` tensor (:data:`PLAIN_DEVICES`) goes to the plain
  version (``common._flash_attention``), the route the CPU tests hold to
  the JAX package and the dry run counts;
* so does any call while autograd records: grad enabled and q, k or v
  requiring grad.  That is the training route, remat's recompute
  included; the kernel has no backward;
* every other CUDA tensor goes to the kernel (:func:`.kernel.flash_attn_cuda`),
  which launches or raises.  There is no fallback.

The head dim, the groups ``H / Hkv``, the lengths and the ``causal`` flag
come from the inputs, so every family's prefill takes the same route.
``q_chunk`` and ``k_chunk`` are the plain version's; the kernel chooses
its own tiles.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attn.kernel import flash_attn_cuda
from repro_torch.models import common

#: device types routed to the plain version; every other goes to the kernel
PLAIN_DEVICES = ("cpu", "meta")


def recording(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether autograd records the call: grad enabled and q, k or v
    requiring grad."""
    return torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                    q_chunk: int, k_chunk: int, scale: Optional[float]) -> torch.Tensor:
    """Attention of ``q [B, Lq, H, Dh]`` over ``k, v [B, Lk, Hkv, Dh]``: the
    plain version or the kernel, by the rule above."""
    if q.device.type in PLAIN_DEVICES or recording(q, k, v):
        return common._flash_attention(q, k, v, causal, q_chunk, k_chunk, scale)
    return flash_attn_cuda(q, k, v, causal, scale)
