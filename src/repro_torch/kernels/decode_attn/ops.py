"""Public wrapper of the GQA decode attention.

Port of the JAX package's ``kernels/decode_attn/ops.py``, at the call
site of ``models/common.decode_attention``: ``q [B, 1, H, Dh]``, a
``[B, L, Hkv, Dh]`` cache and the position of the newest token.  The JAX
wrapper's ``backend`` / ``interpret`` / ``chunk`` arguments choose among
TPU paths and have no counterpart here; this module only routes, by
``repro_torch.device``'s rule: the plain version (:func:`.ref.decode_attention`)
on :data:`PLAIN_DEVICES`, the hand-written kernel (:mod:`.kernel`) on every
other device.  No training path calls it, so autograd decides nothing here.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import PLAIN_DEVICES
from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
from repro_torch.kernels.decode_attn.ref import decode_attention


def gqa_decode_attention(
    q: torch.Tensor,  # [B, 1, H, Dh]
    cache_k: torch.Tensor,  # [B, L, Hkv, Dh]
    cache_v: torch.Tensor,
    pos: int,  # position of the newest token
    valid_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention of the newest token over cache positions ``0..pos`` -> [B, 1, H, Dh].

    ``valid_len`` is the kernel's ``[B]`` int32 ``pos + 1`` on the card; a
    caller that runs many layers at one position builds it once and
    passes it, so no layer makes a tensor of its own.  ``pos + 1`` also
    sizes the kernel's grid (the positions it can have to read).  The
    plain version reads ``pos`` alone."""
    if q.device.type in PLAIN_DEVICES:
        return decode_attention(q, cache_k, cache_v, pos)
    if valid_len is None:
        valid_len = torch.full((q.shape[0],), pos + 1, dtype=torch.int32, device=q.device)
    return decode_attn_cuda(q[:, 0], cache_k, cache_v, valid_len, bound=pos + 1)[:, None]
