"""Public wrapper of the SSD mixer: the chunked scan behind one switch.

Port of the JAX package's ``kernels/ssd_scan/ops.py``.  The model's
prefill (``models.mamba2.mamba_block_apply``) calls :func:`ssd_scan`:

* a CPU tensor goes to the plain blocked version (:func:`.ref.ssd_chunked`);
* a CUDA tensor goes to the hand-written kernel (:mod:`.kernel`), which
  launches or raises.  There is no fallback.

The JAX switch's ``backend`` and ``interpret`` choices have no
counterpart: the plain version and the oracle are called from
:mod:`.ref` directly.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda


def ssd_scan(x: torch.Tensor, log_a: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
             dt: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """x [Bt, L, H, P], log_a / dt [Bt, L, H], B / C [Bt, L, N] -> y [Bt, L, H, P]."""
    if x.device.type == "cpu":
        from repro_torch.kernels.ssd_scan.ref import ssd_chunked

        return ssd_chunked(x, log_a, B, C, dt, chunk)
    # the model hands in views of its (x, B, C) projection
    return ssd_scan_cuda(x.contiguous(), log_a.contiguous(), B.contiguous(),
                         C.contiguous(), dt.contiguous(), chunk)
