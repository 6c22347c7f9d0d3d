"""Public wrappers of the fused S2D-variant conv.

Port of the JAX package's ``kernels/s2d_conv/ops.py``.  Where the JAX
package picked Pallas tiles against a VMEM budget, the CUDA kernel
(:mod:`.kernel`) takes the whole GEMM; this module only routes:

* :func:`s2d_variant_conv` sends a CUDA tensor to the kernel and a CPU
  tensor to the plain version (:func:`.ref.s2d_conv_ref`).  There is no
  fallback: a kernel that cannot run on a CUDA tensor raises.
* :func:`s2d_variant_conv_rs` is the R x S > 1 case — im2col at the d2s
  resolution, then a product that the JAX package leaves to XLA's
  ``einsum`` and this port to ``torch.matmul``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.s2d_conv.kernel import s2d_conv_cuda
from repro_torch.kernels.s2d_conv.ref import d2s, s2d, s2d_conv_ref


def s2d_variant_conv(x: torch.Tensor, w: torch.Tensor, gamma: int) -> torch.Tensor:
    """Fused variant pointwise conv. x: [B,H,W,C], w: [C/g^2, K/g^2]."""
    if x.device.type == "cpu":
        return s2d_conv_ref(x, w, gamma)
    return s2d_conv_cuda(x, w, gamma)


def s2d_variant_conv_rs(x: torch.Tensor, w_full: torch.Tensor, gamma: int) -> torch.Tensor:
    """R x S > 1 variant conv via im2col.

    w_full: [R, S, C/g^2, K/g^2] variant filter (operates in d2s space);
    x is patched at the d2s resolution, matching the paper's Fig. 1
    construction exactly (stride 1, 'same' padding)."""
    R, S, Cv, Kv = w_full.shape
    y = d2s(x, gamma)
    # im2col at the expanded resolution; F.pad lists the last dim first
    yp = F.pad(y, (0, 0, S // 2, (S - 1) // 2, R // 2, (R - 1) // 2))
    B, Hg, Wg, _ = y.shape
    cols = [yp[:, r : r + Hg, s : s + Wg, :] for r in range(R) for s in range(S)]
    patches = torch.cat(cols, dim=-1)  # [B, Hg, Wg, R*S*Cv]
    w2 = w_full.reshape(R * S * Cv, Kv)
    out = torch.matmul(patches.float(), w2.float())
    return s2d(out.to(x.dtype), gamma)
