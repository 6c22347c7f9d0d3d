"""The H100's published peaks and the least time a kernel's call needs.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit: 989
TFLOP/s bf16, 495 TFLOP/s TF32, 67 TFLOP/s float32 on the CUDA cores,
3.35 TB/s of HBM.  :func:`bound` and :func:`ssd_floor` are frozen copies
of ``chip_smoke.py``'s (every input byte read once, the output written
once; the products the algorithm needs), so that a later kernel that
reads or computes less does not move the yardstick.
"""

from __future__ import annotations

from typing import Dict

HBM_BPS = 3.35e12
PEAK = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def bound(t_bytes: float, t_ops: float):
    """The least time of work whose bytes take ``t_bytes`` at the HBM rate
    and whose operations take ``t_ops`` at the type's peak, and which of
    the two bounds it."""
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ssd_floor(Bt: int, L: int, H: int, P: int, N: int, Q: int, dtype: str) -> Dict[str, float]:
    """``t_bytes_s`` and ``t_ops_s`` of one SSD scan call: x [Bt, L, H, P]
    and B, C [Bt, L, N] in ``dtype``, log_a and dt float32, read once, y
    written once; C B^T once per (row, chunk), causal half, at the inputs'
    type; the scores times x dt, the chunk's state and C S per (row, head,
    chunk) in float32 at the faster of the CUDA cores and split TF32 (three
    TF32 products; two for C S where C is bf16, exact in TF32)."""
    isz = ITEMSIZE[dtype]
    nbytes = 2 * Bt * L * H * P * isz + 2 * Bt * L * N * isz + 2 * Bt * L * H * 4
    n_chunks = Bt * (L // Q)
    ops_cb = n_chunks * Q * (Q + 1) * N
    ops_cs = n_chunks * H * 2 * Q * N * P
    ops_f32 = n_chunks * H * (Q * (Q + 1) * P + 2 * Q * N * P) + ops_cs
    f32_s = min(1 / PEAK["float32"], 3 / PEAK["tf32"])
    cs_s = min(1 / PEAK["float32"], 2 / PEAK["tf32"]) if dtype == "bfloat16" else f32_s
    cb_s = 1 / PEAK[dtype] if dtype == "bfloat16" else f32_s
    return {"t_bytes_s": nbytes / HBM_BPS,
            "t_ops_s": ops_cb * cb_s + (ops_f32 - ops_cs) * f32_s + ops_cs * cs_s}


def ssd_bound_s(Bt: int, L: int, H: int, P: int, N: int, Q: int, dtype: str) -> float:
    f = ssd_floor(Bt, L, H, P, N, Q, dtype)
    return bound(f["t_bytes_s"], f["t_ops_s"])[0]
