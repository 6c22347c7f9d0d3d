"""The least time of one MoE layer's routed expert products.

For ``rows`` routes (T k, none dropped): the up products ``[rows, D] x
[D, F]`` and the down products ``[rows, F] x [F, D]``, 4 rows D F FLOPs at
the type's peak; against every expert's two weight matrices read once and
the rows in and out (``[rows, D]`` each) at the HBM rate.  The larger of the
two is the bound (``roofline.bound``); relu² between the products is
elementwise and is not counted.
"""

from __future__ import annotations

from typing import Dict

from h100bench.work.roofline import HBM_BPS, ITEMSIZE, PEAK, bound


def floor(w: Dict, rows: int, dtype: str) -> Dict[str, float]:
    """``t_bytes_s`` and ``t_ops_s`` of one layer's routed products over ``rows`` routes."""
    D, E, F = w["d_model"], w["n_experts"], w["moe_d_ff"]
    isz = ITEMSIZE[dtype]
    nbytes = 2 * E * D * F * isz + 2 * rows * D * isz
    return {"t_bytes_s": nbytes / HBM_BPS, "t_ops_s": 4.0 * rows * D * F / PEAK[dtype]}


def bound_s(w: Dict, rows: int, dtype: str) -> float:
    f = floor(w, rows, dtype)
    return bound(f["t_bytes_s"], f["t_ops_s"])[0]
