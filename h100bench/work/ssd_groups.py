"""The SSD scan's least time where B and C come in G groups.

``roofline.ssd_floor`` counts B and C ``[Bt, L, N]`` read once and C B^T
once per (row, chunk).  With G groups (``[Bt, L, G, N]``, each shared by
H / G heads) both are G times as many; everything per head is unchanged.
``roofline.ssd_floor`` at H = 0 is exactly that per-group part (the B and
C bytes, the C B^T products), so the grouped floor adds it G - 1 more
times: at G = 1 it is ``roofline.ssd_floor`` itself.
"""

from __future__ import annotations

from typing import Dict

from h100bench.work.roofline import bound, ssd_floor


def grouped_ssd_floor(Bt: int, L: int, H: int, P: int, N: int, Q: int, dtype: str,
                      G: int = 1) -> Dict[str, float]:
    base, per_group = ssd_floor(Bt, L, H, P, N, Q, dtype), ssd_floor(Bt, L, 0, P, N, Q, dtype)
    return {k: base[k] + (G - 1) * per_group[k] for k in base}


def grouped_ssd_bound_s(Bt: int, L: int, H: int, P: int, N: int, Q: int, dtype: str,
                        G: int = 1) -> float:
    f = grouped_ssd_floor(Bt, L, H, P, N, Q, dtype, G)
    return bound(f["t_bytes_s"], f["t_ops_s"])[0]
