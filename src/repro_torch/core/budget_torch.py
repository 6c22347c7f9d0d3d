"""Algorithm 1 on the device (torch port of the JAX package's ``budget_jax``).

The greedy tightening loop of :func:`repro_torch.core.budget.tighten_budgets`
over padded per-layer level tables ``[L, R_max]`` (see :func:`pack_levels`,
copied verbatim from the original module): while the reference total at the
current constraint levels exceeds the deadline and some layer can still
tighten, tighten the layer with the largest ``cur - next`` gap, the lowest
index on ties (``torch.argmax``'s first maximum, as ``np.argmax``).

The reference's ``lax.while_loop`` becomes a host loop over a masked body,
and its ``vmap`` over models a batch dimension: one loop over ``[M, L]``
in which a model whose condition has gone false stops moving.  The host
reads "any model still tightening" only every :data:`CHECK_EVERY`
iterations, and never loops past the exact bound on the steps left
(``sum(R - 1 - rho0)`` over real layers).  Everything is explicit
``torch.float64``; the default dtype is never changed.

The reference total is a ``torch.sum``, whose order differs from numpy's
pairwise sum, so ``rho`` and ``feasible`` agree with the numpy reference
except where a total lies within rounding of the deadline, and budgets
agree to rounding (the tests hold them to the reference's rtol 1e-5).

There is no counterpart of ``distribute_budgets_jax_jit``: nothing is
compiled here, so :func:`distribute_budgets_torch` is the entry point.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.budget import latency_levels
from repro_torch.device import resolve_device

_F64 = torch.float64

#: host loop: read "any model active" once per this many iterations
CHECK_EVERY = 8


def pack_levels(lat_table: np.ndarray, r_max: int | None = None) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: build the padded [L, R_max] decreasing level table.

    Padding repeats each layer's last (fastest) distinct latency so that
    padded positions contribute zero gap and are never tightenable.
    """
    L = lat_table.shape[0]
    levels = [latency_levels(lat_table[l]) for l in range(L)]
    R = np.array([len(lv) for lv in levels], dtype=np.int32)
    if r_max is None:
        r_max = int(R.max())
    packed = np.zeros((L, r_max), dtype=lat_table.dtype)
    for l, lv in enumerate(levels):
        packed[l, : len(lv)] = lv[:r_max]
        packed[l, len(lv):] = lv[min(len(lv), r_max) - 1]
    return packed, np.minimum(R, r_max)


class BudgetTorchResult(NamedTuple):
    feasible: torch.Tensor  # bool, [] or [M]
    budgets: torch.Tensor  # [L] or [M, L] f64
    rho: torch.Tensor  # [L] or [M, L] int32
    c_ref: torch.Tensor  # [L] or [M, L] f64


def _as(x, dtype, dev):
    return torch.as_tensor(x, device=dev).to(dtype)


def _tighten(levels, R, deadline, layer_mask, rho) -> BudgetTorchResult:
    """The masked tightening loop over ``[M, L]`` (all tensors on one device)."""
    M, L, r_max = levels.shape
    lanes = torch.arange(L, device=levels.device)
    tight_top = R - 1

    def c_of(rho):
        return torch.where(layer_mask, levels.gather(2, rho[..., None])[..., 0], 0.0)

    def active(rho):
        tight = layer_mask & (rho < tight_top)
        return (c_of(rho).sum(dim=1) > deadline) & tight.any(dim=1), tight

    # every step of an active model raises one real layer's level by one
    steps_left = int(torch.where(layer_mask, (tight_top - rho).clamp(min=0), 0).sum(dim=1).max())
    done = 0
    while done < steps_left:
        for _ in range(min(CHECK_EVERY, steps_left - done)):
            done += 1
            act, tight = active(rho)
            cur = levels.gather(2, rho[..., None])[..., 0]
            nxt = levels.gather(2, (rho + 1).clamp(max=r_max - 1)[..., None])[..., 0]
            gaps = torch.where(tight, cur - nxt, float("-inf"))
            l_star = gaps.argmax(dim=1)
            rho = rho + ((lanes == l_star[:, None]) & act[:, None])
        if not bool(active(rho)[0].any()):
            break
    c_ref = c_of(rho)
    c_total = c_ref.sum(dim=1)
    feasible = c_total <= deadline
    budgets = torch.where(
        feasible[:, None],
        deadline[:, None] * c_ref / torch.clamp(c_total, min=1e-30)[:, None],
        0.0,
    )
    budgets = torch.where(layer_mask, budgets, 0.0)
    return BudgetTorchResult(feasible, budgets, rho.to(torch.int32), c_ref)


def distribute_budgets_batch(
    levels_b,  # [M, L, R_max]
    R_b,  # [M, L]
    deadlines,  # [M]
    layer_mask_b,  # [M, L]
    rho0_b=None,  # [M, L]
    device=None,
) -> BudgetTorchResult:
    """Algorithm 1 across a fleet of models (padded layout), as one masked
    loop over ``[M, L]``.  Arrays or tensors; they are moved to ``device``
    (the card when None)."""
    dev = resolve_device(device)
    levels = _as(levels_b, _F64, dev)
    M, L, _ = levels.shape
    rho = (torch.zeros((M, L), dtype=torch.int64, device=dev) if rho0_b is None
           else _as(rho0_b, torch.int64, dev))
    return _tighten(levels, _as(R_b, torch.int64, dev), _as(deadlines, _F64, dev).reshape(M),
                    _as(layer_mask_b, torch.bool, dev), rho)


def distribute_budgets_torch(
    levels,  # [L, R_max] decreasing, padded
    R,  # [L] number of real levels per layer
    deadline,  # scalar
    layer_mask=None,  # [L] bool; False = phantom layer
    rho0=None,  # [L] starting constraint levels (incremental)
    device=None,
) -> BudgetTorchResult:
    """The tightening kernel for one model; ``rho0=None`` (zeros) is
    offline Algorithm 1, a nonzero ``rho0`` re-distributes a remaining
    deadline from a request's current constraint levels (mirrors
    ``budget.tighten_budgets``).  Runs on ``device`` (the card when None)."""
    dev = resolve_device(device)
    levels = _as(levels, _F64, dev)
    L = levels.shape[0]
    mask = (torch.ones((L,), dtype=torch.bool, device=dev) if layer_mask is None
            else _as(layer_mask, torch.bool, dev))
    out = distribute_budgets_batch(
        levels[None], _as(R, torch.int64, dev)[None], _as(deadline, _F64, dev).reshape(1),
        mask[None], None if rho0 is None else _as(rho0, torch.int64, dev)[None], device=dev)
    return BudgetTorchResult(*(t[0] for t in out))
