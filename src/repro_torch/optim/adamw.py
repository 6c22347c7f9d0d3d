"""AdamW with global-norm clipping and LR schedule, on torch tensors.

Port of the JAX package's ``optim/adamw.py``.  Parameters live in the
model dtype (bf16 by default); the first and second moments are f32, and
the step counter an int32 scalar, on the parameters' device.  The update
is the reference's formula in its order of operations: clip by the
global norm, bias-correct ``m`` and ``v``, ``delta = mh / (sqrt(vh) +
eps) + wd * p``, ``p <- (p_f32 - lr * delta)`` cast back to ``p``'s dtype.
``torch.optim.AdamW`` is not used: it keeps its moments in the parameter
dtype and rounds differently.

The update writes the parameters and the moments in place (under
``torch.no_grad``), so that a full-width step does not hold two copies of
them; it returns the same trees, keeping the reference's
``(params, opt, batch) -> (params, opt, metrics)`` contract.
``opt_state_specs`` and ``zero1_opt_specs`` are the reference's sharding
trees of the optimiser state as data (``repro_torch.launch.mesh``), keyed
as :class:`OptState`; the dry run fits them to the production layouts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.launch.mesh import PartitionSpec as P
from repro_torch.spans import span
from repro_torch.tree import tree_leaves, tree_map

Params = Any


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor
    m: Params
    v: Params


def init_opt_state(params: Params) -> OptState:
    """f32 zero moments beside each parameter; the step an int32 zero."""
    m = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    v = tree_map(torch.zeros_like, m)
    dev = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev), m=m, v=v)


def opt_state_specs(param_specs: Params) -> OptState:
    """m/v shard exactly like their parameters; step replicated."""
    return OptState(step=P(), m=param_specs, v=tree_map(lambda s: s, param_specs))


def zero1_opt_specs(param_specs: Params, opt_shape: "OptState" = None) -> OptState:
    """ZeRO-1: parameters replicated, f32 moments sharded across every
    mesh axis.  Shape-aware: each moment leaf is sharded on its largest
    dim divisible by the full device count (256/512 both divide when 512
    does not, fitted_shardings drops the pod axis), else by 16, else
    replicated (only tiny norm/bias leaves)."""
    ALL = ("pod", "data", "model")

    def leaf_spec(shape_leaf):
        dims = shape_leaf.shape
        best = None
        for want in (512, 256, 32, 16):
            cands = [d for d in range(len(dims)) if dims[d] % want == 0 and dims[d] >= want]
            if cands:
                best = max(cands, key=lambda d: dims[d])
                break
        if best is None:
            return P()
        entries = [None] * len(dims)
        entries[best] = ALL if dims[best] % 256 == 0 else ("data",)
        return P(*entries)

    if opt_shape is not None:
        m_specs = tree_map(leaf_spec, opt_shape.m)
        return OptState(step=P(), m=m_specs, v=tree_map(lambda s: s, m_specs))
    shard = tree_map(lambda s: P(ALL), param_specs)
    return OptState(step=P(), m=shard, v=tree_map(lambda s: s, shard))


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine to 0 at ``total_steps`` (f32)."""
    warm = cfg.lr * (step + 1) / max(1, cfg.warmup_steps)
    t = torch.clamp((step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps),
                    0.0, 1.0)
    cos = cfg.lr * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos).to(torch.float32)


def global_norm(tree: Params) -> torch.Tensor:
    leaves = [torch.sum(torch.square(leaf.float())) for leaf in tree_leaves(tree)]
    return torch.sqrt(sum(leaves))


@torch.no_grad()
def adamw_update(
    cfg: OptConfig, params: Params, grads: Params, state: OptState
) -> Tuple[Params, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step: ``params`` and ``state``'s moments updated in place
    and returned, with ``{"lr", "grad_norm"}`` (device scalars); span
    ``adamw.update``."""
    with span("adamw.update"):
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        step = state.step + 1
        lr = lr_at(cfg, state.step)
        bc1 = 1 - cfg.b1 ** step.float()
        bc2 = 1 - cfg.b2 ** step.float()
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
                              tree_leaves(state.v)):
            g = g.float() * scale
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)  # b1 m + (1 - b1) g
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            mh, vh = m / bc1, v / bc2
            delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, OptState(step, state.m, state.v), {"lr": lr, "grad_norm": gnorm}


def make_train_step(loss_fn: Callable, opt_cfg: OptConfig):
    """(params, opt_state, batch) -> (params, opt_state, metrics): the
    loss (in the span ``model.loss``) and ``torch.autograd.grad`` of it
    with respect to every parameter (each made to require grad), then
    :func:`adamw_update`; ``metrics`` holds ``loss``, ``lr`` and
    ``grad_norm`` as device scalars."""

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with span("model.loss"):
            loss = loss_fn(params, batch)
        it = iter(torch.autograd.grad(loss, leaves))
        grads = tree_map(lambda _: next(it), params)
        params, opt_state, metrics = adamw_update(opt_cfg, params, grads, opt_state)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step
