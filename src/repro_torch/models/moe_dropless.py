"""A dropless mixture-of-experts layer: sigmoid router, relu² experts, a shared expert.

Nemotron-H's MoE mixer (NVIDIA Nemotron-3-Nano; the layer equations of the
release's ``modeling_nemotron_h.py``), over tokens ``x [T, D]``:

    s   = sigmoid(x W_r)                        W_r [D, E], in float32
    ids = topk(s + b, k)                        b: e_score_correction_bias, for
                                                selection only
    w   = s[ids] / (sum s[ids] + 1e-20) * rsf   the unbiased scores, normalised
                                                and scaled (routed_scaling_factor)
    y_j = relu(x W_up[ids_j])^2 W_down[ids_j]   each of the k routes, no gate
    out = sum_j w_j y_j  (float32, cast back)  +  relu(x S_up)^2 S_down

No token is dropped: every one of the T k routes reaches its expert,
however many choose it (``models/moe.py``, the registry's MoE, drops past
a capacity instead; it stays as it is).  ``n_group`` and ``topk_group`` are
1 in the release, so its group-limited selection keeps every expert and is
left out.

:func:`moe_apply` takes one of two routes for the routed experts, by
``repro_torch.device``'s rule:

* the plain route (:func:`experts_plain`): a loop over the experts in plain
  torch, each expert over every token with its routes masked, so that no
  shape depends on the routing (it runs on ``meta``).  It is the CPU's,
  ``meta``'s, autograd's and float32's route, and the twin the grouped
  route is held to;
* the grouped route (:func:`experts_grouped`, a bf16 CUDA tensor with grad
  off): the T k routes sorted by expert (stable), each expert's rows
  counted by ``searchsorted`` on the sorted ids (``bincount`` reads the
  largest id back to the host), the rows gathered once, one grouped GEMM
  (``torch._grouped_mm``, its group ends on the device) for every expert's
  up projection and one for the down projection, relu² between them, and
  the outputs gathered back in route order (by the inverse permutation).
  Nothing reads a value back to the host between the router and the
  combine.

Both routes end in the same combine (:func:`combine`): ``[T, k, D]`` weighted
and summed over k in float32, slot by slot in one order, with no atomics, so
a call gives the same bits every time.

Spans: ``moe.router``, ``moe.experts`` (the routed experts' products and
relu²) and ``moe.shared_expert``.  Counters, on the host with no sync:
:data:`calls` (one a layer call) and :data:`routed_rows` (the routes
dispatched, T k a call, since none is dropped).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import PLAIN_DEVICES, recording
from repro_torch.models.common import linear
from repro_torch.spans import span
from repro_torch.tree import tree_leaves

Params = Dict[str, Any]

#: MoE layer calls since the process began (one a call of :func:`moe_apply`)
calls = 0
#: routes dispatched to the experts since the process began (T k a call)
routed_rows = 0


def relu2(u: torch.Tensor) -> torch.Tensor:
    """relu(u)^2 in u's dtype (the release's ``relu2``)."""
    return F.relu(u).square()


def route(cfg, p: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ids [T, k] int64, w [T, k] float32)`` of tokens ``x [T, D]``: the
    top-k of the sigmoid scores plus the correction bias, weighted by the
    unbiased scores, normalised and scaled."""
    scores = torch.sigmoid(x.float() @ p["router"]["w"].float())
    ids = torch.topk(scores + p["e_bias"], cfg.experts_per_token, dim=-1).indices
    w = scores.gather(1, ids)
    return ids, w / (w.sum(dim=-1, keepdim=True) + 1e-20) * cfg.routed_scaling_factor


def experts_plain(p: Params, x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Each route's expert output ``[T, k, D]`` in x's dtype: every expert
    over every token, kept where a route chose it; span ``moe.experts``."""
    T, k = ids.shape
    with span("moe.experts"):
        y = x.new_zeros((T, k, x.shape[-1]))
        for e in range(p["w_up"].shape[0]):
            out = relu2(x @ p["w_up"][e]) @ p["w_down"][e]
            y = torch.where((ids == e)[..., None], out[:, None], y)
    return y


def experts_grouped(p: Params, x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """:func:`experts_plain`'s result by two grouped GEMMs over the routes
    sorted by expert (span ``moe.experts`` around the GEMMs and relu², the
    sort, the gather and the way back outside it); no value goes back to the
    host."""
    T, k = ids.shape
    E = p["w_up"].shape[0]
    flat = ids.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    ends = torch.searchsorted(flat[order], torch.arange(E, device=x.device), right=True)
    ends = ends.to(torch.int32)
    rows = x[order // k]
    with span("moe.experts"):
        h = relu2(torch._grouped_mm(rows, p["w_up"], offs=ends))
        out = torch._grouped_mm(h, p["w_down"], offs=ends)
    back = torch.empty_like(order)
    back[order] = torch.arange(order.numel(), device=x.device)
    return out[back].reshape(T, k, -1)


def grouped(x: torch.Tensor, p: Params) -> bool:
    """Whether the grouped route takes ``x``: a bf16 tensor off
    ``PLAIN_DEVICES`` that autograd does not record."""
    return (x.device.type not in PLAIN_DEVICES and x.dtype == torch.bfloat16
            and not recording(x, *tree_leaves(p)))


def combine(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``sum_j w_j y_j`` over the k routes of ``y [T, k, D]``, in float32
    (y read in its dtype and widened in the products), slot 0 first; cast to
    y's dtype."""
    acc = y[:, 0] * w[:, :1]
    for j in range(1, y.shape[1]):
        acc.addcmul_(y[:, j], w[:, j:j + 1])
    return acc.to(y.dtype)


def moe_apply(cfg, p: Params, x: torch.Tensor,
              routes: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """The MoE mixer over ``x [B, L, D]`` (the normed residual stream) ->
    ``[B, L, D]``.  Where ``routes`` is a list, the chosen expert ids
    ``[B, L, k]`` are appended to it."""
    global calls, routed_rows
    B, L, D = x.shape
    xt = x.reshape(B * L, D)
    with span("moe.router"):
        ids, w = route(cfg, p, xt)
    if routes is not None:
        routes.append(ids.reshape(B, L, -1))
    y = (experts_grouped if grouped(x, p) else experts_plain)(p, xt, ids)
    out = combine(y, w)
    with span("moe.shared_expert"):
        out = out + linear(p["shared_down"], relu2(linear(p["shared_up"], xt)))
    calls += 1
    routed_rows += ids.numel()
    return out.reshape(B, L, D)
