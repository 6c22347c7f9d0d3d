"""A dropless mixture-of-experts layer: sigmoid router, relu² or SwiGLU experts, a shared expert.

Nemotron-H's MoE mixer (NVIDIA Nemotron-3-Nano; the layer equations of the
release's ``modeling_nemotron_h.py``) and DeepSeek-V3's (``modeling_deepseek.py``'s
``DeepseekV3MoE``, ``topk_method`` ``noaux_tc``), over tokens ``x [T, D]``:

    s   = sigmoid(x W_r)                        W_r [D, E], in float32
    ids = topk(limit(s + b), k)                 b: e_score_correction_bias, for
                                                selection only
    w   = s[ids] / (sum s[ids] + 1e-20) * rsf   the unbiased scores, normalised
                                                and scaled (routed_scaling_factor)
    y_j = act(x, ids_j) W_down[ids_j]           each of the k routes
    out = sum_j w_j y_j  (float32, cast back)  +  the shared expert

``act`` is relu(x W_up)^2 (Nemotron: no gate; the weights ``w_up``) or
silu(x W_g) * (x W_u) (DeepSeek-V3: SwiGLU; the weights ``w_gate_up``, [W_g
| W_u] along the last dim, so one product gives both), and the shared
expert the same with ``shared_up`` or ``shared_gate_up``.  ``limit`` is the
release's group-limited selection (:func:`group_limited`): the E experts in
``cfg.n_group`` groups, each group scored by the sum of its two best biased
scores, the ``cfg.topk_group`` best groups kept and the other experts'
scores set to 0.  With one group (Nemotron) it keeps every expert and is
not computed.

No token is dropped: every one of the T k routes reaches its expert,
however many choose it (``models/moe.py``, the registry's MoE, drops past
a capacity instead; it stays as it is).

Expert parallelism: the layer holds the experts ``cfg.expert_offset`` to
``cfg.expert_offset + n - 1``, n the routed weights' leading dim, and
routes over all E.  Only routes to held experts reach its products; the
combine sums their weighted outputs, and the shared expert is added once.
What the other chips' experts would add is left out (one card runs no
exchange).  Nemotron holds all 128 of its experts.

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
  up projection and one for the down projection, the activation between
  them, and the outputs gathered back in route order (by the inverse
  permutation).  Nothing reads a value back to the host between the router
  and the combine.  Where the layer holds some experts only, the routes to
  others sort last (their ids set to n) and the grouped GEMMs end at the
  held routes' end; the buffers keep all T k rows (the most the held routes
  can be, known without a sync) and the rows past the held ones are zeroed
  in route order before the combine.

Both routes end in the same combine (:func:`combine`): ``[T, k, D]`` weighted
and summed over k in float32, slot by slot in one order, with no atomics, so
a call gives the same bits every time.

Spans: ``moe.router``, ``moe.experts`` (the routed experts' products and
activation) and ``moe.shared_expert``.  Counters, on the host with no sync:
:data:`calls` (one a layer call) and :data:`routed_rows` (the routes
dispatched, T k a call, since none is dropped); on the device, for a layer
that holds some experts only, :data:`held_rows` (its routes to held
experts, added to with no sync, read by :func:`held_count`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import PLAIN_DEVICES, recording
from repro_torch.models.common import glu_activation, linear
from repro_torch.spans import span
from repro_torch.tree import tree_leaves

Params = Dict[str, Any]

#: MoE layer calls since the process began (one a call of :func:`moe_apply`)
calls = 0
#: routes dispatched to the experts since the process began (T k a call)
routed_rows = 0
#: routes to held experts since the process began, of layers that hold some
#: experts only: an int64 tensor a device, under the device's full name
#: (``cuda:0``, never ``cuda``: :func:`device_key`), added to on the device
held_rows: Dict[str, torch.Tensor] = {}


def device_key(device) -> str:
    """The full name of ``device`` (a ``torch.device`` or its name), as a
    tensor on it reports it: ``cuda`` and ``cuda:0`` give ``cuda:0`` where
    the current card is 0."""
    return str(torch.empty(0, device=device).device)


def held_count(device) -> int:
    """The routes to held experts on ``device`` since the process began
    (:data:`held_rows`; 0 where none was counted); reads the count back to
    the host."""
    n = held_rows.get(device_key(device))
    return 0 if n is None else int(n)


def relu2(u: torch.Tensor) -> torch.Tensor:
    """relu(u)^2 in u's dtype (the release's ``relu2``)."""
    return F.relu(u).square()


def swiglu(u: torch.Tensor) -> torch.Tensor:
    """silu(g) * v of ``u = [g | v]`` (the last dim in halves), in u's dtype
    (the release's ``act_fn(gate_proj(x)) * up_proj(x)``)."""
    g, v = u.chunk(2, dim=-1)
    return glu_activation("swiglu", g, v)


def group_limited(biased: torch.Tensor, n_group: int, topk_group: int) -> torch.Tensor:
    """The biased scores ``[T, E]`` with every expert outside the
    ``topk_group`` best of ``n_group`` groups set to 0, a group scored by the
    sum of its two best scores (the release's ``noaux_tc``, which fills 0.0)."""
    T, E = biased.shape
    g = biased.reshape(T, n_group, E // n_group)
    best = torch.topk(g.topk(2, dim=-1).values.sum(-1), topk_group, dim=-1).indices
    keep = torch.zeros((T, n_group), dtype=torch.bool, device=biased.device)
    keep.scatter_(1, best, True)
    return torch.where(keep[..., None], g, 0.0).reshape(T, E)


def route(cfg, p: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ids [T, k] int64, w [T, k] float32)`` of tokens ``x [T, D]``: the
    top-k of the sigmoid scores plus the correction bias (group-limited where
    ``cfg.n_group`` > 1), weighted by the unbiased scores, normalised and
    scaled."""
    scores = torch.sigmoid(x.float() @ p["router"]["w"].float())
    biased = scores + p["e_bias"]
    if cfg.n_group > 1:
        biased = group_limited(biased, cfg.n_group, cfg.topk_group)
    ids = torch.topk(biased, cfg.experts_per_token, dim=-1).indices
    w = scores.gather(1, ids)
    return ids, w / (w.sum(dim=-1, keepdim=True) + 1e-20) * cfg.routed_scaling_factor


def _experts(p: Params):
    """``(activation, input weights [n, D, F or 2F])`` of the routed experts."""
    if "w_gate_up" in p:
        return swiglu, p["w_gate_up"]
    return relu2, p["w_up"]


def held(p: Params) -> int:
    """The routed experts the layer holds (the weights' leading dim)."""
    return _experts(p)[1].shape[0]


def holds_all(p: Params) -> bool:
    """Whether the layer holds every expert the router scores."""
    return held(p) == p["router"]["w"].shape[-1]


def experts_plain(p: Params, x: torch.Tensor, ids: torch.Tensor, first: int = 0) -> torch.Tensor:
    """Each route's expert output ``[T, k, D]`` in x's dtype: every held
    expert (``first`` on) over every token, kept where a route chose it, and
    zero where a route chose an expert not held; span ``moe.experts``."""
    T, k = ids.shape
    act, w_in = _experts(p)
    with span("moe.experts"):
        y = x.new_zeros((T, k, x.shape[-1]))
        for e in range(w_in.shape[0]):
            out = act(x @ w_in[e]) @ p["w_down"][e]
            y = torch.where((ids == first + e)[..., None], out[:, None], y)
    return y


def experts_grouped(p: Params, x: torch.Tensor, ids: torch.Tensor, first: int = 0) -> torch.Tensor:
    """:func:`experts_plain`'s result by two grouped GEMMs over the routes
    sorted by expert (span ``moe.experts`` around the GEMMs and the
    activation, the sort, the gather and the way back outside it); no value
    goes back to the host."""
    T, k = ids.shape
    act, w_in = _experts(p)
    n = w_in.shape[0]
    whole = holds_all(p)
    flat = ids.reshape(-1)
    if not whole:  # held experts 0..n-1 here, every other expert n, sorted last
        flat = flat - first
        flat = torch.where((flat >= 0) & (flat < n), flat, n)
    order = torch.sort(flat, stable=True).indices
    ends = torch.searchsorted(flat[order], torch.arange(n, device=x.device), right=True)
    ends = ends.to(torch.int32)
    rows = x[order // k]
    with span("moe.experts"):
        h = act(torch._grouped_mm(rows, w_in, offs=ends))
        out = torch._grouped_mm(h, p["w_down"], offs=ends)
    back = torch.empty_like(order)
    back[order] = torch.arange(order.numel(), device=x.device)
    y = out[back].reshape(T, k, -1)
    if not whole:  # the rows past the held routes' end are the GEMMs' unwritten rows
        y.masked_fill_((flat == n).reshape(T, k, 1), 0)
    return y


def shared_expert(p: Params, x: torch.Tensor) -> torch.Tensor:
    """The shared expert over tokens ``x [T, D]``: relu² (``shared_up``) or
    SwiGLU (``shared_gate_up``)."""
    if "shared_gate_up" in p:
        return linear(p["shared_down"], swiglu(linear(p["shared_gate_up"], x)))
    return linear(p["shared_down"], relu2(linear(p["shared_up"], x)))


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
    ``[B, L, D]``: the held experts' part and the shared expert.  Where
    ``routes`` is a list, the chosen expert ids ``[B, L, k]`` (over all E
    experts) are appended to it."""
    global calls, routed_rows
    B, L, D = x.shape
    xt = x.reshape(B * L, D)
    first = cfg.expert_offset
    with span("moe.router"):
        ids, w = route(cfg, p, xt)
    if routes is not None:
        routes.append(ids.reshape(B, L, -1))
    y = (experts_grouped if grouped(x, p) else experts_plain)(p, xt, ids, first)
    out = combine(y, w)
    with span("moe.shared_expert"):
        out = out + shared_expert(p, xt)
    calls += 1
    routed_rows += ids.numel()
    if not holds_all(p):
        key = device_key(x.device)
        if key not in held_rows:
            held_rows[key] = torch.zeros((), dtype=torch.int64, device=x.device)
        held_rows[key] += ((ids >= first) & (ids < first + held(p))).sum()
    return out.reshape(B, L, D)
