"""Plain PyTorch reference of the benchmarked models, in float32.

It follows the port's semantics (the parameter trees the benchmark makes
for it, the Mamba2 block, the tied head, AdamW with clipping) and
computes every step in float32 with TF32 off, one layer at a time.  It imports torch alone: nothing of the
program, and it reads the configuration file's widths, never the
program's registry.  The SSD scan is the chunked algorithm of the
Mamba-2 paper (arXiv:2405.21060, Listing 1).

``prec="fp8"`` is the benchmark's control: every matrix product of a
weight (the projections and the head) takes both operands rounded
to float8 e4m3 with one scale a tensor, the step that would tempt a
later change; everything else stays float32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32 = torch.float32
FP8_MAX = 448.0  # largest float8 e4m3 value


@contextlib.contextmanager
def exact_matmul():
    """float32 products without TF32, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale (its largest magnitude
    maps to 448), back in float32; the gradient passes straight through."""
    s = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / s).to(torch.float8_e4m3fn).to(F32) * s
    return t + (q - t).detach() if t.requires_grad else q


def mm(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """``x @ w`` in float32, or with both operands in float8 (``prec="fp8"``)."""
    w = w.to(F32)
    if prec == "fp8":
        return fp8(x) @ fp8(w)
    return x @ w


# ------------------------------------------------------------- parameters --

#: leading stacked dims of the stacked subtrees
STACKED = {"blocks": 1}


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """``(dotted path, tensor)`` of every leaf, keys in sorted order."""
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from named_leaves(v, path)
        else:
            yield path, v


def leaf_units(tree) -> Iterator[Tuple[str, torch.Tensor]]:
    """The leaves with stacked layers taken apart: one ``(name, view)`` a
    layer of every stacked leaf, so a fault in one layer shows as that
    layer's, not averaged over its stack."""
    for path, t in named_leaves(tree):
        lead = STACKED.get(path.split(".")[0], 0)
        if lead == 0:
            yield path, t
            continue
        flat = t.reshape((-1,) + tuple(t.shape[lead:]))
        for i in range(flat.shape[0]):
            yield f"{path}[{i}]", flat[i]


def unit_norms(tree) -> Dict[str, float]:
    """The float32 norm of every unit of :func:`leaf_units`."""
    return {n: float(torch.linalg.vector_norm(t.to(F32))) for n, t in leaf_units(tree)}


def layer(tree, *idx):
    """One layer of a stacked subtree (views)."""
    if isinstance(tree, dict):
        return {k: layer(v, *idx) for k, v in tree.items()}
    return tree[idx]


# ------------------------------------------------------------------ blocks --


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.to(F32)


def ssd(x, log_a, Bm, Cm, dt, chunk: int):
    """The SSD scan in float32: x [Bt, L, H, P], log_a / dt [Bt, L, H],
    B / C [Bt, L, N], from a zero state.  S_t = exp(log_a_t) S_{t-1} + dt_t B_t x_t^T,
    y_t = C_t S_t."""
    Bt, L, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"length {L} is not a multiple of the chunk {Q}")
    nc = L // Q
    xdt = (x * dt[..., None]).reshape(Bt, nc, Q, H, P)
    la = log_a.reshape(Bt, nc, Q, H)
    Bc, Cc = Bm.reshape(Bt, nc, Q, N), Cm.reshape(Bt, nc, Q, N)
    cum = torch.cumsum(la, dim=2)  # [Bt, nc, Q, H]
    cum_h = cum.transpose(2, 3)  # [Bt, nc, H, Q]
    seg = cum_h[..., :, None] - cum_h[..., None, :]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(causal, seg, -torch.inf))  # [Bt, nc, H, Q, Q]
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    y = torch.einsum("bchij,bcjhp->bcihp", CB[:, :, None] * decay, xdt)
    total = cum[:, :, -1]  # [Bt, nc, H]
    to_end = torch.exp(total[:, :, None] - cum)  # [Bt, nc, Q, H]
    S_chunk = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Bc, to_end, xdt)
    S = torch.zeros((Bt, H, N, P), dtype=F32, device=x.device)
    S_in = []
    for c in range(nc):
        S_in.append(S)
        S = torch.exp(total[:, c])[..., None, None] * S + S_chunk[:, c]
    S_in = torch.stack(S_in, dim=1)  # [Bt, nc, H, N, P]
    y = y + torch.einsum("bcin,bchnp,bcih->bcihp", Cc, S_in, torch.exp(cum))
    return y.reshape(Bt, L, H, P)


def mamba_block(w: Dict, p, x: torch.Tensor, prec: str) -> torch.Tensor:
    """One Mamba2 block over x [B, L, D] (float32), from a zero state."""
    Bsz, L, _ = x.shape
    Din = w["ssm_expand"] * w["d_model"]
    N, P, Wc = w["ssm_state"], w["ssm_headdim"], w["ssm_conv_width"]
    H = Din // P
    h = rmsnorm(x, p["norm"]["scale"], w["norm_eps"])
    z, xbc, dt_raw = torch.split(mm(h, p["in_proj"]["w"], prec), [Din, Din + 2 * N, H], dim=-1)
    prev = torch.zeros((Bsz, Wc - 1, xbc.shape[-1]), dtype=F32, device=x.device)
    xp = torch.cat([prev, xbc], dim=1)
    cw = p["conv_w"].to(F32)
    conv = sum(xp[:, i : i + L] * cw[i] for i in range(Wc)) + p["conv_b"].to(F32)
    xs, Bm, Cm = torch.split(F.silu(conv), [Din, N, N], dim=-1)
    xh = xs.reshape(Bsz, L, H, P)
    dt = F.softplus(dt_raw + p["dt_bias"].to(F32))
    log_a = dt * -torch.exp(p["A_log"].to(F32))
    y = ssd(xh, log_a, Bm, Cm, dt, w["ssm_chunk"])
    y = y + p["D"].to(F32)[:, None] * xh
    y = y.reshape(Bsz, L, Din) * F.silu(z)
    y = rmsnorm(y, p["out_norm"]["scale"], w["norm_eps"])
    return x + mm(y, p["out_proj"]["w"], prec)


# ------------------------------------------------------------------ models --


def _body(w: Dict, params, x: torch.Tensor, prec: str, remat: bool = False) -> torch.Tensor:
    """Every block in order over x [B, L, D]."""
    if w["family"] != "ssm":
        raise ValueError(f"the reference has no family {w['family']!r}")
    for i in range(w["n_layers"]):
        def block(x, i=i):
            return mamba_block(w, layer(params["blocks"], i), x, prec)
        x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
    return x


def _head(w: Dict, params, h: torch.Tensor, prec: str) -> torch.Tensor:
    h = rmsnorm(h, params["final_norm"]["scale"], w["norm_eps"])
    return mm(h, params["embed"]["emb"].T, prec)


def prefill_logits(w: Dict, params, tokens: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    """Last-position logits [B, V] of ``tokens`` [B, L]."""
    with torch.no_grad(), exact_matmul():
        x = params["embed"]["emb"][tokens].to(F32)
        x = _body(w, params, x, prec)
        return _head(w, params, x[:, -1], prec)


def loss(w: Dict, params32, tokens: torch.Tensor, labels: torch.Tensor,
         prec: str = "f32") -> torch.Tensor:
    """Mean next-token cross-entropy over every position, each block under
    a checkpoint (recomputed in the backward pass) and the head a batch row
    at a time, so that a full-width step fits beside its optimizer state."""
    x = params32["embed"]["emb"][tokens]
    x = _body(w, params32, x, prec, remat=True)
    tot = torch.zeros((), dtype=F32, device=x.device)

    def row_nll(h, y):
        logits = _head(w, params32, h, prec)
        return (torch.logsumexp(logits, -1) - logits.gather(-1, y[:, None])[:, 0]).sum()

    for b in range(x.shape[0]):
        tot = tot + checkpoint(row_nll, x[b], labels[b], use_reentrant=False)
    return tot / labels.numel()


# --------------------------------------------------------------- training --


def lr_at(opt: Dict, step: int) -> float:
    """Linear warmup to ``lr``, then a cosine to 0 at ``total_steps``."""
    if step < opt["warmup_steps"]:
        return opt["lr"] * (step + 1) / max(1, opt["warmup_steps"])
    t = min(max((step - opt["warmup_steps"]) / max(1, opt["total_steps"] - opt["warmup_steps"]),
                0.0), 1.0)
    return opt["lr"] * 0.5 * (1 + math.cos(math.pi * t))


def train(w: Dict, params, batches: Sequence[Tuple[torch.Tensor, torch.Tensor]], opt: Dict,
          prec: str = "f32") -> Dict:
    """AdamW steps over ``batches`` from ``params`` (the trees the program
    starts from): float32 arithmetic throughout, each parameter kept in its
    given dtype between steps (a bf16 weight is rounded to bf16 after each
    update, as the configuration stores it), moments in float32.  Returns
    each step's loss, the norms of each unit's first gradient as the
    optimizer takes it (clipped), and the norms of each unit's change over
    all the steps."""
    names = [n for n, _ in named_leaves(params)]
    start = dict(named_leaves(params))
    dtypes = {n: t.dtype for n, t in start.items()}
    p32 = {n: t.detach().to(F32).clone().requires_grad_(True) for n, t in start.items()}
    m = {n: torch.zeros_like(t) for n, t in p32.items()}
    v = {n: torch.zeros_like(t) for n, t in p32.items()}
    losses, first_grad = [], None
    with exact_matmul():
        for k, (tok, lab) in enumerate(batches):
            tree = _unflatten(p32)
            lval = loss(w, tree, tok, lab, prec)
            grads = dict(zip(names, torch.autograd.grad(lval, [p32[n] for n in names])))
            losses.append(float(lval.detach()))
            with torch.no_grad():
                gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
                scale = torch.clamp(opt["clip_norm"] / torch.clamp(gnorm, min=1e-9), max=1.0)
                lr, t = lr_at(opt, k), k + 1
                bc1, bc2 = 1 - opt["b1"] ** t, 1 - opt["b2"] ** t
                if k == 0:
                    first_grad = unit_norms(_unflatten({n: g * scale for n, g in grads.items()}))
                for n in names:
                    g = grads[n] * scale
                    m[n].mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
                    v[n].mul_(opt["b2"]).add_((1 - opt["b2"]) * g * g)
                    delta = (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + opt["eps"]) \
                        + opt["weight_decay"] * p32[n]
                    p32[n].copy_((p32[n] - lr * delta).to(dtypes[n]).to(F32))
            del grads, lval
    with torch.no_grad():
        change = unit_norms(_unflatten({n: p32[n] - start[n].to(F32) for n in names}))
    return {"losses": losses, "first_grad": first_grad, "change": change}


def _unflatten(flat: Dict[str, torch.Tensor]) -> Dict:
    tree: Dict = {}
    for path, t in flat.items():
        node = tree
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t
    return tree


def gaps(got: Dict[str, float], ref: Dict[str, float], skip: Sequence[str] = ()) -> Tuple[float, str]:
    """The worst unit's gap between two sets of norms: |got - ref| over the
    larger of the reference's norm of that unit and of the median unit;
    returns the gap and the unit's name."""
    keep = [n for n in ref if n not in skip]
    vals = sorted(ref[n] for n in keep)
    med = vals[len(vals) // 2] if vals else 0.0
    worst, at = 0.0, ""
    for n in keep:
        g = abs(got[n] - ref[n]) / max(ref[n], med, 1e-30)
        if g > worst or not at:
            worst, at = g, n
    return worst, at


def negligible(grads: Dict[str, float], share: float = 1e-3) -> List[str]:
    """Units whose reference gradient is under ``share`` of the median
    unit's: their change is round-off alone, so it is not compared."""
    vals = sorted(grads.values())
    med = vals[len(vals) // 2]
    return [n for n, g in grads.items() if g < share * med]
