"""The Mamba block's passes (``repro_torch.kernels.mamba_passes``) on the CPU.

* ``ref.mamba_passes``, and ``mamba_block_apply`` through the router, equal
  bit for bit a frozen copy of the block's former inline body, at reduced
  mamba2 and zamba2 widths in f32 and bf16 (the CPU route is unchanged;
  ``tests/test_torch_mamba2.py`` still holds the block to the JAX one);
* the route rule of ``ops.mamba_passes``: CPU and ``meta`` tensors take the
  plain passes; with ``ops.PLAIN_DEVICES`` narrowed to the CPU, so that a
  ``meta`` tensor stands for a CUDA one, the kernels' route is taken exactly
  when autograd does not record (grad off, or nothing requiring grad), and
  the Functions' route (``kernel.mamba_passes_grad``) when it records ``x``,
  the addend or a leaf, as each layer of a training step does twice (remat
  full: the forward and its recompute);
* the Functions' route itself, on the CPU with ``ops.PLAIN_DEVICES``
  narrowed to ``meta`` and the six kernel wrappers replaced by plain stand-ins
  that keep their contracts (the gate's backward writes only the z columns of
  the input projection's gradient and hands the D skip's dx on; the conv's
  backward adds it and writes the other columns): a block's gradients, with
  one or two B/C groups and an addend, and a remat-full training step's, equal
  autograd's through the plain passes, with ``launches`` up by two a layer a
  step (the recompute counted) and ``backward_calls`` by one;
* ``mamba_passes_cuda.launches`` stays put on the CPU, and the wrappers
  refuse CPU tensors before anything is built;
* the byte floors of a block call at mamba2-1.3b's widths, forward and
  backward, and the backward's partial-sum cuts against the CUDA source.

No JAX here; the kernels themselves are held on the card
(``tests/test_torch_cuda.py``).
"""

import dataclasses
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.kernels.mamba_passes import kernel, ops, ref
from repro_torch.kernels.mamba_passes.kernel import (
    backward_floor_bytes, conv_silu_bwd_cuda, conv_silu_cuda, floor_bytes, gate_norm_bwd_cuda,
    gate_norm_cuda, mamba_passes_cuda, mamba_passes_grad, rmsnorm_bwd_cuda, rmsnorm_cuda,
)
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models import mamba2
from repro_torch.configs.port_only import get_port_config
from repro_torch.models.common import linear, rmsnorm
from repro_torch.models.model_api import build_model
from repro_torch.tree import tree_leaves, tree_map

ARCHS = {"mamba2-1.3b": {}, "zamba2-2.7b": dict(n_layers=4, head_dim=80)}


def _former_block(cfg, p, x):
    """``models/mamba2.mamba_block_apply`` as it was before its passes moved
    to ``kernels/mamba_passes/ref.py`` (with ``_split_in_proj`` and
    ``_ssm_from_xbc`` inlined), spans left out: the frozen reference."""
    Din, N, H, Pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    res = x
    h = rmsnorm(p["norm"], x, cfg.norm_eps)
    zxbcdt = linear(p["in_proj"], h)
    z, xbc, dt_raw = torch.split(zxbcdt, [Din, Din + 2 * N, H], dim=-1)
    W, L = cfg.ssm_conv_width, xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    conv = sum(pad[:, i : i + L, :] * p["conv_w"][i] for i in range(W))
    xbc = F.silu((conv + p["conv_b"]).float()).to(x.dtype)
    xs, Bm, Cm = torch.split(xbc, [Din, N, N], dim=-1)
    xh = xs.reshape(xs.shape[0], L, H, Pd)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    log_a = dt * -torch.exp(p["A_log"])
    y = ssd_scan(xh, log_a, Bm, Cm, dt, cfg.ssm_chunk)
    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(x.shape[0], x.shape[1], cfg.d_inner)
    y = y.to(x.dtype) * F.silu(z.float()).to(x.dtype)
    y = rmsnorm(p["out_norm"], y, cfg.norm_eps)
    return res + linear(p["out_proj"], y)


def _block(arch, dtype, seed=0):
    cfg = get_config(arch).reduced(dtype=dtype, **ARCHS[arch])
    gen = torch.Generator().manual_seed(seed)
    p = mamba2.init_mamba_block(gen, cfg, getattr(torch, dtype))
    # random conv bias, D, norm scales and dt_bias, so every term of the passes shows
    for k, shape in (("conv_b", p["conv_b"].shape), ("D", p["D"].shape),
                     ("dt_bias", p["dt_bias"].shape)):
        p[k] = torch.randn(shape, generator=gen)
    for k in ("norm", "out_norm"):
        p[k] = {"scale": 1 + 0.1 * torch.randn(p[k]["scale"].shape, generator=gen)}
    x = torch.randn((2, 3 * cfg.ssm_chunk, cfg.d_model), generator=gen).to(getattr(torch, dtype))
    return cfg, p, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_plain_passes_equal_the_former_block_bit_for_bit(arch, dtype):
    cfg, p, x = _block(arch, dtype)
    want = _former_block(cfg, p, x)
    before = mamba_passes_cuda.launches
    got = ref.mamba_passes(cfg, p, x, ssd_scan)
    routed = mamba2.mamba_block_apply(cfg, p, x)
    assert got.dtype == x.dtype and got.shape == x.shape
    assert torch.equal(got, want) and torch.equal(routed, want)
    assert mamba_passes_cuda.launches == before


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_train_step_on_the_cpu_leave_the_counter(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(dtype="float32", **ARCHS[arch]),
                              remat=True, remat_policy="full")
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tok = torch.randint(0, cfg.vocab_size, (2, 2 * cfg.ssm_chunk + 1),
                        generator=torch.Generator().manual_seed(1))
    before = mamba_passes_cuda.launches
    model.prefill(params, {"tokens": tok[:, :-1]})
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = model.loss(params, {"tokens": tok[:, :-1], "labels": tok[:, 1:]})
    torch.autograd.grad(loss, leaves)
    assert mamba_passes_cuda.launches == before


class _Routes:
    """Spies on the three routes of ``ops.mamba_passes``: the plain passes
    run as they are; the kernels' route records its call and returns x; the
    Functions' route records its call and runs the plain passes, so that
    autograd and remat see a real block."""

    def __init__(self, monkeypatch):
        self.plain = self.kernels = self.grad = 0
        plain = ref.mamba_passes

        def spy_plain(*a):
            self.plain += 1
            return plain(*a)

        def spy_kernels(cfg, p, x, scan, addend=None):
            self.kernels += 1
            return x

        def spy_grad(*a):
            self.grad += 1
            return plain(*a)

        monkeypatch.setattr(ref, "mamba_passes", spy_plain)
        monkeypatch.setattr(ops, "mamba_passes_cuda", spy_kernels)
        monkeypatch.setattr(ops, "mamba_passes_grad", spy_grad)


def _meta(t):
    return t.detach().to("meta")


def test_cpu_and_meta_take_the_plain_passes(monkeypatch):
    routes = _Routes(monkeypatch)
    cfg, p, x = _block("mamba2-1.3b", "float32")
    with torch.no_grad():
        mamba2.mamba_block_apply(cfg, p, x)
        out = mamba2.mamba_block_apply(cfg, tree_map(_meta, p), _meta(x))
    assert out.device.type == "meta" and out.shape == x.shape
    assert (routes.plain, routes.kernels, routes.grad) == (2, 0, 0)


@pytest.mark.parametrize("grad,x_grad,leaf_grad,route", [
    (False, False, False, "kernels"),
    (False, True, True, "kernels"),
    (True, False, False, "kernels"),
    (True, True, False, "functions"),
    (True, False, True, "functions"),
])
def test_only_a_block_that_autograd_records_leaves_the_kernels(monkeypatch, grad, x_grad,
                                                               leaf_grad, route):
    """On a device outside ``PLAIN_DEVICES`` (``meta``, with the CPU the only
    plain device), grad on and ``x`` or a block leaf requiring grad leaves
    the kernels' route for the Functions' (the same kernels, each with its
    backward); anything else takes the kernels'.  Neither is the plain
    route."""
    monkeypatch.setattr(ops, "PLAIN_DEVICES", ("cpu",))
    routes = _Routes(monkeypatch)
    cfg, p, x = _block("mamba2-1.3b", "float32")
    p = tree_map(lambda t: _meta(t).requires_grad_(leaf_grad and t.is_floating_point()), p)
    x = _meta(x).requires_grad_(x_grad)
    with torch.set_grad_enabled(grad):
        mamba2.mamba_block_apply(cfg, p, x)
    want = (0, 0, 1) if route == "functions" else (0, 1, 0)
    assert (routes.plain, routes.kernels, routes.grad) == want


@pytest.mark.parametrize("addend_grad,route", [(False, "kernels"), (True, "functions")])
def test_a_block_whose_addend_autograd_records_takes_the_functions(monkeypatch, addend_grad,
                                                                   route):
    """A hybrid site's addend counts as an input: recorded by autograd, it
    sends the block to the Functions' route even where nothing else requires
    grad (the kernels' route would drop its gradient)."""
    monkeypatch.setattr(ops, "PLAIN_DEVICES", ("cpu",))
    routes = _Routes(monkeypatch)
    cfg, p, x = _block("mamba2-1.3b", "float32")
    p, x = tree_map(_meta, p), _meta(x)
    mamba2.mamba_block_apply(cfg, p, x, addend=_meta(x).requires_grad_(addend_grad))
    want = (0, 0, 1) if route == "functions" else (0, 1, 0)
    assert (routes.plain, routes.kernels, routes.grad) == want


def test_a_training_step_with_remat_never_takes_the_kernels(monkeypatch):
    """A remat-full loss and its gradient, on ``meta`` standing for the card:
    each layer's forward and its recompute take the Functions' route, never
    the kernels' route without a backward nor the plain passes; a prefill
    with grad off takes the kernels' route once a layer."""
    monkeypatch.setattr(ops, "PLAIN_DEVICES", ("cpu",))
    routes = _Routes(monkeypatch)
    cfg = dataclasses.replace(get_config("mamba2-1.3b").reduced(dtype="float32"), remat=True,
                              remat_policy="full")
    model = build_model(cfg, "meta")
    params = tree_map(_meta, build_model(cfg, "cpu").init(torch.Generator().manual_seed(0)))
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    tok = torch.zeros((2, 2 * cfg.ssm_chunk), dtype=torch.long, device="meta")
    loss = model.loss(params, {"tokens": tok, "labels": tok})
    torch.autograd.grad(loss, leaves)
    assert (routes.plain, routes.kernels, routes.grad) == (0, 0, 2 * cfg.n_layers)
    with torch.no_grad():
        model.prefill(params, {"tokens": tok})
    assert (routes.kernels, routes.grad) == (cfg.n_layers, 2 * cfg.n_layers)


def test_wrappers_refuse_cpu_tensors_before_building():
    cfg, p, x = _block("mamba2-1.3b", "bfloat16")
    z = torch.zeros((2, 4, 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_nheads),
                    dtype=torch.bfloat16)
    xs = torch.zeros((2, 4, cfg.d_inner), dtype=torch.bfloat16)
    y = xs.view(2, 4, cfg.ssm_nheads, cfg.ssm_headdim)
    calls = [
        lambda: rmsnorm_cuda(x, p["norm"]["scale"], cfg.norm_eps),
        lambda: conv_silu_cuda(z, p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"],
                               cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads),
        lambda: gate_norm_cuda(y, xs, z, p["D"], p["out_norm"]["scale"], cfg.norm_eps,
                               cfg.ssm_headdim),
        lambda: mamba_passes_cuda(cfg, p, x, ssd_scan),
        lambda: rmsnorm_bwd_cuda(x, p["norm"]["scale"], x, cfg.norm_eps),
        lambda: conv_silu_bwd_cuda(z, p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"], xs,
                                   xs[..., :cfg.ssm_state], xs[..., :cfg.ssm_state],
                                   xs[..., :cfg.ssm_nheads].float(),
                                   xs[..., :cfg.ssm_nheads].float(), cfg.d_inner, cfg.ssm_state,
                                   cfg.ssm_nheads),
        lambda: gate_norm_bwd_cuda(y, xs, z, p["D"], p["out_norm"]["scale"], xs, cfg.norm_eps,
                                   cfg.ssm_headdim),
        lambda: mamba_passes_grad(cfg, p, x.requires_grad_(True), ssd_scan),
    ]
    before = (mamba_passes_cuda.launches, mamba_passes_cuda.backward_calls)
    for call in calls:
        with pytest.raises(ValueError, match="CUDA device"):
            call()
    assert kernel.LIBRARY._lib is None
    assert (mamba_passes_cuda.launches, mamba_passes_cuda.backward_calls) == before


def test_byte_floor_at_mamba2_widths():
    """Per token and block, bf16: norm 4 KB in and out; conv the xBC and dt
    columns in, x, B, C out and dt, log_a in f32; gate_norm y, x, z in and
    the out_proj input out; the residual add two reads and a write.  About
    70 KB a token, 18.7 GB (5.6 ms at 3.35 TB/s) a call at 64 x 4096."""
    cfg = get_config("mamba2-1.3b")
    per = floor_bytes(cfg, 1, 2)
    assert per == {"norm": 8192, "conv": 2 * (2 * 4352 + 64) + 512, "gate_norm": 32768,
                   "add": 12288}
    total = sum(floor_bytes(cfg, 64 * 4096, 2).values())
    assert total == 71296 * 64 * 4096
    assert 5.5 < total / 3.35e12 * 1e3 < 5.6


def test_backward_byte_floor_at_mamba2_widths():
    """Per token and block, bf16: the gate's backward y, x, z and the
    output's gradient in, dy, the D skip's dx and dz out; the conv's the
    xBC and dt columns, the scan's and the D skip's dx, dB and dC in (d dt,
    d log_a in f32) and the columns' gradient out; the norm's x and dh in, dx
    out.  About 102 KB a token: 1.72 GB (0.51 ms at 3.35 TB/s) a block at
    training's 8 x 2048."""
    cfg = get_config("mamba2-1.3b")
    per = backward_floor_bytes(cfg, 1, 2)
    cols = 4096 + 256 + 64
    assert per == {"gate_norm": 7 * 4096 * 2, "conv": (2 * cols + 2 * 4096 + 256) * 2 + 512,
                   "norm": 3 * 2048 * 2}
    total = sum(backward_floor_bytes(cfg, 8 * 2048, 2).values())
    assert total == 104704 * 8 * 2048
    assert 0.51 < total / 3.35e12 * 1e3 < 0.52


def test_partial_sum_cuts_match_the_cuda_source():
    """The wrappers size the backward kernels' partial sums by the source's
    cuts: rows a block of the norms' backward sums, tokens a thread of the
    conv's, and the row widths they take (4 chunks a thread of at most
    BWD_THREADS)."""
    src = (Path(kernel.__file__).resolve().parents[2] / "csrc" / "mamba_passes.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("BWD_ROWS") == kernel.BWD_ROWS
    assert const("BWD_RUN") == kernel.BWD_RUN
    assert 4 * const("BWD_THREADS") == kernel.BWD_MAX_CHUNKS
    assert "c <= 4; c *= 2" in src  # bwd_cpt: 1, 2 or 4 chunks a thread


def test_zamba2_blocks_take_the_same_router(monkeypatch):
    """zamba2's hybrid model calls ``mamba_block_apply`` for its Mamba blocks,
    so its blocks are routed like mamba2's, with no test of the model's name."""
    routes = _Routes(monkeypatch)
    cfg = get_config("zamba2-2.7b").reduced(dtype="float32", **ARCHS["zamba2-2.7b"])
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    model.prefill(params, {"tokens": torch.zeros((1, cfg.ssm_chunk), dtype=torch.long)})
    assert (routes.plain, routes.kernels) == (cfg.n_layers, 0)
    monkeypatch.setattr(ops, "PLAIN_DEVICES", ("cpu",))
    with torch.no_grad():
        model.prefill(tree_map(_meta, params),
                      {"tokens": torch.zeros((1, cfg.ssm_chunk), dtype=torch.long,
                                             device="meta")})
    assert routes.kernels == cfg.n_layers


class _StandIns:
    """The six kernel wrappers of ``kernel`` replaced by plain CPU stand-ins
    with the kernels' contracts, so that ``mamba_passes_grad`` (the
    Functions, their ``Link`` and the counters) runs on the CPU: each
    forward is the plain pass, each backward autograd's through it; the
    gate's backward writes only the z columns of a NaN-filled input
    projection gradient, and the conv's backward adds the D skip's dx
    (``dx_extra``) to the scan's and writes the other columns."""

    def __init__(self, monkeypatch, cfg):
        self.cfg = cfg
        for name in ("rmsnorm_cuda", "rmsnorm_bwd_cuda", "conv_silu_cuda", "conv_silu_bwd_cuda",
                     "gate_norm_cuda", "gate_norm_bwd_cuda"):
            monkeypatch.setattr(kernel, name, getattr(self, name))

    @staticmethod
    def _grads(fn, inputs, douts):
        xs = [t.detach().requires_grad_(True) for t in inputs]
        with torch.enable_grad():
            outs = fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return torch.autograd.grad(outs, xs, douts)

    def rmsnorm_cuda(self, x, scale, eps):
        return rmsnorm({"scale": scale}, x, eps)

    def rmsnorm_bwd_cuda(self, x, scale, dout, eps):
        return self._grads(lambda a, s: rmsnorm({"scale": s}, a, eps), (x, scale), dout)

    def _conv(self, zx, w, b, bias, A_log):
        p = {"conv_w": w, "conv_b": b, "dt_bias": bias, "A_log": A_log}
        xh, log_a, Bm, Cm, dt = ref.conv_pass(self.cfg, p, zx, zx.dtype)
        return xh.reshape(*xh.shape[:2], -1), Bm, Cm, dt, log_a

    def conv_silu_cuda(self, zx, w, b, bias, A_log, d_inner, n_state, n_heads, n_groups=1):
        return tuple(t.contiguous() for t in self._conv(zx, w, b, bias, A_log))

    def conv_silu_bwd_cuda(self, zx, w, b, bias, A_log, dx, dB, dC, ddt, dlog_a, d_inner,
                           n_state, n_heads, n_groups=1, dx_extra=None, dzx=None):
        dx = dx if dx_extra is None else dx + dx_extra
        g = self._grads(self._conv, (zx, w, b, bias, A_log), (dx, dB, dC, ddt, dlog_a))
        dzx = torch.zeros_like(zx) if dzx is None else dzx
        dzx[..., d_inner:] = g[0][..., d_inner:]
        return (dzx,) + tuple(g[1:])

    def _gate(self, y, x, zx, D, scale):
        xh = x.reshape(y.shape)
        return ref.gate_pass(self.cfg, {"D": D, "out_norm": {"scale": scale}}, y, xh, zx, x.dtype)

    def gate_norm_cuda(self, y, x, zx, D, scale, eps, headdim, n_groups=1):
        return self._gate(y, x, zx, D, scale)

    def gate_norm_bwd_cuda(self, y, x, zx, D, scale, dout, eps, headdim, n_groups=1, dzx=None):
        dy, dx, dz, dD, dscale = self._grads(self._gate, (y, x, zx, D, scale), dout)
        dzx = torch.full_like(zx, float("nan")) if dzx is None else dzx
        Din = x.shape[-1]
        dzx[..., :Din] = dz[..., :Din]
        return dy, dx, dzx, dD, dscale


def _tiny_zamba2_7b():
    """zamba2-7b's block with its two B/C groups, at 64 channels."""
    return dataclasses.replace(get_port_config("zamba2-7b"), d_model=64, ssm_expand=2,
                               ssm_state=8, ssm_headdim=16, ssm_chunk=16, n_layers=1,
                               dtype="float32")


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b", "zamba2-7b"])
def test_the_functions_route_gives_the_plain_gradient(monkeypatch, arch):
    """One block through ``mamba_passes_grad`` on the stand-ins, against
    autograd through the plain passes on the same inputs: the output and
    the gradients of x, the addend (zamba2-7b's block, two B/C groups) and
    every leaf within 1e-5 of max|ref| (f32: one sum taken in another
    order), none NaN (every column of the projection's gradient written);
    one block call counted, one block backward."""
    if arch == "zamba2-7b":
        cfg = _tiny_zamba2_7b()
        gen = torch.Generator().manual_seed(0)
        p = mamba2.init_mamba_block(gen, cfg, torch.float32)
        for k in ("conv_b", "D", "dt_bias"):
            p[k] = torch.randn(p[k].shape, generator=gen)
        x = torch.randn((2, 3 * cfg.ssm_chunk, cfg.d_model), generator=gen)
    else:
        cfg, p, x = _block(arch, "float32")
    addend = torch.randn(x.shape) if arch == "zamba2-7b" else None
    monkeypatch.setattr(ops, "PLAIN_DEVICES", ("meta",))
    _StandIns(monkeypatch, cfg)
    r = torch.randn(x.shape)

    def grads(route):
        xs = x.clone().requires_grad_(True)
        ad = None if addend is None else addend.clone().requires_grad_(True)
        ps = tree_map(lambda t: t.clone().requires_grad_(True), p)
        out = route(cfg, ps, xs, ssd_scan, ad)
        wrt = [xs] + ([] if ad is None else [ad]) + tree_leaves(ps)
        return out, torch.autograd.grad((out * r).sum(), wrt)

    before = (mamba_passes_cuda.launches, mamba_passes_cuda.backward_calls)
    got_out, got = grads(ops.mamba_passes)
    counted = (mamba_passes_cuda.launches - before[0],
               mamba_passes_cuda.backward_calls - before[1])
    want_out, want = grads(ref.mamba_passes)
    assert counted == (1, 1)
    assert _rel(got_out, want_out) <= 1e-5
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert not g.isnan().any() and g.dtype == w.dtype and _rel(g, w) <= 1e-5


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_a_remat_training_step_on_the_functions_counts_each_layer_twice(monkeypatch, arch):
    """A reduced remat-full train step (loss and every gradient) through the
    Functions on the stand-ins equals the plain passes' step within 1e-5 of
    max|ref|; ``launches`` rises by 2 n_layers (the forward and remat's
    recompute, which stops after the output projection's saved input) and
    ``backward_calls`` by n_layers."""
    cfg = dataclasses.replace(get_config(arch).reduced(dtype="float32", **ARCHS[arch]),
                              remat=True, remat_policy="full")
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tok = torch.randint(0, cfg.vocab_size, (2, 2 * cfg.ssm_chunk + 1),
                        generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}

    def step():
        ps = tree_map(lambda t: t.clone().requires_grad_(True), params)
        loss = model.loss(ps, batch)
        return loss, torch.autograd.grad(loss, tree_leaves(ps))

    want_loss, want = step()
    monkeypatch.setattr(ops, "PLAIN_DEVICES", ("meta",))
    _StandIns(monkeypatch, cfg)
    before = (mamba_passes_cuda.launches, mamba_passes_cuda.backward_calls)
    loss, got = step()
    assert (mamba_passes_cuda.launches - before[0],
            mamba_passes_cuda.backward_calls - before[1]) == (2 * cfg.n_layers, cfg.n_layers)
    assert abs(loss.item() - want_loss.item()) <= 1e-5 * abs(want_loss.item())
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5
