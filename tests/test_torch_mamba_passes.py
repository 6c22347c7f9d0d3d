"""The Mamba block's passes (``repro_torch.kernels.mamba_passes``) on the CPU.

* ``ref.mamba_passes``, and ``mamba_block_apply`` through the router, equal
  bit for bit a frozen copy of the block's former inline body, at reduced
  mamba2 and zamba2 widths in f32 and bf16 (the CPU route is unchanged;
  ``tests/test_torch_mamba2.py`` still holds the block to the JAX one);
* the route rule of ``ops.mamba_passes``: CPU and ``meta`` tensors take the
  plain passes; with ``ops.PLAIN_DEVICES`` narrowed to the CPU, so that a
  ``meta`` tensor stands for a CUDA one, the kernels' route is taken exactly
  when autograd does not record (grad off, or nothing requiring grad), and a
  training step (remat full: the forward and its recompute) never takes it;
* ``mamba_passes_cuda.launches`` stays put on the CPU, and the wrappers
  refuse CPU tensors before anything is built;
* the byte floor of a block call at mamba2-1.3b's widths.

No JAX here; the kernels themselves are held on the card
(``tests/test_torch_cuda.py``).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.kernels.mamba_passes import kernel, ops, ref
from repro_torch.kernels.mamba_passes.kernel import (
    conv_silu_cuda, floor_bytes, gate_norm_cuda, mamba_passes_cuda, rmsnorm_cuda,
)
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models import mamba2
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
    """Spies on both routes of ``ops.mamba_passes``: the plain passes run
    as they are, the kernels' route records its call and returns x."""

    def __init__(self, monkeypatch):
        self.plain = self.kernels = 0
        plain = ref.mamba_passes

        def spy_plain(*a):
            self.plain += 1
            return plain(*a)

        def spy_kernels(cfg, p, x, scan, addend=None):
            self.kernels += 1
            return x

        monkeypatch.setattr(ref, "mamba_passes", spy_plain)
        monkeypatch.setattr(ops, "mamba_passes_cuda", spy_kernels)


def _meta(t):
    return t.detach().to("meta")


def test_cpu_and_meta_take_the_plain_passes(monkeypatch):
    routes = _Routes(monkeypatch)
    cfg, p, x = _block("mamba2-1.3b", "float32")
    with torch.no_grad():
        mamba2.mamba_block_apply(cfg, p, x)
        out = mamba2.mamba_block_apply(cfg, tree_map(_meta, p), _meta(x))
    assert out.device.type == "meta" and out.shape == x.shape
    assert (routes.plain, routes.kernels) == (2, 0)


@pytest.mark.parametrize("grad,x_grad,leaf_grad,route", [
    (False, False, False, "kernels"),
    (False, True, True, "kernels"),
    (True, False, False, "kernels"),
    (True, True, False, "plain"),
    (True, False, True, "plain"),
])
def test_only_a_block_that_autograd_records_leaves_the_kernels(monkeypatch, grad, x_grad,
                                                               leaf_grad, route):
    """On a device outside ``PLAIN_DEVICES`` (``meta``, with the CPU the only
    plain device), grad on and ``x`` or a block leaf requiring grad is the
    plain route; anything else the kernels'."""
    monkeypatch.setattr(ops, "PLAIN_DEVICES", ("cpu",))
    routes = _Routes(monkeypatch)
    cfg, p, x = _block("mamba2-1.3b", "float32")
    p = tree_map(lambda t: _meta(t).requires_grad_(leaf_grad and t.is_floating_point()), p)
    x = _meta(x).requires_grad_(x_grad)
    with torch.set_grad_enabled(grad):
        mamba2.mamba_block_apply(cfg, p, x)
    assert (routes.plain, routes.kernels) == ((1, 0) if route == "plain" else (0, 1))


def test_a_training_step_with_remat_never_takes_the_kernels(monkeypatch):
    """A remat-full loss and its gradient, on ``meta`` standing for the card:
    each layer's forward and its recompute take the plain passes."""
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
    assert (routes.plain, routes.kernels) == (2 * cfg.n_layers, 0)
    with torch.no_grad():
        model.prefill(params, {"tokens": tok})
    assert routes.kernels == cfg.n_layers


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
    ]
    before = mamba_passes_cuda.launches
    for call in calls:
        with pytest.raises(ValueError, match="CUDA device"):
            call()
    assert kernel.LIBRARY._lib is None and mamba_passes_cuda.launches == before


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
