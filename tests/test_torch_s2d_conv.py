"""The port's s2d-conv variant op against the JAX package's, on the CPU.

Inputs are drawn with numpy and handed to both packages; the port's
weights go through ``params_from_numpy`` in the JAX layouts.  The JAX
side runs its Pallas kernel in interpret mode and its ``ref.py`` oracle,
as ``tests/test_kernels.py`` does.  On the CPU the port's
``s2d_variant_conv`` is its plain version, so the CUDA kernel's launch
counter must stay at 0 here; ``test_torch_cuda.py`` holds the kernel
itself against the plain version on a card.

Tolerances are ``tests/test_kernels.py``'s: f32 1e-5 (the same f32
products, summed in another order), bf16 0.15 (bf16 output rounding of
values of order 10).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.s2d_conv.kernel import s2d_conv_pallas
from repro.kernels.s2d_conv.ops import s2d_variant_conv_rs as j_conv_rs
from repro.kernels.s2d_conv.ref import d2s as j_d2s
from repro.kernels.s2d_conv.ref import s2d as j_s2d
from repro.kernels.s2d_conv.ref import s2d_conv_ref as j_ref

from repro_torch.convert import params_from_numpy
from repro_torch.kernels.s2d_conv.kernel import s2d_conv_cuda
from repro_torch.kernels.s2d_conv.ops import s2d_variant_conv, s2d_variant_conv_rs
from repro_torch.kernels.s2d_conv.ref import d2s, s2d, s2d_conv_ref

SHAPES = [  # tests/test_kernels.py
    (2, 8, 8, 16, 32, 2),
    (1, 16, 16, 64, 64, 2),
    (2, 12, 12, 36, 72, 3),
    (1, 8, 8, 256, 128, 2),
    (1, 4, 4, 512, 512, 2),
]
TOL = {"float32": 1e-5, "bfloat16": 0.15}


def _draw(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("shape,g", [((2, 8, 8, 16), 2), ((1, 6, 6, 18), 3),
                                     ((2, 4, 6, 36), 3)])
def test_d2s_s2d_match_the_reference_order(shape, g):
    """Same (gy, gx, c') channel order as the JAX package — bit-equal
    rearrangements, and s2d inverts d2s."""
    x = _draw(shape, 0)
    t = params_from_numpy({"x": x}, device="cpu")["x"]
    got = d2s(t, g)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_d2s(jnp.asarray(x), g)))
    np.testing.assert_array_equal(s2d(got, g).numpy(), x)
    y = _draw((shape[0], shape[1] * g, shape[2] * g, 5), 1)
    np.testing.assert_array_equal(
        s2d(torch.from_numpy(y), g).numpy(), np.asarray(j_s2d(jnp.asarray(y), g)))


def test_pixel_shuffle_orders_channels_differently():
    """Why the port writes its own reshapes: torch's pixel_unshuffle
    (NCHW, channel index c'*g^2 + ...) is a different tensor."""
    x = torch.from_numpy(_draw((1, 4, 4, 8), 2))
    ps = torch.nn.functional.pixel_unshuffle(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    assert ps.shape == s2d(x, 2).shape
    assert not torch.equal(ps, s2d(x, 2))


@pytest.mark.parametrize("B,H,W,C,K,g", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_s2d_variant_conv_matches_reference(B, H, W, C, K, g, dtype):
    x = _draw((B, H, W, C), 10 + C)
    w = _draw((C // g**2, K // g**2), 20 + K)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xj, wj = jnp.asarray(x, jd), jnp.asarray(w, jd)
    pallas = np.asarray(s2d_conv_pallas(xj, wj, g, tile_h=4, tile_w=4,
                                        interpret=True).astype(jnp.float32))
    oracle = np.asarray(j_ref(xj, wj, g).astype(jnp.float32))
    # the same (dtype-rounded) numbers for the port, in the JAX layouts
    p = params_from_numpy({"x": np.asarray(xj), "w": np.asarray(wj)}, device="cpu",
                          expect={"w": (C // g**2, K // g**2)})
    assert p["x"].dtype == getattr(torch, dtype)
    before = s2d_conv_cuda.launches
    got = s2d_variant_conv(p["x"], p["w"], g)
    plain = s2d_conv_ref(p["x"], p["w"], g)
    assert s2d_conv_cuda.launches == before == 0  # CPU -> plain version
    assert got.shape == (B, H, W, K) and got.dtype == p["x"].dtype
    assert torch.equal(got, plain)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), pallas, atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), oracle, atol=tol, rtol=tol)


@pytest.mark.parametrize("R,S,g", [(3, 3, 2), (1, 3, 2), (2, 2, 2), (3, 3, 3)])
def test_s2d_variant_conv_rs_matches_reference(R, S, g):
    """im2col at the d2s resolution with 'same' padding (R//2, (R-1)//2)."""
    C, K = 4 * g * g, 8 * g * g
    x = _draw((2, 6, 6, C), 30)
    wf = _draw((R, S, C // g**2, K // g**2), 31)
    want = np.asarray(j_conv_rs(jnp.asarray(x), jnp.asarray(wf), g))
    p = params_from_numpy({"x": x, "w_full": wf}, device="cpu")
    got = s2d_variant_conv_rs(p["x"], p["w_full"], g)
    assert got.shape == (2, 6, 6, K)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_variant_layers_of_the_main_path_run_on_the_host():
    """The pointwise variant layers the multicam_heavy plans select, at
    their real widths, through the plain version on the CPU."""
    from repro_torch.core import SCENARIOS
    from repro_torch.core.variant_exec import pointwise_variants, run_pointwise_variants
    from repro_torch.costmodel.maestro import PLATFORMS

    plans, _ = SCENARIOS["multicam_heavy"].plans(PLATFORMS["6k_1ws2os"])
    layers = {v.name: v for p in plans for v in pointwise_variants(p)}
    assert {"resnet50.s3b1.conv3", "resnet50.s3b1.down", "resnet50.s3b2.conv1",
            "swin_tiny.s2b0.mlp1", "swin_tiny.s2b0.mlp2"} <= set(layers)
    assert layers["resnet50.s3b1.down"].x_shape() == (1, 28, 28, 512)
    assert layers["swin_tiny.s2b0.mlp2"].x_shape() == (1, 196, 1, 1536)
    swin = [p for p in plans if p.model.name == "swin_tiny"]
    outs = run_pointwise_variants(swin, device="cpu")
    assert outs and all(o.shape == (1, 196, 1, layers[n].K) for n, o in outs.items())
    assert all(bool(torch.isfinite(o).all()) for o in outs.values())
    assert s2d_conv_cuda.launches == 0
