"""Tests of the torch port that need a CUDA card (marker ``cuda``).

They skip where ``torch.cuda.is_available()`` is false, deciding inside
each test.  This file imports neither jax nor the JAX package, so it also
runs on a machine that has only torch:

    python -m pytest -m cuda tests/test_torch_cuda.py

* the s2d-conv kernel (``csrc/s2d_conv.cu``) against its plain version,
  in f32 and bf16, with the smoke run's tolerances;
* ``simulate_batch`` on the card against the host SoA engine.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

SHAPES = [  # tests/test_kernels.py, plus a ragged and a main-path one
    (2, 8, 8, 16, 32, 2), (1, 16, 16, 64, 64, 2), (2, 12, 12, 36, 72, 3),
    (1, 8, 8, 256, 128, 2), (1, 4, 4, 512, 512, 2), (3, 5, 7, 20, 12, 2),
    (1, 28, 28, 256, 1024, 2),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.parametrize("B,H,W,C,K,g", SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_kernel_matches_plain_version(card, B, H, W, C, K, g, dtype, tol):
    from repro_torch.kernels.s2d_conv.kernel import s2d_conv_cuda
    from repro_torch.kernels.s2d_conv.ops import s2d_variant_conv
    from repro_torch.kernels.s2d_conv.ref import s2d_conv_ref

    rng = np.random.default_rng(C + K)
    x = torch.from_numpy(rng.standard_normal((B, H, W, C), dtype=np.float32)).to(card, dtype)
    w = torch.from_numpy(rng.standard_normal((C // g**2, K // g**2),
                                             dtype=np.float32)).to(card, dtype)
    before = s2d_conv_cuda.launches
    got = s2d_variant_conv(x, w, g)
    assert s2d_conv_cuda.launches == before + 1  # a CUDA tensor launches the kernel
    ref = s2d_conv_ref(x, w, g)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == dtype
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item()


def test_kernel_wrapper_rejects_what_it_does_not_take(card):
    from repro_torch.kernels.s2d_conv.kernel import s2d_conv_cuda

    x = torch.zeros((1, 4, 4, 16), device=card)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        s2d_conv_cuda(x.half(), torch.zeros((4, 4), device=card).half(), 2)
    with pytest.raises(ValueError, match="C/g"):
        s2d_conv_cuda(x, torch.zeros((3, 4), device=card), 2)
    with pytest.raises(ValueError, match="contiguous"):
        s2d_conv_cuda(x.transpose(1, 2), torch.zeros((4, 4), device=card), 2)


def test_argmin_takes_the_first_minimum_on_the_card(card):
    """The batch engine's tie-breaks (rid order, first-min ascending k)
    rest on argmin returning the first of equal minima, also when the
    reduction is split across threads."""
    x = torch.ones((64, 8192), dtype=torch.float64, device=card)
    cols = torch.arange(64, device=card) * 97 % 8192
    x[torch.arange(64, device=card), cols] = 0.0
    x[torch.arange(64, device=card), cols + 5] = 0.0
    x[:, -1] = 0.0
    assert torch.equal(x.argmin(1), cols)
    assert torch.equal(torch.where(x < 0.5, 0.0, torch.inf).argmin(1), cols)


def test_batch_engine_on_the_card_matches_host_soa(card):
    from repro_torch.core import SATURATION_SCENARIOS, make_scheduler, simulate, simulate_batch
    from repro_torch.costmodel.maestro import PLATFORMS

    plans, tasks = SATURATION_SCENARIOS["saturation_3x"].plans(PLATFORMS["4k_1ws2os"])
    got = simulate_batch(plans, tasks, 0.05, make_scheduler("terastal"), [0, 1],
                         device=card)
    for s, res in zip([0, 1], got):
        want = simulate(plans, tasks, 0.05, make_scheduler("terastal"), seed=s,
                        engine="soa")
        assert res.fingerprint() == want.fingerprint()
