"""The port's SSD scan against the JAX package's, on the CPU.

Inputs are drawn with numpy at ``tests/test_kernels.py``'s SSD shapes
and dtypes and handed to both packages.  The JAX side runs its oracle
``ssd_naive``, its plain ``ssd_chunked`` and its Pallas kernel in
interpret mode (``ssd_scan(backend="pallas", interpret=True)``), with
``jax_enable_x64`` off (another test module in the same worker may have
turned it on).  On the CPU the port's ``ssd_scan`` runs its plain
``ssd_chunked``, so the CUDA kernel's launch counter must stay at 0 here;
``test_torch_cuda.py`` holds the kernel itself against the plain version
on a card.

Tolerances: ``tests/test_kernels.py``'s: f32 max|d| < 1e-5 max|ref|
against the oracle (the same f32 products, summed in another order);
in the dtype test 1e-4 (f32) and 0.15 (bf16: inputs and output rounded).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels.ssd_scan.ops import ssd_scan as j_ssd_scan
from repro.models import mamba2 as J

from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda, smem_bytes, SMEM_MAX
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_naive
from repro_torch.models import mamba2 as P

SHAPES = [  # (Bt, L, H, P, N, Q): tests/test_kernels.py
    (2, 64, 4, 8, 16, 16),
    (1, 128, 2, 64, 128, 32),
    (2, 32, 8, 16, 8, 32),
    (1, 64, 1, 128, 64, 64),
]


@pytest.fixture(autouse=True)
def x64_off():
    with jax.enable_x64(False):
        yield


def _inputs(seed, Bt, L, H, Pd, N):
    """test_kernels.py's distributions: x, B, C ~ N(0, 1); log_a = -0.3 |N(0, 1)|;
    dt = softplus(N(0, 1))."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((Bt, L, H, Pd), dtype=f)
    la = (-np.abs(rng.standard_normal((Bt, L, H), dtype=f)) * 0.3).astype(f)
    B = rng.standard_normal((Bt, L, N), dtype=f)
    C = rng.standard_normal((Bt, L, N), dtype=f)
    dt = np.logaddexp(rng.standard_normal((Bt, L, H), dtype=f), f(0)).astype(f)
    return x, la, B, C, dt


def _rel(got, ref):
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9))


@pytest.mark.parametrize("Bt,L,H,Pd,N,Q", SHAPES)
def test_ssd_functions_match_jax_oracle_plain_and_pallas(Bt, L, H, Pd, N, Q):
    arrs = _inputs(L + N, Bt, L, H, Pd, N)
    ja = [jnp.asarray(a) for a in arrs]
    ta = [torch.from_numpy(a) for a in arrs]
    want_naive = np.asarray(J.ssd_naive(*ja))
    want_plain = np.asarray(J.ssd_chunked(*ja, Q))
    want_pallas = np.asarray(j_ssd_scan(*ja, chunk=Q, backend="pallas", interpret=True))
    before = ssd_scan_cuda.launches
    got = {
        "naive": ssd_naive(*ta),
        "chunked": ssd_chunked(*ta, Q),
        "ops": ssd_scan(*ta, Q),
    }
    assert ssd_scan_cuda.launches == before  # CPU tensors never reach the kernel
    for name, g in got.items():
        assert g.shape == (Bt, L, H, Pd) and g.dtype == torch.float32, name
        for ref in (want_naive, want_plain, want_pallas):
            assert _rel(g.numpy(), ref) < 1e-5, name


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.15)])
def test_ssd_scan_dtypes_match_jax(dtype, tol):
    """test_kernels.py::test_ssd_scan_dtypes: all five inputs in ``dtype``."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    arrs = _inputs(7, 1, 64, 2, 16, 8)
    ja = [jnp.asarray(a, dtype=jdt) for a in arrs]
    # the same rounded values on both sides
    ta = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(dtype) for a in ja]
    ref = np.asarray(J.ssd_naive(*ja).astype(jnp.float32))
    want_pallas = np.asarray(j_ssd_scan(*ja, chunk=16, backend="pallas",
                                        interpret=True).astype(jnp.float32))
    assert _rel(want_pallas, ref) < tol
    got = ssd_scan(*ta, 16)
    assert got.dtype == dtype
    assert _rel(got.float().numpy(), ref) < tol
    assert _rel(got.float().numpy(), want_pallas) < tol
    want_plain = np.asarray(J.ssd_chunked(*ja, 16).astype(jnp.float32))
    assert _rel(got.float().numpy(), want_plain) < (1e-5 if dtype == torch.float32 else 2e-2)


def test_segsum_matches_jax():
    la = _inputs(3, 2, 16, 3, 4, 4)[1].transpose(0, 2, 1)  # [..., Q]
    want = np.asarray(J._segsum(jnp.asarray(la)))
    got = P._segsum(torch.from_numpy(la)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-6, rtol=1e-5)


def test_chunked_rejects_a_ragged_length():
    ta = [torch.from_numpy(a) for a in _inputs(1, 1, 24, 2, 8, 8)]
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_chunked(*ta, 16)


def test_kernel_wrapper_never_takes_cpu_tensors():
    ta = [torch.from_numpy(a) for a in _inputs(1, 1, 32, 2, 16, 8)]
    before = ssd_scan_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(*ta, 16)
    assert ssd_scan_cuda.launches == before


def test_kernel_shared_memory_fits_the_main_path():
    """mamba2-1.3b's prefill shapes (P=64, N=128, Q=256) fit one block's
    shared memory in f32 and in bf16 (the C / B tiles are kept in x's
    dtype); the largest test shape too; P=128 with N=128 and Q=256 does not."""
    assert smem_bytes(64, 128, 256, 4) == 217088 <= SMEM_MAX
    assert smem_bytes(64, 128, 256, 2) == 182272 <= SMEM_MAX
    assert smem_bytes(128, 64, 64, 4) <= SMEM_MAX
    assert smem_bytes(128, 128, 256, 2) > SMEM_MAX
