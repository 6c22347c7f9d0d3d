"""The SSD-scan kernel's arithmetic and layout, on the CPU (no JAX needed).

``csrc/ssd_scan.cu`` runs only on a card, so its numerics are emulated
here in torch, step for step: C Bᵀ once per (batch row, chunk) into G;
per chunk, row tiles of 64 positions that take exp(cum_i) (C S) and then,
for each 64-wide tile of j <= i, the scores G o exp(cum_i - cum_j) times
xdt (below the diagonal tile the decay is exp(cum_i - cum_i0) times
exp(cum_i0 - cum_j), i0 the row tile's first position; on it, selected to
0 where j > i); then the state update
exp(total) S + (B o w)ᵀ xdt, one 64-row tile of B at a time.  Every
product goes through TF32 operands as the kernel's ``mma.sync`` sees
them, on the bit patterns: hi = the operand rounded to TF32 (to nearest,
ties away from zero, as ``cvt.rna`` gives it), lo = the rest truncated to
TF32 (the tensor cores ignore an operand's low 13 bits); products exact
in f32, sums in f32.

* Split TF32 (``lo*hi + hi*lo + hi*hi``) comes within
  ``tests/test_kernels.py``'s 1e-5 * max|ref| of the oracle ``ssd_naive``
  at its four SSD shapes, and within chip_smoke.py's 1e-4 at a chunk of the
  prefill's widths (Q=256, N=128, P=64).  One TF32 product (``hi*hi``)
  misses 1e-4 at the same shapes: why the kernel takes three.
* ``smem_bytes`` at every ``chip_smoke.SSD_SHAPES`` and
  ``SSD_GROUPED_SHAPES`` entry, within the
  227 KB a block may use with two buffers a copy ring; and every shape the
  CUDA-core kernel before it took, with one buffer a ring where two do not
  fit (all but some P = 128 shapes with padded rows).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd_scan.kernel import HEAD_DIMS, SMEM_MAX, ring_stages, smem_bytes
from repro_torch.kernels.ssd_scan.ref import ssd_naive

ROOT = Path(__file__).resolve().parents[1]
TILE = 64
SHAPES = [  # (Bt, L, H, P, N, Q): tests/test_kernels.py
    (2, 64, 4, 8, 16, 16),
    (1, 128, 2, 64, 128, 32),
    (2, 32, 8, 16, 8, 32),
    (1, 64, 1, 128, 64, 64),
]
PREFILL_CHUNK = (1, 512, 2, 64, 128, 256)  # mamba2-1.3b's P, N and Q; two chunks


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed, Bt, L, H, Pd, N):
    """tests/test_kernels.py's distributions: x, B, C ~ N(0, 1); log_a = -0.3 |N(0, 1)|;
    dt = softplus(N(0, 1))."""
    rng = np.random.default_rng(seed)
    f = np.float32
    draw = [rng.standard_normal((Bt, L, H, Pd), dtype=f),
            -np.abs(rng.standard_normal((Bt, L, H), dtype=f)) * 0.3,
            rng.standard_normal((Bt, L, N), dtype=f), rng.standard_normal((Bt, L, N), dtype=f),
            np.logaddexp(rng.standard_normal((Bt, L, H), dtype=f), f(0))]
    return [torch.from_numpy(np.asarray(a, dtype=f)) for a in draw]


def _rna(t):
    """To TF32, to nearest with ties away from zero (cvt.rna.tf32.f32)."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _trunc(t):
    """To TF32 by dropping the low 13 bits, as the tensor cores read an operand."""
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_tf32(a, b):
    """a @ b as the kernel's split-TF32 mma.sync computes it."""
    ah, bh = _rna(a), _rna(b)
    al, bl = _trunc(a - ah), _trunc(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def one_tf32(a, b):
    """a @ b from a single TF32 product."""
    return _rna(a) @ _rna(b)


def emulate(x, log_a, B, C, dt, Q, mm):
    """The two launches' arithmetic, with every product taken by ``mm``."""
    Bt, L, H, Pd = x.shape
    nc = L // Q
    xc = x.reshape(Bt, nc, Q, H, Pd).permute(0, 3, 1, 2, 4)  # [Bt, H, nc, Q, P]
    lac = log_a.reshape(Bt, nc, Q, H).permute(0, 3, 1, 2)  # [Bt, H, nc, Q]
    dtc = dt.reshape(Bt, nc, Q, H).permute(0, 3, 1, 2)
    Bc = B.reshape(Bt, nc, Q, -1)
    Cc = C.reshape(Bt, nc, Q, -1)
    G = mm(Cc, Bc.transpose(-1, -2))  # launch 1: [Bt, nc, Q, Q], once per (b, chunk)
    S = torch.zeros((Bt, H, B.shape[-1], Pd))
    y = torch.empty((Bt, H, nc, Q, Pd))
    pos = torch.arange(Q)
    for c in range(nc):
        xdt = xc[:, :, c] * dtc[:, :, c, :, None]  # [Bt, H, Q, P]
        cum = torch.cumsum(lac[:, :, c], dim=-1)  # [Bt, H, Q]
        total = cum[..., -1]
        for i0 in range(0, Q, TILE):
            i1 = min(i0 + TILE, Q)
            acc = mm(Cc[:, None, c, i0:i1], S) * torch.exp(cum[..., i0:i1, None])
            for j0 in range(0, i1, TILE):
                j1 = min(j0 + TILE, Q)
                g = G[:, None, c, i0:i1, j0:j1]
                if j0 < i0:  # below the diagonal: two factors, each at most 1
                    row = torch.exp(cum[..., i0:i1] - cum[..., i0, None])
                    col = torch.exp(cum[..., i0, None] - cum[..., j0:j1])
                    scores = g * row[..., :, None] * col[..., None, :]
                else:
                    causal = pos[j0:j1][None, :] <= pos[i0:i1][:, None]
                    seg = torch.where(causal, cum[..., i0:i1, None] - cum[..., None, j0:j1], 0.0)
                    scores = torch.where(causal, g * torch.exp(seg), 0.0)
                acc = acc + mm(scores, xdt[..., j0:j1, :])
            y[:, :, c, i0:i1] = acc
        w = torch.exp(total[..., None] - cum)  # [Bt, H, Q]
        S = torch.exp(total)[..., None, None] * S
        for j0 in range(0, Q, TILE):
            j1 = min(j0 + TILE, Q)
            bw = (Bc[:, None, c, j0:j1, :] * w[..., j0:j1, None]).transpose(-1, -2)
            S = S + mm(bw, xdt[..., j0:j1, :])
    return y.permute(0, 2, 3, 1, 4).reshape(Bt, L, H, Pd)


def _rel(got, ref):
    return ((got - ref).abs().max() / ref.abs().max()).item()


def test_tf32_roundings_on_the_bit_patterns():
    one = 1.0 + 2.0**-11  # halfway between two TF32 values
    x = torch.tensor([one, -one, 1.0 + 2.0**-12, 1.0 + 3 * 2.0**-12], dtype=torch.float32)
    assert _rna(x).tolist() == [1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0, 1.0 + 2.0**-10]
    assert _trunc(x).tolist() == [1.0, -1.0, 1.0, 1.0]
    # hi + lo keeps about 21 bits: one part in 2^21 of the value at most
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(4096, dtype=np.float32))
    hi = _rna(v)
    assert ((hi + _trunc(v - hi) - v).abs() <= v.abs() * 2.0**-21).all()


@pytest.mark.parametrize("Bt,L,H,Pd,N,Q,tol", [s + (1e-5,) for s in SHAPES]
                         + [PREFILL_CHUNK + (1e-4,)])
def test_split_tf32_scan_is_within_tolerance_and_one_product_is_not(Bt, L, H, Pd, N, Q, tol):
    ins = _inputs(L + N, Bt, L, H, Pd, N)
    ref = ssd_naive(*ins)
    assert _rel(emulate(*ins, Q, split_tf32), ref) < tol
    assert _rel(emulate(*ins, Q, one_tf32), ref) > 1e-4


def test_emulation_in_f32_products_is_the_blocked_algorithm():
    """With exact f32 products the emulation is the plain blocked scan (so
    the two tests above measure the operands' rounding, nothing else)."""
    ins = _inputs(3, 1, 128, 2, 64, 128)
    assert _rel(emulate(*ins, 32, torch.matmul), ssd_naive(*ins)) < 2e-6


@pytest.mark.parametrize("shape", _chip_smoke().SSD_SHAPES
                         + [s[:6] for s in _chip_smoke().SSD_GROUPED_SHAPES])
def test_shared_memory_at_every_smoke_shape(shape):
    """Every shape the smoke run checks fits one block in f32 and in bf16
    with two buffers a copy ring, so its copies overlap the products (a
    block reads one group's B and C, so the groups do not enter)."""
    Bt, L, H, Pd, N, Q = shape
    Q = min(Q, L)
    for itemsize in (4, 2):
        assert ring_stages(Pd, N, Q, itemsize) == 2
        assert smem_bytes(Pd, N, Q, itemsize) <= SMEM_MAX
    assert smem_bytes(Pd, N, Q, 2) < smem_bytes(Pd, N, Q, 4)


def _cuda_core_layout_bytes(P, N, Q):
    """Shared memory of the CUDA-core kernel that the tensor-core one
    replaced: S [N, P], xdt [Q, P], cum and w [Q], a C and a B tile
    [64, N + 1] and the score tile [64, 65], all f32, none padded."""
    return 4 * (N * P + Q * P + 2 * TILE * (N + 1) + TILE * (TILE + 1) + 2 * Q)


def test_every_shape_the_cuda_core_kernel_took_still_fits():
    """Where two buffers a ring do not fit, one does: every (P, N, Q) with
    N <= 512, Q <= 256 that the CUDA-core kernel took fits in f32 and bf16,
    except at P = 128 where the zero pads (Q to a multiple of 64, N of 16)
    push the padded rows past the limit."""
    took = [(P, N, Q) for P in HEAD_DIMS for N in range(1, 513) for Q in range(1, 257)
            if _cuda_core_layout_bytes(P, N, Q) <= SMEM_MAX]
    lost = [(P, N, Q, itemsize) for P, N, Q in took for itemsize in (4, 2)
            if smem_bytes(P, N, Q, itemsize) > SMEM_MAX]
    assert lost and all(P == 128 and (Q % TILE or N % 16) for P, N, Q, _ in lost)
    one_buffer = [(P, N, Q) for P, N, Q in took if ring_stages(P, N, Q, 4) == 1]
    assert (64, 192, 256) in one_buffer and (128, 128, 128) in one_buffer


def test_variant_timer_needs_a_card(monkeypatch):
    """``compare.py`` times kernel sources on the card only: without one it
    exits before building anything."""
    from repro_torch.kernels.ssd_scan import compare

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        compare.main(["a.cu", "b.cu"])
