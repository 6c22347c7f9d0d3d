"""The launch planners of the port's s2d-conv and decode-attention kernels, on the CPU.

Both grids are sized on the host in plain Python
(``kernels/s2d_conv/kernel.py::plan_s2d``,
``kernels/decode_attn/kernel.py::plan_splits``), so they are tested here
with the H100's 132 SMs: each planner takes the cheapest grid under its
cost model, the work the blocks share out covers each element exactly
once, and the main path's shapes get the grids the card ran fastest in
``chip_smoke.py``'s sweeps.  The kernels themselves run only on the card
(``test_torch_cuda.py``).

Also here: why the s2d-conv kernel's f32 path takes three TF32 products.
TF32 keeps 10 of f32's 23 mantissa bits (``cvt.rna.tf32.f32``: round to
nearest, ties away from zero, emulated below on the bit patterns).  One
TF32 product misses the f32 tolerance of ``1e-4 * max|ref|`` at every
main-path shape; split TF32 (``lo*hi + hi*lo + hi*hi``) stays within
``1e-5``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attn.kernel import (
    MAX_SPLIT as DEC_MAX_SPLIT,
    plan_splits,
    split_cost,
    split_rows,
)
from repro_torch.kernels.s2d_conv.kernel import (
    SPLITS,
    TILE_K,
    TILE_M,
    TILE_N,
    S2dPlan,
    plan_cost,
    plan_s2d,
)

N_SM = 132  # H100 SXM
DTYPES = [torch.float32, torch.bfloat16]
# (M, Cv, Kv) of the 20 pointwise variant layers of the multicam_heavy @
# 6k_1ws2os plans at B=1 (core/variant_exec.pointwise_variants)
MAIN_GEMMS = [
    (3136, 64, 256), (3136, 128, 256), (3136, 256, 64), (3136, 256, 128),
    (784, 128, 512), (784, 256, 512), (784, 512, 128), (784, 96, 384), (784, 384, 96),
]
# tests/test_kernels.py's (B, H, W, C, K, g) as GEMMs, then ragged ones
OTHER_GEMMS = [
    (2 * 8 * 8 * 4, 4, 8), (16 * 16 * 4, 16, 16), (2 * 12 * 12 * 9, 4, 8),
    (8 * 8 * 4, 64, 32), (4 * 4 * 4, 128, 128),
    (3 * 5 * 7 * 4, 5, 3), (2 * 5 * 7, 4, 3), (9 * 11, 40, 24), (8 * 3136, 64, 256),
]


def _covered_once(intervals, n):
    count = np.zeros(n, dtype=np.int64)
    for lo, hi in intervals:
        count[lo:hi] += 1
    return bool((count == 1).all())


def test_main_path_gemms_are_the_variant_layers():
    from repro_torch.core import SCENARIOS
    from repro_torch.core.variant_exec import pointwise_variants
    from repro_torch.costmodel.maestro import PLATFORMS

    plans, _ = SCENARIOS["multicam_heavy"].plans(PLATFORMS["6k_1ws2os"])
    layers = [v for p in plans for v in pointwise_variants(p)]
    assert len(layers) == 20
    gemms = {(v.H * v.W * v.gamma**2, v.C // v.gamma**2, v.K // v.gamma**2) for v in layers}
    assert gemms == set(MAIN_GEMMS)


@pytest.mark.parametrize("M,Cv,Kv", MAIN_GEMMS + OTHER_GEMMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_s2d_plan_is_the_cheapest_and_covers_each_element_once(M, Cv, Kv, dtype):
    plan = plan_s2d(M, Cv, Kv, dtype, N_SM)
    tiles = plan.m_tiles * plan.n_tiles
    assert plan.tile_k == TILE_K[dtype] and plan.split in SPLITS
    assert plan.blocks == tiles * plan.split
    assert plan.split == 1 or plan.split <= plan.slabs  # no block without a slab
    for s in SPLITS:  # no split the planner may take is cheaper
        if s == 1 or s <= plan.slabs:
            other = S2dPlan(M, Cv, Kv, TILE_K[dtype], s)
            assert plan_cost(plan, N_SM, dtype) <= plan_cost(other, N_SM, dtype)
    # rows, columns and the contraction each dealt out exactly once, so every
    # (row, column, contraction) element of the product lands in one block
    assert _covered_once([(t * TILE_M, min(t * TILE_M + TILE_M, M))
                          for t in range(plan.m_tiles)], M)
    assert _covered_once([(t * TILE_N, min(t * TILE_N + TILE_N, Kv))
                          for t in range(plan.n_tiles)], Kv)
    ranges = [plan.k_range(r) for r in range(plan.split)]
    assert _covered_once(ranges, Cv)
    assert all(k0 % plan.tile_k == 0 for k0, _ in ranges)  # runs of whole slabs


@pytest.mark.parametrize("M,Cv,Kv", [(2 * 5 * 7, 4, 3), (105 * 4, 5, 3), (99, 40, 24)])
@pytest.mark.parametrize("split", [1, 2, 3, 8])
def test_s2d_plan_covers_a_ragged_product_element_by_element(M, Cv, Kv, split):
    """The blocks' (row, column, contraction) boxes, counted element by
    element, for ragged shapes and every kind of split (some runs empty)."""
    plan = S2dPlan(M, Cv, Kv, TILE_K[torch.float32], split)
    count = np.zeros((M, Kv, Cv), dtype=np.int64)
    for mt in range(plan.m_tiles):
        for nt in range(plan.n_tiles):
            for rank in range(split):
                k0, k1 = plan.k_range(rank)
                count[mt * TILE_M:(mt + 1) * TILE_M, nt * TILE_N:(nt + 1) * TILE_N, k0:k1] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_s2d_plan_splits_only_the_long_contractions_of_few_tiles(dtype):
    """784 x 512 x 128 and 784 x 384 x 96 have 26 tiles and 8-16 slabs: a
    cluster of 4 blocks per tile (104 blocks, a quarter of the chain each),
    the split the card ran fastest.  Where the tiles already cover the card,
    or the contraction is short, each block walks the whole of it: a
    cluster merge costs about as much as a slab or two (chip_smoke.py's
    sweep of splits)."""
    for M, Cv, Kv in MAIN_GEMMS:
        plan = plan_s2d(M, Cv, Kv, dtype, N_SM)
        if (M, Cv, Kv) in ((784, 512, 128), (784, 384, 96)):
            assert (plan.m_tiles * plan.n_tiles, plan.split, plan.blocks) == (26, 4, 104)
        elif Cv <= 128 or plan.m_tiles * plan.n_tiles >= 98:
            assert plan.split == 1, (M, Cv, Kv)
    plan = plan_s2d(784, 512, 128, torch.float32, N_SM)
    assert [plan.k_range(r) for r in range(4)] == [(0, 128), (128, 256), (256, 384), (384, 512)]


SERVING = (8, 8, 2 * 64 * 2)  # llama3.2-1b decode: batch 8, 8 KV heads, a bf16 K+V row


@pytest.mark.parametrize("B,Hkv,row_bytes", [SERVING, (8, 16, 2 * 256 * 2), (8, 8, 2 * 64 * 4),
                                             (1, 1, 2 * 128 * 2), (33, 8, 2 * 32 * 2)])
@pytest.mark.parametrize("bound", [0, 1, 17, 32, 256, 2048])
def test_decode_grid_is_balanced_and_takes_the_cheapest_split(B, Hkv, row_bytes, bound):
    S = plan_splits(B, Hkv, bound, row_bytes, N_SM)
    assert 1 <= S <= DEC_MAX_SPLIT
    blocks = B * Hkv * S
    per_sm = [blocks // N_SM + (i < blocks % N_SM) for i in range(N_SM)]
    assert sum(per_sm) == blocks and max(per_sm) - min(per_sm) <= 1
    cost = split_cost(S, B, Hkv, bound, row_bytes, N_SM)
    assert all(cost <= split_cost(s, B, Hkv, bound, row_bytes, N_SM)
               for s in range(1, DEC_MAX_SPLIT + 1))
    if bound <= 32:  # a few rows: one block each, no cluster to merge
        assert S == 1


@pytest.mark.parametrize("bound,want", [(64, 1), (256, 1), (2048, 2)])
def test_decode_grid_at_the_serving_shape(bound, want):
    """The serving loop's first 256 positions: one block per (b, kv head),
    no cluster, the fastest in chip_smoke.py's sweep; the whole cache: two
    blocks each, 128 blocks on 132 SMs."""
    S = plan_splits(*SERVING[:2], bound, SERVING[2], N_SM)
    assert S == want
    blocks = SERVING[0] * SERVING[1] * S
    assert S == 1 or blocks / (-(-blocks // N_SM) * N_SM) >= 0.9


@pytest.mark.parametrize("valid", [0, 1, 17, 256, 2048])
def test_decode_splits_read_each_valid_position_once(valid):
    L = 2048
    for S in range(1, DEC_MAX_SPLIT + 1):
        pieces = [split_rows(valid, L, S, r) for r in range(S)]
        assert all(0 <= a <= b <= valid for a, b in pieces)
        count = np.zeros(L, dtype=np.int64)
        for a, b in pieces:
            count[a:b] += 1
        assert (count[:valid] == 1).all() and not count[valid:].any()


def _tf32(t):
    """cvt.rna.tf32.f32 on the bit patterns: keep 10 mantissa bits, round to
    nearest with ties away from zero (adding half of the dropped range to
    the magnitude, then truncating)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 2.0**-12, -(1.0 + 2.0**-11),
                      3.0e-3, -7.5e5], dtype=torch.float32)
    got = _tf32(x)
    assert got[:3].tolist() == [1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-10]  # a tie goes away from 0
    assert got[3].item() == 1.0 and got[4].item() == -(1.0 + 2.0**-10)
    rel = ((got - x).abs() / x.abs())[5:]
    assert (rel <= 2.0**-11).all() and not torch.equal(got[5:], x[5:])


@pytest.mark.parametrize("M,Cv,Kv", MAIN_GEMMS)
def test_split_tf32_is_within_the_f32_tolerance_and_one_product_is_not(M, Cv, Kv):
    """The kernel's f32 arithmetic, emulated: TF32 operands, products exact
    in f32, f32 sums.  The inputs are drawn as ``variant_inputs`` draws
    them (x normal, w normal / sqrt(Cv))."""
    rng = np.random.default_rng(M + Cv + Kv)
    x = torch.from_numpy(rng.standard_normal((M, Cv), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((Cv, Kv), dtype=np.float32)
                         / np.sqrt(Cv, dtype=np.float32))
    ref = x.double() @ w.double()
    scale = ref.abs().max().item()
    xh, wh = _tf32(x), _tf32(w)
    xl, wl = _tf32(x - xh), _tf32(w - wh)
    split = (xl @ wh + xh @ wl) + xh @ wh
    single = xh @ wh
    assert (split.double() - ref).abs().max().item() <= 1e-5 * scale
    assert (single.double() - ref).abs().max().item() > 1e-4 * scale
