"""The benchmark's FLOP and byte formulas against counts made by hand on a
tiny configuration."""

from __future__ import annotations

import pytest

from h100bench.work import model_flops as mf  # noqa: E402
from h100bench.work import roofline as rl  # noqa: E402

# d_model 4, expand 2 (d_inner 8), head dim 4 (2 heads), state 2, conv 3,
# chunk 4; two layers, vocabulary 10
W = dict(family="ssm", n_layers=2, d_model=4, ssm_expand=2, ssm_headdim=4, ssm_state=2,
         ssm_conv_width=3, ssm_chunk=4, vocab_size=10, dtype="bfloat16")


def test_mamba_projections():
    # in_proj 4 x (2*8 + 2*2 + 2) = 4 x 22; conv 3 taps x (8 + 4) channels; out_proj 8 x 4
    assert mf.mamba_proj_flops(W) == 2 * 4 * 22 + 2 * 3 * 12 + 2 * 8 * 4


def test_ssd_products():
    # one row of 8 tokens: 2 chunks of Q=4; C B^T: 4*5/2 pairs x N=2, x2 -> 40 a chunk;
    # a head a chunk: scores x xdt 10 pairs x P=4 x2 = 80, state 2*4*2*4 = 64, C S 64
    assert mf.ssd_flops(W, 1, 8) == 2 * (40 + 2 * (80 + 64 + 64))


def test_prefill_and_train():
    B, L = 2, 8
    mamba = 2 * (B * L * mf.mamba_proj_flops(W) + mf.ssd_flops(W, B, L))
    head = 2 * 4 * 10
    assert mf.prefill_flops(W, B, L) == mamba + B * head
    assert mf.train_flops(W, B, L) == 3 * (mamba + B * L * head)


def test_ssd_floor():
    f = rl.ssd_floor(1, 8, 2, 4, 2, 4, "bfloat16")
    # x read, y written (2 x 64 bf16), B and C (2 x 16 bf16), log_a and dt (2 x 16 f32)
    assert f["t_bytes_s"] == pytest.approx((2 * 64 * 2 + 2 * 16 * 2 + 2 * 16 * 4) / rl.HBM_BPS)
    f32_s = min(1 / rl.PEAK["float32"], 3 / rl.PEAK["tf32"])
    cs_s = min(1 / rl.PEAK["float32"], 2 / rl.PEAK["tf32"])
    cb, cs = 2 * 4 * 5 * 2, 2 * 2 * 2 * 4 * 2 * 4
    other = 2 * 2 * (4 * 5 * 4 + 2 * 4 * 2 * 4)
    assert f["t_ops_s"] == pytest.approx(cb / rl.PEAK["bfloat16"] + other * f32_s + cs * cs_s)
    assert rl.ssd_bound_s(1, 8, 2, 4, 2, 4, "bfloat16") == max(f["t_bytes_s"], f["t_ops_s"])
