"""The port's analytic roofline against the JAX package's.

``repro_torch.launch.analytics`` and ``launch/roofline.py`` are pinned
copies (``tests/test_torch_copies.py``) whose only departures are the
H100 constants, the docstrings and the dry-run readers.  Here every
counting function equals the reference's exactly for every registry arch
and every shape; ``roofline()``'s time terms equal the reference's scaled
by the ratio of the constants; ``build_table`` equals the reference's row
for row apart from the time columns; and the reference's own roofline
tests run on the port (HBM budget: one H100's 80 GB).
"""

import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.launch.analytics as r_an
import repro.launch.roofline as r_rf
from repro.configs import get_config as r_get_config
from repro.models.model_api import SHAPES as R_SHAPES

import repro_torch.launch.analytics as p_an
import repro_torch.launch.roofline as p_rf
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.registry import all_cells
from repro_torch.launch.analytics import (
    active_params,
    collective_bytes_est,
    hbm_bytes,
    model_flops,
    roofline,
    total_params,
)
from repro_torch.launch.dryrun import collective_bytes
from repro_torch.models.model_api import SHAPES

COUNTS = ["attn_params", "dense_block_params", "moe_block_params", "mamba_block_params",
          "whisper_enc_block_params", "whisper_dec_block_params", "total_params",
          "active_params", "matmul_params", "expert_params", "_n_attn_layers"]
SHAPE_COUNTS = ["model_flops", "cache_bytes", "hbm_bytes", "ssd_flops_fwd"]

#: time term -> the constant that divides it
TERMS = {"compute_s": "PEAK_FLOPS", "memory_s": "HBM_BW", "collective_s": "ICI_BW"}


@pytest.mark.parametrize("arch", ARCHS)
def test_counting_functions_equal_the_reference(arch):
    cfg, rcfg = get_config(arch), r_get_config(arch)
    for name in COUNTS:
        assert getattr(p_an, name)(cfg) == getattr(r_an, name)(rcfg), name
    assert p_an.matmul_params(cfg, False) == r_an.matmul_params(rcfg, False)
    for shape in SHAPES:
        sh, rsh = SHAPES[shape], R_SHAPES[shape]
        for name in SHAPE_COUNTS:
            if name == "ssd_flops_fwd":
                got, want = p_an.ssd_flops_fwd(cfg, 8, 4096), r_an.ssd_flops_fwd(rcfg, 8, 4096)
            else:
                got, want = getattr(p_an, name)(cfg, sh), getattr(r_an, name)(rcfg, rsh)
            assert got == want, (name, shape)
        for n_dev in (256, 512):
            assert p_an.hbm_bytes(cfg, sh, n_dev) == r_an.hbm_bytes(rcfg, rsh, n_dev)
            assert collective_bytes_est(cfg, sh, n_dev) == r_an.collective_bytes_est(
                rcfg, rsh, n_dev), (shape, n_dev)
        assert p_an.attn_flops_fwd(cfg, 8, 4096, 3) == r_an.attn_flops_fwd(rcfg, 8, 4096, 3)


@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_terms_scale_by_the_constants(arch):
    """The same bytes and FLOPs over the H100's rates: each time term is
    the reference's times the ratio of its constant."""
    for shape in SHAPES:
        for n_dev in (1, 8, 256):
            got = roofline(get_config(arch), shape, n_dev=n_dev)
            want = r_an.roofline(r_get_config(arch), shape, n_dev=n_dev)
            for term, const in TERMS.items():
                ratio = getattr(r_an, const) / getattr(p_an, const)
                np.testing.assert_allclose(getattr(got, term), getattr(want, term) * ratio,
                                           rtol=1e-12, atol=0)
            assert (got.useful_flops, got.computed_flops) == (want.useful_flops,
                                                              want.computed_flops)


def test_the_constants_are_the_h100s_and_chip_smokes():
    """The H100 SXM's data-sheet figures, and one set with the rates
    ``chip_smoke.py``'s kernel bounds divide by."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert (p_an.PEAK_FLOPS, p_an.HBM_BW, p_an.ICI_BW) == (989e12, 3.35e12, 25e9)
    assert chip_smoke.HBM_BPS == p_an.HBM_BW
    assert chip_smoke.PEAK["bfloat16"] == p_an.PEAK_FLOPS


def test_build_table_equals_the_reference_but_its_times():
    """Row for row: the arch, the shape, the FLOP counts and their ratio
    are the reference's; the time columns and the roofline fraction are
    the H100's (the bottleneck and hint follow the times)."""
    times = {"bottleneck", "compute_s", "memory_s", "collective_s", "step_s",
             "roofline_fraction", "hint"}
    for optimized in (False, True):
        got = p_rf.build_table(None, optimized=optimized)
        want = r_rf.build_table(None, optimized=optimized)
        assert len(got) == len(want) == len(all_cells())
        for g, w in zip(got, want):
            assert set(g) == set(w)
            assert {k: g[k] for k in g if k not in times} == {
                k: w[k] for k in w if k not in times}
            for term, const in TERMS.items():
                ratio = getattr(r_an, const) / getattr(p_an, const)
                np.testing.assert_allclose(g[term], w[term] * ratio, rtol=1e-12)


def test_load_dryrun_reads_the_ports_reports(tmp_path):
    """``build_table`` reads the port's dry-run JSONL: per-device argument
    bytes on the report's layout and the collective estimate."""
    rec = {"arch": "llama3.2-1b", "shape": "train_4k", "mesh": "16x16", "ok": True,
           "argument_bytes_per_device": {"16x16": 4e9, "pod2x16x16": 2e9},
           "collective_bytes_est": 3e9}
    path = tmp_path / "dry.jsonl"
    path.write_text("\n".join([json.dumps(rec),
                               '{"arch": "x", "shape": "y", "mesh": "16x16", "ok": false}']))
    rows = {(r["arch"], r["shape"]): r for r in p_rf.build_table(str(path))}
    row = rows[("llama3.2-1b", "train_4k")]
    assert row["dryrun_ok"] and row["dryrun_args_gb_per_dev"] == 4.0
    assert row["dryrun_collective_gb_per_dev"] == 3.0
    assert not rows[("llama3.2-1b", "decode_32k")]["dryrun_ok"]
    assert p_rf.load_dryrun(str(tmp_path / "missing.jsonl")) == {}


def test_cost_analysis_dict_reads_the_counter():
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        torch.ones(4, 8) @ torch.ones(8, 2)
    assert p_rf.cost_analysis_dict(fc) == {"flops": 2.0 * 4 * 8 * 2}
    assert p_rf.cost_analysis_dict({"flops": 7, "arch": "x"}) == {"flops": 7.0}


# ----------------------------------------- twins of tests/test_roofline.py ---


def test_param_totals_vs_flops_consistency():
    for arch in ("llama3.2-1b", "gemma-7b", "qwen3-moe-235b-a22b"):
        cfg = get_config(arch)
        fl = model_flops(cfg, SHAPES["train_4k"])
        tokens = 4096 * 256
        assert fl["useful"] == 6.0 * active_params(cfg) * tokens
        assert fl["computed"] > fl["useful"] * 0.5


def test_collective_parser():
    hlo = """
  %x = bf16[1024,512]{1,0} all-gather(bf16[64,512]{1,0} %a), dimensions={0}
  %y = f32[256]{0} all-reduce(f32[256]{0} %b), to_apply=%sum
  %z = bf16[8,8]{1,0} add(bf16[8,8]{1,0} %c, bf16[8,8]{1,0} %d)
"""
    got = collective_bytes(hlo)
    assert got["all-gather"] == 1024 * 512 * 2
    assert got["all-reduce"] == 256 * 4
    assert got["total"] == got["all-gather"] + got["all-reduce"]


def test_roofline_terms_positive_and_bottleneck_sane():
    for arch, shape in [("llama4-maverick-400b-a17b", "train_4k"),
                        ("codeqwen1.5-7b", "decode_32k"),
                        ("mamba2-1.3b", "long_500k")]:
        r = roofline(get_config(arch), shape)
        assert r.compute_s > 0 and r.memory_s > 0 and r.collective_s >= 0
        assert r.bottleneck in ("compute", "memory", "collective")
        assert 0 < r.roofline_fraction <= 1.0


def test_decode_is_memory_bound():
    r = roofline(get_config("codeqwen1.5-7b"), "decode_32k")
    assert r.bottleneck == "memory"


def test_perf_optimizations_improve_modeled_step():
    """Each lever strictly improves its cell, as on the reference's
    constants.  One reading differs: on the H100's, mamba2's ZeRO-1 step
    stays collective-bound (its one gradient all-reduce and parameter
    all-gather at one NVLink link's 25 GB/s take 0.32 s, the compute
    0.048 s at 989 TFLOP/s a card), where the reference's TPU rates make it
    compute-bound."""
    base = roofline(get_config("mamba2-1.3b"), "train_4k")
    opt = roofline(dataclasses.replace(get_config("mamba2-1.3b"), fsdp_all_axes=True), "train_4k")
    assert opt.step_s < 0.5 * base.step_s
    assert opt.bottleneck == "collective" and opt.compute_s < opt.collective_s
    base = roofline(get_config("codeqwen1.5-7b"), "decode_32k")
    opt = roofline(dataclasses.replace(get_config("codeqwen1.5-7b"), kv_cache_quant=True),
                   "decode_32k")
    assert opt.step_s < 0.6 * base.step_s
    base = roofline(get_config("llama4-maverick-400b-a17b"), "train_4k")
    opt = roofline(dataclasses.replace(get_config("llama4-maverick-400b-a17b"),
                                       parallel_block=True), "train_4k")
    assert opt.collective_s < base.collective_s


def test_all_cells_fit_hbm_budget():
    """Weights + optimizer (train) or weights + cache (decode) per device
    stay under one H100's 80 GB on the 256-device layout."""
    HBM = 80e9
    for arch, shape in all_cells():
        cfg = get_config(arch)
        n_dev = 256
        if SHAPES[shape].kind == "train":
            per_dev = total_params(cfg) * (2 + 8) / n_dev  # bf16 + f32 m,v
        else:
            per_dev = (total_params(cfg) * 2 + p_an.cache_bytes(cfg, SHAPES[shape])) / n_dev
        assert per_dev < HBM, (arch, shape, per_dev / 1e9)


def test_hbm_bytes_is_the_reference_formula():
    cfg = get_config("llama3.2-1b")
    assert hbm_bytes(cfg, SHAPES["decode_32k"]) == (
        active_params(cfg) * 2 + p_an.cache_bytes(cfg, SHAPES["decode_32k"]))
