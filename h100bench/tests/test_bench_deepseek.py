"""The deepseek_v3 cell's benchmark files on the CPU at small sizes: the
DeepSeek-V3 prefill driver run whole, with the weights, reference, faults and
formulas made for it, added as files beside the benchmark's own (none edited).

* a tiny deepseek_v3 cell on a share of its experts (8 of 32 held) runs and
  is correct (its three numbers); the prefill faults, deepseek_v3's own
  (``h100bench/deepseek_faults.py``, removed when their context closes) and
  the float8 control are not; the flash kernel's fault, planted in its
  build, is not built here (no nvcc) and is held on the card;
* ``work`` counts the window's MLA blocks, flash launches (none on the CPU),
  MoE calls and routes to held experts from the port's counters;
* the configuration file: the catalog's config.json with its two cuts, the
  deployment and the assumptions; the weights have the port's keys, shapes
  and dtypes at the published widths (on ``meta``): 19.99 B parameters,
  40.09 GB (bf16, the routers and norms in float32);
* ``deepseek_flops`` against counts made by hand, and some 1,245 TFLOP an
  item at the cell's shape;
* the readers on synthetic spans, and left out where the port's counters
  and the window's spans or launches disagree.
"""

from __future__ import annotations

import json
import types

import pytest
import torch

from h100bench.tests.bench_root import REPO, make_root
from h100bench.tests.test_bench_spans import kernel, launch, span  # noqa: F401

from h100bench import deepseek_faults, faults, harness  # noqa: E402
from h100bench import deepseek_inputs as din  # noqa: E402
from h100bench.reference.model import named_leaves  # noqa: E402
from h100bench.trace import Profiler  # noqa: E402
from h100bench.work import deepseek_flops, roofline  # noqa: E402

SEED = 2**33 + 33
#: a tiny deepseek_v3 on a share of its experts: every width that differs from
#: the port-only arch is cut in the file's ``reduced`` (here by the port's names)
TINY = dict(n_layers=3, first_k_dense=1, d_model=64, vocab_size=96, n_heads=4, n_kv_heads=4,
            head_dim=24, q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
            v_head_dim=16, d_ff=96, n_experts=32, n_experts_held=8, expert_offset=8,
            experts_per_token=4, moe_d_ff=32, moe_shared_d_ff=48, n_group=4, topk_group=2,
            routed_scaling_factor=2.5, norm_eps=1e-6, rope_theta=10000.0, rope_factor=40.0,
            rope_original_max=64, rope_beta_fast=32.0, rope_beta_slow=1.0, rope_mscale=1.0,
            rope_mscale_all_dim=1.0, tie_embeddings=False)
MIX = dict(kind="deepseek_prefill", batch=2, seq_len=32, pool=2, check_rows=1, f32_positions=24)
CELL = "tiny-deepseek.tiny-mla-moe"
#: from CPU readings of bf16 runs on six seeds (1-5 and SEED: 0.0036-0.0058),
#: well above them; the float8 control reads 0.032-0.050 on the same seeds
LIMIT = 0.02
#: the program's layers in float32 read 3.1e-7-6.1e-7 on the same six seeds;
#: the faults 3.9e-3 (bias in the weights) and up on SEED, the float8 control
#: 0.066-0.099
LIMIT_F32 = 1e-5
#: the window's bf16 layers against the reference's float32 ones: 0.017-0.033 on
#: the same six seeds (at d_model 64 the residual stream's bf16 rounding sets the
#: number), the float8 control 0.062-0.116
LIMIT_BF16 = 0.045


def tiny_spec(dtype="bfloat16"):
    keep = {"routed_scaling_factor", "norm_eps", "rope_theta", "rope_factor", "rope_beta_fast",
            "rope_beta_slow", "rope_mscale", "rope_mscale_all_dim", "tie_embeddings"}
    return dict(name="tiny-deepseek", arch="deepseek-v3", family="deepseek_v3", dtype=dtype,
                source="a test", widths=dict(TINY), reduced=[k for k in TINY if k not in keep],
                assumed={}, departures=[])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_deepseek_root(tmp_path_factory.mktemp("bench"))


def make_deepseek_root(tmp):
    """``bench_root.make_root`` with the tiny deepseek_v3 cell added as files and entries."""
    root = make_root(tmp)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    spec = tiny_spec()
    (root / "h100bench" / "configs" / "tiny-deepseek.json").write_text(json.dumps(spec))
    bench["configs"].append({"name": "tiny-deepseek", "source": "a test",
                             "file": "h100bench/configs/tiny-deepseek.json",
                             "reduced": spec["reduced"], "why": "a test"})
    (root / "h100bench" / "traffic" / "tiny-mla-moe.json").write_text(json.dumps(MIX))
    bench["workloads"].append({"name": CELL, "config": "tiny-deepseek",
                               "traffic": "tiny-mla-moe", "chips": 1, "why": "a test"})
    (root / "h100bench" / "limits" / f"{CELL}.json").write_text(
        json.dumps({"logits_err": {"limit": LIMIT}, "layer_err_bf16": {"limit": LIMIT_BF16},
                    "layer_err_f32": {"limit": LIMIT_F32}}))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "deepseek-v3.prefill-16k" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(root, seed=SEED, seconds=0.3):
    return harness.run_cell(root, CELL, seed, seconds, False, device="cpu", log=lambda s: None)


def reading(root, seed=SEED):
    """The sound numbers of one checked item and the float8 control's."""
    ctx = harness.context(root, CELL, seed, "cpu", False, log=lambda s: None)
    drv = harness.driver(ctx)
    st = drv.setup(ctx)
    for i in range(drv.check_items(ctx)):
        drv.item(ctx, st, i)
    return drv.check(ctx, st), drv.control(ctx, st)


def test_tiny_cell_runs_and_is_correct(root):
    out = run(root)
    assert out["correct"] is True and out["attempted"] >= 1, out["checks"]
    assert set(out["metrics"]) == {"prefill_tok_per_s", "setup_s"}
    assert set(out["checks"]) == {"logits_err", "layer_err_bf16", "layer_err_f32"}


@pytest.mark.parametrize("fault", faults.KINDS["prefill"])
def test_planted_fault_is_not_correct(root, fault):
    with faults.planted(fault):
        out = run(root)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault", deepseek_faults.EVERY_ROUTE)
def test_planted_deepseek_fault_is_not_correct_and_is_removed(root, fault):
    """Each of deepseek_v3's faults fails the tiny cell by its float32 number
    (the teacher-forced logits follow the faulted routes, so a router fault
    need not show there), and its context leaves the port as it found it."""
    from repro_torch.models import deepseek_v3, moe_dropless

    where = [(moe_dropless, "route"), (moe_dropless, "swiglu"), (moe_dropless, "moe_apply"),
             (deepseek_v3, "softmax_scale"), (deepseek_v3, "rope_interleaved"),
             (deepseek_v3, "kv_proj")]
    before = [getattr(mod, attr) for mod, attr in where]
    with deepseek_faults.planted(fault):
        out = run(root)
    assert [getattr(mod, attr) for mod, attr in where] == before
    assert out["checks"]["layer_err_f32"]["value"] > LIMIT_F32, out["checks"]
    assert out["correct"] is False


def test_the_flash_fault_is_planted_in_the_kernels_source():
    """The flash kernel's V map, which ``flash_v_stride`` changes, is in the
    source once (the build and its reading are the card's)."""
    from repro_torch.kernels.nvcc import CSRC

    sound, fault = deepseek_faults.FLASH_V_MAP
    src = (CSRC / "flash_attn.cu").read_text()
    assert src.count(sound) == 1 and fault not in src


def test_grouped_route_is_taken_on_the_cpu_and_correct(root, monkeypatch):
    """With the grouped route taken on the CPU (``torch._grouped_mm`` has a
    CPU version), the tiny cell's held share is correct."""
    from repro_torch.models import moe_dropless

    monkeypatch.setattr(moe_dropless, "PLAIN_DEVICES", ("meta",))
    grouped, real = [], moe_dropless.experts_grouped
    monkeypatch.setattr(moe_dropless, "experts_grouped", lambda *a: grouped.append(1) or real(*a))
    out = run(root)
    assert out["correct"] is True and grouped, out["checks"]


def test_float8_control_is_not_correct(root):
    sound, low = reading(root)
    assert sound["logits_err"] <= LIMIT < low["logits_err"], (sound, low)
    assert sound["layer_err_f32"] <= LIMIT_F32 < low["layer_err_f32"], (sound, low)
    assert sound["layer_err_bf16"] <= LIMIT_BF16 < low["layer_err_bf16"], (sound, low)


def test_work_counts_the_window(root):
    """``work`` after a window: the MLA blocks and MoE calls of its items,
    the routes to held experts the port counted on the device in it (not
    the warm-up's), the model FLOPs over those routes; no flash launch on
    the CPU, so no attention bound."""
    from repro_torch.models import moe_dropless

    ctx = harness.context(root, CELL, SEED, "cpu", False, log=lambda s: None)
    drv = harness.driver(ctx)
    st = drv.setup(ctx)
    held0 = moe_dropless.held_count("cpu")
    items = [harness.Item(0.0, 1.0, drv.item(ctx, st, i)) for i in range(2)]
    held = moe_dropless.held_count("cpu") - held0
    w = drv.work(ctx, st, items)
    n_moe = TINY["n_layers"] - TINY["first_k_dense"]
    assert (w["mla_calls"], w["moe_calls"], w["flash_calls"]) == (2 * TINY["n_layers"],
                                                                  2 * n_moe, 0)
    assert w["moe_held_rows"] == held and 0 < held < 2 * n_moe * 2 * 32 * 4
    assert w["model_flops"] == pytest.approx(
        2 * deepseek_flops.prefill_flops(ctx.widths, 2, 32, 0)
        + held * deepseek_flops.routed_row_flops(ctx.widths), rel=1e-12)
    assert w["flash_bound_s"] == 0


class MetaGenerator(torch.Generator):
    @property
    def device(self):
        return torch.device("meta")


def _spec():
    return harness.read_json(REPO / "h100bench" / "configs" / "deepseek-v3.json")


def test_input_tree_has_the_ports_layout(root, monkeypatch):
    """At the published widths, on the cut (on ``meta``, nothing allocated)."""
    monkeypatch.setattr(din, "generator", lambda seed, stream, device: MetaGenerator())
    spec = _spec()
    ctx = harness.context(root, CELL, SEED, "cpu", False, log=lambda s: None)
    from repro_torch.models.model_api import build_model

    cfg = harness.driver(ctx).model_config(spec)
    ours = din.weights(harness.widths(spec), 0, "meta")
    theirs = build_model(cfg, "meta").init(MetaGenerator())
    shape = lambda tree: {n: (tuple(t.shape), t.dtype) for n, t in named_leaves(tree)}  # noqa: E731
    assert shape(ours) == shape(theirs)
    n = sum(t.numel() for _, t in named_leaves(ours))
    assert n == pytest.approx(3 * 583.5e6 + 28 * 585.3e6 + 1853e6, rel=1e-3)
    assert n == pytest.approx(19.99e9, rel=1e-3)
    # bf16 but the float32 routers, their biases and the norm scales (0.1 GB)
    assert sum(t.numel() * t.element_size() for _, t in named_leaves(ours)) == \
        pytest.approx(40.09e9, rel=1e-3)


def test_configuration_file_holds_the_catalog_config_and_the_cut():
    spec = _spec()
    w = spec["widths"]
    assert spec["source"] == "https://huggingface.co/deepseek-ai/DeepSeek-V3/blob/main/config.json"
    assert (spec["hidden_size"], spec["num_attention_heads"], spec["q_lora_rank"],
            spec["kv_lora_rank"], spec["qk_nope_head_dim"], spec["qk_rope_head_dim"],
            spec["v_head_dim"]) == (w["d_model"], w["n_heads"], w["q_lora_rank"],
                                    w["kv_lora_rank"], w["qk_nope_dim"], w["qk_rope_dim"],
                                    w["v_head_dim"])
    assert (spec["num_experts_per_tok"], spec["moe_intermediate_size"], spec["intermediate_size"],
            spec["n_group"], spec["topk_group"], spec["routed_scaling_factor"],
            spec["first_k_dense_replace"], spec["rms_norm_eps"]) == (
        w["experts_per_token"], w["moe_d_ff"], w["d_ff"], w["n_group"], w["topk_group"],
        w["routed_scaling_factor"], w["first_k_dense"], w["norm_eps"])
    rs = spec["rope_scaling"]
    assert (rs["factor"], rs["original_max_position_embeddings"], rs["beta_fast"],
            rs["beta_slow"], rs["mscale"], rs["mscale_all_dim"], spec["rope_theta"]) == (
        w["rope_factor"], w["rope_original_max"], w["rope_beta_fast"], w["rope_beta_slow"],
        w["rope_mscale"], w["rope_mscale_all_dim"], w["rope_theta"])
    assert (spec["num_hidden_layers"], spec["n_routed_experts"]) == (w["n_layers"],
                                                                    w["n_experts_held"]) == (31, 8)
    assert w["n_experts"] == spec["published"]["n_routed_experts"] == 256
    assert "EP32" in spec["deployment"] and "1,024 routed rows" in spec["why"]


# ------------------------------------------------------------------- formulas --

W = dict(d_model=4, n_heads=2, qk_nope_dim=2, qk_rope_dim=2, v_head_dim=3, q_lora_rank=5,
         kv_lora_rank=6, n_layers=3, first_k_dense=1, d_ff=7, n_experts=8, moe_shared_d_ff=9,
         moe_d_ff=10, vocab_size=11)


def test_deepseek_flops_counted_by_hand():
    # q_a 4x5, q_b 5x(2*4), kv_a 4x(6+2), kv_b 6x(2*5), o (2*3)x4
    assert deepseek_flops.mla_proj_flops(W) == 2 * (20 + 40 + 32 + 60 + 24)
    # 2 heads, 8*9/2 pairs a row, 4 + 3 dims
    assert deepseek_flops.attention_flops(W, 1, 8) == 2 * 2 * 36 * 7
    assert deepseek_flops.dense_flops(W) == 3 * 2 * 4 * 7
    assert deepseek_flops.moe_token_flops(W) == 2 * 4 * 8 + 3 * 2 * 4 * 9
    assert deepseek_flops.routed_row_flops(W) == 3 * 2 * 4 * 10
    T = 8
    assert deepseek_flops.prefill_flops(W, 1, 8, 5) == (
        3 * (T * deepseek_flops.mla_proj_flops(W) + deepseek_flops.attention_flops(W, 1, 8))
        + T * deepseek_flops.dense_flops(W) + 2 * T * deepseek_flops.moe_token_flops(W)
        + 5 * deepseek_flops.routed_row_flops(W) + 2 * 4 * 11)
    assert deepseek_flops.flash_bound_s(W, 1, 8, "bfloat16") == \
        deepseek_flops.attention_flops(W, 1, 8) / roofline.PEAK["bfloat16"]


def test_published_flops_of_an_item():
    """2 x 16,384 tokens, each held expert 1/32 of the T k routes: some 1,245
    TFLOP, attention's core 22.0 TFLOP a layer (55%), the MLA projections
    12.3, the flash bound 22.2 ms a layer."""
    w = _spec()["widths"]
    T = 2 * 16384
    held = 28 * T * 8 * 8 // 256
    total = deepseek_flops.prefill_flops(w, 2, 16384, held)
    assert total == pytest.approx(1.244e15, rel=1e-3)
    assert deepseek_flops.attention_flops(w, 2, 16384) == pytest.approx(21.99e12, rel=1e-3)
    assert T * deepseek_flops.mla_proj_flops(w) == pytest.approx(12.26e12, rel=1e-3)
    assert 31 * deepseek_flops.attention_flops(w, 2, 16384) / total == pytest.approx(0.548,
                                                                                     abs=2e-3)
    assert deepseek_flops.flash_bound_s(w, 2, 16384, "bfloat16") == pytest.approx(22.24e-3,
                                                                                 rel=1e-3)


# -------------------------------------------------------------------- readers --

def _events(calls):
    """``calls`` layers: an MLA block 100 us of device, of which its flash
    kernel 60 us; an MoE layer 50 us; 50 us outside any span."""
    evs, corr = [span("window", 0, 1000 * calls)], 0
    for c in range(calls):
        o = 1000 * c
        evs += [span("mla.attention", o, o + 100), span("flash_attention", o + 20, o + 60),
                launch(o + 10, corr + 1), launch(o + 30, corr + 2),
                kernel("proj_gemm", o + 200, o + 240, corr + 1),
                kernel("void flash_fwd_bf16<192, 128>", o + 240, o + 300, corr + 2),
                span("deepseek.moe", o + 100, o + 200), launch(o + 150, corr + 3),
                kernel("grouped_gemm", o + 300, o + 350, corr + 3),
                launch(o + 600, corr + 4), kernel("head", o + 350, o + 400, corr + 4)]
        corr += 4
    return evs


def _read(metric, evs, work):
    prof = Profiler()  # noqa: F841  (found in this frame by spans.live_profiler)
    prof._prof = types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=types.SimpleNamespace(events=lambda: evs)))
    logs = []
    ctx = harness.Context(REPO, {}, {}, dict(TINY), {}, 1, torch.device("cpu"), True,
                          log=logs.append)
    run = harness.Run(ctx, [harness.Item(0.0, 1.0, 1)], 1.0, work, {}, prof.trace())
    reader = harness.load_module(REPO / "h100bench" / "metrics" / f"{metric}.py",
                                 f"test_metric_{metric.replace('.', '_')}")
    return reader.read(run), logs


WORK = {"mla_calls": 4, "flash_calls": 4, "moe_calls": 4, "flash_bound_s": 4 * 30e-6}


def test_mla_share_reads_its_span():
    got, _ = _read("mla_share.deepseek_prefill", _events(4), WORK)
    assert got == pytest.approx(50.0)


def test_moe_share_reads_its_span():
    got, _ = _read("moe_share.deepseek_prefill", _events(4), WORK)
    assert got == pytest.approx(25.0)


def test_mla_attention_roofline_reads_the_flash_span():
    """A bound of 30 us a call over the 60 us charged to ``flash_attention``."""
    got, logs = _read("mla_attention_roofline.deepseek_prefill", _events(4), WORK)
    assert got == pytest.approx(50.0), logs


def test_device_idle_reads_the_window():
    """The prefill cells' ``device_idle.prefill``, which the cell lists."""
    got, _ = _read("device_idle.prefill", _events(4), WORK)
    assert got == pytest.approx(100.0 * (1 - 4 * 200 / 4000))


def test_mfu_reads_the_drivers_model_flops():
    """The prefill cells' ``mfu.prefill``, which the cell lists: ``work``'s
    model FLOPs (the held routes' too) over the 1 s window at the bf16 peak."""
    from h100bench.readers import PEAK

    got, _ = _read("mfu.prefill", _events(4), dict(WORK, model_flops=0.25 * PEAK["bfloat16"]))
    assert got == pytest.approx(25.0)


def test_the_cell_lists_a_reader_for_each_of_its_metrics():
    """The cell's per-layer metrics: its own three readers and the prefill
    cells' ``mfu.prefill`` and ``device_idle.prefill``, each with its file."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    mine = {m["name"] for m in bench["per_layer"]
            if "deepseek-v3.prefill-16k" in m.get("workloads", [])}
    assert mine == {"mfu.prefill", "device_idle.prefill", "mla_share.deepseek_prefill",
                    "mla_attention_roofline.deepseek_prefill", "moe_share.deepseek_prefill"}
    for name in mine:
        assert (REPO / "h100bench" / "metrics" / f"{name}.py").is_file(), name


@pytest.mark.parametrize("case", ["counter off", "a layer more", "no program spans"])
@pytest.mark.parametrize("metric", ["mla_share.deepseek_prefill", "moe_share.deepseek_prefill",
                                    "mla_attention_roofline.deepseek_prefill"])
def test_readers_leave_out_a_count_mismatch(metric, case):
    evs, work = _events(4), dict(WORK)
    if case == "counter off":
        work = {k: (3 if k.endswith("calls") else v) for k, v in work.items()}
    if case == "a layer more":
        evs = evs + [span("mla.attention", 3500, 3501), span("flash_attention", 3500, 3501),
                     span("deepseek.moe", 3502, 3503)]
    if case == "no program spans":
        evs = [e for e in evs if not e.is_user_annotation() or e.name() == "window"]
    got, logs = _read(metric, evs, work)
    assert got is None and any("left out" in line or "no program spans" in line
                               for line in logs), logs


def test_roofline_leaves_out_a_launch_the_trace_lost():
    """The spans and the counter agree, but the trace holds a launch of the
    flash kernel fewer: its time is not that of the counted calls."""
    evs = _events(4)
    evs.remove(next(e for e in evs if e.name().startswith("void flash")))
    got, logs = _read("mla_attention_roofline.deepseek_prefill", evs, WORK)
    assert got is None and any("left out" in line for line in logs), logs
