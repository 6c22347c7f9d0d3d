"""The nemotron_h cell's benchmark files on the CPU at small sizes: the
Nemotron-H prefill driver run whole, with the weights, reference, faults and
formulas made for it, added as files beside the benchmark's own (none edited).

* a tiny nemotron_h cell runs and is correct (its three numbers); the
  prefill faults, nemotron_h's own (``h100bench/nemotron_faults.py``, removed
  when their context closes) and the float8 control are not; the fault in
  the grouped GEMMs' group ends fails it by ``layer_err_bf16`` alone, with
  the grouped route taken on the CPU;
* ``work`` counts the window's MoE calls and routes from the port's
  counters (T k a call: nothing dropped);
* the weights have the port's keys, shapes and dtypes at the published
  widths (on ``meta``): 31.58 B parameters;
* the configuration file holds the catalog's config.json and the driver's
  widths check takes it against the port-only configuration;
* ``nemotron_flops`` and ``moe_groups`` against counts made by hand;
* the MoE share and expert-GEMM roofline readers on synthetic spans, and
  left out where the port's counter and the window's spans disagree.
"""

from __future__ import annotations

import json
import types

import pytest
import torch

from h100bench.tests.bench_root import REPO, make_root
from h100bench.tests.test_bench_spans import kernel, launch, span  # noqa: F401

from h100bench import faults, harness, nemotron_faults  # noqa: E402
from h100bench import nemotron_inputs as nin  # noqa: E402
from h100bench.reference.model import named_leaves  # noqa: E402
from h100bench.trace import Profiler  # noqa: E402
from h100bench.work import moe_groups, nemotron_flops, roofline  # noqa: E402

SEED = 2**33 + 31
#: a tiny nemotron_h of the port-only arch: every key that differs from it is in reduced
TINY = dict(n_layers=6, d_model=64, vocab_size=96, n_heads=4, n_kv_heads=2, head_dim=16,
            layer_pattern="ME*MEM", mamba_num_heads=4, ssm_headdim=16, ssm_state=16,
            ssm_ngroups=2, ssm_conv_width=4, ssm_chunk=16, n_experts=8, experts_per_token=3,
            moe_d_ff=32, moe_shared_d_ff=48, routed_scaling_factor=2.5, norm_eps=1e-5,
            tie_embeddings=False)
KEEP = {"ssm_conv_width", "routed_scaling_factor", "norm_eps", "tie_embeddings"}
MIX = dict(kind="nemotron_prefill", batch=3, seq_len=32, pool=2, check_rows=2)
CELL = "tiny-nemotron.tiny-moe-hybrid"
#: from CPU readings of bf16 runs on six seeds (1-5 and SEED: 0.0068-0.0132),
#: well above them; the float8 control reads 0.092-0.104 on the same seeds
LIMIT = 0.04
#: the program's layers in float32 read 5.1e-7-1.03e-6 on the same six seeds;
#: the faults 1.6e-4 (one Mamba layer's groups swapped) and up on seeds 5, 6
#: and SEED, the float8 control 0.070-0.081
LIMIT_F32 = 1e-5
#: the window's bf16 layers against the reference's float32 ones: 0.044-0.065 on the
#: same six seeds (at d_model 64 the addends are small beside the residual stream, whose
#: bf16 rounding sets the number), the float8 control 0.075-0.094 there, so the control
#: is held by the other two numbers; the grouped route's ends one row early 0.59-0.67
LIMIT_BF16 = 0.2


def tiny_spec(dtype="bfloat16"):
    return dict(name="tiny-nemotron", arch="nemotron-3-nano-30b-a3b", family="nemotron_h",
                dtype=dtype, source="a test", widths=dict(TINY),
                reduced=[k for k in TINY if k not in KEEP], assumed={}, departures=[])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_nemotron_root(tmp_path_factory.mktemp("bench"))


def make_nemotron_root(tmp):
    """``bench_root.make_root`` with the tiny nemotron_h cell added as files and entries."""
    root = make_root(tmp)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    spec = tiny_spec()
    (root / "h100bench" / "configs" / "tiny-nemotron.json").write_text(json.dumps(spec))
    bench["configs"].append({"name": "tiny-nemotron", "source": "a test",
                             "file": "h100bench/configs/tiny-nemotron.json",
                             "reduced": spec["reduced"], "why": "a test"})
    (root / "h100bench" / "traffic" / "tiny-moe-hybrid.json").write_text(json.dumps(MIX))
    bench["workloads"].append({"name": CELL, "config": "tiny-nemotron",
                               "traffic": "tiny-moe-hybrid", "chips": 1, "why": "a test"})
    (root / "h100bench" / "limits" / f"{CELL}.json").write_text(
        json.dumps({"logits_err": {"limit": LIMIT}, "layer_err_bf16": {"limit": LIMIT_BF16},
                    "layer_err_f32": {"limit": LIMIT_F32}}))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "nemotron-3-nano-30b-a3b.prefill-4k" in m.get("workloads", []):
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


@pytest.mark.parametrize("fault", nemotron_faults.EVERY_ROUTE)
def test_planted_nemotron_fault_is_not_correct_and_is_removed(root, fault):
    """Each of nemotron_h's faults fails the tiny cell by its float32 number
    (the teacher-forced logits follow the faulted routes, so a router fault
    need not show there), and its context leaves the port as it found it."""
    from repro_torch.kernels.mamba_passes import kernel as mp
    from repro_torch.kernels.mamba_passes import ref as passes_ref
    from repro_torch.models import mamba2, moe_dropless, nemotron_h

    where = [(moe_dropless, "route"), (moe_dropless, "relu2"), (moe_dropless, "moe_apply"),
             (nemotron_h, "flash_attention"), (mamba2, "ssd_scan"), (mp, "gate_norm_cuda"),
             (passes_ref, "gated_norm")]
    before = [getattr(mod, attr) for mod, attr in where]
    with nemotron_faults.planted(fault, TINY["layer_pattern"].count("M")):
        out = run(root)
    assert [getattr(mod, attr) for mod, attr in where] == before
    assert out["checks"]["layer_err_f32"]["value"] > LIMIT_F32, out["checks"]
    assert out["correct"] is False


def test_grouped_route_fault_is_seen_by_the_bf16_layers_alone(root, monkeypatch):
    """With the grouped route taken on the CPU (``torch._grouped_mm`` has a
    CPU version), the tiny cell is correct; with the group ends one row
    early it is not, by ``layer_err_bf16``, while the float32 program, on
    the plain route, stays within ``layer_err_f32``; the fault's context
    puts the grouped GEMM back."""
    from repro_torch.models import moe_dropless

    monkeypatch.setattr(moe_dropless, "PLAIN_DEVICES", ("meta",))
    grouped, real = [], moe_dropless.experts_grouped
    monkeypatch.setattr(moe_dropless, "experts_grouped", lambda *a: grouped.append(1) or real(*a))
    sound = run(root)
    assert sound["correct"] is True and grouped, sound["checks"]
    gemm = torch._grouped_mm
    with nemotron_faults.planted("ends_off_by_one", TINY["layer_pattern"].count("M")):
        out = run(root)
    assert torch._grouped_mm is gemm
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert checks["layer_err_bf16"] > LIMIT_BF16 and checks["layer_err_f32"] <= LIMIT_F32, checks
    assert out["correct"] is False


def test_float8_control_is_not_correct(root):
    sound, low = reading(root)
    assert sound["logits_err"] <= LIMIT < low["logits_err"], (sound, low)
    assert sound["layer_err_f32"] <= LIMIT_F32 < low["layer_err_f32"], (sound, low)


def test_work_counts_the_window(root):
    """``work`` after a window: the model FLOPs and SSD calls of its items,
    and the MoE calls and routes the port counted in it (not the warm-up's):
    T k routes a call, none dropped."""
    ctx = harness.context(root, CELL, SEED, "cpu", False, log=lambda s: None)
    drv = harness.driver(ctx)
    st = drv.setup(ctx)
    items = [harness.Item(0.0, 1.0, drv.item(ctx, st, i)) for i in range(2)]
    w = drv.work(ctx, st, items)
    n_moe = TINY["layer_pattern"].count("E")
    assert w["moe_calls"] == 2 * n_moe
    assert w["moe_routed_rows"] == 2 * n_moe * 3 * 32 * TINY["experts_per_token"]
    assert w["ssd_scan_calls"] == 2 * TINY["layer_pattern"].count("M")
    assert w["model_flops"] == 2 * nemotron_flops.prefill_flops(ctx.widths, 3, 32)
    assert w["moe_experts_bound_s"] == 2 * n_moe * moe_groups.bound_s(ctx.widths, 3 * 32 * 3,
                                                                      "bfloat16")


class MetaGenerator(torch.Generator):
    @property
    def device(self):
        return torch.device("meta")


def test_input_tree_has_the_ports_layout(root, monkeypatch):
    """At the published widths (on ``meta``, nothing allocated)."""
    monkeypatch.setattr(nin, "generator", lambda seed, stream, device: MetaGenerator())
    spec = harness.read_json(REPO / "h100bench" / "configs" / "nemotron-3-nano-30b-a3b.json")
    ctx = harness.context(root, CELL, SEED, "cpu", False, log=lambda s: None)
    drv = harness.driver(ctx)
    from repro_torch.models.model_api import build_model

    cfg = drv.model_config(spec)
    ours = nin.weights(harness.widths(spec), 0, "meta")
    theirs = build_model(cfg, "meta").init(MetaGenerator())
    shape = lambda tree: {n: (tuple(t.shape), t.dtype) for n, t in named_leaves(tree)}  # noqa: E731
    assert shape(ours) == shape(theirs)
    n = sum(t.numel() for _, t in named_leaves(ours))
    assert n == pytest.approx(31.58e9, rel=1e-3)
    assert sum(t.numel() * t.element_size() for _, t in named_leaves(ours)) == \
        pytest.approx(63.16e9, rel=1e-3)


def test_configuration_file_holds_the_catalog_config_and_the_ports_widths(root):
    spec = harness.read_json(REPO / "h100bench" / "configs" / "nemotron-3-nano-30b-a3b.json")
    w = spec["widths"]
    assert spec["reduced"] == [] and "NoPE" in spec["assumed"]["position_embedding"]
    # the release's keys, as its config.json names them, beside the port's widths
    assert (spec["hidden_size"], spec["mamba_num_heads"] * spec["mamba_head_dim"],
            spec["n_groups"], spec["ssm_state_size"], spec["chunk_size"]) == (
        w["d_model"], 4096, w["ssm_ngroups"], w["ssm_state"], w["ssm_chunk"])
    assert (spec["n_routed_experts"], spec["num_experts_per_tok"], spec["moe_intermediate_size"],
            spec["moe_shared_expert_intermediate_size"], spec["routed_scaling_factor"]) == (
        w["n_experts"], w["experts_per_token"], w["moe_d_ff"], w["moe_shared_d_ff"],
        w["routed_scaling_factor"])
    assert spec["hybrid_override_pattern"] == w["layer_pattern"]
    assert (spec["n_group"], spec["topk_group"], spec["norm_topk_prob"],
            spec["tie_word_embeddings"]) == (1, 1, True, False)
    ctx = harness.context(root, CELL, SEED, "cpu", False, log=lambda s: None)
    cfg = harness.driver(ctx).model_config(spec)
    assert (cfg.d_inner, cfg.ssm_nheads, cfg.layer_pattern) == (4096, 64, w["layer_pattern"])
    with pytest.raises(ValueError, match="ssm_ngroups"):
        harness.driver(ctx).model_config(dict(spec, widths=dict(w, ssm_ngroups=1)))


# ------------------------------------------------------------------- formulas --

W = dict(d_model=4, mamba_num_heads=2, ssm_headdim=4, ssm_state=2, ssm_ngroups=2,
         ssm_conv_width=3, ssm_chunk=4, n_heads=4, n_kv_heads=2, head_dim=2, n_experts=4,
         experts_per_token=2, moe_d_ff=3, moe_shared_d_ff=5, vocab_size=10,
         layer_pattern="ME*E")


def test_nemotron_flops_counted_by_hand():
    # in_proj 4 x (8 + 16 + 2): d_inner 8, conv channels 8 + 2*2*2 = 16, 2 heads;
    # conv 3 x 16; out_proj 8 x 4
    assert nemotron_flops.mamba_proj_flops(W) == 2 * 4 * 26 + 2 * 3 * 16 + 2 * 8 * 4
    # 2 chunks of Q=4: C B^T 2 groups x 4*5 pairs x N=2; a head 4*5*4 + 2*4*2*4 + 2*4*2*4
    assert nemotron_flops.ssd_flops(W, 1, 8) == 2 * 2 * 4 * 5 * 2 + 2 * 2 * (80 + 64 + 64)
    # q 4 -> 8, k and v 4 -> 4 each, o 8 -> 4
    assert nemotron_flops.attn_proj_flops(W) == 2 * (4 * 8 + 2 * 4 * 4 + 8 * 4)
    assert nemotron_flops.attention_flops(W, 1, 8) == 2 * 2 * 4 * 2 * 36
    # router 4 x 4; 2 experts of 4 -> 3 -> 4; shared 4 -> 5 -> 4
    assert nemotron_flops.moe_flops(W) == 2 * (16 + 2 * (12 + 12) + 20 + 20)
    T = 8
    assert nemotron_flops.prefill_flops(W, 1, 8) == (
        T * nemotron_flops.mamba_proj_flops(W) + nemotron_flops.ssd_flops(W, 1, 8)
        + T * nemotron_flops.attn_proj_flops(W) + nemotron_flops.attention_flops(W, 1, 8)
        + 2 * T * nemotron_flops.moe_flops(W) + 2 * 4 * 10)


def test_published_model_flops_per_token():
    spec = harness.read_json(REPO / "h100bench" / "configs" / "nemotron-3-nano-30b-a3b.json")
    w = spec["widths"]
    per_token = nemotron_flops.prefill_flops(w, 8, 4096) / (8 * 4096)
    assert per_token == pytest.approx(6.015e9, rel=1e-3)
    assert 23 * nemotron_flops.moe_flops(w) == pytest.approx(3.688e9, rel=1e-3)


def test_moe_groups_counted_by_hand():
    f = moe_groups.floor(W, 10, "bfloat16")
    # both weights of 4 experts (4 x 3 each) and 10 rows of 4 in and out, bf16
    assert f["t_bytes_s"] == pytest.approx((2 * 4 * 4 * 3 * 2 + 2 * 10 * 4 * 2) / roofline.HBM_BPS)
    assert f["t_ops_s"] == pytest.approx(4 * 10 * 4 * 3 / roofline.PEAK["bfloat16"])
    assert moe_groups.bound_s(W, 10, "bfloat16") == max(f.values())


# -------------------------------------------------------------------- readers --

def _moe_events(calls):
    """``calls`` MoE layers: the layer 100 us of device, of which its experts'
    two products 50 us and its router 10 us; a Mamba block's pass 100 us."""
    evs, corr = [span("window", 0, 1000 * calls)], 0
    for c in range(calls):
        o = 1000 * c
        evs += [span("nemotron_h.moe", o, o + 100), span("moe.router", o + 5, o + 15),
                span("moe.experts", o + 20, o + 60), launch(o + 10, corr + 1),
                launch(o + 30, corr + 2), launch(o + 40, corr + 3), launch(o + 80, corr + 4),
                kernel("router", o + 200, o + 210, corr + 1),
                kernel("grouped_gemm_up", o + 210, o + 235, corr + 2),
                kernel("grouped_gemm_down", o + 235, o + 260, corr + 3),
                kernel("combine", o + 260, o + 300, corr + 4),
                span("mamba.block", o + 100, o + 200), launch(o + 150, corr + 5),
                kernel("pass_kernel", o + 300, o + 400, corr + 5)]
        corr += 5
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


def test_moe_share_reads_its_span():
    got, _ = _read("moe_share.nemotron_prefill", _moe_events(4), {"moe_calls": 4})
    assert got == pytest.approx(50.0)


def test_expert_gemm_roofline_reads_the_experts_span():
    """A bound of 20 us a call over the 50 us charged to ``moe.experts``."""
    work = {"moe_calls": 4, "moe_routed_rows": 400, "moe_experts_bound_s": 4 * 20e-9 * 1000}
    got, logs = _read("expert_gemm_roofline.nemotron_prefill", _moe_events(4), work)
    assert got == pytest.approx(40.0), logs


@pytest.mark.parametrize("case", ["counter off", "a layer more", "no program spans"])
@pytest.mark.parametrize("metric", ["moe_share.nemotron_prefill",
                                    "expert_gemm_roofline.nemotron_prefill"])
def test_moe_readers_leave_out_a_count_mismatch(metric, case):
    evs, calls = _moe_events(4), 4
    if case == "counter off":
        calls = 3
    if case == "a layer more":
        evs = evs + [span("nemotron_h.moe", 3500, 3501), span("moe.experts", 3500, 3501)]
    if case == "no program spans":
        evs = [e for e in evs if not e.is_user_annotation() or e.name() == "window"]
    work = {"moe_calls": calls, "moe_routed_rows": 100 * calls, "moe_experts_bound_s": 1e-6}
    got, logs = _read(metric, evs, work)
    assert got is None and any("left out" in line or "no program spans" in line
                               for line in logs), logs
