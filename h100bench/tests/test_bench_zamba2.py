"""The zamba2 cell's benchmark files on the CPU at small sizes: the hybrid
prefill driver run whole, with the weights, reference and formulas made for
it, added as files beside the benchmark's own (none edited).

* a tiny zamba2 cell runs and is correct (both of its numbers); the
  planted faults, zamba2's own (``h100bench/zamba2_faults.py``, removed
  when their context closes) and the float8 control are not;
* the zamba2 weights have the port's keys, shapes and dtypes at the
  published widths (on ``meta``);
* ``zamba2_flops`` and the grouped SSD floor reduce to ``model_flops`` and
  ``roofline.ssd_floor`` at a Mamba-only, one-group width, and count a site
  and a group as made by hand;
* the driver's widths check refuses a width the port-only configuration
  lacks, and one that differs outside ``reduced``;
* the shared-block and attention readers on synthetic spans, and left out
  where the port's counter and the window's spans disagree.
"""

from __future__ import annotations

import json
import types

import pytest
import torch

from h100bench.tests.bench_root import REPO, make_root
from h100bench.tests.test_bench_spans import AUTOGRAD, kernel, launch, span  # noqa: F401

from h100bench import faults, harness  # noqa: E402
from h100bench import zamba2_faults  # noqa: E402
from h100bench import zamba2_inputs as zin  # noqa: E402
from h100bench.reference.model import named_leaves  # noqa: E402
from h100bench.trace import Profiler  # noqa: E402
from h100bench.work import model_flops, roofline, ssd_groups, zamba2_flops  # noqa: E402

SEED = 2**33 + 29
#: a tiny zamba2 of the port-only arch: every key that differs from it is in reduced
TINY = dict(n_layers=5, d_model=64, vocab_size=96, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=96,
            ssm_state=16, ssm_headdim=16, ssm_expand=2, ssm_chunk=16, ssm_conv_width=4,
            ssm_ngroups=2, hybrid_layer_ids=[1, 2, 4], num_mem_blocks=2, adapter_rank=8,
            rope_theta=10000.0, norm_eps=1e-5, tie_embeddings=True)
KEEP = {"ssm_expand", "ssm_conv_width", "ssm_ngroups", "num_mem_blocks", "rope_theta",
        "norm_eps", "tie_embeddings"}
MIX = dict(kind="hybrid_prefill", batch=3, seq_len=32, pool=2, check_rows=2)
CELL = "tiny-zamba2.tiny-hybrid"
#: from CPU readings of bf16 runs on six seeds (0.0104-0.0173), well above
#: them; the float8 control reads 0.109-0.197 on the same seeds
LIMIT = 0.05
#: the program in float32 reads 2.5e-7-3.7e-7 on six seeds; zamba2's faults 6.3e-5
#: and up, the float8 control 0.11-0.19
LIMIT_F32 = 1e-5


def tiny_spec(dtype="bfloat16"):
    return dict(name="tiny-zamba2", arch="zamba2-7b", family="zamba2", dtype=dtype,
                source="a test", widths=dict(TINY),
                reduced=[k for k in TINY if k not in KEEP], assumed={}, departures=[])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_zamba2_root(tmp_path_factory.mktemp("bench"))


def make_zamba2_root(tmp):
    """``bench_root.make_root`` with the tiny zamba2 cell added as files and entries."""
    root = make_root(tmp)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    spec = tiny_spec()
    (root / "h100bench" / "configs" / "tiny-zamba2.json").write_text(json.dumps(spec))
    bench["configs"].append({"name": "tiny-zamba2", "source": "a test",
                             "file": "h100bench/configs/tiny-zamba2.json",
                             "reduced": spec["reduced"], "why": "a test"})
    (root / "h100bench" / "traffic" / "tiny-hybrid.json").write_text(json.dumps(MIX))
    bench["workloads"].append({"name": CELL, "config": "tiny-zamba2", "traffic": "tiny-hybrid",
                               "chips": 1, "why": "a test"})
    (root / "h100bench" / "limits" / f"{CELL}.json").write_text(
        json.dumps({"logits_err": {"limit": LIMIT}, "logits_err_f32": {"limit": LIMIT_F32}}))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "zamba2-7b.prefill-4k" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(root, seed=SEED, seconds=0.3):
    return harness.run_cell(root, CELL, seed, seconds, False, device="cpu", log=lambda s: None)


def test_tiny_cell_runs_and_is_correct(root):
    out = run(root)
    assert out["correct"] is True and out["attempted"] >= 1, out["checks"]
    assert set(out["metrics"]) == {"prefill_tok_per_s", "setup_s"}
    assert set(out["checks"]) == {"logits_err", "logits_err_f32"}


@pytest.mark.parametrize("fault", faults.KINDS["prefill"])
def test_planted_fault_is_not_correct(root, fault):
    with faults.planted(fault):
        out = run(root)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault", zamba2_faults.FAULTS)
def test_planted_zamba2_fault_is_not_correct_and_is_removed(root, fault):
    """Each of zamba2's faults fails the tiny cell by its float32 number
    (6.3e-5 to 0.22 on seeds 5, 6 and SEED, against a limit of 1e-5; in
    bf16 all but ``norm_not_grouped`` move the tiny cell's logits by less
    than its rounding), and its context leaves the port as it found it."""
    from repro_torch.kernels.mamba_passes import kernel as mp
    from repro_torch.kernels.mamba_passes import ref as passes_ref
    from repro_torch.models import mamba2, model_api, zamba2

    where = [(model_api, "build_model"), (zamba2, "flash_attention"), (mamba2, "ssd_scan"),
             (mp, "gate_norm_cuda"), (passes_ref, "gated_norm")]
    before = [getattr(mod, attr) for mod, attr in where]
    with zamba2_faults.planted(fault, TINY["n_layers"]):
        out = run(root)
    assert [getattr(mod, attr) for mod, attr in where] == before
    assert out["checks"]["logits_err_f32"]["value"] > LIMIT_F32, out["checks"]
    assert out["correct"] is False


def test_float8_control_is_not_correct(root):
    ctx = harness.context(root, CELL, SEED, "cpu", False, log=lambda s: None)
    drv = harness.driver(ctx)
    st = drv.setup(ctx)
    for i in range(drv.check_items(ctx)):
        drv.item(ctx, st, i)
    sound, low = drv.check(ctx, st), drv.control(ctx, st)
    assert sound["logits_err"] <= LIMIT < low["logits_err"], (sound, low)
    assert sound["logits_err_f32"] <= LIMIT_F32 < low["logits_err_f32"], (sound, low)


def test_work_counts_the_window(root):
    """``work`` after a window: the model FLOPs and SSD calls of its items,
    and the shared-block calls the port counted in it (not the warm-up's)."""
    ctx = harness.context(root, CELL, SEED, "cpu", False, log=lambda s: None)
    drv = harness.driver(ctx)
    st = drv.setup(ctx)
    items = [harness.Item(0.0, 1.0, drv.item(ctx, st, i)) for i in range(2)]
    w = drv.work(ctx, st, items)
    assert w["shared_block_calls"] == 2 * len(TINY["hybrid_layer_ids"])
    assert w["ssd_scan_calls"] == 2 * TINY["n_layers"]
    assert w["model_flops"] == 2 * zamba2_flops.prefill_flops(ctx.widths, 3, 32)


class MetaGenerator(torch.Generator):
    @property
    def device(self):
        return torch.device("meta")


def test_input_tree_has_the_ports_layout(root, monkeypatch):
    """At the published widths (on ``meta``, nothing allocated)."""
    monkeypatch.setattr(zin, "generator", lambda seed, stream, device: MetaGenerator())
    spec = harness.read_json(REPO / "h100bench" / "configs" / "zamba2-7b.json")
    ctx = harness.context(root, CELL, SEED, "cpu", False, log=lambda s: None)
    drv = harness.driver(ctx)
    from repro_torch.models.model_api import build_model

    cfg = drv.model_config(spec)
    ours = zin.weights(harness.widths(spec), 0, "meta")
    theirs = build_model(cfg, "meta").init(MetaGenerator())
    shape = lambda tree: {n: (tuple(t.shape), t.dtype) for n, t in named_leaves(tree)}  # noqa: E731
    assert shape(ours) == shape(theirs)
    assert sum(t.numel() for _, t in named_leaves(ours)) == pytest.approx(7.36e9, rel=0.01)


def test_widths_check_refuses_what_the_port_only_config_lacks_or_differs(root):
    ctx = harness.context(root, CELL, SEED, "cpu", False, log=lambda s: None)
    drv = harness.driver(ctx)
    spec = harness.read_json(REPO / "h100bench" / "configs" / "zamba2-7b.json")
    assert drv.model_config(spec).hybrid_layer_ids == tuple(spec["widths"]["hybrid_layer_ids"])
    with pytest.raises(ValueError, match="has no attention_bias"):
        drv.model_config(dict(spec, widths=dict(spec["widths"], attention_bias=False)))
    with pytest.raises(ValueError, match="ssm_ngroups"):
        drv.model_config(dict(spec, widths=dict(spec["widths"], ssm_ngroups=1)))


# ------------------------------------------------------------------- formulas --

W = dict(family="ssm", n_layers=2, d_model=4, ssm_expand=2, ssm_headdim=4, ssm_state=2,
         ssm_conv_width=3, ssm_chunk=4, vocab_size=10, dtype="bfloat16")


def test_formulas_reduce_to_the_mamba_ones_at_one_group_and_no_site():
    for w in (W, dict(W, ssm_ngroups=1, hybrid_layer_ids=[])):
        assert zamba2_flops.prefill_flops(w, 2, 8) == model_flops.prefill_flops(W, 2, 8)
    for args in [(1, 8, 2, 4, 2, 4, "bfloat16"), (8, 4096, 64, 64, 128, 256, "bfloat16"),
                 (2, 512, 4, 32, 16, 128, "float32")]:
        assert ssd_groups.grouped_ssd_floor(*args) == roofline.ssd_floor(*args)
        assert ssd_groups.grouped_ssd_bound_s(*args) == roofline.ssd_bound_s(*args)


def test_groups_and_sites_counted_by_hand():
    w = dict(W, ssm_ngroups=2, n_heads=2, head_dim=4, d_ff=6, adapter_rank=1,
             hybrid_layer_ids=[1])
    # in_proj 4 x (16 + 2*2*2 + 2) = 4 x 26, conv 3 x (8 + 8), out_proj 8 x 4
    assert zamba2_flops.mamba_proj_flops(w) == 2 * 4 * 26 + 2 * 3 * 16 + 2 * 8 * 4
    # one more group: C B^T of 2 chunks, 4*5 pairs x N=2 x 2 FLOPs... once more
    assert zamba2_flops.ssd_flops(w, 1, 8) == model_flops.ssd_flops(W, 1, 8) + 2 * 4 * 5 * 2
    # q, k, v 8 -> 8; o 8 -> 4; gate-up 4 -> 12; adapter 4 -> 1 -> 12; down 6 -> 4; linear 4 -> 4
    site = 2 * (3 * 8 * 8 + 8 * 4 + 4 * 12 + 4 * 1 + 1 * 12 + 6 * 4 + 4 * 4)
    assert zamba2_flops.site_flops(w) == site
    # QK^T and PV: 2 heads x 4 dims x 8*9/2 pairs, x2 products x2 FLOPs
    assert zamba2_flops.attention_flops(w, 1, 8) == 2 * 2 * 2 * 4 * 36
    mamba = 2 * (8 * zamba2_flops.mamba_proj_flops(w) + zamba2_flops.ssd_flops(w, 1, 8))
    assert zamba2_flops.prefill_flops(w, 1, 8) == (mamba + 8 * site
                                                   + zamba2_flops.attention_flops(w, 1, 8) + 80)
    f1, f2 = (ssd_groups.grouped_ssd_floor(1, 8, 2, 4, 2, 4, "bfloat16", g) for g in (1, 2))
    # a second group: B and C (2 x 16 bf16) read once more, C B^T once more
    assert f2["t_bytes_s"] - f1["t_bytes_s"] == pytest.approx(2 * 16 * 2 / roofline.HBM_BPS)
    assert f2["t_ops_s"] - f1["t_ops_s"] == pytest.approx(2 * 4 * 5 * 2 / roofline.PEAK["bfloat16"])


# -------------------------------------------------------------------- readers --

SITE_READERS = {"shared_block_share.zamba2_prefill": 60.0,
                "attention_share.zamba2_prefill": 20.0}


def _site_events(items, sites):
    """``items`` windows of ``sites`` sites: a site's attention kernel 20 us,
    the rest of its shared block 40 us, a Mamba block's pass 40 us (100 us of
    device a site)."""
    evs, corr = [span("window", 0, 1000 * items * sites)], 0
    for k in range(items * sites):
        o = 1000 * k
        evs += [span("zamba2.shared_block", o, o + 100), span("flash_attention", o + 10, o + 40),
                launch(o + 20, corr + 1), launch(o + 60, corr + 2),
                kernel("attn_kernel", o + 200, o + 220, corr + 1),
                kernel("mlp_kernel", o + 220, o + 260, corr + 2),
                span("mamba.block", o + 100, o + 200), launch(o + 150, corr + 3),
                kernel("pass_kernel", o + 260, o + 300, corr + 3)]
        corr += 3
    return evs


def _read(metric, evs, items, work):
    prof = Profiler()  # noqa: F841  (found in this frame by spans.live_profiler)
    prof._prof = types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=types.SimpleNamespace(events=lambda: evs)))
    logs = []
    ctx = harness.Context(REPO, {}, {}, dict(TINY, hybrid_layer_ids=[1, 3]), {}, 1,
                          torch.device("cpu"), True, log=logs.append)
    run = harness.Run(ctx, [harness.Item(0.0, 1.0, 1)] * items, 1.0, work, {}, prof.trace())
    reader = harness.load_module(REPO / "h100bench" / "metrics" / f"{metric}.py",
                                 f"test_metric_{metric.replace('.', '_')}")
    return reader.read(run), logs


@pytest.mark.parametrize("metric", sorted(SITE_READERS))
def test_site_readers_read_their_spans(metric):
    got, _ = _read(metric, _site_events(2, 2), 2, {"shared_block_calls": 4})
    assert got == pytest.approx(SITE_READERS[metric])


@pytest.mark.parametrize("case", ["counter off", "a site more", "no program spans"])
@pytest.mark.parametrize("metric", sorted(SITE_READERS))
def test_site_readers_leave_out_a_count_mismatch(metric, case):
    evs, calls = _site_events(2, 2), 4
    if case == "counter off":
        calls = 3
    if case == "a site more":
        evs = evs + [span("zamba2.shared_block", 3500, 3501), span("flash_attention", 3500, 3501)]
    if case == "no program spans":
        evs = [e for e in evs if not e.is_user_annotation() or e.name() == "window"]
    got, logs = _read(metric, evs, 2, {"shared_block_calls": calls})
    assert got is None and any("left out" in line for line in logs), logs
