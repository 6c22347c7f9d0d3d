"""The port's one-card dry run: every family's steps on ``meta``, counted.

``repro_torch.launch.dryrun`` builds the real train, prefill and decode
steps on the ``meta`` device (nothing allocated) and counts their matmul
FLOPs with ``torch.utils.flop_counter.FlopCounterMode``.  The port loops
over its layers where the reference scans, so every layer is counted:
the twin of ``tests/test_roofline.py::test_flops_formula_matches_xla_on_unrolled_tiny_dense``
is sharp here, where the reference's can only assert "same order".

Where a family's count departs from ``analytics.model_flops``, the test
states the size of the gap and the term that causes it: the dense and vlm
families' counts equal ``dryrun.dense_count`` (model_flops less the
norm scales, the head's unrun positions and remat's unrun products)
exactly; the MoE's equal model_flops plus the dense one-hot dispatch's
products exactly; the ssm, hybrid and encdec families sit in stated
bands.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
from repro_torch.launch import dryrun
from repro_torch.launch.analytics import attn_flops_fwd, matmul_params, model_flops
from repro_torch.models.model_api import ShapeSpec
from repro_torch.models.moe import _capacity
from repro_torch.tree import tree_leaves

KINDS = ("train", "prefill", "decode")
#: the tiny cells: B=2, L=64 (the reduced configs' attention chunks are 16)
TINY = {k: ShapeSpec(f"tiny_{k}", 64, 2, k) for k in KINDS}
#: counted / model_flops where no closed form of the port's products is
#: held: (low, high) at TINY, with the terms that make the gap
BANDS = {
    # head at the last position only; conv_w, A_log, D, dt_bias and the norms
    # in matmul_params multiply no matrix; ssd_chunked's products (C·Bᵀ per
    # chunk, the decays, the states) against ssd_flops_fwd's
    ("ssm", "train"): (0.87, 0.89), ("ssm", "prefill"): (0.765, 0.785),
    ("ssm", "decode"): (0.96, 0.98),
    # as ssm, and the shared attention block runs at every site while
    # total_params counts its weights once
    ("hybrid", "train"): (0.93, 0.95), ("hybrid", "prefill"): (0.85, 0.87),
    ("hybrid", "decode"): (0.97, 0.99),
    # model_flops counts the encoder's weights once per decoder token as well
    # as per frame (matmul_params holds them), and decode charges them and
    # the cross K/V projections every step, where the port reads the cross
    # K/V from the cache
    ("encdec", "train"): (0.59, 0.61), ("encdec", "prefill"): (0.66, 0.68),
    ("encdec", "decode"): (0.53, 0.55),
}


def _tiny_cfg(arch, **over):
    return dataclasses.replace(get_config(arch).reduced(dtype="float32"), **over)


def _overrides(arch, cfg):
    """``cfg`` as the dry run's field overrides of the registry's config."""
    full = get_config(arch)
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if getattr(cfg, f.name) != getattr(full, f.name)}


def _count(arch, cfg, shape):
    fn, args, _, _ = dryrun.build_step(arch, shape, _overrides(arch, cfg))
    return dryrun.count_flops(fn, args)


# ------------------------------------------------- the sharp dense twin ---


def test_flops_formula_matches_the_counter_on_tiny_dense():
    """Reduced llama3.2-1b (f32, 2 layers, chunks of 64, no remat): the
    forward ``embed -> forward_hidden_dense -> h @ head`` counted exactly.
    It equals ``2·matmul_params·B·L + attn_flops_fwd`` less the two norm
    scales a block that ``matmul_params`` holds but no product runs
    (2·B·L·2·d_model·n_layers FLOPs): within 1e-12, and the formula's own
    gap is 0.13% of it."""
    from repro_torch.models.common import embed
    from repro_torch.models.transformer import _lm_head_w, forward_hidden_dense

    cfg = _tiny_cfg("llama3.2-1b", n_layers=2, attn_q_chunk=64, attn_k_chunk=64, remat=False)
    params = dryrun.build_step("llama3.2-1b", TINY["prefill"], _overrides("llama3.2-1b", cfg))[1][0]
    B, L = 2, 64

    def fwd(params, tokens):
        x = embed(params["embed"], tokens)
        pos = torch.arange(L, device=x.device).expand(B, L)
        h = forward_hidden_dense(cfg, params, x, pos)
        return h @ _lm_head_w(cfg, params)

    tok = torch.empty((B, L), dtype=torch.int32, device="meta")
    counted = dryrun.count_flops(fwd, (params, tok))
    ours = 2.0 * matmul_params(cfg, True) * B * L + attn_flops_fwd(cfg, B, L, cfg.n_layers)
    norms = 2.0 * B * L * 2 * cfg.d_model * cfg.n_layers
    assert counted == pytest.approx(ours - norms, rel=1e-12, abs=0)
    assert abs(counted / ours - 1) < 2e-3


# -------------------------------------------- every family on meta ---


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_every_step_runs_on_meta(arch, kind):
    """Each family's step at reduced size runs on ``meta``: every argument
    and every output stays there (nothing materialised), and no kernel of
    the port is launched (their wrappers take ``meta`` to the plain
    versions, whose products the counter sees)."""
    cfg = _tiny_cfg(arch)
    fn, args, _, _ = dryrun.build_step(arch, TINY[kind], _overrides(arch, cfg))
    before = (decode_attn_cuda.launches, ssd_scan_cuda.launches)
    out = fn(*args)
    assert (decode_attn_cuda.launches, ssd_scan_cuda.launches) == before
    tensors = [t for t in tree_leaves((args, out)) if isinstance(t, torch.Tensor)]
    assert tensors and all(t.device.type == "meta" for t in tensors)
    if kind == "train":
        _, _, metrics = out
        assert set(metrics) == {"lr", "grad_norm", "loss"}


@pytest.mark.parametrize("arch", [a for a in ARCHS if get_config(a).family == "dense"])
@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_dense_counts_equal_dense_count(arch, remat, kind):
    """The dense family: the count equals ``dense_count`` exactly.  The gap
    to model_flops is the norm scales (every kind), the head at L-1
    positions (prefill: 16% at TINY) and, under remat, the loss's fourth
    pass and each layer's last product (train: 8%)."""
    cfg = _tiny_cfg(arch, remat=remat)
    counted = _count(arch, cfg, TINY[kind])
    assert counted == pytest.approx(dryrun.dense_count(cfg, TINY[kind]), rel=1e-12, abs=0)
    gap = 1 - counted / model_flops(cfg, TINY[kind])["computed"]
    assert {"train": 0.0 <= gap < 0.10, "prefill": 0.14 < gap < 0.18,
            "decode": 0.0 < gap < 2e-3}[kind], gap


@pytest.mark.parametrize("kind", KINDS)
def test_vlm_counts_are_dense_over_the_patches_too(kind):
    """llava: the patch embeddings run through every layer, which
    model_flops (text tokens only) does not count: the count is the dense
    family's at L + n_patches positions, the loss's head on the text
    positions alone."""
    cfg = _tiny_cfg("llava-next-34b")
    sh, Np = TINY[kind], cfg.n_patches
    dense = dataclasses.replace(cfg, family="dense")
    if kind == "decode":
        want = dryrun.dense_count(dense, sh)
    else:
        want = dryrun.dense_count(dense, dataclasses.replace(sh, seq_len=sh.seq_len + Np))
    if kind == "train":
        want -= 3 * 2.0 * cfg.vocab_size * cfg.d_model * sh.global_batch * Np
    assert _count("llava-next-34b", cfg, sh) == pytest.approx(want, rel=1e-12, abs=0)


def _moe_terms(cfg, T):
    """Per MoE layer at T tokens: (one pass of the dispatch einsum, which
    equals one of the combine einsum, over the ``[G, S, E, C]`` one-hots;
    the experts' products over every capacity slot less model_flops' top-k
    experts a token)."""
    S = min(cfg.moe_group_size, T)
    G, E, C, D, F = T // S, cfg.n_experts, _capacity(cfg, S), cfg.d_model, cfg.moe_d_ff
    return 2.0 * G * S * E * C * D, 6.0 * D * F * (G * E * C - T * cfg.experts_per_token)


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b", "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_moe_counts_are_model_flops_plus_the_dense_dispatch(arch, kind):
    """The MoE's prefill and decode: model_flops with the dense family's
    terms (norm scales, the head at the last position), plus the dense
    one-hot dispatch: the dispatch and combine einsums and the experts run
    over every capacity slot (``_moe_terms``).  At TINY qwen3-moe's prefill
    count is 1.6x model_flops."""
    cfg = _tiny_cfg(arch)
    sh = TINY[kind]
    B, L, D, V = sh.global_batch, sh.seq_len, cfg.d_model, cfg.vocab_size
    T = B * (L if kind == "prefill" else 1)
    n_moe = cfg.n_layers // cfg.moe_every
    dispatch, experts = _moe_terms(cfg, T)
    want = (model_flops(cfg, sh)["computed"] - 2.0 * 2 * D * cfg.n_layers * T
            + n_moe * (2 * dispatch + experts))
    if kind == "prefill":
        want -= 2.0 * V * D * B * (L - 1)
    assert _count(arch, cfg, sh) == pytest.approx(want, rel=1e-12, abs=0)


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b", "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("remat", [True, False])
def test_moe_train_count_carries_the_dispatch(arch, remat):
    """The MoE train step, exactly: model_flops less the norm scales' passes
    (and under remat the loss's fourth pass), plus the dispatch einsum
    forward, recomputed and once in the backward (no gradient reaches the
    one-hots), the combine einsum forward and twice in the backward (remat's
    early stop skips it, each group's last product), and the experts' extra
    slots in every pass."""
    cfg = _tiny_cfg(arch, remat=remat)
    sh = TINY["train"]
    T, D = sh.global_batch * sh.seq_len, cfg.d_model
    passes = 4 if remat else 3
    dispatch, experts = _moe_terms(cfg, T)
    want = model_flops(cfg, sh)["computed"] - passes * 2.0 * 2 * D * cfg.n_layers * T
    if remat:
        want -= 2.0 * cfg.vocab_size * D * T
    want += (cfg.n_layers // cfg.moe_every) * ((passes + 2) * dispatch + passes * experts)
    assert _count(arch, cfg, sh) == pytest.approx(want, rel=1e-12, abs=0)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b", "whisper-base"])
def test_other_families_sit_in_their_stated_bands(arch, kind):
    cfg = _tiny_cfg(arch)
    lo, hi = BANDS[(cfg.family, kind)]
    ratio = _count(arch, cfg, TINY[kind]) / model_flops(cfg, TINY[kind])["computed"]
    assert lo < ratio < hi, ratio


# ------------------------------------------------------------- reports ---


def test_run_cell_reports_a_full_width_cell():
    """llama3.2-1b's ``decode_32k`` at its published widths: the count
    within 1e-12 of ``dense_count`` (0.99998 of model_flops), the 140 GB of
    weights and cache past one H100, and per device under the fitted specs
    on both layouts."""
    rep = dryrun.run_cell("llama3.2-1b", "decode_32k", False, verbose=False)
    cfg = get_config("llama3.2-1b")
    assert rep["ok"] and rep["mesh"] == "16x16" and rep["n_devices"] == 256
    assert rep["flops"] == pytest.approx(dryrun.dense_count(cfg, "decode_32k"), rel=1e-12)
    assert not rep["fits_one_h100"] and rep["argument_bytes"] > dryrun.H100_HBM_BYTES
    per = rep["argument_bytes_per_device"]
    assert rep["argument_bytes"] > per["16x16"] > per["pod2x16x16"] > 0
    assert rep["collective_bytes_est"] > 0


def test_a_custom_shape_and_the_cli(capsys, tmp_path):
    rep = dryrun.run_cell("mamba2-1.3b", ShapeSpec("probe", 128, 2, "prefill"), True,
                          verbose=False, overrides={"n_layers": "2"})
    assert rep["shape"] == "probe" and rep["mesh"] == "pod2x16x16" and rep["n_devices"] == 512
    assert rep["overrides"] == {"n_layers": "2"} and rep["fits_one_h100"]
    import sys

    out = tmp_path / "dry.jsonl"
    argv = sys.argv
    sys.argv = ["dryrun", "--arch", "whisper-base", "--shape", "decode_32k", "--both-meshes",
                "--out", str(out), "--set", "n_layers=2"]
    try:
        dryrun.main()
    finally:
        sys.argv = argv
    lines = out.read_text().splitlines()
    assert len(lines) == 2 and all('"ok": true' in line for line in lines)
    assert capsys.readouterr().out.count('"arch": "whisper-base"') == 2


def test_apply_overrides_types_fields():
    cfg = dryrun._apply_overrides(get_config("llama3.2-1b"),
                                  {"remat": "false", "n_layers": "4", "rope_theta": "1e4"})
    assert (cfg.remat, cfg.n_layers, cfg.rope_theta) == (False, 4, 1e4)
    with pytest.raises(ValueError, match="dense family"):
        dryrun.dense_count(get_config("mamba2-1.3b"), "prefill_32k")
