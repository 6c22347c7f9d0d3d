"""DeepSeek-V3 as released (``repro_torch.models.deepseek_v3``), its expert-parallel
MoE layer (``repro_torch.models.moe_dropless``) and latent attention's split heads on the CPU.

* the configuration: the release's widths, the refusals, the configuration
  file's cut (31 layers, 8 of 256 experts held) against the port-only
  configuration;
* the port against the plain float32 reference ``h100bench/reference/deepseek_v3.py``
  at a tiny size on seeded random weights (2 dense + 2 MoE layers, 32
  experts in 4 groups, top 2 groups, top 4): the prefill's last logits (the
  reference on the program's routes: float32 within 1e-5 of max|ref|, bf16
  within 5e-2; in float32 the reference's own routes are the program's);
* the expert share: at 4 shares of 8 experts, the shares' MoE outputs, the
  shared expert counted once, add up to the uncut reference layer; the
  held routes counted on the device;
* group-limited selection against the release's formula written out here,
  with a case where the best single expert lies in a group not chosen;
* YaRN's inverse frequencies, mscale and the softmax scale at V3's own
  numbers against the release's formulas written out here; the interleaved
  rope against the release's layout;
* the plain ``_flash_attention`` with v narrower than q and k against naive
  attention, causal and not;
* the grouped route on a held share equal to the plain route bit for bit,
  with nothing read back to the host;
* planted faults the float32 comparison fails by far; the spans and
  counters over a prefill; the entry points the family lacks refuse.

No JAX here.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from h100bench import deepseek_faults  # noqa: E402
from h100bench.harness import load_module, read_json  # noqa: E402
from h100bench.reference import deepseek_v3 as ref  # noqa: E402
from repro_torch.configs.port_only import PORT_ARCHS, get_port_config  # noqa: E402
from repro_torch.models import common, deepseek_v3, moe_dropless  # noqa: E402
from repro_torch.models.common import embed  # noqa: E402
from repro_torch.models.model_api import build_model  # noqa: E402

ARCH = "deepseek-v3"
F32_TOL = 1e-5  # port vs reference, float32: the same arithmetic, other orders of sums
BF16_TOL = 5e-2  # port in bf16 vs the float32 reference, through four layers
FAULT_MIN = 20 * F32_TOL  # a planted fault reads at least this far from the reference

TINY = dict(n_layers=4, first_k_dense=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=24,
            qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, q_lora_rank=32, kv_lora_rank=16,
            d_ff=96, vocab_size=96, n_experts=32, n_experts_held=32, experts_per_token=4,
            n_group=4, topk_group=2, moe_d_ff=32, moe_shared_d_ff=48, attn_q_chunk=16,
            attn_k_chunk=32, rope_original_max=64)
#: the widths the reference reads, as the configuration file names them
KEYS = ("n_layers", "first_k_dense", "d_model", "vocab_size", "n_heads", "q_lora_rank",
        "kv_lora_rank", "qk_nope_dim", "qk_rope_dim", "v_head_dim", "d_ff", "n_experts",
        "n_experts_held", "expert_offset", "experts_per_token", "moe_d_ff", "moe_shared_d_ff",
        "n_group", "topk_group", "routed_scaling_factor", "norm_eps", "rope_theta",
        "rope_factor", "rope_original_max", "rope_beta_fast", "rope_beta_slow", "rope_mscale",
        "rope_mscale_all_dim")
L = 40


def tiny_cfg(dtype="float32", **over):
    return dataclasses.replace(get_port_config(ARCH), dtype=dtype, **dict(TINY, **over))


def widths_of(cfg):
    return dict({k: getattr(cfg, k) for k in KEYS}, family=cfg.family, dtype=cfg.dtype)


def setup(dtype="float32", seed=0, **over):
    cfg = tiny_cfg(dtype, **over)
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(seed))
    tokens = torch.randint(0, cfg.vocab_size, (2, L), generator=torch.Generator().manual_seed(1))
    return cfg, model, params, tokens


def rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def moe_params(cfg, params, i=0):
    return deepseek_v3._layer(params["moe"], i)


# ----------------------------------------------------------- configuration --

def test_configuration_is_the_releases():
    cfg = get_port_config(ARCH)
    deepseek_v3.check_config(cfg)
    assert ARCH in PORT_ARCHS
    assert (cfg.n_layers, cfg.first_k_dense, cfg.d_model, cfg.n_heads, cfg.head_dim,
            cfg.v_head_dim, cfg.q_lora_rank, cfg.kv_lora_rank) == (61, 3, 7168, 128, 192, 128,
                                                                   1536, 512)
    assert (cfg.n_experts, cfg.n_experts_held, cfg.experts_per_token, cfg.n_group,
            cfg.topk_group, cfg.moe_d_ff, cfg.moe_shared_d_ff, cfg.d_ff) == (
        256, 256, 8, 8, 4, 2048, 2048, 18432)


@pytest.mark.parametrize("over,match", [
    (dict(head_dim=32), "qk_nope_dim"),
    (dict(n_kv_heads=2), "own k and v"),
    (dict(n_group=3), "groups of at least two"),
    (dict(topk_group=5), "groups"),
    (dict(experts_per_token=20), "kept groups"),
    (dict(expert_offset=30, n_experts_held=8), "held"),
    (dict(tie_embeddings=True), "untied"),
])
def test_check_config_refuses(over, match):
    with pytest.raises(ValueError, match=match):
        deepseek_v3.check_config(tiny_cfg(**over))


def test_configuration_file_cuts_layers_and_held_experts_only():
    """The file holds the catalog's config.json with ``num_hidden_layers`` and
    ``n_routed_experts`` cut (listed in ``reduced``); the driver's widths
    check gives the port-only configuration with 31 layers and 8 experts
    held, and refuses a width that differs without a cut."""
    spec = read_json(REPO / "h100bench" / "configs" / f"{ARCH}.json")
    drv = load_module(REPO / "h100bench" / "drivers" / "deepseek_prefill.py", "test_ds_driver")
    cfg = drv.model_config(spec)
    assert cfg == dataclasses.replace(get_port_config(ARCH), n_layers=31, n_experts_held=8)
    assert spec["reduced"] == ["n_routed_experts", "num_hidden_layers"]
    assert (spec["num_hidden_layers"], spec["n_routed_experts"]) == (31, 8)
    assert spec["published"] == {"n_routed_experts": 256, "num_hidden_layers": 61}
    assert set(spec["assumed"]) >= {"weights", "e_score_correction_bias", "redundant_experts",
                                    "attention", "mtp"}
    with pytest.raises(ValueError, match="n_group"):
        drv.model_config(dict(spec, widths=dict(spec["widths"], n_group=4)))


# -------------------------------------------------------- against the reference --

@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_port_prefill_matches_the_reference(dtype, tol):
    """The reference follows the program's routes; in float32 its own are the same."""
    cfg, _, params, tokens = setup(dtype)
    routes = []
    with torch.no_grad():
        got = deepseek_v3.deepseek_v3_prefill(cfg, params, tokens, routes)
    stats = {}
    want = ref.prefill_logits(widths_of(cfg), params, tokens, routes=routes, stats=stats)
    assert rel(got, want) < tol
    assert len(routes) == cfg.n_layers - cfg.first_k_dense
    if dtype == "float32":
        assert stats["differ"] == 0 and stats["routes"] == len(routes) * tokens.numel()


def test_model_prefill_is_the_family_prefill():
    cfg, model, params, tokens = setup()
    assert torch.equal(model.prefill(params, {"tokens": tokens}),
                       deepseek_v3.deepseek_v3_prefill(cfg, params, tokens))


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_each_layer_kind_matches_the_reference(kind):
    """A layer's addend (output less input) in float32, the reference routing for itself."""
    cfg, _, params, _ = setup()
    l = cfg.first_k_dense if kind == "moe" else 0
    k, pa, pf = list(deepseek_v3.layers(cfg, params))[l]
    assert k == kind
    h = torch.randn(2, L, cfg.d_model, generator=torch.Generator().manual_seed(2))
    got = deepseek_v3.layer_apply(cfg, kind, pa, pf, h)
    want = ref.layer_apply(widths_of(cfg), kind, pa, pf, h)
    assert rel(got - h, want - h) < F32_TOL


# ------------------------------------------------------------ the expert share --

def _share(cfg, p, s, n):
    """Share ``s`` of ``n`` experts: the config and the weights it holds."""
    sl = slice(s * n, (s + 1) * n)
    return (dataclasses.replace(cfg, expert_offset=s * n, n_experts_held=n),
            dict(p, w_gate_up=p["w_gate_up"][sl], w_down=p["w_down"][sl]))


@pytest.mark.parametrize("route", ["plain", "grouped"])
def test_expert_shares_add_up_to_the_uncut_layer(route, monkeypatch):
    """At 4 shares of 8 of the 32 experts, each share's MoE output (its held
    experts' part and the shared expert), the shared expert counted once,
    adds up to the uncut reference layer; the held routes each share counts
    on the device add up to T k."""
    if route == "grouped":  # a bf16 CPU tensor takes the grouped route
        monkeypatch.setattr(moe_dropless, "PLAIN_DEVICES", ("meta",))
    dtype = "bfloat16" if route == "grouped" else "float32"
    cfg, _, params, _ = setup(dtype)
    p = moe_params(cfg, params)
    x = torch.randn(1, L, cfg.d_model, generator=torch.Generator().manual_seed(3))
    x = x.to(common.dtype_of(dtype))
    shared = moe_dropless.shared_expert(p, x[0]).float()
    total, counted = -3 * shared, 0
    for s in range(4):
        scfg, sp = _share(cfg, p, s, 8)
        before = moe_dropless.held_count("cpu")
        total = total + moe_dropless.moe_apply(scfg, sp, x)[0].float()
        counted += moe_dropless.held_count(torch.device("cpu")) - before
    want = ref.moe(widths_of(cfg), p, x.float(), "f32")[0]
    assert rel(total, want) < (F32_TOL if route == "plain" else BF16_TOL)
    assert counted == L * cfg.experts_per_token


def test_the_held_count_is_read_under_the_devices_full_name(monkeypatch):
    """``moe_apply`` stores its count under the name its tensor's device
    reports, and ``held_count`` reads it whatever form the device is given in
    (a name or a ``torch.device``): on a card, ``cuda`` reads what was
    stored under ``cuda:0``; a device with nothing counted reads 0."""
    for d in ("cpu", torch.device("cpu"), "meta", torch.device("meta")):
        assert moe_dropless.device_key(d) == str(torch.empty(0, device=d).device)
    monkeypatch.setattr(moe_dropless, "held_rows", {"cpu": torch.tensor(5)})
    assert moe_dropless.held_count("cpu") == moe_dropless.held_count(torch.device("cpu")) == 5
    assert moe_dropless.held_count("meta") == 0


def test_a_share_computes_only_its_own_experts_part():
    """One share of 8 against the reference given the same share: the held
    experts' part and the shared expert, nothing of the other 24."""
    cfg, _, params, _ = setup()
    scfg, sp = _share(cfg, moe_params(cfg, params), 2, 8)
    x = torch.randn(1, L, cfg.d_model, generator=torch.Generator().manual_seed(4))
    got = moe_dropless.moe_apply(scfg, sp, x)
    want = ref.moe(widths_of(scfg), sp, x, "f32")
    assert rel(got, want) < F32_TOL
    assert rel(got, ref.moe(widths_of(cfg), moe_params(cfg, params), x, "f32")) > 0.1


# ------------------------------------------------------------------- routing --

def release_noaux_tc(scores, bias, n_group, topk_group, top_k):
    """``MoEGate.forward``'s ``noaux_tc`` selection of the release, written out."""
    n = scores.shape[0]
    scores_for_choice = scores.view(n, -1) + bias.unsqueeze(0)
    group_scores = scores_for_choice.view(n, n_group, -1).topk(2, dim=-1)[0].sum(dim=-1)
    group_idx = torch.topk(group_scores, k=topk_group, dim=-1, sorted=False)[1]
    group_mask = torch.zeros_like(group_scores)
    group_mask.scatter_(1, group_idx, 1)
    score_mask = group_mask.unsqueeze(-1).expand(n, n_group, scores.shape[1] // n_group)
    tmp_scores = scores_for_choice.masked_fill(~score_mask.reshape(n, -1).bool(), 0.0)
    _, topk_idx = torch.topk(tmp_scores, k=top_k, dim=-1, sorted=False)
    topk_weight = scores.gather(1, topk_idx)
    return topk_idx, topk_weight / (topk_weight.sum(dim=-1, keepdim=True) + 1e-20)


def test_group_limited_selection_is_the_releases_formula():
    cfg, _, params, _ = setup()
    p = moe_params(cfg, params)
    x = torch.randn(64, cfg.d_model, generator=torch.Generator().manual_seed(5))
    ids, w = moe_dropless.route(cfg, p, x)
    scores = torch.sigmoid(x @ p["router"]["w"])
    want_ids, want_w = release_noaux_tc(scores, p["e_bias"], cfg.n_group, cfg.topk_group,
                                        cfg.experts_per_token)
    assert torch.equal(ids.sort(-1).values, want_ids.sort(-1).values)
    order = lambda i: i.argsort(-1)  # noqa: E731
    assert torch.allclose(w.gather(1, order(ids)), 2.5 * want_w.gather(1, order(want_ids)),
                          rtol=1e-6)


def test_the_best_single_expert_can_lie_in_a_group_not_chosen():
    """Group 0 holds the best expert (0.99) beside weak ones; groups 1 and 2
    hold two good experts each, so their top-2 sums beat group 0's: the top
    2 groups are 1 and 2, and expert 0 is not chosen, as the release's
    formula says; with no group limit it would be."""
    cfg = tiny_cfg(n_experts=16, n_experts_held=16, n_group=4, topk_group=2,
                   experts_per_token=2, d_model=16)
    s = torch.full((1, 16), 0.1)
    s[0, 0] = 0.99
    s[0, 4:6] = torch.tensor([0.7, 0.6])
    s[0, 8:10] = torch.tensor([0.65, 0.62])
    bias = torch.zeros(16)
    logit = torch.logit(s)
    p = {"router": {"w": torch.eye(16)}, "e_bias": bias}
    ids, _ = moe_dropless.route(cfg, p, logit)
    want, _ = release_noaux_tc(s, bias, 4, 2, 2)
    assert sorted(ids[0].tolist()) == sorted(want[0].tolist()) == [4, 8]
    assert 0 not in ids[0].tolist()
    free, _ = moe_dropless.route(dataclasses.replace(cfg, n_group=1, topk_group=1), p, logit)
    assert 0 in free[0].tolist()
    assert torch.equal(moe_dropless.group_limited(s, 1, 1), s)


# --------------------------------------------------------------------- rope --

def test_yarn_frequencies_mscale_and_softmax_scale_at_v3s_numbers():
    """dim 64, base 10000, factor 40 over 4096, beta 32 / 1, mscale 1: the
    release's ``_set_cos_sin_cache`` frequencies written out, its
    correction range (10, 23), and the scale 192^-1/2 (0.1 ln 40 + 1)^2."""
    dim, base, factor, orig = 64, 10000.0, 40.0, 4096
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    freq_inter = 1.0 / (factor * base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))

    def corr(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))) / (2 * math.log(base))

    low, high = max(math.floor(corr(32)), 0), min(math.ceil(corr(1)), dim - 1)
    assert (low, high) == (10, 23)
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    inv_freq_mask = 1.0 - ramp
    want = freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask
    got = common.yarn_rope_freqs(dim, base, factor, orig, 32.0, 1.0, torch.device("cpu"))
    assert torch.equal(got, want)
    assert torch.equal(got[:low], freq_extra[:low]) and torch.equal(got[high:], freq_inter[high:])
    m = 0.1 * math.log(40) + 1.0
    assert common.yarn_mscale(40.0, 1.0) == pytest.approx(m, rel=1e-15)
    assert common.yarn_mscale(1.0, 1.0) == 1.0
    cfg = get_port_config(ARCH)
    assert deepseek_v3.softmax_scale(cfg) == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    assert deepseek_v3.softmax_scale(cfg) == pytest.approx(0.13523, rel=1e-4)
    cos, sin = deepseek_v3.rope_tables(cfg, 5, torch.device("cpu"))
    ang = torch.arange(5, dtype=torch.float32)[:, None] * want
    assert torch.equal(cos, torch.cos(ang)) and torch.equal(sin, torch.sin(ang))


def test_interleaved_rope_is_the_releases_layout():
    """The port's rope against ``apply_rotary_pos_emb`` of the release (as
    the reference writes it): the pairs taken apart, then rotated; the dot
    product of a rotated q and k depends on their positions' difference."""
    cfg = get_port_config(ARCH)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(1, 9, 3, 64, generator=g)
    cos, sin = deepseek_v3.rope_tables(cfg, 9, torch.device("cpu"))
    w = {"qk_rope_dim": 64, "rope_theta": 1e4, "rope_factor": 40.0, "rope_original_max": 4096,
         "rope_beta_fast": 32.0, "rope_beta_slow": 1.0, "rope_mscale": 1.0,
         "rope_mscale_all_dim": 1.0}
    c2, s2 = ref.yarn_cos_sin(w, 9, torch.device("cpu"))
    assert torch.allclose(deepseek_v3.rope_interleaved(x, cos, sin),
                          ref.apply_rotary_pos_emb(x, c2, s2), atol=1e-6)
    q, k = torch.randn(64, generator=g), torch.randn(64, generator=g)
    big = deepseek_v3.rope_tables(cfg, 40, torch.device("cpu"))
    rot = lambda v, i: deepseek_v3.rope_interleaved(  # noqa: E731
        v.expand(1, 40, 1, 64), *big)[0, i, 0]
    assert float(rot(q, 30) @ rot(k, 27)) == pytest.approx(float(rot(q, 13) @ rot(k, 10)),
                                                           rel=1e-4)


# --------------------------------------------------- split heads, plain route --

@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_attention_takes_v_narrower_than_q_and_k(causal):
    """q and k of 24, v of 16, lengths not multiples of the chunks, against
    softmax(q k^T scale) v written out."""
    g = torch.Generator().manual_seed(7)
    B, Lq, H, Dqk, Dv = 2, 37, 3, 24, 16
    q, k = torch.randn(B, Lq, H, Dqk, generator=g), torch.randn(B, Lq, H, Dqk, generator=g)
    v = torch.randn(B, Lq, H, Dv, generator=g)
    got = common.flash_attention(q, k, v, causal=causal, q_chunk=8, k_chunk=16, scale=0.3)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.3
    if causal:
        s = s.masked_fill(~torch.ones(Lq, Lq, dtype=torch.bool).tril(), -torch.inf)
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    assert got.shape == (B, Lq, H, Dv)
    assert torch.allclose(got, want, atol=1e-5)


# ------------------------------------------------------------ the grouped route --

@pytest.fixture
def grouped_on_cpu(monkeypatch):
    monkeypatch.setattr(moe_dropless, "PLAIN_DEVICES", ("meta",))


def _share_inputs(first=8, n=8, T=2 * L, seed=8):
    cfg, _, params, _ = setup("bfloat16")
    scfg, sp = _share(cfg, moe_params(cfg, params), first // n, n)
    x = torch.randn(T, cfg.d_model, generator=torch.Generator().manual_seed(seed)).bfloat16()
    return scfg, sp, x


def test_grouped_route_on_a_share_is_the_plain_route_bit_for_bit(grouped_on_cpu):
    """8 of 32 experts held, SwiGLU: the routes to other experts give zero
    rows on both routes, and the held ones the same bits."""
    cfg, p, x = _share_inputs()
    ids, _ = moe_dropless.route(cfg, p, x)
    held = (ids >= 8) & (ids < 16)
    assert held.any() and not held.all()
    assert moe_dropless.grouped(x, p) and not moe_dropless.holds_all(p)
    got = moe_dropless.experts_grouped(p, x, ids, 8)
    assert torch.equal(got, moe_dropless.experts_plain(p, x, ids, 8))
    assert not got[~held].any() and got[held].abs().amax(-1).gt(0).all()


def test_grouped_route_on_a_share_reads_nothing_back_to_the_host(grouped_on_cpu, monkeypatch):
    cfg, p, x = _share_inputs()

    def refuse(*a, **k):
        raise AssertionError("a value read back to the host")

    for name in ("item", "tolist", "__bool__", "nonzero", "cpu", "numpy", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "nonzero", refuse)
    moe_dropless.moe_apply(cfg, p, x[None])


# -------------------------------------------------------------------- faults --

@pytest.mark.parametrize("fault", deepseek_faults.EVERY_ROUTE)
def test_planted_faults_fail_the_comparison(fault):
    """Each fault planted above the route moves some layer's addend far from
    the reference (routing for itself) in float32, on the program's own
    layer inputs; on a share of 16 experts from 8, so that a shifted held
    range shows."""
    cfg, _, params, tokens = setup(n_experts_held=16)
    cfg = dataclasses.replace(cfg, expert_offset=8)
    worst = 0.0
    with deepseek_faults.planted(fault), torch.no_grad():
        h = embed(params["embed"], tokens)
        for kind, pa, pf in deepseek_v3.layers(cfg, params):
            got = deepseek_v3.layer_apply(cfg, kind, pa, pf, h)
            want = ref.layer_apply(widths_of(cfg), kind, pa, pf, h)
            worst = max(worst, rel(got - h, want - h))
            h = got
    assert worst > FAULT_MIN


# ------------------------------------------------------------ spans, counters --

def test_prefill_records_its_spans_and_counts_its_layers():
    cfg, model, params, tokens = setup()
    n_moe = cfg.n_layers - cfg.first_k_dense
    mla, calls = deepseek_v3.mla.calls, moe_dropless.calls
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model.prefill(params, {"tokens": tokens})
    names = [e.name for e in prof.events()]
    for name, n in (("mla.attention", cfg.n_layers), ("mla.q_proj", cfg.n_layers),
                    ("mla.kv_proj", cfg.n_layers), ("flash_attention", cfg.n_layers),
                    ("deepseek.dense_mlp", cfg.first_k_dense), ("deepseek.moe", n_moe),
                    ("moe.router", n_moe), ("moe.experts", n_moe),
                    ("moe.shared_expert", n_moe)):
        assert names.count(name) == n, name
    assert deepseek_v3.mla.calls - mla == cfg.n_layers
    assert moe_dropless.calls - calls == n_moe


@pytest.mark.parametrize("entry", ["loss", "init_cache", "decode_step", "param_specs",
                                   "cache_specs"])
def test_loss_decode_and_specs_refuse_saying_why(entry):
    model = build_model(tiny_cfg(), "cpu")
    args = {"loss": ({}, {}), "init_cache": (1, 8), "decode_step": ({}, None, {}, 0),
            "param_specs": (), "cache_specs": ()}[entry]
    with pytest.raises(NotImplementedError, match="deepseek_v3 has no"):
        getattr(model, entry)(*args)


def test_swiglu_is_silu_of_the_gate_times_the_up_half():
    u = torch.randn(3, 8, generator=torch.Generator().manual_seed(9))
    assert torch.equal(moe_dropless.swiglu(u), F.silu(u[:, :4]) * u[:, 4:])
