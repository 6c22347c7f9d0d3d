"""Nemotron-H as released (``repro_torch.models.nemotron_h``) and its dropless MoE layer
(``repro_torch.models.moe_dropless``) on the CPU.

* the configuration: the release's pattern (23 Mamba, 23 MoE, 6 attention
  layers at 5, 12, 19, 26, 33 and 42), d_inner the Mamba heads times their
  dim (4096, not expand x d_model), the configuration file's widths against
  the port-only configuration;
* the port against the plain float32 reference ``h100bench/reference/nemotron_h.py``
  at a tiny size on seeded random weights: the prefill's last logits (the
  reference on the program's routes: float32 within 1e-5 of max|ref|, bf16
  within 5e-2) and, in float32, the reference's own routes equal to the
  program's; each layer kind's addend; the MoE layer on its plain route;
* the router by hand (sigmoid scores, the bias in the selection only, the
  weights normalised and scaled);
* the grouped route (``torch._grouped_mm`` runs on the CPU too; the route
  rule narrowed to ``meta``) equal to the plain route bit for bit, the same
  bits on a second call, no value read back to the host, and dropless under
  a bias that sends every token to the same experts;
* planted faults the float32 comparison fails by far; the spans and
  counters over a prefill; the entry points the family lacks refuse.

No JAX here.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from h100bench import nemotron_faults  # noqa: E402
from h100bench.harness import load_module, read_json  # noqa: E402
from h100bench.reference import nemotron_h as ref  # noqa: E402
from repro_torch.configs.port_only import PORT_ARCHS, get_port_config  # noqa: E402
from repro_torch.models import moe_dropless, nemotron_h  # noqa: E402
from repro_torch.models.common import embed  # noqa: E402
from repro_torch.models.model_api import build_model  # noqa: E402

ARCH = "nemotron-3-nano-30b-a3b"
F32_TOL = 1e-5  # port vs reference, float32: the same arithmetic, other orders of sums
BF16_TOL = 5e-2  # port in bf16 vs the float32 reference, through eight layers
FAULT_MIN = 20 * F32_TOL  # a planted fault reads at least this far from the reference

TINY = dict(n_layers=8, layer_pattern="ME*MEM*E", d_model=64, n_heads=8, n_kv_heads=2,
            head_dim=16, vocab_size=96, mamba_num_heads=8, ssm_headdim=8, ssm_state=16,
            ssm_ngroups=4, ssm_chunk=16, n_experts=8, experts_per_token=3, moe_d_ff=32,
            moe_shared_d_ff=48, attn_q_chunk=16, attn_k_chunk=32)
L = 32


def tiny_cfg(dtype="float32", **over):
    return dataclasses.replace(get_port_config(ARCH), dtype=dtype, **dict(TINY, **over))


def widths_of(cfg):
    """The reference's widths dict of a config, as a configuration file gives them."""
    keys = ("d_model", "vocab_size", "n_heads", "n_kv_heads", "head_dim", "layer_pattern",
            "mamba_num_heads", "ssm_headdim", "ssm_state", "ssm_ngroups", "ssm_conv_width",
            "ssm_chunk", "n_experts", "experts_per_token", "moe_d_ff", "moe_shared_d_ff",
            "routed_scaling_factor", "norm_eps")
    return dict({k: getattr(cfg, k) for k in keys}, family=cfg.family, dtype=cfg.dtype)


def setup(dtype="float32", seed=0, **over):
    cfg = tiny_cfg(dtype, **over)
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(seed))
    tokens = torch.randint(0, cfg.vocab_size, (2, L), generator=torch.Generator().manual_seed(1))
    return cfg, model, params, tokens


def rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


# ----------------------------------------------------------- configuration --

def test_pattern_and_d_inner_are_the_releases():
    cfg = get_port_config(ARCH)
    kinds = nemotron_h.layer_kinds(cfg)
    assert (kinds.count("mamba"), kinds.count("moe"), kinds.count("attn")) == (23, 23, 6)
    assert [l for l, k in enumerate(kinds) if k == "attn"] == [5, 12, 19, 26, 33, 42]
    assert (cfg.d_inner, cfg.ssm_nheads) == (4096, 64)
    assert cfg.d_inner != cfg.ssm_expand * cfg.d_model
    assert ARCH in PORT_ARCHS
    nemotron_h.check_config(cfg)


@pytest.mark.parametrize("over,match", [
    (dict(layer_pattern="ME-*"), "kinds"),
    (dict(layer_pattern="MEM"), "the pattern has 3 layers"),
    (dict(ssm_ngroups=3), "Mamba heads"),
    (dict(tie_embeddings=True), "untied"),
    (dict(d_ff=1856), "no dense MLP"),
])
def test_check_config_refuses(over, match):
    with pytest.raises(ValueError, match=match):
        nemotron_h.check_config(tiny_cfg(**dict(dict(n_layers=4, layer_pattern="ME*E"), **over)))


def test_configuration_file_is_the_port_only_configuration():
    spec = read_json(REPO / "h100bench" / "configs" / f"{ARCH}.json")
    drv = load_module(REPO / "h100bench" / "drivers" / "hybrid_prefill.py", "test_hybrid_driver")
    assert drv.model_config(spec) == get_port_config(ARCH)
    assert spec["reduced"] == [] and spec["hybrid_override_pattern"] == spec["widths"][
        "layer_pattern"]


# -------------------------------------------------------- against the reference --

@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_port_prefill_matches_the_reference(dtype, tol):
    """The reference follows the program's routes; in float32 its own are the same."""
    cfg, _, params, tokens = setup(dtype)
    routes = []
    with torch.no_grad():
        got = nemotron_h.nemotron_h_prefill(cfg, params, tokens, routes)
    stats = {}
    want = ref.prefill_logits(widths_of(cfg), params, tokens, routes=routes, stats=stats)
    assert rel(got, want) < tol
    assert len(routes) == cfg.layer_pattern.count("E")
    if dtype == "float32":
        assert stats["differ"] == 0 and stats["routes"] == len(routes) * tokens.numel()


def test_model_prefill_is_the_family_prefill():
    cfg, model, params, tokens = setup()
    assert torch.equal(model.prefill(params, {"tokens": tokens}),
                       nemotron_h.nemotron_h_prefill(cfg, params, tokens))


@pytest.mark.parametrize("kind", ["mamba", "attn", "moe"])
def test_each_layer_kind_matches_the_reference(kind):
    """A layer's addend (output less input) in float32, the reference routing for itself."""
    cfg, _, params, _ = setup()
    l = nemotron_h.layer_kinds(cfg).index(kind)
    p = nemotron_h.layers(cfg, params)[l][1]
    h = torch.randn(2, L, cfg.d_model, generator=torch.Generator().manual_seed(2))
    got = nemotron_h.layer_apply(cfg, p, kind, h)
    want = ref.layer_apply(widths_of(cfg), kind, p, h)
    assert rel(got - h, want - h) < F32_TOL


def test_moe_plain_route_matches_the_reference_mixer():
    cfg, _, params, _ = setup()
    p = nemotron_h.layers(cfg, params)[1][1]
    x = torch.randn(2, L, cfg.d_model, generator=torch.Generator().manual_seed(3))
    assert rel(moe_dropless.moe_apply(cfg, p, x), ref.moe_mixer(widths_of(cfg), p, x, "f32")) \
        < F32_TOL


def test_router_by_hand():
    cfg, _, params, _ = setup()
    p = nemotron_h.layers(cfg, params)[1][1]
    x = torch.randn(5, cfg.d_model, generator=torch.Generator().manual_seed(4))
    ids, w = moe_dropless.route(cfg, p, x)
    s = torch.sigmoid(x @ p["router"]["w"])
    for t in range(5):
        biased = (s[t] + p["e_bias"]).tolist()
        pick = sorted(range(cfg.n_experts), key=lambda e: -biased[e])[:cfg.experts_per_token]
        assert sorted(ids[t].tolist()) == sorted(pick)
        chosen = s[t, ids[t]]
        assert torch.allclose(w[t], chosen / chosen.sum() * 2.5, rtol=1e-6)
    assert torch.allclose(w.sum(-1), torch.full((5,), 2.5), rtol=1e-6)


# ------------------------------------------------------------ the grouped route --

@pytest.fixture
def grouped_on_cpu(monkeypatch):
    """The route rule narrowed to ``meta``, so that a bf16 CPU tensor takes
    the grouped route (``torch._grouped_mm`` has a CPU version)."""
    monkeypatch.setattr(moe_dropless, "PLAIN_DEVICES", ("meta",))


def _moe_inputs(seed=5, T=2 * L):
    cfg, _, params, _ = setup("bfloat16")
    p = nemotron_h.layers(cfg, params)[1][1]
    x = torch.randn(T, cfg.d_model, generator=torch.Generator().manual_seed(seed)).bfloat16()
    return cfg, p, x


def test_grouped_route_is_the_plain_route_bit_for_bit(grouped_on_cpu):
    cfg, p, x = _moe_inputs()
    ids, _ = moe_dropless.route(cfg, p, x)
    assert moe_dropless.grouped(x, p)
    assert torch.equal(moe_dropless.experts_grouped(p, x, ids),
                       moe_dropless.experts_plain(p, x, ids))


def test_moe_layer_takes_the_grouped_route_and_gives_the_same_bits_twice(grouped_on_cpu,
                                                                        monkeypatch):
    cfg, p, x = _moe_inputs()
    taken = []
    grouped = moe_dropless.experts_grouped
    monkeypatch.setattr(moe_dropless, "experts_grouped",
                        lambda *a: taken.append(1) or grouped(*a))
    a = moe_dropless.moe_apply(cfg, p, x[None])
    b = moe_dropless.moe_apply(cfg, p, x[None])
    assert taken == [1, 1] and torch.equal(a, b)


def test_grouped_route_reads_nothing_back_to_the_host(grouped_on_cpu, monkeypatch):
    """No ``item``, ``tolist``, truth value or ``nonzero`` between the router
    and the combine: on the card each would wait for the device."""
    cfg, p, x = _moe_inputs()

    def refuse(*a, **k):
        raise AssertionError("a value read back to the host")

    for name in ("item", "tolist", "__bool__", "nonzero", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "nonzero", refuse)
    ids, w = moe_dropless.route(cfg, p, x)
    moe_dropless.combine(moe_dropless.experts_grouped(p, x, ids), w)


@pytest.mark.parametrize("route", ["grouped", "plain"])
def test_dropless_when_every_token_picks_the_same_experts(route, monkeypatch):
    """A correction bias that sends every token to experts 2..4: every route
    is computed (``routed_rows`` rises by T k), and the layer is the
    reference's, which drops nothing."""
    if route == "grouped":
        monkeypatch.setattr(moe_dropless, "PLAIN_DEVICES", ("meta",))
    cfg, p, x = _moe_inputs(T=64)
    bias = torch.zeros_like(p["e_bias"])
    bias[2:5] = 10.0
    p = dict(p, e_bias=bias)
    ids, _ = moe_dropless.route(cfg, p, x)
    assert sorted(set(ids.reshape(-1).tolist())) == [2, 3, 4]
    rows = moe_dropless.routed_rows
    got = moe_dropless.moe_apply(cfg, p, x[None])
    assert moe_dropless.routed_rows - rows == 64 * cfg.experts_per_token
    want = ref.moe_mixer(widths_of(cfg), p, x[None].float(), "f32")
    assert rel(got, want) < BF16_TOL


# -------------------------------------------------------------------- faults --

@pytest.mark.parametrize("fault", nemotron_faults.EVERY_ROUTE)
def test_planted_faults_fail_the_comparison(fault):
    """Each fault planted above the route moves some layer's addend far from
    the reference (routing for itself) in float32, on the program's own
    layer inputs."""
    cfg, _, params, tokens = setup()
    worst = 0.0
    with nemotron_faults.planted(fault, cfg.layer_pattern.count("M")), torch.no_grad():
        h = embed(params["embed"], tokens)
        for kind, p in nemotron_h.layers(cfg, params):
            got = nemotron_h.layer_apply(cfg, p, kind, h)
            want = ref.layer_apply(widths_of(cfg), kind, p, h)
            worst = max(worst, rel(got - h, want - h))
            h = got
    assert worst > FAULT_MIN


# ------------------------------------------------------------ spans, counters --

def test_prefill_records_its_spans_and_counts_its_moe_layers():
    cfg, model, params, tokens = setup()
    n_moe = cfg.layer_pattern.count("E")
    calls, rows = moe_dropless.calls, moe_dropless.routed_rows
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model.prefill(params, {"tokens": tokens})
    names = [e.name for e in prof.events()]
    for name in ("nemotron_h.moe", "moe.router", "moe.experts", "moe.shared_expert"):
        assert names.count(name) == n_moe, name
    assert names.count("flash_attention") == cfg.layer_pattern.count("*")
    assert names.count("mamba.block") == cfg.layer_pattern.count("M")
    assert moe_dropless.calls - calls == n_moe
    assert moe_dropless.routed_rows - rows == n_moe * tokens.numel() * cfg.experts_per_token


@pytest.mark.parametrize("entry", ["loss", "init_cache", "decode_step", "param_specs",
                                   "cache_specs"])
def test_loss_decode_and_specs_refuse_saying_why(entry):
    model = build_model(tiny_cfg(), "cpu")
    args = {"loss": ({}, {}), "init_cache": (1, 8), "decode_step": ({}, None, {}, 0),
            "param_specs": (), "cache_specs": ()}[entry]
    with pytest.raises(NotImplementedError, match="nemotron_h has no"):
        getattr(model, entry)(*args)


def test_relu2_and_nope():
    """relu² is relu squared; attention reads no position: the last row's
    output is the same over its keys in any order (rotary would move it)."""
    u = torch.tensor([-2.0, -0.5, 0.0, 0.5, 3.0])
    assert torch.equal(moe_dropless.relu2(u), F.relu(u) ** 2)
    cfg, _, params, _ = setup()
    p = nemotron_h.layers(cfg, params)[2][1]
    h = torch.randn(1, L, cfg.d_model, generator=torch.Generator().manual_seed(6))
    perm = torch.cat([torch.randperm(L - 1, generator=torch.Generator().manual_seed(7)),
                      torch.tensor([L - 1])])
    last = nemotron_h.attention_apply(cfg, p, h)[0, -1]
    assert torch.allclose(nemotron_h.attention_apply(cfg, p, h[:, perm])[0, -1], last,
                          atol=1e-5)


def test_only_bf16_off_the_plain_devices_takes_the_grouped_route(grouped_on_cpu):
    cfg, p, x = _moe_inputs()
    assert moe_dropless.grouped(x, p)
    assert not moe_dropless.grouped(x.float(), p)
    assert not moe_dropless.grouped(x.to("meta"), p)
    leaf = p["w_up"].clone().requires_grad_(True)
    assert not moe_dropless.grouped(x, dict(p, w_up=leaf))
