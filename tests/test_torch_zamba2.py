"""Zamba2 as released (``repro_torch.models.zamba2``) and grouped B/C on the CPU.

* the plain float32 reference ``h100bench/reference/zamba2.py`` against
  transformers' ``Zamba2ForCausalLM`` (a tiny ``Zamba2Config`` with two
  shared blocks, four hybrid sites, two B/C groups, MLP adapters and rope;
  the same weights copied in), last logits within 1e-4 of their max
  (float32 on both sides, sums in other orders); skipped only where
  transformers does not import;
* the port's ``Model.prefill`` against the reference at a tiny size: float32
  within 1e-5 of max|ref| (the same float32 arithmetic in another order of
  sums), bf16 within 5e-2 (bf16 weights and activations through seven
  layers, against float32 throughout);
* the layer pattern of ``configs.zamba2_7b`` against the release's
  ``layers_block_type`` (the configuration file holds the catalog's
  config.json), and each site's block and adapter;
* planted faults that the float32 comparison fails by far: the adapter of
  the next site, attention scaled by 1/sqrt(Dh), B and C collapsed to one
  group, the out-norm over the whole d_inner, the addend t put into the
  residual;
* the grouped SSD functions: ``ssd_chunked`` in G groups against
  ``ssd_naive`` of each head with its group's B and C; one group through
  the grouped route equal bit for bit to the shared-B/C route, in the scan
  and in a whole Mamba block; the grouped out-norm;
* ``flash_attention``'s ``scale``; the spans ``zamba2.shared_block``,
  ``flash_attention`` and ``mamba.block`` and the shared-block counter over
  a prefill; decode and the sharding specs refuse, saying why.

No JAX here.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from h100bench.reference import zamba2 as ref  # noqa: E402
from repro_torch.configs.port_only import PORT_ARCHS, get_port_config  # noqa: E402
from repro_torch.kernels.mamba_passes import ref as passes_ref  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_naive  # noqa: E402
from repro_torch.models import mamba2, zamba2  # noqa: E402
from repro_torch.models.common import flash_attention  # noqa: E402
from repro_torch.models.model_api import build_model  # noqa: E402

F32_TOL = 1e-5  # port vs reference, float32: the same arithmetic, other orders of sums
BF16_TOL = 5e-2  # port in bf16 vs the float32 reference, through seven layers
HF_TOL = 1e-4  # reference vs transformers, float32: other orders of sums and other kernels
FAULT_MIN = 20 * F32_TOL  # a planted fault reads at least this far from the reference

TINY = dict(n_layers=7, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=96,
            vocab_size=96, ssm_state=16, ssm_headdim=16, ssm_chunk=16,
            hybrid_layer_ids=(1, 3, 4, 6), adapter_rank=8, attn_q_chunk=16, attn_k_chunk=32,
            logits_chunk=32)
L = 48


def tiny_cfg(dtype="float32", **over):
    return dataclasses.replace(get_port_config("zamba2-7b"), dtype=dtype, **dict(TINY, **over))


def widths_of(cfg):
    """The reference's widths dict of a config, as a configuration file gives them."""
    keys = ("n_layers", "d_model", "vocab_size", "n_heads", "head_dim", "d_ff", "ssm_state",
            "ssm_headdim", "ssm_expand", "ssm_chunk", "ssm_conv_width", "ssm_ngroups",
            "num_mem_blocks", "adapter_rank", "rope_theta", "norm_eps", "tie_embeddings")
    w = {k: getattr(cfg, k) for k in keys}
    return dict(w, family=cfg.family, dtype=cfg.dtype, hybrid_layer_ids=list(cfg.hybrid_layer_ids))


def rand_params(cfg, seed=0):
    """The port's init with every norm scale, conv bias, D and dt_bias drawn
    at random too, and the shared blocks' query and key projections and the
    adapters' second factor eight times the init's scale (attention's
    softmax far from uniform, the adapters a large part of the MLP's input),
    so that each term shows in the logits."""
    gen = torch.Generator().manual_seed(seed)
    p = build_model(cfg, "cpu").init(gen)
    for leaf in (p["shared"]["wq"], p["shared"]["wk"], p["adapters"]["up"]):
        leaf["w"] = leaf["w"] * 8

    def jitter(t, mean, std):
        return (mean + std * torch.randn(t.shape, generator=gen)).to(t.dtype)

    mb = p["mamba_blocks"]
    for k in ("norm", "out_norm"):
        mb[k]["scale"] = jitter(mb[k]["scale"], 1.0, 0.1)
    mb["conv_b"] = jitter(mb["conv_b"], 0.0, 0.1)
    mb["D"] = jitter(mb["D"], 1.0, 0.3)
    mb["dt_bias"] = jitter(mb["dt_bias"], -4.0, 0.5)
    for k in ("attn_norm", "mlp_norm"):
        p["shared"][k]["scale"] = jitter(p["shared"][k]["scale"], 1.0, 0.1)
    p["final_norm"]["scale"] = jitter(p["final_norm"]["scale"], 1.0, 0.1)
    return p


def tokens(cfg, seed=1, batch=2):
    return torch.randint(0, cfg.vocab_size, (batch, L), generator=torch.Generator().manual_seed(seed))


def rel(got, want):
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max())


def as_dtype(tree, dtype):
    if isinstance(tree, dict):
        return {k: as_dtype(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.dtype == torch.float32 and tree.dim() >= 2 else tree


# ------------------------------------------------------- against the release --


def _hf_model(layer_types, seed):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.Zamba2Config(
        vocab_size=96, hidden_size=64, num_hidden_layers=len(layer_types),
        layers_block_type=list(layer_types), mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
        mamba_ngroups=2, n_mamba_heads=8, chunk_size=16, intermediate_size=96,
        hidden_act="gelu", num_attention_heads=4, num_mem_blocks=2,
        use_shared_attention_adapter=False, adapter_rank=8, use_mem_rope=True,
        rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=True, use_cache=False,
        # the release's time_step_limit is null, so its CUDA path limits no dt;
        # transformers' torch path clamps dt at time_step_min, set here below any dt
        time_step_min=1e-9, attn_implementation="eager")
    torch.manual_seed(seed)
    model = transformers.Zamba2ForCausalLM(cfg).eval()
    with torch.no_grad():  # every norm scale, bias, D and dt_bias off its init too
        for name, t in model.named_parameters():
            if name.endswith("layernorm.weight") or name.endswith("norm.weight"):
                t.add_(0.1 * torch.randn_like(t))
            elif name.endswith(("conv1d.bias", ".D")):
                t.add_(0.1 * torch.randn_like(t))
    return model


def _params_from_hf(model):
    """The port's tree (f32) of a transformers Zamba2, leaf for leaf."""
    m, cfg = model.model, model.config

    def T(lin):
        return lin.weight.detach().T.contiguous()

    def mamba(dec):
        mix = dec.mamba
        return {"norm": {"scale": dec.input_layernorm.weight.detach()},
                "in_proj": {"w": T(mix.in_proj)},
                "conv_w": mix.conv1d.weight.detach()[:, 0, :].T.contiguous(),
                "conv_b": mix.conv1d.bias.detach(), "A_log": mix.A_log.detach(),
                "D": mix.D.detach(), "dt_bias": mix.dt_bias.detach(),
                "out_norm": {"scale": mix.norm.weight.detach()},
                "out_proj": {"w": T(mix.out_proj)}}

    def shared(st):
        a, f = st.self_attn, st.feed_forward
        return {"attn_norm": {"scale": st.input_layernorm.weight.detach()},
                "wq": {"w": T(a.q_proj)}, "wk": {"w": T(a.k_proj)}, "wv": {"w": T(a.v_proj)},
                "wo": {"w": T(a.o_proj)}, "mlp_norm": {"scale": st.pre_ff_layernorm.weight.detach()},
                "w_gate_up": {"w": T(f.gate_up_proj)}, "w_down": {"w": T(f.down_proj)}}

    sites = cfg.hybrid_layer_ids
    decs = [lay.mamba_decoder if l in sites else lay for l, lay in enumerate(m.layers)]
    blocks = [m.layers[sites[b]].shared_transformer for b in range(cfg.num_mem_blocks)]
    adapters = [m.layers[l].shared_transformer.feed_forward.gate_up_proj_adapter_list[i]
                for i, l in enumerate(sites)]
    stack = mamba2._stack  # noqa: SLF001 (the models' own stacking)
    return {
        "embed": {"emb": m.embed_tokens.weight.detach()},
        "mamba_blocks": stack([mamba(d) for d in decs]),
        "shared": stack([shared(b) for b in blocks]),
        "adapters": stack([{"down": {"w": T(a[0])}, "up": {"w": T(a[1])}} for a in adapters]),
        "site_linear": stack([{"w": T(m.layers[l].linear)} for l in sites]),
        "final_norm": {"scale": m.final_layernorm.weight.detach()},
    }


def _hf_widths(model):
    c = model.config
    return dict(family="zamba2", dtype="float32", n_layers=c.num_hidden_layers,
                d_model=c.hidden_size, vocab_size=c.vocab_size, n_heads=c.num_attention_heads,
                head_dim=c.attention_head_dim, d_ff=c.intermediate_size,
                ssm_state=c.mamba_d_state, ssm_headdim=c.mamba_headdim, ssm_expand=c.mamba_expand,
                ssm_chunk=c.chunk_size, ssm_conv_width=c.mamba_d_conv, ssm_ngroups=c.mamba_ngroups,
                hybrid_layer_ids=list(c.hybrid_layer_ids), num_mem_blocks=c.num_mem_blocks,
                adapter_rank=c.adapter_rank, rope_theta=c.rope_theta, norm_eps=c.rms_norm_eps,
                tie_embeddings=True)


HF_PATTERNS = [
    ("mamba", "hybrid", "mamba", "hybrid", "hybrid", "mamba", "hybrid"),
    ("hybrid", "mamba", "mamba", "hybrid", "mamba", "hybrid", "mamba", "mamba", "hybrid"),
]


@pytest.mark.parametrize("pattern", range(len(HF_PATTERNS)))
def test_reference_matches_transformers_zamba2(pattern):
    model = _hf_model(HF_PATTERNS[pattern], seed=pattern)
    w = _hf_widths(model)
    assert w["num_mem_blocks"] == 2 and len(w["hybrid_layer_ids"]) >= 3 and w["ssm_ngroups"] == 2
    params = _params_from_hf(model)
    toks = torch.randint(0, 96, (2, L), generator=torch.Generator().manual_seed(pattern))
    with torch.no_grad():
        want = model(input_ids=toks).logits[:, -1]
    assert rel(ref.prefill_logits(w, params, toks), want) <= HF_TOL


def test_transformers_runs_each_site_on_its_block_and_adapter():
    model = _hf_model(HF_PATTERNS[0], seed=0)
    cfg = tiny_cfg(hybrid_layer_ids=tuple(model.config.hybrid_layer_ids))
    assert zamba2.layer_types(cfg) == list(model.config.layers_block_type)
    for i, l in enumerate(cfg.hybrid_layer_ids):
        st = model.model.layers[l].shared_transformer
        assert st.block_id == cfg.block_of_site(i) == i % 2
        assert isinstance(st.feed_forward.gate_up_proj_adapter_list[i], torch.nn.Sequential)


# --------------------------------------------------------- the port's prefill --


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_port_prefill_matches_the_reference(dtype, tol):
    cfg = tiny_cfg(dtype)
    p32 = rand_params(tiny_cfg())
    params = as_dtype(p32, getattr(torch, dtype))
    toks = tokens(cfg)
    got = build_model(cfg, "cpu").prefill(params, {"tokens": toks})
    want = ref.prefill_logits(widths_of(cfg), params, toks)
    assert got.shape == (2, cfg.vocab_size) and got.dtype == torch.float32
    assert rel(got, want) <= tol


def test_port_loss_is_the_prefill_forward():
    cfg = tiny_cfg()
    params, toks = rand_params(cfg), tokens(cfg)
    model = build_model(cfg, "cpu")
    loss = model.loss(params, {"tokens": toks, "labels": toks})
    h = zamba2.rmsnorm(params["final_norm"], zamba2._forward(cfg, params, toks), cfg.norm_eps)
    logits = (h @ params["embed"]["emb"].T).float()
    want = F.cross_entropy(logits.reshape(-1, cfg.vocab_size), toks.reshape(-1))
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close((h[:, -1] @ params["embed"]["emb"].T).float(),
                               model.prefill(params, {"tokens": toks}))


def test_layer_pattern_is_the_releases():
    cfg = get_port_config("zamba2-7b")
    release = json.loads((REPO / "h100bench" / "configs" / "zamba2-7b.json").read_text())
    assert "zamba2-7b" in PORT_ARCHS
    assert zamba2.layer_types(cfg) == release["layers_block_type"]
    assert list(cfg.hybrid_layer_ids) == release["hybrid_layer_ids"]
    assert (cfg.n_layers, cfg.d_model, cfg.ssm_ngroups, cfg.num_mem_blocks, cfg.adapter_rank) == (
        release["num_hidden_layers"], release["hidden_size"], release["mamba_ngroups"],
        release["num_mem_blocks"], release["adapter_rank"])
    assert (cfg.n_heads * cfg.resolved_head_dim, cfg.resolved_head_dim, cfg.d_ff,
            cfg.ssm_nheads) == (release["attention_hidden_size"], release["attention_head_dim"],
                                release["ffn_hidden_size"], release["n_mamba_heads"])
    zamba2.check_config(cfg)
    assert [cfg.block_of_site(i) for i in range(cfg.n_sites)] == [i % 2 for i in range(13)]


@pytest.mark.parametrize("site", range(len(TINY["hybrid_layer_ids"])))
def test_each_site_runs_its_block_and_its_adapter(site):
    """The port's shared block at a site equals the reference's, which reads
    shared block ``site % 2``, adapter ``site`` and site linear ``site``."""
    cfg = tiny_cfg()
    params = rand_params(cfg)
    gen = torch.Generator().manual_seed(site)
    h, e = (torch.randn((2, L, cfg.d_model), generator=gen) for _ in range(2))
    positions = torch.arange(L).expand(2, L)
    got = zamba2.shared_block(cfg, params, site, h, e, positions)
    with ref.exact_matmul():
        want = ref.shared_block(widths_of(cfg), params, site, h, e, "f32")
    assert rel(got, want) <= F32_TOL


def _collapse_groups(scan):
    def collapsed(x, log_a, B, C, dt, chunk):
        return scan(x, log_a, B[:, :, :1].expand_as(B), C[:, :, :1].expand_as(C), dt, chunk)
    return collapsed


def _whole_norm(cfg, p, y):
    return mamba2.rmsnorm(p["out_norm"], y, cfg.norm_eps)


def _roll_adapters(params):
    return dict(params, adapters={k: {"w": torch.roll(v["w"], 1, dims=0)}
                                  for k, v in params["adapters"].items()})


FAULTS = ["adapter_of_next_site", "scale_inv_sqrt_dh", "groups_collapsed", "norm_not_grouped",
          "addend_in_residual"]


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_fail_the_comparison(monkeypatch, fault):
    cfg = tiny_cfg()
    params, toks = rand_params(cfg), tokens(cfg)
    want = ref.prefill_logits(widths_of(cfg), params, toks)
    run = params
    if fault == "adapter_of_next_site":
        run = _roll_adapters(params)
    elif fault == "scale_inv_sqrt_dh":
        monkeypatch.setattr(zamba2, "flash_attention",
                            lambda q, k, v, scale=None, **kw: flash_attention(q, k, v, **kw))
    elif fault == "groups_collapsed":
        monkeypatch.setattr(mamba2, "ssd_scan", _collapse_groups(mamba2.ssd_scan))
    elif fault == "norm_not_grouped":
        monkeypatch.setattr(passes_ref, "gated_norm", _whole_norm)
    else:
        apply = zamba2.mamba_block_apply
        monkeypatch.setattr(zamba2, "mamba_block_apply", lambda c, p, h, t=None: apply(
            c, p, h if t is None else h + t))
    got = build_model(cfg, "cpu").prefill(run, {"tokens": toks})
    assert rel(got, want) >= FAULT_MIN, rel(got, want)


# ------------------------------------------------------------ grouped scans --

SCAN_SHAPES = [  # (Bt, L, H, P, N, Q, G)
    (2, 32, 4, 8, 8, 8, 2), (1, 48, 6, 16, 16, 16, 3), (2, 64, 8, 16, 16, 16, 4),
    (1, 32, 4, 8, 8, 32, 1),
]


def _scan_inputs(Bt, Lq, H, P, N, G, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    draw = [rng.standard_normal((Bt, Lq, H, P), dtype=f),
            -np.abs(rng.standard_normal((Bt, Lq, H), dtype=f)) * 0.3,
            rng.standard_normal((Bt, Lq, G, N), dtype=f), rng.standard_normal((Bt, Lq, G, N), dtype=f),
            np.logaddexp(rng.standard_normal((Bt, Lq, H), dtype=f), f(0))]
    return [torch.from_numpy(np.asarray(a, dtype=f)) for a in draw]


@pytest.mark.parametrize("Bt,Lq,H,P,N,Q,G", SCAN_SHAPES)
def test_grouped_chunked_scan_is_each_heads_scan_with_its_group(Bt, Lq, H, P, N, Q, G):
    x, la, B, C, dt = _scan_inputs(Bt, Lq, H, P, N, G, seed=Lq + G)
    got = ssd_chunked(x, la, B, C, dt, Q)
    per_head = torch.cat([ssd_naive(x[:, :, h:h + 1], la[..., h:h + 1], B[:, :, h * G // H],
                                    C[:, :, h * G // H], dt[..., h:h + 1]) for h in range(H)],
                         dim=2)
    assert got.shape == x.shape
    torch.testing.assert_close(got, per_head, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ssd_naive(x, la, B, C, dt), per_head, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_group_is_the_shared_scan_bit_for_bit(dtype):
    x, la, B, C, dt = _scan_inputs(2, 64, 4, 16, 8, 1, seed=3)
    x, B, C = x.to(dtype), B.to(dtype), C.to(dtype)
    assert torch.equal(ssd_chunked(x, la, B, C, dt, 16), ssd_chunked(x, la, B[:, :, 0],
                                                                      C[:, :, 0], dt, 16))
    assert torch.equal(ssd_naive(x, la, B, C, dt), ssd_naive(x, la, B[:, :, 0], C[:, :, 0], dt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_group_mamba_block_is_the_ungrouped_block_bit_for_bit(dtype):
    """A Zamba2Config with ssm_ngroups 1 runs the same block, bit for bit, as
    the plain ModelConfig of the same widths (the mamba2 route)."""
    from repro_torch.configs import get_config

    base = get_config("mamba2-1.3b").reduced(dtype=dtype)
    one = zamba2.Zamba2Config(**dataclasses.asdict(base), ssm_ngroups=1)
    gen = torch.Generator().manual_seed(0)
    p = mamba2.init_mamba_block(gen, base, getattr(torch, dtype))
    x = torch.randn((2, 2 * base.ssm_chunk, base.d_model), generator=gen).to(getattr(torch, dtype))
    assert torch.equal(mamba2.mamba_block_apply(one, p, x), mamba2.mamba_block_apply(base, p, x))


def test_grouped_out_norm_takes_each_groups_rms():
    cfg = tiny_cfg()
    gen = torch.Generator().manual_seed(0)
    y = torch.randn((2, 5, cfg.d_inner), generator=gen)
    p = {"out_norm": {"scale": 1 + 0.1 * torch.randn(cfg.d_inner, generator=gen)}}
    half = cfg.d_inner // 2
    want = torch.cat([F.rms_norm(y[..., :half], (half,), eps=cfg.norm_eps),
                      F.rms_norm(y[..., half:], (half,), eps=cfg.norm_eps)], -1) * p["out_norm"]["scale"]
    torch.testing.assert_close(passes_ref.gated_norm(cfg, p, y), want, rtol=1e-6, atol=1e-6)


def test_addend_enters_the_norm_and_not_the_residual():
    cfg = tiny_cfg()
    params = rand_params(cfg)
    p = mamba2._layer(params["mamba_blocks"], 0)  # noqa: SLF001
    gen = torch.Generator().manual_seed(5)
    x, t = (torch.randn((2, L, cfg.d_model), generator=gen) for _ in range(2))
    got = mamba2.mamba_block_apply(cfg, p, x, t)
    no_res = mamba2.mamba_block_apply(cfg, p, x + t) - (x + t)  # the mixer of rmsnorm(x + t)
    torch.testing.assert_close(got, x + no_res, rtol=1e-5, atol=1e-5)


# ------------------------------------------------- attention, spans, refusals --


@pytest.mark.parametrize("scale", [None, 0.125, (32 / 2) ** -0.5])
def test_flash_attention_scale(scale):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 40, 4, 32), generator=gen) for _ in range(3))
    got = flash_attention(q, k, v, causal=True, q_chunk=16, k_chunk=16, scale=scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (32 ** -0.5 if scale is None else scale)
    s = torch.where(torch.tril(torch.ones(40, 40, dtype=torch.bool)), s, -torch.inf)
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_prefill_records_its_spans_and_counts_its_sites():
    from torch.profiler import ProfilerActivity, profile

    cfg = tiny_cfg()
    params, toks = rand_params(cfg), tokens(cfg)
    model = build_model(cfg, "cpu")
    before = zamba2.shared_block.calls
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.prefill(params, {"tokens": toks})
    assert zamba2.shared_block.calls == before + cfg.n_sites
    names = [e.name for e in prof.events()]
    assert names.count("zamba2.shared_block") == cfg.n_sites
    assert names.count("flash_attention") == cfg.n_sites
    assert names.count("mamba.block") == cfg.n_layers
    model.prefill(params, {"tokens": toks})  # no profiler: the counter alone
    assert zamba2.shared_block.calls == before + 2 * cfg.n_sites


@pytest.mark.parametrize("entry", ["init_cache", "decode_step", "param_specs", "cache_specs"])
def test_decode_and_specs_refuse_saying_why(entry):
    model = build_model(tiny_cfg(), "cpu")
    args = {"init_cache": (2, 8), "decode_step": (None, None, None, 0), "param_specs": (),
            "cache_specs": ()}[entry]
    with pytest.raises(NotImplementedError, match="zamba2"):
        getattr(model, entry)(*args)


def test_port_only_lookup_leaves_the_registry_alone():
    from repro_torch.configs import ARCHS

    assert "zamba2-7b" not in ARCHS and len(ARCHS) == 10
    with pytest.raises(KeyError, match="port-only"):
        get_port_config("zamba2-0b")
    with pytest.raises(ValueError, match="2 d_model"):
        zamba2.check_config(tiny_cfg(head_dim=16))
