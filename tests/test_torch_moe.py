"""The port's MoE family (llama4-maverick, qwen3-moe: dispatch, prefill, decode) against the JAX package's, on the CPU.

``moe_dispatch`` is held to JAX's on the same numpy ``x`` and
``router_w``: the dispatch tensor equal (it is 0/1: which token goes to
which expert's which capacity slot), combine and the auxiliary loss
within 1e-6 (the gates' softmax, taken in another order), for top-1 and
for top-2 and top-3 with tokens dropped at capacity.  Each case asserts
its inputs' top-k margin first: the float64 router logits of every token,
sorted, differ by at least 1e-4 between neighbours down to the (k+1)-th,
where another f32 summation order moves a logit (a dot of 12 or 16 terms
of order 1) by some 1e-6, so no order of summation can flip the choice.

Reduced ``llama4-maverick-400b-a17b`` (four layers: two groups of a dense
and an MoE block) and ``qwen3-moe-235b-a22b`` (two MoE blocks), 8 experts,
top-1 and top-8, groups of 8 tokens (so that a prefill dispatches several
groups) and attention chunks of 8, run in both packages with the very same
weights (``tests/torch_twins.py``).  Tolerance:
``tests/test_model_consistency.py``'s ``atol 2e-4, rtol 2e-3``, and equal
greedy tokens.  The JAX side runs with ``jax_enable_x64`` off.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.launch import serve as j_serve
from repro.models import moe as JM
from repro.models.config import ModelConfig as JModelConfig
from repro.models.model_api import build_model as j_build_model

from repro_torch.convert import params_from_numpy
from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
from repro_torch.launch import serve
from repro_torch.models import moe as PM
from repro_torch.models.config import ModelConfig
from repro_torch.models.model_api import build_model

import torch_twins as tw

ROOT = Path(__file__).resolve().parents[1]
ARCHS = {"llama4-maverick-400b-a17b": dict(n_layers=4), "qwen3-moe-235b-a22b": {}}
B, L, STEPS = 2, 12, 8
SMALL = dict(attn_q_chunk=8, attn_k_chunk=8, moe_group_size=8)
TOL = tw.TOL
MARGIN = 1e-4


@pytest.fixture(autouse=True)
def x64_off():
    with jax.enable_x64(False):
        yield


def _top_k_margin(x, w, k):
    """The least gap between neighbours of each token's float64 router
    logits, sorted, down to the (k+1)-th (the softmax keeps their order)."""
    logits = -np.sort(-(x.astype(np.float64) @ w.astype(np.float64)), axis=-1)
    return float(np.diff(-logits[..., :k + 1], axis=-1).min())


# (E, K, capacity_factor, G, S, D, offset): offset shifts x, so that the
# router favours some experts and their capacity overflows
DISPATCH = [
    (8, 1, 1.25, 2, 32, 16, 0.0),  # top-1
    (4, 2, 1.0, 2, 32, 16, 1.0),  # top-2, drops
    (8, 3, 1.0, 3, 24, 12, 1.0),  # top-3, drops
]


@pytest.mark.parametrize("E,K,cf,G,S,D,offset", DISPATCH)
def test_dispatch_matches_jax_exactly(E, K, cf, G, S, D, offset):
    fields = dict(name="t", family="moe", n_layers=2, d_model=D, n_heads=2, n_kv_heads=2,
                  d_ff=32, vocab_size=64, n_experts=E, experts_per_token=K, moe_d_ff=16,
                  capacity_factor=cf, moe_group_size=S)
    j_cfg, cfg = JModelConfig(**fields), ModelConfig(**fields)
    rng = np.random.default_rng(E * 100 + K)
    x = rng.standard_normal((G, S, D), dtype=np.float32) + np.float32(offset)
    w = 0.3 * rng.standard_normal((D, E), dtype=np.float32)
    assert _top_k_margin(x, w, K) >= MARGIN
    jd, jc, ja = JM.moe_dispatch(j_cfg, jnp.asarray(w), jnp.asarray(x))
    d, c, a = PM.moe_dispatch(cfg, torch.from_numpy(w), torch.from_numpy(x))
    C = PM._capacity(cfg, S)
    assert C == JM._capacity(j_cfg, S) and d.shape == (G, S, E, C)
    assert np.array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(a.item(), float(ja), atol=1e-6, rtol=0)
    # every slot holds at most one token, combine weights lie in [0, 1], and
    # each token reaches at most K experts
    assert d.sum(dim=1).max() <= 1 and 0 <= c.min() and c.max() <= 1 + 1e-6
    assert d.sum(dim=(2, 3)).max() <= K
    if offset:  # the skewed router overflows some expert's capacity
        assert d.sum() < G * S * K


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_forced_route_replays_moe_topk():
    """``chip_smoke._forced_topk``, which the smoke run's plain replay
    takes in place of ``moe_topk``: ``moe_topk``'s own indices give back
    its own choice; another run's indices are taken as given, each with
    this call's gate, and ``moe_dispatch`` built on them sends the tokens
    there."""
    forced_topk = _chip_smoke()._forced_topk
    fields = dict(name="t", family="moe", n_layers=2, d_model=12, n_heads=2, n_kv_heads=2,
                  d_ff=32, vocab_size=64, n_experts=8, experts_per_token=3, moe_d_ff=16,
                  capacity_factor=8 / 3, moe_group_size=24)
    cfg = ModelConfig(**fields)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 24, 12), dtype=np.float32))
    w = torch.from_numpy(0.3 * rng.standard_normal((12, 8), dtype=np.float32))
    gates = torch.softmax(x @ w, dim=-1)
    own = PM.moe_topk(cfg, gates)
    again = forced_topk(gates, own[2])
    for a, b in zip(own, again):
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    forced = [(i + 1) % 8 for i in own[2]]  # other experts, still distinct per token
    sel_gate, onehot, idx = forced_topk(gates, forced)
    assert all(torch.equal(i, f) for i, f in zip(idx, forced))
    for k in range(3):
        torch.testing.assert_close(sel_gate[k], torch.gather(gates, -1, forced[k][..., None])[..., 0])
    real = PM.moe_topk
    try:
        PM.moe_topk = lambda c, g: forced_topk(g, forced)
        d, _, _ = PM.moe_dispatch(cfg, w, x)
    finally:
        PM.moe_topk = real
    # capacity E/K: no token dropped; each token's slots are its forced experts
    sent = d.sum(dim=3)  # [G, S, E]
    assert torch.equal(sent, sum(torch.nn.functional.one_hot(f, 8).float() for f in forced))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_init_draws_the_jax_shapes_and_scales(arch):
    """The port's own init (expert banks drawn an expert at a time): the
    JAX tree (MoE blocks [groups, ...], llama4's dense blocks [groups, 1,
    ...]), norms at 1, and the JAX scales."""
    over = dict(ARCHS[arch], d_model=256, d_ff=512)
    _, cfg = tw.cfgs(arch, **over)
    small = 0.02 / (2 * cfg.n_layers) ** 0.5
    scales = {"embed/emb": 0.02, "lm_head/w": 0.02, "moe_blocks/moe/router/w": 0.02,
              "moe_blocks/moe/w_gate": 0.02, "moe_blocks/moe/w_up": 0.02,
              "moe_blocks/moe/w_down": small, "moe_blocks/attn/wo/w": small}
    if cfg.moe_every > 1:
        scales["dense_blocks/mlp/w_down/w"] = small
    _, flat = tw.init_matches_jax(arch, scales, **over)
    ng = cfg.n_layers // cfg.moe_every
    assert flat["moe_blocks/moe/w_gate"].shape == (ng, cfg.n_experts, 256, cfg.moe_d_ff)
    assert ("dense_blocks/attn/wq/w" in flat) == (cfg.moe_every > 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_ffn_matches_jax(arch):
    """``moe_ffn_apply`` over three groups of tokens: output and aux loss."""
    j_model, j_params, model, params = tw.both(arch, seed=1, **ARCHS[arch], **SMALL)
    cfg = model.cfg
    x = np.random.default_rng(2).standard_normal((B, L, cfg.d_model), dtype=np.float32)
    take = lambda tree: {k: (take(v) if isinstance(v, dict) else v[0])  # noqa: E731
                         for k, v in tree.items()}
    jy, ja = JM.moe_ffn_apply(cfg, take(j_params["moe_blocks"]["moe"]), jnp.asarray(x))
    y, a = PM.moe_ffn_apply(cfg, take(params["moe_blocks"]["moe"]), torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(a.item(), float(ja), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="not divisible"):
        PM.moe_ffn_apply(cfg, take(params["moe_blocks"]["moe"]), torch.zeros((1, 10, cfg.d_model)))


@pytest.mark.parametrize("length", [L, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, length):
    j_model, j_params, model, params = tw.both(arch, seed=3, **ARCHS[arch], **SMALL)
    cfg = model.cfg
    toks = tw.tokens(cfg, (B, length), seed=4)
    want = np.asarray(j_model.prefill(j_params, {"tokens": jnp.asarray(toks)}))
    before = decode_attn_cuda.launches
    got = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.array_equal(got.argmax(-1).numpy(), want.argmax(-1))
    assert decode_attn_cuda.launches == before


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch):
    j_model, j_params, model, params = tw.both(arch, seed=5, **ARCHS[arch], **SMALL)
    cfg = model.cfg
    toks = tw.tokens(cfg, (B, STEPS), seed=6)
    j_cache, cache = j_model.init_cache(B, L), model.init_cache(B, L)
    assert sorted(cache) == sorted(j_cache)
    for name in cache:
        assert cache[name].shape == j_cache[name].shape, name
        assert 0 not in cache[name].stride(), name
    j_step = jax.jit(j_model.decode_step)
    before = decode_attn_cuda.launches
    for i in range(STEPS):
        want, j_cache = j_step(j_params, jnp.asarray(toks[:, i]), j_cache, jnp.int32(i))
        got, cache = model.decode_step(params, torch.from_numpy(toks[:, i]), cache, i)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        assert np.array_equal(got.argmax(-1).numpy(), want.argmax(-1)), i
    for name in cache:
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(j_cache[name]), **TOL)
        assert not cache[name][..., STEPS:, :, :].any(), name
    assert decode_attn_cuda.launches == before


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_equals_its_own_decode(arch):
    """The JAX package's cross-path check (the llama4 and qwen3 cases of
    test_decode_matches_train_forward) on the port alone: B=2, 8 tokens,
    attention chunks of 4.  The capacity factor is E/K here, so that no
    expert's capacity can overflow in either path: the reference's capacity
    depends on a group's token count (16 in the prefill, 2 in a decode
    step), and where it drops a token the two paths compute different
    functions."""
    _, cfg0 = tw.cfgs(arch, **ARCHS[arch])
    _, _, model, params = tw.both(arch, seed=7, **ARCHS[arch], attn_q_chunk=4, attn_k_chunk=4,
                                  capacity_factor=cfg0.n_experts / cfg0.experts_per_token)
    toks = torch.from_numpy(tw.tokens(model.cfg, (B, 8), seed=8))
    want = model.prefill(params, {"tokens": toks})
    cache = model.init_cache(B, 8)
    for i in range(8):
        got, cache = model.decode_step(params, toks[:, i], cache, i)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_run_matches_jax_serve_run(arch, monkeypatch):
    j_cfg, _ = tw.cfgs(arch)
    j_model = j_build_model(j_cfg)
    np_params, expect = tw.numpy_params(j_model, seed=9)
    j_params = jax.tree_util.tree_map(jnp.asarray, np_params)
    params = params_from_numpy(np_params, device="cpu", expect=expect)
    monkeypatch.setattr(j_serve, "build_model", lambda cfg: dataclasses.replace(
        j_build_model(cfg), init=lambda key: j_params))
    monkeypatch.setattr(serve, "build_model", lambda cfg, device: dataclasses.replace(
        build_model(cfg, device), init=lambda gen: params))
    want = np.asarray(j_serve.run(arch, tokens=STEPS, batch=B, ctx=L))
    before = decode_attn_cuda.launches
    got = serve.run(arch, tokens=STEPS, batch=B, ctx=L, device="cpu")
    assert got.shape == (B, STEPS) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert decode_attn_cuda.launches == before
