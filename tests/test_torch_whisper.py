"""The port's whisper encoder-decoder (prefill and decode) against the JAX package's, on the CPU.

A reduced ``whisper-base`` (``reduced(dtype="float32")``: two encoder and
two decoder layers, 4 heads over 4 KV heads of 32, with ``encoder_seq``
20 and attention chunks of 8, so that several query and key chunks run
and the last of each is padded) runs in both packages with the very same
weights (``tests/torch_twins.py``: numpy draws every leaf, the port takes
the arrays through ``convert.params_from_numpy``) and the same numpy
frames and tokens.  Tolerance: ``tests/test_model_consistency.py``'s
``atol 2e-4, rtol 2e-3`` on states, logits and caches, and equal greedy
tokens.  The JAX side runs with ``jax_enable_x64`` off (its
``flash_attention`` raises under x64, and another test module in the same
worker may have turned it on).  On the CPU the decode attention is its
plain version, so the kernel's launch counter does not move.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.launch import serve as j_serve
from repro.models import whisper as JW
from repro.models.model_api import build_model as j_build_model

from repro_torch.convert import params_from_numpy
from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
from repro_torch.launch import serve
from repro_torch.models import whisper as PW
from repro_torch.models.model_api import build_model

import torch_twins as tw

ARCH = "whisper-base"
B, L, STEPS = 2, 12, 8
SMALL = dict(encoder_seq=20, attn_q_chunk=8, attn_k_chunk=8)
TOL = tw.TOL


@pytest.fixture(autouse=True)
def x64_off():
    with jax.enable_x64(False):
        yield


def _frames(cfg, seed=2):
    a = np.random.default_rng(seed).standard_normal((B, cfg.encoder_seq, cfg.d_model),
                                                     dtype=np.float32)
    return a, torch.from_numpy(a)


def test_model_init_draws_the_jax_shapes_and_scales():
    """The port's own init: the JAX tree (encoder and decoder blocks stacked
    [n_layers, ...], tied embedding), norms at 1, and the JAX scales."""
    j_cfg, cfg = tw.cfgs(ARCH, d_model=256, d_ff=512)
    small = 0.02 / (2 * cfg.n_layers) ** 0.5
    _, flat = tw.init_matches_jax(ARCH, {
        "embed/emb": 0.02, "enc_blocks/attn/wq/w": 0.02, "enc_blocks/attn/wo/w": small,
        "enc_blocks/mlp/w1/w": 0.02, "enc_blocks/mlp/w2/w": small,
        "dec_blocks/self_attn/wk/w": 0.02, "dec_blocks/cross_attn/wv/w": 0.02,
        "dec_blocks/cross_attn/wo/w": small, "dec_blocks/mlp/w2/w": small,
    }, d_model=256, d_ff=512)
    assert flat["enc_blocks/attn/wq/w"].shape[0] == cfg.n_encoder_layers
    assert flat["dec_blocks/cross_attn/wq/w"].shape[0] == cfg.n_layers


def test_encoder_and_decoder_match_jax():
    """``encode`` (bidirectional, RoPE) over padded chunks, then
    ``decoder_hidden`` (causal self-attention with RoPE, cross-attention
    without), and ``gelu_mlp`` (tanh GELU taken in f32)."""
    j_model, j_params, model, params = tw.both(ARCH, **SMALL)
    cfg = model.cfg
    fa, ft = _frames(cfg)
    want_enc = JW.encode(cfg, j_params, jnp.asarray(fa))
    got_enc = PW.encode(cfg, params, ft)
    np.testing.assert_allclose(got_enc.numpy(), np.asarray(want_enc), **TOL)
    toks = tw.tokens(cfg, (B, L))
    want = JW.decoder_hidden(cfg, j_params, jnp.asarray(toks), want_enc)
    got = PW.decoder_hidden(cfg, params, torch.from_numpy(toks), got_enc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    x = np.random.default_rng(3).standard_normal((B, 5, cfg.d_model), dtype=np.float32)
    mlp = params["dec_blocks"]["mlp"]
    np.testing.assert_allclose(
        PW.gelu_mlp({k: {"w": v["w"][0]} for k, v in mlp.items()}, torch.from_numpy(x)).numpy(),
        np.asarray(JW.gelu_mlp({k: {"w": v["w"][0]} for k, v in j_params["dec_blocks"]["mlp"].items()},
                               jnp.asarray(x))), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("length", [L, 5])
def test_prefill_matches_jax(length):
    j_model, j_params, model, params = tw.both(ARCH, seed=1, **SMALL)
    cfg = model.cfg
    fa, ft = _frames(cfg, seed=4)
    toks = tw.tokens(cfg, (B, length), seed=5)
    want = np.asarray(j_model.prefill(j_params, {"frames": jnp.asarray(fa),
                                                 "tokens": jnp.asarray(toks)}))
    before = decode_attn_cuda.launches
    got = model.prefill(params, {"frames": ft, "tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.array_equal(got.argmax(-1).numpy(), want.argmax(-1))
    assert decode_attn_cuda.launches == before


def test_cross_kv_and_decode_steps_match_jax():
    """``encdec_prefill_cross`` writes each layer's cross K/V (in place in
    the port, into a new cache in JAX), then 8 decode steps: logits, the
    self-attention caches, and cross K/V that decode only reads."""
    j_model, j_params, model, params = tw.both(ARCH, seed=6, **SMALL)
    cfg = model.cfg
    fa, ft = _frames(cfg, seed=7)
    toks = tw.tokens(cfg, (B, STEPS), seed=8)
    j_cache = j_model.init_cache(B, L)
    cache = model.init_cache(B, L)
    assert sorted(cache) == sorted(j_cache) == ["k", "v", "xk", "xv"]
    for name in cache:
        assert cache[name].shape == j_cache[name].shape, name
        assert not cache[name].any() and 0 not in cache[name].stride(), name
    j_cache = JW.encdec_prefill_cross(cfg, j_params, JW.encode(cfg, j_params, jnp.asarray(fa)),
                                      j_cache)
    same = PW.encdec_prefill_cross(cfg, params, PW.encode(cfg, params, ft), cache)
    assert same is cache
    for name in ("xk", "xv"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(j_cache[name]), **TOL)
    cross = {n: cache[n].clone() for n in ("xk", "xv")}
    j_step = jax.jit(j_model.decode_step)
    before = decode_attn_cuda.launches
    for i in range(STEPS):
        want, j_cache = j_step(j_params, jnp.asarray(toks[:, i]), j_cache, jnp.int32(i))
        got, cache = model.decode_step(params, torch.from_numpy(toks[:, i]), cache, i)
        want = np.asarray(want)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        assert np.array_equal(got.argmax(-1).numpy(), want.argmax(-1)), i
    for name in cache:
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(j_cache[name]), **TOL)
    for name, t in cross.items():
        assert torch.equal(cache[name], t), name
    assert not cache["k"][:, :, STEPS:].any()
    assert decode_attn_cuda.launches == before


def test_prefill_equals_its_own_decode():
    """The JAX package's cross-path check (test_whisper_decode_matches_train)
    on the port alone: encoder, cross K/V, then decode step by step equals
    ``decoder_hidden``'s last logits on the same tokens."""
    _, _, model, params = tw.both(ARCH, seed=9, **SMALL)
    cfg = model.cfg
    _, ft = _frames(cfg, seed=10)
    toks = torch.from_numpy(tw.tokens(cfg, (B, L), seed=11))
    want = model.prefill(params, {"frames": ft, "tokens": toks})
    cache = PW.encdec_prefill_cross(cfg, params, PW.encode(cfg, params, ft),
                                    model.init_cache(B, L))
    for i in range(L):
        got, cache = model.decode_step(params, toks[:, i], cache, i)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_serve_run_matches_jax_serve_run(monkeypatch):
    """``serve.run(..., device="cpu")`` against the JAX ``serve.run`` (greedy
    from token 0, the cross K/V as ``init_cache`` leaves them, the reduced
    model), both entry points given the same numpy-drawn weights."""
    j_cfg, _ = tw.cfgs(ARCH)
    j_model = j_build_model(j_cfg)
    np_params, expect = tw.numpy_params(j_model, seed=12)
    j_params = jax.tree_util.tree_map(jnp.asarray, np_params)
    params = params_from_numpy(np_params, device="cpu", expect=expect)
    monkeypatch.setattr(j_serve, "build_model", lambda cfg: dataclasses.replace(
        j_build_model(cfg), init=lambda key: j_params))
    monkeypatch.setattr(serve, "build_model", lambda cfg, device: dataclasses.replace(
        build_model(cfg, device), init=lambda gen: params))
    want = np.asarray(j_serve.run(ARCH, tokens=STEPS, batch=B, ctx=L))
    before = decode_attn_cuda.launches
    got = serve.run(ARCH, tokens=STEPS, batch=B, ctx=L, device="cpu")
    assert got.shape == (B, STEPS) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert decode_attn_cuda.launches == before


def test_serve_decode_goes_on_from_a_filled_cache():
    """``serve.decode`` handed whisper's cache with the cross K/V written and
    the first token: the same ids as stepping ``decode_step`` by hand."""
    _, _, model, params = tw.both(ARCH, seed=13, **SMALL)
    cfg = model.cfg
    _, ft = _frames(cfg, seed=14)
    enc = PW.encode(cfg, params, ft)
    first = torch.tensor([3, 7], dtype=torch.int32)
    cache = PW.encdec_prefill_cross(cfg, params, enc, model.init_cache(B, L))
    got = serve.decode(model, params, tokens=4, batch=B, ctx=L, cache=cache, start=2, first=first)
    cache = PW.encdec_prefill_cross(cfg, params, enc, model.init_cache(B, L))
    tok, want = first, []
    for i in range(2, 6):
        logits, cache = model.decode_step(params, tok, cache, i)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        want.append(tok)
    assert torch.equal(got, torch.stack(want, dim=1))
    with pytest.raises(ValueError, match="do not fit"):
        serve.decode(model, params, tokens=4, batch=B, ctx=L, start=L - 3)
