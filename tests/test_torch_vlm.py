"""The port's llava VLM backbone (prefill with patch embeddings, and decode) against the JAX package's, on the CPU.

A reduced ``llava-next-34b`` (``reduced(dtype="float32")``: two layers, 4
heads over 2 KV heads of 32, 16 patch embeddings, attention chunks of 8,
so that the patches and the text cross chunk boundaries and the last
chunk is padded) runs in both packages with the very same weights
(``tests/torch_twins.py``) and the same numpy patch embeddings and tokens.
Tolerance: ``tests/test_model_consistency.py``'s ``atol 2e-4, rtol
2e-3``, and equal greedy tokens.  The JAX side runs with
``jax_enable_x64`` off (its ``flash_attention`` raises under x64).  On the
CPU the decode attention is its plain version, so the kernel's launch
counter does not move.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.launch import serve as j_serve
from repro.models.model_api import build_model as j_build_model

from repro_torch.convert import params_from_numpy
from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
from repro_torch.launch import serve
from repro_torch.models import transformer, vlm
from repro_torch.models.model_api import build_model

import torch_twins as tw

ARCH = "llava-next-34b"
B, L, STEPS = 2, 12, 8
SMALL = dict(attn_q_chunk=8, attn_k_chunk=8)
TOL = tw.TOL


@pytest.fixture(autouse=True)
def x64_off():
    with jax.enable_x64(False):
        yield


def test_model_init_is_the_dense_backbones():
    """init, cache and decode step are dense's, as in the JAX package; the
    tree has JAX's shapes, an untied head, and the JAX scales."""
    assert vlm.init_vlm_model is transformer.init_dense_model
    assert vlm.vlm_decode_step is transformer.dense_decode_step
    assert vlm.vlm_init_cache is transformer.dense_init_cache
    j_cfg, cfg = tw.cfgs(ARCH, d_model=256, d_ff=512)
    small = 0.02 / (2 * cfg.n_layers) ** 0.5
    _, flat = tw.init_matches_jax(ARCH, {
        "embed/emb": 0.02, "lm_head/w": 0.02, "blocks/attn/wq/w": 0.02,
        "blocks/attn/wo/w": small, "blocks/mlp/w_down/w": small,
    }, d_model=256, d_ff=512)
    assert flat["blocks/attn/wk/w"].shape == (cfg.n_layers, 256, cfg.n_kv_heads * 32)


@pytest.mark.parametrize("with_patches", [True, False])
@pytest.mark.parametrize("length", [L, 3])
def test_prefill_matches_jax(with_patches, length):
    """``Model.prefill`` with the patch embeddings ahead of the tokens
    (positions over Np + Lt), and without them (the JAX prefill's ``if``)."""
    j_model, j_params, model, params = tw.both(ARCH, seed=1, **SMALL)
    cfg = model.cfg
    toks = tw.tokens(cfg, (B, length), seed=2)
    j_batch, batch = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if with_patches:
        patches = np.random.default_rng(3).standard_normal((B, cfg.n_patches, cfg.d_model),
                                                           dtype=np.float32)
        j_batch["patch_embeds"] = jnp.asarray(patches)
        batch["patch_embeds"] = torch.from_numpy(patches)
    want = np.asarray(j_model.prefill(j_params, j_batch))
    before = decode_attn_cuda.launches
    got = model.prefill(params, batch)
    assert got.dtype == torch.float32 and got.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.array_equal(got.argmax(-1).numpy(), want.argmax(-1))
    assert decode_attn_cuda.launches == before
    if with_patches:  # the patches do move the logits
        alone = model.prefill(params, {"tokens": batch["tokens"]})
        assert (alone - got).abs().max() > 1e-3


def test_decode_steps_match_jax():
    j_model, j_params, model, params = tw.both(ARCH, seed=4, **SMALL)
    cfg = model.cfg
    toks = tw.tokens(cfg, (B, STEPS), seed=5)
    j_cache, cache = j_model.init_cache(B, L), model.init_cache(B, L)
    assert sorted(cache) == sorted(j_cache) == ["k", "v"]
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
    assert decode_attn_cuda.launches == before


def test_prefill_equals_its_own_decode():
    """The JAX package's cross-path check (test_decode_matches_train_forward
    for llava) on the port alone: three query chunks of 4, the last one
    padded, against decode step by step."""
    _, _, model, params = tw.both(ARCH, seed=6, attn_q_chunk=4, attn_k_chunk=4)
    toks = torch.from_numpy(tw.tokens(model.cfg, (B, 10), seed=7))
    want = model.prefill(params, {"tokens": toks})
    cache = model.init_cache(B, 10)
    for i in range(10):
        got, cache = model.decode_step(params, toks[:, i], cache, i)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_serve_run_matches_jax_serve_run(monkeypatch):
    j_cfg, _ = tw.cfgs(ARCH)
    j_model = j_build_model(j_cfg)
    np_params, expect = tw.numpy_params(j_model, seed=8)
    j_params = jax.tree_util.tree_map(jnp.asarray, np_params)
    params = params_from_numpy(np_params, device="cpu", expect=expect)
    monkeypatch.setattr(j_serve, "build_model", lambda cfg: dataclasses.replace(
        j_build_model(cfg), init=lambda key: j_params))
    monkeypatch.setattr(serve, "build_model", lambda cfg, device: dataclasses.replace(
        build_model(cfg, device), init=lambda gen: params))
    want = np.asarray(j_serve.run(ARCH, tokens=STEPS, batch=B, ctx=L))
    got = serve.run(ARCH, tokens=STEPS, batch=B, ctx=L, device="cpu")
    assert got.shape == (B, STEPS) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
