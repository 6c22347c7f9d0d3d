"""The port's dense decode path against the JAX package's, on the CPU.

A reduced ``llama3.2-1b`` (``reduced(dtype="float32")``) decodes 8 steps
in both packages with the very same weights: numpy draws every leaf
into the shapes of ``jax.eval_shape(model.init, key)`` (no ``jax.random``
stream involved), the JAX side takes the arrays as they are, and the
port takes them through ``convert.params_from_numpy`` (stacked
``blocks``, shapes checked leaf by leaf).  Both consume the same
numpy-drawn tokens; at every step the logits agree within
``tests/test_model_consistency.py``'s ``atol 2e-4, rtol 2e-3`` and the
greedy tokens (argmax) are equal, with and without the int8 KV cache.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.models.model_api import build_model as j_build_model

from repro_torch.configs import get_config
from repro_torch.configs.registry import ARCHS
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
from repro_torch.launch import serve
from repro_torch.models.model_api import build_model

ARCH = "llama3.2-1b"
B, CTX, STEPS = 2, 16, 8


def _leaf_path(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _numpy_params(j_model, seed=0):
    """Every leaf of the JAX param tree drawn with numpy: linears and the
    embedding ~ N(0, 0.02^2), norm scales 1 + N(0, 0.1^2)."""
    shapes = jax.eval_shape(j_model.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    leaves, expect = [], {}
    for path, sds in flat:
        where = _leaf_path(path)
        a = rng.standard_normal(sds.shape, dtype=np.float32)
        a = 1.0 + 0.1 * a if where.endswith("scale") else 0.02 * a
        leaves.append(a.astype(sds.dtype))
        expect[where] = sds.shape
    return jax.tree_util.tree_unflatten(treedef, leaves), expect


@pytest.mark.parametrize("kv_cache_quant", [False, True])
def test_decode_steps_match_jax(kv_cache_quant):
    j_cfg = j_get_config(ARCH).reduced(dtype="float32", kv_cache_quant=kv_cache_quant)
    cfg = get_config(ARCH).reduced(dtype="float32", kv_cache_quant=kv_cache_quant)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
    j_model = j_build_model(j_cfg)
    np_params, expect = _numpy_params(j_model)
    j_params = jax.tree_util.tree_map(jnp.asarray, np_params)
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(np_params, device="cpu", expect=expect)
    assert params["blocks"]["attn"]["wq"]["w"].shape == (cfg.n_layers, cfg.d_model,
                                                          cfg.n_heads * cfg.resolved_head_dim)

    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, STEPS), dtype=np.int32)
    j_cache = j_model.init_cache(B, CTX)
    cache = model.init_cache(B, CTX)
    assert cache["k"].shape == j_cache["k"].shape
    assert str(cache["k"].dtype).split(".")[1] == str(j_cache["k"].dtype)
    j_step = jax.jit(j_model.decode_step)
    before = decode_attn_cuda.launches
    for i in range(STEPS):
        want, j_cache = j_step(j_params, jnp.asarray(toks[:, i]), j_cache, jnp.int32(i))
        got, cache = model.decode_step(params, torch.from_numpy(toks[:, i]), cache, i)
        want = np.asarray(want)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-3)
        assert np.array_equal(got.argmax(-1).numpy(), want.argmax(-1)), i
    # the caches were written in place, position by position, like JAX's
    for name in ("k", "v"):
        j_c = np.asarray(j_cache[name])
        if kv_cache_quant:
            assert np.abs(cache[name].numpy().astype(np.int32) - j_c).max() <= 1
        else:
            np.testing.assert_allclose(cache[name].numpy(), j_c, atol=1e-5, rtol=1e-4)
        assert not cache[name][:, :, STEPS:].any()
    assert decode_attn_cuda.launches == before


def test_greedy_serve_matches_jax_serve():
    """``serve.decode`` against the JAX serve loop, same weights, greedy."""
    j_cfg = j_get_config(ARCH).reduced(dtype="float32")
    j_model = j_build_model(j_cfg)
    np_params, expect = _numpy_params(j_model, seed=2)
    j_params = jax.tree_util.tree_map(jnp.asarray, np_params)
    model, _ = serve.load(ARCH, reduced=True, device="cpu")
    params = params_from_numpy(np_params, device="cpu", expect=expect)
    seen, step = [], model.decode_step

    def keep(p, t, c, pos):
        logits, c = step(p, t, c, pos)
        seen.append((pos, logits))
        return logits, c

    model.decode_step = keep
    got = serve.decode(model, params, tokens=STEPS, batch=B, ctx=CTX)
    assert got.shape == (B, STEPS) and got.dtype == torch.int32
    assert [i for i, _ in seen] == list(range(STEPS))

    j_cache = j_model.init_cache(B, CTX)
    j_step = jax.jit(j_model.decode_step)
    tok = jnp.zeros((B,), jnp.int32)
    for i in range(STEPS):
        logits, j_cache = j_step(j_params, tok, j_cache, jnp.int32(i))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        np.testing.assert_allclose(seen[i][1].numpy(), np.asarray(logits), atol=2e-4, rtol=2e-3)
        assert np.array_equal(got[:, i].numpy(), np.asarray(tok)), i


def test_serve_run_entry_point_on_the_cpu():
    seq = serve.run(ARCH, tokens=4, batch=3, ctx=8, reduced=True, device="cpu")
    assert seq.shape == (3, 4) and seq.dtype == torch.int32
    assert bool(((seq >= 0) & (seq < 512)).all())
    with pytest.raises(ValueError, match="do not fit"):
        serve.run(ARCH, tokens=9, batch=1, ctx=8, reduced=True, device="cpu")


def test_serve_needs_the_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serve.run(ARCH, tokens=2, batch=1, ctx=4)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_model(get_config(ARCH).reduced(dtype="float32"))


@pytest.mark.parametrize("arch", ARCHS)
def test_every_registry_arch_builds_prefills_and_decodes(arch):
    """``build_model`` takes every architecture of the registry: the reduced
    config builds, prefills (with its family's frames or patch embeddings)
    and decodes one step on the CPU, finite logits of the vocabulary's
    width, without launching the decode kernel."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8), dtype=np.int32))
    batch = {"tokens": toks}
    dt = params["embed"]["emb"].dtype
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model), dtype=np.float32)).to(dt)
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_patches, cfg.d_model), dtype=np.float32)).to(dt)
    before = decode_attn_cuda.launches
    logits = model.prefill(params, batch)
    step, _ = model.decode_step(params, toks[:, 0], model.init_cache(2, 8), 0)
    for out in (logits, step):
        assert out.shape == (2, cfg.vocab_size) and out.dtype == torch.float32
        assert bool(torch.isfinite(out).all())
    assert decode_attn_cuda.launches == before


def test_model_init_draws_the_jax_shapes_and_scales():
    """The port's own init: the JAX tree's shapes and dtypes, blocks
    stacked, and the JAX scales (0.02; wo / w_down 0.02 / sqrt(2 n_layers))."""
    cfg = get_config(ARCH).reduced(dtype="float32", d_model=256, d_ff=512)
    j_model = j_build_model(j_get_config(ARCH).reduced(dtype="float32", d_model=256, d_ff=512))
    shapes = jax.eval_shape(j_model.init, jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    flat_j = {_leaf_path(p): s for p, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    flat_t = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            flat_t["/".join(path)] = node

    walk(params, ())
    assert sorted(flat_t) == sorted(flat_j)
    for where, sds in flat_j.items():
        assert tuple(flat_t[where].shape) == sds.shape, where
        assert str(flat_t[where].dtype).split(".")[1] == str(sds.dtype), where
    small = 0.02 / (2 * cfg.n_layers) ** 0.5
    for where, want in [("embed/emb", 0.02), ("blocks/attn/wq/w", 0.02),
                        ("blocks/attn/wo/w", small), ("blocks/mlp/w_down/w", small)]:
        assert abs(flat_t[where].std().item() / want - 1) < 0.05, where
    assert bool((flat_t["final_norm/scale"] == 1).all())
