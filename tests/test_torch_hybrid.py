"""The port's zamba2 hybrid (prefill and decode) against the JAX package's, on the CPU.

A reduced ``zamba2-2.7b`` (``reduced(dtype="float32")`` with
``n_layers=4`` and ``hybrid_attn_every=2``, so that two attention sites
share one block's weights and each keeps its own KV cache; ``ssm_chunk=4``
and attention chunks of 4, so that several chunks run) runs in both
packages with the very same weights: numpy draws every leaf into the
shapes of ``jax.eval_shape(model.init, key)``, the JAX side takes the
arrays as they are, and the port takes them through
``convert.params_from_numpy`` (``mamba_blocks`` stacked twice, by group
and by position in the group).  Both consume the same numpy-drawn tokens.
Tolerance: ``tests/test_model_consistency.py``'s ``atol 2e-4, rtol 2e-3``
on logits and caches, and equal greedy tokens.  The JAX side runs with
``jax_enable_x64`` off (its ``flash_attention`` raises under x64, and
another test module in the same worker may have turned it on).  On the
CPU the SSD scan and the decode attention are their plain versions, so
neither kernel's launch counter moves.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.launch import serve as j_serve
from repro.models.model_api import build_model as j_build_model

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
from repro_torch.launch import serve
from repro_torch.models.model_api import build_model

ARCH = "zamba2-2.7b"
B, L, STEPS = 2, 16, 8
TOL = dict(atol=2e-4, rtol=2e-3)


@pytest.fixture(autouse=True)
def x64_off():
    with jax.enable_x64(False):
        yield


def _cfgs(**over):
    over = dict(dtype="float32", n_layers=4, hybrid_attn_every=2, ssm_chunk=4,
                attn_q_chunk=4, attn_k_chunk=4, **over)
    j_cfg = j_get_config(ARCH).reduced(**over)
    cfg = get_config(ARCH).reduced(**over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
    return j_cfg, cfg


def _leaf_path(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _draw(where, shape, rng):
    """A leaf drawn with numpy at a scale that keeps the model stable."""
    a = rng.standard_normal(shape, dtype=np.float32)
    name = where.split("/")[-1]
    if name in ("scale", "D"):
        return 1.0 + 0.1 * a
    if name == "conv_w":
        return 0.2 * a
    if name == "A_log":
        return np.log(rng.uniform(1.0, 16.0, shape)).astype(np.float32)
    if name == "dt_bias":
        return np.log(np.expm1(rng.uniform(1e-3, 0.1, shape))).astype(np.float32)
    return 0.02 * a  # linears, the embedding, conv_b


def _numpy_params(j_model, seed=0):
    shapes = jax.eval_shape(j_model.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    leaves, expect = [], {}
    for path, sds in flat:
        where = _leaf_path(path)
        leaves.append(_draw(where, sds.shape, rng).astype(sds.dtype))
        expect[where] = sds.shape
    return jax.tree_util.tree_unflatten(treedef, leaves), expect


def _both(seed=0, **over):
    j_cfg, cfg = _cfgs(**over)
    j_model = j_build_model(j_cfg)
    np_params, expect = _numpy_params(j_model, seed)
    model = build_model(cfg, device="cpu")
    return (j_model, jax.tree_util.tree_map(jnp.asarray, np_params), model,
            params_from_numpy(np_params, device="cpu", expect=expect))


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape, dtype=np.int32)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, path + (key,)).items()}
    return {"/".join(path): tree}


def test_model_init_draws_the_jax_shapes_and_scales():
    """The port's own init: the JAX tree's shapes and dtypes (Mamba blocks
    stacked [groups, per_group, ...], one shared attention block), the
    deterministic leaves equal to JAX's (``A_log`` within 1e-6 relative, as
    in test_torch_mamba2.py), and the JAX scales."""
    j_cfg, cfg = _cfgs(d_model=256, d_ff=512, ssm_state=64)
    j_params = j_build_model(j_cfg).init(jax.random.PRNGKey(0))
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    flat_j = {_leaf_path(p): a for p, a in jax.tree_util.tree_flatten_with_path(j_params)[0]}
    flat_t = _flat(params)
    assert sorted(flat_t) == sorted(flat_j)
    for where, a in flat_j.items():
        assert tuple(flat_t[where].shape) == a.shape, where
        assert str(flat_t[where].dtype).split(".")[1] == str(a.dtype), where
    assert flat_t["mamba_blocks/in_proj/w"].shape[:2] == (2, 2)
    assert flat_t["shared_attn/attn/wq/w"].dim() == 2  # one set of weights, not stacked
    for where in ("mamba_blocks/D", "mamba_blocks/dt_bias", "mamba_blocks/conv_b",
                  "mamba_blocks/norm/scale", "shared_attn/attn_norm/scale", "final_norm/scale"):
        assert np.array_equal(flat_t[where].numpy(), np.asarray(flat_j[where])), where
    np.testing.assert_allclose(flat_t["mamba_blocks/A_log"].numpy(),
                               np.asarray(flat_j["mamba_blocks/A_log"]), rtol=1e-6, atol=0)
    small = 0.02 / (2 * cfg.n_layers) ** 0.5
    for where, want in [("embed/emb", 0.02), ("mamba_blocks/in_proj/w", 0.02),
                        ("mamba_blocks/conv_w", 0.2), ("mamba_blocks/out_proj/w", small),
                        ("shared_attn/attn/wq/w", 0.02), ("shared_attn/attn/wo/w", small),
                        ("shared_attn/mlp/w_down/w", small)]:
        assert abs(flat_t[where].std().item() / want - 1) < 0.05, where
        assert abs(float(np.std(flat_j[where])) / want - 1) < 0.05, where


@pytest.mark.parametrize("length", [16, 8])
def test_prefill_matches_jax(length):
    j_model, j_params, model, params = _both()
    cfg = model.cfg
    toks = _tokens(cfg, (B, length))
    want = np.asarray(j_model.prefill(j_params, {"tokens": jnp.asarray(toks)}))
    before = (ssd_scan_cuda.launches, decode_attn_cuda.launches)
    got = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.array_equal(got.argmax(-1).numpy(), want.argmax(-1))
    assert (ssd_scan_cuda.launches, decode_attn_cuda.launches) == before


def test_decode_steps_match_jax():
    j_model, j_params, model, params = _both(seed=3)
    cfg = model.cfg
    toks = _tokens(cfg, (B, STEPS), seed=4)
    j_cache = j_model.init_cache(B, L)
    cache = model.init_cache(B, L)
    assert sorted(cache) == sorted(j_cache)
    for name in cache:
        assert cache[name].shape == j_cache[name].shape, name
        assert str(cache[name].dtype).split(".")[1] == str(j_cache[name].dtype), name
    j_step = jax.jit(j_model.decode_step)
    before = (ssd_scan_cuda.launches, decode_attn_cuda.launches)
    for i in range(STEPS):
        want, j_cache = j_step(j_params, jnp.asarray(toks[:, i]), j_cache, jnp.int32(i))
        got, cache = model.decode_step(params, torch.from_numpy(toks[:, i]), cache, i)
        want = np.asarray(want)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        assert np.array_equal(got.argmax(-1).numpy(), want.argmax(-1)), i
    # every site's KV cache and every block's state were carried like JAX's
    for name in cache:
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(j_cache[name]), **TOL)
    assert not cache["attn_k"][:, :, STEPS:].any()
    assert (ssd_scan_cuda.launches, decode_attn_cuda.launches) == before


def test_sites_and_blocks_keep_their_own_state():
    """The shared block's two sites write their own KV caches, and every
    Mamba block its own state: no cache tensor is a broadcast view, and
    after one step no two sites' keys and no two blocks' states are equal
    (a cache whose blocks aliased one state would make them so)."""
    _, _, model, params = _both(seed=5)
    cache = model.init_cache(B, L)
    for name, t in cache.items():
        assert 0 not in t.stride() and t.is_contiguous(), name
    _, cache = model.decode_step(params, torch.from_numpy(_tokens(model.cfg, (B,), seed=6)),
                                 cache, 0)
    k0, k1 = cache["attn_k"][:, :, 0]
    assert k0.abs().max() > 0 and not torch.allclose(k0, k1)
    assert not torch.allclose(cache["attn_v"][0, :, 0], cache["attn_v"][1, :, 0])
    for name in ("ssm", "conv"):
        states = cache[name].flatten(0, 1)
        assert states.abs().amax(dim=tuple(range(1, states.dim()))).min() > 0, name
        for a in range(len(states)):
            for b in range(a):
                assert not torch.allclose(states[a], states[b]), (name, a, b)


def test_serve_run_matches_jax_serve_run(monkeypatch):
    """``serve.run(..., device="cpu")`` against the JAX ``serve.run`` (greedy
    from token 0, the reduced model), both entry points given the same
    numpy-drawn weights in place of their own random init."""
    j_cfg = j_get_config(ARCH).reduced(dtype="float32")
    j_model = j_build_model(j_cfg)
    np_params, expect = _numpy_params(j_model, seed=2)
    j_params = jax.tree_util.tree_map(jnp.asarray, np_params)
    params = params_from_numpy(np_params, device="cpu", expect=expect)
    monkeypatch.setattr(j_serve, "build_model", lambda cfg: dataclasses.replace(
        j_build_model(cfg), init=lambda key: j_params))
    monkeypatch.setattr(serve, "build_model", lambda cfg, device: dataclasses.replace(
        build_model(cfg, device), init=lambda gen: params))
    want = np.asarray(j_serve.run(ARCH, tokens=STEPS, batch=B, ctx=L))
    before = (ssd_scan_cuda.launches, decode_attn_cuda.launches)
    got = serve.run(ARCH, tokens=STEPS, batch=B, ctx=L, device="cpu")
    assert got.shape == (B, STEPS) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert (ssd_scan_cuda.launches, decode_attn_cuda.launches) == before


def test_serve_run_entry_point_on_the_cpu():
    model, _ = serve.load(ARCH, reduced=True, device="cpu")
    assert model.cfg.family == "hybrid"
    seq = serve.run(ARCH, tokens=4, batch=3, ctx=8, reduced=True, device="cpu")
    assert seq.shape == (3, 4) and bool(((seq >= 0) & (seq < 512)).all())


@pytest.mark.parametrize("length", [4, 12])
def test_prefill_equals_its_own_decode(length):
    """The JAX package's cross-path check (test_decode_matches_train_forward)
    on the port alone: the prefill's last logits (SSD scan and flash
    attention) equal the decode path's (recurrent update and cached
    attention) after the same tokens: one chunk, and three."""
    _, _, model, params = _both(seed=7)
    toks = torch.from_numpy(_tokens(model.cfg, (B, length), seed=8))
    want = model.prefill(params, {"tokens": toks})
    cache = model.init_cache(B, length)
    for i in range(length):
        got, cache = model.decode_step(params, toks[:, i], cache, i)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
