"""The port's Mamba2 model (prefill and decode) against the JAX package's, on the CPU.

A reduced ``mamba2-1.3b`` (``reduced(dtype="float32")`` with
``ssm_chunk=4``, so that several chunks run, as
``tests/test_model_consistency.py`` does) runs in both packages with the
very same weights: numpy draws every leaf into the shapes of
``jax.eval_shape(model.init, key)``, the JAX side takes the arrays as
they are, and the port takes them through ``convert.params_from_numpy``
(stacked ``blocks``).  Both consume the same numpy-drawn tokens.
Tolerance: ``tests/test_model_consistency.py``'s ``atol 2e-4, rtol 2e-3``
on logits and block outputs, and equal greedy tokens.  The JAX side runs
with ``jax_enable_x64`` off (another test module in the same worker may
have turned it on).  On the CPU the SSD scan is the plain version, so
the kernel's launch counter stays at 0.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.models import mamba2 as J
from repro.models.model_api import build_model as j_build_model

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
from repro_torch.launch import serve
from repro_torch.models import mamba2 as P
from repro_torch.models.model_api import build_model
from repro_torch.models.transformer import _layer

ARCH = "mamba2-1.3b"
B, L, STEPS = 2, 16, 8
TOL = dict(atol=2e-4, rtol=2e-3)


@pytest.fixture(autouse=True)
def x64_off():
    with jax.enable_x64(False):
        yield


def _cfgs(**over):
    over = dict(dtype="float32", ssm_chunk=4, **over)
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
    if name == "scale":
        return 1.0 + 0.1 * a
    if name == "conv_w":
        return 0.2 * a
    if name == "A_log":
        return np.log(rng.uniform(1.0, 16.0, shape)).astype(np.float32)
    if name == "D":
        return 1.0 + 0.1 * a
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
    j_params = jax.tree_util.tree_map(jnp.asarray, np_params)
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(np_params, device="cpu", expect=expect)
    return j_model, j_params, model, params


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape, dtype=np.int32)


def test_block_apply_matches_jax_layer_by_layer():
    j_model, j_params, model, params = _both()
    cfg = model.cfg
    x = np.random.default_rng(3).standard_normal((B, L, cfg.d_model), dtype=np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    before = ssd_scan_cuda.launches
    for i in range(cfg.n_layers):
        jp = jax.tree_util.tree_map(lambda a: a[i], j_params["blocks"])
        jx = J.mamba_block_apply(j_model.cfg, jp, jx)
        tx = P.mamba_block_apply(cfg, _layer(params["blocks"], i), tx)
        assert tx.dtype == torch.float32 and tx.shape == (B, L, cfg.d_model)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    assert ssd_scan_cuda.launches == before


def test_prefill_and_decode_steps_match_jax():
    j_model, j_params, model, params = _both()
    cfg = model.cfg
    toks = _tokens(cfg, (B, L))
    want = np.asarray(j_model.prefill(j_params, {"tokens": jnp.asarray(toks)}))
    got = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    j_cache = j_model.init_cache(B, L)
    cache = model.init_cache(B, L)
    for name in ("conv", "ssm"):
        assert cache[name].shape == j_cache[name].shape
        assert str(cache[name].dtype).split(".")[1] == str(j_cache[name].dtype)
    j_step = jax.jit(j_model.decode_step)
    before = ssd_scan_cuda.launches
    for i in range(STEPS):
        want, j_cache = j_step(j_params, jnp.asarray(toks[:, i]), j_cache, jnp.int32(i))
        got, cache = model.decode_step(params, torch.from_numpy(toks[:, i]), cache, i)
        want = np.asarray(want)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        assert np.array_equal(got.argmax(-1).numpy(), want.argmax(-1)), i
    # the states were carried like JAX's
    np.testing.assert_allclose(cache["ssm"].numpy(), np.asarray(j_cache["ssm"]), **TOL)
    np.testing.assert_allclose(cache["conv"].numpy(), np.asarray(j_cache["conv"]), **TOL)
    assert ssd_scan_cuda.launches == before  # decode runs no kernel


@pytest.mark.parametrize("length", [4, 12])
def test_prefill_equals_its_own_decode(length):
    """The JAX package's cross-path check (test_decode_matches_train_forward)
    on the port alone: the chunked prefill's last logits equal the recurrent
    decode's after the same tokens (one chunk, and three)."""
    _, _, model, params = _both(seed=4)
    toks = torch.from_numpy(_tokens(model.cfg, (B, length), seed=5))
    want = model.prefill(params, {"tokens": toks})
    cache = model.init_cache(B, length)
    for i in range(length):
        got, cache = model.decode_step(params, toks[:, i], cache, i)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_serve_run_matches_jax_serve():
    """``serve.run`` on the CPU against the JAX serve loop (greedy from
    token 0), same weights (decode does not read ``ssm_chunk``)."""
    j_model, j_params, _, params = _both(seed=2)
    model, _ = serve.load(ARCH, reduced=True, device="cpu")
    assert model.cfg.family == "ssm"
    got = serve.decode(model, params, tokens=STEPS, batch=B, ctx=L)
    assert got.shape == (B, STEPS) and got.dtype == torch.int32
    j_cache = j_model.init_cache(B, L)
    j_step = jax.jit(j_model.decode_step)
    tok = jnp.zeros((B,), jnp.int32)
    for i in range(STEPS):
        logits, j_cache = j_step(j_params, tok, j_cache, jnp.int32(i))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        assert np.array_equal(got[:, i].numpy(), np.asarray(tok)), i
    seq = serve.run(ARCH, tokens=4, batch=3, ctx=8, reduced=True, device="cpu")
    assert seq.shape == (3, 4) and bool(((seq >= 0) & (seq < 512)).all())


def test_model_init_draws_the_jax_shapes_and_scales():
    """The port's own init: the JAX tree's shapes and dtypes, blocks stacked,
    the JAX scales, and the deterministic leaves: ``D`` and ``dt_bias``
    bit-equal, ``A_log`` within 1e-6 relative (XLA's f32 ``linspace`` and
    ``log`` are a few ulp off the correctly rounded values that the port
    takes)."""
    j_cfg, cfg = _cfgs(d_model=256, ssm_state=64)
    j_model = j_build_model(j_cfg)
    j_params = j_model.init(jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    flat_j = {_leaf_path(p): a for p, a in jax.tree_util.tree_flatten_with_path(j_params)[0]}
    flat_t = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            flat_t["/".join(path)] = node

    walk(params, ())
    assert sorted(flat_t) == sorted(flat_j)
    for where, a in flat_j.items():
        assert tuple(flat_t[where].shape) == a.shape, where
        assert str(flat_t[where].dtype).split(".")[1] == str(a.dtype), where
    for where in ("blocks/D", "blocks/dt_bias", "blocks/conv_b", "blocks/norm/scale",
                  "blocks/out_norm/scale", "final_norm/scale"):
        assert np.array_equal(flat_t[where].numpy(), np.asarray(flat_j[where])), where
    np.testing.assert_allclose(flat_t["blocks/A_log"].numpy(), np.asarray(flat_j["blocks/A_log"]),
                               rtol=1e-6, atol=0)
    small = 0.02 / (2 * cfg.n_layers) ** 0.5
    for where, want in [("embed/emb", 0.02), ("blocks/in_proj/w", 0.02),
                        ("blocks/conv_w", 0.2), ("blocks/out_proj/w", small)]:
        assert abs(flat_t[where].std().item() / want - 1) < 0.05, where


def test_softplus_agrees_with_jax():
    x = np.concatenate([np.linspace(-30, 30, 601, dtype=np.float32),
                        np.array([19.99, 20.0, 20.01, 50.0, -100.0], np.float32)])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = torch.nn.functional.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-37, rtol=2e-7)  # JAX flushes denormals
