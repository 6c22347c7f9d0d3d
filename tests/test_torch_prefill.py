"""The port's dense prefill (flash attention, the dense block, ``Model.prefill``) against the JAX package's, on the CPU.

Inputs are drawn with numpy and handed to both packages.
``flash_attention`` is held against the JAX package's and against both
packages' ``naive_attention`` (the oracle), over GQA and MHA heads, causal
and not, lengths that are and are not multiples of the chunks, in f32
(``atol 2e-5``: the same f32 products, summed in another order) and bf16
(``2e-2 * max|ref|``: both versions round the softmax weights and the
output to bf16).  A reduced ``llama3.2-1b`` (``reduced(dtype="float32")``
with query and key chunks of 4, so that several chunks and a padded one
run) prefills in both packages with the very same weights (numpy draws
every leaf into the shapes of ``jax.eval_shape(model.init, key)``; the
port takes them through ``convert.params_from_numpy``): the dense block,
serial and parallel, and the last-position logits agree within
``tests/test_model_consistency.py``'s ``atol 2e-4, rtol 2e-3``, and the
port's prefill equals its own decode.  The JAX side runs with
``jax_enable_x64`` off: under x64 its ``flash_attention`` raises (the
reference's ``lax.scan`` carry comes back as f64), and another test module
in the same worker may have turned it on.  The prefill path launches no
kernel of the port.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.models import common as J
from repro.models import transformer as JT
from repro.models.model_api import build_model as j_build_model

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
from repro_torch.models import common as P
from repro_torch.models import transformer as PT
from repro_torch.models.model_api import build_model
from repro_torch.models.transformer import _layer

ARCH = "llama3.2-1b"
TOL = dict(atol=2e-4, rtol=2e-3)
FLASH = [  # (B, Lq, Lk, H, Hkv, Dh, q_chunk, k_chunk)
    (2, 32, 32, 8, 2, 16, 8, 16),  # GQA, lengths multiples of both chunks
    (2, 37, 37, 8, 2, 16, 8, 16),  # GQA, both padded
    (1, 64, 64, 4, 4, 32, 16, 32),  # MHA
    (2, 11, 11, 4, 4, 8, 4, 4),  # MHA, padded, chunks of 4
    (1, 20, 20, 6, 1, 16, 512, 1024),  # one chunk each (the chunks clip to the length)
    (2, 12, 20, 8, 4, 16, 8, 8),  # more keys than queries
]


@pytest.fixture(autouse=True)
def x64_off():
    with jax.enable_x64(False):
        yield


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Lq,Lk,H,Hkv,Dh,qc,kc", FLASH)
def test_flash_attention_matches_jax_and_the_oracles(B, Lq, Lk, H, Hkv, Dh, qc, kc, causal):
    q, k, v = _draw(Lq + 7 * Lk + Dh, (B, Lq, H, Dh), (B, Lk, Hkv, Dh), (B, Lk, Hkv, Dh))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(J.flash_attention(jq, jk, jv, causal=causal, q_chunk=qc, k_chunk=kc))
    j_naive = np.asarray(J.naive_attention(jq, jk, jv, causal=causal))
    got = P.flash_attention(_t(q), _t(k), _t(v), causal=causal, q_chunk=qc, k_chunk=kc)
    naive = P.naive_attention(_t(q), _t(k), _t(v), causal=causal)
    assert got.shape == (B, Lq, H, Dh) and got.dtype == torch.float32
    for ref in (want, j_naive, naive.numpy()):
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Lq,Lk,H,Hkv,Dh,qc,kc", [FLASH[1], FLASH[3]])
def test_flash_attention_bf16_matches_jax(B, Lq, Lk, H, Hkv, Dh, qc, kc, causal):
    q, k, v = _draw(3, (B, Lq, H, Dh), (B, Lk, Hkv, Dh), (B, Lk, Hkv, Dh))
    jb = [jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(J.flash_attention(*jb, causal=causal, q_chunk=qc, k_chunk=kc)
                      .astype(jnp.float32))
    tb = [_t(a).to(torch.bfloat16) for a in (q, k, v)]
    got = P.flash_attention(*tb, causal=causal, q_chunk=qc, k_chunk=kc)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= 2e-2 * np.abs(want).max()


def _leaf_path(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _cfgs(**over):
    over = dict(dtype="float32", attn_q_chunk=4, attn_k_chunk=4, **over)
    j_cfg = j_get_config(ARCH).reduced(**over)
    cfg = get_config(ARCH).reduced(**over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
    return j_cfg, cfg


def _both(seed=0, **over):
    """Both models with the same numpy-drawn weights: linears and the
    embedding ~ N(0, 0.02^2), norm scales 1 + N(0, 0.1^2)."""
    j_cfg, cfg = _cfgs(**over)
    j_model = j_build_model(j_cfg)
    shapes = jax.eval_shape(j_model.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    leaves, expect = [], {}
    for path, sds in flat:
        where = _leaf_path(path)
        a = rng.standard_normal(sds.shape, dtype=np.float32)
        leaves.append((1.0 + 0.1 * a if where.endswith("scale") else 0.02 * a).astype(sds.dtype))
        expect[where] = sds.shape
    np_params = jax.tree_util.tree_unflatten(treedef, leaves)
    model = build_model(cfg, device="cpu")
    return (j_model, jax.tree_util.tree_map(jnp.asarray, np_params), model,
            params_from_numpy(np_params, device="cpu", expect=expect))


@pytest.mark.parametrize("parallel_block", [False, True])
def test_dense_block_apply_matches_jax(parallel_block):
    j_model, j_params, model, params = _both(parallel_block=parallel_block)
    cfg = model.cfg
    B, L = 2, 10
    x = np.random.default_rng(3).standard_normal((B, L, cfg.d_model), dtype=np.float32)
    jpos = jnp.broadcast_to(jnp.arange(L)[None], (B, L))
    tpos = torch.arange(L).expand(B, L)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for i in range(cfg.n_layers):
        jp = jax.tree_util.tree_map(lambda a: a[i], j_params["blocks"])
        jx = JT.dense_block_apply(j_model.cfg, jp, jx, jpos)
        tx = PT.dense_block_apply(cfg, _layer(params["blocks"], i), tx, tpos)
        assert tx.dtype == torch.float32 and tx.shape == (B, L, cfg.d_model)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)


@pytest.mark.parametrize("length", [16, 13])
def test_prefill_matches_jax(length):
    j_model, j_params, model, params = _both(seed=1)
    cfg = model.cfg
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, length), dtype=np.int32)
    want = np.asarray(j_model.prefill(j_params, {"tokens": jnp.asarray(toks)}))
    before = decode_attn_cuda.launches
    got = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == (2, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.array_equal(got.argmax(-1).numpy(), want.argmax(-1))
    assert decode_attn_cuda.launches == before
    # the hidden states at every position, final norm included
    jh = JT.forward_hidden_dense(j_model.cfg, j_params, J.embed(j_params["embed"], toks),
                                 jnp.broadcast_to(jnp.arange(length)[None], (2, length)))
    th = PT.forward_hidden_dense(cfg, params, P.embed(params["embed"], torch.from_numpy(toks)),
                                 torch.arange(length).expand(2, length))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


@pytest.mark.parametrize("length", [4, 11])
def test_prefill_equals_its_own_decode(length):
    """The JAX package's cross-path check (test_decode_matches_train_forward)
    on the port alone: the flash-attention prefill's last logits equal the
    decode path's after the same tokens (one chunk, and a padded third)."""
    _, _, model, params = _both(seed=4)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, model.cfg.vocab_size, (2, length), dtype=np.int32))
    want = model.prefill(params, {"tokens": toks})
    cache = model.init_cache(2, length)
    for i in range(length):
        got, cache = model.decode_step(params, toks[:, i], cache, i)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
