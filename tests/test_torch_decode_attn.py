"""The port's decode attention and its building blocks against the JAX package's, on the CPU.

Inputs are drawn with numpy and handed to both packages.  The JAX side
runs its plain ``models.common.decode_attention`` and its Pallas kernel
in interpret mode, as ``tests/test_kernels.py`` does.  On the CPU the
port's ``gqa_decode_attention`` is its plain version, so the CUDA
kernel's launch counter must stay at 0 here; ``test_torch_cuda.py``
holds the kernel itself against the plain version on a card.

Tolerance: ``tests/test_kernels.py``'s f32 ``atol 1e-5, rtol 1e-4`` (the
same f32 products, summed in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.decode_attn.ops import gqa_decode_attention as j_gqa
from repro.models import common as J

from repro_torch.configs import get_config
from repro_torch.configs.registry import ARCHS
from repro_torch.kernels.decode_attn.kernel import SUPPORTED, decode_attn_cuda
from repro_torch.kernels.decode_attn.ops import gqa_decode_attention
from repro_torch.kernels.decode_attn.ref import decode_attention
from repro_torch.models import common as P

SHAPES = [  # (B, L, H, Hkv, Dh, pos, chunk): tests/test_kernels.py, then zamba2's heads
    (2, 64, 8, 2, 16, 63, 16),
    (1, 128, 4, 4, 32, 80, 32),
    (3, 256, 16, 8, 64, 255, 64),
    (1, 64, 8, 1, 128, 10, 64),
    (2, 96, 4, 4, 80, 70, 32),
]
TOL = dict(atol=1e-5, rtol=1e-4)


def _draw(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("B,L,H,Hkv,Dh,pos,chunk", SHAPES)
def test_decode_attention_matches_jax_plain_and_pallas(B, L, H, Hkv, Dh, pos, chunk):
    q, k, v = _draw(L + Dh, (B, 1, H, Dh), (B, L, Hkv, Dh), (B, L, Hkv, Dh))
    want_plain = np.asarray(J.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                               jnp.asarray(v), jnp.int32(pos)))
    want_pallas = np.asarray(j_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.int32(pos), backend="pallas", chunk=chunk,
                                   interpret=True))
    before = decode_attn_cuda.launches
    for got in (decode_attention(_t(q), _t(k), _t(v), pos),
                gqa_decode_attention(_t(q), _t(k), _t(v), pos)):
        assert got.shape == (B, 1, H, Dh) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want_plain, **TOL)
        np.testing.assert_allclose(got.numpy(), want_pallas, **TOL)
    assert decode_attn_cuda.launches == before  # CPU tensors never reach the kernel


def test_decode_attention_respects_valid_length():
    """Entries beyond pos must not influence the output (test_kernels.py:142-154)."""
    B, L, H, Hkv, Dh, pos = 1, 64, 4, 2, 16, 20
    q, k, v = _draw(3, (B, 1, H, Dh), (B, L, Hkv, Dh), (B, L, Hkv, Dh))
    k2, v2 = k.copy(), v.copy()
    k2[:, 30:] = 999.0
    v2[:, 30:] = -999.0
    out1 = gqa_decode_attention(_t(q), _t(k), _t(v), pos)
    out2 = gqa_decode_attention(_t(q), _t(k2), _t(v2), pos)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-6)
    want = np.asarray(j_gqa(jnp.asarray(q), jnp.asarray(k2), jnp.asarray(v2), jnp.int32(pos),
                            backend="pallas", chunk=16, interpret=True))
    np.testing.assert_allclose(out2.numpy(), want, **TOL)


def test_decode_attention_bf16_matches_jax_plain():
    """Both plain versions round the softmax weights to bf16 before P @ V;
    bf16 tolerance 2e-2 * max|ref| (bf16 rounding of p and of the output)."""
    B, L, H, Hkv, Dh, pos = 2, 64, 8, 2, 64, 40
    q, k, v = _draw(5, (B, 1, H, Dh), (B, L, Hkv, Dh), (B, L, Hkv, Dh))
    jb = [jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(J.decode_attention(*jb, jnp.int32(pos)).astype(jnp.float32))
    tb = [_t(a).to(torch.bfloat16) for a in (q, k, v)]
    got = gqa_decode_attention(*tb, pos)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("Lq,Lk,q_offset", [(8, 8, 0), (4, 12, 8)])
def test_naive_attention_matches_jax(Lq, Lk, q_offset):
    q, k, v = _draw(11, (2, Lq, 8, 32), (2, Lk, 2, 32), (2, Lk, 2, 32))
    want = np.asarray(J.naive_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        causal=True, q_offset=q_offset))
    got = P.naive_attention(_t(q), _t(k), _t(v), causal=True, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_norm_rope_glu_match_jax():
    x, scale, a, b = _draw(13, (2, 3, 4, 64), (64,), (2, 5, 96), (2, 5, 96))
    pos = np.array([[0, 7, 300], [5, 1, 2047]], dtype=np.int32)
    np.testing.assert_allclose(
        P.rmsnorm({"scale": _t(scale)}, _t(x), 1e-5).numpy(),
        np.asarray(J.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5)),
        atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(
        P.apply_rope(_t(x), _t(pos), 5e5).numpy(),
        np.asarray(J.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e5)),
        atol=1e-5, rtol=1e-4)
    for kind in ("swiglu", "geglu"):
        np.testing.assert_allclose(
            P.glu_activation(kind, _t(a), _t(b)).numpy(),
            np.asarray(J.glu_activation(kind, jnp.asarray(a), jnp.asarray(b))),
            atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError):
        P.glu_activation("relu", _t(a), _t(b))


def test_kernel_wrapper_never_takes_cpu_tensors():
    q, k = torch.zeros((1, 4, 16)), torch.zeros((1, 8, 2, 16))
    before = decode_attn_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        decode_attn_cuda(q, k, k, torch.ones((1,), dtype=torch.int32))
    assert decode_attn_cuda.launches == before


def test_decode_kernel_takes_every_attention_decoding_configs_head_shape():
    """Every config of the registry whose family decodes with attention
    (dense, vlm, moe, encdec: self- and cross-attention, and hybrid's
    shared block; ssm alone has none) decodes through the kernel on the
    card: its (head dim, query heads per KV head) is one the kernel takes."""
    served = [get_config(a) for a in ARCHS if get_config(a).family != "ssm"]
    assert {c.family for c in served} == {"dense", "vlm", "moe", "encdec", "hybrid"}
    assert len(served) == len(ARCHS) - 1
    shapes = {c.name: (c.resolved_head_dim, c.n_heads // c.n_kv_heads) for c in served}
    assert shapes["llava-next-34b"] == (128, 7)
    assert shapes["llama4-maverick-400b-a17b"] == (128, 5)
    assert shapes["qwen3-moe-235b-a22b"] == (128, 16)
    assert shapes["whisper-base"] == (64, 1)
    for name, shape in shapes.items():
        assert shape in SUPPORTED, name
