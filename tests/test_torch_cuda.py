"""Tests of the torch port that need a CUDA card (marker ``cuda``).

They skip where ``torch.cuda.is_available()`` is false, deciding inside
each test.  This file imports neither jax nor the JAX package, so it also
runs on a machine that has only torch:

    python -m pytest -m cuda tests/test_torch_cuda.py

* the s2d-conv kernel (``csrc/s2d_conv.cu``) against its plain version,
  in f32 and bf16, with the smoke run's tolerances, at the
  ``tests/test_kernels.py`` shapes, the 9 GEMM shapes of the main path's
  variant layers, ragged and unaligned rows, and every split of the
  contraction (1 to 8 blocks a cluster);
* both kernels bit-identical over two calls and under CUDA-graph replay
  (the cluster merges sum in a fixed order);
* the decode-attention kernel (``csrc/decode_attn.cu``) against its plain
  version, in f32 (``atol 1e-5, rtol 1e-4``: another summation order)
  and bf16 (``2e-2 * max|ref|``: the plain version rounds the softmax
  weights to bf16), at the ``tests/test_kernels.py`` shapes, the serving
  path's shape, a ragged cache length, every split of a row's cache (1 to
  8 blocks a cluster), per-row valid lengths from 0, and gemma-7b's head
  shape (Dh = 256, one query head per KV head); serving goes through the
  kernel;
* the SSD-scan kernel (``csrc/ssd_scan.cu``) against the oracle
  ``ssd_naive`` (f32, ``tests/test_kernels.py``'s rel < 1e-5) and the
  plain ``ssd_chunked`` (bf16 output: 2e-2 * max|ref|) at the
  ``tests/test_kernels.py`` shapes, one chunk (L = Q), ragged rows, shapes
  with one buffer a copy ring, unaligned inputs and the prefill's shape (f32 1e-4), the model's dtypes (x, B, C bf16;
  log_a, dt f32), bit-identical repeats and CUDA-graph replay (the C Bᵀ
  workspace allocated under capture), the wrapper's rejections, and a
  reduced mamba2 prefill through the kernel, one call per layer;
* ``simulate_batch`` on the card against the host SoA engine;
* the device Terastal round (``core/scheduler_torch.terastal_round``, one
  CUDA graph per bucket) bit-equal to the same ops run eagerly on the card
  and on the host, for every backfill mode, and the SoA engine with every
  block round on it fingerprint-equal to the Python round; Algorithm 1
  (``core/budget_torch``) on the card equal to the host.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

SHAPES = [  # tests/test_kernels.py, plus ragged ones and a main-path one
    (2, 8, 8, 16, 32, 2), (1, 16, 16, 64, 64, 2), (2, 12, 12, 36, 72, 3),
    (1, 8, 8, 256, 128, 2), (1, 4, 4, 512, 512, 2), (3, 5, 7, 20, 12, 2),
    (1, 28, 28, 256, 1024, 2),
    (2, 5, 7, 4, 3, 1),  # Cv = 4, Kv = 3: bf16 rows of 8 bytes
    (1, 9, 11, 40, 24, 1),  # whole 16-byte rows, ragged in every dimension
]
# (M, Cv, Kv) of the 20 pointwise variant layers the multicam_heavy @ 6k_1ws2os
# plans select (core/variant_exec.pointwise_variants), at B=1; all have g = 2
MAIN_GEMMS = [
    (3136, 64, 256), (3136, 128, 256), (3136, 256, 64), (3136, 256, 128),
    (784, 128, 512), (784, 256, 512), (784, 512, 128), (784, 96, 384), (784, 384, 96),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.parametrize("B,H,W,C,K,g", SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_kernel_matches_plain_version(card, B, H, W, C, K, g, dtype, tol):
    from repro_torch.kernels.s2d_conv.kernel import s2d_conv_cuda
    from repro_torch.kernels.s2d_conv.ops import s2d_variant_conv
    from repro_torch.kernels.s2d_conv.ref import s2d_conv_ref

    rng = np.random.default_rng(C + K)
    x = torch.from_numpy(rng.standard_normal((B, H, W, C), dtype=np.float32)).to(card, dtype)
    w = torch.from_numpy(rng.standard_normal((C // g**2, K // g**2),
                                             dtype=np.float32)).to(card, dtype)
    before = s2d_conv_cuda.launches
    got = s2d_variant_conv(x, w, g)
    assert s2d_conv_cuda.launches == before + 1  # a CUDA tensor launches the kernel
    ref = s2d_conv_ref(x, w, g)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == dtype
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item()


def _s2d_inputs(card, M, Cv, Kv, dtype, seed):
    """x [1, H, W, 4 Cv] and w [Cv, Kv] for g = 2, H * W * 4 = M."""
    side = int(round((M // 4) ** 0.5))
    assert side * side * 4 == M
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, side, side, 4 * Cv), dtype=np.float32)
    w = rng.standard_normal((Cv, Kv), dtype=np.float32) / np.sqrt(Cv, dtype=np.float32)
    return torch.from_numpy(x).to(card, dtype), torch.from_numpy(w).to(card, dtype)


@pytest.mark.parametrize("M,Cv,Kv", MAIN_GEMMS)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_kernel_at_the_main_path_shapes(card, M, Cv, Kv, dtype, tol):
    from repro_torch.kernels.s2d_conv.kernel import s2d_conv_cuda
    from repro_torch.kernels.s2d_conv.ref import s2d_conv_ref

    x, w = _s2d_inputs(card, M, Cv, Kv, dtype, M + Cv + Kv)
    got = s2d_conv_cuda(x, w, 2)
    ref = s2d_conv_ref(x, w, 2)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == dtype
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item()


@pytest.mark.parametrize("split", range(1, 9))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_kernel_takes_every_split_of_the_contraction(card, split, dtype, tol):
    """A cluster of 1 to 8 blocks per tile, each over its run of slabs
    (some runs empty: 784 x 96 has 3 f32 slabs, 2 bf16 ones)."""
    from repro_torch.kernels.s2d_conv.kernel import s2d_conv_cuda
    from repro_torch.kernels.s2d_conv.ref import s2d_conv_ref

    for M, Cv, Kv in ((784, 512, 128), (784, 96, 384)):
        x, w = _s2d_inputs(card, M, Cv, Kv, dtype, split)
        got = s2d_conv_cuda(x, w, 2, split=split)
        ref = s2d_conv_ref(x, w, 2)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= tol * ref.float().abs().max().item()


def _replayed(fn):
    """``fn()`` captured in a CUDA graph and replayed three times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_is_deterministic_and_replays_in_a_graph(card, dtype):
    """Two calls bit-identical, and a CUDA-graph replay equal to an eager
    call, where the blocks of a cluster sum each tile's partials."""
    from repro_torch.kernels.s2d_conv.kernel import plan_s2d, s2d_conv_cuda

    M, Cv, Kv = 784, 512, 128
    n_sm = torch.cuda.get_device_properties(card).multi_processor_count
    assert plan_s2d(M, Cv, Kv, dtype, n_sm).split > 1
    x, w = _s2d_inputs(card, M, Cv, Kv, dtype, 3)
    first = s2d_conv_cuda(x, w, 2)
    second = s2d_conv_cuda(x, w, 2)
    replayed = _replayed(lambda: s2d_conv_cuda(x, w, 2))
    assert torch.equal(first, second)
    assert torch.equal(replayed, first)


def test_kernel_wrapper_rejects_what_it_does_not_take(card):
    from repro_torch.kernels.s2d_conv.kernel import s2d_conv_cuda

    x = torch.zeros((1, 4, 4, 16), device=card)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        s2d_conv_cuda(x.half(), torch.zeros((4, 4), device=card).half(), 2)
    with pytest.raises(ValueError, match="C/g"):
        s2d_conv_cuda(x, torch.zeros((3, 4), device=card), 2)
    with pytest.raises(ValueError, match="contiguous"):
        s2d_conv_cuda(x.transpose(1, 2), torch.zeros((4, 4), device=card), 2)
    with pytest.raises(ValueError, match="split"):
        s2d_conv_cuda(x, torch.zeros((4, 4), device=card), 2, split=9)


def test_argmin_takes_the_first_minimum_on_the_card(card):
    """The batch engine's tie-breaks (rid order, first-min ascending k)
    rest on argmin returning the first of equal minima, also when the
    reduction is split across threads."""
    x = torch.ones((64, 8192), dtype=torch.float64, device=card)
    cols = torch.arange(64, device=card) * 97 % 8192
    x[torch.arange(64, device=card), cols] = 0.0
    x[torch.arange(64, device=card), cols + 5] = 0.0
    x[:, -1] = 0.0
    assert torch.equal(x.argmin(1), cols)
    assert torch.equal(torch.where(x < 0.5, 0.0, torch.inf).argmin(1), cols)


def test_batch_engine_on_the_card_matches_host_soa(card):
    from repro_torch.core import SATURATION_SCENARIOS, make_scheduler, simulate, simulate_batch
    from repro_torch.costmodel.maestro import PLATFORMS

    plans, tasks = SATURATION_SCENARIOS["saturation_3x"].plans(PLATFORMS["4k_1ws2os"])
    got = simulate_batch(plans, tasks, 0.05, make_scheduler("terastal"), [0, 1],
                         device=card)
    for s, res in zip([0, 1], got):
        want = simulate(plans, tasks, 0.05, make_scheduler("terastal"), seed=s,
                        engine="soa")
        assert res.fingerprint() == want.fingerprint()


DECODE_SHAPES = [  # (B, L, H, Hkv, Dh, pos): tests/test_kernels.py, serving, ragged
    (2, 64, 8, 2, 16, 63), (1, 128, 4, 4, 32, 80), (3, 256, 16, 8, 64, 255),
    (1, 64, 8, 1, 128, 10), (8, 2048, 32, 8, 64, 255), (8, 2048, 32, 8, 64, 2047),
    (2, 77, 16, 2, 32, 76), (2, 100, 8, 8, 128, 0),
    (33, 40, 16, 8, 32, 39),  # B * Hkv fills the card: one block per row
    (1, 1024, 8, 1, 128, 1000),  # a cluster of 8 blocks shares one row's cache
    (2, 300, 16, 16, 256, 299), (8, 2048, 16, 16, 256, 2047),  # gemma-7b's heads
]


def _decode_inputs(card, B, L, H, Hkv, Dh, dtype, seed):
    rng = np.random.default_rng(seed)
    draw = [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, 1, H, Dh), (B, L, Hkv, Dh), (B, L, Hkv, Dh))]
    return [torch.from_numpy(a).to(card, dtype) for a in draw]


def _close(got, ref, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-4)
    else:
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= 2e-2 * ref.float().abs().max().item()


@pytest.mark.parametrize("B,L,H,Hkv,Dh,pos", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain_version(card, B, L, H, Hkv, Dh, pos, dtype):
    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
    from repro_torch.kernels.decode_attn.ops import gqa_decode_attention
    from repro_torch.kernels.decode_attn.ref import decode_attention

    q, k, v = _decode_inputs(card, B, L, H, Hkv, Dh, dtype, L + Dh)
    before = decode_attn_cuda.launches
    got = gqa_decode_attention(q, k, v, pos)
    assert decode_attn_cuda.launches == before + 1  # a CUDA tensor launches the kernel
    ref = decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == dtype
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_reads_each_rows_own_valid_length(card, dtype):
    """Per-row ``valid_len`` (the Pallas kernel's ``[B]`` lengths), from 0:
    each row equals the plain version at its own position, a row with no
    valid position gives 0, and what lies beyond a row's length is never
    read, for every split of the cache."""
    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
    from repro_torch.kernels.decode_attn.ref import decode_attention

    B, L, H, Hkv, Dh = 5, 300, 16, 4, 64
    q, k, v = _decode_inputs(card, B, L, H, Hkv, Dh, dtype, 1)
    lengths = [0, 1, 18, 256, 300]
    valid = torch.tensor(lengths, dtype=torch.int32, device=card)
    k2, v2 = k.clone(), v.clone()
    for b, n in enumerate(lengths):
        k2[b, n:] = float("nan")
        v2[b, n:] = float("nan")
    for splits in range(1, 9):
        got = decode_attn_cuda(q[:, 0], k, v, valid, splits=splits)
        got2 = decode_attn_cuda(q[:, 0], k2, v2, valid, splits=splits)
        torch.cuda.synchronize()
        assert torch.equal(got, got2)
        assert not bool(got[0].any())
        for b, n in enumerate(lengths[1:], 1):
            want = decode_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1], n - 1)
            _close(got[b:b + 1, None], want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_is_deterministic_and_replays_in_a_graph(card, dtype):
    """Two calls bit-identical, and a CUDA-graph replay equal to an eager
    call, at the serving shape where a cluster of blocks merges each
    (b, kv head)'s cache."""
    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda, plan_splits

    B, L, H, Hkv, Dh = 8, 2048, 32, 8, 64
    n_sm = torch.cuda.get_device_properties(card).multi_processor_count
    assert plan_splits(B, Hkv, L, 2 * Dh * torch.finfo(dtype).bits // 8, n_sm) > 1
    q, k, v = _decode_inputs(card, B, L, H, Hkv, Dh, dtype, 4)
    valid = torch.full((B,), 1500, dtype=torch.int32, device=card)
    first = decode_attn_cuda(q[:, 0], k, v, valid)
    second = decode_attn_cuda(q[:, 0], k, v, valid)
    replayed = _replayed(lambda: decode_attn_cuda(q[:, 0], k, v, valid))
    assert torch.equal(first, second)
    assert torch.equal(replayed, first)


def test_decode_kernel_wrapper_rejects_what_it_does_not_take(card):
    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda

    q = torch.zeros((1, 8, 64), device=card)
    k = torch.zeros((1, 16, 2, 64), device=card)
    valid = torch.ones((1,), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        decode_attn_cuda(q.half(), k.half(), k.half(), valid)
    with pytest.raises(ValueError, match="head dims"):
        decode_attn_cuda(torch.zeros((1, 8, 48), device=card),
                         torch.zeros((1, 16, 2, 48), device=card),
                         torch.zeros((1, 16, 2, 48), device=card), valid)
    with pytest.raises(ValueError, match="groups"):
        decode_attn_cuda(torch.zeros((1, 32, 64), device=card), k[:, :, :1].contiguous(),
                         k[:, :, :1].contiguous(), valid)
    with pytest.raises(ValueError, match="int32"):
        decode_attn_cuda(q, k, k, valid.long())
    strided = torch.zeros((1, 2, 16, 64), device=card).transpose(1, 2)  # [1, 16, 2, 64]
    with pytest.raises(ValueError, match="contiguous"):
        decode_attn_cuda(q, strided, strided, valid)
    with pytest.raises(ValueError, match="splits"):
        decode_attn_cuda(q, k, k, valid, splits=0)


def test_serve_on_the_card_goes_through_the_kernel(card):
    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
    from repro_torch.launch import serve

    model, params = serve.load("llama3.2-1b", reduced=True)
    assert model.device.type == "cuda"
    before = decode_attn_cuda.launches
    seq = serve.decode(model, params, tokens=5, batch=2, ctx=8)
    assert decode_attn_cuda.launches == before + 5 * model.cfg.n_layers
    assert seq.shape == (2, 5) and seq.device.type == "cuda"


SSD_SHAPES = [  # (Bt, L, H, P, N, Q): tests/test_kernels.py, the reduced model, one chunk
    (2, 64, 4, 8, 16, 16), (1, 128, 2, 64, 128, 32), (2, 32, 8, 16, 8, 32),
    (1, 64, 1, 128, 64, 64), (1, 64, 2, 16, 8, 16), (2, 32, 8, 32, 16, 4),
    (2, 512, 4, 64, 128, 256), (1, 96, 3, 32, 16, 256),
    (2, 256, 4, 64, 128, 256),  # L = Q: one chunk of the prefill's widths
    (1, 30, 2, 16, 12, 6),  # rows of B, C and G that are not whole 16-byte chunks
    (2, 512, 2, 64, 224, 256), (1, 384, 3, 128, 128, 192),  # one buffer a copy ring
]


def _ssd_inputs(card, Bt, L, H, Pd, N, seed):
    """tests/test_kernels.py's distributions, drawn with numpy, in f32."""
    rng = np.random.default_rng(seed)
    f = np.float32
    draw = [rng.standard_normal((Bt, L, H, Pd), dtype=f),
            -np.abs(rng.standard_normal((Bt, L, H), dtype=f)) * 0.3,
            rng.standard_normal((Bt, L, N), dtype=f), rng.standard_normal((Bt, L, N), dtype=f),
            np.logaddexp(rng.standard_normal((Bt, L, H), dtype=f), f(0))]
    return [torch.from_numpy(np.asarray(a, dtype=f)).to(card) for a in draw]


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / (ref.float().abs().max() + 1e-9)).item()


@pytest.mark.parametrize("Bt,L,H,Pd,N,Q", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain_version(card, Bt, L, H, Pd, N, Q, dtype):
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_naive

    x, la, B, C, dt = _ssd_inputs(card, Bt, L, H, Pd, N, L + N)
    x, B, C = x.to(dtype), B.to(dtype), C.to(dtype)  # log_a and dt stay f32, as in the model
    before = ssd_scan_cuda.launches
    got = ssd_scan(x, la, B, C, dt, Q)
    assert ssd_scan_cuda.launches == before + 1  # a CUDA tensor launches the kernel
    plain = ssd_chunked(x, la, B, C, dt, Q)
    torch.cuda.synchronize()
    assert got.shape == plain.shape and got.dtype == dtype
    assert bool(torch.isfinite(got.float()).all())
    if dtype == torch.float32:
        assert _rel(got, ssd_naive(x, la, B, C, dt)) < 1e-5
        assert _rel(got, plain) < 1e-5
    else:
        assert _rel(got, plain) < 2e-2


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_ssd_kernel_at_the_prefill_shape(card, dtype, tol):
    """mamba2-1.3b's prefill (Bt=8, L=4096, H=64, P=64, N=128, Q=256)
    against the plain version, with chip_smoke.py's tolerances (f32 1e-4:
    the cumsum of 256 log-decays taken in another order)."""
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    x, la, B, C, dt = _ssd_inputs(card, 8, 4096, 64, 64, 128, 5)
    x, B, C = x.to(dtype), B.to(dtype), C.to(dtype)
    got = ssd_scan_cuda(x, la, B, C, dt, 256)
    plain = ssd_chunked(x, la, B, C, dt, 256)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    assert _rel(got, plain) < tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_takes_inputs_at_unaligned_addresses(card, dtype):
    """x, B and C one element into their buffers (contiguous, but not on a
    16-byte boundary): the kernel loads them element by element."""
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    def unaligned(t):
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=card)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    x, la, B, C, dt = _ssd_inputs(card, 2, 128, 4, 32, 16, 11)
    x, B, C = (unaligned(t) for t in (x, B, C))
    assert x.data_ptr() % 16 and B.data_ptr() % 16 and C.data_ptr() % 16
    got = ssd_scan_cuda(x, la, B, C, dt, 64)
    plain = ssd_chunked(x, la, B, C, dt, 64)
    torch.cuda.synchronize()
    assert _rel(got, plain) < (1e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_is_deterministic_and_replays_in_a_graph(card, dtype):
    """Two calls bit-identical, and a CUDA-graph replay equal to an eager
    call: the C Bᵀ workspace is allocated inside the captured call."""
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda

    x, la, B, C, dt = _ssd_inputs(card, 2, 512, 4, 64, 128, 9)
    x, B, C = x.to(dtype), B.to(dtype), C.to(dtype)
    first = ssd_scan_cuda(x, la, B, C, dt, 256)
    second = ssd_scan_cuda(x, la, B, C, dt, 256)
    replayed = _replayed(lambda: ssd_scan_cuda(x, la, B, C, dt, 256))
    assert torch.equal(first, second)
    assert torch.equal(replayed, first)


def test_ssd_kernel_takes_all_five_inputs_in_bf16(card):
    """tests/test_kernels.py::test_ssd_scan_dtypes: the wrapper casts log_a
    and dt to f32; rel < 0.15 against the oracle."""
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_naive

    ins = [t.to(torch.bfloat16) for t in _ssd_inputs(card, 1, 64, 2, 16, 8, 7)]
    got = ssd_scan_cuda(*ins, 16)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert _rel(got, ssd_naive(*ins)) < 0.15


def test_ssd_kernel_wrapper_rejects_what_it_does_not_take(card):
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda

    x, la, B, C, dt = _ssd_inputs(card, 1, 32, 2, 16, 8, 1)
    before = ssd_scan_cuda.launches
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ssd_scan_cuda(x.half(), la, B.half(), C.half(), dt, 16)
    with pytest.raises(ValueError, match="one dtype"):
        ssd_scan_cuda(x, la, B.bfloat16(), C, dt, 16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_scan_cuda(x, la, B, C, dt, 12)
    with pytest.raises(ValueError, match="do not match"):
        ssd_scan_cuda(x, la[:, :16], B, C, dt, 16)
    with pytest.raises(ValueError, match="head dims"):
        ssd_scan_cuda(torch.zeros((1, 32, 2, 48), device=card), la, B, C, dt, 16)
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros((1, 256, 1, 128), device=card)
        bc = torch.zeros((1, 256, 128), device=card)
        f = torch.zeros((1, 256, 1), device=card)
        ssd_scan_cuda(big, f, bc, bc, f, 256)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan_cuda(x.transpose(2, 3).contiguous().transpose(2, 3), la, B, C, dt, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(x.cpu(), la, B, C, dt, 16)
    assert ssd_scan_cuda.launches == before


def test_mamba2_prefill_on_the_card_goes_through_the_kernel(card):
    """A reduced mamba2 (f32) prefills on the card with one kernel launch per
    layer, and its logits equal the same weights' prefill on the CPU
    (tests/test_model_consistency.py's atol 2e-4, rtol 2e-3)."""
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.launch import serve
    from repro_torch.models.model_api import build_model

    model, params = serve.load("mamba2-1.3b", reduced=True)
    assert model.device.type == "cuda"
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (2, 4 * model.cfg.ssm_chunk), dtype=np.int32))
    before = ssd_scan_cuda.launches
    got = model.prefill(params, {"tokens": toks.to(card)})
    assert ssd_scan_cuda.launches == before + model.cfg.n_layers
    host = build_model(model.cfg, device="cpu")
    want = host.prefill(_to_cpu(params), {"tokens": toks})
    torch.testing.assert_close(got.cpu(), want, atol=2e-4, rtol=2e-3)
    seq = serve.decode(model, params, tokens=4, batch=2, ctx=8)
    assert ssd_scan_cuda.launches == before + model.cfg.n_layers  # decode: no kernel
    assert seq.shape == (2, 4)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


# ------------------------------------------------ the paper's device programs ---


def _round_state(rng, nj_pad, na):
    """A padded round state on a dyadic grid (exact ties), as numpy."""
    nj = int(rng.integers(1, nj_pad + 1))
    g = lambda lo, hi, size=None: rng.integers(lo, hi, size) / 256.0  # noqa: E731
    lat = g(1, 17, (nj, na))
    lat[rng.random((nj, na)) < 0.1] = np.inf
    lat[np.isinf(lat).all(axis=1), 0] = g(1, 17)
    state = dict(ready_mask=np.arange(nj_pad) < nj, vdl=np.zeros(nj_pad),
                 vdl_next=np.zeros(nj_pad), next_min=np.zeros(nj_pad),
                 lat=np.full((nj_pad, na), np.inf), lat_var=np.full((nj_pad, na), np.inf),
                 tau=1.0 + np.where(rng.random(na) < 0.5, 0.0, g(0, 17, na)),
                 idle_mask=rng.random(na) < 0.7)
    vdl = 1.0 + g(0, 33, nj)
    state["vdl"][:nj], state["vdl_next"][:nj], state["next_min"][:nj] = (
        vdl, vdl + g(1, 33, nj), g(0, 9, nj))
    state["lat"][:nj] = lat
    state["lat_var"][:nj] = np.where(rng.random((nj, 1)) < 0.5, np.inf,
                                     np.maximum(lat - g(0, 8, (nj, na)), 1 / 256))
    return state


@pytest.mark.parametrize("mode", ["ef", "paper", "positive"])
@pytest.mark.parametrize("nj_pad,na", [(4, 1), (16, 3), (64, 3), (128, 4)])
def test_device_round_graph_equals_eager_and_host(card, mode, nj_pad, na):
    from repro_torch.core import scheduler_torch as ST

    rng = np.random.default_rng(nj_pad * 10 + na)
    for _ in range(12):
        st = _round_state(rng, nj_pad, na)
        host = ST.terastal_round(ST.RoundInputs(*(torch.from_numpy(st[f]) for f in
                                                  ST.RoundInputs._fields)), mode=mode)
        inp = ST.RoundInputs(*(torch.from_numpy(st[f]).to(card) for f in ST.RoundInputs._fields))
        eager = ST._round(inp, mode)
        for _ in range(2):  # the capture, then a replay
            graph = ST.terastal_round(inp, mode=mode)
            for a, b, c in zip(graph, eager, host):
                assert a.device.type == "cuda" and a.dtype == c.dtype
                assert torch.equal(a.cpu(), b.cpu()) and torch.equal(a.cpu(), c)
    assert ((nj_pad, na), mode, inp.lat.device) in ST._GRAPHS


@pytest.mark.parametrize("mode", ["ef", "paper", "positive"])
def test_soa_device_round_on_the_card_equals_python(card, mode):
    from repro_torch.core import SATURATION_SCENARIOS, make_scheduler, simulate
    from repro_torch.core import scheduler_torch as ST
    from repro_torch.costmodel.maestro import PLATFORMS

    plans, tasks = SATURATION_SCENARIOS["saturation_5x"].plans(PLATFORMS["4k_1ws2os"])
    sched = make_scheduler(f"terastal(backfill_mode={mode})")
    before = ST.terastal_round.calls
    dev = simulate(plans, tasks, 0.3, sched, seed=0, engine="soa", round_kernel="jax")
    assert ST.terastal_round.calls - before > 3000
    py = simulate(plans, tasks, 0.3, sched, seed=0, engine="soa", round_kernel="python")
    assert dev.fingerprint() == py.fingerprint()


def test_budgets_on_the_card_equal_the_host(card):
    from repro_torch.core import SCENARIOS
    from repro_torch.core.budget import distribute_budgets
    from repro_torch.core.budget_torch import distribute_budgets_torch, pack_levels
    from repro_torch.costmodel.maestro import PLATFORMS

    plans, _ = SCENARIOS["multicam_heavy"].plans(PLATFORMS["6k_1ws2os"])
    for p in plans:
        packed, R = pack_levels(p.lat)
        got = distribute_budgets_torch(packed, R, p.deadline)
        host = distribute_budgets_torch(packed, R, p.deadline, device="cpu")
        ref = distribute_budgets(p.lat, p.deadline)
        assert got.budgets.device.type == "cuda"
        assert bool(got.feasible) == bool(host.feasible) == ref.feasible
        assert got.rho.cpu().tolist() == host.rho.tolist() == ref.rho.tolist()
        np.testing.assert_allclose(got.budgets.cpu().numpy(), ref.budgets, rtol=1e-5)
