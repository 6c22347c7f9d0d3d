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
  8 blocks a cluster), per-row valid lengths from 0, gemma-7b's head
  shape (Dh = 256, one query head per KV head), zamba2-2.7b's (Dh = 80,
  one query head per KV head, with a CUDA-graph replay), llama4-maverick's,
  llava-next-34b's and qwen3-moe's (Dh = 128, 5, 7 and 16 query heads per
  KV head, with CUDA-graph replays, and the 16 heads kept apart), and
  whisper-base's cross-attention (1500 valid positions); serving goes
  through the kernel, and so does an int8 KV cache (``kv_cache_quant``),
  decoding as on the CPU, with a planted wrong dequantisation scale read;
* the SSD-scan kernel (``csrc/ssd_scan.cu``) against the oracle
  ``ssd_naive`` (f32, ``tests/test_kernels.py``'s rel < 1e-5) and the
  plain ``ssd_chunked`` (bf16 output: 2e-2 * max|ref|) at the
  ``tests/test_kernels.py`` shapes, one chunk (L = Q), ragged rows, shapes
  with one buffer a copy ring, unaligned inputs and the prefill's shape (f32 1e-4), the model's dtypes (x, B, C bf16;
  log_a, dt f32), bit-identical repeats and CUDA-graph replay (the C Bᵀ
  workspace allocated under capture), the wrapper's rejections, and a
  reduced mamba2 prefill through the kernel, one call per layer; under
  grad, the kernel inside ``ops.SSDScan`` with the plain version's
  gradient, and a reduced mamba2 train step equal to the CPU's;
* the SSD backward kernel (``csrc/ssd_scan_bwd.cu``): its five gradients
  against ``ops.plain_grads`` on the same inputs and output gradient at
  the ``tests/test_kernels.py`` shapes, ragged rows, (p)'s training shape,
  zamba2-7b's (H 112, G 2) and nemotron's (G 8, Q 128): f32 within 1e-4 of
  max|ref|, bf16 x, B, C gradients within 4 bf16 ulps and the f32 log_a,
  dt ones within 1e-4; two planted faults (dS' not carried between chunks,
  dlog_a without its reverse cumsum), each built from a changed copy of the
  source, read outside those limits; a subset of ``needs``; one launch a
  backward and the forward's count unmoved; equal bits over two calls; the
  wrapper's refusals;
* the Mamba block's pass kernels (``csrc/mamba_passes.cu``) against the
  plain passes they replace, each kernel fed the plain passes' own inputs, in
  bf16 at mamba2-1.3b's and zamba2-2.7b's block widths, B in {1, 3} and L in
  {1, 3, 257, 4096}, within 4 bf16 ulps of max|ref| (the plain conv rounds
  each product and partial sum to bf16; the kernel sums in f32), dt and
  log_a in f32 to 2e-6 (the same f32 operations), and in f32 to 1e-5 of
  max|ref| (another summation order); against the block's f32 twin, the
  kernels' route no further than the plain route; a conv window shifted by a
  token read outside the limit; the wrappers' rejections; a reduced mamba2
  prefill on the fused route equal to the plain route's, with
  ``mamba_passes_cuda.launches`` up by n_layers a prefill and by 2 n_layers
  a training step (the forward and remat's recompute), ``backward_calls`` by
  n_layers;
* the passes' backward kernels, each Function's gradients of every input
  and leaf against ``torch.autograd.grad`` through the matching plain pass
  (``ref.rmsnorm``, ``conv_pass``, ``gate_pass``) on the same inputs and
  output gradient, at mamba2-1.3b's and zamba2-7b's block widths (one and
  two B/C groups), L in {1, 3, 257, 2048}: f32 within 1e-5 of max|ref|, bf16
  within PASS_BWD_ULPS bf16 ulps of max|ref|; two runs equal bit for bit; the
  conv's outputs' gradients a token late read outside the limit; a whole
  block (zamba2-7b's with an addend) and a reduced mamba2 remat-full train
  step against the plain passes on the card;
* B and C in groups: the SSD kernel with G groups against the plain
  ``ssd_chunked`` at small, ragged and zamba2-7b's prefill shape (collapsed
  groups read far outside), one group bit-equal to the shared-B/C call, the
  pass kernels at zamba2-7b's block (two groups) with the tolerances above,
  the wrappers refusing heads that are not whole groups; a tiny zamba2 of
  the port-only family prefilling on the card through both kernels, one
  shared-block call a site, equal to the plain passes and to the CPU;
* a reduced zamba2 (heads of 80) prefilling and decoding on the card
  through both kernels, equal to the CPU, and raising where the decode
  kernel refuses its head shape (no fallback); a reduced whisper, llava,
  llama4 and qwen3-moe at their families' head shapes, prefilling and
  decoding on the card, equal to the CPU, with one decode-kernel launch
  per attention site and step;
* ``simulate_batch`` on the card against the host SoA engine, fault-free
  and with a ``down`` window (the fault lane);
* the device Terastal round (``core/scheduler_torch.terastal_round``, one
  CUDA graph per bucket) bit-equal to the same ops run eagerly on the card
  and on the host, for every backfill mode, and the SoA engine with every
  block round on it fingerprint-equal to the Python round; Algorithm 1
  (``core/budget_torch``) on the card equal to the host;
* the prefill attention kernel (``csrc/flash_attn.cu``, bf16) against the
  plain ``common._flash_attention`` on the same inputs, causal and not,
  each output row (one query of one head) against its own max|ref|, within
  four bf16 ulps (P rounded against other running maxima), at zamba2-7b's
  site, every other head dim at 1, 4, 7 and 16 query heads a KV head,
  ragged lengths and whisper's cross shape; strided views of a fused
  projection; two planted faults, each built from a changed copy of the
  source, read far outside the tolerance: the causal skip one tile early,
  and the middle tile of keys left out of rows that read 32 tiles or more;
  ``flash_attn_cuda.launches`` up by the sites a prefill and not at all
  under grad; a tiny zamba2 through the kernel equal to the plain route;
  a float32 call through ``common.flash_attention`` on the plain route,
  bit for bit, with no launch; nemotron's attention shape (32 query heads
  over 2 KV heads of 128, B=8, L=4096);
* nemotron's dropless MoE layer (``models/moe_dropless``) at its published
  widths on 32,768 tokens: the grouped route (two ``torch._grouped_mm``
  calls) against the plain per-expert route on the card, the same bits on a
  second call, no host sync between the router and the combine (CUDA's sync
  debug mode set to raise), every route computed under a bias that sends
  every token to the same six experts; the SSD kernel and the pass kernels
  at its Mamba block (eight B/C groups, chunk 128); a tiny nemotron_h
  prefilling on the card through every kernel against the float32
  reference on the card's own routes;
* deepseek-v3's latent attention: the flash kernel at (192, 128) (v a view
  of W_kvb's output) at 16k on a slice of heads and at ragged lengths,
  against the plain route within the tolerance of the other head dims; a
  planted fault (V's map stepping heads by DQK) read far outside it; every
  (d, d) head dim the same bits as the kernel built for one head dim gave;
  its MoE layer on the benchmark's share (8 of 256 experts, top-8 over 8
  groups, SwiGLU) on the grouped route against the plain route, the routes
  to other experts zero, the held routes counted on the device and read by
  the benchmark driver's counters under the device run.py gives, no host
  sync; nemotron's grouped route the same bits as the former code's; a
  small deepseek_v3 prefilling through the kernel and the grouped route
  against the float32 reference.
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


def test_batch_engine_fault_lane_on_the_card_matches_host_soa(card):
    """The fault lane on the card: a ``down`` window that opens and closes
    inside the horizon, on the Table-II mix, lanes equal to the host SoA."""
    from repro_torch.core import SCENARIOS, make_scheduler, simulate, simulate_batch
    from repro_torch.costmodel.maestro import PLATFORMS

    spec = "down(acc=0,start=0.1,duration=0.2)"
    plans, tasks = SCENARIOS["multicam_heavy"].plans(PLATFORMS["6k_1ws2os"])
    for sched in ("edf", "terastal"):
        stats = {}
        got = simulate_batch(plans, tasks, 0.35, make_scheduler(sched), [0, 1], faults=spec,
                             device=card, stats=stats)
        for s, res in zip([0, 1], got):
            want = simulate(plans, tasks, 0.35, make_scheduler(sched), seed=s, faults=spec,
                            engine="soa")
            assert res.faulted_spans == want.faulted_spans == 1
            assert res.fingerprint() == want.fingerprint(), (sched, s)
        if sched == "edf":
            assert stats["evictions"] > 0


DECODE_SHAPES = [  # (B, L, H, Hkv, Dh, pos): tests/test_kernels.py, serving, ragged
    (2, 64, 8, 2, 16, 63), (1, 128, 4, 4, 32, 80), (3, 256, 16, 8, 64, 255),
    (1, 64, 8, 1, 128, 10), (8, 2048, 32, 8, 64, 255), (8, 2048, 32, 8, 64, 2047),
    (2, 77, 16, 2, 32, 76), (2, 100, 8, 8, 128, 0),
    (33, 40, 16, 8, 32, 39),  # B * Hkv fills the card: one block per row
    (1, 1024, 8, 1, 128, 1000),  # a cluster of 8 blocks shares one row's cache
    (2, 300, 16, 16, 256, 299), (8, 2048, 16, 16, 256, 2047),  # gemma-7b's heads
    (8, 2048, 32, 32, 80, 255), (8, 2048, 32, 32, 80, 2047), (2, 77, 4, 4, 80, 76),  # zamba2's
    (8, 2048, 40, 8, 128, 2047), (2, 77, 10, 2, 128, 76),  # llama4-maverick's heads (G 5)
    (8, 2048, 56, 8, 128, 2047), (2, 77, 14, 2, 128, 76),  # llava-next-34b's (G 7)
    (8, 2048, 64, 4, 128, 2047), (2, 77, 16, 1, 128, 76),  # qwen3-moe's (G 16)
    (3, 300, 32, 2, 128, 0),  # G 16, one valid position
    (8, 1500, 8, 8, 64, 1499), (8, 448, 8, 8, 64, 255),  # whisper-base's cross and self
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


@pytest.mark.parametrize("splits", [None, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_at_zamba2_heads_replays_in_a_graph(card, dtype, splits):
    """zamba2-2.7b's heads (Dh 80, one query head per KV head: five 16-byte
    vectors a thread in f32) at its serving shape: the planner's split and
    a cluster of 3, against the plain version, and a CUDA-graph replay
    bit-equal to an eager call."""
    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
    from repro_torch.kernels.decode_attn.ref import decode_attention

    B, L, H, Hkv, Dh, pos = 8, 2048, 32, 32, 80, 1499
    q, k, v = _decode_inputs(card, B, L, H, Hkv, Dh, dtype, 6)
    valid = torch.full((B,), pos + 1, dtype=torch.int32, device=card)
    first = decode_attn_cuda(q[:, 0], k, v, valid, splits=splits)
    replayed = _replayed(lambda: decode_attn_cuda(q[:, 0], k, v, valid, splits=splits))
    assert torch.equal(replayed, first)
    _close(first[:, None], decode_attention(q, k, v, pos), dtype)


@pytest.mark.parametrize("splits", [None, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv", [(40, 8), (56, 8), (64, 4)])
def test_decode_kernel_at_the_moe_and_vlm_heads_replays_in_a_graph(card, H, Hkv, dtype, splits):
    """llama4-maverick's (G 5), llava-next-34b's (G 7) and qwen3-moe's (G 16:
    heads 8..15 in the upper rows of the bf16 A operand) heads of 128 at the
    serving shape: the planner's split and a cluster of 3, against the plain
    version, and a CUDA-graph replay bit-equal to an eager call."""
    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
    from repro_torch.kernels.decode_attn.ref import decode_attention

    B, L, Dh, pos = 8, 4352, 128, 4150
    q, k, v = _decode_inputs(card, B, L, H, Hkv, Dh, dtype, H)
    valid = torch.full((B,), pos + 1, dtype=torch.int32, device=card)
    first = decode_attn_cuda(q[:, 0], k, v, valid, splits=splits)
    replayed = _replayed(lambda: decode_attn_cuda(q[:, 0], k, v, valid, splits=splits))
    assert torch.equal(replayed, first)
    _close(first[:, None], decode_attention(q, k, v, pos), dtype)


def test_decode_kernel_keeps_the_upper_heads_apart(card):
    """At G 16 each bf16 thread carries two heads (g and g + 8): give each
    of the 16 query heads of a KV head its own one-hot query over a cache
    whose values name their position, so that every head's output is the
    value of its own best position; a swap or a mix of the two halves
    shows."""
    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
    from repro_torch.kernels.decode_attn.ref import decode_attention

    B, L, H, Hkv, Dh = 2, 64, 32, 2, 128
    k = torch.zeros((B, L, Hkv, Dh), device=card)
    k[:, torch.arange(16), :, torch.arange(16)] = 30.0  # position t's key: dim t
    v = torch.arange(L, device=card, dtype=torch.float32)[None, :, None, None].expand(
        B, L, Hkv, Dh).contiguous()
    q = torch.zeros((B, 1, H, Dh), device=card)
    for h in range(H):
        q[:, 0, h, h % 16] = 30.0  # head h attends to position h mod 16 (weight ~1)
    for dtype in (torch.float32, torch.bfloat16):
        qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
        valid = torch.full((B,), L, dtype=torch.int32, device=card)
        got = decode_attn_cuda(qd[:, 0], kd, vd, valid).float()
        want = decode_attention(qd, kd, vd, L - 1)[:, 0].float()
        torch.cuda.synchronize()
        heads = torch.arange(H, device=card) % 16
        assert torch.allclose(got[:, :, 0], heads.float().expand(B, H), atol=0.05), dtype
        _close(got.to(dtype)[:, None], want.to(dtype)[:, None], dtype)


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


def test_int8_kv_cache_decodes_on_the_card_as_on_the_cpu(card, monkeypatch):
    """``kv_cache_quant`` on the card: a reduced llama3.2-1b (f32) decodes 8
    steps through the decode kernel, one launch per layer and step, with
    the int8 cache dequantised for it; every step's logits equal the same
    weights' on the CPU (atol 2e-4, rtol 2e-3) and the caches' int8 codes
    within one step of rounding.  A planted fault, the cache dequantised
    with 1/29 in place of 1/32, reads far outside (its excess over the
    limit at least 100 x atol)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
    from repro_torch.models import transformer
    from repro_torch.models.model_api import build_model

    cfg = get_config("llama3.2-1b").reduced(dtype="float32", kv_cache_quant=True)
    model, host = build_model(cfg), build_model(cfg, device="cpu")
    params = model.init(torch.Generator(device=card).manual_seed(0))
    host_params = _to_cpu(params)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8),
                                                              dtype=np.int32))

    def decode(m, p, dev):
        cache, out = m.init_cache(2, 8), []
        for i in range(8):
            logits, cache = m.decode_step(p, toks[:, i].to(dev), cache, i)
            out.append(logits.cpu())
        return torch.stack(out), cache

    before = decode_attn_cuda.launches
    got, cache = decode(model, params, card)
    assert decode_attn_cuda.launches == before + 8 * cfg.n_layers
    want, host_cache = decode(host, host_params, "cpu")
    assert cache["k"].dtype == torch.int8 and cache["k"].device.type == "cuda"
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-3)
    for name in ("k", "v"):
        assert (cache[name].cpu().int() - host_cache[name].int()).abs().max().item() <= 1

    dequant = transformer._kv_dequant
    monkeypatch.setattr(transformer, "_kv_dequant",
                        lambda x, dtype: dequant(x, dtype) * (transformer.KV_QUANT_SCALE / 29.0))
    fault, _ = decode(model, params, card)
    excess = ((fault - want).abs() - 2e-3 * want.abs()).max().item()
    assert excess >= 100 * 2e-4, excess


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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_ssd_scan_under_grad_on_the_card_has_the_plain_gradient(card, dtype, tol):
    """Under grad a CUDA scan runs the kernel once inside ``ops.SSDScan``:
    its output has the Function's ``grad_fn``, and the gradients of all five
    inputs, the backward kernel's (one launch), are autograd's through the
    plain ``ssd_chunked`` (max|d| <= tol max|ref|); under ``no_grad`` the
    kernel runs bare."""
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    x, la, B, C, dt = _ssd_inputs(card, 2, 512, 4, 64, 128, 3)
    x, B, C = x.to(dtype), B.to(dtype), C.to(dtype)
    w = torch.randn(x.shape, generator=torch.Generator(device=card).manual_seed(1),
                    device=card)

    def grads(fn):
        ts = [t.clone().requires_grad_(True) for t in (x, la, B, C, dt)]
        y = fn(*ts, 256)
        return y, torch.autograd.grad((y.float() * w).sum(), ts)

    from repro_torch.kernels.ssd_scan.kernel_bwd import ssd_scan_bwd_cuda

    before, before_bwd = ssd_scan_cuda.launches, ssd_scan_bwd_cuda.launches
    y, got = grads(ssd_scan)
    assert ssd_scan_cuda.launches == before + 1
    assert ssd_scan_bwd_cuda.launches == before_bwd + 1
    assert type(y.grad_fn).__name__ == "SSDScanBackward"
    _, want = grads(ssd_chunked)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and _rel(g, r) <= tol
    with torch.no_grad():
        assert ssd_scan(x, la, B, C, dt, 256).grad_fn is None
    assert ssd_scan_cuda.launches == before + 2


# (Bt, L, H, P, N, G, Q): tests/test_kernels.py's shapes, rows that are not whole
# groups of 4 (Q 6, N 12), (p)'s training shape, zamba2-7b's heads and groups,
# nemotron's eight groups and chunk of 128
SSD_BWD_SHAPES = [
    (2, 64, 4, 8, 16, 1, 16), (1, 128, 2, 64, 128, 1, 32), (2, 32, 8, 16, 8, 1, 32),
    (1, 64, 1, 128, 64, 1, 64), (1, 64, 2, 16, 8, 1, 16), (2, 32, 8, 32, 16, 1, 4),
    (1, 30, 2, 16, 12, 1, 6), (1, 384, 3, 128, 128, 1, 192),
    (8, 2048, 64, 64, 128, 1, 256),  # (p): mamba2-1.3b's training shape
    (2, 512, 112, 64, 64, 2, 256),  # zamba2-7b
    (2, 512, 64, 64, 128, 8, 128),  # nemotron-3-nano-30b-a3b
]
SSD_BWD_F32 = 1e-4  # each gradient's max|d| over its max|ref|: f32, and log_a's and dt's
SSD_BWD_ULPS = 4  # bf16 x, B and C gradients: bf16 ulps of max|ref|
#: planted faults, each a changed copy of csrc/ssd_scan_bwd.cu: dS' not carried
#: from a chunk into the one before it, and dlog_a without its reverse cumsum
SSD_BWD_FAULTS = {
    "state_gradient_not_carried": ("            dS = eT[c] * dS + loc;", "            (void)loc;"),
    "no_reverse_cumsum": ("        dlog_a[(row0 + k) * H + h] = acc;",
                          "        dlog_a[(row0 + k) * H + h] = dcum(k);"),
}


def _ssd_bwd_inputs(card, Bt, L, H, Pd, N, G, dtype, seed):
    """x, log_a, B, C, dt as ``_ssd_inputs`` (B and C [Bt, L, G, N] when G > 1),
    and an output gradient dy; x, B, C and dy in ``dtype``."""
    rng = np.random.default_rng(seed)
    f = np.float32
    bc = (Bt, L, G, N) if G > 1 else (Bt, L, N)
    draw = [rng.standard_normal((Bt, L, H, Pd), dtype=f),
            -np.abs(rng.standard_normal((Bt, L, H), dtype=f)) * 0.3,
            rng.standard_normal(bc, dtype=f), rng.standard_normal(bc, dtype=f),
            np.logaddexp(rng.standard_normal((Bt, L, H), dtype=f), f(0)),
            rng.standard_normal((Bt, L, H, Pd), dtype=f)]
    ts = [torch.from_numpy(np.asarray(a, dtype=f)).to(card) for a in draw]
    return [t.to(dtype) if k in (0, 2, 3, 5) else t for k, t in enumerate(ts)]


def _ssd_bwd_gaps(got, want, dtype):
    """Each gradient's gap: bf16 ulps of max|ref| for a bf16 one, else max|d|
    over max|ref|."""
    return [_ulps(g, w) if w.dtype == torch.bfloat16 else _rel(g, w)
            for g, w in zip(got, want)]


def _ssd_bwd_limits(dtype):
    return [SSD_BWD_ULPS if dtype == torch.bfloat16 and k in (0, 2, 3) else SSD_BWD_F32
            for k in range(5)]


@pytest.mark.parametrize("Bt,L,H,Pd,N,G,Q", SSD_BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_kernel_matches_plain_grads(card, Bt, L, H, Pd, N, G, Q, dtype):
    """``ssd_scan_bwd_cuda``'s five gradients against ``ops.plain_grads``
    (autograd through the plain ``ssd_chunked``) on the same inputs and output
    gradient: f32 within SSD_BWD_F32 of max|ref| each; in bf16 the x, B and C
    gradients (stored in bf16) within SSD_BWD_ULPS bf16 ulps of max|ref|, log_a's
    and dt's (f32) within SSD_BWD_F32.  One launch counted a call, each gradient
    in its input's dtype and shape."""
    from repro_torch.kernels.ssd_scan.kernel_bwd import ssd_scan_bwd_cuda
    from repro_torch.kernels.ssd_scan.ops import plain_grads

    *inputs, dy = _ssd_bwd_inputs(card, Bt, L, H, Pd, N, G, dtype, L + N + G)
    before = ssd_scan_bwd_cuda.launches
    got = ssd_scan_bwd_cuda(*inputs, dy, Q)
    assert ssd_scan_bwd_cuda.launches == before + 1
    want = plain_grads(inputs, (True,) * 5, Q, dy)
    torch.cuda.synchronize()
    for g, w, a in zip(got, want, inputs):
        assert g.dtype == w.dtype == a.dtype and g.shape == w.shape == a.shape
    gaps = _ssd_bwd_gaps(got, want, dtype)
    assert all(g <= t for g, t in zip(gaps, _ssd_bwd_limits(dtype))), gaps


@pytest.mark.parametrize("fault", sorted(SSD_BWD_FAULTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_limits_read_planted_faults(card, monkeypatch, tmp_path, fault, dtype):
    """Each planted fault (``SSD_BWD_FAULTS``, a build of a changed copy of the
    source) reads outside the limits that the sound kernel meets on the same
    inputs, at a shape of eight chunks: dS' not carried spoils dx, dB, dlog_a
    and ddt; no reverse cumsum spoils dlog_a."""
    from pathlib import Path

    from repro_torch.kernels.nvcc import CSRC, CudaLibrary
    from repro_torch.kernels.ssd_scan import kernel_bwd
    from repro_torch.kernels.ssd_scan.ops import plain_grads

    *inputs, dy = _ssd_bwd_inputs(card, 2, 1024, 4, 64, 128, 1, dtype, 17)
    want = plain_grads(inputs, (True,) * 5, 128, dy)
    limits = _ssd_bwd_limits(dtype)
    sound = _ssd_bwd_gaps(kernel_bwd.ssd_scan_bwd_cuda(*inputs, dy, 128), want, dtype)
    assert all(g <= t for g, t in zip(sound, limits)), sound
    src = (CSRC / "ssd_scan_bwd.cu").read_text()
    good, bad = SSD_BWD_FAULTS[fault]
    assert src.count(good) == 1
    path = Path(tmp_path) / f"ssd_scan_bwd_{fault}.cu"
    path.write_text(src.replace(good, bad))
    lib = CudaLibrary(str(path), kernel_bwd._bind).load()
    monkeypatch.setattr(kernel_bwd, "load", lambda: lib)
    gaps = _ssd_bwd_gaps(kernel_bwd.ssd_scan_bwd_cuda(*inputs, dy, 128), want, dtype)
    spoiled = (0, 1, 2, 4) if fault == "state_gradient_not_carried" else (1,)
    assert all(gaps[k] > 10 * limits[k] for k in spoiled), (fault, gaps)


def test_ssd_backward_kernel_returns_only_the_gradients_asked_for(card):
    """A subset of ``needs``: the others are None, the ones asked for equal
    the full call's bit for bit (the kernels they need run alone), and the
    Function passes ``needs_input_grad`` through."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.kernel_bwd import ssd_scan_bwd_cuda

    *inputs, dy = _ssd_bwd_inputs(card, 2, 512, 4, 64, 64, 2, torch.bfloat16, 5)
    full = ssd_scan_bwd_cuda(*inputs, dy, 256)
    for needs in [(True, False, False, False, True), (False, True, False, False, False),
                  (False, False, True, False, False), (False, False, False, True, False),
                  (True, False, True, True, False)]:
        got = ssd_scan_bwd_cuda(*inputs, dy, 256, needs)
        for g, f, n in zip(got, full, needs):
            assert (g is None) != n and (g is None or torch.equal(g, f)), needs
    ts = [t.clone().requires_grad_(k in (2, 4)) for k, t in enumerate(inputs)]
    y = ops.ssd_scan(*ts, chunk=256)
    gB, gdt = torch.autograd.grad(y, [ts[2], ts[4]], dy)
    assert torch.equal(gB, full[2]) and torch.equal(gdt, full[4])


def test_ssd_backward_counts_one_launch_a_backward(card, monkeypatch):
    """Under grad on the card: one ``ssd_scan_bwd_cuda`` launch and one
    ``SSDScan.backward_calls`` a backward, ``ssd_scan_cuda.launches`` unmoved
    by it, and the plain ``plain_grads`` never called."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.kernel_bwd import ssd_scan_bwd_cuda

    *inputs, dy = _ssd_bwd_inputs(card, 2, 512, 4, 64, 128, 1, torch.bfloat16, 6)
    ts = [t.clone().requires_grad_(True) for t in inputs]
    y = ops.ssd_scan(*ts, chunk=256)
    fwd, bwd, calls = ssd_scan_cuda.launches, ssd_scan_bwd_cuda.launches, ops.SSDScan.backward_calls
    monkeypatch.setattr(ops, "plain_grads", lambda *a: pytest.fail("the plain backward ran"))
    torch.autograd.grad(y, ts, dy)
    assert ssd_scan_bwd_cuda.launches == bwd + 1 and ops.SSDScan.backward_calls == calls + 1
    assert ssd_scan_cuda.launches == fwd


def test_ssd_backward_kernel_is_deterministic(card):
    """Two calls on the same inputs give equal bits: every row and partial
    sum is added in a fixed order."""
    from repro_torch.kernels.ssd_scan.kernel_bwd import ssd_scan_bwd_cuda

    *inputs, dy = _ssd_bwd_inputs(card, 2, 512, 8, 64, 128, 2, torch.bfloat16, 7)
    first = ssd_scan_bwd_cuda(*inputs, dy, 128)
    second = ssd_scan_bwd_cuda(*inputs, dy, 128)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_ssd_backward_wrapper_rejects_what_it_does_not_take(card):
    from repro_torch.kernels.ssd_scan.kernel_bwd import ssd_scan_bwd_cuda

    *inputs, dy = _ssd_bwd_inputs(card, 1, 32, 2, 16, 8, 1, torch.float32, 1)
    x, la, B, C, dt = inputs
    before = ssd_scan_bwd_cuda.launches
    with pytest.raises(ValueError, match="one dtype"):
        ssd_scan_bwd_cuda(x, la, B.bfloat16(), C, dt, dy, 16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_scan_bwd_cuda(x, la, B, C, dt, dy, 12)
    with pytest.raises(ValueError, match="do not match"):
        ssd_scan_bwd_cuda(x, la, B, C, dt, dy[:, :16], 16)
    with pytest.raises(ValueError, match="head dims"):
        ssd_scan_bwd_cuda(torch.zeros((1, 32, 2, 48), device=card), la, B, C, dt,
                          torch.zeros((1, 32, 2, 48), device=card), 16)
    big = torch.zeros((1, 8192, 1, 8), device=card)
    f, bc = torch.zeros((1, 8192, 1), device=card), torch.zeros((1, 8192, 8), device=card)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_scan_bwd_cuda(big, f, bc, bc, f, big, 1)  # the walk over 8192 chunks of one
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan_bwd_cuda(x.transpose(2, 3).contiguous().transpose(2, 3), la, B, C, dt, dy, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_bwd_cuda(x.cpu(), la, B, C, dt, dy, 16)
    assert ssd_scan_bwd_cuda.launches == before


def test_mamba2_train_step_on_the_card_matches_the_cpu(card):
    """A reduced mamba2 (f32) train step: the loss and every gradient on the
    card equal the CPU's (atol 2e-4, rtol 2e-3), the SSD kernel called
    twice a layer (the forward and the remat recompute)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.models.model_api import build_model
    from repro_torch.tree import tree_leaves

    cfg = get_config("mamba2-1.3b").reduced(dtype="float32")
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    batch = synth_batch(cfg, DataConfig(global_batch=2, seq_len=64, seed=5), 0)

    def loss_grads(dev, p):
        leaves = tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        loss = build_model(cfg, dev).loss(p, {k: torch.from_numpy(v).to(dev)
                                              for k, v in batch.items()})
        return loss, torch.autograd.grad(loss, leaves)

    before = ssd_scan_cuda.launches
    got, g_card = loss_grads(card, _to_card(params, card))
    assert ssd_scan_cuda.launches == before + 2 * cfg.n_layers
    want, g_cpu = loss_grads("cpu", params)
    torch.testing.assert_close(got.cpu(), want, atol=2e-4, rtol=2e-3)
    for a, b in zip(g_card, g_cpu):
        torch.testing.assert_close(a.cpu(), b, atol=2e-4, rtol=2e-3)


def _to_card(tree, card):
    if isinstance(tree, dict):
        return {k: _to_card(v, card) for k, v in tree.items()}
    return tree.detach().to(card)


# ------------------------------------------------ the Mamba block's passes ---

# zamba2-7b: two B/C groups; nemotron: eight, and d_inner 4096 from 64 heads of 64
PASS_ARCHS = ("mamba2-1.3b", "zamba2-2.7b", "zamba2-7b", "nemotron-3-nano-30b-a3b")
PASS_ULPS = 4  # kernels vs the plain passes in bf16: ulps of max|ref|


def _pass_block(card, arch, B, L, dtype=torch.bfloat16, seed=0):
    """One Mamba block of ``arch`` at its published widths on the card, with
    random conv bias, D, dt_bias and norm scales (so every term shows), an
    input x [B, L, d_model] and a stand-in y [B, L, H, P] for the scan's
    output, all drawn from ``seed``."""
    import dataclasses

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.configs.port_only import get_port_config
    from repro_torch.models.mamba2 import init_mamba_block

    cfg = dataclasses.replace((get_config if arch in ARCHS else get_port_config)(arch),
                              n_layers=1, dtype=str(dtype).split(".")[-1])
    gen = torch.Generator(device=card).manual_seed(seed)
    p = init_mamba_block(gen, cfg, dtype)

    def draw(shape):
        return torch.randn(shape, generator=gen, device=card)

    p["conv_b"], p["D"], p["dt_bias"] = (draw(p[k].shape) for k in ("conv_b", "D", "dt_bias"))
    for k in ("norm", "out_norm"):
        p[k] = {"scale": 1 + 0.1 * draw(p[k]["scale"].shape)}
    x = draw((B, L, cfg.d_model)).to(dtype)
    y = draw((B, L, cfg.ssm_nheads, cfg.ssm_headdim)).to(dtype)
    return cfg, p, x, y


def _spied_linear(m, module, seen, first=None):
    """``module.linear`` recording each call's input and output in ``seen``;
    the first call (the input projection) returns ``first`` where given."""
    from repro_torch.models.common import linear

    def lin(w, h):
        out = linear(w, h) if first is None or seen else first
        seen.append((h, out))
        return out

    m.setattr(module, "linear", lin)


def _plain_io(monkeypatch, cfg, p, x, y, zxbcdt=None):
    """The plain passes (``ref.mamba_passes``) on ``x``, the scan's output
    taken as ``y`` (and the input projection's as ``zxbcdt`` where given):
    the norm's output h, the input projection zxbcdt, the conv's outputs
    (x [B, L, d_inner] contiguous, B, C, dt, log_a) and the gate norm's
    output g, the input of the output projection."""
    from repro_torch.kernels.mamba_passes import ref

    seen, conv = [], []

    def scan(xh, log_a, B, C, dt, chunk):
        conv.extend([xh.reshape(*xh.shape[:2], -1).contiguous(), B, C, dt, log_a])
        return y

    with monkeypatch.context() as m, torch.no_grad():
        _spied_linear(m, ref, seen, zxbcdt)
        ref.mamba_passes(cfg, p, x, scan)
    (h, z), (g, _) = seen
    return dict(h=h, zxbcdt=z, conv=conv, g=g)


def _fused_g(monkeypatch, cfg, p, x, y, zxbcdt):
    """The out_proj input of the kernels' route (``mamba_passes_cuda``) on
    ``x``, the input projection's output taken as ``zxbcdt`` and the scan's
    as ``y``."""
    from repro_torch.kernels.mamba_passes import kernel

    seen = []
    with monkeypatch.context() as m, torch.no_grad():
        _spied_linear(m, kernel, seen, zxbcdt)
        kernel.mamba_passes_cuda(cfg, p, x, lambda *a: y)
    return seen[1][0]


def _ulps(got, want):
    """max|got - want| in bf16 ulps of max|want|: 2^(e - 7), e its binade."""
    import math

    m = want.float().abs().max().item()
    return (got.float() - want.float()).abs().max().item() / 2.0 ** (math.floor(math.log2(m)) - 7)


def _fused_outputs(cfg, p, x, y, plain):
    """Each kernel on the plain passes' own inputs."""
    from repro_torch.kernels.mamba_passes.kernel import (
        conv_silu_cuda, gate_norm_cuda, rmsnorm_cuda,
    )
    from repro_torch.kernels.mamba_passes.ref import ssm_groups

    G = ssm_groups(cfg)
    h = rmsnorm_cuda(x, p["norm"]["scale"], cfg.norm_eps)
    conv = conv_silu_cuda(plain["zxbcdt"], p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"],
                          cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, G)
    g = gate_norm_cuda(y, plain["conv"][0], plain["zxbcdt"], p["D"], p["out_norm"]["scale"],
                       cfg.norm_eps, cfg.ssm_headdim, G)
    return dict(h=h, conv=list(conv), g=g)


@pytest.mark.parametrize("L", [1, 3, 257, 4096])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("arch", PASS_ARCHS)
def test_mamba_pass_kernels_match_the_plain_passes(card, monkeypatch, arch, B, L):
    """bf16: h, x, B, C and g within PASS_ULPS of the plain passes' (the norms
    differ by summation order, the conv by the plain path's bf16 rounding of
    its products and partial sums); dt and log_a, f32 in both, to 2e-6."""
    cfg, p, x, y = _pass_block(card, arch, B, L)
    plain = _plain_io(monkeypatch, cfg, p, x, y)
    got = _fused_outputs(cfg, p, x, y, plain)
    for name, a, b in [("h", got["h"], plain["h"]), ("g", got["g"], plain["g"])] + [
            (k, a, b) for k, a, b in zip("xBC", got["conv"], plain["conv"])]:
        assert a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape, name
        assert _ulps(a, b) <= PASS_ULPS, (name, _ulps(a, b))
    for a, b in zip(got["conv"][3:], plain["conv"][3:]):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("arch,B,L", [("mamba2-1.3b", 3, 257), ("zamba2-2.7b", 1, 4096),
                                      ("zamba2-7b", 1, 4096)])
def test_mamba_pass_kernels_in_f32(card, monkeypatch, arch, B, L):
    """f32 activations: every output within 1e-5 of max|ref| (the same f32
    arithmetic in another summation order)."""
    cfg, p, x, y = _pass_block(card, arch, B, L, dtype=torch.float32)
    plain = _plain_io(monkeypatch, cfg, p, x, y)
    got = _fused_outputs(cfg, p, x, y, plain)
    for a, b in [(got["h"], plain["h"]), (got["g"], plain["g"])] + list(
            zip(got["conv"], plain["conv"])):
        assert a.dtype == torch.float32 and _rel(a, b) <= 1e-5


@pytest.mark.parametrize("arch", PASS_ARCHS)
def test_mamba_pass_kernels_are_no_less_precise_than_the_plain_passes(card, monkeypatch, arch):
    """Against the f32 twin (the same bf16 weights and input in f32, the same
    input projection and scan outputs), the kernels' route is no further
    than the plain bf16 route: the rms of the error of the norm's output and
    of the out_proj input at most 1% above the plain route's.  The two share
    every rounding point but the conv's, where the kernel keeps f32."""
    import dataclasses

    from repro_torch.tree import tree_map

    cfg, p, x, y = _pass_block(card, arch, 2, 512)
    plain = _plain_io(monkeypatch, cfg, p, x, y)
    got = _fused_outputs(cfg, p, x, y, plain)
    g = _fused_g(monkeypatch, cfg, p, x, y, plain["zxbcdt"])
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    twin = _plain_io(monkeypatch, cfg32, tree_map(lambda t: t.float(), p), x.float(), y.float(),
                     plain["zxbcdt"].float())

    def rms(a, b):
        return (a.float() - b).pow(2).mean().sqrt().item()

    for name, fused, bf16, want in [("h", got["h"], plain["h"], twin["h"]),
                                    ("g", g, plain["g"], twin["g"])]:
        assert rms(fused, want) <= 1.01 * rms(bf16, want), (name, rms(fused, want),
                                                            rms(bf16, want))


def test_mamba_pass_limit_reads_a_conv_window_shifted_by_a_token(card, monkeypatch):
    """The planted fault: the conv kernel on the input projection shifted one
    token later (its window a token behind) reads far outside PASS_ULPS."""
    from repro_torch.kernels.mamba_passes.kernel import conv_silu_cuda

    cfg, p, x, y = _pass_block(card, "mamba2-1.3b", 1, 257)
    plain = _plain_io(monkeypatch, cfg, p, x, y)
    z = plain["zxbcdt"]
    shifted = torch.cat([torch.zeros_like(z[:, :1]), z[:, :-1]], dim=1)
    got = conv_silu_cuda(shifted, p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"],
                         cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads)
    assert _ulps(got[0], plain["conv"][0]) > 10 * PASS_ULPS


def test_mamba_pass_wrappers_reject_what_the_kernels_do_not_take(card):
    from repro_torch.kernels.mamba_passes.kernel import (
        conv_silu_cuda, gate_norm_cuda, mamba_passes_cuda, rmsnorm_cuda,
    )

    cfg, p, x, y = _pass_block(card, "mamba2-1.3b", 1, 8)
    Din, N, H, Pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    scale, eps = p["norm"]["scale"], cfg.norm_eps
    z = torch.zeros((1, 8, 2 * Din + 2 * N + H), dtype=torch.bfloat16, device=card)
    xs = torch.zeros((1, 8, Din), dtype=torch.bfloat16, device=card)
    conv = (p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"], Din, N, H)
    gate = (p["D"], p["out_norm"]["scale"], eps, Pd)
    before = mamba_passes_cuda.launches
    cases = [
        ("float32 or bfloat16", lambda: rmsnorm_cuda(x.half(), scale, eps)),
        ("contiguous", lambda: rmsnorm_cuda(x[..., :1024], scale[:1024], eps)),
        ("aligned", lambda: rmsnorm_cuda(torch.zeros(cfg.d_model + 1, dtype=torch.bfloat16,
                                                     device=card)[1:], scale, eps)),
        ("shape", lambda: rmsnorm_cuda(x, scale[:1024], eps)),
        ("scale in torch.float32", lambda: rmsnorm_cuda(x, scale.bfloat16(), eps)),
        ("conv widths", lambda: conv_silu_cuda(z, p["conv_w"][:1], *conv[1:])),
        ("must be", lambda: conv_silu_cuda(z[..., 8:].contiguous(), *conv)),
        ("conv_w in", lambda: conv_silu_cuda(z, p["conv_w"].float(), *conv[1:])),
        ("multiples of 8", lambda: conv_silu_cuda(
            torch.zeros((1, 8, 2 * Din + 2 * N + 4), dtype=torch.bfloat16, device=card),
            p["conv_w"], p["conv_b"], p["dt_bias"][:4], p["A_log"][:4], Din, N, 4)),
        ("shape", lambda: gate_norm_cuda(y[:, :4], xs, z, *gate)),
        ("not a multiple", lambda: gate_norm_cuda(y, xs, z, p["D"], p["out_norm"]["scale"],
                                                  eps, 48)),
        ("D in torch.float32", lambda: gate_norm_cuda(y, xs, z, p["D"].half(),
                                                      *gate[1:])),
        ("CUDA device", lambda: gate_norm_cuda(y, xs.cpu(), z, *gate)),
    ]
    for match, call in cases:
        with pytest.raises(ValueError, match=match):
            call()
    assert mamba_passes_cuda.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_prefill_on_the_fused_route_matches_the_plain_route(card, monkeypatch, dtype):
    """A reduced mamba2 prefill on the card: the fused route (the default with
    grad off, ``mamba_passes_cuda.launches`` up by n_layers) against the plain
    passes on the card (``ops.PLAIN_DEVICES`` widened to ``cuda``, the counter
    put): f32 at tests/test_model_consistency.py's atol 2e-4, rtol 2e-3; bf16
    logits within 2e-2 of max|ref| (the conv's bf16 rounding points, through
    two layers)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.mamba_passes import ops
    from repro_torch.kernels.mamba_passes.kernel import mamba_passes_cuda
    from repro_torch.models.model_api import build_model

    cfg = get_config("mamba2-1.3b").reduced(dtype=dtype)
    model = build_model(cfg, card)
    params = model.init(torch.Generator(device=card).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 4 * cfg.ssm_chunk), dtype=np.int64)).to(card)
    before = mamba_passes_cuda.launches
    got = model.prefill(params, {"tokens": toks})
    assert mamba_passes_cuda.launches == before + cfg.n_layers
    monkeypatch.setattr(ops, "PLAIN_DEVICES", ("cpu", "meta", "cuda"))
    want = model.prefill(params, {"tokens": toks})
    assert mamba_passes_cuda.launches == before + cfg.n_layers
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-3)
    else:
        assert _rel(got, want) <= 2e-2


def test_mamba_passes_counter_rises_a_prefill_and_a_training_step(card):
    """``mamba_passes_cuda.launches``: n_layers a prefill of a reduced mamba2
    (bf16, remat full), and 2 n_layers a training step (loss and every
    gradient: the forward and remat's recompute, each through the
    Functions), while ``backward_calls`` rises by n_layers there and the SSD
    kernel's counter by 2 n_layers."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.mamba_passes.kernel import mamba_passes_cuda
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.models.model_api import build_model
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config("mamba2-1.3b").reduced(dtype="bfloat16"), remat=True,
                              remat_policy="full")
    model = build_model(cfg, card)
    params = model.init(torch.Generator(device=card).manual_seed(0))
    tok = torch.randint(0, cfg.vocab_size, (2, 2 * cfg.ssm_chunk + 1), device=card,
                        generator=torch.Generator(device=card).manual_seed(1))
    before = mamba_passes_cuda.launches
    model.prefill(params, {"tokens": tok[:, :-1]})
    assert mamba_passes_cuda.launches == before + cfg.n_layers
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    ssd, bwd = ssd_scan_cuda.launches, mamba_passes_cuda.backward_calls
    loss = model.loss(params, {"tokens": tok[:, :-1], "labels": tok[:, 1:]})
    torch.autograd.grad(loss, leaves)
    assert mamba_passes_cuda.launches == before + 3 * cfg.n_layers
    assert mamba_passes_cuda.backward_calls == bwd + cfg.n_layers
    assert ssd_scan_cuda.launches == ssd + 2 * cfg.n_layers


# ------------------------------------------------ the passes' backward ---

PASS_BWD_ARCHS = ("mamba2-1.3b", "zamba2-7b")  # zamba2-7b: two B/C groups and an addend
PASS_BWD_ULPS = 4  # bf16 gradients vs autograd through the plain passes: ulps of max|ref|
PASS_BWD_F32 = 1e-5  # f32 gradients: of max|ref|


def _pass_grads(card, arch, L, dtype, seed=0):
    """A block of ``arch`` at B=1 (``_pass_block``), each pass's inputs (x;
    the input projection zxbcdt of the plain norm of x; the scan's output y
    and the plain conv's x) and a random gradient of each pass's outputs."""
    from repro_torch.kernels.mamba_passes import ref
    from repro_torch.models.common import linear, rmsnorm

    cfg, p, x, y = _pass_block(card, arch, 1, L, dtype, seed)
    G = ref.ssm_groups(cfg)
    with torch.no_grad():
        zx = linear(p["in_proj"], rmsnorm(p["norm"], x, cfg.norm_eps))
        xs = ref.conv_pass(cfg, p, zx, dtype)[0].reshape(1, L, cfg.d_inner).contiguous()
    gen = torch.Generator(device=card).manual_seed(seed + 1)

    def draw(shape, dt=dtype):
        return torch.randn(shape, generator=gen, device=card).to(dt)

    bc = (1, L, cfg.ssm_state) if G == 1 else (1, L, G, cfg.ssm_state)
    H = cfg.ssm_nheads
    grads = dict(h=draw(x.shape), out=draw((1, L, cfg.d_inner)),
                 conv=(draw((1, L, cfg.d_inner)), draw(bc), draw(bc),
                       draw((1, L, H), torch.float32), draw((1, L, H), torch.float32)))
    return cfg, p, dict(x=x, zx=zx, y=y, xs=xs), grads


def _norm_grads(cfg, p, io, grads, fused):
    """(dx, d scale) of the input norm: ``RMSNormFn`` or the plain rmsnorm."""
    from repro_torch.kernels.mamba_passes.kernel import RMSNormFn
    from repro_torch.models.common import rmsnorm

    x, s = (t.detach().clone().requires_grad_(True) for t in (io["x"], p["norm"]["scale"]))
    h = (RMSNormFn.apply(x, s, cfg.norm_eps) if fused
         else rmsnorm({"scale": s}, x, cfg.norm_eps))
    return dict(zip(("x", "scale"), torch.autograd.grad(h, (x, s), grads["h"])))


def _conv_grads(cfg, p, io, grads, fused, shift=0):
    """The gradients of zxbcdt (its xBC and dt columns), conv_w, conv_b,
    dt_bias and A_log: ``ConvSiluFn`` (its outputs' gradients ``shift``
    tokens later where given: the planted fault) or the plain conv pass."""
    from repro_torch.kernels.mamba_passes import kernel, ref

    names = ("conv_w", "conv_b", "dt_bias", "A_log")
    ts = [t.detach().clone().requires_grad_(True) for t in [io["zx"]] + [p[k] for k in names]]
    G, Din = ref.ssm_groups(cfg), cfg.d_inner
    gs = grads["conv"]
    if fused:
        outs = kernel.ConvSiluFn.apply(*ts, Din, cfg.ssm_state, cfg.ssm_nheads, G,
                                       kernel.Link())
        if shift:
            gs = tuple(torch.cat([torch.zeros_like(g[:, :shift]), g[:, :-shift]], dim=1)
                       for g in gs)
    else:
        xh, log_a, Bm, Cm, dt = ref.conv_pass(cfg, dict(zip(names, ts[1:])), ts[0],
                                              io["zx"].dtype)
        outs = (xh.reshape(*xh.shape[:2], Din), Bm, Cm, dt, log_a)
    got = torch.autograd.grad(outs, ts, gs)
    return dict(zxbcdt=got[0][..., Din:], **dict(zip(names, got[1:])))


def _gate_grads(cfg, p, io, grads, fused):
    """The gradients of y, x (the D skip's share), z, D and the out norm's
    scale: ``GateNormFn`` (x's and z's through its ``Link``) or the plain
    gate pass."""
    from repro_torch.kernels.mamba_passes import kernel, ref

    ts = [t.detach().clone().requires_grad_(True) for t in (
        io["y"], io["xs"], io["zx"], p["D"], p["out_norm"]["scale"])]
    Din = cfg.d_inner
    if fused:
        link = kernel.Link()
        g = kernel.GateNormFn.apply(*ts, cfg.norm_eps, cfg.ssm_headdim, ref.ssm_groups(cfg),
                                    link)
        dy, dD, ds = torch.autograd.grad(g, (ts[0], ts[3], ts[4]), grads["out"])
        return dict(y=dy, x=link.dx, z=link.dzx[..., :Din], D=dD, scale=ds)
    g = ref.gate_pass(cfg, {"D": ts[3], "out_norm": {"scale": ts[4]}}, ts[0],
                      ts[1].view(ts[0].shape), ts[2], ts[0].dtype)
    dy, dx, dz, dD, ds = torch.autograd.grad(g, ts, grads["out"])
    return dict(y=dy, x=dx, z=dz[..., :Din], D=dD, scale=ds)


def _pass_readings(card, arch, L, dtype, seed=0):
    """{pass.tensor: (fused, plain)} of every input's and leaf's gradient."""
    cfg, p, io, grads = _pass_grads(card, arch, L, dtype, seed)
    out = {}
    for name, fn in (("norm", _norm_grads), ("conv", _conv_grads), ("gate", _gate_grads)):
        got, want = fn(cfg, p, io, grads, True), fn(cfg, p, io, grads, False)
        out.update({f"{name}.{k}": (got[k], want[k]) for k in want})
    return out


def _grad_gap(got, want, dtype):
    """max|got - want| in bf16 ulps of max|want| (bf16 activations), or over
    max|want| (f32)."""
    return _ulps(got, want) if dtype == torch.bfloat16 else _rel(got.float(), want.float())


@pytest.mark.parametrize("L", [1, 3, 257, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", PASS_BWD_ARCHS)
def test_mamba_pass_backward_kernels_have_the_plain_gradient(card, arch, dtype, L):
    """Each Function's gradients (every input and leaf) against
    ``torch.autograd.grad`` through the matching plain pass, fed the same
    inputs and output gradient: f32 within 1e-5 of max|ref| (the same
    arithmetic, sums in another order); bf16 within PASS_BWD_ULPS bf16 ulps
    of max|ref| (the plain backward rounds its intermediates to bf16, the
    kernels keep f32 and round each output once).  Each gradient has its
    input's dtype."""
    limit = PASS_BWD_ULPS if dtype == torch.bfloat16 else PASS_BWD_F32
    for name, (got, want) in _pass_readings(card, arch, L, dtype).items():
        assert got.dtype == want.dtype and got.shape == want.shape, name
        gap = _grad_gap(got, want, dtype)
        assert gap <= limit, (name, gap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_pass_backward_is_deterministic(card, dtype):
    """Two runs of each backward kernel on the same inputs give equal bits:
    the parameter gradients' partial sums are added in a fixed order."""
    first = _pass_readings(card, "zamba2-7b", 257, dtype)
    second = _pass_readings(card, "zamba2-7b", 257, dtype)
    for name in first:
        assert torch.equal(first[name][0], second[name][0]), name


def test_mamba_pass_backward_limit_reads_a_conv_gradient_shifted_by_a_token(card):
    """The planted fault: the conv's backward fed its outputs' gradients one
    token late reads far outside PASS_BWD_ULPS on the xBC columns and on
    conv_w."""
    cfg, p, io, grads = _pass_grads(card, "mamba2-1.3b", 257, torch.bfloat16)
    got = _conv_grads(cfg, p, io, grads, True, shift=1)
    want = _conv_grads(cfg, p, io, grads, False)
    for k in ("zxbcdt", "conv_w"):
        assert _ulps(got[k], want[k]) > 10 * PASS_BWD_ULPS, k


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("arch", PASS_BWD_ARCHS)
def test_mamba_block_backward_on_the_functions_matches_the_plain_route(card, monkeypatch, arch,
                                                                       dtype, tol):
    """A whole block under autograd (zamba2-7b's with an addend): the
    Functions' route (one block call and one block backward counted) against
    the plain passes on the card (``ops.PLAIN_DEVICES`` widened to
    ``cuda``), the same SSD Function in both: the gradients of x, the addend
    and every leaf within ``tol`` of max|ref| (f32: summation order through
    the scan's backward; bf16: the two routes' rounding points)."""
    from repro_torch.kernels.mamba_passes import ops
    from repro_torch.kernels.mamba_passes.kernel import mamba_passes_cuda
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.tree import tree_leaves, tree_map

    cfg, p, x, _ = _pass_block(card, arch, 2, 512, dtype)
    gen = torch.Generator(device=card).manual_seed(7)
    addend = (torch.randn(x.shape, generator=gen, device=card).to(dtype)
              if arch == "zamba2-7b" else None)
    r = torch.randn(x.shape, generator=gen, device=card)

    def grads():
        xs = x.clone().requires_grad_(True)
        ad = None if addend is None else addend.clone().requires_grad_(True)
        ps = tree_map(lambda t: t.detach().clone().requires_grad_(True), p)
        out = ops.mamba_passes(cfg, ps, xs, ssd_scan, ad)
        wrt = [xs] + ([] if ad is None else [ad]) + tree_leaves(ps)
        return torch.autograd.grad((out.float() * r).sum(), wrt)

    before = (mamba_passes_cuda.launches, mamba_passes_cuda.backward_calls)
    got = grads()
    assert (mamba_passes_cuda.launches - before[0],
            mamba_passes_cuda.backward_calls - before[1]) == (1, 1)
    monkeypatch.setattr(ops, "PLAIN_DEVICES", ("cpu", "meta", "cuda"))
    want = grads()
    assert (mamba_passes_cuda.launches, mamba_passes_cuda.backward_calls) == (
        before[0] + 1, before[1] + 1)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and _rel(g.float(), w.float()) <= tol, i


def test_mamba2_train_step_on_the_functions_matches_the_plain_route(card, monkeypatch):
    """A reduced mamba2 (f32, remat full) train step on the card: the
    Functions' route against the plain passes on the card (``ops.PLAIN_DEVICES``
    widened to ``cuda``), loss and every gradient within atol 2e-4, rtol
    2e-3; ``launches`` up by 2 n_layers and ``backward_calls`` by n_layers on
    the Functions, neither on the plain route."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.mamba_passes import ops
    from repro_torch.kernels.mamba_passes.kernel import mamba_passes_cuda
    from repro_torch.models.model_api import build_model
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config("mamba2-1.3b").reduced(dtype="float32"), remat=True,
                              remat_policy="full")
    model = build_model(cfg, card)
    params = model.init(torch.Generator(device=card).manual_seed(0))
    tok = torch.randint(0, cfg.vocab_size, (2, 4 * cfg.ssm_chunk + 1), device=card,
                        generator=torch.Generator(device=card).manual_seed(1))

    def step():
        ps = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
        loss = model.loss(ps, {"tokens": tok[:, :-1], "labels": tok[:, 1:]})
        return loss, torch.autograd.grad(loss, tree_leaves(ps))

    before = (mamba_passes_cuda.launches, mamba_passes_cuda.backward_calls)
    got_loss, got = step()
    assert (mamba_passes_cuda.launches - before[0],
            mamba_passes_cuda.backward_calls - before[1]) == (2 * cfg.n_layers, cfg.n_layers)
    monkeypatch.setattr(ops, "PLAIN_DEVICES", ("cpu", "meta", "cuda"))
    counts = (mamba_passes_cuda.launches, mamba_passes_cuda.backward_calls)
    want_loss, want = step()
    assert (mamba_passes_cuda.launches, mamba_passes_cuda.backward_calls) == counts
    torch.testing.assert_close(got_loss, want_loss, atol=2e-4, rtol=2e-3)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-3)


# ------------------------------------------- B/C in groups, and zamba2-7b ---

GROUPED_SSD = [  # (Bt, L, H, P, N, Q, G): small, ragged rows, zamba2-7b's and nemotron's prefill
    (2, 64, 4, 8, 16, 16, 2), (1, 128, 8, 64, 64, 32, 4), (1, 30, 6, 16, 12, 6, 3),
    (2, 512, 4, 64, 128, 256, 2), (8, 4096, 112, 64, 64, 256, 2),
    (8, 4096, 64, 64, 128, 128, 8),
]


def _grouped_ssd_inputs(card, Bt, L, H, Pd, N, G, seed):
    x, la, B, C, dt = _ssd_inputs(card, Bt, L, H, Pd, G * N, seed)
    return x, la, B.view(Bt, L, G, N), C.view(Bt, L, G, N), dt


@pytest.mark.parametrize("Bt,L,H,Pd,N,Q,G", GROUPED_SSD)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_ssd_kernel_matches_plain_version(card, Bt, L, H, Pd, N, Q, G, dtype):
    """B and C ``[Bt, L, G, N]``: one kernel call (each head reading its
    group) against the plain ``ssd_chunked`` (each group's heads with their B
    and C); f32 within 1e-5 of max|ref| (1e-4 at the prefill shape: the
    cumsum of 256 log-decays in another order), bf16 output 2e-2; B and C
    collapsed to the first group read far outside."""
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    x, la, B, C, dt = _grouped_ssd_inputs(card, Bt, L, H, Pd, N, G, L + G)
    x, B, C = x.to(dtype), B.to(dtype), C.to(dtype)
    before = ssd_scan_cuda.launches
    got = ssd_scan(x, la, B, C, dt, Q)
    assert ssd_scan_cuda.launches == before + 1
    plain = ssd_chunked(x, la, B, C, dt, Q)
    torch.cuda.synchronize()
    assert got.shape == plain.shape and got.dtype == dtype
    tol = 2e-2 if dtype == torch.bfloat16 else (1e-4 if L >= 4096 else 1e-5)
    assert _rel(got, plain) < tol
    one = ssd_chunked(x, la, B[:, :, :1].expand_as(B), C[:, :, :1].expand_as(C), dt, Q)
    assert _rel(got, one) > 10 * tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_with_one_group_is_the_shared_kernel_bit_for_bit(card, dtype):
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda

    x, la, B, C, dt = _ssd_inputs(card, 2, 512, 4, 64, 128, 9)
    x, B, C = x.to(dtype), B.to(dtype), C.to(dtype)
    shared = ssd_scan_cuda(x, la, B, C, dt, 256)
    assert torch.equal(ssd_scan_cuda(x, la, B[:, :, None], C[:, :, None], dt, 256), shared)


def test_grouped_wrappers_reject_heads_not_in_whole_groups(card):
    from repro_torch.kernels.mamba_passes.kernel import (
        conv_silu_cuda, gate_norm_cuda, mamba_passes_cuda,
    )
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda

    x, la, B, C, dt = _grouped_ssd_inputs(card, 1, 32, 4, 16, 8, 3, 1)
    before = ssd_scan_cuda.launches
    with pytest.raises(ValueError, match="multiple of B's groups"):
        ssd_scan_cuda(x, la, B, C, dt, 16)
    assert ssd_scan_cuda.launches == before
    cfg, p, xs, y = _pass_block(card, "zamba2-7b", 1, 8)  # 112 heads
    z = torch.zeros((1, 8, 2 * cfg.d_inner + 4 * cfg.ssm_state + cfg.ssm_nheads),
                    dtype=torch.bfloat16, device=card)
    xi = torch.zeros((1, 8, cfg.d_inner), dtype=torch.bfloat16, device=card)
    before = mamba_passes_cuda.launches
    with pytest.raises(ValueError, match="multiple of 3 groups"):
        conv_silu_cuda(z, p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"], cfg.d_inner,
                       cfg.ssm_state, cfg.ssm_nheads, 3)
    with pytest.raises(ValueError, match="multiple of 3 groups"):
        gate_norm_cuda(y, xi, z, p["D"], p["out_norm"]["scale"], cfg.norm_eps, cfg.ssm_headdim, 3)
    assert mamba_passes_cuda.launches == before


def _tiny_zamba2(dtype):
    import dataclasses

    from repro_torch.configs.port_only import get_port_config

    return dataclasses.replace(
        get_port_config("zamba2-7b"), dtype=dtype, n_layers=7, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=32, d_ff=96, vocab_size=96, ssm_state=16, ssm_headdim=16,
        ssm_chunk=16, hybrid_layer_ids=(1, 3, 4, 6), adapter_rank=8, attn_q_chunk=16,
        attn_k_chunk=32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zamba2_prefill_on_the_card_goes_through_the_kernels(card, monkeypatch, dtype):
    """A tiny zamba2 (two B/C groups, four sites over two shared blocks):
    its prefill on the card launches the SSD kernel and the fused passes once
    a Mamba block and counts one shared-block call a site; it equals the
    plain passes on the card (``ops.PLAIN_DEVICES`` widened) and, in f32, the
    CPU's prefill (tests/test_model_consistency.py's atol 2e-4, rtol 2e-3);
    bf16 within 2e-2 of max|ref| (the conv's bf16 rounding points, through
    seven layers)."""
    from repro_torch.kernels.mamba_passes import ops
    from repro_torch.kernels.mamba_passes.kernel import mamba_passes_cuda
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.models import zamba2
    from repro_torch.models.model_api import build_model

    cfg = _tiny_zamba2(dtype)
    model = build_model(cfg, card)
    params = model.init(torch.Generator(device=card).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 4 * cfg.ssm_chunk), dtype=np.int64)).to(card)
    counts = (mamba_passes_cuda.launches, ssd_scan_cuda.launches, zamba2.shared_block.calls)
    got = model.prefill(params, {"tokens": toks})
    assert (mamba_passes_cuda.launches, ssd_scan_cuda.launches, zamba2.shared_block.calls) == (
        counts[0] + cfg.n_layers, counts[1] + cfg.n_layers, counts[2] + cfg.n_sites)
    monkeypatch.setattr(ops, "PLAIN_DEVICES", ("cpu", "meta", "cuda"))
    want = model.prefill(params, {"tokens": toks})
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-3)
        host = build_model(cfg, "cpu").prefill(_to_cpu(params), {"tokens": toks.cpu()})
        torch.testing.assert_close(got.cpu(), host, atol=2e-4, rtol=2e-3)
    else:
        assert _rel(got, want) <= 2e-2


def test_zamba2_prefill_and_decode_on_the_card_go_through_both_kernels(card):
    """A reduced zamba2 (f32, two attention sites sharing one block, heads
    of 80) prefills on the card with one SSD-kernel launch per Mamba block
    and decodes with one decode-kernel launch per site and step; its logits
    equal the same weights' on the CPU (tests/test_model_consistency.py's
    atol 2e-4, rtol 2e-3)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.models.model_api import build_model

    cfg = get_config("zamba2-2.7b").reduced(dtype="float32", n_layers=4, head_dim=80)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=card).manual_seed(0))
    host = build_model(cfg, device="cpu")
    host_params = _to_cpu(params)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 3 * cfg.ssm_chunk), dtype=np.int32))
    before = (ssd_scan_cuda.launches, decode_attn_cuda.launches)
    got = model.prefill(params, {"tokens": toks.to(card)})
    assert (ssd_scan_cuda.launches, decode_attn_cuda.launches) == (before[0] + 4, before[1])
    want = host.prefill(host_params, {"tokens": toks})
    torch.testing.assert_close(got.cpu(), want, atol=2e-4, rtol=2e-3)
    cache, host_cache = model.init_cache(2, 8), host.init_cache(2, 8)
    for i in range(5):
        got, cache = model.decode_step(params, toks[:, i].to(card), cache, i)
        want, host_cache = host.decode_step(host_params, toks[:, i], host_cache, i)
        torch.testing.assert_close(got.cpu(), want, atol=2e-4, rtol=2e-3)
    assert (ssd_scan_cuda.launches, decode_attn_cuda.launches) == (before[0] + 4,
                                                                   before[1] + 2 * 5)


def test_zamba2_decode_on_the_card_raises_where_the_kernel_refuses(card, monkeypatch):
    """No fallback: with the kernel refusing zamba2's head shape, a decode
    step on the card raises instead of computing through the plain version."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn import kernel
    from repro_torch.models.model_api import build_model

    cfg = get_config("zamba2-2.7b").reduced(dtype="float32", head_dim=80)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=card).manual_seed(0))
    monkeypatch.setattr(kernel, "SUPPORTED", kernel.SUPPORTED - {(80, 1)})
    with pytest.raises(ValueError, match="head dims"):
        model.decode_step(params, torch.zeros((2,), dtype=torch.int32, device=card),
                          model.init_cache(2, 8), 0)


# (arch, config overrides): each family's head shape at reduced widths
FAMILY_CARDS = [
    ("whisper-base", dict(head_dim=64, n_heads=4, n_kv_heads=4)),
    ("llava-next-34b", dict(head_dim=128, n_heads=14, n_kv_heads=2)),
    ("llama4-maverick-400b-a17b", dict(head_dim=128, n_heads=10, n_kv_heads=2)),
    ("qwen3-moe-235b-a22b", dict(head_dim=128, n_heads=16, n_kv_heads=1)),
]


@pytest.mark.parametrize("arch,over", FAMILY_CARDS)
def test_new_families_prefill_and_decode_on_the_card_through_the_kernel(card, arch, over):
    """A reduced whisper, llava, llama4 and qwen3-moe (f32, at their
    families' head shapes: Dh 64 G 1, Dh 128 G 7, 5 and 16) prefill on the
    card with no decode-kernel launch and decode with one decode-kernel launch per
    attention site and step (whisper: two a layer, self and cross); the
    logits equal the same weights' on the CPU (tests/test_model_consistency.py's
    atol 2e-4, rtol 2e-3)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
    from repro_torch.models import whisper
    from repro_torch.models.model_api import build_model

    cfg = get_config(arch).reduced(dtype="float32", **over)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=card).manual_seed(0))
    host = build_model(cfg, device="cpu")
    host_params = _to_cpu(params)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8), dtype=np.int32))
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model), dtype=np.float32))
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_patches, cfg.d_model), dtype=np.float32))
    before = decode_attn_cuda.launches
    got = model.prefill(params, {k: v.to(card) for k, v in batch.items()})
    assert decode_attn_cuda.launches == before
    want = host.prefill(host_params, batch)
    torch.testing.assert_close(got.cpu(), want, atol=2e-4, rtol=2e-3)
    cache, host_cache = model.init_cache(2, 8), host.init_cache(2, 8)
    sites = cfg.n_layers
    if cfg.family == "encdec":
        cache = whisper.encdec_prefill_cross(cfg, params, whisper.encode(
            cfg, params, batch["frames"].to(card)), cache)
        host_cache = whisper.encdec_prefill_cross(cfg, host_params, whisper.encode(
            cfg, host_params, batch["frames"]), host_cache)
        sites = 2 * cfg.n_layers
    for i in range(5):
        got, cache = model.decode_step(params, toks[:, i].to(card), cache, i)
        want, host_cache = host.decode_step(host_params, toks[:, i], host_cache, i)
        torch.testing.assert_close(got.cpu(), want, atol=2e-4, rtol=2e-3)
    assert decode_attn_cuda.launches == before + sites * 5


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


# ---------------------------------------------- the prefill attention kernel ---

#: (B, Lq, Lk, H, Hkv, Dh): zamba2-7b's site (scale (Dh/2)^-1/2); the other head
#: dims at 1, 4, 7 and 16 query heads a KV head; ragged lengths (1100; 777 and
#: 513, not multiples of 64); query and key lengths apart (whisper's cross
#: attention, 448 against 1500); 15 heads of 4096, whose grid ends in a
#: partial group of heads
FLASH_SHAPES = [
    (8, 4096, 4096, 32, 32, 224),
    (2, 1100, 1100, 4, 4, 32),
    (2, 777, 777, 16, 4, 64),
    (2, 513, 513, 7, 1, 80),
    (1, 1100, 1100, 56, 8, 128),
    (1, 1000, 1000, 64, 4, 128),
    (3, 4096, 4096, 5, 1, 128),
    (2, 600, 600, 16, 16, 256),
    (2, 448, 1500, 8, 8, 64),
    (8, 4096, 4096, 32, 2, 128),  # nemotron's attention layers: GQA 16:1
]
#: each output row (one query position of one head) against its own max|ref|,
#: so that the rows that see many keys, whose outputs are near 1/sqrt(keys),
#: cannot hide under the first rows' (one key's v): four bf16 ulps (2^-8 of the row's max|ref| each): both routes round P
#: to bf16, each against its own running max (64-key tiles here, 1024-key
#: chunks there), the plain route rounds each chunk's P·V, and both round the
#: output once more (read <= 1.06e-2)
FLASH_BF16_TOL = 4 * 2.0**-8
#: a planted fault the first rows cannot show: a warpgroup that reads 32 or
#: more tiles of keys leaves out its middle one
FLASH_MIDDLE_TILE = ("        if (j < mine) {",
                     "        if (j < mine && (mine < 32 || j != mine / 2)) {")


def _flash_inputs(card, B, Lq, Lk, H, Hkv, Dh, dtype, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=card).to(dtype)
                 for shape in ((B, Lq, H, Dh), (B, Lk, Hkv, Dh), (B, Lk, Hkv, Dh)))


def _row_rel(got, ref):
    """Max over the output rows (the last dim is the head dim) of
    max|d_row| / max|ref_row|."""
    d = (got.float() - ref.float()).abs().amax(-1)
    return (d / ref.float().abs().amax(-1).clamp_min(1e-30)).max().item()


def _flash_fault(tmp_path, sound, faulty):
    """A build of ``flash_attn.cu`` with ``sound`` replaced by ``faulty``."""
    from pathlib import Path

    from repro_torch.kernels.flash_attn import kernel
    from repro_torch.kernels.nvcc import CSRC, CudaLibrary

    src = (CSRC / "flash_attn.cu").read_text()
    assert src.count(sound) == 1
    path = Path(tmp_path) / "flash_attn_fault.cu"
    path.write_text(src.replace(sound, faulty))
    return CudaLibrary(str(path), kernel._bind).load()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Lq,Lk,H,Hkv,Dh", FLASH_SHAPES)
def test_flash_kernel_matches_the_plain_route(card, B, Lq, Lk, H, Hkv, Dh, causal):
    """One launch, each row within the tolerance above of
    ``common._flash_attention`` on the same inputs (TF32 off, as the plain
    route's f32 products need)."""
    from repro_torch.kernels.flash_attn.kernel import flash_attn_cuda
    from repro_torch.models.common import _flash_attention

    assert not torch.backends.cuda.matmul.allow_tf32
    scale = (Dh / 2) ** -0.5 if Dh == 224 else None
    q, k, v = _flash_inputs(card, B, Lq, Lk, H, Hkv, Dh, torch.bfloat16)
    before = flash_attn_cuda.launches
    got = flash_attn_cuda(q, k, v, causal, scale)
    assert flash_attn_cuda.launches == before + 1
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, Lq, H, Dh)
    want = _flash_attention(q, k, v, causal, 512, 1024, scale)
    assert _row_rel(got, want) <= FLASH_BF16_TOL


def test_flash_route_sends_a_float32_call_to_the_plain_version(card):
    """A float32 prefill call through ``common.flash_attention`` with grad off,
    at the benchmark's float32 check (2 rows of zamba2-7b's site): no
    launch, and ``common._flash_attention`` bit for bit."""
    from repro_torch.kernels.flash_attn.kernel import flash_attn_cuda
    from repro_torch.models.common import _flash_attention, flash_attention

    B, L, H, Dh = 2, 4096, 32, 224
    scale = (Dh / 2) ** -0.5
    q, k, v = _flash_inputs(card, B, L, L, H, H, Dh, torch.float32)
    before = flash_attn_cuda.launches
    with torch.no_grad():
        got = flash_attention(q, k, v, causal=True, scale=scale)
    assert flash_attn_cuda.launches == before
    assert torch.equal(got, _flash_attention(q, k, v, True, 512, 1024, scale))


def test_flash_kernel_reads_strided_views_of_a_fused_projection(card):
    """q, k and v as head slices of one [B, L, H + 2 Hkv, Dh] tensor (rows of
    (H + 2 Hkv) Dh elements): the same output, bit for bit, as from
    contiguous copies."""
    from repro_torch.kernels.flash_attn.kernel import flash_attn_cuda

    B, L, H, Hkv, Dh = 2, 700, 8, 2, 128
    qkv = torch.randn((B, L, H + 2 * Hkv, Dh), device=card,
                      generator=torch.Generator(device=card).manual_seed(0)).bfloat16()
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + Hkv], qkv[:, :, H + Hkv:]
    assert not q.is_contiguous()
    got = flash_attn_cuda(q, k, v, True)
    assert torch.equal(got, flash_attn_cuda(*(t.contiguous() for t in (q, k, v)), True))


def test_flash_limit_reads_a_causal_skip_one_tile_early(card, tmp_path):
    """A planted fault: the source with the causal skip one tile too early
    (each block's last tile of keys, the one its diagonal crosses, left
    out), built beside the sound one, reads far outside the tolerance that
    the sound kernel meets on the same inputs."""
    from repro_torch.kernels.flash_attn import kernel
    from repro_torch.models.common import _flash_attention

    faulty = _flash_fault(tmp_path, "return causal ? min(all, (end - 1) / bn + 1) : all;",
                          "return causal ? min(all, (end - 1) / bn) : all;")
    q, k, v = _flash_inputs(card, 2, 1100, 1100, 4, 2, 64, torch.bfloat16)
    want = _flash_attention(q, k, v, True, 512, 1024, None)
    assert _row_rel(kernel.flash_attn_cuda(q, k, v, True), want) <= FLASH_BF16_TOL
    assert _row_rel(kernel.launch(faulty, q, k, v, True, None), want) > 10 * FLASH_BF16_TOL


@pytest.mark.parametrize("B,L,H,Hkv,Dh,causal", [(8, 4096, 32, 32, 224, True),
                                                 (3, 4096, 5, 1, 128, False)])
def test_flash_limit_reads_the_middle_tile_left_out_of_long_rows(card, tmp_path, B, L, H, Hkv,
                                                                 Dh, causal):
    """A planted fault the first rows cannot show (``FLASH_MIDDLE_TILE``): rows that read 32 tiles of keys or more, whose
    outputs are a few hundredths where the first rows' are near one, leave
    out one tile of them.  At zamba2-7b's site and at a non-causal GQA
    shape, each row against its own max|ref| reads it far outside the
    tolerance that the sound kernel meets on the same inputs."""
    from repro_torch.kernels.flash_attn import kernel
    from repro_torch.models.common import _flash_attention

    faulty = _flash_fault(tmp_path, *FLASH_MIDDLE_TILE)
    scale = (Dh / 2) ** -0.5 if Dh == 224 else None
    q, k, v = _flash_inputs(card, B, L, L, H, Hkv, Dh, torch.bfloat16)
    want = _flash_attention(q, k, v, causal, 512, 1024, scale)
    assert _row_rel(kernel.flash_attn_cuda(q, k, v, causal, scale), want) <= FLASH_BF16_TOL
    assert _row_rel(kernel.launch(faulty, q, k, v, causal, scale), want) > 4 * FLASH_BF16_TOL


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-7b"])
def test_flash_counter_rises_a_prefill_and_stays_under_grad(card, arch):
    """``flash_attn_cuda.launches``: one an attention site in a prefill (bf16),
    none in a training step's loss and gradients (remat full: the forward
    and its recompute both on the plain route)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn.kernel import flash_attn_cuda
    from repro_torch.models.model_api import build_model
    from repro_torch.tree import tree_leaves

    if arch == "zamba2-7b":
        cfg = _tiny_zamba2("bfloat16")
        sites = cfg.n_sites
    else:
        cfg = get_config(arch).reduced(dtype="bfloat16")
        sites = cfg.n_layers
    cfg = dataclasses.replace(cfg, remat=True, remat_policy="full")
    model = build_model(cfg, card)
    params = model.init(torch.Generator(device=card).manual_seed(0))
    tok = torch.randint(0, cfg.vocab_size, (2, 65), device=card,
                        generator=torch.Generator(device=card).manual_seed(1))
    before = flash_attn_cuda.launches
    model.prefill(params, {"tokens": tok[:, :-1]})
    assert flash_attn_cuda.launches == before + sites
    leaves = [t for t in tree_leaves(params) if t.is_floating_point()]
    for t in leaves:
        t.requires_grad_(True)
    loss = model.loss(params, {"tokens": tok[:, :-1], "labels": tok[:, 1:]})
    torch.autograd.grad(loss, leaves)
    assert flash_attn_cuda.launches == before + sites


def test_zamba2_prefill_through_the_flash_kernel_equals_the_plain_route(card, monkeypatch):
    """A tiny bf16 zamba2 prefill on the card through the kernel (one launch a
    site) against the same weights' prefill on the plain route on the card
    (``ops.PLAIN_DEVICES`` widened to ``cuda``, the counter put): logits
    within 2e-2 of max|ref| (one bf16 ulp of attention's output, through
    seven layers)."""
    from repro_torch.kernels.flash_attn import ops
    from repro_torch.kernels.flash_attn.kernel import flash_attn_cuda
    from repro_torch.models.model_api import build_model

    cfg = _tiny_zamba2("bfloat16")
    model = build_model(cfg, card)
    params = model.init(torch.Generator(device=card).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 4 * cfg.ssm_chunk), dtype=np.int64)).to(card)
    before = flash_attn_cuda.launches
    got = model.prefill(params, {"tokens": toks})
    assert flash_attn_cuda.launches == before + cfg.n_sites
    monkeypatch.setattr(ops, "PLAIN_DEVICES", ("cpu", "meta", "cuda"))
    want = model.prefill(params, {"tokens": toks})
    assert flash_attn_cuda.launches == before + cfg.n_sites
    assert _rel(got, want) <= 2e-2


# ------------------------------------------------- nemotron's dropless MoE ---

def _moe_layer(card, T=32768, seed=0):
    """One MoE layer of nemotron-3-nano-30b-a3b at its published widths on
    the card (the benchmark's scales) and normed tokens x [T, D] in bf16."""
    from repro_torch.configs.port_only import get_port_config

    cfg = get_port_config("nemotron-3-nano-30b-a3b")
    g = torch.Generator(device=card).manual_seed(seed)
    D, E, F, Fs = cfg.d_model, cfg.n_experts, cfg.moe_d_ff, cfg.moe_shared_d_ff

    def draw(shape, std, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=card) * std).to(dtype)

    p = {"router": {"w": draw((D, E), 0.02, torch.float32)},
         "e_bias": draw((E,), 0.01, torch.float32),
         "w_up": draw((E, D, F), 0.02), "w_down": draw((E, F, D), 0.002),
         "shared_up": {"w": draw((D, Fs), 0.02)}, "shared_down": {"w": draw((Fs, D), 0.002)}}
    return cfg, p, draw((T, D), 1.0)


def test_moe_grouped_route_matches_the_plain_route_at_full_width(card, monkeypatch):
    """32,768 tokens, 196,608 routes: the grouped route's expert outputs
    against the plain route's (every expert over every token, masked) on the
    same routes, within 1e-2 of max|ref| (bf16 products of K 2688 and 1856
    summed in other orders); the layer the same bits on a second call."""
    from repro_torch.models import moe_dropless

    cfg, p, x = _moe_layer(card)
    ids, w = moe_dropless.route(cfg, p, x)
    got = moe_dropless.experts_grouped(p, x, ids)
    want = moe_dropless.experts_plain(p, x, ids)
    torch.cuda.synchronize()
    assert _rel(got, want) < 1e-2
    rows = moe_dropless.routed_rows
    a = moe_dropless.moe_apply(cfg, p, x[None])
    b = moe_dropless.moe_apply(cfg, p, x[None])
    assert torch.equal(a, b) and moe_dropless.routed_rows - rows == 2 * ids.numel()


def test_moe_grouped_route_makes_no_host_sync(card):
    from repro_torch.models import moe_dropless

    cfg, p, x = _moe_layer(card, T=4096)
    moe_dropless.moe_apply(cfg, p, x[None])  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ids, w = moe_dropless.route(cfg, p, x)
        moe_dropless.combine(moe_dropless.experts_grouped(p, x, ids), w)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_moe_grouped_route_is_dropless_when_every_token_picks_six_experts(card):
    from repro_torch.models import moe_dropless

    cfg, p, x = _moe_layer(card, T=8192)
    bias = torch.zeros_like(p["e_bias"])
    bias[10:16] = 10.0
    p = dict(p, e_bias=bias)
    ids, _ = moe_dropless.route(cfg, p, x)
    assert torch.equal(ids.sort(-1).values[0], torch.arange(10, 16, device=card))
    got = moe_dropless.experts_grouped(p, x, ids)
    want = moe_dropless.experts_plain(p, x, ids)
    assert _rel(got, want) < 1e-2 and got.abs().amin(-1).gt(0).float().mean() > 0.99


def test_nemotron_planted_flash_fault_moves_gqa_attention(card):
    """The benchmark's planted flash fault (``h100bench/nemotron_faults``:
    query head h reading KV head h % Hkv, a build of a changed copy of the
    source) at nemotron's heads, 32 over 2 of 128: the sound kernel within
    2e-2 of the plain route, the faulted one far outside it, and the sound
    build back once the fault's context closes."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from h100bench import nemotron_faults
    from repro_torch.models.common import _flash_attention, flash_attention

    g = torch.Generator(device=card).manual_seed(0)
    q = torch.randn((2, 512, 32, 128), generator=g, device=card).bfloat16()
    k, v = (torch.randn((2, 512, 2, 128), generator=g, device=card).bfloat16() for _ in range(2))
    want = _flash_attention(q, k, v, True, 512, 1024, 128 ** -0.5)
    with torch.no_grad():
        sound = flash_attention(q, k, v, causal=True, scale=128 ** -0.5)
        with nemotron_faults.planted("flash_wrong_kv_head", 0):
            bad = flash_attention(q, k, v, causal=True, scale=128 ** -0.5)
        after = flash_attention(q, k, v, causal=True, scale=128 ** -0.5)
    assert _rel(sound, want) < 2e-2 < 0.2 < _rel(bad, want)
    assert torch.equal(after, sound)


def test_nemotron_prefill_on_the_card_matches_the_reference(card):
    """A small nemotron_h whose widths every kernel takes (heads of 64 for
    the SSD and flash kernels, groups of 8 B/C channels, experts of 128):
    bf16 on the card through the pass, SSD, flash and grouped routes,
    against the float32 reference on the card's own routes, within 5e-2."""
    import dataclasses
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from h100bench.reference import nemotron_h as ref
    from repro_torch.configs.port_only import get_port_config
    from repro_torch.kernels.flash_attn.kernel import flash_attn_cuda
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.models import moe_dropless, nemotron_h
    from repro_torch.models.model_api import build_model

    cfg = dataclasses.replace(
        get_port_config("nemotron-3-nano-30b-a3b"), n_layers=5, layer_pattern="ME*ME",
        d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, vocab_size=512, mamba_num_heads=8,
        ssm_headdim=64, ssm_state=64, ssm_ngroups=2, ssm_chunk=64, n_experts=8,
        experts_per_token=2, moe_d_ff=128, moe_shared_d_ff=256)
    model = build_model(cfg, card)
    params = model.init(torch.Generator(device=card).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 256), dtype=np.int64)).to(card)
    launched = (flash_attn_cuda.launches, ssd_scan_cuda.launches)
    grouped = []
    real = moe_dropless.experts_grouped
    moe_dropless.experts_grouped = lambda *a: grouped.append(1) or real(*a)
    try:
        routes = []
        got = nemotron_h.nemotron_h_prefill(cfg, params, toks, routes)
    finally:
        moe_dropless.experts_grouped = real
    assert (flash_attn_cuda.launches - launched[0], ssd_scan_cuda.launches - launched[1]) == (1, 2)
    assert len(grouped) == 2
    keys = ("d_model", "vocab_size", "n_heads", "n_kv_heads", "head_dim", "layer_pattern",
            "mamba_num_heads", "ssm_headdim", "ssm_state", "ssm_ngroups", "ssm_conv_width",
            "ssm_chunk", "n_experts", "experts_per_token", "moe_d_ff", "moe_shared_d_ff",
            "routed_scaling_factor", "norm_eps")
    w = dict({k: getattr(cfg, k) for k in keys}, family=cfg.family)
    want = ref.prefill_logits(w, params, toks, routes=routes)
    assert _rel(got, want) < 5e-2


# ------------------------------- deepseek-v3: latent attention's split heads ---

#: the flash kernel's outputs (sha256 of the bf16 bits, first 16 hex digits) at
#: every (d, d) head dim, causal (1) or not (0), on CPU-drawn inputs (seed Dh;
#: q [2, 300, 4, Dh], k and v [2, 300, 2, Dh]), read from the kernel built with
#: one head dim, before it took v narrower than q and k (H100 80GB HBM3)
FLASH_BITS = {
    "32-1": "1c9d9aab7f8d5e87", "32-0": "f0f8b6a0e5cab61b", "64-1": "31549bc059059667",
    "64-0": "490ff682e35916bc", "80-1": "1e8803a0741f992b", "80-0": "cc3644c36cf23291",
    "128-1": "f6397efb1dd4380c", "128-0": "4d914aa181a377c3", "224-1": "38c8b9e886f75ae3",
    "224-0": "1edc31e95bc75315", "256-1": "bf41127571a64e02", "256-0": "41c982342e8fabe4",
}


def _mla_inputs(card, B, L, H, seed=0):
    """q and k of 192 and v of 128, v a view of a [B, L, H, 256] tensor (the
    model's ``[k_nope | v]``, W_kvb's output), as ``deepseek_v3.kv_proj``
    hands it to the kernel."""
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn((B, L, H, 192), generator=g, device=card).bfloat16()
    k = torch.randn((B, L, H, 192), generator=g, device=card).bfloat16()
    kv = torch.randn((B, L, H, 256), generator=g, device=card).bfloat16()
    return q, k, kv[..., 128:]


@pytest.mark.parametrize("B,L,H,causal", [(1, 16384, 8, True), (2, 1100, 4, False),
                                          (2, 777, 4, True)])
def test_flash_kernel_at_latent_attentions_split_heads(card, B, L, H, causal):
    """DeepSeek-V3's MLA heads (q, k 192; v 128) at its 16k prompts on a slice
    of its 128 heads, and at ragged lengths: one launch, the output [B, L, H,
    128], each row within the tolerance of the other head dims of the plain
    route on the same inputs, at the model's softmax scale."""
    from repro_torch.kernels.flash_attn.kernel import flash_attn_cuda
    from repro_torch.models.common import _flash_attention

    scale = 192 ** -0.5 * (0.1 * np.log(40) + 1) ** 2
    q, k, v = _mla_inputs(card, B, L, H)
    assert not v.is_contiguous()
    before = flash_attn_cuda.launches
    got = flash_attn_cuda(q, k, v, causal, scale)
    assert flash_attn_cuda.launches == before + 1 and tuple(got.shape) == (B, L, H, 128)
    want = _flash_attention(q, k, v, causal, 512, 1024, scale)
    assert _row_rel(got, want) <= FLASH_BF16_TOL


def test_flash_limit_reads_v_at_dqks_stride(card, tmp_path):
    """The benchmark's planted fault (``h100bench/deepseek_faults``: V's
    tensor map stepping heads by DQK, not by V's own stride), built from a
    changed copy of the source, reads far outside the tolerance the sound
    kernel meets on the same inputs."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from h100bench import deepseek_faults
    from repro_torch.kernels.flash_attn import kernel
    from repro_torch.models.common import _flash_attention

    faulty = _flash_fault(tmp_path, *deepseek_faults.FLASH_V_MAP)
    q, k, v = _mla_inputs(card, 1, 2048, 8)
    want = _flash_attention(q, k, v, True, 512, 1024, None)
    assert _row_rel(kernel.flash_attn_cuda(q, k, v, True), want) <= FLASH_BF16_TOL
    assert _row_rel(kernel.launch(faulty, q, k, v, True, None), want) > 10 * FLASH_BF16_TOL


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Dh", [32, 64, 80, 128, 224, 256])
def test_flash_kernel_gives_every_head_dim_the_bits_it_gave_before(card, Dh, causal):
    """Templating the kernel on (DQK, DV) left each (d, d) build's output as
    it was, bit for bit (:data:`FLASH_BITS`)."""
    import hashlib

    from repro_torch.kernels.flash_attn.kernel import flash_attn_cuda

    g = torch.Generator().manual_seed(Dh)
    q = torch.randn((2, 300, 4, Dh), generator=g).bfloat16().to(card)
    k, v = (torch.randn((2, 300, 2, Dh), generator=g).bfloat16().to(card) for _ in range(2))
    out = flash_attn_cuda(q, k, v, causal, None).cpu().view(torch.int16).numpy().tobytes()
    assert hashlib.sha256(out).hexdigest()[:16] == FLASH_BITS[f"{Dh}-{int(causal)}"]


# ---------------------------------------- deepseek-v3: the expert-parallel MoE ---

def _deepseek_moe_layer(card, T=32768, seed=0):
    """One MoE layer of deepseek-v3 at its published widths on the card, the
    benchmark's share (experts 0-7 of 256 held, top-8 over 8 groups, the best
    4 kept, SwiGLU), and normed tokens x [T, D] in bf16."""
    import dataclasses

    from repro_torch.configs.port_only import get_port_config

    cfg = dataclasses.replace(get_port_config("deepseek-v3"), n_experts_held=8)
    g = torch.Generator(device=card).manual_seed(seed)
    D, E, F, Fs, n = cfg.d_model, cfg.n_experts, cfg.moe_d_ff, cfg.moe_shared_d_ff, 8

    def draw(shape, std, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=card) * std).to(dtype)

    p = {"router": {"w": draw((D, E), 0.02, torch.float32)},
         "e_bias": draw((E,), 0.01, torch.float32),
         "w_gate_up": draw((n, D, 2 * F), 0.02), "w_down": draw((n, F, D), 0.002),
         "shared_gate_up": {"w": draw((D, 2 * Fs), 0.02)},
         "shared_down": {"w": draw((Fs, D), 0.002)}}
    return cfg, p, draw((T, D), 1.0)


def test_moe_grouped_route_on_deepseeks_share_matches_the_plain_route(card):
    """32,768 tokens, 262,144 routes, some 8,192 to the held experts: the
    grouped route's expert outputs against the plain route's on the same
    routes, within 1e-2 of max|ref| as nemotron's; the routes to experts not
    held zero on both; the layer the same bits on a second call; the held
    routes counted on the device."""
    from repro_torch.models import moe_dropless

    cfg, p, x = _deepseek_moe_layer(card)
    ids, w = moe_dropless.route(cfg, p, x)
    held = ids < 8
    got = moe_dropless.experts_grouped(p, x, ids, 0)
    want = moe_dropless.experts_plain(p, x, ids, 0)
    torch.cuda.synchronize()
    assert _rel(got, want) < 1e-2
    assert not got[~held].any() and not want[~held].any()
    assert 4096 < int(held.sum()) < 16384
    before = moe_dropless.held_count(x.device)
    a = moe_dropless.moe_apply(cfg, p, x[None])
    b = moe_dropless.moe_apply(cfg, p, x[None])
    assert torch.equal(a, b)
    assert moe_dropless.held_count(x.device) - before == 2 * int(held.sum())


def test_the_deepseek_drivers_counters_read_the_held_routes_on_the_card(card):
    """The benchmark driver's ``counters``, given the device as
    ``h100bench/run.py`` builds it (``torch.device("cuda")``, no index), read
    the routes a layer on a share counted on the card (a tensor on
    ``cuda:0``): the count the driver's model FLOPs take for the held
    experts."""
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    from h100bench.harness import load_module
    from repro_torch.models import moe_dropless

    drv = load_module(root / "h100bench" / "drivers" / "deepseek_prefill.py",
                      "test_deepseek_prefill_driver")
    cfg, p, x = _deepseek_moe_layer(card, T=4096, seed=1)
    ids, _ = moe_dropless.route(cfg, p, x)
    held = int((ids < 8).sum())
    before = drv.counters(torch.device("cuda"))
    moe_dropless.moe_apply(cfg, p, x[None])
    after = drv.counters(torch.device("cuda"))
    assert held > 0
    assert after[3] - before[3] == held
    assert after[2] - before[2] == 1
    assert moe_dropless.held_count("cuda") == moe_dropless.held_count(x.device) == after[3]


def test_moe_grouped_route_on_a_share_makes_no_host_sync(card):
    from repro_torch.models import moe_dropless

    cfg, p, x = _deepseek_moe_layer(card, T=4096)
    moe_dropless.moe_apply(cfg, p, x[None])  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        moe_dropless.moe_apply(cfg, p, x[None])
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _former_experts_grouped(p, x, ids):
    """``moe_dropless.experts_grouped`` as it was before the layer held a share
    of the experts and took SwiGLU ones (relu², every expert held)."""
    from repro_torch.models.moe_dropless import relu2

    T, k = ids.shape
    E = p["w_up"].shape[0]
    flat = ids.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    ends = torch.searchsorted(flat[order], torch.arange(E, device=x.device), right=True)
    ends = ends.to(torch.int32)
    rows = x[order // k]
    h = relu2(torch._grouped_mm(rows, p["w_up"], offs=ends))
    out = torch._grouped_mm(h, p["w_down"], offs=ends)
    back = torch.empty_like(order)
    back[order] = torch.arange(order.numel(), device=x.device)
    return out[back].reshape(T, k, -1)


def test_nemotrons_grouped_route_is_unchanged_by_the_share_and_swiglu(card):
    """nemotron's layer at its published widths on 32,768 tokens: its route
    and its grouped experts the same bits as the former code's."""
    from repro_torch.models import moe_dropless

    cfg, p, x = _moe_layer(card)
    ids, w = moe_dropless.route(cfg, p, x)
    scores = torch.sigmoid(x.float() @ p["router"]["w"].float())
    assert torch.equal(ids, torch.topk(scores + p["e_bias"], 6, dim=-1).indices)
    assert moe_dropless.holds_all(p)
    assert torch.equal(moe_dropless.experts_grouped(p, x, ids), _former_experts_grouped(p, x, ids))


def test_deepseek_prefill_on_the_card_matches_the_reference(card):
    """A small deepseek_v3 at latent attention's head dims (192 and 128, 2
    heads) on a share of its experts (8 of 16 held, from 4): bf16 on the card
    through the flash kernel (one launch a layer) and the grouped route,
    against the float32 reference on the card's own routes, within 5e-2."""
    import dataclasses
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from h100bench.reference import deepseek_v3 as ref
    from repro_torch.configs.port_only import get_port_config
    from repro_torch.kernels.flash_attn.kernel import flash_attn_cuda
    from repro_torch.models import deepseek_v3, moe_dropless
    from repro_torch.models.model_api import build_model

    cfg = dataclasses.replace(
        get_port_config("deepseek-v3"), n_layers=3, first_k_dense=1, d_model=256, n_heads=2,
        n_kv_heads=2, q_lora_rank=64, kv_lora_rank=64, d_ff=512, vocab_size=512, n_experts=16,
        n_experts_held=8, expert_offset=4, experts_per_token=4, n_group=4, topk_group=2,
        moe_d_ff=128, moe_shared_d_ff=128)
    model = build_model(cfg, card)
    params = model.init(torch.Generator(device=card).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 700), dtype=np.int64)).to(card)
    launched = flash_attn_cuda.launches
    grouped = []
    real = moe_dropless.experts_grouped
    moe_dropless.experts_grouped = lambda *a: grouped.append(1) or real(*a)
    try:
        routes = []
        got = deepseek_v3.deepseek_v3_prefill(cfg, params, toks, routes)
    finally:
        moe_dropless.experts_grouped = real
    assert flash_attn_cuda.launches - launched == cfg.n_layers and len(grouped) == 2
    keys = ("n_layers", "first_k_dense", "d_model", "vocab_size", "n_heads", "q_lora_rank",
            "kv_lora_rank", "qk_nope_dim", "qk_rope_dim", "v_head_dim", "d_ff", "n_experts",
            "n_experts_held", "expert_offset", "experts_per_token", "moe_d_ff",
            "moe_shared_d_ff", "n_group", "topk_group", "routed_scaling_factor", "norm_eps",
            "rope_theta", "rope_factor", "rope_original_max", "rope_beta_fast",
            "rope_beta_slow", "rope_mscale", "rope_mscale_all_dim")
    w = dict({k: getattr(cfg, k) for k in keys}, family=cfg.family)
    want = ref.prefill_logits(w, params, toks, routes=routes)
    assert _rel(got, want) < 5e-2
