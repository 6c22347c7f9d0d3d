"""Binding of the hand-written Hopper kernel ``csrc/decode_attn.cu``, and its grid planner.

The kernel replaces the JAX package's Pallas TPU kernel
``kernels/decode_attn/kernel.py::_decode_attn_kernel``: GQA attention of
one query token against a KV cache, reading only the first
``valid_len[b]`` positions of each row.  It is one launch: each
``(b, kv head)`` is a thread-block cluster of ``S`` blocks that stream
their shares of the cache through a ``cp.async`` ring in shared memory
and merge their online-softmax states through distributed shared memory
(see the note at the top of the CUDA source).  No workspace, no second
pass.  bf16 runs its products on the tensor cores, f32 on the CUDA
cores.

:func:`plan_splits` sizes the grid on the host, in plain Python, from an
upper bound on the valid length (the cache length, or ``pos + 1`` where
the caller knows it), ``B * Hkv``, the bytes of a cache position and the
SM count, never from ``valid_len`` itself, so a CUDA graph can replay
the launch;
:func:`split_rows` is the device's division of ``[0, valid_len[b])``
among a cluster's blocks.

The source is compiled with ``nvcc`` at first use into a shared library
with a plain C interface and loaded with ctypes (:mod:`..nvcc`).
Nothing is built or imported from CUDA when this module is imported.

:func:`decode_attn_cuda` counts its launches in
``decode_attn_cuda.launches`` (a plain integer, added to only where the
kernel is launched), so a run can show that its main path went through
the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.nvcc import DTYPE_CODES, CudaLibrary, check_launch, stream

HEAD_DIMS = (16, 32, 64, 128)
GROUPS = (1, 2, 4, 8)
#: (head dim, query heads per KV head) the kernel is built for: every pair of
#: HEAD_DIMS x GROUPS, zamba2-2.7b's (80, 1), gemma-7b's (256, 1), and at Dh 128
#: llama4-maverick's group of 5, llava-next-34b's 7 and qwen3-moe's 16
SUPPORTED = (frozenset((d, g) for d in HEAD_DIMS for g in GROUPS)
             | {(80, 1), (256, 1), (128, 5), (128, 7), (128, 16)})
MAX_SPLIT = 8  # blocks of a cluster, the portable maximum
#: bytes per us that one block streams through its ring, that the whole card
#: streams, and the time a cluster's merge adds (us): fitted on an H100 to the
#: sweep of splits that chip_smoke.py prints (bf16, Dh 64 and 256)
BLOCK_BYTES_PER_US = 27.5e3
CARD_BYTES_PER_US = 2.9e6
CLUSTER_US = 1.8


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.decode_attn
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("decode_attn.cu", _bind)
build = LIBRARY.build
load = LIBRARY.load


def split_cost(splits: int, batch: int, kv_heads: int, bound: int, row_bytes: int,
               n_sm: int) -> float:
    """Modelled time (us, launch aside) of ``splits`` blocks per
    ``(b, kv head)`` over ``bound`` positions of ``row_bytes`` (K and V):
    the busiest SM streams the rows of its ``ceil(B * Hkv * S / n_sm)``
    blocks at one block's rate, or the card all rows at its own, whichever
    is slower, and a cluster adds its merge."""
    rows = max(int(bound), 0)
    busiest = -(-batch * kv_heads * splits // n_sm) * -(-rows // splits) * row_bytes
    stream = max(busiest / BLOCK_BYTES_PER_US,
                 batch * kv_heads * rows * row_bytes / CARD_BYTES_PER_US)
    return stream + (CLUSTER_US if splits > 1 else 0.0)


def plan_splits(batch: int, kv_heads: int, bound: int, row_bytes: int, n_sm: int) -> int:
    """Blocks per ``(b, kv head)`` for at most ``bound`` valid positions:
    the split in 1..``MAX_SPLIT`` of least :func:`split_cost`, the smaller
    on a tie."""
    return min(range(1, MAX_SPLIT + 1),
               key=lambda s: (split_cost(s, batch, kv_heads, bound, row_bytes, n_sm), s))


def split_rows(valid: int, length: int, splits: int, rank: int) -> Tuple[int, int]:
    """Cache positions ``[start, end)`` that block ``rank`` of a cluster of
    ``splits`` reads, as the kernel computes them."""
    valid = min(max(valid, 0), length)
    per = -(-valid // splits)
    start = min(rank * per, valid)
    return start, min(start + per, valid)


def decode_attn_cuda(
    q: torch.Tensor,  # [B, H, Dh]
    cache_k: torch.Tensor,  # [B, L, Hkv, Dh]
    cache_v: torch.Tensor,
    valid_len: torch.Tensor,  # [B] int32: cache positions to attend to
    bound: Optional[int] = None,
    splits: Optional[int] = None,
) -> torch.Tensor:
    """The kernel on CUDA tensors -> out [B, H, Dh] in q's dtype.

    Checks device, dtype, shape, contiguity and alignment, allocates the
    output, launches on the current stream without synchronising, and
    raises if the launch is refused.  ``bound`` is an upper bound on
    ``valid_len`` (the cache length when None) from which
    :func:`plan_splits` sizes the grid; ``splits`` (1 to 8) overrides it.
    The result is right for any of them."""
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (cache_k, cache_v, valid_len)):
        raise ValueError(
            "decode_attn_cuda needs q, cache_k, cache_v and valid_len on one CUDA device "
            f"(got {q.device}, {cache_k.device}, {cache_v.device}, {valid_len.device}); "
            "CPU tensors go to ref.decode_attention"
        )
    if q.dtype not in DTYPE_CODES or cache_k.dtype != q.dtype or cache_v.dtype != q.dtype:
        raise ValueError(
            "decode_attn_cuda takes float32 or bfloat16 q, cache_k and cache_v of one dtype "
            f"(got {q.dtype}, {cache_k.dtype}, {cache_v.dtype})"
        )
    if q.dim() != 3 or cache_k.dim() != 4 or cache_v.shape != cache_k.shape:
        raise ValueError(
            "q must be [B, H, Dh] and cache_k / cache_v one [B, L, Hkv, Dh] shape (got "
            f"{tuple(q.shape)}, {tuple(cache_k.shape)}, {tuple(cache_v.shape)})"
        )
    B, H, Dh = q.shape
    Bc, L, Hkv, Dhc = cache_k.shape
    if Bc != B or Dhc != Dh or Hkv == 0 or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match the cache {tuple(cache_k.shape)}")
    G = H // Hkv
    if (Dh, G) not in SUPPORTED:
        raise ValueError(
            f"decode_attn_cuda supports head dims {HEAD_DIMS} with groups H/Hkv in {GROUPS}, "
            f"head dims 80 and 256 with group 1, and head dim 128 with groups 5, 7 and 16 "
            f"(got Dh={Dh}, G={G})"
        )
    if valid_len.dtype != torch.int32 or tuple(valid_len.shape) != (B,):
        raise ValueError(f"valid_len must be int32 [B={B}] (got {valid_len.dtype} "
                         f"{tuple(valid_len.shape)})")
    if not all(t.is_contiguous() for t in (q, cache_k, cache_v, valid_len)):
        raise ValueError("decode_attn_cuda needs contiguous q, cache_k, cache_v and valid_len")
    if any(t.data_ptr() % 16 for t in (q, cache_k, cache_v)):
        raise ValueError("decode_attn_cuda reads 16-byte vectors: q, cache_k and cache_v "
                         "must start at 16-byte aligned addresses")
    if splits is not None and not 1 <= splits <= MAX_SPLIT:
        raise ValueError(f"splits must lie in 1..{MAX_SPLIT} (got {splits})")
    out = torch.empty((B, H, Dh), dtype=q.dtype, device=dev)
    if splits is None:
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        splits = plan_splits(B, Hkv, L if bound is None else min(bound, L),
                             2 * Dh * q.element_size(), n_sm)
    lib = load()
    with torch.cuda.device(dev):
        rc = lib.decode_attn(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), valid_len.data_ptr(),
            out.data_ptr(), B, L, Hkv, G, Dh, splits, DTYPE_CODES[q.dtype], stream(dev),
        )
    check_launch("decode_attn", rc)
    decode_attn_cuda.launches += 1
    return out


decode_attn_cuda.launches = 0
