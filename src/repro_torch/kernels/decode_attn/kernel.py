"""Binding of the hand-written Hopper kernel ``csrc/decode_attn.cu``.

The kernel replaces the JAX package's Pallas TPU kernel
``kernels/decode_attn/kernel.py::_decode_attn_kernel``: GQA attention of
one query token against a KV cache, reading only the first
``valid_len[b]`` positions of each row, in two passes (the cache split
across blocks, then a merge of the splits' online-softmax states; see
the note at the top of the CUDA source).

The source is compiled with ``nvcc`` at first use into a shared library
with a plain C interface and loaded with ctypes (:mod:`..nvcc`).
Nothing is built or imported from CUDA when this module is imported.

:func:`decode_attn_cuda` counts its launches in
``decode_attn_cuda.launches`` (a plain integer, added to only where the
kernel is launched; one launch runs both passes), so a run can show that
its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.nvcc import CudaLibrary

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
GROUPS = (1, 2, 4, 8)
#: (head dim, query heads per KV head) the kernel is built for: every pair of
#: HEAD_DIMS x GROUPS, and gemma-7b's (256, 1)
SUPPORTED = frozenset((d, g) for d in HEAD_DIMS for g in GROUPS) | {(256, 1)}
MIN_SPLIT_ROWS = 16  # fewest cache positions worth a block of their own


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.decode_attn
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("decode_attn.cu", _bind)
build = LIBRARY.build
load = LIBRARY.load


def default_splits(device: torch.device, batch: int, kv_heads: int, length: int) -> int:
    """Pieces each row's cache is cut into: enough blocks for two per SM,
    but no piece shorter than ``MIN_SPLIT_ROWS`` of the cache length."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    want = -(-2 * n_sm // (batch * kv_heads))
    return max(1, min(want, -(-length // MIN_SPLIT_ROWS)))


def decode_attn_cuda(
    q: torch.Tensor,  # [B, H, Dh]
    cache_k: torch.Tensor,  # [B, L, Hkv, Dh]
    cache_v: torch.Tensor,
    valid_len: torch.Tensor,  # [B] int32: cache positions to attend to
) -> torch.Tensor:
    """The kernel on CUDA tensors -> out [B, H, Dh] in q's dtype.

    Checks device, dtype, shape, contiguity and alignment, allocates the
    output and the workspace of the :func:`default_splits` blocks that
    share each row's cache, launches on the current stream without
    synchronising, and raises if the launch is refused."""
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (cache_k, cache_v, valid_len)):
        raise ValueError(
            "decode_attn_cuda needs q, cache_k, cache_v and valid_len on one CUDA device "
            f"(got {q.device}, {cache_k.device}, {cache_v.device}, {valid_len.device}); "
            "CPU tensors go to ref.decode_attention"
        )
    if q.dtype not in _DTYPE_CODES or cache_k.dtype != q.dtype or cache_v.dtype != q.dtype:
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
            f"and head dim 256 with group 1 (got Dh={Dh}, G={G})"
        )
    if valid_len.dtype != torch.int32 or tuple(valid_len.shape) != (B,):
        raise ValueError(f"valid_len must be int32 [B={B}] (got {valid_len.dtype} "
                         f"{tuple(valid_len.shape)})")
    if not all(t.is_contiguous() for t in (q, cache_k, cache_v, valid_len)):
        raise ValueError("decode_attn_cuda needs contiguous q, cache_k, cache_v and valid_len")
    if any(t.data_ptr() % 16 for t in (q, cache_k, cache_v)):
        raise ValueError("decode_attn_cuda reads 16-byte vectors: q, cache_k and cache_v "
                         "must start at 16-byte aligned addresses")
    out = torch.empty((B, H, Dh), dtype=q.dtype, device=dev)
    S = default_splits(dev, B, Hkv, L)
    work = torch.empty(B * Hkv * S * G * (Dh + 2), dtype=torch.float32, device=dev)
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.decode_attn(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), valid_len.data_ptr(),
            out.data_ptr(), work.data_ptr(), B, L, Hkv, G, Dh, S,
            _DTYPE_CODES[q.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(f"decode_attn launch failed: cudaError {rc}")
    decode_attn_cuda.launches += 1
    return out


decode_attn_cuda.launches = 0
