"""Binding of the hand-written Hopper kernel ``csrc/flash_attn.cu``.

The forward pass of ``models.common.flash_attention`` on the no-grad CUDA
route (see the note at the top of the CUDA source): one launch a call, q
``[B, Lq, H, Dh]`` against k ``[B, Lk, Hkv, Dh]`` and v ``[B, Lk, Hkv,
Dv]``, head h reading KV head ``h / (H / Hkv)``, causal (query i sees keys
0..i) or not, in bf16 on wgmma with TMA loads read straight from the
tensors' strides.  V is as wide as q and k (:data:`HEAD_DIMS`), or the
pair ``(Dh, Dv)`` is latent attention's (:data:`SPLIT_HEADS`).  A float32
call takes the plain route (``ops``), not this kernel.

:func:`flash_attn_cuda` checks dtype, shape, head dims, groups, strides and
alignment, then the device, and raises on what the kernel does not take;
it allocates the output ``[B, Lq, H, Dv]`` with ``torch.empty``, raises if
the launch is refused, and counts its launches in
``flash_attn_cuda.launches`` (a plain integer), so a run can show that its
main path went through the kernel.  :func:`launch` is the launch itself,
on any build of the source (the card tests build a changed copy to plant
a fault).  :func:`smem_bytes` is the shared memory a block of the kernel
asks for, the plan the CPU tests check.

The source is compiled with ``nvcc`` at first use into a shared library
with a plain C interface and loaded with ctypes (:mod:`..nvcc`).  Nothing
is built or imported from CUDA when this module is imported.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.nvcc import CudaLibrary, check_launch, stream

#: the head dims the kernel is built for: the tiny twins' 32, llama3.2-1b's and
#: whisper's 64, zamba2-2.7b's 80, the Dh-128 families', zamba2-7b's 224, gemma-7b's 256
HEAD_DIMS = (32, 64, 80, 128, 224, 256)
#: (Dh, Dv) pairs of q and k against v built beside them: DeepSeek-V3's latent
#: attention (128 no-position dims and 64 rope dims in q and k, values of 128)
SPLIT_HEADS = ((192, 128),)
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper
#: query rows a block, keys a tile, head-dim columns a 128-byte swizzled
#: chunk, tiles in flight
BLOCK_M, BLOCK_N, CHUNK, STAGES = 128, 64, 64, 2
TMAP_ERROR = 1000  # launch codes from here up: cuTensorMapEncodeTiled refused a tensor map


def smem_bytes(head_dim: int, v_dim: Optional[int] = None) -> int:
    """Dynamic shared memory a block of the kernel asks for at ``head_dim``
    (q and k) and ``v_dim`` (v; None: ``head_dim``): Q (BLOCK_M rows) and
    STAGES x (K + V) (BLOCK_N rows each), each head dim in 128-byte chunks
    rounded up to CHUNK columns, 1024 bytes to align them, and the
    mbarriers."""
    chunks = -(-head_dim // CHUNK)
    chunks_v = -(-(head_dim if v_dim is None else v_dim) // CHUNK)
    q, k, v = chunks * BLOCK_M * 128, chunks * BLOCK_N * 128, chunks_v * BLOCK_N * 128
    return 1024 + q + STAGES * (k + v) + 8 * (1 + 2 * STAGES)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = lib.flash_attn_fwd
    fn.argtypes = [p] * 4 + [i] * 7 + [ll] * 9 + [ctypes.c_float, i, p]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("flash_attn.cu", _bind)
build = LIBRARY.build
load = LIBRARY.load


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    name = "flash_attn_cuda"
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name} takes q [B, Lq, H, Dh], k [B, Lk, Hkv, Dh] and v [B, Lk, "
                         f"Hkv, Dv] (got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)})")
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise ValueError(f"{name} takes q, k and v all in bfloat16 (got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}); float32 goes to common._flash_attention")
    B, _, H, Dh = q.shape
    Dv = v.shape[3]
    if tuple(k.shape[:3]) != tuple(v.shape[:3]) or k.shape[0] != B or k.shape[3] != Dh:
        raise ValueError(f"{name}: k {tuple(k.shape)} and v {tuple(v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if not (Dh == Dv and Dh in HEAD_DIMS or (Dh, Dv) in SPLIT_HEADS):
        raise ValueError(f"{name} takes head dims {HEAD_DIMS} with v as wide, or (q and k, v) "
                         f"of {SPLIT_HEADS} (got {Dh}, {Dv})")
    Hkv = k.shape[2]
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"{name}: the {H} query heads are not whole groups of the {Hkv} KV heads")
    for t, n in ((q, "q"), (k, "k"), (v, "v")):
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a contiguous last dim of {n} (strides {t.stride()})")
    for t, n in ((q, "q"), (k, "k"), (v, "v")):  # TMA: 16-byte aligned bases and strides
        if any(s % 8 for s in t.stride()[:3]):
            raise ValueError(f"{name} needs {n}'s strides in multiples of 16 bytes (strides "
                             f"{t.stride()})")
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name} needs {n} at a 16-byte aligned address")
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"{name} needs q, k and v on one CUDA device (got {q.device}, {k.device}, "
                         f"{v.device}); CPU tensors go to common._flash_attention")


def flash_attn_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention of ``q [B, Lq, H, Dh]`` over ``k [B, Lk, Hkv, Dh]`` and
    ``v [B, Lk, Hkv, Dv]``, in bf16: ``softmax(q kᵀ scale, masked) v``
    ``[B, Lq, H, Dv]``, ``scale`` None being 1/sqrt(Dh), as
    ``common._flash_attention`` computes it."""
    _check(q, k, v)
    out = launch(load(), q, k, v, causal, scale)
    flash_attn_cuda.launches += 1
    return out


def launch(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           scale: Optional[float]) -> torch.Tensor:
    """One launch of ``lib``'s ``flash_attn_fwd`` (a build of the source) on
    inputs :func:`flash_attn_cuda` has checked; the new output."""
    B, Lq, H, Dh = q.shape
    Lk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    scale = float(1.0 / np.sqrt(Dh)) if scale is None else float(scale)
    out = torch.empty((B, Lq, H, Dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Lq, Lk, H, Hkv, Dh, Dv,
            q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), scale, int(bool(causal)), stream(q.device))
    if rc >= TMAP_ERROR:
        raise RuntimeError(f"flash_attn_cuda: cuTensorMapEncodeTiled refused a tensor map "
                           f"(CUresult {rc - TMAP_ERROR})")
    check_launch("flash_attn_cuda", rc)
    return out


flash_attn_cuda.launches = 0
