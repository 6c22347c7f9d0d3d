"""Binding of the hand-written Hopper kernel ``csrc/s2d_conv.cu``.

The kernel replaces the JAX package's Pallas TPU kernel
``kernels/s2d_conv/kernel.py::_s2d_conv_kernel``: the fused
D2S -> 1x1 conv -> S2D variant, computed as one GEMM over the contiguous
views ``x.reshape(-1, C/g^2) @ w`` (the rearrangements cancel; see the
note at the top of the CUDA source).

The source is compiled with ``nvcc`` at first use into a shared library
with a plain C interface and loaded with ctypes (:mod:`..nvcc`).
Nothing is built or imported from CUDA when this module is imported.

:func:`s2d_conv_cuda` counts its launches in ``s2d_conv_cuda.launches``
(a plain integer, added to only where the kernel is launched), so a run
can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.nvcc import CudaLibrary

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.s2d_conv_gemm
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("s2d_conv.cu", _bind)
build = LIBRARY.build
load = LIBRARY.load


def s2d_conv_cuda(x: torch.Tensor, w: torch.Tensor, gamma: int) -> torch.Tensor:
    """The kernel on CUDA tensors. x: [B,H,W,C], w: [C/g^2, K/g^2] -> [B,H,W,K].

    Checks device, dtype, shape and contiguity, allocates the output,
    launches on the current stream without synchronising, and raises if
    the launch is refused."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(
            f"s2d_conv_cuda needs x and w on one CUDA device (got {x.device}, "
            f"{w.device}); CPU tensors go to ref.s2d_conv_ref"
        )
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(
            f"s2d_conv_cuda takes float32 or bfloat16 x and w of one dtype "
            f"(got {x.dtype}, {w.dtype})"
        )
    if x.dim() != 4 or w.dim() != 2:
        raise ValueError(f"x must be [B,H,W,C] and w [C/g^2, K/g^2] (got "
                         f"{tuple(x.shape)}, {tuple(w.shape)})")
    B, H, W, C = x.shape
    Cv, Kv = w.shape
    g2 = gamma * gamma
    if Cv * g2 != C:
        raise ValueError(f"w rows {Cv} != C/g^2 = {C}/{g2}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("s2d_conv_cuda needs contiguous x and w")
    out = torch.empty((B, H, W, Kv * g2), dtype=x.dtype, device=x.device)
    M = B * H * W * g2
    if M == 0 or Kv == 0:
        return out
    lib = load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.s2d_conv_gemm(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), M, Cv, Kv,
            _DTYPE_CODES[x.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(f"s2d_conv_gemm launch failed: cudaError {rc}")
    s2d_conv_cuda.launches += 1
    return out


s2d_conv_cuda.launches = 0
