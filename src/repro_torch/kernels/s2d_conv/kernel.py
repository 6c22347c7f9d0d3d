"""Binding of the hand-written Hopper kernel ``csrc/s2d_conv.cu``.

The kernel replaces the JAX package's Pallas TPU kernel
``kernels/s2d_conv/kernel.py::_s2d_conv_kernel``: the fused
D2S -> 1x1 conv -> S2D variant, computed as one GEMM over the contiguous
views ``x.reshape(-1, C/g^2) @ w`` (the rearrangements cancel; see the
note at the top of the CUDA source).

The source is compiled with ``nvcc`` at first use into a shared library
with a plain C interface, cached by the source's hash under
``csrc/build/`` (listed in ``.gitignore``), and loaded with ctypes.
Nothing is built or imported from CUDA when this module is imported.

:func:`s2d_conv_cuda` counts its launches in ``s2d_conv_cuda.launches``
(a plain integer, added to only where the kernel is launched), so a run
can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
SOURCE = CSRC / "s2d_conv.cu"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found: the s2d-conv kernel is built from "
            f"{SOURCE.name} with the CUDA toolkit"
        )
    return nvcc


def build(verbose: bool = False) -> Path:
    """Compile the kernel library if this source has not been built yet;
    returns its path.  ``verbose`` adds ``-Xptxas -v`` and prints the
    compiler's report (registers, shared memory, spills)."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libs2d_conv-{tag}.so"
    if lib.exists() and not verbose:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name and rename into place, so concurrent
    # builders never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {SOURCE.name}:\n{proc.stderr}"
            )
        if verbose:
            print(proc.stderr.strip())
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.s2d_conv_gemm
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


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
