"""Binding of the hand-written Hopper kernel ``csrc/ssd_scan.cu``.

The kernel replaces the JAX package's Pallas TPU kernel
``kernels/ssd_scan/kernel.py::_ssd_kernel``: the Mamba2 SSD chunked scan.
A call makes two launches (see the note at the top of the CUDA source):
``ssd_scan_cb_kernel`` computes C Bᵀ once per (batch row, chunk, group of
B and C) into an f32 workspace ``[Bt, L/Q, G, Q, Q]``
(:func:`workspace_shape`), which the wrapper allocates; ``ssd_scan_kernel``,
one block per (head, batch row), walks the chunks in order with the state
in shared memory and reads its group's.  B and C are ``[Bt, L, N]``,
shared by every head, or ``[Bt, L, G, N]``, head h reading group h G / H.

The source is compiled with ``nvcc`` at first use into a shared library
with a plain C interface and loaded with ctypes (:mod:`..nvcc`).
Nothing is built or imported from CUDA when this module is imported.

:func:`ssd_scan_cuda` counts its calls in ``ssd_scan_cuda.launches`` (a
plain integer, added to once a call, where the two kernels are launched),
so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.nvcc import DTYPE_CODES, CudaLibrary, check_launch, stream

HEAD_DIMS = (8, 16, 32, 64, 128)  # P
SMEM_MAX = 232448  # bytes of shared memory one block may use on Hopper
_TILE = 64  # rows of the kernel's C, B and G tiles


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.ssd_scan
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("ssd_scan.cu", _bind)
build = LIBRARY.build
load = LIBRARY.load


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _layout_bytes(P: int, N: int, Q: int, itemsize: int, stages: int) -> int:
    nk, qp = _round_up(N, 16), _round_up(Q, _TILE)
    xs = P + 16 if P % 32 == 8 else P + 8
    f32 = nk * xs + qp * xs + stages * _TILE * (_TILE + 4) + 2 * qp
    return 4 * f32 + stages * _TILE * (nk + 8) * itemsize


def ring_stages(P: int, N: int, Q: int, itemsize: int = 4) -> int:
    """Buffers of each of the block's two copy rings: 2 where they fit in
    shared memory, else 1 (the copies then no longer overlap the products)."""
    return 2 if _layout_bytes(P, N, Q, itemsize, 2) <= SMEM_MAX else 1


def smem_bytes(P: int, N: int, Q: int, itemsize: int = 4) -> int:
    """Shared memory of one ``ssd_scan_kernel`` block (``scan_smem_bytes``
    in the source), for x, B and C of ``itemsize`` bytes: in f32 the state
    [NK, XS], xdt [QP, XS], :func:`ring_stages` G tiles [64, 68] and the
    chunk's cumsum and decay weights [QP]; as many C / B tiles [64, NK + 8]
    in x's dtype.  NK is N rounded up to 16, QP is Q rounded up to 64, and
    XS is the padded row of P (P + 8, or P + 16 at P = 8)."""
    return _layout_bytes(P, N, Q, itemsize, ring_stages(P, N, Q, itemsize))


def workspace_shape(Bt: int, L: int, Q: int, G: int = 1) -> tuple:
    """Shape of the f32 workspace that holds C Bᵀ of every (batch row,
    chunk, group): ``[Bt, L // Q, G, Q, Q]`` (only its causal 64 x 64 tiles
    are written and read)."""
    return (Bt, L // Q, G, Q, Q)


def ssd_scan_cuda(
    x: torch.Tensor,  # [Bt, L, H, P]
    log_a: torch.Tensor,  # [Bt, L, H]
    B: torch.Tensor,  # [Bt, L, N] or [Bt, L, G, N]
    C: torch.Tensor,  # as B
    dt: torch.Tensor,  # [Bt, L, H]
    chunk: int = 256,
) -> torch.Tensor:
    """The kernel on CUDA tensors -> y [Bt, L, H, P] in x's dtype.

    ``x``, ``B`` and ``C`` are float32 or bfloat16, of one dtype;
    ``log_a`` and ``dt`` are cast to float32 (the Pallas kernel's first
    step).  B and C hold one group (``[Bt, L, N]``) or G (``[Bt, L, G, N]``,
    H a multiple of G).  Checks device, dtypes, shapes, contiguity and
    ``L % Q == 0`` (``Q = min(chunk, L)``), allocates the output and the
    C Bᵀ workspace, launches both kernels on the current stream without
    synchronising, and raises if a launch is refused."""
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in (log_a, B, C, dt)):
        raise ValueError(
            "ssd_scan_cuda needs x, log_a, B, C and dt on one CUDA device (got "
            f"{x.device}, {log_a.device}, {B.device}, {C.device}, {dt.device}); "
            "CPU tensors go to ref.ssd_chunked"
        )
    if x.dtype not in DTYPE_CODES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(
            "ssd_scan_cuda takes float32 or bfloat16 x, B and C of one dtype "
            f"(got {x.dtype}, {B.dtype}, {C.dtype})"
        )
    if not (log_a.is_floating_point() and dt.is_floating_point()):
        raise ValueError(f"log_a and dt must be floating point (got {log_a.dtype}, {dt.dtype})")
    if x.dim() != 4 or B.dim() not in (3, 4):
        raise ValueError(f"x must be [Bt, L, H, P] and B, C [Bt, L, N] or [Bt, L, G, N] (got "
                         f"{tuple(x.shape)}, {tuple(B.shape)})")
    if B.dim() == 3:  # one group, shared by every head
        B, C = B.unsqueeze(2), C.unsqueeze(2)
    Bt, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if (tuple(B.shape) != (Bt, L, G, N) or tuple(C.shape) != (Bt, L, G, N) or G < 1 or H % G
            or tuple(log_a.shape) != (Bt, L, H) or tuple(dt.shape) != (Bt, L, H)):
        raise ValueError(
            f"shapes do not match x [Bt, L, H, P] = {tuple(x.shape)} (H a multiple of B's groups): "
            f"B {tuple(B.shape)}, "
            f"C {tuple(C.shape)}, log_a {tuple(log_a.shape)}, dt {tuple(dt.shape)}"
        )
    if P not in HEAD_DIMS:
        raise ValueError(f"ssd_scan_cuda supports head dims P in {HEAD_DIMS} (got {P})")
    Q = min(chunk, L)
    if Q <= 0 or L % Q:
        raise ValueError(f"sequence length {L} is not a multiple of the chunk {Q}")
    smem = smem_bytes(P, N, Q, x.element_size())
    if smem > SMEM_MAX:
        raise ValueError(
            f"P={P}, N={N}, Q={Q} in {x.dtype} needs {smem} bytes of shared memory per "
            f"block, more than the {SMEM_MAX} a block may use"
        )
    if not all(t.is_contiguous() for t in (x, log_a, B, C, dt)):
        raise ValueError("ssd_scan_cuda needs contiguous x, log_a, B, C and dt")
    log_a = log_a.to(torch.float32)
    dt = dt.to(torch.float32)
    out = torch.empty_like(x)
    if Bt * L * H == 0:
        return out
    lib = load()
    with torch.cuda.device(dev):
        # from the caching allocator (under CUDA-graph capture, the graph's own pool)
        cb = torch.empty(workspace_shape(Bt, L, Q, G), dtype=torch.float32, device=dev)
        rc = lib.ssd_scan(
            x.data_ptr(), log_a.data_ptr(), B.data_ptr(), C.data_ptr(), dt.data_ptr(),
            cb.data_ptr(), out.data_ptr(), Bt, L, H, P, N, Q, G, DTYPE_CODES[x.dtype],
            stream(dev),
        )
    check_launch("ssd_scan", rc)
    ssd_scan_cuda.launches += 1
    return out


ssd_scan_cuda.launches = 0
