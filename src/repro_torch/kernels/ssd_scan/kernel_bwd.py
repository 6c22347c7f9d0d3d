"""Binding of the hand-written Hopper kernel ``csrc/ssd_scan_bwd.cu``: the
SSD scan's backward, all five gradients from the forward's saved inputs.

It replaces no Pallas kernel: the JAX package differentiates its plain
blocked ``ssd_chunked``.  :func:`ssd_scan_bwd_cuda` computes what
``ref.ssd_chunked_grads`` writes out, in f32 on the tensor cores (split
TF32 where an operand is f32), in nine launches (see the note at the top of
the CUDA source), and stores dx, dB and dC in x's dtype and dlog_a and ddt
in f32, cast to their inputs' dtypes.  The wrapper allocates the outputs and
the f32 intermediates (:func:`workspace_shapes`) from the caching allocator.

The source has a library of its own, built and loaded at the first call
(:mod:`..nvcc`), so a process that never differentiates the scan never
builds it.  ``ssd_scan_bwd_cuda.launches`` counts the calls.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.kernels.nvcc import DTYPE_CODES, CudaLibrary, check_launch, stream
from repro_torch.kernels.ssd_scan.kernel import HEAD_DIMS, SMEM_MAX

TILE = 64  # rows and columns of the kernels' output tiles
_TILES_BYTES = 2 * 2304 * 4 + 4 * TILE * 4  # a block's two operand slabs and a row reduction


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.ssd_scan_bwd
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("ssd_scan_bwd.cu", _bind)
build = LIBRARY.build
load = LIBRARY.load

#: the kernel's f32 intermediates, in the order of its C interface
WORKSPACES = ("cum", "ecum", "erev", "Gm", "dGm", "Sst", "Dst", "spart", "rpart", "vpart",
              "upart", "dpart")


def workspace_shapes(Bt: int, L: int, H: int, P: int, N: int, Q: int,
                     G: int = 1) -> Dict[str, Tuple[int, ...]]:
    """The f32 buffers a call needs: cum, e^cum and e^{T - cum} [Bt, L, H];
    C Bᵀ and its gradient summed over each group's heads [Bt, L/Q, G, Q, Q];
    the states entering each chunk and the gradients of those leaving it
    [Bt, L/Q, H, N, P]; e^T <S, dS'> in parts of 256 state elements
    [Bt, L/Q, H, ceil(N P / 256)]; and per tile of 64 head columns the row
    sums dy·y and x·dxdt each without the diagonal term, x·(dS' part of
    dxdt) and x·dxdt [., Bt, L, H]."""
    nc, npt = L // Q, -(-P // TILE)
    return dict(cum=(Bt, L, H), ecum=(Bt, L, H), erev=(Bt, L, H), Gm=(Bt, nc, G, Q, Q),
                dGm=(Bt, nc, G, Q, Q), Sst=(Bt, nc, H, N, P), Dst=(Bt, nc, H, N, P),
                spart=(Bt, nc, H, -(-N * P // 256)), rpart=(npt, Bt, L, H),
                vpart=(npt, Bt, L, H), upart=(npt, Bt, L, H), dpart=(npt, Bt, L, H))


def smem_bytes(L: int, Q: int, heads: int = 1) -> int:
    """The most shared memory a block of the call takes: beside the operand
    slabs, a chunk's staged cum, dt and decays [3, Q] or the decays and dt
    of a group's ``heads`` at a tile's rows and columns [3, heads, 64]; or the
    chunk walk's e^T and partial sums [9, L/Q]."""
    return max(_TILES_BYTES + 3 * Q * 4, _TILES_BYTES + 3 * heads * TILE * 4,
               9 * (L // Q) * 4)


def ssd_scan_bwd_cuda(
    x: torch.Tensor,  # [Bt, L, H, P]
    log_a: torch.Tensor,  # [Bt, L, H]
    B: torch.Tensor,  # [Bt, L, N] or [Bt, L, G, N]
    C: torch.Tensor,  # as B
    dt: torch.Tensor,  # [Bt, L, H]
    dy: torch.Tensor,  # [Bt, L, H, P], the output's gradient
    chunk: int = 256,
    needs: Sequence[bool] = (True,) * 5,
) -> tuple:
    """The gradients ``(dx, dlog_a, dB, dC, ddt)`` of ``ssd_scan_cuda(x,
    log_a, B, C, dt, chunk)`` against ``dy`` on CUDA tensors, each in its
    input's dtype and shape; None where ``needs`` is false (those the kernel
    does not need on the way are not computed).

    Takes what the forward takes (x, B, C float32 or bfloat16 of one dtype;
    log_a and dt cast to float32; P in ``HEAD_DIMS``; G groups with H a
    multiple of G; ``L % Q == 0``), checks it the same way, and launches on
    the current stream without synchronising; a shape whose blocks need more
    shared memory than a block may use raises a ``ValueError``."""
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in (log_a, B, C, dt, dy)):
        raise ValueError(
            "ssd_scan_bwd_cuda needs x, log_a, B, C, dt and dy on one CUDA device (got "
            f"{x.device}, {log_a.device}, {B.device}, {C.device}, {dt.device}, {dy.device}); "
            "CPU tensors go to ops.plain_grads"
        )
    if x.dtype not in DTYPE_CODES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(
            "ssd_scan_bwd_cuda takes float32 or bfloat16 x, B and C of one dtype "
            f"(got {x.dtype}, {B.dtype}, {C.dtype})"
        )
    if not (log_a.is_floating_point() and dt.is_floating_point() and dy.is_floating_point()):
        raise ValueError(f"log_a, dt and dy must be floating point (got {log_a.dtype}, "
                         f"{dt.dtype}, {dy.dtype})")
    if x.dim() != 4 or B.dim() not in (3, 4):
        raise ValueError(f"x must be [Bt, L, H, P] and B, C [Bt, L, N] or [Bt, L, G, N] (got "
                         f"{tuple(x.shape)}, {tuple(B.shape)})")
    grouped = B.dim() == 4
    B4, C4 = (B, C) if grouped else (B.unsqueeze(2), C.unsqueeze(2))
    Bt, L, H, P = x.shape
    G, N = B4.shape[2], B4.shape[3]
    if (tuple(C4.shape) != (Bt, L, G, N) or tuple(B4.shape[:2]) != (Bt, L) or G < 1 or H % G
            or tuple(log_a.shape) != (Bt, L, H) or tuple(dt.shape) != (Bt, L, H)
            or tuple(dy.shape) != tuple(x.shape)):
        raise ValueError(
            f"shapes do not match x [Bt, L, H, P] = {tuple(x.shape)} (H a multiple of B's groups): "
            f"B {tuple(B.shape)}, C {tuple(C.shape)}, log_a {tuple(log_a.shape)}, "
            f"dt {tuple(dt.shape)}, dy {tuple(dy.shape)}"
        )
    if P not in HEAD_DIMS:
        raise ValueError(f"ssd_scan_bwd_cuda supports head dims P in {HEAD_DIMS} (got {P})")
    Q = min(chunk, L)
    if Q <= 0 or L % Q:
        raise ValueError(f"sequence length {L} is not a multiple of the chunk {Q}")
    smem = smem_bytes(L, Q, H // G)
    if smem > SMEM_MAX:
        raise ValueError(f"L={L}, Q={Q}, {H // G} heads a group need {smem} bytes of shared "
                         f"memory per block, more than the {SMEM_MAX} a block may use")
    if not all(t.is_contiguous() for t in (x, log_a, B, C, dt)):
        raise ValueError("ssd_scan_bwd_cuda needs contiguous x, log_a, B, C and dt")
    needs = tuple(bool(n) for n in needs)
    gx, gla, gB, gC, gdt = needs
    f32 = torch.float32
    la32, dt32 = log_a.to(f32), dt.to(f32)
    dy = dy.to(x.dtype).contiguous()
    per_pos = gx or gla or gdt

    def out(shape, dtype, wanted):
        return torch.empty(shape, dtype=dtype, device=dev) if wanted else None

    dx = out(x.shape, x.dtype, per_pos)
    dB, dC = out(B4.shape, x.dtype, gB), out(C4.shape, x.dtype, gC)
    dla, ddt = out(log_a.shape, f32, gla), out(dt.shape, f32, gla or gdt)
    if Bt * L * H and any(needs):
        lib = load()
        with torch.cuda.device(dev):
            ws = {k: torch.empty(s, dtype=f32, device=dev)
                  for k, s in workspace_shapes(Bt, L, H, P, N, Q, G).items()}
            bufs = [x, la32, B4, C4, dt32, dy, dx, dB, dC, dla, ddt] + [ws[k] for k in WORKSPACES]
            ptrs = (ctypes.c_void_p * len(bufs))(*[0 if t is None else t.data_ptr() for t in bufs])
            mask = sum(1 << i for i, n in enumerate(needs) if n)
            rc = lib.ssd_scan_bwd(ptrs, Bt, L, H, P, N, Q, G, mask, DTYPE_CODES[x.dtype],
                                  stream(dev))
        check_launch("ssd_scan_bwd", rc)
        ssd_scan_bwd_cuda.launches += 1
    elif any(needs):  # nothing to launch: the gradients of an empty scan
        for t in (dx, dB, dC, dla, ddt):
            if t is not None:
                t.zero_()
    if not grouped:
        dB = None if dB is None else dB.squeeze(2)
        dC = None if dC is None else dC.squeeze(2)
    grads = (dx, dla, dB, dC, ddt)
    dtypes = (x.dtype, log_a.dtype, B.dtype, C.dtype, dt.dtype)
    return tuple(g.to(dty) if n else None for g, dty, n in zip(grads, dtypes, needs))


ssd_scan_bwd_cuda.launches = 0
