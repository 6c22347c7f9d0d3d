"""Binding of the hand-written Hopper kernel ``csrc/s2d_conv.cu``, and its launch planner.

The kernel replaces the JAX package's Pallas TPU kernel
``kernels/s2d_conv/kernel.py::_s2d_conv_kernel``: the fused
D2S -> 1x1 conv -> S2D variant, computed as one GEMM over the contiguous
views ``x.reshape(-1, C/g^2) @ w`` (the rearrangements cancel).  It runs
on the tensor cores: bf16 directly, f32 as split TF32 (three TF32
products of each operand's high and low parts, never a single one; see
the note at the top of the CUDA source), with a ring of ``cp.async``
slabs in shared memory.

:func:`plan_s2d` is the launch planner, plain Python: it cuts the output
into 64 x 64 tiles and, where a tile's contraction is long and the tiles
leave SMs idle, splits it over a cluster of 2, 4 or 8 blocks, which sum
their partial tiles in rank order through distributed shared memory (no
workspace, no atomics: two calls on one input are bit-identical).  It
weighs the chain of slabs a block walks against the cost of the
cluster's merge, with times fitted to the card.

The source is compiled with ``nvcc`` at first use into a shared library
with a plain C interface and loaded with ctypes (:mod:`..nvcc`).
Nothing is built or imported from CUDA when this module is imported.

:func:`s2d_conv_cuda` counts its launches in ``s2d_conv_cuda.launches``
(a plain integer, added to only where the kernel is launched), so a run
can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels.nvcc import DTYPE_CODES, CudaLibrary, check_launch, stream

TILE_M = 64  # output rows of a tile (BM in the source)
TILE_N = 64  # output columns of a tile (BN)
TILE_K = {torch.float32: 32, torch.bfloat16: 64}  # contraction slab (Cfg<T>::BK): 128 bytes
MAX_SPLIT = 8  # blocks of a cluster, the portable maximum
SPLITS = (1, 2, 4, 8)  # clusters of 3, 5, 6 or 7 blocks ran slower than 4 or 8
#: one block's time per slab of products, and the cluster merge's time per
#: block (partials through shared memory, two cluster barriers), in us:
#: fitted on an H100 to the sweep of splits that chip_smoke.py prints
SLAB_US = {torch.float32: 0.85, torch.bfloat16: 0.4}
MERGE_US = 0.85


@dataclass(frozen=True)
class S2dPlan:
    """One launch: ``m_tiles x n_tiles`` output tiles, each computed by a
    cluster of ``split`` blocks over its own runs of ``tile_k``-deep slabs."""

    M: int
    Cv: int
    Kv: int
    tile_k: int
    split: int

    @property
    def m_tiles(self) -> int:
        return -(-self.M // TILE_M)

    @property
    def n_tiles(self) -> int:
        return -(-self.Kv // TILE_N)

    @property
    def slabs(self) -> int:
        return -(-self.Cv // self.tile_k)

    @property
    def blocks(self) -> int:
        return self.m_tiles * self.n_tiles * self.split

    def k_range(self, rank: int) -> Tuple[int, int]:
        """Contraction indices ``[k0, k1)`` of block ``rank`` of a cluster,
        as the kernel computes them: a balanced run of whole slabs."""
        s0 = rank * self.slabs // self.split
        s1 = (rank + 1) * self.slabs // self.split
        return min(s0 * self.tile_k, self.Cv), min(s1 * self.tile_k, self.Cv)


def plan_cost(plan: S2dPlan, n_sm: int, dtype: torch.dtype) -> float:
    """Modelled time (us, launch aside): the busiest SM runs
    ``ceil(blocks / n_sm)`` blocks, each its run of slabs and, in a
    cluster, the merge."""
    waves = -(-plan.blocks // n_sm)
    merge = MERGE_US if plan.split > 1 else 0.0
    return waves * (-(-plan.slabs // plan.split) * SLAB_US[dtype] + merge)


def plan_s2d(M: int, Cv: int, Kv: int, dtype: torch.dtype, n_sm: int) -> S2dPlan:
    """The split in ``SPLITS`` (at most one block per slab) of least
    :func:`plan_cost`, the smaller on a tie."""
    plans = [S2dPlan(M, Cv, Kv, TILE_K[dtype], s) for s in SPLITS
             if s == 1 or s <= -(-Cv // TILE_K[dtype])]
    return min(plans, key=lambda p: (plan_cost(p, n_sm, dtype), p.split))


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.s2d_conv_gemm
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("s2d_conv.cu", _bind)
build = LIBRARY.build
load = LIBRARY.load


def s2d_conv_cuda(x: torch.Tensor, w: torch.Tensor, gamma: int,
                  split: Optional[int] = None) -> torch.Tensor:
    """The kernel on CUDA tensors. x: [B,H,W,C], w: [C/g^2, K/g^2] -> [B,H,W,K].

    Checks device, dtype, shape and contiguity, allocates the output,
    launches the :func:`plan_s2d` grid (or ``split`` blocks per tile, 1 to
    8) on the current stream without synchronising, and raises if the
    launch is refused."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(
            f"s2d_conv_cuda needs x and w on one CUDA device (got {x.device}, "
            f"{w.device}); CPU tensors go to ref.s2d_conv_ref"
        )
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
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
    if split is not None and not 1 <= split <= MAX_SPLIT:
        raise ValueError(f"split must lie in 1..{MAX_SPLIT} (got {split})")
    out = torch.empty((B, H, W, Kv * g2), dtype=x.dtype, device=x.device)
    M = B * H * W * g2
    if M == 0 or Kv == 0:
        return out
    if split is None:
        n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
        split = plan_s2d(M, Cv, Kv, x.dtype, n_sm).split
    lib = load()
    with torch.cuda.device(x.device):
        rc = lib.s2d_conv_gemm(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), M, Cv, Kv, split,
            DTYPE_CODES[x.dtype], stream(x.device),
        )
    check_launch("s2d_conv_gemm", rc)
    s2d_conv_cuda.launches += 1
    return out


s2d_conv_cuda.launches = 0
