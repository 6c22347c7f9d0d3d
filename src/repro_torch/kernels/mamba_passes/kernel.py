"""Binding of the hand-written Hopper kernels ``csrc/mamba_passes.cu``.

The Mamba block's passes on the no-grad CUDA route (see the note at the
top of the CUDA source): three launches a block call, around the two
projections and the scan.

* :func:`rmsnorm_cuda`: the input rmsnorm;
* :func:`conv_silu_cuda`: the causal conv, ``+ conv_b`` and silu, written
  as contiguous x, B and C (the scan's inputs), with dt and log_a in f32;
* :func:`gate_norm_cuda`: the D skip, the ``silu(z)`` gate and the out
  rmsnorm (over each group of ``d_inner / G`` channels where B and C come
  in G groups), the input of the output projection.

Groups reach the conv as its channel count alone: B and C of G groups are
``2 G N`` contiguous channels of the input projection, written as ``[B, L,
G N]`` and viewed as ``[B, L, G, N]``.  A hybrid site's addend is one add
in the activations' dtype before the input norm.

:func:`mamba_passes_cuda` is the block with them, as ``ref.mamba_passes``
is the block with the plain passes; it counts its calls in
``mamba_passes_cuda.launches`` (a plain integer, added to once a block
call, where the three kernels launch), so a run can show that its main path
went through the kernels.  Each wrapper checks device, dtype, shape,
contiguity and 16-byte alignment and raises on what its kernel does not
take; it allocates the outputs and raises if a launch is refused.

The source is compiled with ``nvcc`` at first use into a shared library
with a plain C interface and loaded with ctypes (:mod:`..nvcc`).  Nothing
is built or imported from CUDA when this module is imported.
"""

from __future__ import annotations

import ctypes
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.kernels.mamba_passes.ref import ssm_groups
from repro_torch.kernels.nvcc import DTYPE_CODES, CudaLibrary, check_launch, stream
from repro_torch.models.common import linear
from repro_torch.models.config import ModelConfig
from repro_torch.spans import span

NORM_MAX_CHUNKS = 32 * 32  # 16-byte chunks of a row the input norm holds (32 a lane)
GATE_MAX_CHUNKS = 8 * 256  # 16-byte chunks of a row the gate norm holds (8 a thread)
CONV_WIDTHS = (2, 3, 4)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mamba_rmsnorm.argtypes = [p, p, p, i, i, f, i, p]
    lib.mamba_conv_silu.argtypes = [p, i] + [p] * 9 + [i] * 7 + [p]
    lib.mamba_gate_norm.argtypes = [p, p, p, i, p, p, p, i, i, i, i, f, i, p]
    for fn in (lib.mamba_rmsnorm, lib.mamba_conv_silu, lib.mamba_gate_norm):
        fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("mamba_passes.cu", _bind)
build = LIBRARY.build
load = LIBRARY.load


def _lanes(dtype: torch.dtype) -> int:
    """Elements in 16 bytes of ``dtype``."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def _check(name: str, ts: Dict[str, torch.Tensor], dtype: torch.dtype) -> None:
    """Every tensor of ``ts`` on one CUDA device, contiguous and 16-byte
    aligned, and ``dtype`` (the activations') one that the kernels take."""
    first = next(iter(ts.values()))
    dev = first.device
    if dev.type != "cuda" or any(t.device != dev for t in ts.values()):
        got = ", ".join(f"{k} {t.device}" for k, t in ts.items())
        raise ValueError(f"{name} needs its tensors on one CUDA device (got {got}); CPU "
                         "tensors go to ref.mamba_passes")
    if dtype not in DTYPE_CODES:
        raise ValueError(f"{name} takes float32 or bfloat16 activations (got {dtype})")
    for k, t in ts.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} needs a contiguous {k}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} needs {k} at a 16-byte aligned address")


def _dtypes(name: str, want: torch.dtype, **ts: torch.Tensor) -> None:
    for k, t in ts.items():
        if t.dtype != want:
            raise ValueError(f"{name} needs {k} in {want} (got {t.dtype})")


def _shape(name: str, t: torch.Tensor, want: tuple, what: str) -> None:
    if tuple(t.shape) != tuple(want):
        raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, not {tuple(want)}")


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The rmsnorm of ``x [..., D]`` (f32 or bf16) with the f32 ``scale [D]``,
    in x's dtype: ``x rsqrt(mean(x²) + eps) scale`` in f32, rounded once."""
    name = "rmsnorm_cuda"
    _check(name, {"x": x, "scale": scale}, x.dtype)
    _dtypes(name, torch.float32, scale=scale)
    D = x.shape[-1]
    _shape(name, scale, (D,), "scale")
    V = _lanes(x.dtype)
    if D % V or D // V > NORM_MAX_CHUNKS:
        raise ValueError(f"{name} takes rows of a multiple of {V} up to {NORM_MAX_CHUNKS * V} "
                         f"elements in {x.dtype} (got {D})")
    out = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return out
    lib = load()
    with torch.cuda.device(x.device):
        rc = lib.mamba_rmsnorm(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, D, eps,
                               DTYPE_CODES[x.dtype], stream(x.device))
    check_launch(name, rc)
    return out


def conv_silu_cuda(zxbcdt: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                   dt_bias: torch.Tensor, A_log: torch.Tensor, d_inner: int, n_state: int,
                   n_heads: int, n_groups: int = 1):
    """The conv, silu and dt of the input projection ``zxbcdt [B, L, 2
    d_inner + 2 G N + H]`` (columns z, x, B, C, dt; G = ``n_groups``), with
    ``conv_w [W, d_inner + 2 G N]`` in its dtype and the f32 ``conv_b``,
    ``dt_bias [H]`` and ``A_log [H]``.  Returns x ``[B, L, d_inner]``, B and
    C ``[B, L, N]`` (one group) or ``[B, L, G, N]`` in zxbcdt's dtype and
    dt, log_a ``[B, L, H]`` in f32, each a new contiguous tensor."""
    name = "conv_silu_cuda"
    ts = {"zxbcdt": zxbcdt, "conv_w": conv_w, "conv_b": conv_b, "dt_bias": dt_bias,
          "A_log": A_log}
    _check(name, ts, zxbcdt.dtype)
    _dtypes(name, zxbcdt.dtype, conv_w=conv_w)
    _dtypes(name, torch.float32, conv_b=conv_b, dt_bias=dt_bias, A_log=A_log)
    Din, H, G = d_inner, n_heads, n_groups
    if G < 1 or H % G:
        raise ValueError(f"{name}: the {H} heads are not a multiple of {G} groups")
    N = G * n_state  # the kernel's B (and C) channels: every group's
    C, width = Din + 2 * N, 2 * Din + 2 * N + n_heads
    if zxbcdt.dim() != 3 or zxbcdt.shape[-1] != width:
        raise ValueError(f"{name}: zxbcdt must be [B, L, {width}] (got {tuple(zxbcdt.shape)})")
    W = conv_w.shape[0] if conv_w.dim() == 2 else 0
    if W not in CONV_WIDTHS:
        raise ValueError(f"{name} takes conv widths {CONV_WIDTHS} (got conv_w "
                         f"{tuple(conv_w.shape)})")
    _shape(name, conv_w, (W, C), "conv_w")
    _shape(name, conv_b, (C,), "conv_b")
    _shape(name, dt_bias, (H,), "dt_bias")
    _shape(name, A_log, (H,), "A_log")
    V = _lanes(zxbcdt.dtype)
    if Din % V or N % V or H % V:
        raise ValueError(f"{name} needs d_inner, N and H multiples of {V} in {zxbcdt.dtype} "
                         f"(got {Din}, {N}, {H})")
    Bsz, L = zxbcdt.shape[:2]
    dev, dtype = zxbcdt.device, zxbcdt.dtype
    x = torch.empty((Bsz, L, Din), dtype=dtype, device=dev)
    bc = (Bsz, L, n_state) if G == 1 else (Bsz, L, G, n_state)
    Bm = torch.empty(bc, dtype=dtype, device=dev)
    Cm = torch.empty(bc, dtype=dtype, device=dev)
    dt = torch.empty((Bsz, L, H), dtype=torch.float32, device=dev)
    log_a = torch.empty((Bsz, L, H), dtype=torch.float32, device=dev)
    if Bsz * L == 0:
        return x, Bm, Cm, dt, log_a
    lib = load()
    with torch.cuda.device(dev):
        rc = lib.mamba_conv_silu(
            zxbcdt.data_ptr(), width, conv_w.data_ptr(), conv_b.data_ptr(), dt_bias.data_ptr(),
            A_log.data_ptr(), x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
            log_a.data_ptr(), Bsz, L, Din, N, H, W, DTYPE_CODES[dtype], stream(dev))
    check_launch(name, rc)
    return x, Bm, Cm, dt, log_a


def gate_norm_cuda(y: torch.Tensor, x: torch.Tensor, zxbcdt: torch.Tensor, D: torch.Tensor,
                   scale: torch.Tensor, eps: float, headdim: int,
                   n_groups: int = 1) -> torch.Tensor:
    """``rmsnorm((y + D x) silu(z)) scale`` over each row of d_inner (or
    over each of its ``n_groups`` groups of ``d_inner / n_groups``
    channels), z the first d_inner columns of ``zxbcdt [B, L, *]``: y the
    scan's output ``[B, L, H, P]``, x the conv's ``[B, L, d_inner]``, both in
    zxbcdt's dtype; ``D [H]`` and ``scale [d_inner]`` in f32.  ``y + D x``,
    ``silu(z)`` and their product are rounded to the dtype, as the plain
    passes round them.  Returns ``[B, L, d_inner]`` in that dtype."""
    name = "gate_norm_cuda"
    ts = {"y": y, "x": x, "zxbcdt": zxbcdt, "D": D, "scale": scale}
    _check(name, ts, zxbcdt.dtype)
    _dtypes(name, zxbcdt.dtype, y=y, x=x)
    _dtypes(name, torch.float32, D=D, scale=scale)
    if x.dim() != 3 or zxbcdt.dim() != 3:
        raise ValueError(f"{name}: x and zxbcdt must be [B, L, *] (got {tuple(x.shape)}, "
                         f"{tuple(zxbcdt.shape)})")
    Bsz, L, Din = x.shape
    Pd = headdim
    if Pd <= 0 or Din % Pd:
        raise ValueError(f"{name}: d_inner {Din} is not a multiple of the head dim {Pd}")
    H, G = Din // Pd, n_groups
    if G < 1 or H % G:
        raise ValueError(f"{name}: the {H} heads are not a multiple of {G} groups")
    _shape(name, y, (Bsz, L, H, Pd), "y")
    _shape(name, D, (H,), "D")
    _shape(name, scale, (Din,), "scale")
    if tuple(zxbcdt.shape[:2]) != (Bsz, L) or zxbcdt.shape[-1] < Din:
        raise ValueError(f"{name}: zxbcdt {tuple(zxbcdt.shape)} does not hold z [{Bsz}, {L}, "
                         f"{Din}]")
    V = _lanes(x.dtype)
    if Pd % V or Din // G // V > GATE_MAX_CHUNKS:
        raise ValueError(f"{name} needs a head dim that is a multiple of {V} and groups of "
                         f"d_inner up to {GATE_MAX_CHUNKS * V} in {x.dtype} (got {Pd}, "
                         f"{Din // G})")
    out = torch.empty_like(x)
    if Bsz * L == 0:
        return out
    lib = load()
    with torch.cuda.device(x.device):
        rc = lib.mamba_gate_norm(y.data_ptr(), x.data_ptr(), zxbcdt.data_ptr(), zxbcdt.shape[-1],
                                 D.data_ptr(), scale.data_ptr(), out.data_ptr(), Bsz * L, Din, Pd,
                                 G, eps, DTYPE_CODES[x.dtype], stream(x.device))
    check_launch(name, rc)
    return out


def mamba_passes_cuda(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
                      scan: Callable[..., torch.Tensor],
                      addend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``ref.mamba_passes`` with the three kernels in place of the plain
    passes: the same projections (spans ``mamba.in_proj``, ``mamba.out_proj``),
    the same ``scan``, the same ``addend`` (a plain add in x's dtype before
    the input norm) and the same residual add, a plain add in x's dtype."""
    Bsz, L = x.shape[0], x.shape[1]
    G = ssm_groups(cfg)
    h = rmsnorm_cuda(x if addend is None else x + addend, p["norm"]["scale"], cfg.norm_eps)
    with span("mamba.in_proj"):
        zxbcdt = linear(p["in_proj"], h)
    xs, Bm, Cm, dt, log_a = conv_silu_cuda(zxbcdt, p["conv_w"], p["conv_b"], p["dt_bias"],
                                           p["A_log"], cfg.d_inner, cfg.ssm_state,
                                           cfg.ssm_nheads, G)
    y = scan(xs.view(Bsz, L, cfg.ssm_nheads, cfg.ssm_headdim), log_a, Bm, Cm, dt,
             cfg.ssm_chunk)
    y = gate_norm_cuda(y, xs, zxbcdt, p["D"], p["out_norm"]["scale"], cfg.norm_eps,
                       cfg.ssm_headdim, G)
    with span("mamba.out_proj"):
        out = linear(p["out_proj"], y)
    mamba_passes_cuda.launches += 1
    return x + out


mamba_passes_cuda.launches = 0


def floor_bytes(cfg: ModelConfig, tokens: int, itemsize: int) -> Dict[str, int]:
    """The least bytes each pass of a block call over ``tokens`` tokens moves
    (each input read once, each output written once; activations of
    ``itemsize`` bytes, dt and log_a in f32): ``norm``, ``conv`` (the xBC and
    dt columns in; x, B, C, dt and log_a out), ``gate_norm`` (y, x, z in; the
    out_proj input out) and the residual ``add``.  B and C are every
    group's; a hybrid site's addend is not counted."""
    D, Din, N, H = cfg.d_model, cfg.d_inner, ssm_groups(cfg) * cfg.ssm_state, cfg.ssm_nheads
    per = {
        "norm": 2 * D * itemsize,
        "conv": (2 * (Din + 2 * N) + H) * itemsize + 2 * H * 4,
        "gate_norm": 4 * Din * itemsize,
        "add": 3 * D * itemsize,
    }
    return {k: v * tokens for k, v in per.items()}
