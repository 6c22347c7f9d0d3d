"""Binding of the hand-written Hopper kernels ``csrc/mamba_passes.cu``.

The Mamba block's passes on the CUDA routes (see the note at the top of
the CUDA source): three launches a block call, around the two
projections and the scan, and under autograd three more, with their
parameter gradients' sums, in its backward.

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

Under autograd (:func:`mamba_passes_grad`) each kernel runs inside a
``torch.autograd.Function`` (:class:`RMSNormFn`, :class:`ConvSiluFn`,
:class:`GateNormFn`) that saves its inputs alone; its backward is the
kernel's gradient kernel (:func:`rmsnorm_bwd_cuda`,
:func:`conv_silu_bwd_cuda`, :func:`gate_norm_bwd_cuda`), each parameter's
gradient summed from the kernel's f32 partial sums by ``mamba_colsum`` in a
fixed order.  The input projection's gradient is one tensor: the gate's
backward writes its z columns and hands it, with the D skip's share of dx,
to the conv's backward (:class:`Link`), which writes the rest.
``mamba_passes_cuda.backward_calls`` counts the block backwards.

The source is compiled with ``nvcc`` at first use into a shared library
with a plain C interface and loaded with ctypes (:mod:`..nvcc`).  Nothing
is built or imported from CUDA when this module is imported.
"""

from __future__ import annotations

import ctypes
from typing import Any, Callable, Dict, Optional

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.mamba_passes.ref import ssm_groups
from repro_torch.kernels.nvcc import DTYPE_CODES, CudaLibrary, check_launch, stream
from repro_torch.models.common import linear
from repro_torch.models.config import ModelConfig
from repro_torch.spans import span

NORM_MAX_CHUNKS = 32 * 32  # 16-byte chunks of a row the input norm holds (32 a lane)
GATE_MAX_CHUNKS = 8 * 256  # 16-byte chunks of a row the gate norm holds (8 a thread)
CONV_WIDTHS = (2, 3, 4)
# the backward kernels' partial sums, as csrc/mamba_passes.cu cuts them
BWD_MAX_CHUNKS = 4 * 512  # 16-byte chunks of a row the two norms' backward holds (4 a thread)
BWD_ROWS = 16  # token rows a block of the two norms' backward sums (its row of partials)
BWD_RUN = 64  # tokens a thread of the conv's backward sums (its row of partials)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mamba_rmsnorm.argtypes = [p, p, p, i, i, f, i, p]
    lib.mamba_conv_silu.argtypes = [p, i] + [p] * 9 + [i] * 7 + [p]
    lib.mamba_gate_norm.argtypes = [p, p, p, i, p, p, p, i, i, i, i, f, i, p]
    lib.mamba_rmsnorm_bwd.argtypes = [p] * 5 + [i, i, f, i, p]
    lib.mamba_conv_silu_bwd.argtypes = [p, i] + [p] * 12 + [i] * 7 + [p]
    lib.mamba_gate_norm_bwd.argtypes = [p, p, p, i] + [p] * 8 + [i] * 4 + [f, i, p]
    lib.mamba_colsum.argtypes = [p, i, i, i, i, p, i, p]
    for fn in (lib.mamba_rmsnorm, lib.mamba_conv_silu, lib.mamba_gate_norm,
               lib.mamba_rmsnorm_bwd, lib.mamba_conv_silu_bwd, lib.mamba_gate_norm_bwd,
               lib.mamba_colsum):
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


def _block(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
           scan: Callable[..., torch.Tensor], addend: Optional[torch.Tensor], norm: Callable,
           conv: Callable, gate: Callable) -> torch.Tensor:
    """The block around its three passes ``norm``, ``conv`` and ``gate``
    (each called as :func:`rmsnorm_cuda`, :func:`conv_silu_cuda` and
    :func:`gate_norm_cuda` are): the projections (spans ``mamba.in_proj``,
    ``mamba.out_proj``), ``scan``, the ``addend`` (a plain add in x's dtype
    before the input norm) and the residual add, a plain add in x's dtype.
    The call is counted in ``mamba_passes_cuda.launches`` before the output
    projection, so that remat's recompute, which stops once it has made the
    last saved tensor (that projection's input) again, counts too."""
    Bsz, L = x.shape[0], x.shape[1]
    G = ssm_groups(cfg)
    h = norm(x if addend is None else x + addend, p["norm"]["scale"], cfg.norm_eps)
    with span("mamba.in_proj"):
        zxbcdt = linear(p["in_proj"], h)
    xs, Bm, Cm, dt, log_a = conv(zxbcdt, p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"],
                                 cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, G)
    y = scan(xs.view(Bsz, L, cfg.ssm_nheads, cfg.ssm_headdim), log_a, Bm, Cm, dt,
             cfg.ssm_chunk)
    y = gate(y, xs, zxbcdt, p["D"], p["out_norm"]["scale"], cfg.norm_eps, cfg.ssm_headdim, G)
    mamba_passes_cuda.launches += 1
    with span("mamba.out_proj"):
        out = linear(p["out_proj"], y)
    return x + out


def mamba_passes_cuda(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
                      scan: Callable[..., torch.Tensor],
                      addend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``ref.mamba_passes`` with the three kernels in place of the plain
    passes, around the same projections, ``scan``, ``addend`` and residual
    add (:func:`_block`)."""
    return _block(cfg, p, x, scan, addend, rmsnorm_cuda, conv_silu_cuda, gate_norm_cuda)


mamba_passes_cuda.launches = 0
mamba_passes_cuda.backward_calls = 0


# ---------------------------------------------------------------- backward --


def _colsum(part: torch.Tensor, col0: int, out: torch.Tensor, group: int = 1) -> torch.Tensor:
    """``out [n]`` (f32 or bf16) = the sums over the rows of the f32 partials
    ``part [R, K]`` of each of the n columns from ``col0`` on (of each run of
    ``group`` of them), in a fixed order."""
    lib = load()
    ptr = part.data_ptr() + col0 * part.element_size()
    with torch.cuda.device(part.device):
        rc = lib.mamba_colsum(ptr, part.shape[0], part.shape[1], out.numel(), group,
                              out.data_ptr(), DTYPE_CODES[out.dtype], stream(part.device))
    check_launch("mamba_colsum", rc)
    return out


def _bwd_chunks(name: str, n: int, dtype: torch.dtype) -> None:
    V = _lanes(dtype)
    if n % V or n // V > BWD_MAX_CHUNKS:
        raise ValueError(f"{name} takes rows of a multiple of {V} up to {BWD_MAX_CHUNKS * V} "
                         f"elements in {dtype} (got {n})")


def rmsnorm_bwd_cuda(x: torch.Tensor, scale: torch.Tensor, dout: torch.Tensor, eps: float):
    """The gradient of :func:`rmsnorm_cuda` at ``x [..., D]`` against
    ``dout`` (x's shape and dtype): ``dx`` in x's dtype and ``d scale [D]``
    in f32."""
    name = "rmsnorm_bwd_cuda"
    _check(name, {"x": x, "scale": scale, "dout": dout}, x.dtype)
    _dtypes(name, x.dtype, dout=dout)
    _dtypes(name, torch.float32, scale=scale)
    D = x.shape[-1]
    _shape(name, scale, (D,), "scale")
    _shape(name, dout, x.shape, "dout")
    _bwd_chunks(name, D, x.dtype)
    dx = torch.empty_like(x)
    dscale = torch.empty((D,), dtype=torch.float32, device=x.device)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return dx, dscale.zero_()
    part = torch.empty((-(-rows // BWD_ROWS), D), dtype=torch.float32, device=x.device)
    lib = load()
    with torch.cuda.device(x.device):
        rc = lib.mamba_rmsnorm_bwd(x.data_ptr(), scale.data_ptr(), dout.data_ptr(), dx.data_ptr(),
                                   part.data_ptr(), rows, D, eps, DTYPE_CODES[x.dtype],
                                   stream(x.device))
    check_launch(name, rc)
    return dx, _colsum(part, 0, dscale)


def gate_norm_bwd_cuda(y: torch.Tensor, x: torch.Tensor, zxbcdt: torch.Tensor, D: torch.Tensor,
                       scale: torch.Tensor, dout: torch.Tensor, eps: float, headdim: int,
                       n_groups: int = 1, dzx: Optional[torch.Tensor] = None):
    """The gradient of :func:`gate_norm_cuda` at its inputs against ``dout
    [B, L, d_inner]``: ``dy`` (y's shape), ``dx`` (the D skip's share, x's
    shape), ``dzx`` (zxbcdt's shape, its z columns written: ``dzx`` where
    given, else a new tensor whose other columns are left unwritten), and
    ``d D [H]`` and ``d scale [d_inner]`` in f32."""
    name = "gate_norm_bwd_cuda"
    dzx = torch.empty_like(zxbcdt) if dzx is None else dzx
    ts = {"y": y, "x": x, "zxbcdt": zxbcdt, "D": D, "scale": scale, "dout": dout, "dzx": dzx}
    _check(name, ts, x.dtype)
    _dtypes(name, x.dtype, y=y, zxbcdt=zxbcdt, dout=dout, dzx=dzx)
    _dtypes(name, torch.float32, D=D, scale=scale)
    Bsz, L, Din = x.shape
    Pd, G = headdim, n_groups
    H = Din // Pd
    if Pd <= 0 or Din % Pd or G < 1 or H % G:
        raise ValueError(f"{name}: d_inner {Din} is not whole heads of {Pd} in {G} groups")
    _shape(name, y, (Bsz, L, H, Pd), "y")
    _shape(name, dout, x.shape, "dout")
    _shape(name, dzx, zxbcdt.shape, "dzx")
    _shape(name, D, (H,), "D")
    _shape(name, scale, (Din,), "scale")
    if tuple(zxbcdt.shape[:2]) != (Bsz, L) or zxbcdt.shape[-1] < Din:
        raise ValueError(f"{name}: zxbcdt {tuple(zxbcdt.shape)} does not hold z [{Bsz}, {L}, "
                         f"{Din}]")
    V = _lanes(x.dtype)
    if Pd % V:
        raise ValueError(f"{name} needs a head dim that is a multiple of {V} (got {Pd})")
    _bwd_chunks(name, Din // G, x.dtype)
    dy, dx = torch.empty_like(y), torch.empty_like(x)
    dD = torch.empty((H,), dtype=torch.float32, device=x.device)
    dscale = torch.empty((Din,), dtype=torch.float32, device=x.device)
    rows = Bsz * L
    if rows == 0:
        return dy, dx, dzx, dD.zero_(), dscale.zero_()
    blocks = -(-rows // BWD_ROWS)
    part_w = torch.empty((blocks, Din), dtype=torch.float32, device=x.device)
    part_d = torch.empty((blocks, Din // V), dtype=torch.float32, device=x.device)
    lib = load()
    with torch.cuda.device(x.device):
        rc = lib.mamba_gate_norm_bwd(
            y.data_ptr(), x.data_ptr(), zxbcdt.data_ptr(), zxbcdt.shape[-1], D.data_ptr(),
            scale.data_ptr(), dout.data_ptr(), dy.data_ptr(), dx.data_ptr(), dzx.data_ptr(),
            part_w.data_ptr(), part_d.data_ptr(), rows, Din, Pd, G, eps, DTYPE_CODES[x.dtype],
            stream(x.device))
    check_launch(name, rc)
    return dy, dx, dzx, _colsum(part_d, 0, dD, Pd // V), _colsum(part_w, 0, dscale)


def conv_silu_bwd_cuda(zxbcdt: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                       dt_bias: torch.Tensor, A_log: torch.Tensor, dx: torch.Tensor,
                       dB: torch.Tensor, dC: torch.Tensor, ddt: torch.Tensor,
                       dlog_a: torch.Tensor, d_inner: int, n_state: int, n_heads: int,
                       n_groups: int = 1, dx_extra: Optional[torch.Tensor] = None,
                       dzx: Optional[torch.Tensor] = None):
    """The gradient of :func:`conv_silu_cuda` at its inputs against the
    gradients of its five outputs (``dx`` plus ``dx_extra`` where given, the
    D skip's share, for x): ``dzx`` (zxbcdt's shape and dtype, its xBC and dt
    columns written into ``dzx`` where given, else into a new tensor whose z
    columns are zero), and ``d conv_w`` in conv_w's dtype, ``d conv_b``, ``d
    dt_bias`` and ``d A_log`` in f32."""
    name = "conv_silu_bwd_cuda"
    dzx = torch.zeros_like(zxbcdt) if dzx is None else dzx
    ts = {"zxbcdt": zxbcdt, "conv_w": conv_w, "conv_b": conv_b, "dt_bias": dt_bias,
          "A_log": A_log, "dx": dx, "dB": dB, "dC": dC, "ddt": ddt, "dlog_a": dlog_a, "dzx": dzx}
    if dx_extra is not None:
        ts["dx_extra"] = dx_extra
    _check(name, ts, zxbcdt.dtype)
    _dtypes(name, zxbcdt.dtype, conv_w=conv_w, dx=dx, dB=dB, dC=dC, dzx=dzx,
            **({} if dx_extra is None else {"dx_extra": dx_extra}))
    _dtypes(name, torch.float32, conv_b=conv_b, dt_bias=dt_bias, A_log=A_log, ddt=ddt,
            dlog_a=dlog_a)
    Din, H, N = d_inner, n_heads, n_groups * n_state
    C, width = Din + 2 * N, 2 * Din + 2 * N + H
    if zxbcdt.dim() != 3 or zxbcdt.shape[-1] != width:
        raise ValueError(f"{name}: zxbcdt must be [B, L, {width}] (got {tuple(zxbcdt.shape)})")
    Bsz, L = zxbcdt.shape[:2]
    W = conv_w.shape[0] if conv_w.dim() == 2 else 0
    if W not in CONV_WIDTHS:
        raise ValueError(f"{name} takes conv widths {CONV_WIDTHS} (got conv_w "
                         f"{tuple(conv_w.shape)})")
    _shape(name, conv_w, (W, C), "conv_w")
    _shape(name, dzx, zxbcdt.shape, "dzx")
    for k, t, n in (("dx", dx, Din), ("dB", dB, N), ("dC", dC, N), ("ddt", ddt, H),
                    ("dlog_a", dlog_a, H)) + ((("dx_extra", dx_extra, Din),)
                                              if dx_extra is not None else ()):
        if tuple(t.shape[:2]) != (Bsz, L) or t.numel() != Bsz * L * n:
            raise ValueError(f"{name}: {k} {tuple(t.shape)} is not [{Bsz}, {L}, {n}] elements")
    V = _lanes(zxbcdt.dtype)
    if Din % V or N % V or H % V:
        raise ValueError(f"{name} needs d_inner, N and H multiples of {V} in {zxbcdt.dtype} "
                         f"(got {Din}, {N}, {H})")
    dev = zxbcdt.device
    dw = torch.empty((W, C), dtype=conv_w.dtype, device=dev)
    grads = torch.empty((C + 2 * H,), dtype=torch.float32, device=dev)  # conv_b, dt_bias, A_log
    db, dbias, dA = grads[:C], grads[C:C + H], grads[C + H:]
    if Bsz * L == 0:
        dw.zero_(), grads.zero_()
        return dzx, dw, db, dbias, dA
    part = torch.empty((Bsz * -(-L // BWD_RUN), (W + 1) * C + 2 * H), dtype=torch.float32,
                       device=dev)
    lib = load()
    with torch.cuda.device(dev):
        rc = lib.mamba_conv_silu_bwd(
            zxbcdt.data_ptr(), width, conv_w.data_ptr(), conv_b.data_ptr(), dt_bias.data_ptr(),
            A_log.data_ptr(), dx.data_ptr(), None if dx_extra is None else dx_extra.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), ddt.data_ptr(), dlog_a.data_ptr(), dzx.data_ptr(),
            part.data_ptr(), Bsz, L, Din, N, H, W, DTYPE_CODES[zxbcdt.dtype], stream(dev))
    check_launch(name, rc)
    _colsum(part, 0, dw)
    _colsum(part, W * C, grads)
    return dzx, dw, db, dbias, dA


class Link:
    """What a block's gate backward hands its conv backward: the input
    projection's gradient ``dzx`` with its z columns written, and the D
    skip's share of dx.  Autograd runs the gate's backward first (its input x
    is the conv's output), so the conv's backward adds the D skip's dx in its
    kernel and writes the rest of ``dzx`` in place: autograd adds neither two
    full-width gradients of the projection's slices nor two of x."""

    __slots__ = ("dzx", "dx")

    def __init__(self):
        self.dzx: Optional[torch.Tensor] = None
        self.dx: Optional[torch.Tensor] = None


class RMSNormFn(torch.autograd.Function):
    """:func:`rmsnorm_cuda` under autograd; its backward is
    :func:`rmsnorm_bwd_cuda` and counts a block backward in
    ``mamba_passes_cuda.backward_calls`` (the block's last pass backwards)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_cuda(x, scale, eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, dh):
        x, scale = ctx.saved_tensors
        mamba_passes_cuda.backward_calls += 1
        return rmsnorm_bwd_cuda(x, scale, dh.contiguous(), ctx.eps) + (None,)


class ConvSiluFn(torch.autograd.Function):
    """:func:`conv_silu_cuda` under autograd; its backward is
    :func:`conv_silu_bwd_cuda`, fed the D skip's dx and the projection's
    gradient by the block's :class:`GateNormFn` through ``link``."""

    @staticmethod
    def forward(ctx, zxbcdt, conv_w, conv_b, dt_bias, A_log, d_inner, n_state, n_heads,
                n_groups, link):
        ctx.save_for_backward(zxbcdt, conv_w, conv_b, dt_bias, A_log)
        ctx.dims, ctx.link = (d_inner, n_state, n_heads, n_groups), link
        return conv_silu_cuda(zxbcdt, conv_w, conv_b, dt_bias, A_log, d_inner, n_state,
                              n_heads, n_groups)

    @staticmethod
    @once_differentiable
    def backward(ctx, dx, dB, dC, ddt, dlog_a):
        link = ctx.link
        grads = conv_silu_bwd_cuda(*ctx.saved_tensors,
                                   *(t.contiguous() for t in (dx, dB, dC, ddt, dlog_a)),
                                   *ctx.dims, dx_extra=link.dx, dzx=link.dzx)
        link.dzx = link.dx = None
        return grads + (None,) * 5


class GateNormFn(torch.autograd.Function):
    """:func:`gate_norm_cuda` under autograd; its backward is
    :func:`gate_norm_bwd_cuda`, which gives y's gradient and the norm's
    leaves' and leaves x's (the D skip's share) and zxbcdt's (its z columns)
    to the block's :class:`ConvSiluFn` through ``link``."""

    @staticmethod
    def forward(ctx, y, x, zxbcdt, D, scale, eps, headdim, n_groups, link):
        ctx.save_for_backward(y, x, zxbcdt, D, scale)
        ctx.args, ctx.link = (eps, headdim, n_groups), link
        return gate_norm_cuda(y, x, zxbcdt, D, scale, eps, headdim, n_groups)

    @staticmethod
    @once_differentiable
    def backward(ctx, dg):
        dy, dx, dzx, dD, dscale = gate_norm_bwd_cuda(*ctx.saved_tensors, dg.contiguous(),
                                                     *ctx.args)
        ctx.link.dx = dx if ctx.needs_input_grad[1] else None
        ctx.link.dzx = dzx if ctx.needs_input_grad[2] else None
        return dy, None, None, dD, dscale, None, None, None, None


def mamba_passes_grad(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
                      scan: Callable[..., torch.Tensor],
                      addend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`mamba_passes_cuda` under autograd: the same kernels, each in
    its ``torch.autograd.Function``, the conv's and the gate's sharing one
    :class:`Link`."""
    link = Link()
    return _block(cfg, p, x, scan, addend, RMSNormFn.apply,
                  lambda *a: ConvSiluFn.apply(*a, link), lambda *a: GateNormFn.apply(*a, link))


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


def backward_floor_bytes(cfg: ModelConfig, tokens: int, itemsize: int) -> Dict[str, int]:
    """The least bytes each backward kernel of a block call over ``tokens``
    tokens moves (each input read once, each output written once; the
    parameters and their gradients' partial sums not counted): ``gate_norm``
    (y, x, z and the output's gradient in; dy, the D skip's dx and dz out),
    ``conv`` (the xBC and dt columns, dx of the scan and of the D skip, dB,
    dC in; d dt and d log_a in f32; the xBC and dt columns' gradient out) and
    ``norm`` (x and the output's gradient in, dx out)."""
    D, Din, N, H = cfg.d_model, cfg.d_inner, ssm_groups(cfg) * cfg.ssm_state, cfg.ssm_nheads
    cols = Din + 2 * N + H  # the xBC and dt columns
    per = {
        "gate_norm": 7 * Din * itemsize,
        "conv": (2 * cols + 2 * Din + 2 * N) * itemsize + 2 * H * 4,
        "norm": 3 * D * itemsize,
    }
    return {k: v * tokens for k, v in per.items()}
