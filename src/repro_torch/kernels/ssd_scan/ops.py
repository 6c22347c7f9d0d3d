"""Public wrapper of the SSD mixer: the chunked scan behind one switch.

Port of the JAX package's ``kernels/ssd_scan/ops.py``.  The model's
prefill and its training forward (``models.mamba2.mamba_block_apply``)
call :func:`ssd_scan`, which routes by ``repro_torch.device``'s rule: the
plain blocked version (:func:`.ref.ssd_chunked`), which autograd
differentiates as it is, on :data:`PLAIN_DEVICES`; the hand-written kernel
(:mod:`.kernel`) on every other device.  While autograd records, the
kernel runs inside :class:`SSDScan`, whose backward routes by the same
rule: on :data:`PLAIN_DEVICES`, :func:`plain_grads` (autograd through the
plain ``ssd_chunked`` recomputed from the saved inputs: the function the
JAX package differentiates, since it has no backward kernel); on every
other device, the hand-written backward kernel
(:func:`.kernel_bwd.ssd_scan_bwd_cuda`), which computes the same
gradients.  So no CUDA tensor reaches the plain version.

The JAX switch's ``backend`` and ``interpret`` choices have no
counterpart: the plain version and the oracle are called from
:mod:`.ref` directly.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.device import PLAIN_DEVICES, recording
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
from repro_torch.kernels.ssd_scan.kernel_bwd import ssd_scan_bwd_cuda
from repro_torch.spans import span


def plain_grads(inputs: Sequence[torch.Tensor], needs: Sequence[bool], chunk: int,
                dy: torch.Tensor):
    """Gradients of ``ref.ssd_chunked`` at ``inputs = (x, log_a, B, C,
    dt)`` against the output gradient ``dy``: the forward recomputed on
    detached copies under ``torch.enable_grad()``, then
    ``torch.autograd.grad``; None where ``needs`` is false."""
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    with torch.enable_grad():
        xs = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        y = ssd_chunked(*xs, chunk)
        wanted = [t for t in xs if t.requires_grad]
        got = iter(torch.autograd.grad(y, wanted, dy) if wanted else ())
    return tuple(next(got) if n else None for n in needs)


class SSDScan(torch.autograd.Function):
    """The kernel's forward under autograd; its backward, inside the span
    ``ssd_scan.backward``, the backward kernel on a CUDA tensor and
    :func:`plain_grads` on :data:`PLAIN_DEVICES`.  ``backward_calls``
    counts the backward's calls since the process began."""

    backward_calls = 0

    @staticmethod
    def forward(ctx, x, log_a, B, C, dt, chunk):
        ctx.save_for_backward(x, log_a, B, C, dt)
        ctx.chunk = chunk
        return ssd_scan_cuda(x, log_a, B, C, dt, chunk)

    @staticmethod
    def backward(ctx, dy):
        SSDScan.backward_calls += 1
        needs = ctx.needs_input_grad[:5]
        with span("ssd_scan.backward"):
            if dy.device.type in PLAIN_DEVICES:
                grads = plain_grads(ctx.saved_tensors, needs, ctx.chunk, dy)
            else:
                grads = ssd_scan_bwd_cuda(*ctx.saved_tensors, dy, ctx.chunk, needs)
        return grads + (None,)


def ssd_scan(x: torch.Tensor, log_a: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
             dt: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """x [Bt, L, H, P], log_a / dt [Bt, L, H], B / C [Bt, L, N] (shared by every
    head) or [Bt, L, G, N] (head h reads group h G / H) -> y [Bt, L, H, P].

    The span ``ssd_scan`` holds the route that computes the scan, whichever
    it is; the copies of the model's views into contiguous tensors lie
    outside it, with the caller's passes."""
    if x.device.type in PLAIN_DEVICES:
        from repro_torch.kernels.ssd_scan.ref import ssd_chunked

        with span("ssd_scan"):
            return ssd_chunked(x, log_a, B, C, dt, chunk)
    # the plain passes hand in views of their (x, B, C) projection; the fused
    # passes contiguous tensors, which copy nothing here
    args = tuple(t.contiguous() for t in (x, log_a, B, C, dt))
    with span("ssd_scan"):
        if recording(*args):
            return SSDScan.apply(*args, chunk)
        return ssd_scan_cuda(*args, chunk)
