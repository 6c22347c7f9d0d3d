"""Where the port's entry points run, and which route a call takes there.

Every entry point takes ``device=None`` and resolves it here: ``None``
means the CUDA card, and a host without one raises instead of carrying
on silently on the CPU.  Callers that want the host (the CPU tests) say
so with ``device="cpu"``.

Each hand-written kernel sits behind a ``kernels/<name>/ops.py`` that
routes a call on what its inputs show, by one rule:

* a tensor on a device of :data:`PLAIN_DEVICES` goes to the plain torch
  version: on the CPU the route the tests hold to the JAX package, on
  ``meta`` the dry run's shapes, so a FLOP count sees the plain version's
  products;
* a call that autograd records (:func:`recording`) goes where the
  operation has a backward: the plain version, or a Function around the
  kernel whose backward is written (``ssd_scan.ops.SSDScan``, and the
  Mamba passes' three in ``mamba_passes.kernel.mamba_passes_grad``);
* every other tensor goes to the kernel, which launches or raises.  There
  is no fallback.

Each ``ops`` module imports :data:`PLAIN_DEVICES` as a name of its own, so
a test can narrow or widen one kernel's route by setting ``ops.PLAIN_DEVICES``.
"""

from __future__ import annotations

from typing import Union

import torch

#: device types routed to the plain versions; every other goes to the kernels
PLAIN_DEVICES = ("cpu", "meta")


def recording(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on ``tensors``: grad enabled and any
    of them requiring grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device with no card present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run the "
            "torch port on the host"
        )
    return dev
