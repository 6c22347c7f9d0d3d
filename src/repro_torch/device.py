"""Where the port's entry points run.

Every entry point takes ``device=None`` and resolves it here: ``None``
means the CUDA card, and a host without one raises instead of carrying
on silently on the CPU.  Callers that want the host (the CPU tests) say
so with ``device="cpu"``.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device with no card present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run the "
            "torch port on the host"
        )
    return dev
