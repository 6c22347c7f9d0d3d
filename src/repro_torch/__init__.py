"""Terastal on PyTorch and CUDA: the port of the JAX package ``repro``.

Same layout as the JAX package (``core/``, ``costmodel/``,
``kernels/``), written with torch tensors and an explicit ``device``.
Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see :mod:`repro_torch.device`).  Nothing here imports
jax or the JAX package.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
