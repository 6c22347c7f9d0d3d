"""Parameters from numpy arrays to tensors, in the JAX package's layouts.

The JAX package keeps layer-variant weights as ``w [C/g^2, K/g^2]``
(the fused pointwise variant) and ``w_full [R, S, C/g^2, K/g^2]`` (the
R x S variant behind im2col).  The port keeps the same layouts at its
public functions, so a test hands both packages the very same numbers:
it draws them with numpy, gives the arrays to the JAX function, and
passes the same tree through :func:`params_from_numpy` for the port.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device

#: leaf name -> rank of its JAX layout (checked on conversion)
LAYOUT_RANKS = {"w": 2, "w_full": 4}


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")  # a private, writable copy (jax's are read-only)
    if a.dtype.name == "bfloat16":
        # numpy has no native bf16 (jax arrays come back as ml_dtypes
        # bfloat16): move the raw bits, so the weights stay bit-equal
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(
    tree: Any,
    device: Union[str, torch.device, None] = None,
    expect: Optional[Dict[str, Tuple[int, ...]]] = None,
) -> Any:
    """Convert a dict/list/tuple tree of numpy arrays into tensors on
    ``device`` (``cuda`` when None), keeping every array's layout.

    Leaves named in :data:`LAYOUT_RANKS` must have that rank; a
    mismatch raises ``ValueError`` naming the leaf.  ``expect`` maps a
    leaf name to the exact shape it must have (e.g. ``{"w": (Cv, Kv)}``)."""
    dev = resolve_device(device)

    def conv(node, name=None):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v, name) for v in node)
        if not isinstance(node, (np.ndarray, np.generic)):
            raise TypeError(f"leaf {name!r} is {type(node).__name__}, not a numpy array")
        want = LAYOUT_RANKS.get(name)
        if want is not None and np.ndim(node) != want:
            raise ValueError(
                f"leaf {name!r} has shape {np.shape(node)}; its JAX layout "
                f"has rank {want}"
            )
        shape = (expect or {}).get(name)
        if shape is not None and tuple(np.shape(node)) != tuple(shape):
            raise ValueError(
                f"leaf {name!r} has shape {np.shape(node)}, expected {tuple(shape)}"
            )
        return _tensor(node, dev)

    return conv(tree)
