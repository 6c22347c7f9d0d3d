"""Parameters from numpy arrays to tensors, in the JAX package's layouts.

The JAX package keeps layer-variant weights as ``w [C/g^2, K/g^2]``
(the fused pointwise variant) and ``w_full [R, S, C/g^2, K/g^2]`` (the
R x S variant behind im2col).  Its LM parameter trees keep every linear
as ``{"w": [d_in, d_out]}`` too, but stack the blocks: each leaf under
``blocks`` has a leading ``n_layers`` axis (``jax.vmap`` of the block
init), and the hybrid and MoE trees stack some blocks twice, by group
and by position in the group (:data:`STACKED`).  The Mamba2 tree adds
``conv_w [W, conv_ch]`` and f32 vectors
(``A_log``, ``D``, ``dt_bias``, ``conv_b``) that keep their dtype.  The
port keeps the same layouts at its public functions, so a test hands
both packages the very same numbers: it draws them with numpy, gives the
arrays to the JAX function, and passes the same tree through
:func:`params_from_numpy` for the port.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device

#: leaf name -> rank of its JAX layout (checked on conversion); ``conv_w`` is
#: the Mamba2 block's depthwise conv weight ``[W, conv_ch]``
LAYOUT_RANKS = {"w": 2, "w_full": 4, "conv_w": 2}
#: subtree -> the leading stacked-layer axes its leaves carry: one ``jax.vmap``
#: of the block init (``[n_layers, ...]``), or two nested ones (``[groups,
#: per_group, ...]``: zamba2's Mamba blocks, llama4's dense blocks)
STACKED = {"blocks": 1, "moe_blocks": 1, "enc_blocks": 1, "dec_blocks": 1,
           "mamba_blocks": 2, "dense_blocks": 2}


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

    Leaves named in :data:`LAYOUT_RANKS` must have that rank, plus the
    stacked axes of each enclosing :data:`STACKED` subtree
    (``blocks/attn/wq/w`` is ``[n_layers, d_in, d_out]``,
    ``mamba_blocks/conv_w`` is ``[groups, per_group, W, conv_ch]``); a
    mismatch raises ``ValueError`` naming the leaf's path.  ``expect`` maps a leaf's path (``"a/b/w"``)
    or its bare name (``"w"``) to the exact shape it must have; the path
    wins where both are given."""
    dev = resolve_device(device)
    expect = expect or {}

    def conv(node, path, name=None):
        # name: the leaf's own key; a list's elements go by the list's key
        if isinstance(node, dict):
            return {k: conv(v, path + (str(k),), k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v, path + (str(i),), name) for i, v in enumerate(node))
        where = "/".join(path)
        if not isinstance(node, (np.ndarray, np.generic)):
            raise TypeError(f"leaf {where!r} is {type(node).__name__}, not a numpy array")
        want = LAYOUT_RANKS.get(name)
        if want is not None:
            want += sum(STACKED.get(part, 0) for part in path[:-1])
            if np.ndim(node) != want:
                raise ValueError(
                    f"leaf {where!r} has shape {np.shape(node)}; its JAX layout "
                    f"has rank {want}"
                )
        shape = expect.get(where, expect.get(name))
        if shape is not None and tuple(np.shape(node)) != tuple(shape):
            raise ValueError(
                f"leaf {where!r} has shape {np.shape(node)}, expected {tuple(shape)}"
            )
        return _tensor(node, dev)

    return conv(tree, ())
