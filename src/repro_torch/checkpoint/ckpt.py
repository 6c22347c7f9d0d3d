"""Checkpoints of torch trees in the JAX package's layout (msgpack + atomic rename).

Port of the JAX package's ``checkpoint/ckpt.py``; one checkpoint restores
in either package.

* ``save``: copies each leaf to the host and serializes the flattened
  ``{path: {dtype, shape, data, bf16}}`` map with msgpack, written to a
  temp file, fsynced and renamed, then marked ``COMMITTED``: a crash
  mid-save never corrupts the last good checkpoint.  Paths are the
  reference's: keys joined with ``/``, a ``NamedTuple``'s fields as
  ``.name`` (``str`` of JAX's ``GetAttrKey``: ``opt/.step``,
  ``opt/.m/embed/emb``), a list's elements by index.  bf16 leaves are
  stored as f32 bytes with ``"bf16": true``.
* ``restore``: rebuilds the tree of ``like`` on ``device`` (the CUDA card
  when None), bf16 leaves read back from f32 with round-to-nearest-even
  (as ``ml_dtypes`` does); restoring onto another device than the one
  that saved is the one-card form of the reference's elastic restore.
* ``latest_step`` + step-numbered directories give restart-after-failure
  semantics; the trainer in ``repro_torch.launch.train`` checkpoints
  every N steps and resumes from the newest complete checkpoint.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Optional, Union

import msgpack
import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_items, tree_rebuild

Params = Any


def _entry(t: torch.Tensor) -> Dict[str, Any]:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return {"dtype": "bfloat16", "shape": list(t.shape),
                "data": t.float().numpy().tobytes(), "bf16": True}
    a = t.numpy()
    return {"dtype": str(a.dtype), "shape": list(a.shape), "data": a.tobytes(), "bf16": False}


def _encode(tree: Params) -> bytes:
    return msgpack.packb({k: _entry(v) for k, v in tree_items(tree)}, use_bin_type=True)


def _decode(raw: bytes) -> Dict[str, torch.Tensor]:
    out = {}
    for k, meta in msgpack.unpackb(raw, raw=False).items():
        if meta.get("bf16"):
            arr = np.frombuffer(meta["data"], dtype=np.float32).reshape(meta["shape"])
            out[k] = torch.from_numpy(arr.copy()).to(torch.bfloat16)
        else:
            arr = np.frombuffer(meta["data"], dtype=np.dtype(meta["dtype"])).reshape(meta["shape"])
            out[k] = torch.from_numpy(arr.copy())
    return out


def save(path: str, step: int, tree: Params) -> str:
    """Atomic checkpoint write; returns the checkpoint directory."""
    ckpt_dir = os.path.join(path, f"step_{step:08d}")
    os.makedirs(ckpt_dir, exist_ok=True)
    target = os.path.join(ckpt_dir, "state.msgpack")
    raw = _encode(tree)
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(raw)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    # completion marker makes partially-written checkpoints detectable
    with open(os.path.join(ckpt_dir, "COMMITTED"), "w") as f:
        f.write(str(step))
    return ckpt_dir


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = []
    for d in os.listdir(path):
        if d.startswith("step_") and os.path.exists(os.path.join(path, d, "COMMITTED")):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def restore(path: str, step: int, like: Params,
            device: Union[str, torch.device, None] = None) -> Params:
    """Load ``step`` into a tree shaped as ``like`` (each leaf's shape
    checked), its tensors on ``device`` in the checkpoint's dtypes."""
    dev = resolve_device(device)
    target = os.path.join(path, f"step_{step:08d}", "state.msgpack")
    with open(target, "rb") as f:
        flat = _decode(f.read())

    def leaf(key, like_leaf):
        t = flat[key]
        if tuple(t.shape) != tuple(like_leaf.shape):
            raise ValueError(f"shape mismatch at {key}: ckpt {tuple(t.shape)} vs model "
                             f"{tuple(like_leaf.shape)}")
        return t.to(dev)

    return tree_rebuild(like, leaf)
