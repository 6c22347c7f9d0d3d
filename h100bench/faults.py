"""Faults planted underneath the timed path, to show that ``correct`` fails.

Each fault wraps what the port's ``build_model`` returns (or, for a step
that returns its state unchanged in training, the port's AdamW update)
for as long as its context is open.  The harness runs as it always does
on top.  ``h100bench/calibrate.py`` reads the faults of a training cell
on the card at the cell's own size; the tests plant every fault at a
small size on the CPU.  None is reachable from ``run.py``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict

import torch

#: the faults each kind of cell can have
KINDS = {
    "prefill": ("answer_altered", "half_batch"),
    "train": ("state_unchanged", "half_batch", "labels_unshifted"),
}


def _roll_row0(logits: torch.Tensor) -> torch.Tensor:
    out = logits.clone()
    out[0] = torch.roll(out[0], 1, dims=-1)
    return out


def _wrappers(name: str) -> Dict[str, Callable]:
    """{Model attribute: wrapper of the attribute} for a fault."""
    if name == "answer_altered":
        return {"prefill": lambda f: lambda p, b: _roll_row0(f(p, b))}
    if name == "half_batch":
        def prefill(f):
            def g(p, b):
                h = b["tokens"].shape[0] // 2
                out = f(p, {k: v[:h] for k, v in b.items()})
                return out[torch.arange(b["tokens"].shape[0]) % h]
            return g

        def loss(f):
            return lambda p, b: f(p, {k: v[: v.shape[0] // 2] for k, v in b.items()})
        return {"prefill": prefill, "loss": loss}
    if name == "labels_unshifted":
        return {"loss": lambda f: lambda p, b: f(p, dict(b, labels=b["tokens"]))}
    if name == "state_unchanged":
        return {}
    raise ValueError(f"no fault {name!r}")


@contextlib.contextmanager
def planted(name: str):
    """The port's models built while this is open carry fault ``name``."""
    from repro_torch.models import model_api
    from repro_torch.optim import adamw

    wraps = _wrappers(name)
    orig_build, orig_update = model_api.build_model, adamw.adamw_update

    def build(cfg, device=None):
        model = orig_build(cfg, device)
        for attr, wrap in wraps.items():
            setattr(model, attr, wrap(getattr(model, attr)))
        return model

    model_api.build_model = build
    if name == "state_unchanged":
        adamw.adamw_update = lambda cfg, params, grads, state: (
            params, state, {"lr": torch.zeros(()), "grad_norm": torch.zeros(())})
    try:
        yield
    finally:
        model_api.build_model, adamw.adamw_update = orig_build, orig_update
