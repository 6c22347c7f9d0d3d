"""Fault tolerance for the training loop.

Port of the JAX package's ``runtime/ft.py``: :class:`StragglerMonitor`
and :class:`Supervisor` as they are, over the port's checkpoints
(``repro_torch.checkpoint.ckpt``).

* **Checkpoint/restart**: periodic atomic checkpoints; on startup the
  supervisor resumes from the newest COMMITTED step.  Because the data
  pipeline is a pure function of (seed, step), restart reproduces the
  exact batch sequence.
* **Preemption safety**: SIGTERM triggers a final checkpoint before exit.
* **Bad-step quarantine**: a non-finite loss or grad-norm rolls back to
  the last checkpoint and *skips* the offending data step.
* **Straggler detection**: steps slower than ``factor`` x the running
  median of the last ``window`` step times raise an event.

:func:`elastic_remesh` restores a checkpoint onto another layout
(``repro_torch.launch.mesh``): the spec tree is fitted to the layout,
which must hold as many devices as the port runs on (one: every axis of
size 1), and the arrays are restored onto ``device``; a larger layout
raises, naming both counts, as the reference's mesh does on a host
without its devices.  ``Supervisor.restore(step, like, device)``
(``ckpt.restore``) restores onto any device, whichever wrote the
checkpoint (CPU <-> card).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import signal
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.launch.mesh import fitted_shardings, require_devices


@dataclasses.dataclass
class StragglerMonitor:
    factor: float = 3.0
    window: int = 32
    times: List[float] = dataclasses.field(default_factory=list)
    events: List[Tuple[int, float, float]] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        med = float(np.median(self.times[-self.window :])) if self.times else dt
        self.times.append(dt)
        if len(self.times) >= 8 and dt > self.factor * med:
            self.events.append((step, dt, med))
            return True
        return False


@dataclasses.dataclass
class Supervisor:
    ckpt_dir: str
    ckpt_every: int = 50
    keep_last: int = 3
    straggler: StragglerMonitor = dataclasses.field(default_factory=StragglerMonitor)
    _last_good: Optional[int] = None
    _term_requested: bool = False

    def install_signal_handler(self) -> None:
        def _on_term(signum, frame):
            self._term_requested = True

        signal.signal(signal.SIGTERM, _on_term)

    # ---- resume ------------------------------------------------------------
    def resume_step(self) -> Optional[int]:
        return ckpt_lib.latest_step(self.ckpt_dir)

    def restore(self, step: int, like, device: Union[str, torch.device, None] = None):
        self._last_good = step
        return ckpt_lib.restore(self.ckpt_dir, step, like, device)

    # ---- per-step bookkeeping ----------------------------------------------
    def checkpoint(self, step: int, state) -> None:
        ckpt_lib.save(self.ckpt_dir, step, state)
        self._last_good = step
        self._gc()

    def _gc(self) -> None:
        if not os.path.isdir(self.ckpt_dir):
            return
        steps = sorted(
            int(d.split("_")[1])
            for d in os.listdir(self.ckpt_dir)
            if d.startswith("step_") and os.path.exists(os.path.join(self.ckpt_dir, d, "COMMITTED"))
        )
        for s in steps[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"), ignore_errors=True)

    def on_step(
        self, step: int, dt: float, metrics: Dict[str, Any], state
    ) -> Tuple[str, Optional[int]]:
        """Returns (action, rollback_step). Actions: 'ok' | 'rollback' |
        'checkpoint_and_exit'."""
        if self._term_requested:
            self.checkpoint(step, state)
            return "checkpoint_and_exit", None
        loss = float(metrics.get("loss", 0.0))
        gnorm = float(metrics.get("grad_norm", 0.0))
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            return "rollback", self._last_good
        self.straggler.observe(step, dt)
        if self.ckpt_every and step > 0 and step % self.ckpt_every == 0:
            self.checkpoint(step, state)
        return "ok", None


def elastic_remesh(ckpt_dir: str, step: int, like, new_mesh, spec_tree,
                   device: Union[str, torch.device, None] = None):
    """Restore a checkpoint onto a DIFFERENT layout (scale up/down): the
    checkpoint stores full (unsharded) arrays, so resharding is fitting
    the spec tree to the new layout.  The port runs on one device, so the
    layout must have size 1; the arrays land on ``device`` (the card when
    None)."""
    require_devices(new_mesh, 1)
    fitted_shardings(spec_tree, like, new_mesh)
    return ckpt_lib.restore(ckpt_dir, step, like, device)
