"""Training entry point of the torch port: real steps on one card, fault-tolerant loop.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --full \\
        --steps 6 --batch 8 --seq 1024

Port of the JAX package's ``launch/train.py``: the registry model
(``reduced(dtype="float32")`` unless ``--full``, then the published widths
in the config's dtype) trained by ``optim.adamw.make_train_step`` on
``data.pipeline`` batches, the loop supervised by
:class:`repro_torch.runtime.ft.Supervisor`: resume from the newest
checkpoint, a checkpoint at N holding the state before step N, rollback
on a non-finite step (the data shifted past it), checkpoint and exit on
SIGTERM, straggler events.  It runs on the CUDA card unless the caller
passes ``device="cpu"``; without a card and without that, it raises.  On
the card the ssm and hybrid families run every SSD scan of the forward
(and of each layer's recompute) through the hand-written kernel.
Weights are drawn at random from ``seed``.  ``use_mesh`` places the
parameters by the model's ``param_specs("train")`` fitted to ``mesh``
(the reference's production mesh when None), which must hold as many
devices as the port runs on, one: a one-card layout
(``launch.mesh.one_device_mesh()``) trains as without it, and the
production layout raises, naming both counts, as the reference's does on
a host without 256 devices.
"""

from __future__ import annotations

import argparse
import os
import signal
import tempfile
import time
from typing import Optional, Union

import torch

from repro_torch.configs import get_config
from repro_torch.configs.registry import ARCHS
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.launch.mesh import fitted_shardings, make_production_mesh, require_devices
from repro_torch.models.model_api import build_model
from repro_torch.optim.adamw import OptConfig, init_opt_state, make_train_step
from repro_torch.runtime.ft import Supervisor


def run(
    arch: str,
    steps: int = 100,
    batch: int = 8,
    seq: int = 128,
    reduced: bool = True,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    use_mesh: bool = False,
    log_every: int = 10,
    seed: int = 0,
    device: Union[str, torch.device, None] = None,
    mesh=None,
):
    """Train ``steps`` steps; returns ``final_loss``, ``losses`` (one a step
    run), ``straggler_events``, ``params`` and ``step_s`` (each step's
    seconds, from its batch on the device to its loss on the host)."""
    if use_mesh:
        mesh = mesh if mesh is not None else make_production_mesh()
        require_devices(mesh, 1)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced(dtype="float32")
    model = build_model(cfg, device)
    params = model.init(torch.Generator(device=model.device).manual_seed(seed))
    if use_mesh:
        # every spec fits a one-device layout, so the parameters stay where they are
        fitted_shardings(model.param_specs("train"), params, mesh)
    opt = init_opt_state(params)
    opt_cfg = OptConfig(warmup_steps=max(1, steps // 20), total_steps=steps)
    train_step = make_train_step(model.loss, opt_cfg)

    sup = Supervisor(ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"),
                     ckpt_every=ckpt_every)
    previous = signal.getsignal(signal.SIGTERM)
    sup.install_signal_handler()
    try:
        start_step = 0
        resume = sup.resume_step() if ckpt_dir else None
        if resume is not None:
            state = sup.restore(resume, {"params": params, "opt": opt}, model.device)
            params, opt = state["params"], state["opt"]
            start_step = resume
            print(f"[train] resumed from step {resume}")

        dcfg = DataConfig(global_batch=batch, seq_len=seq, seed=1234)
        pipe = Pipeline(cfg, dcfg, start_step=start_step, device=model.device)
        losses, step_s = [], []
        step = start_step
        while step < steps:
            batch_data = next(pipe)
            t0 = time.time()
            params, opt, metrics = train_step(params, opt, batch_data)
            loss = float(metrics["loss"])  # waits for the step
            dt = time.time() - t0
            losses.append(loss)
            step_s.append(dt)
            if step % log_every == 0:
                print(f"[train] step {step} loss {loss:.4f} ({dt*1e3:.0f} ms)")
            step += 1
            # checkpoint convention: a checkpoint at N is the state BEFORE
            # running step N, so restart resumes with data step N exactly.
            action, rb = sup.on_step(step, dt, metrics, {"params": params, "opt": opt})
            if action == "rollback" and rb is not None:
                state = sup.restore(rb, {"params": params, "opt": opt}, model.device)
                params, opt = state["params"], state["opt"]
                step = rb
                pipe = Pipeline(cfg, dcfg, start_step=step + 1, device=model.device)  # shift past bad data
                print(f"[train] non-finite step; rolled back to {rb}")
                continue
            if action == "checkpoint_and_exit":
                print("[train] SIGTERM: checkpointed and exiting")
                break
        if ckpt_dir:
            sup.checkpoint(step, {"params": params, "opt": opt})
    finally:
        signal.signal(signal.SIGTERM, previous)
    return {"final_loss": losses[-1] if losses else None, "losses": losses,
            "straggler_events": sup.straggler.events, "params": params, "step_s": step_s}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS), required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true", help="full (non-reduced) config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    args = ap.parse_args()
    out = run(
        args.arch,
        steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        reduced=not args.full,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
    )
    print(f"[train] done; final loss {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
