"""Serving entry point of the torch port: greedy decode loop for every family of the registry.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b --tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b --tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base --tokens 16

Port of the JAX package's ``launch/serve.py``: cache init, one
``decode_step`` per token from token 0, greedy sampling (like the JAX
loop, it hands no prefill state to decode: whisper's cross K/V stay as
``init_cache`` leaves them, zero).  It runs on the CUDA card unless the
caller passes ``device="cpu"``; without a card and without that, it
raises.  On the card every attention step of the dense, vlm, moe and
encdec families (whisper: self- and cross-attention) and of the hybrid
family's shared block runs through the hand-written decode-attention
kernel; the ssm family (mamba2) decodes by its O(1) recurrent update,
which launches no kernel of the port, and so do the hybrid's Mamba
blocks.  Weights are drawn at random from ``seed``.  :func:`run` is
:func:`load` followed by :func:`decode`; a caller that wants the weights
as well (to replay the same steps) calls the two, and one that has
filled a cache (a prompt's keys and values, whisper's cross K/V) hands
it to :func:`decode` with the position and tokens to go on from.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Tuple, Union

import torch

from repro_torch.configs import get_config
from repro_torch.configs.registry import ARCHS
from repro_torch.models.model_api import Model, Params, build_model


def load(arch: str, reduced: bool = True, device: Union[str, torch.device, None] = None,
         seed: int = 0) -> Tuple[Model, Params]:
    """The model (``reduced(dtype="float32")`` unless ``reduced`` is False,
    then the published widths in the config's dtype) and its weights."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced(dtype="float32")
    model = build_model(cfg, device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    return model, model.init(gen)


def decode(model: Model, params: Params, tokens: int = 16, batch: int = 2,
           ctx: int = 64, cache: Optional[Params] = None, start: int = 0,
           first: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``tokens`` greedy steps at positions ``start..start+tokens-1`` ->
    ``[batch, tokens]`` int32 ids: from token 0 and a fresh cache of
    ``ctx`` positions, or from ``first [batch]`` and ``cache`` (written in
    place), whose first ``start`` positions the caller has filled."""
    if start + tokens > ctx:
        raise ValueError(f"{tokens} tokens from position {start} do not fit a cache of "
                         f"{ctx} positions")
    dev = model.device
    if cache is None:
        cache = model.init_cache(batch, ctx)
    tok = torch.zeros((batch,), dtype=torch.int32, device=dev) if first is None else first
    out_tokens = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for i in range(start, start + tokens):
        logits, cache = model.decode_step(params, tok, cache, i)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out_tokens.append(tok)
    seq = torch.stack(out_tokens, dim=1)
    sample = seq[0][:12].tolist()  # waits for the device
    dt = time.perf_counter() - t0
    print(f"[serve] {model.cfg.name}: generated {tokens} tokens x{batch} in {dt*1e3:.0f} ms "
          f"({dt/tokens*1e3:.1f} ms/token on {dev.type})")
    print(f"[serve] sample: {sample}")
    return seq


def run(arch: str, tokens: int = 16, batch: int = 2, ctx: int = 64, reduced: bool = True,
        device: Union[str, torch.device, None] = None, seed: int = 0) -> torch.Tensor:
    model, params = load(arch, reduced=reduced, device=device, seed=seed)
    return decode(model, params, tokens=tokens, batch=batch, ctx=ctx)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS), required=True)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args()
    run(args.arch, tokens=args.tokens, batch=args.batch, reduced=not args.full)


if __name__ == "__main__":
    main()
