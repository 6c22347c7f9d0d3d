"""The inputs a run makes from its seed: weights and token batches.

Everything is drawn on the run's device by ``torch.Generator``s seeded
from ``--seed``, one large call a stacked leaf and in the type the leaf
is served in, so the same seed gives the same inputs and set-up stays
short.  The trees have the port's keys and layouts (layers stacked along
leading dims); the program and the reference are handed the same
tensors.  Scales are those of the port's own initialisers: N(0, 0.02)
projections, output projections scaled by 1/sqrt(2 n_layers), the conv
taps N(0, 0.2), ``A_log = log(linspace(1, 16, H))``, ``dt_bias =
softplus^-1(0.01)``, ``D`` and the norm scales one, the conv bias zero.
This module imports torch alone.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

BF16, F32 = torch.bfloat16, torch.float32
DTYPES = {"bfloat16": BF16, "float32": F32}


def sub_seed(seed: int, stream: int) -> int:
    """A seed for one stream of inputs (weights, tokens, state) of run ``seed``."""
    return (seed * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) % (1 << 63)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))


class Maker:
    """Draws leaves in one order from one generator."""

    def __init__(self, gen: torch.Generator, device, dtype: torch.dtype):
        self.gen, self.device, self.dtype = gen, device, dtype

    def normal(self, shape, std: float, dtype=None) -> torch.Tensor:
        t = torch.empty(shape, dtype=dtype or self.dtype, device=self.device)
        return t.normal_(0.0, std, generator=self.gen)

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, dtype=F32, device=self.device)


def mamba_blocks(mk: Maker, w: Dict, lead: Tuple[int, ...]) -> Dict:
    D, P, N, Wc = w["d_model"], w["ssm_headdim"], w["ssm_state"], w["ssm_conv_width"]
    Din = w["ssm_expand"] * D
    H, ch = Din // P, Din + 2 * N
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float64, device=mk.device))
    return {
        "norm": {"scale": mk.full(lead + (D,), 1.0)},
        "in_proj": {"w": mk.normal(lead + (D, 2 * Din + 2 * N + H), 0.02)},
        "conv_w": mk.normal(lead + (Wc, ch), 0.2),
        "conv_b": mk.full(lead + (ch,), 0.0),
        "A_log": a_log.to(F32).expand(lead + (H,)).contiguous(),
        "D": mk.full(lead + (H,), 1.0),
        "dt_bias": mk.full(lead + (H,), math.log(math.expm1(0.01))),
        "out_norm": {"scale": mk.full(lead + (Din,), 1.0)},
        "out_proj": {"w": mk.normal(lead + (Din, D), 0.02 / math.sqrt(max(1, 2 * w["n_layers"])))},
    }


def weights(w: Dict, seed: int, device) -> Dict:
    """The parameter tree of configuration widths ``w`` for run ``seed``."""
    mk = Maker(generator(seed, 1, device), device, DTYPES[w["dtype"]])
    tree = {"embed": {"emb": mk.normal((w["vocab_size"], w["d_model"]), 0.02)},
            "final_norm": {"scale": mk.full((w["d_model"],), 1.0)}}
    if w["family"] != "ssm":
        raise ValueError(f"no weights for family {w['family']!r}")
    tree["blocks"] = mamba_blocks(mk, w, (w["n_layers"],))
    return tree


def tokens(w: Dict, seed: int, shape: Tuple[int, ...], device, stream: int = 2) -> torch.Tensor:
    """Token ids uniform over the vocabulary, int64."""
    return torch.randint(0, w["vocab_size"], shape, generator=generator(seed, stream, device),
                         device=device, dtype=torch.int64)
