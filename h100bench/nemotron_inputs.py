"""The weights a nemotron_h run makes from its seed, in the port's tree.

As ``h100bench/inputs.py`` makes the ssm family's (one ``Maker`` on the
run's device, the leaf's serving type), for the port's Nemotron-H keys and
layouts (``repro_torch.models.nemotron_h``): the Mamba blocks ``[#M, ...]``
with ``mamba_num_heads`` heads (d_inner their product) and ``ssm_ngroups``
groups of B and C, the attention layers ``[#*, ...]``, the MoE layers
``[#E, ...]``.  A stacked leaf is one call, but the routed experts, which
are drawn a layer at a time.  Scales are the port's initialisers': N(0,
0.02) projections, the output projections (attention's ``wo``, the Mamba
blocks' ``out_proj``, the experts' and the shared expert's down
projections) scaled by 1/sqrt(2 n_layers), the router N(0, 0.02) and its
correction bias N(0, 0.01) in float32 (nonzero, so that a router that
leaves it out of the selection chooses other experts and shows), norm
scales one; the Mamba blocks' other leaves as ``inputs.mamba_blocks`` makes them.
Token batches are ``inputs.tokens``'.  This module imports torch alone.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from h100bench.inputs import DTYPES, F32, Maker, generator, tokens  # noqa: F401

KINDS = {"M": "mamba", "*": "attn", "E": "moe"}
BIAS_STD = 0.01


def _out(w: Dict) -> float:
    return 0.02 / math.sqrt(max(1, 2 * w["n_layers"]))


def mamba_blocks(mk: Maker, w: Dict, n: int) -> Dict:
    D, P, N, Wc = w["d_model"], w["ssm_headdim"], w["ssm_state"], w["ssm_conv_width"]
    H, G = w["mamba_num_heads"], w["ssm_ngroups"]
    Din = H * P
    ch = Din + 2 * G * N
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float64, device=mk.device))
    return {
        "norm": {"scale": mk.full((n, D), 1.0)},
        "in_proj": {"w": mk.normal((n, D, Din + ch + H), 0.02)},
        "conv_w": mk.normal((n, Wc, ch), 0.2),
        "conv_b": mk.full((n, ch), 0.0),
        "A_log": a_log.to(F32).expand((n, H)).contiguous(),
        "D": mk.full((n, H), 1.0),
        "dt_bias": mk.full((n, H), math.log(math.expm1(0.01))),
        "out_norm": {"scale": mk.full((n, Din), 1.0)},
        "out_proj": {"w": mk.normal((n, Din, D), _out(w))},
    }


def attention_layers(mk: Maker, w: Dict, n: int) -> Dict:
    D, dh = w["d_model"], w["head_dim"]
    Aq, Akv = w["n_heads"] * dh, w["n_kv_heads"] * dh
    return {
        "norm": {"scale": mk.full((n, D), 1.0)},
        "wq": {"w": mk.normal((n, D, Aq), 0.02)},
        "wk": {"w": mk.normal((n, D, Akv), 0.02)},
        "wv": {"w": mk.normal((n, D, Akv), 0.02)},
        "wo": {"w": mk.normal((n, Aq, D), _out(w))},
    }


def _per_layer(mk: Maker, shape: Tuple[int, ...], std: float) -> torch.Tensor:
    """A stacked leaf ``[n, ...]`` drawn a layer at a time."""
    t = torch.empty(shape, dtype=mk.dtype, device=mk.device)
    for i in range(shape[0]):
        t[i].normal_(0.0, std, generator=mk.gen)
    return t


def moe_layers(mk: Maker, w: Dict, n: int) -> Dict:
    D, E, F, Fs = w["d_model"], w["n_experts"], w["moe_d_ff"], w["moe_shared_d_ff"]
    return {
        "norm": {"scale": mk.full((n, D), 1.0)},
        "router": {"w": mk.normal((n, D, E), 0.02, dtype=F32)},
        "e_bias": mk.normal((n, E), BIAS_STD, dtype=F32),
        "w_up": _per_layer(mk, (n, E, D, F), 0.02),
        "w_down": _per_layer(mk, (n, E, F, D), _out(w)),
        "shared_up": {"w": mk.normal((n, D, Fs), 0.02)},
        "shared_down": {"w": mk.normal((n, Fs, D), _out(w))},
    }


def weights(w: Dict, seed: int, device) -> Dict:
    """The parameter tree of configuration widths ``w`` for run ``seed``."""
    if w["family"] != "nemotron_h":
        raise ValueError(f"no nemotron_h weights for family {w['family']!r}")
    mk = Maker(generator(seed, 1, device), device, DTYPES[w["dtype"]])
    D, V = w["d_model"], w["vocab_size"]
    pattern = w["layer_pattern"]
    make = {"mamba": mamba_blocks, "attn": attention_layers, "moe": moe_layers}
    tree = {"embed": {"emb": mk.normal((V, D), 0.02)}}
    for letter, kind in KINDS.items():
        if pattern.count(letter):
            tree[kind] = make[kind](mk, w, pattern.count(letter))
    tree["final_norm"] = {"scale": mk.full((D,), 1.0)}
    tree["head"] = {"w": mk.normal((D, V), 0.02)}
    return tree
