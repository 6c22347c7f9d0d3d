"""The weights a deepseek_v3 run makes from its seed, in the port's tree.

As ``h100bench/inputs.py`` makes the ssm family's (one ``Maker`` on the
run's device, the leaf's serving type), for the port's DeepSeek-V3 keys and
layouts (``repro_torch.models.deepseek_v3``): ``mla`` ``[n_layers, ...]``,
``dense`` ``[first_k_dense, ...]``, ``moe`` ``[n_layers - first_k_dense,
...]`` with the held experts' ``w_gate_up [n, D, 2F]`` and ``w_down [n, F,
D]`` (``n_experts_held`` of them) and the router over all ``n_experts``.  A
stacked leaf is one call, but the routed experts, which are drawn a layer
at a time.  Scales are the port's initialisers': N(0, 0.02) projections,
the output projections (W_o, the dense, routed and shared down projections)
scaled by 1/sqrt(2 n_layers), the router N(0, 0.02) and its correction bias
N(0, 0.01) in float32 (nonzero, so that a router that leaves it out of the
selection chooses other experts and shows), norm scales one.  Token batches
are ``inputs.tokens``'.  This module imports torch alone.
"""

from __future__ import annotations

import math
from typing import Dict

from h100bench.inputs import DTYPES, F32, Maker, generator, tokens  # noqa: F401
from h100bench.nemotron_inputs import BIAS_STD, _per_layer


def _out(w: Dict) -> float:
    return 0.02 / math.sqrt(max(1, 2 * w["n_layers"]))


def mla_layers(mk: Maker, w: Dict, n: int) -> Dict:
    D, H = w["d_model"], w["n_heads"]
    nope, rope, dv = w["qk_nope_dim"], w["qk_rope_dim"], w["v_head_dim"]
    Rq, Rkv = w["q_lora_rank"], w["kv_lora_rank"]
    return {
        "norm": {"scale": mk.full((n, D), 1.0)},
        "q_a": {"w": mk.normal((n, D, Rq), 0.02)},
        "q_norm": {"scale": mk.full((n, Rq), 1.0)},
        "q_b": {"w": mk.normal((n, Rq, H * (nope + rope)), 0.02)},
        "kv_a": {"w": mk.normal((n, D, Rkv + rope), 0.02)},
        "kv_norm": {"scale": mk.full((n, Rkv), 1.0)},
        "kv_b": {"w": mk.normal((n, Rkv, H * (nope + dv)), 0.02)},
        "o": {"w": mk.normal((n, H * dv, D), _out(w))},
    }


def dense_layers(mk: Maker, w: Dict, n: int) -> Dict:
    D, Fd = w["d_model"], w["d_ff"]
    return {
        "norm": {"scale": mk.full((n, D), 1.0)},
        "gate_up": {"w": mk.normal((n, D, 2 * Fd), 0.02)},
        "down": {"w": mk.normal((n, Fd, D), _out(w))},
    }


def moe_layers(mk: Maker, w: Dict, n: int) -> Dict:
    D, E, F, Fs = w["d_model"], w["n_experts"], w["moe_d_ff"], w["moe_shared_d_ff"]
    held = w["n_experts_held"]
    return {
        "norm": {"scale": mk.full((n, D), 1.0)},
        "router": {"w": mk.normal((n, D, E), 0.02, dtype=F32)},
        "e_bias": mk.normal((n, E), BIAS_STD, dtype=F32),
        "w_gate_up": _per_layer(mk, (n, held, D, 2 * F), 0.02),
        "w_down": _per_layer(mk, (n, held, F, D), _out(w)),
        "shared_gate_up": {"w": mk.normal((n, D, 2 * Fs), 0.02)},
        "shared_down": {"w": mk.normal((n, Fs, D), _out(w))},
    }


def weights(w: Dict, seed: int, device) -> Dict:
    """The parameter tree of configuration widths ``w`` for run ``seed``."""
    if w["family"] != "deepseek_v3":
        raise ValueError(f"no deepseek_v3 weights for family {w['family']!r}")
    mk = Maker(generator(seed, 1, device), device, DTYPES[w["dtype"]])
    D, V, L, n_dense = w["d_model"], w["vocab_size"], w["n_layers"], w["first_k_dense"]
    tree = {"embed": {"emb": mk.normal((V, D), 0.02)}, "mla": mla_layers(mk, w, L)}
    if n_dense:
        tree["dense"] = dense_layers(mk, w, n_dense)
    if L > n_dense:
        tree["moe"] = moe_layers(mk, w, L - n_dense)
    tree["final_norm"] = {"scale": mk.full((D,), 1.0)}
    tree["head"] = {"w": mk.normal((D, V), 0.02)}
    return tree
