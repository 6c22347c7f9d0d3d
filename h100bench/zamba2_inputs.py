"""The weights a zamba2 run makes from its seed, in the port's tree.

As ``h100bench/inputs.py`` makes the ssm family's (one ``Maker`` on the
run's device, one large call a stacked leaf, the leaf's serving type), for
the port's zamba2 keys and layouts (``repro_torch.models.zamba2``): the
Mamba blocks ``[n_layers, ...]`` with ``ssm_ngroups`` groups of B and C,
the shared blocks ``[num_mem_blocks, ...]``, each site's adapter and linear
``[n_sites, ...]``.  Scales are the port's initialisers': N(0, 0.02)
projections (the adapters and the site linears too), the output
projections (attention's ``wo``, the MLP's ``w_down``, the Mamba blocks'
``out_proj``) scaled by 1/sqrt(2 n_layers), norm scales one; the Mamba
blocks' other leaves as ``inputs.mamba_blocks`` makes them.  Token batches
are ``inputs.tokens``'.  This module imports torch alone.
"""

from __future__ import annotations

import math
from typing import Dict

from h100bench.inputs import DTYPES, Maker, generator, mamba_blocks, tokens  # noqa: F401


def shared_blocks(mk: Maker, w: Dict, n: int) -> Dict:
    D, F = w["d_model"], w["d_ff"]
    A = w["n_heads"] * w["head_dim"]
    out = 0.02 / math.sqrt(max(1, 2 * w["n_layers"]))
    return {
        "attn_norm": {"scale": mk.full((n, 2 * D), 1.0)},
        "wq": {"w": mk.normal((n, 2 * D, A), 0.02)},
        "wk": {"w": mk.normal((n, 2 * D, A), 0.02)},
        "wv": {"w": mk.normal((n, 2 * D, A), 0.02)},
        "wo": {"w": mk.normal((n, A, D), out)},
        "mlp_norm": {"scale": mk.full((n, D), 1.0)},
        "w_gate_up": {"w": mk.normal((n, D, 2 * F), 0.02)},
        "w_down": {"w": mk.normal((n, F, D), out)},
    }


def weights(w: Dict, seed: int, device) -> Dict:
    """The parameter tree of configuration widths ``w`` for run ``seed``."""
    if w["family"] != "zamba2":
        raise ValueError(f"no zamba2 weights for family {w['family']!r}")
    mk = Maker(generator(seed, 1, device), device, DTYPES[w["dtype"]])
    D, F, r = w["d_model"], w["d_ff"], w["adapter_rank"]
    sites = len(w["hybrid_layer_ids"])
    return {
        "embed": {"emb": mk.normal((w["vocab_size"], D), 0.02)},
        "final_norm": {"scale": mk.full((D,), 1.0)},
        # a block of G groups is inputs' block of one group of G N state channels:
        # the same leaves and widths (in_proj D x (2 Din + 2 G N + H), the conv over
        # Din + 2 G N channels)
        "mamba_blocks": mamba_blocks(mk, dict(w, ssm_state=w["ssm_ngroups"] * w["ssm_state"]),
                                     (w["n_layers"],)),
        "shared": shared_blocks(mk, w, w["num_mem_blocks"]),
        "adapters": {"down": {"w": mk.normal((sites, D, r), 0.02)},
                     "up": {"w": mk.normal((sites, r, 2 * F), 0.02)}},
        "site_linear": {"w": mk.normal((sites, D, D), 0.02)},
    }
