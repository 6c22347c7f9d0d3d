"""Per-variant / per-combination accuracy model.

The paper trains each variant on the original dataset (layer swapped in,
all other layers frozen) and measures: individual VGG11 variants lose
7.0%-17.0% (Fig. 3 bottom); architecturally redundant models (ResNet50,
Swin-Tiny, Sp2Dense) stay robust under multiple variants while compact
models degrade quickly (Fig. 4); combination loss compounds with the
specific set of layers modified, not just the count.

Offline in this container (no ImageNet/VOC/KITTI), we use a calibrated
deterministic proxy with exactly those properties:

    delta(layer) = BASE * (1 - redundancy) * (0.55 + 0.9*u) * (1 + 0.35*(gamma-2))

where ``u`` is a per-(model, layer) hash-uniform in [0, 1] — fixed across
runs, varying across layers (Fig. 3's layer-dependence) — clipped to
[0.5%, 25%].  With VGG11's redundancy of 0.35 this spans ~6.8%-16.3% per
individual gamma=2 variant, matching Fig. 3.  Combinations compound
multiplicatively on retained accuracy with a mild interaction exponent:

    retained(V) = prod_i (1 - delta_i) ** INTERACTION

``examples/variant_training.py`` grounds the proxy's shape with a real
S2D/D2S variant trained in JAX on a small CNN.
"""

from __future__ import annotations

import hashlib
from typing import Dict, FrozenSet, Iterable, Mapping

BASE_LOSS = 0.19
INTERACTION = 1.1
MIN_LOSS, MAX_LOSS = 0.005, 0.25


def _hash_uniform(model_name: str, layer_name: str) -> float:
    h = hashlib.sha256(f"{model_name}/{layer_name}".encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


def layer_variant_loss(
    model_name: str, layer_name: str, redundancy: float, gamma: int
) -> float:
    """Relative accuracy loss of swapping in this single variant."""
    u = _hash_uniform(model_name, layer_name)
    delta = BASE_LOSS * (1.0 - redundancy) * (0.55 + 0.9 * u)
    delta *= 1.0 + 0.35 * max(0, gamma - 2)
    return float(min(MAX_LOSS, max(MIN_LOSS, delta)))


def combo_retained_fraction(losses: Iterable[float]) -> float:
    """Retained accuracy fraction (relative to baseline) of a variant set."""
    r = 1.0
    for d in losses:
        r *= (1.0 - d) ** INTERACTION
    return r


def combo_loss(losses: Iterable[float]) -> float:
    return 1.0 - combo_retained_fraction(losses)


def service_quality(miss_rate: float, mean_accuracy_loss: float) -> float:
    """Degraded-mode service quality in [0, 1] for fault-axis reporting.

    The fraction of requests that met their deadline, discounted by the
    mean accuracy retained on completions::

        quality = (1 - miss_rate) * (1 - mean_accuracy_loss)

    This is the graceful-degradation ordering fig10 reports: trading a
    deadline miss (zero utility) for a variant completion (slightly
    reduced accuracy, full timeliness) raises quality, so a scheduler
    that uses the variant lever under faults dominates one that keeps
    nominal accuracy but misses through the outage.  A NaN accuracy
    loss (no variant-bearing model completed anything — see
    ``SimResult.accuracy_loss_stats``) counts as zero loss."""
    loss = mean_accuracy_loss
    if loss != loss:  # NaN
        loss = 0.0
    q = (1.0 - miss_rate) * (1.0 - loss)
    return float(min(1.0, max(0.0, q)))
