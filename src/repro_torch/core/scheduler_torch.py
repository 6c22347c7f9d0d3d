"""Host-side trial packers for the batched-trial engine (numpy only).

Counterpart of the staging half of ``scheduler_jax`` in the JAX
package: ``bucket_nj``, ``bucket_ev``, ``_trial_buffers`` and
``pack_trials`` are copied verbatim, so the torch engine stages the
same seed-major bucket buffers byte for byte, without the jax import
and the process-wide x64 switch that come with the original module.
The device round (``terastal_round`` with ``pack_view``/``pack_arrays``)
and the fault-epoch packer (``pack_fault_epochs``) are not ported yet.
"""

from __future__ import annotations

import numpy as np

#: smallest NJ bucket; NJ pads up to the next power of two above this.
BUCKET_MIN = 4


def bucket_nj(nj: int) -> int:
    """Pad a ready-queue size to its power-of-two shape bucket."""
    if nj <= BUCKET_MIN:
        return BUCKET_MIN
    return 1 << (nj - 1).bit_length()


# ------------------------------------------- batched trial staging ----

#: persistent seed-major staging buffers for the batched-trial engine
#: (``repro_torch.core.engine_batch``), one set per (B_pad, NR_pad)
#: bucket, so a sweep sees only O(log max_B x log max_NR) distinct
#: shapes.
_TRIAL_BUFFERS: dict = {}


def _trial_buffers(b_pad: int, nr_pad: int):
    key = (b_pad, nr_pad)
    buf = _TRIAL_BUFFERS.get(key)
    if buf is None:
        buf = {
            # +1 sentinel column: the event loop peeks arr_t[ai] with
            # ai == n_ev after the last arrival; the pad is +inf so the
            # peek reads "no more arrivals" without a bounds branch.
            "arr_t": np.full((b_pad, nr_pad + 1), np.inf),
            "arr_m": np.zeros((b_pad, nr_pad), np.int32),
            "dl": np.full((b_pad, nr_pad), np.inf),
            "dl12": np.full((b_pad, nr_pad), np.inf),
            "n_ev": np.zeros(b_pad, np.int32),
        }
        _TRIAL_BUFFERS[key] = buf
    return buf


def bucket_ev(n: int) -> int:
    """Pad an event-horizon length to its shape bucket.

    Finer-grained than ``bucket_nj``: rungs at every power of two AND at
    1.5x the previous one (..., 96, 128, 192, 256, 384, ...).  The batch
    engine's per-iteration cost is linear in the padded horizon, so pow2
    rounding's worst case (~2x dead width just past a boundary) is real
    wall-clock; the extra rungs cap the waste at ~33% for one more
    compile-cache entry per size class."""
    n = max(int(n), BUCKET_MIN)
    p = 1 << (n - 1).bit_length()
    h = (p >> 1) + (p >> 2)      # 1.5 * previous pow2 rung
    return h if n <= h else p


def pack_trials(events: "list[tuple]", deadline_by_model: np.ndarray):
    """Stage B seeds' pre-generated release events into the persistent
    seed-major trial buffers (the batched counterpart of
    :func:`pack_arrays`).

    ``events`` is ``[(times, models)]`` per seed — the output of
    ``workload.batch_release_events`` — and ``deadline_by_model`` maps
    model_idx -> relative deadline.  Both the seed axis and the event
    horizon are padded to pow2 shape buckets (``bucket_nj``), so the
    batch engine's jitted program compiles once per (B, NR) bucket pair;
    pad lanes carry ``n_ev = 0`` (immediately drained) and pad slots
    ``arr_t = +inf`` (never popped).  Absolute deadlines are computed
    here with the same IEEE-f64 adds the reference engine performs per
    request (``now + plan.deadline``; ``dl12 = dl + 1e-12`` mirrors its
    inline miss/drop epsilon), so downstream comparisons are bit-equal.

    Returns ``(buf, b_pad, nr_pad)`` where ``buf`` holds the padded
    numpy arrays (views of the persistent buffers — consume before the
    next call)."""
    B = len(events)
    NR = max((len(t) for t, _ in events), default=0)
    b_pad = bucket_nj(B)
    nr_pad = bucket_ev(max(NR, 1))
    buf = _trial_buffers(b_pad, nr_pad)
    buf["arr_t"][:] = np.inf
    buf["dl"][:] = np.inf
    buf["dl12"][:] = np.inf
    buf["arr_m"][:] = 0
    buf["n_ev"][:] = 0
    for b, (times, models) in enumerate(events):
        n = len(times)
        buf["n_ev"][b] = n
        if not n:
            continue
        buf["arr_t"][b, :n] = times
        buf["arr_m"][b, :n] = models
        dl = times + deadline_by_model[models]
        buf["dl"][b, :n] = dl
        buf["dl12"][b, :n] = dl + 1e-12
    return buf, b_pad, nr_pad
