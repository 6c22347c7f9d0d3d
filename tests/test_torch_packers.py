"""The port's trial packers stage the reference's buffers byte for byte.

``repro_torch.core.scheduler_torch`` copies ``bucket_nj``, ``bucket_ev``,
``_trial_buffers`` and ``pack_trials`` out of the JAX package's
``scheduler_jax``.  Importing that module turns on ``jax_enable_x64`` for
the whole process, so the comparison runs in a subprocess and leaves
this test worker's jax configuration alone.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import numpy as np
from repro.core import scheduler_jax as RJ
from repro.core.workload import get_scenario as r_scenario
from repro.core.simulator import make_arrival_process as r_arrival
from repro.costmodel.maestro import PLATFORMS as R_PLATFORMS
from repro_torch.core import scheduler_torch as PT
from repro_torch.core.workload import batch_release_events, get_scenario
from repro_torch.core.simulator import make_arrival_process
from repro_torch.costmodel.maestro import PLATFORMS

for n in range(0, 5000):
    assert PT.bucket_ev(n) == RJ.bucket_ev(n), n
    assert PT.bucket_nj(n) == RJ.bucket_nj(n), n
assert PT.BUCKET_MIN == RJ.BUCKET_MIN

checked = 0
for name, plat, dur, arrival, seeds in [
    ("saturation_3x", "4k_1ws2os", 0.12, "poisson", [0, 1, 2]),
    ("saturation_5x", "4k_1ws2os", 0.1, "poisson", list(range(32))),
    ("multicam_heavy", "6k_1ws2os", 0.25, None, list(range(5))),
    ("multicam_heavy", "6k_1ws2os", 0.25, "periodic", [7]),
]:
    plans, tasks = get_scenario(name).plans(PLATFORMS[plat])
    procs = None
    if arrival is not None:
        proc = make_arrival_process(arrival)
        procs = [t.arrival or proc for t in tasks]
    events = batch_release_events(tasks, dur, seeds, procs)
    dl = np.array([p.deadline for p in plans])
    got, gb, gn = PT.pack_trials(events, dl)
    got = {k: v.copy() for k, v in got.items()}
    want, wb, wn = RJ.pack_trials(events, dl)
    assert (gb, gn) == (wb, wn)
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = got[k], np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), (name, k)
        checked += 1
print("OK", checked)
"""


def test_pack_trials_and_buckets_are_byte_equal_to_the_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], env=env, cwd=str(ROOT),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["OK", "20"]


def test_pack_trials_pads_to_buckets():
    """In-process shape pins of the copy (no jax involved)."""
    import numpy as np

    from repro_torch.core.scheduler_torch import bucket_ev, bucket_nj, pack_trials

    assert [bucket_ev(n) for n in (1, 4, 5, 7, 96, 97, 129)] == [4, 4, 6, 8, 96, 128, 192]
    assert [bucket_nj(n) for n in (1, 4, 5, 9)] == [4, 4, 8, 16]
    times = np.array([0.0, 0.01, 0.02])
    models = np.array([0, 1, 0], np.int32)
    buf, b_pad, nr_pad = pack_trials([(times, models), (times[:1], models[:1])],
                                     np.array([0.1, 0.2]))
    assert (b_pad, nr_pad) == (4, 4)
    assert buf["arr_t"].shape == (4, 5) and np.isinf(buf["arr_t"][:, 3:]).all()
    assert list(buf["n_ev"]) == [3, 1, 0, 0]
    assert buf["dl"][0, 1] == 0.01 + 0.2 and buf["dl12"][0, 1] == (0.01 + 0.2) + 1e-12
