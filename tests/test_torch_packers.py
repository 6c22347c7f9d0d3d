"""The port's trial packers stage the reference's buffers byte for byte.

``repro_torch.core.scheduler_torch`` copies ``bucket_nj``, ``bucket_ev``,
``_trial_buffers``, ``pack_trials`` and ``pack_fault_epochs`` out of the
JAX package's ``scheduler_jax``.  Importing that module turns on ``jax_enable_x64`` for
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


FAULT_SCRIPT = r"""
import numpy as np
from repro.core import scheduler_jax as RJ
from repro.core.faults import make_fault_model as r_fault
from repro.core.workload import get_scenario as r_scenario
from repro.costmodel.maestro import PLATFORMS as R_PLATFORMS
from repro_torch.core import scheduler_torch as PT
from repro_torch.core.faults import make_fault_model
from repro_torch.core.workload import get_scenario
from repro_torch.costmodel.maestro import PLATFORMS

assert PT._FAULT_CODES == RJ._FAULT_CODES
# (scenario, platform, fault spec or None for the scenario's own, duration,
# seeds, b_pad): every kind, retighten on and off, pad lanes, NF of 1, 2, 3,
# 6 and the intermittent timelines' own counts (mostly not powers of two)
CASES = [
    ("multicam_heavy", "6k_1ws2os", "down(acc=0,start=0.1,duration=0.2)", 0.35, [0, 1], 4),
    ("multicam_heavy", "6k_1ws2os",
     "down(acc=2,start=0.05,duration=0.1,retighten=true)", 0.3, [0, 1, 2], 8),
    ("multicam_heavy", "6k_1ws2os", "throttle(acc=1,start=0.05,duration=0.3,factor=2.5)",
     0.2, [0, 1], 4),
    ("multicam_heavy", "6k_1ws2os", "permanent(acc=1,start=0.15)", 0.25, [0], 4),
    ("multicam_heavy", "6k_1ws2os", "permanent(acc=0,start=0.1,retighten=true)"
     "+throttle(acc=1,start=0.05,duration=0.1,factor=2)", 0.3, [0, 1], 4),
    ("multicam_heavy", "6k_1ws2os", "intermittent(acc=2,rate=8.0,mean_down=0.05)",
     0.6, list(range(5)), 8),
    ("multicam_heavy", "6k_1ws2os",
     "intermittent(acc=1,rate=10.0,mean_down=0.05,retighten=true)", 0.6, [0, 1, 2], 4),
    ("saturation_3x", "4k_1ws2os", "throttle(acc=0,start=0.01,duration=0.05,factor=3,"
     "retighten=true)", 0.1, [0, 1], 4),
]
for name in ("fault_dropout", "fault_brownout", "fault_flash_crowd"):
    for plat in get_scenario(name).platform_names:
        CASES.append((name, plat, None, 2.0, [0, 1, 2], 4))
checked = 0
nfs = set()
for scen, plat, spec, dur, seeds, b_pad in CASES:
    plans, _ = get_scenario(scen).plans(PLATFORMS[plat])
    r_plans, _ = r_scenario(scen).plans(R_PLATFORMS[plat])
    spec = spec or get_scenario(scen).faults
    lp = max(len(p.model.layers) for p in plans)
    got, g_nf, g_spans = PT.pack_fault_epochs(make_fault_model(spec), plans, dur, seeds,
                                              b_pad, lp)
    want, w_nf, w_spans = RJ.pack_fault_epochs(r_fault(spec), r_plans, dur, seeds, b_pad, lp)
    assert (g_nf, g_spans) == (w_nf, w_spans), (scen, spec)
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = got[k], np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (scen, spec, k)
        assert a.tobytes() == b.tobytes(), (scen, spec, k)
        checked += 1
    nfs.update(int(n) for n in got["n_f"][: len(seeds)])
assert {1, 2, 3, 6} <= nfs and any(n & (n - 1) for n in nfs), nfs
print("OK", checked)
"""


def test_pack_fault_epochs_is_byte_equal_to_the_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", FAULT_SCRIPT], env=env, cwd=str(ROOT),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["OK", str(9 * 14)]


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
