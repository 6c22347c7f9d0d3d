"""Batched-trial engine of the torch port: the fault lane.

``repro_torch.core.engine_batch.simulate_batch(device="cpu", faults=...)``
is held to the JAX package's numpy SoA engine (``repro.core.simulate(
engine="soa", faults=...)``) on ``multicam_heavy`` @ ``6k_1ws2os``, the
paper's Table-II mix where Terastal applies layer variants: every lane's
full ``SimResult.fingerprint()``, and its ``evicted`` / ``remapped`` /
``faulted_spans`` named on their own.  Each case's horizon is chosen so
that its fault windows open (and, where the spec closes them, close)
inside it.  An inactive fault model must dispatch exactly the
fault-free ops.  This file holds ``down``, ``throttle`` and ``permanent``;
``test_torch_engine_batch_faults_intermittent.py`` the seed-derived
intermittent timelines, re-tightened chains and a variant undone.
"""

import functools

import pytest

pytest.importorskip("torch")

import repro.core as R
from repro.costmodel.maestro import PLATFORMS as R_PLATFORMS

import repro_torch.core as P
from repro_torch.core.engine_batch import simulate_batch
from repro_torch.costmodel.maestro import PLATFORMS

CELL, PLATFORM = "multicam_heavy", "6k_1ws2os"

CASES = [  # (fault spec, duration, scheduler, seeds)
    ("down(acc=0,start=0.1,duration=0.2)", 0.35, "edf", (0, 1)),
    ("down(acc=0,start=0.1,duration=0.2)", 0.35, "terastal", (0, 1)),
    ("throttle(acc=1,start=0.05,duration=0.3,factor=2.5)", 0.2, "terastal", (0, 1)),
    ("throttle(acc=1,start=0.05,duration=0.3,factor=2.5)", 0.2, "fcfs", (0, 1)),
    ("permanent(acc=1,start=0.15)", 0.25, "dream", (0, 1)),
]


def _per_model(res, field):
    return {m: getattr(s, field) for m, s in res.per_model.items()}


@functools.lru_cache(maxsize=None)
def fault_case(spec, dur, sched, seeds):
    """Run one case on the port's batch engine and the reference's SoA
    engine, assert lane-for-lane parity, and return the engine's stats."""
    pp, pt = P.get_scenario(CELL).plans(PLATFORMS[PLATFORM])
    rp, rt = R.get_scenario(CELL).plans(R_PLATFORMS[PLATFORM])
    stats = {}
    got = simulate_batch(pp, pt, dur, P.make_scheduler(sched), list(seeds), faults=spec,
                         device="cpu", stats=stats)
    assert len(got) == len(seeds)
    spans = []
    for s, res in zip(seeds, got):
        want = R.simulate(rp, rt, dur, R.make_scheduler(sched), seed=s, faults=spec,
                          engine="soa")
        where = (spec, sched, s)
        assert _per_model(res, "evicted") == _per_model(want, "evicted"), where
        assert _per_model(res, "remapped") == _per_model(want, "remapped"), where
        assert res.faulted_spans == want.faulted_spans, where
        assert res.fingerprint() == want.fingerprint(), where
        spans.append(res.faulted_spans)
    return dict(stats, faulted_spans=sum(spans))


def grid_totals(cases):
    """The fault counters summed over ``cases`` (each run once a process)."""
    keys = ("evictions", "retimings", "ghost_pops", "variant_undos", "faulted_spans")
    runs = [fault_case(*c) for c in cases]
    return {k: sum(r[k] for r in runs) for k in keys}


@pytest.mark.parametrize("spec,dur,sched,seeds", CASES)
def test_fault_lane_matches_reference_soa(spec, dur, sched, seeds):
    stats = fault_case(spec, dur, sched, seeds)
    assert stats["iterations"] <= stats["max_it"]


#: ops that only re-view a tensor or wrap a Python scalar: no device kernel
_VIEW_OPS = {"unsqueeze", "select", "slice", "expand", "view", "_unsafe_view", "alias",
             "scalar_tensor", "t", "permute", "detach", "lift_fresh", "squeeze", "reshape",
             "_local_scalar_dense"}


def ops_per_iteration(faults, dur=0.03, seeds=(0, 1)):
    """(the op names ``simulate_batch`` dispatches in order, the ops that
    are not views per loop iteration) for terastal on the Table-II mix."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    pp, pt = P.get_scenario(CELL).plans(PLATFORMS[PLATFORM])
    stats = {}
    with Count() as c:
        simulate_batch(pp, pt, dur, P.make_scheduler("terastal"), list(seeds), faults=faults,
                       device="cpu", stats=stats)
    kernels = sum(n not in _VIEW_OPS for n in c.names)
    return c.names, kernels / stats["iterations"]


def test_fault_lane_is_a_static_branch():
    """An inactive fault model runs exactly the fault-free ops; an active
    one adds the lane's ops to every iteration, whether a fault fires or
    not (388.4 against 590.8 non-view ops an iteration here)."""
    free, free_per_it = ops_per_iteration(None)
    none, _ = ops_per_iteration("none")
    assert none == free
    _, lane_per_it = ops_per_iteration("down(acc=0,start=0.01,duration=0.01)")
    assert 1.3 < lane_per_it / free_per_it < 1.8, (lane_per_it, free_per_it)


def test_fault_lane_evicts_retimes_and_replays_ghosts():
    """Each branch of the lane fires on this grid: a ``down`` or
    ``permanent`` window evicts in-flight layers, a ``throttle`` re-times
    them, and every orphaned finish comes back as a ghost pop."""
    tot = grid_totals(CASES)
    assert tot["evictions"] > 0 and tot["retimings"] > 0
    assert tot["ghost_pops"] == tot["evictions"] + tot["retimings"]
    assert tot["faulted_spans"] > 0
    # fault-free lanes count nothing
    pp, pt = P.get_scenario(CELL).plans(PLATFORMS[PLATFORM])
    stats = {}
    simulate_batch(pp, pt, 0.02, P.make_scheduler("terastal"), [0], faults="none",
                   device="cpu", stats=stats)
    assert [stats[k] for k in ("evictions", "retimings", "ghost_pops", "variant_undos")] == [
        0, 0, 0, 0]
