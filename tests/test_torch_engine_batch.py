"""Batched-trial engine of the torch port: greedy kernels and named gates.

``repro_torch.core.engine_batch.simulate_batch(device="cpu")`` is held
to the JAX package's numpy SoA engine (``repro.core.simulate(
engine="soa")``): every lane's full ``SimResult.fingerprint()`` must be
equal on ``tests/test_engine_batch.py``'s differential grid
(``saturation_3x`` @ ``4k_1ws2os``, 0.12 s, seeds 0-2).  This file holds
the FCFS / EDF / DREAM kernels and every ``BatchUnsupportedError`` gate;
the Terastal kernels and the variant cell are in the sibling files.
"""

import pytest

pytest.importorskip("torch")

import repro.core as R
from repro.costmodel.maestro import PLATFORMS as R_PLATFORMS

import repro_torch.core as P
from repro_torch.core.budget_online import BudgetPolicy
from repro_torch.core.engine_batch import BatchUnsupportedError, simulate_batch
from repro_torch.core.scheduler import Scheduler, TerastalScheduler
from repro_torch.core.simulator import ClosedLoopClients
from repro_torch.costmodel.maestro import PLATFORMS

SEEDS = [0, 1, 2]
DUR = 0.12
CELL, PLATFORM = "saturation_3x", "4k_1ws2os"


def batch_matches_reference_soa(sched_spec, arrival, cell=CELL, platform=PLATFORM,
                                dur=DUR, seeds=SEEDS, **kw):
    """Run the port's batch engine on the host and the JAX package's SoA
    engine per seed; returns the port's results after asserting parity."""
    pp, pt = P.get_scenario(cell).plans(PLATFORMS[platform])
    rp, rt = R.get_scenario(cell).plans(R_PLATFORMS[platform])
    p_procs = r_procs = None
    if arrival is not None:
        p_procs = [t.arrival or P.make_arrival_process(arrival) for t in pt]
        r_procs = [t.arrival or R.make_arrival_process(arrival) for t in rt]
    got = simulate_batch(pp, pt, dur, P.make_scheduler(sched_spec), seeds,
                         processes=p_procs, device="cpu", **kw)
    assert len(got) == len(seeds)
    for s, res in zip(seeds, got):
        want = R.simulate(rp, rt, dur, R.make_scheduler(sched_spec), seed=s,
                          processes=r_procs, engine="soa", **kw).fingerprint()
        assert res.fingerprint() == want, (cell, sched_spec, arrival, s)
    return got


@pytest.mark.parametrize("sched_spec", ["fcfs", "edf", "dream"])
@pytest.mark.parametrize("arrival", ["poisson", "periodic"])
def test_greedy_kernels_match_reference_soa(sched_spec, arrival):
    batch_matches_reference_soa(sched_spec, arrival)


def _cell():
    return P.SATURATION_SCENARIOS[CELL].plans(PLATFORMS[PLATFORM])


def test_unsupported_axes_raise_named_errors():
    """Every axis the reference rejects is rejected here too, with a
    message naming it — never a silent fallback."""
    assert issubclass(BatchUnsupportedError, ValueError)
    plans, tasks = _cell()
    sched = P.make_scheduler("terastal")

    class WeirdScheduler(Scheduler):
        name = "weird"

        def schedule_round(self, *a, **kw):  # pragma: no cover
            raise NotImplementedError

    with pytest.raises(BatchUnsupportedError, match="no kernel for WeirdScheduler"):
        simulate_batch(plans, tasks, DUR, WeirdScheduler(), SEEDS, device="cpu")

    class TweakedTerastal(TerastalScheduler):
        pass

    with pytest.raises(BatchUnsupportedError, match="no kernel"):
        simulate_batch(plans, tasks, DUR, TweakedTerastal(), SEEDS, device="cpu")
    with pytest.raises(BatchUnsupportedError, match="online budget policy"):
        simulate_batch(plans, tasks, DUR, sched, SEEDS, budget_policy="reclaim",
                       device="cpu")
    ticking = BudgetPolicy()
    ticking.tick_interval = 0.02
    with pytest.raises(BatchUnsupportedError, match="tick events"):
        simulate_batch(plans, tasks, DUR, sched, SEEDS, budget_policy=ticking,
                       device="cpu")
    with pytest.raises(BatchUnsupportedError, match="admission policy"):
        simulate_batch(plans, tasks, DUR, sched, SEEDS,
                       admission="shed_early(margin=1.5)", device="cpu")
    closed = ClosedLoopClients(n_users=4, think_time=0.05)
    with pytest.raises(BatchUnsupportedError, match="closed-loop"):
        simulate_batch(plans, tasks, DUR, sched, SEEDS,
                       processes=[closed for _ in tasks], device="cpu")
    dag_plans, dag_tasks = P.get_scenario("dag_moe_4expert").plans(PLATFORMS["6k_1ws2os"])
    with pytest.raises(BatchUnsupportedError, match="does not support DAG plans"):
        simulate_batch(dag_plans, dag_tasks, DUR, sched, SEEDS, device="cpu")


def test_fault_models_raise_until_the_fault_lane_is_ported():
    plans, tasks = _cell()
    sched = P.make_scheduler("terastal")
    resume = "down(acc=0,start=0.01,duration=0.02,interrupted=resume)"
    with pytest.raises(BatchUnsupportedError, match="resume"):
        simulate_batch(plans, tasks, DUR, sched, SEEDS, faults=resume, device="cpu")
    for spec in ("down(acc=0,start=0.01,duration=0.02)",
                 "throttle(acc=1,start=0.0,duration=0.05,factor=2)"):
        with pytest.raises(BatchUnsupportedError, match="fault lane"):
            simulate_batch(plans, tasks, DUR, sched, SEEDS, faults=spec, device="cpu")
        with pytest.raises(BatchUnsupportedError, match="fault lane"):
            P.simulate(plans, tasks, DUR, sched, seed=0, engine="batch", faults=spec,
                       device="cpu")
    # an inactive fault model is the fault-free engine
    got = simulate_batch(plans, tasks, 0.02, sched, [0], faults="none", device="cpu")
    want = P.simulate(plans, tasks, 0.02, sched, seed=0, engine="soa")
    assert got[0].fingerprint() == want.fingerprint()


def test_simulate_dispatch_propagates_named_error():
    plans, tasks = _cell()
    with pytest.raises(BatchUnsupportedError, match="admission policy"):
        P.simulate(plans, tasks, DUR, P.make_scheduler("terastal"), seed=0,
                   engine="batch", admission="shed_early(margin=1.5)", device="cpu")
