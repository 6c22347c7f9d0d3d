"""Batched-trial engine of the torch port: intermittent fault timelines.

The seed-derived ``intermittent`` renewal process against the JAX
package's numpy SoA engine (harness in ``test_torch_engine_batch_faults.py``):
with ``retighten=true``, whose epochs carry the re-tightened virtual-
deadline chains, and a denser timeline on the accelerator where Terastal
runs variant layers, so that an eviction undoes a variant (its seeds
found by a search over seeds 0-15 at 0.3 s; 4 and 5 undo one each).
"""

import pytest

pytest.importorskip("torch")

from test_torch_engine_batch_faults import fault_case, grid_totals

CASES = [  # (fault spec, duration, scheduler, seeds)
    ("intermittent(acc=1,rate=10.0,mean_down=0.05,retighten=true)", 0.3, "terastal", (0, 1)),
    ("intermittent(acc=1,rate=10.0,mean_down=0.05,retighten=true)", 0.3, "edf", (0, 1)),
    ("intermittent(acc=1,rate=20.0,mean_down=0.02)", 0.2, "terastal", (4, 5)),
]


@pytest.mark.parametrize("spec,dur,sched,seeds", CASES)
def test_intermittent_faults_match_reference_soa(spec, dur, sched, seeds):
    stats = fault_case(spec, dur, sched, seeds)
    assert stats["iterations"] <= stats["max_it"]


def test_an_eviction_undoes_a_variant():
    tot = grid_totals(CASES)
    assert tot["variant_undos"] > 0
    assert tot["evictions"] >= tot["variant_undos"]
    assert tot["faulted_spans"] > 0
