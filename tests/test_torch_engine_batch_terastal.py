"""Batched-trial engine of the torch port: the Terastal kernels.

Both backfill modes on ``tests/test_engine_batch.py``'s differential
grid, every lane's fingerprint equal to the JAX package's numpy SoA
engine (see ``test_torch_engine_batch.py`` for the harness).
"""

import pytest

pytest.importorskip("torch")

from test_torch_engine_batch import batch_matches_reference_soa


@pytest.mark.parametrize("sched_spec", [
    "terastal",                        # ef backfill, budgets + variants
    "terastal(backfill_mode=paper)",
])
@pytest.mark.parametrize("arrival", ["poisson", "periodic"])
def test_terastal_kernels_match_reference_soa(sched_spec, arrival):
    batch_matches_reference_soa(sched_spec, arrival)
