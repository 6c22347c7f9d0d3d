"""Batched-trial engine of the torch port: variant cell and entry points.

* ``multicam_heavy`` @ ``6k_1ws2os`` (the paper's Table-II mix), where
  Terastal applies layer variants: the lanes must apply them and stay
  fingerprint-identical to the JAX package's numpy SoA engine.
* The inert budget axes (explicit static policy, admission "none").
* ``simulate(engine="batch", device="cpu")``, the B = 1 entry point.
"""

import pytest

pytest.importorskip("torch")

import repro.core as R
from repro.costmodel.maestro import PLATFORMS as R_PLATFORMS

import repro_torch.core as P
from repro_torch.costmodel.maestro import PLATFORMS

from test_torch_engine_batch import CELL, DUR, PLATFORM, batch_matches_reference_soa


def test_multicam_variant_cell_matches_reference_soa():
    got = batch_matches_reference_soa("terastal", None, cell="multicam_heavy",
                                      platform="6k_1ws2os", dur=0.25, seeds=[0])
    applied = sum(s.variants_applied for s in got[0].per_model.values())
    assert applied > 0


def test_inert_budget_axes_match_reference_soa():
    batch_matches_reference_soa("terastal", "poisson", seeds=[0, 1],
                                budget_policy="static", admission="none")


def test_simulate_engine_batch_dispatch():
    pp, pt = P.SATURATION_SCENARIOS[CELL].plans(PLATFORMS[PLATFORM])
    rp, rt = R.SATURATION_SCENARIOS[CELL].plans(R_PLATFORMS[PLATFORM])
    got = P.simulate(pp, pt, DUR, P.make_scheduler("terastal"), seed=1,
                     engine="batch", device="cpu")
    want = R.simulate(rp, rt, DUR, R.make_scheduler("terastal"), seed=1, engine="soa")
    assert got.fingerprint() == want.fingerprint()
