"""The port's copies of the numpy modules agree with the JAX package's.

``repro_torch`` keeps its own copies of the JAX package's numpy modules
(cost model, budgets, variants, scheduler, simulator, SoA engine, ...)
so that it never imports the JAX package.  These tests hold the copies
to the originals: every scenario's plans are equal field for field, and
the scalar engines' ``SimResult`` fingerprints are equal on a small grid
that also crosses the budget-policy, admission and fault axes.  The
model configs (``models/config.py``, ``configs/``) are verbatim copies
with only the import paths changed, and every ``CONFIG`` equals the
reference's field for field.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as R
from repro.core.workload import SCENARIO_CATALOGS as R_CATALOGS
from repro.costmodel.maestro import PLATFORMS as R_PLATFORMS

import repro_torch.core as P
from repro_torch.core import engine_soa as P_soa
from repro_torch.core.workload import SCENARIO_CATALOGS as P_CATALOGS
from repro_torch.costmodel.maestro import PLATFORMS as P_PLATFORMS

CELLS = [
    (cat, name, plat)
    for cat, scenarios in R_CATALOGS.items()
    for name, sc in scenarios.items()
    for plat in sc.platform_names
]


def _plans(catalogs, platforms, cat, name, plat):
    return catalogs[cat][name].plans(platforms[plat])


def test_catalogs_are_the_same():
    assert {c: sorted(s) for c, s in P_CATALOGS.items()} == {
        c: sorted(s) for c, s in R_CATALOGS.items()
    }
    assert sorted(P_PLATFORMS) == sorted(R_PLATFORMS)
    assert {"SCENARIOS", "SATURATION_SCENARIOS"} <= {cat for cat, _, _ in CELLS}


@pytest.mark.parametrize("cat,name,plat", CELLS)
def test_plans_equal_the_reference(cat, name, plat):
    rp, rt = _plans(R_CATALOGS, R_PLATFORMS, cat, name, plat)
    pp, pt = _plans(P_CATALOGS, P_PLATFORMS, cat, name, plat)
    assert len(rp) == len(pp) and len(rt) == len(pt)
    for a, b in zip(rp, pp):
        assert a.model.name == b.model.name
        for field in ("lat", "lat_var", "vdl_rel", "remaining_min"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype and np.array_equal(x, y), field
        assert a.theta == b.theta and a.deadline == b.deadline
        assert sorted(a.variants) == sorted(b.variants)
        for l, va in a.variants.items():
            vb = b.variants[l]
            assert (va.gamma, va.direction, va.loss) == (vb.gamma, vb.direction, vb.loss)
            assert np.array_equal(va.latencies, vb.latencies)
        assert (a.dag is None) == (b.dag is None)
    for a, b in zip(rt, pt):
        assert (a.model_idx, a.fps, a.prob) == (b.model_idx, b.fps, b.prob)


GRID = [
    ("saturation_3x", "4k_1ws2os", 0.05, {}),
    ("multicam_heavy", "6k_1ws2os", 0.1, {}),
    ("saturation_3x", "4k_1ws2os", 0.05,
     dict(budget_policy="reclaim", admission="shed_early(margin=1.5)")),
    ("multicam_heavy", "6k_1ws2os", 0.1,
     dict(faults="down(acc=0,start=0.02,duration=0.03)")),
]


@pytest.mark.parametrize("engine", ["soa", "reference"])
@pytest.mark.parametrize("sched", ["fcfs", "edf", "dream", "terastal",
                                   "terastal(backfill_mode=paper)"])
@pytest.mark.parametrize("cell", range(len(GRID)))
def test_scalar_engines_match_the_reference(cell, sched, engine):
    name, plat, dur, kw = GRID[cell]
    rp, rt = R.get_scenario(name).plans(R_PLATFORMS[plat])
    pp, pt = P.get_scenario(name).plans(P_PLATFORMS[plat])
    for seed in (0, 1):
        want = R.simulate(rp, rt, dur, R.make_scheduler(sched), seed=seed,
                          engine=engine, **kw).fingerprint()
        got = P.simulate(pp, pt, dur, P.make_scheduler(sched), seed=seed,
                         engine=engine, **kw).fingerprint()
        assert got == want, (name, sched, engine, seed)


def test_device_round_is_not_ported_yet():
    """round_kernel="jax" names the missing torch round; "auto" is the
    python round and probes nothing."""
    plans, tasks = P.SATURATION_SCENARIOS["saturation_3x"].plans(P_PLATFORMS["4k_1ws2os"])
    sched = P.make_scheduler("terastal")
    with pytest.raises(P_soa.DeviceRoundUnavailableError, match="later slice"):
        P.simulate(plans, tasks, 0.05, sched, seed=0, engine="soa", round_kernel="jax")
    assert issubclass(P_soa.DeviceRoundUnavailableError, ValueError)
    auto = P.simulate(plans, tasks, 0.05, sched, seed=0, engine="soa", round_kernel="auto")
    py = P.simulate(plans, tasks, 0.05, sched, seed=0, engine="soa", round_kernel="python")
    assert auto.fingerprint() == py.fingerprint()


# ------------------------------------------------------ model configs ---

SRC = Path(__file__).resolve().parents[1] / "src"
CONFIG_MODULES = sorted(p.name for p in (SRC / "repro" / "configs").glob("*.py"))


def _as_port(text):
    """The reference source with its import paths moved to the port."""
    return re.sub(r"\brepro\.", "repro_torch.", text)


@pytest.mark.parametrize("rel", ["models/config.py"]
                         + [f"configs/{name}" for name in CONFIG_MODULES])
def test_config_sources_are_verbatim_copies(rel):
    """models/config.py, configs/registry.py, configs/__init__.py and the
    ten config modules: the reference's text with only ``repro.`` ->
    ``repro_torch.``."""
    want = _as_port((SRC / "repro" / rel).read_text())
    assert (SRC / "repro_torch" / rel).read_text() == want


def test_every_config_equals_the_reference():
    from repro.configs import ARCHS as R_ARCHS
    from repro.configs import get_config as r_get_config
    from repro.configs.registry import all_cells as r_all_cells
    from repro.models.model_api import SHAPES as R_SHAPES

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.configs.registry import all_cells
    from repro_torch.models.model_api import SHAPES

    assert len(CONFIG_MODULES) == 12 and len(ARCHS) == 10
    assert ARCHS == R_ARCHS and all_cells() == r_all_cells()
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in R_SHAPES.items()}
    for arch in ARCHS:
        got, want = get_config(arch), r_get_config(arch)
        assert type(got).__module__ == "repro_torch.models.config"
        assert dataclasses.asdict(got) == dataclasses.asdict(want), arch
        assert (got.resolved_head_dim, got.d_inner, got.ssm_nheads) == (
            want.resolved_head_dim, want.d_inner, want.ssm_nheads)
        assert dataclasses.asdict(got.reduced(dtype="float32")) == dataclasses.asdict(
            want.reduced(dtype="float32")), arch
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("llama-0b")
