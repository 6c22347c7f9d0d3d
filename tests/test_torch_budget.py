"""Algorithm 1 on torch equals the numpy reference and the JAX program.

``repro_torch.core.budget_torch`` runs here on the CPU (``device="cpu"``)
against ``budget.distribute_budgets`` / ``tighten_budgets`` (numpy) and
the JAX package's ``budget_jax`` in f64, on the hand instance of
``tests/test_budget.py``, on 200 seeded random instances shaped like its
property test, on every model of every catalog scenario, and in the
batched form over each cell's models padded with phantom layers.
``rho`` and ``feasible`` must be equal; budgets agree to the reference's
own rtol 1e-5 (the totals are summed in another order than numpy's).
The JAX side runs under ``jax.enable_x64(True)`` in a ``with`` block, so
no other test module of this worker sees x64 switched on.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.budget import distribute_budgets, latency_levels, tighten_budgets
from repro_torch.core.budget_torch import (
    distribute_budgets_batch,
    distribute_budgets_torch,
    pack_levels,
)
from repro_torch.core.workload import SCENARIO_CATALOGS
from repro_torch.costmodel.maestro import PLATFORMS

RTOL = 1e-5  # tests/test_budget.py's


def _check(out, ref):
    assert bool(out.feasible) == ref.feasible
    assert out.rho.dtype == torch.int32
    assert out.rho.tolist() == ref.rho.tolist()
    got = out.budgets.numpy()
    if ref.feasible:
        np.testing.assert_allclose(got, ref.budgets, rtol=RTOL)
        np.testing.assert_allclose(out.c_ref.numpy(), ref.c_ref, rtol=0, atol=0)
    else:
        assert not got.any()


def _jax_budgets(packed, R, deadline, rho0=None):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core.budget_jax import distribute_budgets_jax_jit

    with jax.enable_x64(True):
        out = distribute_budgets_jax_jit(
            jnp.asarray(packed, dtype=jnp.float64), jnp.asarray(R), jnp.float64(deadline),
            rho0=None if rho0 is None else jnp.asarray(rho0, dtype=jnp.int32))
        return bool(out.feasible), np.asarray(out.rho).tolist(), np.asarray(out.budgets)


@pytest.mark.parametrize("scale2", [0.5, 1.0, 2.0])
def test_hand_instance_from_rho0(scale2):
    """tests/test_budget.py::test_jax_kernel_matches_reference_from_rho0."""
    lat = np.array([[8.0, 1.0, 4.0], [3.0, 2.0, 2.0], [6.0, 4.0, 1.0], [5.0, 5.0, 5.0]])
    off = distribute_budgets(lat, deadline=14.0)
    deadline2 = 14.0 * scale2
    ref = tighten_budgets(off.levels, deadline2, rho0=off.rho)
    packed, R = pack_levels(lat)
    out = distribute_budgets_torch(packed, R, deadline2, rho0=off.rho, device="cpu")
    _check(out, ref)
    feasible, rho, budgets = _jax_budgets(packed, R, deadline2, off.rho)
    assert (bool(out.feasible), out.rho.tolist()) == (feasible, rho)
    np.testing.assert_allclose(out.budgets.numpy(), budgets, rtol=RTOL)


def _instances(n=200, seed=0):
    """``tests/test_budget.py::_instances`` drawn from a seeded generator:
    1-12 layers, 1-4 accelerators, f32-representable latencies in
    [2^-13, 10], deadline = min-sum x U(0.3, 3) + 1e-6."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        L, n_acc = int(rng.integers(1, 13)), int(rng.integers(1, 5))
        lat = rng.uniform(0.0001220703125, 10.0, (L, n_acc)).astype(np.float32).astype(np.float64)
        if rng.random() < 0.3:  # equal latencies: fewer distinct levels, gap ties
            lat[:, -1] = lat[:, 0]
        deadline = float(lat.min(axis=1).sum() * rng.uniform(0.3, 3.0) + 1e-6)
        yield lat, deadline, float(rng.choice([0.5, 1.0, 2.0]))


def _margin(lat, deadline):
    return abs(lat.min(axis=1).sum() - deadline) / deadline


def test_random_instances_match_numpy_and_jax():
    checked = feasible = 0
    worst = 0.0
    for lat, deadline, scale2 in _instances():
        if _margin(lat, deadline) <= 1e-9:
            continue
        packed, R = pack_levels(lat)
        ref = distribute_budgets(lat, deadline)
        out = distribute_budgets_torch(packed, R, deadline, device="cpu")
        _check(out, ref)
        j_feasible, j_rho, j_budgets = _jax_budgets(packed, R, deadline)
        assert (bool(out.feasible), out.rho.tolist()) == (j_feasible, j_rho)
        np.testing.assert_allclose(out.budgets.numpy(), j_budgets, rtol=RTOL)
        if ref.feasible:
            feasible += 1
            worst = max(worst, float(np.max(np.abs(out.budgets.numpy() - ref.budgets)
                                            / ref.budgets)))
            # incremental re-distribution from the offline levels
            ref2 = tighten_budgets(ref.levels, deadline * scale2, rho0=ref.rho)
            if _margin(lat, deadline * scale2) > 1e-9:
                _check(distribute_budgets_torch(packed, R, deadline * scale2, rho0=ref.rho,
                                                device="cpu"), ref2)
        checked += 1
    assert checked >= 190 and 40 <= feasible < checked
    assert worst < RTOL


CELLS = [(cat, name, plat) for cat, scs in SCENARIO_CATALOGS.items()
         for name, sc in scs.items() for plat in sc.platform_names]


def _cell_models(name, cat, plat):
    plans, _ = SCENARIO_CATALOGS[cat][name].plans(PLATFORMS[plat])
    return [(p.lat, p.deadline) for p in plans]


@pytest.mark.parametrize("cat,name,plat", CELLS)
def test_every_catalog_model_and_the_batched_cell(cat, name, plat):
    models = _cell_models(name, cat, plat)
    refs = [distribute_budgets(lat, dl) for lat, dl in models]
    singles = []
    for (lat, dl), ref in zip(models, refs):
        packed, R = pack_levels(lat)
        out = distribute_budgets_torch(packed, R, dl, device="cpu")
        _check(out, ref)
        singles.append(out)
    # the cell's models in one padded batch: phantom layers repeat a zero level
    M = len(models)
    L = max(lat.shape[0] for lat, _ in models)
    r_max = max(int(pack_levels(lat)[1].max()) for lat, _ in models)
    levels_b = np.zeros((M, L, r_max))
    R_b = np.ones((M, L), np.int32)
    mask_b = np.zeros((M, L), bool)
    for m, (lat, _) in enumerate(models):
        packed, R = pack_levels(lat, r_max)
        n = lat.shape[0]
        levels_b[m, :n], R_b[m, :n], mask_b[m, :n] = packed, R, True
    out = distribute_budgets_batch(levels_b, R_b, np.array([dl for _, dl in models]), mask_b,
                                   device="cpu")
    for m, (single, ref) in enumerate(zip(singles, refs)):
        n = models[m][0].shape[0]
        assert bool(out.feasible[m]) == bool(single.feasible) == ref.feasible
        assert out.rho[m, :n].tolist() == single.rho.tolist() == ref.rho.tolist()
        # the padded total is summed over more terms, so in another order
        np.testing.assert_allclose(out.budgets[m, :n].numpy(), ref.budgets, rtol=RTOL)
        assert not out.budgets[m, n:].any() and not out.rho[m, n:].any()


def test_phantom_layers_and_the_default_mask():
    """A phantom layer is never tightened and gets no budget, whatever its
    levels; no mask means every layer is real."""
    lat = np.array([[4.0, 1.0], [3.0, 2.0], [9.0, 0.5]])
    packed, R = pack_levels(lat)
    ref = distribute_budgets(lat[:2], 3.5)
    out = distribute_budgets_torch(packed, R, 3.5, layer_mask=[True, True, False], device="cpu")
    assert out.rho.tolist()[:2] == ref.rho.tolist() and out.rho.tolist()[2] == 0
    np.testing.assert_allclose(out.budgets.numpy()[:2], ref.budgets, rtol=RTOL)
    assert float(out.budgets[2]) == 0.0 and float(out.c_ref[2]) == 0.0
    _check(distribute_budgets_torch(packed, R, 3.5, device="cpu"), distribute_budgets(lat, 3.5))
    # infeasible: even the fastest levels do not fit
    _check(distribute_budgets_torch(packed, R, 1.0, device="cpu"), distribute_budgets(lat, 1.0))
    assert [latency_levels(r).tolist() for r in lat] == [[4.0, 1.0], [3.0, 2.0], [9.0, 0.5]]


def test_budget_kernel_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    packed, R = pack_levels(np.array([[2.0, 1.0]]))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        distribute_budgets_torch(packed, R, 1.5)


def test_pack_levels_is_the_reference_copy():
    jax = pytest.importorskip("jax")  # noqa: F841
    from repro.core.budget_jax import pack_levels as r_pack_levels

    for lat, _, _ in _instances(50, seed=1):
        for r_max in (None, 1, 2):
            a, b = pack_levels(lat, r_max), r_pack_levels(lat, r_max)
            assert a[0].tobytes() == b[0].tobytes() and a[1].tobytes() == b[1].tobytes()
