"""The port's campaign stack gives the reference's results, field for field.

``repro_torch.core.campaign`` and ``sampling`` are copies of the JAX
package's numpy modules (pinned by ``tests/test_torch_copies.py``); here
they run: ``Campaign.run`` against the reference's on a grid crossing the
four schedulers, two arrival processes and the ``soa`` / ``auto``
engines; ``engine="batch"`` (the port's batched engine, on the host)
against the port's ``soa``; the executor's forked pool against serial;
and the sampler reading back a journal the reference wrote, with no
trial run again.  Every ``TrialResult`` field but ``wall_s`` must be
equal.  Neither package imports jax on these paths.
"""

import dataclasses
import math
import sys

import pytest

torch = pytest.importorskip("torch")

import repro.core as R
from repro.core import sampling as R_sampling

import repro_torch.core as P
from repro_torch.core import campaign as P_campaign
from repro_torch.core import sampling as P_sampling

SCHEDULERS = ("fcfs", "edf", "dream", "terastal")


def _fields(res, drop=("wall_s",)):
    """A TrialResult as plain values, without ``drop`` (spec fields included)."""
    d = dataclasses.asdict(res)
    for k in drop:
        d.pop(k, None)
        d["spec"].pop(k, None)
    return _nan_safe(d)


def _nan_safe(obj):
    """NaN != NaN: map it to a marker so equal results compare equal."""
    if isinstance(obj, float) and math.isnan(obj):
        return "nan"
    if isinstance(obj, dict):
        return {k: _nan_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_nan_safe(v) for v in obj)
    return obj


def _grid(pkg, **kw):
    base = dict(scenarios=("multicam_heavy",), platforms=("6k_1ws2os",),
                schedulers=SCHEDULERS, arrivals=("periodic", "poisson"), seeds=(0, 1),
                duration=0.15)
    base.update(kw)
    return pkg.Campaign(**base)


@pytest.mark.parametrize("engine", ["soa", "auto"])
def test_campaign_equals_the_reference(engine):
    want = _grid(R, engine=engine).run(parallel=False)
    got = _grid(P, engine=engine).run(parallel=False, device="cpu")
    assert len(got.trials) == len(want.trials) == 2 * 2 * len(SCHEDULERS)
    for a, b in zip(got.trials, want.trials):
        assert type(a).__module__ == "repro_torch.core.campaign"
        assert _fields(a) == _fields(b)
    assert got.aggregate() == want.aggregate()
    assert any(t.variants_applied for t in got.trials)


def test_campaign_on_the_saturation_cell_equals_the_reference():
    kw = dict(scenarios=("saturation_5x",), platforms=("4k_1ws2os",), arrivals=("poisson",),
              seeds=(0, 1, 2), duration=0.05)
    want = _grid(R, **kw).run(parallel=False)
    got = _grid(P, **kw).run(parallel=False)  # soa/auto: the device is never needed
    for a, b in zip(got.trials, want.trials):
        assert _fields(a) == _fields(b)


@pytest.mark.parametrize("parallel", [False, True])
def test_batch_engine_campaign_equals_soa(parallel):
    """engine="batch" on the host: through ``run_trial_batch`` (one
    program a seed group) when parallel, through ``run_trial`` (B=1) when
    serial; every field but the engine and ``wall_s`` equals soa's."""
    soa = _grid(P, engine="soa", duration=0.08).run(parallel=False)
    batch = _grid(P, engine="batch", duration=0.08).run(parallel=parallel, max_workers=2,
                                                        device="cpu")
    assert [t.spec.engine for t in batch.trials] == ["batch"] * len(soa.trials)
    for a, b in zip(batch.trials, soa.trials):
        assert _fields(a, drop=("wall_s", "engine")) == _fields(b, drop=("wall_s", "engine"))


def test_batch_engine_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _grid(P, engine="batch", schedulers=("terastal",)).run(parallel=True, max_workers=2)


def test_fault_cell_under_batch_raises():
    """A fault cell of Fig. 10 now runs on the batched engine: the
    ``fault_dropout`` outage opens at 0.5 s, inside the horizon, and every
    field but ``wall_s`` and the engine equals the host ``soa`` grid's,
    the evictions and remaps included (through ``run_trial_batch`` when
    parallel).  Terastal has accelerator 0 idle when it drops on both
    seeds; EDF has a layer in flight there, which is evicted."""
    kw = dict(scenarios=("fault_dropout",), platforms=("6k_1ws2os",),
              schedulers=("terastal", "edf"), seeds=(0, 1), duration=0.55)
    soa = P.Campaign(engine="soa", **kw).run(parallel=False)
    batch = P.Campaign(engine="batch", **kw).run(parallel=True, max_workers=2, device="cpu")
    drop = ("wall_s", "engine")
    assert [_fields(t, drop) for t in batch.trials] == [_fields(t, drop) for t in soa.trials]
    assert [(t.evicted, t.remapped) for t in batch.trials] == [
        (t.evicted, t.remapped) for t in soa.trials]
    assert sum(t.evicted for t in batch.trials) > 0


def test_executor_forked_pool_equals_serial():
    specs = _grid(P, engine="soa", arrivals=("poisson",)).trials()
    serial = [P.run_trial(s, device="cpu") for s in specs]
    with P.TrialExecutor(_grid(P).cell_keys(), parallel=True, max_workers=2,
                         device="cpu") as ex:
        pooled = ex.map(specs, chunksize=2)
        streamed = ex.run_batch(specs)
        assert ex.parallel and ex._pool is not None
        # fork, unless another module of this worker loaded jax (the
        # reference's rule) or CUDA is up (the port's)
        want = "spawn" if "jax" in sys.modules or torch.cuda.is_initialized() else "fork"
        assert ex._pool._mp_context.get_start_method() == want
    for a, b, c in zip(serial, pooled, streamed):
        assert _fields(a) == _fields(b) == _fields(c)
    with P.TrialExecutor(parallel=True, max_workers=2, device="cpu") as ex:
        assert ex.device == "cpu"
        assert [_fields(r) for r in ex.map(specs[:3])] == [_fields(r) for r in serial[:3]]


def test_run_adaptive_reads_back_a_reference_journal(tmp_path, monkeypatch):
    journal = tmp_path / "sampler.jsonl"
    kw = dict(arrivals=("poisson",), seeds=(0, 1, 2, 3), duration=0.1,
              schedulers=("edf", "terastal"))
    cfg = dict(min_seeds=2, round_seeds=1)
    want = R_sampling.run_adaptive(_grid(R, **kw), R.SamplerConfig(**cfg), parallel=False,
                                   journal=str(journal))
    ran = []
    monkeypatch.setattr(P_campaign, "run_trial",
                        lambda spec, device=None: ran.append(spec) or pytest.fail("re-ran"))
    monkeypatch.setattr(P_campaign, "run_trial_batch",
                        lambda specs, device=None: pytest.fail("re-ran a batch"))
    got = P_sampling.run_adaptive(_grid(P, **kw), P.SamplerConfig(**cfg), parallel=False,
                                  journal=str(journal), device="cpu")
    assert not ran
    assert [_fields(t) for t in got.trials] == [_fields(t) for t in want.trials]
    assert [dataclasses.asdict(v) for v in got.verdicts] == [
        dataclasses.asdict(v) for v in want.verdicts]
    assert got.rounds == want.rounds and got.n_trials_cap == want.n_trials_cap


def test_run_adaptive_on_the_batch_engine_equals_soa(tmp_path):
    kw = dict(arrivals=("poisson",), seeds=(0, 1, 2), duration=0.06,
              schedulers=("edf", "terastal"))
    cfg = P.SamplerConfig(min_seeds=2, round_seeds=1)
    soa = P.run_adaptive(_grid(P, engine="soa", **kw), cfg, parallel=False)
    batch = P.run_adaptive(_grid(P, engine="batch", **kw), cfg, parallel=False,
                           journal=str(tmp_path / "j.jsonl"), device="cpu")
    drop = ("wall_s", "engine")
    assert [_fields(t, drop) for t in batch.trials] == [_fields(t, drop) for t in soa.trials]
    # resumed from its own journal: nothing runs again
    again = P.run_adaptive(_grid(P, engine="batch", **kw), cfg, parallel=False,
                           journal=str(tmp_path / "j.jsonl"), device="cpu")
    assert [_fields(t) for t in again.trials] == [_fields(t) for t in batch.trials]


def test_the_port_exports_the_reference_campaign_names():
    names = ["Campaign", "CampaignResult", "DegenerateSampleError", "ExecutorCrashError",
             "TrialExecutor", "TrialResult", "TrialSpec", "bootstrap_ci", "run_trial",
             "AdaptiveResult", "GapVerdict", "SamplerConfig", "SamplerJournal",
             "fixed_grid_verdicts", "gap_separates", "paired_t_pvalue", "run_adaptive"]
    assert set(names) <= set(R.__all__) and set(names) <= set(P.__all__)
    assert set(R.__all__) <= set(P.__all__)
    for n in names:
        assert getattr(P, n).__module__.startswith("repro_torch.core.")
    for cls in ("TrialSpec", "TrialResult", "Campaign", "SamplerConfig"):
        assert [f.name for f in dataclasses.fields(getattr(P, cls))] == [
            f.name for f in dataclasses.fields(getattr(R, cls))]
