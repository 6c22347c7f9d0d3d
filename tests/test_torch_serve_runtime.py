"""The port's LM-serving control plane against the JAX package's.

``repro_torch.runtime.serve_runtime`` is a pinned copy of the reference
(``tests/test_torch_copies.py``) whose partitions describe H100 nodes and
whose latency table comes from ``repro_torch.launch.analytics`` on the
H100's constants.  Here:

* the six tests of ``tests/test_serve_runtime.py`` run on the port, with
  its own H100 partitions;
* the differential: with the port's constants and ``default_partitions``
  patched to the reference's values (read from the JAX package at test
  time, so that the port's text never holds them), ``build_serving_plan``
  equals the reference's field for field, and every ``serve_workload``
  fingerprint equals the reference's bit for bit: every scheduler, the
  static / reclaim / adaptive budget policies, ``token_bucket`` admission
  and closed-loop arrivals.
"""

import dataclasses
import enum

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.launch.analytics as r_an
import repro.runtime.serve_runtime as r_sr
from repro.configs import get_config as r_get_config

import repro_torch.launch.analytics as p_an
import repro_torch.runtime.serve_runtime as p_sr
from repro_torch.configs import get_config
from repro_torch.core.scheduler import ALL_SCHEDULERS
from repro_torch.runtime.serve_runtime import (
    MeshPartition,
    ServingModel,
    build_serving_plan,
    decode_chunk_latency,
    default_partitions,
    serve_workload,
)


def _models(get=get_config, sm=ServingModel):
    return [
        sm(get("llama3.2-1b"), tokens_out=32, chunk=16, ctx_len=2048, batch=8, redundancy=0.5),
        sm(get("gemma-7b"), tokens_out=32, chunk=16, ctx_len=4096, batch=8, redundancy=0.7),
    ]


# ------------------------------------------- twins of test_serve_runtime ---


def test_default_partitions_heterogeneous():
    parts = default_partitions()
    assert len(parts) == 3
    assert len({p.n_chips for p in parts}) == 2  # wide + narrow
    # the latency structure is genuinely heterogeneous: per-model preferred
    # partitions differ between a big and a small model
    small, big = _models()[0], _models()[1]
    lat_small = [decode_chunk_latency(small.cfg, p, small.chunk, small.ctx_len, small.batch)
                 for p in parts]
    lat_big = [decode_chunk_latency(big.cfg, p, big.chunk, big.ctx_len, big.batch) for p in parts]
    assert all(l > 0 for l in lat_small + lat_big)
    assert int(np.argmin(lat_small)) != int(np.argmin(lat_big))


def test_build_serving_plan_chunks_and_budgets():
    sm = _models()[0]
    parts = default_partitions()
    plan = build_serving_plan(sm, parts, deadline=1.0)
    assert plan.lat.shape == (sm.tokens_out // sm.chunk, len(parts))
    assert plan.budget.feasible
    np.testing.assert_allclose(plan.budget.budgets.sum(), 1.0, rtol=1e-9)


@pytest.mark.parametrize("name", ALL_SCHEDULERS)
def test_serve_workload_smoke_each_scheduler(name):
    models = _models()
    res = serve_workload(models, rates_fps=[4.0, 2.0], scheduler=name, duration=1.0)
    assert np.isfinite(res.mean_miss_rate)
    assert 0.0 <= res.mean_miss_rate <= 1.0
    assert all(s.released > 0 for s in res.per_model.values())
    u = res.utilization()
    assert (u >= 0).all() and (u <= 1.0 + 1e-9).all()


def test_serve_workload_budget_policy_passthrough():
    models = _models()
    kw = dict(rates_fps=[4.0, 2.0], scheduler="terastal", duration=1.0)
    ref = serve_workload(models, **kw)
    static = serve_workload(models, budget_policy="static", **kw)
    assert static.mean_miss_rate == ref.mean_miss_rate
    assert static.acc_busy_time.tolist() == ref.acc_busy_time.tolist()
    for pol in ("reclaim", "adaptive"):
        res = serve_workload(models, budget_policy=pol, **kw)
        assert np.isfinite(res.mean_miss_rate)
    with pytest.raises(KeyError, match="unknown budget policy"):
        serve_workload(models, budget_policy="slackful", **kw)


def test_serve_workload_length_mismatch_raises():
    models = _models()
    with pytest.raises(ValueError, match="same length"):
        serve_workload(models, rates_fps=[4.0], duration=0.5)
    with pytest.raises(ValueError, match="same length"):
        serve_workload(models[:1], rates_fps=[4.0, 2.0], duration=0.5)


def test_serve_workload_admission_and_closed_loop():
    models = _models()
    kw = dict(rates_fps=[4.0, 2.0], scheduler="terastal", duration=1.0)
    ref = serve_workload(models, **kw)
    none = serve_workload(models, admission="none", **kw)
    assert none.fingerprint() == ref.fingerprint()
    shed = serve_workload(models, admission="token_bucket(rate=2,burst=1)", **kw)
    assert sum(s.shed for s in shed.per_model.values()) > 0
    closed = serve_workload(models, arrival="closed_loop(n_users=3,think_time=0.05)", **kw)
    for s in closed.per_model.values():
        assert s.released == s.completed + s.dropped + s.in_flight
    with pytest.raises(KeyError, match="unknown admission policy"):
        serve_workload(models, admission="bouncer", **kw)


def test_the_h100_partitions_fit_the_mix_and_split_the_preferences():
    """The four-model mix of ``benchmarks/bench_lm_serving.py``: the small
    model prefers a single-node slice, the three big ones the two-node
    slice, and every model's bf16 weights fit the cards of a narrow slice
    (80 GB each)."""
    mix = [("llama3.2-1b", 2048, 8), ("gemma-7b", 4096, 8), ("mistral-nemo-12b", 8192, 8),
           ("qwen3-moe-235b-a22b", 4096, 4)]
    parts = default_partitions()
    assert [p.n_chips for p in parts] == [16, 8, 8]
    best = []
    for arch, ctx, b in mix:
        cfg = get_config(arch)
        lat = [decode_chunk_latency(cfg, p, 16, ctx, b) for p in parts]
        best.append(parts[int(np.argmin(lat))].n_chips)
        assert 2 * p_an.total_params(cfg) < min(p.n_chips for p in parts) * 80e9, arch
    assert best == [8, 16, 16, 16]


def test_one_card_prediction_has_no_collective_term():
    """``MeshPartition("h100", 1, 0.0)``: the chunk is its memory (or
    compute) term alone, 16 tokens of weights and cache over the HBM rate."""
    cfg = get_config("llama3.2-1b")
    got = decode_chunk_latency(cfg, MeshPartition("h100", 1, 0.0), 16, 2048, 8)
    shape = p_an.ShapeSpec("x", 2048, 8, "decode")
    t_mem = (p_an.active_params(cfg) * 2 + p_an.cache_bytes(cfg, shape)) / p_an.HBM_BW
    assert got == 16 * t_mem


# ---------------------------------------------------------- differential ---


@pytest.fixture
def reference_constants(monkeypatch):
    """The port's constants and partitions set to the reference's values
    (``serve_runtime`` binds the constants by ``from ... import``, so they
    are patched in both modules)."""
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        value = getattr(r_an, name)
        monkeypatch.setattr(p_an, name, value)
        monkeypatch.setattr(p_sr, name, value)
    ref_parts = tuple(p_sr.MeshPartition(p.name, p.n_chips, p.collective_overhead_s)
                      for p in r_sr.default_partitions())
    monkeypatch.setattr(p_sr, "default_partitions", lambda: ref_parts)
    return ref_parts


def _same(a, b, where="plan"):
    """Field-for-field equality of a reference object and the port's."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, enum.Enum):
        assert a.name == b.name, where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


@pytest.mark.parametrize("arch,ctx,batch", [("llama3.2-1b", 2048, 8), ("gemma-7b", 4096, 8),
                                            ("qwen3-moe-235b-a22b", 4096, 4),
                                            ("mamba2-1.3b", 2048, 8)])
@pytest.mark.parametrize("deadline", [1.0, 0.05])
def test_plan_equals_the_reference_field_for_field(reference_constants, arch, ctx, batch,
                                                   deadline):
    want = r_sr.build_serving_plan(
        r_sr.ServingModel(r_get_config(arch), tokens_out=64, chunk=16, ctx_len=ctx, batch=batch),
        r_sr.default_partitions(), deadline=deadline)
    got = build_serving_plan(
        ServingModel(get_config(arch), tokens_out=64, chunk=16, ctx_len=ctx, batch=batch),
        p_sr.default_partitions(), deadline=deadline)
    _same(want, got)
    for table in ("lat_var", "min_lat", "remaining_min"):
        _same(getattr(want, table), getattr(got, table), table)


def _both(**kw):
    want = r_sr.serve_workload(_models(r_get_config, r_sr.ServingModel), **kw)
    got = p_sr.serve_workload(_models(), **kw)
    return want, got


@pytest.mark.parametrize("sched", ALL_SCHEDULERS)
@pytest.mark.parametrize("policy", ["static", "reclaim", "adaptive"])
def test_fingerprints_equal_the_reference(reference_constants, sched, policy):
    want, got = _both(rates_fps=[4.0, 2.0], scheduler=sched, duration=1.0,
                      budget_policy=policy)
    assert got.fingerprint() == want.fingerprint()


@pytest.mark.parametrize("kw", [
    dict(admission="token_bucket(rate=2,burst=1)"),
    dict(arrival="closed_loop(n_users=3,think_time=0.05)"),
    dict(seed=3, rates_fps=[6.0, 3.0]),
], ids=["token_bucket", "closed_loop", "seed3"])
def test_admission_and_arrivals_equal_the_reference(reference_constants, kw):
    kw = dict(dict(rates_fps=[4.0, 2.0], scheduler="terastal", duration=1.0), **kw)
    want, got = _both(**kw)
    assert got.fingerprint() == want.fingerprint()
