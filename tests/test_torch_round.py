"""The port's device Terastal round equals the JAX package's, element for element.

``repro_torch.core.scheduler_torch.terastal_round`` runs here on the CPU
(``device="cpu"``) on two kinds of round state:

* states captured from real saturation trials of the port's SoA engine
  at ready-queue depths either side of the pow2 buckets 16 and 64
  (NJ 15/16/17/63/64/65, the grid of ``tests/test_round_kernels.py``),
  for every backfill mode;
* seeded random states on a dyadic grid (exact ties everywhere), with
  variants, padded slots, busy accelerators and infinite latencies.

The JAX package's ``scheduler_jax.terastal_round`` runs on the same
arrays in a subprocess: importing that module turns on
``jax_enable_x64`` for the whole process, which would leak into other
test files of this worker.  Then the SoA engine with
``round_kernel="jax", device="cpu"`` is held fingerprint-equal to the
Python round on the saturation cells, and the dispatch plumbing
(crossover resolution, "auto" at an infinite crossover) to the
reference's.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import engine_soa, make_scheduler, simulate
from repro_torch.core import scheduler_torch as ST
from repro_torch.core.workload import SATURATION_SCENARIOS
from repro_torch.costmodel.maestro import PLATFORMS

ROOT = Path(__file__).resolve().parents[1]
MODES = ("ef", "paper", "positive")
#: either side of the pow2 shape buckets 16 and 64 (bucket_nj boundaries)
BOUNDARY_NJ = (15, 16, 17, 63, 64, 65)
FIELDS = ST.RoundInputs._fields
#: (NJ_pad, NA) of the random states
RANDOM_SHAPES = ((4, 1), (8, 4), (16, 3), (64, 3))
N_RANDOM = 40  # per shape and mode


def _stage_state(B, now, busy, idle_mask):
    """The engine's ``_jax_round`` staging of a captured block, as numpy."""
    n, n_acc = B.n, len(busy)
    perm = np.argsort(B.rid_arr[:n])
    inp = ST.pack_arrays(
        B.vdl_arr[:n][perm], B.vdl_next_arr[:n][perm], B.next_min_arr[:n][perm],
        B.lat_arr[:, :n].T[perm], B.latv_arr[:, :n].T[perm],
        np.array([b if b > now else now for b in busy]),
        np.array([bool(idle_mask >> k & 1) for k in range(n_acc)]),
        device="cpu",
    )
    return {f: getattr(inp, f).numpy() for f in FIELDS}


def _captured(mode, per_target=2):
    """Round states at the boundary depths, captured from saturation trials
    with the vectorized kernel forced on (so the block keeps its mirrors)."""
    got = {nj: [] for nj in BOUNDARY_NJ}
    orig = engine_soa._kern_terastal_vec

    def capture(B, now, busy, idle_mask, n_idle, kmode):
        if B.n in got and len(got[B.n]) < per_target:
            got[B.n].append(_stage_state(B, now, busy, idle_mask))
        return orig(B, now, busy, idle_mask, n_idle, kmode)

    engine_soa._kern_terastal_vec = capture
    old_env = os.environ.get("REPRO_ROUND_VEC_MIN")
    os.environ["REPRO_ROUND_VEC_MIN"] = "2"
    try:
        for cell in ("saturation_5x", "saturation_3x"):
            if all(len(v) >= per_target for v in got.values()):
                break
            plans, tasks = SATURATION_SCENARIOS[cell].plans(PLATFORMS["4k_1ws2os"])
            simulate(plans, tasks, 1.5, make_scheduler(f"terastal(backfill_mode={mode})"),
                     seed=0, engine="soa", round_kernel="python")
    finally:
        engine_soa._kern_terastal_vec = orig
        if old_env is None:
            del os.environ["REPRO_ROUND_VEC_MIN"]
        else:
            os.environ["REPRO_ROUND_VEC_MIN"] = old_env
    return got


def _random_state(rng, nj_pad, na):
    """A padded round state on a dyadic grid: exact ties in slack, finish
    times and backfill scores; some accelerators unable to run a layer,
    some layers without a variant, some accelerators busy."""
    nj = int(rng.integers(1, nj_pad + 1))
    g = lambda lo, hi, size=None: rng.integers(lo, hi, size) / 256.0  # noqa: E731
    now = 1.0
    lat = g(1, 17, (nj, na))
    lat[rng.random((nj, na)) < 0.1] = np.inf
    lat[np.isinf(lat).all(axis=1), 0] = g(1, 17)
    lat_var = np.where(rng.random((nj, 1)) < 0.5, np.inf, np.maximum(lat - g(0, 8, (nj, na)), 1 / 256))
    vdl = now + g(0, 33, nj)
    state = {
        "ready_mask": np.arange(nj_pad) < nj,
        "vdl": np.zeros(nj_pad), "vdl_next": np.zeros(nj_pad), "next_min": np.zeros(nj_pad),
        "lat": np.full((nj_pad, na), np.inf), "lat_var": np.full((nj_pad, na), np.inf),
        "tau": now + np.where(rng.random(na) < 0.5, 0.0, g(0, 17, na)),
        "idle_mask": rng.random(na) < 0.7,
    }
    state["vdl"][:nj] = vdl
    state["vdl_next"][:nj] = vdl + g(1, 33, nj)
    state["next_min"][:nj] = g(0, 9, nj)
    state["lat"][:nj] = lat
    state["lat_var"][:nj] = lat_var
    return state


def _port_round(state, mode):
    inp = ST.RoundInputs(*(torch.from_numpy(np.array(state[f])) for f in FIELDS))
    out = ST.terastal_round(inp, mode=mode)
    return tuple(t.numpy() for t in out)


JAX_SCRIPT = r"""
import sys
import numpy as np
import jax.numpy as jnp
from repro.core import scheduler_jax as RJ

data = np.load(sys.argv[1], allow_pickle=False)
out = {}
for key in sorted({k.rsplit("/", 1)[0] for k in data.files}):
    mode = key.split("/")[0]
    inp = RJ.RoundInputs(*(jnp.asarray(data[f"{key}/{f}"]) for f in RJ.RoundInputs._fields))
    o = RJ.terastal_round(inp, mode=mode)
    for f in o._fields:
        out[f"{key}/{f}"] = np.asarray(getattr(o, f))
np.savez(sys.argv[2], **out)
print("OK", len(out))
"""


@pytest.fixture(scope="module")
def rounds(tmp_path_factory):
    """{(mode, label): (state, port outputs, reference outputs)}."""
    states = {}
    for mode in MODES:
        for nj, found in _captured(mode).items():
            assert found, f"no round captured at NJ={nj} ({mode})"
            for i, st in enumerate(found):
                states[(mode, f"captured{nj}.{i}")] = st
        rng = np.random.default_rng({"ef": 0, "paper": 1, "positive": 2}[mode])
        for nj_pad, na in RANDOM_SHAPES:
            for i in range(N_RANDOM):
                states[(mode, f"random{nj_pad}x{na}.{i}")] = _random_state(rng, nj_pad, na)
    d = tmp_path_factory.mktemp("rounds")
    np.savez(d / "in.npz", **{f"{m}/{lab}/{f}": st[f] for (m, lab), st in states.items()
                             for f in FIELDS})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(d / "in.npz"),
                           str(d / "out.npz")], env=env, cwd=str(ROOT),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    ref = np.load(d / "out.npz")
    return {(m, lab): (st, _port_round(st, m),
                       tuple(ref[f"{m}/{lab}/{f}"] for f in ST.RoundOutputs._fields))
            for (m, lab), st in states.items()}


def _assert_equal(got, want, what):
    for f, a, b in zip(ST.RoundOutputs._fields, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f, a.dtype, b.dtype)
        assert np.array_equal(a, b), (what, f, a, b)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("nj", BOUNDARY_NJ)
def test_round_equals_the_reference_on_captured_states(rounds, mode, nj):
    hits = [(lab, v) for (m, lab), v in rounds.items()
            if m == mode and lab.startswith(f"captured{nj}.")]
    assert hits
    for lab, (st, got, want) in hits:
        assert int(st["ready_mask"].sum()) == nj
        _assert_equal(got, want, (mode, lab))
        assert got[0].dtype == np.int32 and got[1].dtype == np.bool_ and got[2].dtype == np.int32


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", RANDOM_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_round_equals_the_reference_on_random_states(rounds, mode, shape):
    hits = [(lab, v) for (m, lab), v in rounds.items()
            if m == mode and lab.startswith(f"random{shape[0]}x{shape[1]}.")]
    assert len(hits) == N_RANDOM
    assigned = 0
    for lab, (_, got, want) in hits:
        _assert_equal(got, want, (mode, lab))
        assigned += int((got[0] >= 0).sum())
    assert assigned > 0


def test_random_states_reach_both_stages_and_variants(rounds):
    """The random grid is not vacuous: stage-1 and stage-2 assignments,
    variant assignments and unassigned ready slots all occur."""
    seen = {"stage1": 0, "stage2": 0, "variant": 0, "left": 0}
    for (_, lab), (st, (acc, var, seq), _) in rounds.items():
        nj = st["lat"].shape[0]
        ready = st["ready_mask"]
        seen["stage1"] += int(((acc >= 0) & (seq < nj)).sum())
        seen["stage2"] += int(((acc >= 0) & (seq >= nj) & (seq < nj + st["lat"].shape[1])).sum())
        seen["variant"] += int(var.sum())
        seen["left"] += int((ready & (acc < 0)).sum())
    assert all(v > 0 for v in seen.values()), seen


# ------------------------------------------------------------ the engine ---

ENGINE_GRID = [("saturation_5x", 0.3, mode) for mode in MODES] + [("saturation_3x", 0.1, "ef")]


@pytest.mark.parametrize("cell,dur,mode", ENGINE_GRID)
def test_soa_with_the_device_round_equals_the_python_round(cell, dur, mode, monkeypatch):
    """Every block round on the device round (``round_kernel="jax"``), on
    the host: the trial is fingerprint-identical to the Python rounds, and
    its device rounds cover the NJ buckets the boundary grid names."""
    monkeypatch.delenv("REPRO_ROUND_KERNEL", raising=False)
    plans, tasks = SATURATION_SCENARIOS[cell].plans(PLATFORMS["4k_1ws2os"])
    sched = make_scheduler(f"terastal(backfill_mode={mode})")
    buckets = []
    orig = engine_soa._jax_round

    def counting(B, *args):
        buckets.append(ST.bucket_nj(B.n))
        return orig(B, *args)

    monkeypatch.setattr(engine_soa, "_jax_round", counting)
    dev = simulate(plans, tasks, dur, sched, seed=0, engine="soa", round_kernel="jax",
                   device="cpu")
    py = simulate(plans, tasks, dur, sched, seed=0, engine="soa", round_kernel="python")
    assert dev.fingerprint() == py.fingerprint()
    assert dev.rounds == py.rounds and len(buckets) > 0
    want = {16, 32} | ({64, 128} if cell == "saturation_5x" else set())
    assert want <= set(buckets), sorted(set(buckets))


def test_device_round_raises_without_a_card_unless_told_cpu(monkeypatch):
    """round_kernel="jax" with no device runs on the card: without one it
    raises instead of running on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.delenv("REPRO_ROUND_KERNEL", raising=False)
    plans, tasks = SATURATION_SCENARIOS["saturation_3x"].plans(PLATFORMS["4k_1ws2os"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        simulate(plans, tasks, 0.05, make_scheduler("terastal"), seed=0, engine="soa",
                 round_kernel="jax")


def test_round_crossover_resolution_matches_the_reference(monkeypatch):
    from repro.core import engine_soa as R_soa

    monkeypatch.delenv("REPRO_ROUND_CROSSOVER", raising=False)
    steps = [(None, None), (128, None), (128, "96"), (128, "inf"), (None, "7.5")]
    try:
        for installed, env in steps:
            if env is None:
                monkeypatch.delenv("REPRO_ROUND_CROSSOVER", raising=False)
            else:
                monkeypatch.setenv("REPRO_ROUND_CROSSOVER", env)
            for mod in (engine_soa, R_soa):
                mod.set_round_crossover(installed)
            assert engine_soa.round_crossover() == R_soa.round_crossover(), (installed, env)
        monkeypatch.delenv("REPRO_ROUND_CROSSOVER", raising=False)
        engine_soa.set_round_crossover(None)
        assert engine_soa.round_crossover() == float("inf")  # the default
        engine_soa.set_round_crossover(128)
        assert engine_soa.round_crossover() == 128.0
    finally:
        engine_soa.set_round_crossover(None)
        R_soa.set_round_crossover(None)


def test_auto_at_an_infinite_crossover_never_calls_the_device_round(monkeypatch):
    monkeypatch.delenv("REPRO_ROUND_KERNEL", raising=False)
    monkeypatch.delenv("REPRO_ROUND_CROSSOVER", raising=False)
    engine_soa.set_round_crossover(None)
    plans, tasks = SATURATION_SCENARIOS["saturation_3x"].plans(PLATFORMS["4k_1ws2os"])
    sched = make_scheduler("terastal")
    before = ST.terastal_round.calls
    auto = simulate(plans, tasks, 0.1, sched, seed=0, engine="soa", round_kernel="auto")
    assert ST.terastal_round.calls == before
    monkeypatch.setenv("REPRO_ROUND_CROSSOVER", "inf")
    simulate(plans, tasks, 0.1, sched, seed=0, engine="soa", round_kernel="auto")
    assert ST.terastal_round.calls == before
    py = simulate(plans, tasks, 0.1, sched, seed=0, engine="soa", round_kernel="python")
    assert auto.fingerprint() == py.fingerprint()
    # a finite crossover sends deep rounds of "auto" to the device round
    monkeypatch.setenv("REPRO_ROUND_CROSSOVER", "20")
    deep = simulate(plans, tasks, 0.1, sched, seed=0, engine="soa", round_kernel="auto",
                    device="cpu")
    assert ST.terastal_round.calls > before
    assert deep.fingerprint() == py.fingerprint()


def test_round_kernel_env_reaches_auto_trials(monkeypatch):
    """As in the reference: REPRO_ROUND_KERNEL=jax applies through "auto",
    and an explicit "python" beats it."""
    plans, tasks = SATURATION_SCENARIOS["saturation_3x"].plans(PLATFORMS["4k_1ws2os"])
    monkeypatch.setenv("REPRO_ROUND_KERNEL", "jax")
    before = ST.terastal_round.calls
    simulate(plans, tasks, 0.05, make_scheduler("terastal"), seed=0, engine="soa",
             round_kernel="auto", device="cpu")
    assert ST.terastal_round.calls > before
    before = ST.terastal_round.calls
    simulate(plans, tasks, 0.05, make_scheduler("terastal"), seed=0, engine="soa",
             round_kernel="python", device="cpu")
    assert ST.terastal_round.calls == before
    with pytest.raises(ValueError, match="unknown backfill mode"):
        ST.terastal_round(ST.RoundInputs(*(torch.zeros(1) for _ in FIELDS)), mode="nope")


# ----------------------------------------------------------- pack_view ---


def _view_instance(pkg, rng):
    """A one-model round on a dyadic grid, in ``pkg`` (the port or the
    reference), as ``tests/test_scheduler_jax.py`` draws it."""
    import importlib

    core = importlib.import_module(f"{pkg}.core")
    Request, SchedView = core.Request, core.SchedView
    budget = importlib.import_module(f"{pkg}.core.budget")
    variants = importlib.import_module(f"{pkg}.core.variants")
    zoo = importlib.import_module(f"{pkg}.costmodel.dnn_zoo")
    layers = importlib.import_module(f"{pkg}.costmodel.layers")
    maestro = importlib.import_module(f"{pkg}.costmodel.maestro")

    NA, NJ, n_layers = (int(rng.integers(lo, hi)) for lo, hi in ((1, 5), (1, 9), (1, 5)))
    lat = rng.integers(1, 65, (n_layers, NA)) / 256.0
    plat = maestro.Platform("t", tuple(maestro.Accelerator(f"a{k}", maestro.Dataflow.WS, 1024)
                                       for k in range(NA)))
    deadline = lat.min(axis=1).sum() * int(rng.integers(2, 9))
    plan = variants.ModelPlan(
        model=zoo.DnnModel("m", [layers.matmul(f"l{i}", 8, 8, 8) for i in range(n_layers)],
                           redundancy=0.5),
        platform=plat, deadline=deadline, lat=lat,
        budget=budget.distribute_budgets(lat, deadline), variants={}, theta=0.9)
    now = 1.0
    reqs = []
    for j in range(NJ):
        arr = now - int(rng.integers(0, 65)) / 256.0
        req = Request(rid=j, model_idx=0, arrival=arr, deadline_abs=arr + deadline,
                      next_layer=int(rng.integers(0, n_layers)))
        if rng.random() < 0.5:
            req.vdl_abs = arr + np.cumsum(rng.integers(1, 65, n_layers) / 256.0)
        reqs.append(req)
    busy = np.maximum(np.where(rng.random(NA) < 0.5, now + rng.integers(-32, 33, NA) / 256.0,
                               -1.0), 0.0)
    return SchedView(now=now, ready=reqs, acc_busy_until=busy, plans=[plan]), reqs


def test_pack_view_round_matches_the_python_scheduler():
    """pack_view + the device round (host) assign exactly what the port's
    Python ``TerastalScheduler`` assigns (``tests/test_scheduler_jax.py``'s
    property, on seeded instances)."""
    from repro_torch.core import SchedView, TerastalScheduler

    rng = np.random.default_rng(3)
    assigned = 0
    for _ in range(150):
        view, reqs = _view_instance("repro_torch", rng)
        sched = TerastalScheduler()
        py = {a.req.rid: (a.acc, a.use_variant) for a in sched.schedule(view)}
        view2 = SchedView(now=view.now, ready=list(reqs), acc_busy_until=view.acc_busy_until.copy(),
                          plans=view.plans)
        inp, slots = ST.pack_view(view2, sched, device="cpu")
        out = ST.terastal_round(inp)
        got = {r.rid: (int(out.assign_acc[i]), bool(out.assign_var[i]))
               for i, r in enumerate(slots) if int(out.assign_acc[i]) >= 0}
        assert got == py
        assigned += len(py)
    assert assigned > 100


PACK_SCRIPT = r"""
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import test_torch_round as T
from repro.core import scheduler_jax as RJ
from repro.core.scheduler import TerastalScheduler as RSched
from repro_torch.core.scheduler import TerastalScheduler as PSched

checked = 0
for seed in range(60):
    r_view, _ = T._view_instance("repro", np.random.default_rng(seed))
    p_view, _ = T._view_instance("repro_torch", np.random.default_rng(seed))
    want, _ = RJ.pack_view(r_view, RSched())
    want = {f: np.asarray(getattr(want, f)) for f in RJ.RoundInputs._fields}
    got, _ = T.ST.pack_view(p_view, PSched(), device="cpu")
    for f in T.FIELDS:
        a, b = getattr(got, f).numpy(), want[f]
        assert a.dtype == b.dtype and a.shape == b.shape, (seed, f)
        assert a.tobytes() == b.tobytes(), (seed, f)
        checked += 1
print("OK", checked)
"""


def test_pack_view_stages_the_reference_arrays_byte_for_byte():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", PACK_SCRIPT, str(ROOT / "tests")], env=env,
                          cwd=str(ROOT), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["OK", str(60 * len(FIELDS))]
