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

Every copied source is pinned to its original: the reference's text with
``repro.`` -> ``repro_torch.`` and, for the few copies that depart from
it, exactly the departures listed in :data:`DEPARTURES` (each a
replacement of one stretch of the original's text), so an edit anywhere
else in a copy, or a departure that drifts, fails.
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


# ------------------------------------------------------- source pins ---

#: the port's modules that share a name with a module of the JAX package
#: but are ports, not copies (the original imports jax)
PORTS = {"core/engine_batch.py", "launch/dryrun.py", "launch/mesh.py", "launch/serve.py",
         "launch/train.py", "runtime/ft.py"}

#: every departure of a copy from its original (after ``repro.`` ->
#: ``repro_torch.``): ``(original text, the copy's text[, count])``, each
#: original stretch found exactly ``count`` (default 1) times
DEPARTURES = {
    "core/__init__.py": [
        ('"""Terastal core: virtual budgets, layer variants, online scheduling, simulator."""',
         '"""Terastal core (torch port): budgets, variants, scheduling, simulator, batched trials.\n'
         '\n'
         'Exports the reference\'s names, and the port\'s batched-trial engine\n'
         '(``simulate_batch``, ``BatchUnsupportedError``).\n'
         '"""'),
        ("from repro_torch.core.faults import (",
         "from repro_torch.core.engine_batch import BatchUnsupportedError, simulate_batch\n"
         "from repro_torch.core.faults import ("),
        ('    "run_trial",\n',
         '    "run_trial",\n    "BatchUnsupportedError",\n    "simulate_batch",\n'),
    ],
    "core/simulator.py": [
        ('  ``D_m = 1 / fps``.\n"""',
         '  ``D_m = 1 / fps``.\n'
         '\n'
         'Torch port: a copy of the JAX package\'s ``core/simulator.py`` whose\n'
         ':func:`simulate` also takes ``device``, the torch device of the\n'
         'batched engine and of the SoA engine\'s device round.\n'
         '"""'),
        ('    faults: Union["FaultModel", str, None] = None,\n) -> SimResult:',
         '    faults: Union["FaultModel", str, None] = None,\n    device=None,\n) -> SimResult:'),
        ('    vectorized kernels, depth-dispatched), ``"jax"`` (force the jitted\n'
         '    ``scheduler_jax.terastal_round``), or ``"auto"``/``None`` (python\n'
         '    below the calibrated crossover; see ``engine_soa.round_crossover``).\n',
         '    vectorized kernels, depth-dispatched), ``"jax"`` (force the device\n'
         '    round, ``scheduler_torch.terastal_round``), or ``"auto"``/``None``\n'
         '    (python below the calibrated crossover; see\n'
         '    ``engine_soa.round_crossover``).\n'),
        ('    by the reference engine.\n    """',
         '    by the reference engine.\n'
         '\n'
         '    ``device`` is the torch device of ``engine="batch"``\'s trial program\n'
         '    and of the SoA engine\'s device round (``"cuda"`` when None; pass\n'
         '    ``device="cpu"`` to run them on the host).\n'
         '    """'),
        ("            faults=fault_model,\n",
         "            faults=fault_model, device=device,\n"),
        ("                fault_model=fault_model,\n",
         "                fault_model=fault_model, device=device,\n"),
    ],
    "core/engine_soa.py": [
        ('boundary (``tests/test_round_kernels.py``).\n"""',
         'boundary (``tests/test_round_kernels.py``).\n'
         '\n'
         'Torch port: a copy of the JAX package\'s ``core/engine_soa.py`` whose\n'
         'device round is ``scheduler_torch.terastal_round`` (the seam keeps the\n'
         'reference\'s names: :func:`round_crossover`, :func:`set_round_crossover`,\n'
         '``_jax_mod``, ``_jax_round`` and the ``jax_min`` / ``jax_on`` dispatch)\n'
         'and whose :func:`simulate_soa` takes the ``device`` that round runs on.\n'
         '"""'),
        ("* rounds deeper than a calibrated crossover can ride the **jitted\n"
         "  kernel** (``scheduler_jax.terastal_round``): the block mirrors stage\n"
         "  into ``pack_arrays``'s persistent pow2 bucket buffers (batched\n"
         "  host->device copies) and the outputs come back in one device sync,\n"
         "  in the exact reference emission order via ``assign_seq``.  Kernel\n"
         "  choice: ``REPRO_ROUND_KERNEL`` in {python, jax, auto}; \"auto\" uses\n"
         "  the jitted round only above :func:`round_crossover` (env\n"
         "  ``REPRO_ROUND_CROSSOVER``, or set from measurement by\n"
         "  ``benchmarks/bench_scheduler_round.py`` — on CPU-only hosts the\n"
         "  measured crossover is typically infinity and auto == python).\n",
         "* rounds deeper than a calibrated crossover can ride the **device\n"
         "  round** (``scheduler_torch.terastal_round``, the port of the JAX\n"
         "  package's jitted round, whose name ``round_kernel=\"jax\"`` keeps):\n"
         "  the block mirrors stage into ``pack_arrays``'s persistent pow2\n"
         "  bucket buffers (one host->device copy per field, onto the\n"
         "  ``device`` given to :func:`simulate_soa`, the card when None) and\n"
         "  the outputs come back in one device sync, in the exact reference\n"
         "  emission order via ``assign_seq``.  Kernel choice:\n"
         "  ``REPRO_ROUND_KERNEL`` in {python, jax, auto}; \"auto\" uses the\n"
         "  device round only above :func:`round_crossover` (env\n"
         "  ``REPRO_ROUND_CROSSOVER`` or :func:`set_round_crossover`; +inf when\n"
         "  neither is set, and then auto == python).\n"),
        ('#: depth-dispatched), "jax" (force the jitted ``terastal_round`` for\n'
         '#: every block round), "auto" (python below :func:`round_crossover`,\n'
         '#: jitted above).  Per-trial override: ``simulate(round_kernel=...)`` /\n'
         '#: ``TrialSpec.round_kernel``; process-wide: ``REPRO_ROUND_KERNEL``.',
         '#: depth-dispatched), "jax" (force the device round,\n'
         '#: ``scheduler_torch.terastal_round``, for every block round), "auto"\n'
         '#: (python below :func:`round_crossover`, the device round above).\n'
         '#: Per-trial override: ``simulate(round_kernel=...)`` /\n'
         '#: ``TrialSpec.round_kernel``; process-wide: ``REPRO_ROUND_KERNEL``.'),
        ('    """NJ above which ``REPRO_ROUND_KERNEL=auto`` rides the jitted round.\n'
         '\n'
         '    Resolution order: ``REPRO_ROUND_CROSSOVER`` env (a number, or\n'
         '    ``inf``), else the value installed by :func:`set_round_crossover`\n'
         '    (``benchmarks/bench_scheduler_round.py`` measures and installs it at\n'
         '    benchmark-smoke time), else +inf — the honest default for CPU-only\n'
         '    hosts, where per-round dispatch overhead keeps the jitted kernel\n'
         '    behind the vectorized Python round at every measured depth.\n'
         '\n'
         '    When the resolved value is INF, ``simulate_soa`` drops the jax\n'
         '    branch from its per-round dispatch entirely (``jax_on`` below):\n'
         '    ``auto`` is then end-to-end identical to ``round_kernel="python"``\n'
         '    and never imports ``scheduler_jax`` (pinned by\n'
         '    ``tests/test_round_kernels.py::test_auto_inf_crossover_is_python``)."""',
         '    """NJ above which ``REPRO_ROUND_KERNEL=auto`` rides the device round.\n'
         '\n'
         '    Resolution order: ``REPRO_ROUND_CROSSOVER`` env (a number, or\n'
         '    ``inf``), else the value installed by :func:`set_round_crossover`,\n'
         '    else +inf: no crossover is installed by default, so "auto" stays on\n'
         '    the Python round.\n'
         '\n'
         '    When the resolved value is INF, ``simulate_soa`` drops the device\n'
         '    branch from its per-round dispatch entirely (``jax_on`` below):\n'
         '    ``auto`` is then end-to-end identical to ``round_kernel="python"``\n'
         '    and never calls the device round (pinned by\n'
         '    ``tests/test_torch_round.py``)."""'),
        ("_SJ = None  # lazily imported repro_torch.core.scheduler_jax (pulls in jax)\n"
         "\n"
         "\n"
         "def _jax_mod():\n"
         '    """Lazy scheduler_jax import.  NOTE: importing it enables jax x64\n'
         "    process-wide (bit-parity with the f64 Python kernels requires it),\n"
         "    so the first jitted round in a process changes the default dtype of\n"
         "    any *later-created* default-dtype jax arrays.  In-repo jax code is\n"
         "    dtype-explicit (pinned by running the suite under JAX_ENABLE_X64=1);\n"
         "    embedders mixing this engine with dtype-implicit jax code should\n"
         '    import scheduler_jax up front rather than mid-run."""\n'
         "    global _SJ\n"
         "    if _SJ is None:\n"
         "        from repro_torch.core import scheduler_jax\n"
         "\n"
         "        _SJ = scheduler_jax\n",
         "_SJ = None  # lazily imported repro_torch.core.scheduler_torch (the device round)\n"
         "\n"
         "\n"
         "def _jax_mod():\n"
         '    """Lazy import of the device round\'s module, ``scheduler_torch``."""\n'
         "    global _SJ\n"
         "    if _SJ is None:\n"
         "        from repro_torch.core import scheduler_torch\n"
         "\n"
         "        _SJ = scheduler_torch\n"),
        ("def _jax_round(B, now, busy, idle_mask, n_acc, mode):\n"
         '    """One Terastal round on the jitted kernel (``REPRO_ROUND_KERNEL=jax``\n'
         "    or NJ past the calibrated crossover): stage the deep mirrors into\n"
         "    ``pack_arrays``'s persistent bucket buffers in ascending-rid order\n"
         "    (stable argsort ties == (slack, rid)), run ``terastal_round``, and\n"
         "    fetch all three outputs in one device sync.",
         "def _jax_round(B, now, busy, idle_mask, n_acc, mode, device=None):\n"
         '    """One Terastal round on the device (``REPRO_ROUND_KERNEL=jax`` or\n'
         "    NJ past the calibrated crossover), on ``device`` (the card when\n"
         "    None): stage the deep mirrors into ``pack_arrays``'s persistent\n"
         "    bucket buffers in ascending-rid order (stable argsort ties ==\n"
         "    (slack, rid)), run ``terastal_round``, and fetch all three outputs\n"
         "    in one device sync."),
        ("        tau,\n        idle,\n    )\n"
         "    o = SJ.terastal_round(inp, mode=mode)\n"
         "    acc, var, seq = SJ.jax.device_get((o.assign_acc, o.assign_var, o.assign_seq))\n",
         "        tau,\n        idle,\n        device=device,\n    )\n"
         "    o = SJ.terastal_round(inp, mode=mode)\n"
         "    acc, var, seq = SJ.device_get(o)\n"),
        ("    fault_model: Optional[FaultModel] = None,\n) -> SimResult:\n",
         "    fault_model: Optional[FaultModel] = None,\n    device=None,\n) -> SimResult:\n"),
        ("    ``REPRO_ROUND_KERNEL`` environment variable, then ``\"auto\"``.\n",
         "    ``REPRO_ROUND_KERNEL`` environment variable, then ``\"auto\"``.\n"
         "    ``device`` is where the device round runs (the card when None;\n"
         "    ``device=\"cpu\"`` runs it on the host).\n"),
        ("_jax_round(B, now, busy, idle_mask, n_acc, mode)\n",
         "_jax_round(B, now, busy, idle_mask, n_acc, mode, device)\n"),
    ],
    "core/campaign.py": [
        ('bit-for-bit — pinned by ``tests/test_campaign.py``.\n"""',
         'bit-for-bit — pinned by ``tests/test_campaign.py``.\n'
         '\n'
         'Torch port: a copy of the JAX package\'s ``core/campaign.py`` with the\n'
         'import paths moved to ``repro_torch`` (so :func:`run_trial_batch` runs\n'
         'the port\'s batched engine).  It departs in two places only: a\n'
         '``device`` keyword on :func:`run_trial`, :func:`run_trial_batch`,\n'
         ':class:`TrialExecutor` and :meth:`Campaign.run`, handed to\n'
         '``simulate`` / ``simulate_batch`` and to pool workers (the card when\n'
         'None; specs and results stay the reference\'s, field for field), and\n'
         'the pool spawns instead of forking once this process has initialised\n'
         'CUDA.\n'
         '"""'),
        ("def run_trial(spec: TrialSpec) -> TrialResult:",
         "def run_trial(spec: TrialSpec, device=None) -> TrialResult:"),
        ("        faults=_resolve_faults(spec),\n    )\n",
         "        faults=_resolve_faults(spec),\n        device=device,\n    )\n"),
        ("def run_trial_batch(specs: Sequence[TrialSpec]) -> List[TrialResult]:",
         "def run_trial_batch(specs: Sequence[TrialSpec], device=None) -> List[TrialResult]:"),
        ("        faults=_resolve_faults(base),\n    )\n",
         "        faults=_resolve_faults(base),\n        device=device,\n    )\n"),
        ('    __slots__ = ("_spec",)\n'
         "\n"
         "    def __init__(self, spec: TrialSpec):\n"
         "        self._spec = spec\n"
         "\n"
         "    def result(self) -> TrialResult:\n"
         "        return run_trial(self._spec)\n",
         '    __slots__ = ("_spec", "_device")\n'
         "\n"
         "    def __init__(self, spec: TrialSpec, device=None):\n"
         "        self._spec = spec\n"
         "        self._device = device\n"
         "\n"
         "    def result(self) -> TrialResult:\n"
         "        return run_trial(self._spec, self._device)\n"),
        ("        max_workers: Optional[int] = None,\n"
         "    ):\n"
         "        self.cell_keys = list(cell_keys)\n",
         "        max_workers: Optional[int] = None,\n"
         "        device=None,\n"
         "    ):\n"
         "        self.cell_keys = list(cell_keys)\n"
         "        self.device = device\n"),
        ("            # loads can deadlock — fall back to spawn when jax is\n"
         "            # already in-process.\n"
         "            methods = multiprocessing.get_all_start_methods()\n"
         '            method = "fork" if ("fork" in methods and "jax" not in sys.modules) else "spawn"\n',
         "            # loads can deadlock — fall back to spawn when jax is\n"
         "            # already in-process; so does a process that has\n"
         "            # initialised CUDA (torch is read only if already loaded).\n"
         "            methods = multiprocessing.get_all_start_methods()\n"
         '            torch_mod = sys.modules.get("torch")\n'
         "            cuda_up = torch_mod is not None and torch_mod.cuda.is_initialized()\n"
         '            method = ("fork" if ("fork" in methods and "jax" not in sys.modules\n'
         '                                 and not cuda_up) else "spawn")\n'),
        ("pool.submit(run_trial, spec)", "pool.submit(run_trial, spec, self.device)", 2),
        ("        return _ImmediateFuture(spec)\n",
         "        return _ImmediateFuture(spec, self.device)\n"),
        ("run_trial_batch([specs[i] for i in idxs])",
         "run_trial_batch([specs[i] for i in idxs], self.device)"),
        ("                    res = run_trial(specs[i])\n",
         "                    res = run_trial(specs[i], self.device)\n"),
        ("                return list(pool.map(run_trial, specs, chunksize=chunksize))\n",
         "                return list(pool.map(run_trial, specs, [self.device] * len(specs),\n"
         "                                     chunksize=chunksize))\n"),
        ("        return [run_trial(s) for s in specs]\n",
         "        return [run_trial(s, self.device) for s in specs]\n"),
        ("        chunksize: Optional[int] = None,\n    ) -> CampaignResult:\n",
         "        chunksize: Optional[int] = None,\n        device=None,\n    ) -> CampaignResult:\n"),
        ('        (per-trial PRNG streams depend only on the spec)."""\n',
         "        (per-trial PRNG streams depend only on the spec).  ``device`` is\n"
         '        where the trials\' device work runs (the card when None)."""\n'),
        ("            return CampaignResult([run_trial(s) for s in specs])\n",
         "            return CampaignResult([run_trial(s, device) for s in specs])\n"),
        ("            self.cell_keys(), parallel=True, max_workers=n_workers\n",
         "            self.cell_keys(), parallel=True, max_workers=n_workers, device=device\n"),
    ],
    "core/sampling.py": [
        ('  pure functions of their specs.\n"""',
         '  pure functions of their specs.\n'
         '\n'
         'Torch port: a copy of the JAX package\'s ``core/sampling.py`` whose\n'
         ':func:`run_adaptive` also takes ``device`` and hands it to its\n'
         ':class:`TrialExecutor`.\n'
         '"""'),
        ("    journal: Optional[str] = None,\n) -> AdaptiveResult:\n",
         "    journal: Optional[str] = None,\n    device=None,\n) -> AdaptiveResult:\n"),
        ("    reproduces it trial-for-trial).\"\"\"\n",
         "    reproduces it trial-for-trial).  ``device`` goes to every trial (the\n"
         "    card when None).\"\"\"\n"),
        ("            campaign.cell_keys(), parallel=parallel, max_workers=max_workers\n",
         "            campaign.cell_keys(), parallel=parallel, max_workers=max_workers,\n"
         "            device=device,\n"),
    ],
    "launch/analytics.py": [
        ('small UNROLLED configs where XLA counts are exact.\n'
         '\n'
         'Hardware constants (TPU v5e targets, per the assignment):\n'
         '  197 TFLOP/s bf16 / chip, 819 GB/s HBM / chip, ~50 GB/s/link ICI.\n'
         '"""',
         'small UNROLLED configs where XLA counts are exact.\n'
         '\n'
         "Torch port: a copy of the JAX package's ``launch/analytics.py`` whose\n"
         'hardware constants describe the NVIDIA H100 SXM (NVIDIA, "H100 Tensor\n'
         'Core GPU" data sheet): 989 TFLOP/s dense bf16 a card, 3.35 TB/s HBM3 a\n'
         'card, and NVLink 4 at 25 GB/s a link in each direction (18 links a\n'
         "card).  The counting functions are the reference's, unchanged.  The\n"
         "port's dry run (``repro_torch.launch.dryrun``) counts FLOPs with\n"
         '``torch.utils.flop_counter.FlopCounterMode``, which sees every layer of\n'
         "the port's Python loop, so there the closed-form count is checked\n"
         'against an exact one.\n'
         '"""'),
        ('PEAK_FLOPS = 197e12  # bf16 per chip\n'
         'HBM_BW = 819e9  # bytes/s per chip\n'
         'ICI_BW = 50e9  # bytes/s per link\n',
         '# H100 SXM, NVIDIA "H100 Tensor Core GPU" data sheet\n'
         'PEAK_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s per card\n'
         'HBM_BW = 3.35e12  # HBM3 bytes/s per card\n'
         'ICI_BW = 25e9  # NVLink 4 bytes/s per link, each direction (50 GB/s both ways)\n'),
    ],
    "runtime/serve_runtime.py": [
        ('"""Terastal as a first-class LM serving controller.\n'
         '\n'
         "Maps the paper's abstractions onto a TPU pod (DESIGN.md §3):\n"
         '\n'
         '* **Heterogeneous accelerators**  -> mesh *partitions* of different TP\n'
         '  width (e.g. one tp=16 slice + two tp=4 slices carved from a pod).  A\n'
         '  wide slice is the "preferred accelerator" for big-model decode steps\n'
         '  (more FLOPs/HBM per step) while narrow slices serve small models with\n'
         '  less collective overhead — the same preferred/non-preferred latency\n'
         '  structure Terastal exploits, with per-(model, partition) step\n'
         '  latencies derived from the analytic roofline\n'
         '  (``repro_torch.launch.analytics``).\n'
         '* **Layers** -> token *chunks*: generating T tokens is a chain of T/K\n'
         '  non-preemptive chunk jobs, schedulable on different partitions at\n'
         '  chunk boundaries (KV migration rides the shared pod interconnect; its\n'
         '  cost is charged into the latency table).\n'
         '* **Layer variants** -> shape-preserving reduced blocks (d_ff / gamma^2)\n'
         '  with latency scaled by the active-FLOP ratio and accuracy loss from\n'
         "  the calibrated proxy — exactly the paper's variant trade, generalized\n"
         '  to transformer blocks.\n'
         '\n'
         'Offline: Algorithm 1 decomposes each request deadline into chunk\n'
         'budgets and selects which models get block variants.  Online:\n'
         'Algorithm 2 (the *same* scheduler class as the faithful reproduction)\n'
         'maps chunk jobs to partitions.  The event-driven simulator provides the\n'
         'serving-loop clock, so FCFS/EDF/DREAM/Terastal are directly comparable\n'
         'on LM traffic (see examples/lm_serve_terastal.py and benchmarks).\n'
         '"""',
         '"""Terastal as a first-class LM serving controller.\n'
         '\n'
         "Torch port: a copy of the JAX package's ``runtime/serve_runtime.py``\n"
         "that maps the paper's abstractions onto NVIDIA H100 cards:\n"
         '\n'
         '* **Heterogeneous accelerators**  -> *partitions* of H100s of different\n'
         '  width (one 16-card slice across two 8-card HGX H100 nodes, two\n'
         '  single-node 8-card NVLink slices: :func:`default_partitions`).  The\n'
         '  wide slice is the "preferred accelerator" for big-model decode steps\n'
         '  (more FLOPs/HBM per step) while the narrow slices serve small models\n'
         '  with less collective overhead — the same preferred/non-preferred\n'
         '  latency structure Terastal exploits, with per-(model, partition) step\n'
         "  latencies derived from the analytic roofline on the H100's constants\n"
         '  (``repro_torch.launch.analytics``).\n'
         '* **Layers** -> token *chunks*: generating T tokens is a chain of T/K\n'
         '  non-preemptive chunk jobs, schedulable on different partitions at\n'
         '  chunk boundaries (KV migration rides the interconnect; its cost is\n'
         '  charged into the latency table).\n'
         '* **Layer variants** -> shape-preserving reduced blocks (d_ff / gamma^2)\n'
         '  with latency scaled by the active-FLOP ratio and accuracy loss from\n'
         "  the calibrated proxy — exactly the paper's variant trade, generalized\n"
         '  to transformer blocks.\n'
         '\n'
         'Offline: Algorithm 1 decomposes each request deadline into chunk\n'
         'budgets and selects which models get block variants.  Online:\n'
         'Algorithm 2 (the *same* scheduler class as the faithful reproduction)\n'
         'maps chunk jobs to partitions.  The event-driven simulator provides the\n'
         'serving-loop clock, so FCFS/EDF/DREAM/Terastal are directly comparable\n'
         'on LM traffic.  ``MeshPartition.n_chips`` counts cards here.\n'
         '"""'),
        ('def default_partitions() -> Tuple[MeshPartition, ...]:\n'
         '    """One 16x16 pod carved into 1 wide + 2 narrow serving slices.\n'
         '\n'
         '    The width spread is deliberately large (192 / 32 / 32): big-model\n'
         '    chunks are ~2x slower on narrow slices (HBM-bound weight streaming)\n'
         '    while small-model chunks are ~2x slower on the wide slice\n'
         '    (collective-overhead-bound) — the skewed preferred/non-preferred\n'
         '    structure the paper\'s scheduling targets."""\n'
         '    return (\n'
         '        MeshPartition("wide_tp192", 192, collective_overhead_s=8e-5),\n'
         '        MeshPartition("narrow_tp32a", 32, collective_overhead_s=3e-5),\n'
         '        MeshPartition("narrow_tp32b", 32, collective_overhead_s=3e-5),\n'
         '    )\n',
         'def default_partitions() -> Tuple[MeshPartition, ...]:\n'
         '    """Four 8-card HGX H100 nodes carved into 1 wide + 2 narrow serving\n'
         '    slices: one 16-card slice across two nodes and two single-node\n'
         '    8-card NVLink slices.\n'
         '\n'
         '    Big-model chunks are ~2x slower on a narrow slice (HBM-bound weight\n'
         '    streaming) while small-model chunks are slower on the wide slice,\n'
         "    whose collectives cross the nodes' network — the skewed\n"
         "    preferred/non-preferred structure the paper's scheduling targets.\n"
         '    Each ``collective_overhead_s`` (seconds a log2 step of a decode\n'
         "    step's collectives) is a modelling assumption, not measured: 5 us\n"
         '    inside one node\'s NVLink switch, 30 us across two nodes."""\n'
         '    return (\n'
         '        MeshPartition("wide_2node_16", 16, collective_overhead_s=3e-5),\n'
         '        MeshPartition("node_8a", 8, collective_overhead_s=5e-6),\n'
         '        MeshPartition("node_8b", 8, collective_overhead_s=5e-6),\n'
         '    )\n'),
    ],
    "launch/roofline.py": [
        ('"""Roofline report: per (arch x shape) three-term analysis.\n'
         '\n'
         'Sources:\n'
         " * analytic terms from ``repro_torch.launch.analytics`` (primary — XLA's\n"
         '   cost_analysis counts scan bodies once, verified in\n'
         '   tests/test_roofline.py, so raw dry-run FLOPs under-report scanned\n'
         '   depth; the analytic counts are validated against published parameter\n'
         '   totals and against cost_analysis on unrolled reduced configs);\n'
         ' * raw dry-run numbers from results/dryrun_all.jsonl (memory fit proof +\n'
         '   collective mix).\n'
         '\n'
         'Usage:\n'
         '    PYTHONPATH=src python -m repro_torch.launch.roofline --dryrun results/dryrun_all.jsonl\n'
         '"""',
         '"""Roofline report: per (arch x shape) three-term analysis.\n'
         '\n'
         "Torch port: a copy of the JAX package's ``launch/roofline.py`` on the\n"
         'H100 constants of ``repro_torch.launch.analytics``.  Sources:\n'
         ' * analytic terms from ``repro_torch.launch.analytics`` (primary; the\n'
         '   counts are validated against published parameter totals and, in\n'
         '   ``tests/test_torch_dryrun.py``, against an exact FLOP count of a\n'
         '   reduced config);\n'
         " * the port's dry-run reports (``python -m repro_torch.launch.dryrun\n"
         '   --all --out results/dryrun_all.jsonl``): per-device argument bytes\n'
         '   under the fitted spec trees, and the analytic collective estimate.\n'
         '\n'
         'Usage:\n'
         '    PYTHONPATH=src python -m repro_torch.launch.roofline --dryrun results/dryrun_all.jsonl\n'
         '"""'),
        ('def cost_analysis_dict(compiled) -> Dict:\n'
         '    """Normalize ``compiled.cost_analysis()`` across JAX versions.\n'
         '\n'
         '    Older JAX returns one dict; newer versions return a list with one\n'
         '    entry per compiled module (the main module first).  Always hand back\n'
         '    a plain dict so callers can ``.get("flops")`` either way.\n'
         '    """\n'
         '    cost = compiled.cost_analysis()\n'
         '    if isinstance(cost, (list, tuple)):\n'
         '        cost = cost[0] if cost else {}\n'
         '    return dict(cost)\n',
         'def cost_analysis_dict(counted) -> Dict:\n'
         '    """The dry run\'s count as the reference\'s ``cost_analysis()`` dict.\n'
         '\n'
         '    ``counted`` is a ``torch.utils.flop_counter.FlopCounterMode`` that\n'
         '    ran the step, or a report of ``repro_torch.launch.dryrun.run_cell``;\n'
         '    either way a plain dict with ``"flops"`` comes back, so callers can\n'
         '    ``.get("flops")`` as they do on the reference\'s."""\n'
         '    if hasattr(counted, "get_total_flops"):\n'
         '        return {"flops": float(counted.get_total_flops())}\n'
         '    return {"flops": float(counted["flops"])}\n'),
        ('def load_dryrun(path: Optional[str]) -> Dict:\n'
         '    if not path:\n'
         '        return {}\n'
         '    out = {}\n'
         '    try:\n'
         '        for line in open(path):\n'
         '            r = json.loads(line)\n'
         '            if r.get("ok"):\n'
         '                out[(r["arch"], r["shape"], r["mesh"])] = r\n'
         '    except FileNotFoundError:\n'
         '        pass\n'
         '    return out\n',
         'def load_dryrun(path: Optional[str]) -> Dict:\n'
         '    """The port\'s dry-run reports by (arch, shape, mesh), each also under\n'
         '    the keys ``build_table`` reads: ``memory.argument_bytes`` (per device\n'
         "    under the fitted spec trees on the report's layout) and\n"
         '    ``collective_bytes_per_device.total`` (``collective_bytes_est``, an\n'
         '    estimate: one card runs no collective)."""\n'
         '    if not path:\n'
         '        return {}\n'
         '    out = {}\n'
         '    try:\n'
         '        for line in open(path):\n'
         '            r = json.loads(line)\n'
         '            if r.get("ok"):\n'
         '                r.setdefault("memory", {"argument_bytes": r["argument_bytes_per_device"][r["mesh"]]})\n'
         '                r.setdefault("collective_bytes_per_device", {"total": r["collective_bytes_est"]})\n'
         '                out[(r["arch"], r["shape"], r["mesh"])] = r\n'
         '    except FileNotFoundError:\n'
         '        pass\n'
         '    return out\n'),
    ],
}


def _copied_modules():
    out = []
    for sub in ("core", "costmodel", "launch", "runtime"):
        for p in sorted((SRC / "repro_torch" / sub).glob("*.py")):
            rel = f"{sub}/{p.name}"
            if (SRC / "repro" / rel).is_file() and rel not in PORTS:
                out.append(rel)
    return out


COPIED = _copied_modules()


def _pinned_text(rel):
    """The original's text, import paths moved, with the listed departures."""
    text = _as_port((SRC / "repro" / rel).read_text())
    for old, new, *count in DEPARTURES.get(rel, ()):
        n = count[0] if count else 1
        assert text.count(old) == n, f"{rel}: departure anchor found {text.count(old)}x: {old[:70]!r}"
        text = text.replace(old, new)
    return text


def _pin_breaks(rel, root):
    """The lines where ``root/rel`` and the pinned text part (empty = pin holds)."""
    import difflib

    got = (root / rel).read_text().splitlines()
    want = _pinned_text(rel).splitlines()
    return [line for line in difflib.unified_diff(want, got, lineterm="", n=0)
            if line[:1] in "+-" and line[:3] not in ("+++", "---")]


def test_every_copy_is_pinned():
    """The copies are exactly the expected set, and every departure table
    belongs to a copy."""
    assert COPIED == [
        "core/__init__.py", "core/accuracy.py", "core/admission.py", "core/budget.py",
        "core/budget_online.py", "core/campaign.py", "core/dag.py", "core/engine_soa.py",
        "core/faults.py", "core/sampling.py", "core/scheduler.py", "core/simulator.py",
        "core/specs.py", "core/variants.py", "core/workload.py",
        "costmodel/__init__.py", "costmodel/dnn_zoo.py", "costmodel/layers.py",
        "costmodel/maestro.py", "launch/analytics.py", "launch/roofline.py",
        "runtime/serve_runtime.py",
    ]
    assert set(DEPARTURES) <= set(COPIED)


@pytest.mark.parametrize("rel", COPIED)
def test_copy_source_equals_its_pinned_original(rel):
    breaks = _pin_breaks(rel, SRC / "repro_torch")
    assert not breaks, "\n".join(breaks[:40])


@pytest.mark.parametrize("rel", COPIED)
def test_a_stray_edit_fails_the_pin(rel, tmp_path):
    """A one-line edit outside the departures (the middle line of the
    copy) fails its pin, and so does an edit of a departure's own text."""
    text = (SRC / "repro_torch" / rel).read_text()
    lines = text.splitlines(keepends=True)
    edits = [len(lines) // 2]
    for _, new, *_ in DEPARTURES.get(rel, ())[:1]:
        start = text.index(new)
        edits.append(text[:start].count("\n"))
    for i in edits:
        edited = list(lines)
        edited[i] = edited[i].rstrip("\n") + "  # edited\n"
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text("".join(edited))
        breaks = _pin_breaks(rel, tmp_path)
        assert breaks and any("# edited" in b for b in breaks), (rel, i)
