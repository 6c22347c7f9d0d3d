"""The harness on the CPU at small sizes: files found by name, the result
line's keys, ``correct`` false under every planted fault and under the
float8 control, the checks for a card and for JAX, the trace reduction."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from h100bench.tests.bench_root import CELLS, LIMITS, MIXES, REPO, cell_name, make_root

from h100bench import faults, harness, readers  # noqa: E402  (bench_root puts the paths in place)
from h100bench.trace import Trace  # noqa: E402

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
SEED = 2**33 + 17


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def run(root, cell, seed=SEED, seconds=0.3):
    return harness.run_cell(root, cell, seed, seconds, False, device="cpu", log=lambda s: None)


@pytest.mark.parametrize("config,mix", CELLS)
def test_added_cells_run_and_are_correct(root, config, mix):
    """A configuration, mix, cell and limits added as files plus entries run
    with no code edited, and the result line has the contract's keys."""
    out = run(root, cell_name(config, mix))
    assert list(out) == KEYS
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    kind = MIXES[mix]["kind"]
    assert "setup_s" in out["metrics"] and any(kind in m for m in out["metrics"])
    assert set(out["checks"]) == set(LIMITS[kind])
    json.loads(json.dumps(out))


def test_added_metric_is_read(root):
    """A per-layer metric added as a file and an entry is read over a trace."""
    ctx = harness.context(root, cell_name("tiny-mamba2", "tiny-prefill"), 1, "cpu", True)
    want = harness.metrics_of(ctx)["per_layer"]
    assert "tokens_seen.prefill" in [m["name"] for m in want]
    items = [harness.Item(0.0, 1.0, 128), harness.Item(1.0, 2.0, 128)]
    tr = Trace([(0, 10**9, "k")], [], (0, 2 * 10**9))
    got = harness.per_layer_values(harness.Run(ctx, items, 2.0, {}, {}, tr),
                                   [m for m in want if m["name"] == "tokens_seen.prefill"])
    assert got == {"tokens_seen.prefill": {"value": 256.0, "unit": "tokens"}}


FAULTED = [(config, mix, f) for config, mix in CELLS for f in faults.KINDS[MIXES[mix]["kind"]]]


@pytest.mark.parametrize("config,mix,fault", FAULTED)
def test_planted_fault_is_not_correct(root, config, mix, fault):
    """With the timed path broken underneath, the rest of a run finds it."""
    with faults.planted(fault):
        out = run(root, cell_name(config, mix))
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("config,mix", CELLS)
def test_float8_control_is_not_correct(root, config, mix):
    """The reference in float8, in the program's place, fails a limit."""
    ctx = harness.context(root, cell_name(config, mix), SEED, "cpu", False, log=lambda s: None)
    drv = harness.driver(ctx)
    st = drv.setup(ctx)
    for i in range(drv.check_items(ctx)):
        drv.item(ctx, st, i)
    lim = harness.limits(ctx)
    sound, low = drv.check(ctx, st), drv.control(ctx, st)
    assert all(v <= lim[k] for k, v in sound.items()), sound
    assert any(v > lim[k] for k, v in low.items()), low


def _bare_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_no_card_exits_without_a_result():
    p = subprocess.run([sys.executable, "h100bench/run.py", "--workload",
                        "mamba2-1.3b.prefill-4k", "--seed", str(2**31 + 5), "--seconds", "1"],
                       cwd=REPO, capture_output=True, text=True, env=_bare_env(), timeout=300)
    assert p.returncode == 2 and p.stdout.strip() == "", (p.returncode, p.stdout, p.stderr)


def test_bare_checkout_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files has no
    program to run: the run fails instead of printing a result."""
    shutil.copytree(REPO / "h100bench", tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import sys; sys.path.insert(0, '.'); from pathlib import Path; "
            "from h100bench import harness; "
            "harness.run_cell(Path('.'), 'mamba2-1.3b.prefill-4k', 3, 0.1, False, device='cpu')")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True,
                       env=_bare_env(), timeout=300)
    assert p.returncode != 0 and "repro_torch" in p.stderr and p.stdout.strip() == ""


def test_a_run_loads_no_jax_and_the_reference_no_program(root):
    """After a run, no module of the process has the top-level name jax,
    jaxlib, flax or repro (whole names: repro_torch is the program); the
    reference, the inputs and the formulas load nothing of repro_torch."""
    code = (
        "import sys, json; sys.path[:0] = [%r, %r]; from pathlib import Path; "
        "from h100bench import harness; "
        "harness.run_cell(Path(%r), %r, 5, 0.1, False, device='cpu', log=lambda s: None); "
        "print(json.dumps(harness.forbidden_modules()))"
        % (str(REPO / "src"), str(REPO), str(root), cell_name("tiny-mamba2", "tiny-prefill")))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=_bare_env(), timeout=300)
    assert p.returncode == 0, p.stderr
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []
    code = (
        "import sys; sys.path[:0] = [%r]; import h100bench.reference.model, h100bench.inputs, "
        "h100bench.work.model_flops, h100bench.work.roofline; "
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'repro_torch', 'repro', 'jax'}))"
        % str(REPO))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=_bare_env(), timeout=300)
    assert p.returncode == 0 and p.stdout.strip() == "[]", (p.stdout, p.stderr)


def test_forbidden_names_are_whole_top_level_names():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.models.mamba2", "reprox"]) == []
    assert harness.forbidden_modules(["repro.core", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_trace_reduction():
    """Busy time is the union of device intervals inside the window; idle
    time is labelled by the host span it fell in."""
    ms = 10**6
    device = [(1 * ms, 4 * ms, "a"), (2 * ms, 5 * ms, "b"), (8 * ms, 9 * ms, "a"),
              (20 * ms, 30 * ms, "outside")]
    spans = [(0, 6 * ms, "prefill"), (6 * ms, 10 * ms, "to_host")]
    tr = Trace(device, spans, (0, 10 * ms))
    assert tr.window_s == pytest.approx(0.010)
    assert tr.busy_s == pytest.approx(0.005)
    assert tr.idle == pytest.approx({"prefill": 0.002, "to_host": 0.003})
    assert tr.matching("a") == (2, pytest.approx(0.004))
    b = tr.breakdown()
    assert b["device_ops"][0][0] == "outside" and len(b["idle_gaps"]) == 2


@pytest.mark.parametrize("counted,recorded,want", [
    (3, {"cb": 3, "scan": 3}, 25.0),
    (4, {"cb": 3, "scan": 3}, None),  # a call the trace did not see
    (3, {"cb": 3, "scan": 6}, None),  # a kernel launched twice a call
    (3, {"cb": 3, "scan": 0}, None),  # a kernel renamed
])
def test_kernel_roofline_holds_the_calls(counted, recorded, want):
    """A kernel's roofline divides the bound of the calls the benchmark made
    by the time of every launch of the named kernels, and is left out where
    the port's counter or the trace disagrees with those calls."""
    ms = 10**6
    device = [(k * 10 * ms, k * 10 * ms + ms, f"void {name}<64>")
              for name, n in recorded.items() for k in range(n)]
    tr = Trace(device, [], (0, 100 * ms))
    ctx = harness.Context(harness.Path("."), {}, {}, {}, {}, 1, torch.device("cpu"), True,
                          log=lambda s: None)
    run = harness.Run(ctx, [], 1.0, {"ssd_scan_calls": 3, "ssd_scan_bound_s": 0.0015},
                      {"ssd_scan": counted}, tr)
    got = readers.kernel_roofline(run, {"cb": 1, "scan": 1}, "ssd_scan")
    assert got == (None if want is None else pytest.approx(want))


def test_nearest_rank():
    vals = list(range(1, 101))
    assert harness.nearest_rank(vals, 0.95) == 95
    assert harness.nearest_rank([3.0], 0.95) == 3.0


@pytest.mark.cuda
def test_added_cells_on_the_card(root, cuda_card):
    """The small cells through the port's kernels, traced, on the card."""
    for config, mix in CELLS:
        out = harness.run_cell(root, cell_name(config, mix), SEED, 0.5, True, device="cuda",
                               log=lambda s: None)
        assert out["correct"] is True, out["checks"]
        assert out["device"]["busy_s"] > 0 and "breakdown" in out


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
