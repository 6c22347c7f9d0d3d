"""The torch port stands alone: no jax, no JAX package, card by default.

* **Import isolation.**  A fresh process imports every module of
  ``repro_torch`` and every import of ``chip_smoke.py``; neither ``jax``
  nor the JAX package ``repro`` may appear in ``sys.modules``.  A static
  pass over the sources pins the same rule at the import statements.
* **Device default.**  Entry points run on CUDA unless told
  ``device="cpu"``; with no card they raise instead of running on the
  host silently, and the kernel wrapper never falls back to the plain
  version on a CUDA tensor.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        parts = list(p.relative_to(ROOT / "src").with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _imported_names(path):
    """Every module an import statement in ``path`` names."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_sources_import_neither_jax_nor_the_jax_package():
    assert len(SOURCES) > 20
    bad = [(p.relative_to(ROOT).as_posix(), n)
           for p in SOURCES for n in _imported_names(p) if _forbidden(n)]
    assert not bad, bad


def test_fresh_process_loads_neither_jax_nor_repro():
    """Subprocess, so the assertion sees a clean module table."""
    smoke_imports = [
        ast.unparse(node)
        for node in ast.walk(ast.parse((ROOT / "chip_smoke.py").read_text()))
        if isinstance(node, (ast.Import, ast.ImportFrom))
    ]
    script = "\n".join([
        "import importlib, sys",
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]",
        f"for m in {_port_modules()!r}:",
        "    importlib.import_module(m)",
        "import chip_smoke",
        *smoke_imports,
        "bad = sorted(m for m in sys.modules",
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))",
        "assert not bad, bad",
        "print('OK', len([m for m in sys.modules if m.startswith('repro_torch')]))",
    ])
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", script], env=env, cwd=str(ROOT),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")
    assert int(proc.stdout.split()[1]) >= len(_port_modules())


def test_resolve_device_defaults_to_the_card():
    from repro_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            resolve_device()
        with pytest.raises(RuntimeError, match='device="cpu"'):
            resolve_device("cuda")


def test_entry_points_raise_without_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    import numpy as np

    from repro_torch.convert import params_from_numpy
    from repro_torch.core import SATURATION_SCENARIOS, make_scheduler, simulate, simulate_batch
    from repro_torch.core.variant_exec import run_pointwise_variants
    from repro_torch.costmodel.maestro import PLATFORMS

    plans, tasks = SATURATION_SCENARIOS["saturation_3x"].plans(PLATFORMS["4k_1ws2os"])
    sched = make_scheduler("terastal")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        simulate_batch(plans, tasks, 0.01, sched, [0])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        simulate(plans, tasks, 0.01, sched, seed=0, engine="batch")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        params_from_numpy({"w": np.zeros((2, 2), np.float32)})
    with pytest.raises(RuntimeError, match='device="cpu"'):
        run_pointwise_variants(plans)
    # told the host, they run
    got = simulate(plans, tasks, 0.01, sched, seed=0, engine="batch", device="cpu")
    want = simulate(plans, tasks, 0.01, sched, seed=0, engine="soa")
    assert got.fingerprint() == want.fingerprint()


def test_kernel_wrapper_never_takes_cpu_tensors():
    """The CUDA wrapper refuses host tensors (the plain version is the
    routing function's business, not a fallback inside the wrapper)."""
    from repro_torch.kernels.s2d_conv.kernel import s2d_conv_cuda

    x = torch.zeros((1, 2, 2, 4))
    w = torch.zeros((1, 1))
    before = s2d_conv_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        s2d_conv_cuda(x, w, 2)
    assert s2d_conv_cuda.launches == before


def test_params_from_numpy_checks_layouts():
    import numpy as np

    from repro_torch.convert import params_from_numpy

    p = params_from_numpy({"w": np.ones((4, 8), np.float32),
                           "w_full": np.ones((3, 3, 4, 8), np.float32)}, device="cpu")
    assert p["w"].shape == (4, 8) and p["w_full"].shape == (3, 3, 4, 8)
    with pytest.raises(ValueError, match="'w'.*rank 2"):
        params_from_numpy({"w": np.ones((3, 4, 8), np.float32)}, device="cpu")
    with pytest.raises(ValueError, match="'w_full'.*rank 4"):
        params_from_numpy({"w_full": np.ones((4, 8), np.float32)}, device="cpu")
    with pytest.raises(ValueError, match=r"expected \(4, 8\)"):
        params_from_numpy({"w": np.ones((8, 4), np.float32)}, device="cpu",
                          expect={"w": (4, 8)})
