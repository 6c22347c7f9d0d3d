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


def test_params_from_numpy_takes_a_stacked_lm_tree():
    """A JAX LM tree stacks its blocks: every leaf under ``blocks`` has a
    leading n_layers axis, so ``blocks/.../w`` is rank 3; outside
    ``blocks`` the variant-layout ranks hold as before."""
    import numpy as np

    from repro_torch.convert import params_from_numpy

    nl, d, v = 3, 8, 16
    tree = {
        "embed": {"emb": np.ones((v, d), np.float32)},
        "blocks": {
            "attn_norm": {"scale": np.ones((nl, d), np.float32)},
            "attn": {"wq": {"w": np.ones((nl, d, d), np.float32)}},
            "mlp": {"w_down": {"w": np.ones((nl, 2 * d, d), np.float32)}},
        },
        "final_norm": {"scale": np.ones((d,), np.float32)},
        "lm_head": {"w": np.ones((d, v), np.float32)},
    }
    p = params_from_numpy(tree, device="cpu",
                          expect={"blocks/attn/wq/w": (nl, d, d), "lm_head/w": (d, v)})
    assert p["blocks"]["attn"]["wq"]["w"].shape == (nl, d, d)
    assert p["lm_head"]["w"].shape == (d, v)
    with pytest.raises(ValueError, match="'blocks/attn/wq/w'.*rank 3"):
        params_from_numpy({"blocks": {"attn": {"wq": {"w": np.ones((d, d), np.float32)}}}},
                          device="cpu")
    with pytest.raises(ValueError, match="'lm_head/w'.*rank 2"):
        params_from_numpy({"lm_head": {"w": np.ones((nl, d, v), np.float32)}}, device="cpu")
    with pytest.raises(ValueError, match=r"'blocks/attn/wq/w'.*expected \(3, 8, 4\)"):
        params_from_numpy(tree, device="cpu", expect={"blocks/attn/wq/w": (nl, d, 4)})
    # a list's elements are checked under the list's own name
    with pytest.raises(ValueError, match="'w/1'.*rank 2"):
        params_from_numpy({"w": [np.ones((d, d), np.float32), np.ones(d, np.float32)]},
                          device="cpu")
    # a path wins over a bare name
    params_from_numpy(tree, device="cpu",
                      expect={"w": (0,), "blocks/attn/wq/w": (nl, d, d),
                              "blocks/mlp/w_down/w": (nl, 2 * d, d), "lm_head/w": (d, v)})


def test_params_from_numpy_takes_the_ssm_tree():
    """The Mamba2 tree as JAX stacks it: ``in_proj/w`` and ``out_proj/w``
    rank 2 + 1, ``conv_w [n_layers, W, conv_ch]``, and the f32 vectors kept
    f32 beside bf16 weights."""
    import numpy as np

    ml_dtypes = pytest.importorskip("ml_dtypes")
    from repro_torch.convert import params_from_numpy

    nl, d, ch, h = 2, 8, 12, 4
    bf = ml_dtypes.bfloat16
    tree = {"blocks": {
        "in_proj": {"w": np.ones((nl, d, 2 * ch), bf)},
        "conv_w": np.ones((nl, 4, ch), bf),
        "conv_b": np.zeros((nl, ch), np.float32),
        "A_log": np.ones((nl, h), np.float32),
        "out_proj": {"w": np.ones((nl, ch, d), bf)},
    }}
    p = params_from_numpy(tree, device="cpu")["blocks"]
    assert p["conv_w"].shape == (nl, 4, ch) and p["conv_w"].dtype == torch.bfloat16
    assert p["A_log"].dtype == p["conv_b"].dtype == torch.float32
    assert p["in_proj"]["w"].shape == (nl, d, 2 * ch)
    with pytest.raises(ValueError, match="'blocks/conv_w'.*rank 3"):
        params_from_numpy({"blocks": {"conv_w": np.ones((4, ch), bf)}}, device="cpu")


def test_params_from_numpy_keeps_bf16_bits():
    import numpy as np

    ml_dtypes = pytest.importorskip("ml_dtypes")
    from repro_torch.convert import params_from_numpy

    a = (np.random.default_rng(0).standard_normal((2, 4, 8)) * 3).astype(ml_dtypes.bfloat16)
    t = params_from_numpy({"blocks": {"w": a}}, device="cpu")["blocks"]["w"]
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16), a.view(np.uint16))


ARCHS = ("llama4-maverick-400b-a17b", "qwen3-moe-235b-a22b", "mamba2-1.3b", "codeqwen1.5-7b",
         "gemma-7b", "mistral-nemo-12b", "llama3.2-1b", "zamba2-2.7b", "whisper-base",
         "llava-next-34b")  # repro.configs.registry.ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_takes_every_reduced_param_tree(arch):
    """The JAX package's reduced param tree of every arch (its shapes from
    ``jax.eval_shape`` of ``init``, filled with zeros) converts, each leaf
    keeping its shape: the stacked axes of ``mamba_blocks`` and
    ``dense_blocks`` (two each) and of the other block stacks (one)."""
    import numpy as np

    jax = pytest.importorskip("jax")
    from repro.configs.registry import ARCHS as registry_archs, get_config
    from repro.models.model_api import build_model
    from repro_torch.convert import params_from_numpy

    assert ARCHS == registry_archs
    model = build_model(get_config(arch).reduced())
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    got = params_from_numpy(tree, device="cpu")
    want = jax.tree_util.tree_leaves_with_path(tree)
    have = dict(jax.tree_util.tree_leaves_with_path(got, is_leaf=torch.is_tensor))
    assert len(have) == len(want)
    for path, leaf in want:
        assert tuple(have[path].shape) == leaf.shape, jax.tree_util.keystr(path)


def test_new_modules_run_without_jax_or_repro():
    """The device programs and the campaign stack, imported and run on the
    host in a fresh process: Algorithm 1, a Terastal round, a trial with
    every block round on the device round, a two-trial campaign and the
    sampler, and still no jax and no JAX package in the module table."""
    script = "\n".join([
        "import sys",
        f"sys.path[:0] = [{str(ROOT / 'src')!r}]",
        "import numpy as np, torch",
        "import repro_torch.core as P",
        "from repro_torch.core import budget_torch, campaign, sampling, scheduler_torch",
        "from repro_torch.costmodel.maestro import PLATFORMS",
        "packed, R = budget_torch.pack_levels(np.array([[4.0, 1.0], [3.0, 2.0]]))",
        "out = budget_torch.distribute_budgets_torch(packed, R, 3.5, device='cpu')",
        "assert out.rho.tolist() == [1, 1], out",
        "inp = scheduler_torch.pack_arrays(np.array([1.0]), np.array([2.0]), np.array([0.0]),",
        "    np.array([[0.5, 0.25]]), np.full((1, 2), np.inf), np.zeros(2),",
        "    np.array([True, True]), device='cpu')",
        "o = scheduler_torch.terastal_round(inp)",
        "assert o.assign_acc.tolist()[0] == 1, o",
        "plans, tasks = P.SATURATION_SCENARIOS['saturation_3x'].plans(PLATFORMS['4k_1ws2os'])",
        "a = P.simulate(plans, tasks, 0.02, P.make_scheduler('terastal'), seed=0, engine='soa',",
        "               round_kernel='jax', device='cpu')",
        "b = P.simulate(plans, tasks, 0.02, P.make_scheduler('terastal'), seed=0, engine='soa',",
        "               round_kernel='python')",
        "assert a.fingerprint() == b.fingerprint()",
        "c = P.Campaign(scenarios=('saturation_3x',), platforms=('4k_1ws2os',),",
        "               schedulers=('edf', 'terastal'), seeds=(0, 1), duration=0.02)",
        "res = c.run(parallel=False, device='cpu')",
        "ad = P.run_adaptive(c, P.SamplerConfig(stopping=False), parallel=False, device='cpu')",
        "assert len(res.trials) == len(ad.trials) == 4",
        "bad = sorted(m for m in sys.modules",
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))",
        "assert not bad, bad",
        "print('OK')",
    ])
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.pop("REPRO_ROUND_KERNEL", None)
    proc = subprocess.run([sys.executable, "-c", script], env=env, cwd=str(ROOT),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK"
