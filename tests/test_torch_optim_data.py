"""The port's optimiser (``optim/adamw.py``) and data pipeline
(``data/pipeline.py``) against the JAX package's, on the CPU.

AdamW: ``adamw_update``, ``lr_at`` and ``global_norm`` on the same numpy
parameters, gradients and moments in both packages, f32, within 1e-6
(relative; the same operations in the same order), the clip case
included, and the twins of ``tests/test_numerics.py``'s AdamW tests.  The
data pipeline: ``synth_batch`` equal byte for byte for every family, the
``Pipeline``'s tensors equal to the JAX pipeline's arrays (f32 and bf16),
and the twins of ``tests/test_numerics.py``'s pipeline tests.  The JAX
side runs with ``jax_enable_x64`` off (another test module in the same
worker may have turned it on).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.configs.registry import ARCHS
from repro.data import pipeline as JD
from repro.optim import adamw as JA

from repro_torch.configs import get_config
from repro_torch.data import pipeline as PD
from repro_torch.optim import adamw as PA
from repro_torch.tree import tree_leaves, tree_map


@pytest.fixture(autouse=True)
def x64_off():
    with jax.enable_x64(False):
        yield


# ------------------------------------------------------------------ adamw ---


def _tree(rng, scale=1.0):
    """A nested tree of f32 arrays in the shape of a small model's."""
    return {
        "embed": {"emb": (scale * rng.standard_normal((16, 8))).astype(np.float32)},
        "blocks": {"w": {"w": (scale * rng.standard_normal((2, 8, 8))).astype(np.float32)},
                   "scale": (1 + 0.1 * scale * rng.standard_normal((2, 8))).astype(np.float32)},
        "final_norm": {"scale": (scale * rng.standard_normal(8)).astype(np.float32)},
    }


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _to_numpy(tree):
    return tree_map(lambda t: t.numpy(), tree)


def _close(got, want, rtol=1e-6, atol=1e-7):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("step", [0, 3, 9, 10, 55, 99, 150])
def test_lr_at_matches_jax(step):
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=100)
    got = PA.lr_at(PA.OptConfig(**cfg), torch.tensor(step, dtype=torch.int32))
    want = JA.lr_at(JA.OptConfig(**cfg), jnp.int32(step))
    assert got.dtype == torch.float32 and got.shape == ()
    _close(got.numpy(), np.asarray(want))


def test_global_norm_matches_jax():
    tree = _tree(np.random.default_rng(0), 3.0)
    _close(PA.global_norm(_to_torch(tree)).numpy(), np.asarray(JA.global_norm(tree)))


@pytest.mark.parametrize("clip_norm", [1e9, 1.0, 0.05])
@pytest.mark.parametrize("steps", [1, 4])
def test_adamw_update_matches_jax(clip_norm, steps):
    """Several updates on shared numpy gradients (the same each time in
    both packages), clipping off, on and hard; parameters, moments, the
    step counter, ``lr`` and ``grad_norm`` equal within 1e-6."""
    rng = np.random.default_rng(steps)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip_norm)
    j_cfg, p_cfg = JA.OptConfig(**kw), PA.OptConfig(**kw)
    params = _tree(rng)
    j_p = jax.tree_util.tree_map(jnp.asarray, params)
    j_s = JA.init_opt_state(j_p)
    p_p = _to_torch(params)
    p_s = PA.init_opt_state(p_p)
    assert p_s.step.dtype == torch.int32 and int(p_s.step) == 0
    assert all(t.dtype == torch.float32 and not t.any() for t in tree_leaves(p_s.m))
    for _ in range(steps):
        grads = _tree(rng, 2.0)
        j_p, j_s, j_m = JA.adamw_update(j_cfg, j_p, jax.tree_util.tree_map(jnp.asarray, grads), j_s)
        p_p, p_s, p_m = PA.adamw_update(p_cfg, p_p, _to_torch(grads), p_s)
        for k in ("lr", "grad_norm"):
            _close(p_m[k].numpy(), np.asarray(j_m[k]))
    assert int(p_s.step) == int(j_s.step) == steps
    for got, want in ((p_p, j_p), (p_s.m, j_s.m), (p_s.v, j_s.v)):
        jax.tree_util.tree_map(_close, _to_numpy(got), jax.tree_util.tree_map(np.asarray, want))


def test_adamw_keeps_bf16_params_and_f32_moments():
    """bf16 parameters stay bf16 (``p_f32 - lr * delta`` rounded once), the
    moments f32; the same update as JAX's on the same bf16 bits."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    rng = np.random.default_rng(1)
    p_np = rng.standard_normal((4, 8)).astype(ml_dtypes.bfloat16)
    g_np = rng.standard_normal((4, 8)).astype(ml_dtypes.bfloat16)
    cfg = dict(lr=0.05, warmup_steps=1, total_steps=10)
    j_p, j_s, _ = JA.adamw_update(JA.OptConfig(**cfg), {"w": jnp.asarray(p_np)},
                                  {"w": jnp.asarray(g_np)}, JA.init_opt_state({"w": jnp.asarray(p_np)}))
    bf = lambda a: torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)  # noqa: E731
    p = {"w": bf(p_np)}
    p, s, _ = PA.adamw_update(PA.OptConfig(**cfg), p, {"w": bf(g_np)}, PA.init_opt_state(p))
    assert p["w"].dtype == torch.bfloat16 and s.m["w"].dtype == torch.float32
    np.testing.assert_array_equal(p["w"].float().numpy(), np.asarray(j_p["w"], np.float32))
    _close(s.v["w"].numpy(), np.asarray(j_s.v["w"]))


def test_adamw_matches_reference_step():
    """tests/test_numerics.py's first step against its closed form."""
    cfg = PA.OptConfig(lr=0.1, warmup_steps=1, total_steps=100, weight_decay=0.0, clip_norm=1e9)
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.5, 0.5])}
    p1, st1, _ = PA.adamw_update(cfg, p, g, PA.init_opt_state(p))
    m = 0.1 * 0.5 / (1 - 0.9)
    v = 0.05 * 0.25 / (1 - 0.95)
    lr0 = float(PA.lr_at(cfg, torch.tensor(0, dtype=torch.int32)))
    expect = np.array([1.0, -2.0]) - lr0 * (m / (np.sqrt(v) + cfg.eps))
    np.testing.assert_allclose(p1["w"].numpy(), expect, rtol=1e-5)
    assert int(st1.step) == 1


def test_adamw_clips_global_norm():
    cfg = PA.OptConfig(lr=1e-3, clip_norm=1.0)
    p = {"w": torch.zeros(4)}
    g = {"w": torch.full((4,), 100.0)}
    _, _, metrics = PA.adamw_update(cfg, p, g, PA.init_opt_state(p))
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)


def test_lr_schedule_shape():
    cfg = PA.OptConfig(lr=1.0, warmup_steps=10, total_steps=100)
    lrs = [float(PA.lr_at(cfg, torch.tensor(s, dtype=torch.int32))) for s in (0, 9, 10, 55, 99)]
    assert lrs[0] < lrs[1] <= 1.0  # warmup rises
    assert lrs[2] == pytest.approx(1.0, abs=0.1)
    assert lrs[3] < lrs[2] and lrs[4] < lrs[3]  # cosine decays


def test_make_train_step_updates_in_place():
    """The step differentiates the loss with respect to every parameter,
    writes the update into the same tensors and returns them, with the
    loss, ``lr`` and ``grad_norm`` as device scalars."""
    p = {"a": torch.tensor([1.0, 2.0]), "b": {"c": torch.tensor(3.0)}}
    ids = {id(t) for t in tree_leaves(p)}
    step = PA.make_train_step(lambda q, batch: (q["a"] * batch).sum() + q["b"]["c"] ** 2,
                              PA.OptConfig(lr=0.1, warmup_steps=1, weight_decay=0.0))
    q, s, m = step(p, PA.init_opt_state(p), torch.tensor([1.0, -1.0]))
    assert {id(t) for t in tree_leaves(q)} == ids and int(s.step) == 1
    assert m["loss"].item() == pytest.approx(8.0) and not m["loss"].requires_grad
    # the first update moves each coordinate by lr against its gradient's sign
    np.testing.assert_allclose(q["a"].detach().numpy(), [0.9, 2.1], rtol=1e-6)
    assert q["b"]["c"].item() == pytest.approx(2.9)
    assert m["grad_norm"].item() == pytest.approx(np.sqrt(2 + 36))


# ---------------------------------------------------------- data pipeline ---


@pytest.mark.parametrize("arch", ARCHS)
def test_synth_batch_equals_jax_byte_for_byte(arch):
    j_cfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    for dcfg in (dict(global_batch=3, seq_len=24, seed=7),
                 dict(global_batch=4, seq_len=16, seed=1234, row_start=1, row_end=3)):
        for step in (0, 5):
            want = JD.synth_batch(j_cfg, JD.DataConfig(**dcfg), step)
            got = PD.synth_batch(cfg, PD.DataConfig(**dcfg), step)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
                assert got[k].tobytes() == want[k].tobytes(), (arch, k)


@pytest.mark.parametrize("arch,dtype", [("llama3.2-1b", "float32"), ("whisper-base", "float32"),
                                        ("whisper-base", "bfloat16"),
                                        ("llava-next-34b", "bfloat16")])
def test_pipeline_tensors_equal_the_jax_pipelines_arrays(arch, dtype):
    """Two prefetched batches from step 2: int32 tokens and labels as they
    are, float frames / patches in the model's dtype (bf16 rounded to
    nearest even in both), on the asked device."""
    j_cfg = j_get_config(arch).reduced(dtype=dtype)
    cfg = get_config(arch).reduced(dtype=dtype)
    dcfg = dict(global_batch=2, seq_len=16, seed=3)
    j_pipe = JD.Pipeline(j_cfg, JD.DataConfig(**dcfg), start_step=2)
    pipe = PD.Pipeline(cfg, PD.DataConfig(**dcfg), start_step=2, device="cpu")
    for _ in range(2):
        want, got = next(j_pipe), next(pipe)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            t = got[k]
            assert t.device.type == "cpu" and str(t.dtype).split(".")[1] == str(w.dtype), k
            a = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
            b = np.asarray(w).view(np.int16) if t.dtype == torch.bfloat16 else np.asarray(w)
            np.testing.assert_array_equal(a, b)
    assert pipe.step == j_pipe.step == 4


def test_pipeline_pure_function_of_step():
    cfg = get_config("llama3.2-1b").reduced()
    d = PD.DataConfig(global_batch=4, seq_len=16, seed=7)
    a = PD.synth_batch(cfg, d, 5)
    b = PD.synth_batch(cfg, d, 5)
    c = PD.synth_batch(cfg, d, 6)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert a["tokens"].max() < cfg.vocab_size


def test_pipeline_host_slicing_consistent():
    cfg = get_config("llama3.2-1b").reduced()
    full = PD.synth_batch(cfg, PD.DataConfig(global_batch=8, seq_len=16, seed=7), 3)
    lo = PD.synth_batch(cfg, PD.DataConfig(global_batch=8, seq_len=16, seed=7, row_start=0,
                                           row_end=4), 3)
    hi = PD.synth_batch(cfg, PD.DataConfig(global_batch=8, seq_len=16, seed=7, row_start=4,
                                           row_end=8), 3)
    np.testing.assert_array_equal(np.concatenate([lo["tokens"], hi["tokens"]]), full["tokens"])
