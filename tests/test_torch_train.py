"""The port's training path (losses, gradients, remat, the SSD scan under
autograd, ``launch.train.run``) against the JAX package's, on the CPU.

Every registry arch runs at its reduced f32 config in both packages with
the very same numpy-drawn weights (``tests/torch_twins.py``) and the same
``synth_batch``: ``Model.loss`` and every gradient leaf within
``tests/test_model_consistency.py``'s ``atol 2e-4, rtol 2e-3`` of the JAX
``Model.loss`` and ``jax.grad``, the loss inside
``tests/test_arch_smoke.py``'s band ``(0.5 ln V, 2 ln V)``.  The JAX side
runs with ``jax_enable_x64`` off: the reference's ``chunked_softmax_xent``
and ``flash_attention`` raise under x64, which another test module in the
same worker may have turned on.

The SSD kernel cannot run here: its ``autograd.Function`` is held with
the kernel entry replaced by the plain ``ssd_chunked`` (the backward is
the plain version's gradient either way), and the routing that sends a
non-CPU tensor under grad through the Function is held on ``meta``
tensors sent down the kernel's route (``ops.PLAIN_DEVICES`` narrowed to
the CPU: the dry run's ``meta`` tensors take the plain version).
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp

from repro.configs.registry import ARCHS
from repro.data.pipeline import DataConfig as JDataConfig, synth_batch as j_synth_batch
from repro.models import mamba2 as J
from repro.models.common import chunked_softmax_xent as j_xent

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
from repro_torch.kernels.ssd_scan.ref import ssd_chunked
from repro_torch.launch import train
from repro_torch.models.common import chunked_softmax_xent
from repro_torch.optim.adamw import OptConfig, init_opt_state, make_train_step
from repro_torch.tree import tree_leaves

from torch_twins import TOL, both, flat, leaf_path


@pytest.fixture(autouse=True)
def x64_off():
    with jax.enable_x64(False):
        yield


# ----------------------------------------------------------- cross-entropy --


def _naive_xent(h, w, y, mask=None):
    logits = (h.astype(np.float64) @ w.astype(np.float64))
    lse = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) + logits.max(-1)
    nll = lse - np.take_along_axis(logits, y[..., None].astype(np.int64), -1)[..., 0]
    m = np.ones_like(nll) if mask is None else mask
    return (nll * m).sum() / max(m.sum(), 1.0)


@given(B=st.integers(1, 3), L=st.sampled_from([4, 7, 16]), V=st.sampled_from([11, 32]),
       chunk=st.sampled_from([2, 4, 16]), masked=st.booleans())
@settings(max_examples=30, deadline=None)
def test_chunked_xent_matches_jax_and_naive(B, L, V, chunk, masked):
    """tests/test_numerics.py's naive check, with and without a mask, and
    tails (L = 7 over chunks of 2 and 4) included."""
    rng = np.random.default_rng(B * 100 + L + V)
    h = rng.standard_normal((B, L, 8), dtype=np.float32)
    w = rng.standard_normal((8, V), dtype=np.float32)
    y = rng.integers(0, V, (B, L)).astype(np.int32)
    mask = (rng.random((B, L)) < 0.6).astype(np.float32) if masked else None
    got = chunked_softmax_xent(torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(y),
                               None if mask is None else torch.from_numpy(mask), chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == ()
    want = j_xent(jnp.asarray(h), jnp.asarray(w), jnp.asarray(y),
                  None if mask is None else jnp.asarray(mask), chunk=chunk)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.item(), _naive_xent(h, w, y, mask), rtol=1e-5)


def test_chunked_xent_mask():
    """tests/test_numerics.py's: masking the second half equals the first half's loss."""
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.standard_normal((2, 8, 4), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 16), dtype=np.float32))
    y = torch.zeros((2, 8), dtype=torch.int32)
    mask = torch.zeros((2, 8))
    mask[:, :4] = 1.0
    full = chunked_softmax_xent(h[:, :4], w, y[:, :4], chunk=4)
    masked = chunked_softmax_xent(h, w, y, mask=mask, chunk=4)
    np.testing.assert_allclose(masked.item(), full.item(), rtol=1e-5)
    # every position masked: tot / max(cnt, 1) = 0
    assert chunked_softmax_xent(h, w, y, mask=torch.zeros((2, 8)), chunk=3).item() == 0.0


# ---------------------------------------------------- losses and gradients --


def _batch(cfg, B=4, L=48, seed=5):
    """48 positions: a whole logits chunk of 32 and a tail of 16 (reduced
    ``logits_chunk``), three SSD chunks, three MoE groups of 64 tokens."""
    return j_synth_batch(cfg, JDataConfig(global_batch=B, seq_len=L, seed=seed), 0)


def _port_loss_and_grads(model, params, batch):
    leaves = flat(params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    names = sorted(leaves)
    grads = torch.autograd.grad(loss, [leaves[n] for n in names])
    return loss, dict(zip(names, grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    j_model, j_params, model, params = both(arch)
    batch = _batch(model.cfg)
    j_loss, j_grads = jax.value_and_grad(j_model.loss)(
        j_params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _port_loss_and_grads(model, params, batch)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(loss.item(), float(j_loss), **TOL)
    lnv = np.log(model.cfg.vocab_size)
    assert 0.5 * lnv < loss.item() < 2.0 * lnv
    want = {leaf_path(p): np.asarray(g)
            for p, g in jax.tree_util.tree_flatten_with_path(j_grads)[0]}
    assert sorted(want) == sorted(grads)
    for name, g in grads.items():
        assert tuple(g.shape) == want[name].shape, name
        np.testing.assert_allclose(g.numpy(), want[name], err_msg=name, **TOL)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-2.7b", "qwen3-moe-235b-a22b",
                                  "whisper-base"])
def test_remat_policies_give_equal_losses_and_gradients(arch):
    """``full``, ``dots`` and ``none`` recompute the same functions: equal
    loss and gradients (the CPU's products are deterministic)."""
    out = {}
    for policy in ("full", "dots", "none"):
        _, _, model, params = both(arch, remat_policy=policy)
        out[policy] = _port_loss_and_grads(model, params, _batch(model.cfg))
    loss, grads = out["none"]
    for policy in ("full", "dots"):
        assert out[policy][0].item() == loss.item(), policy
        for name, g in grads.items():
            assert torch.equal(out[policy][1][name], g), (policy, name)


def test_remat_checkpoints_only_while_autograd_records(monkeypatch):
    """Under grad with parameters that require it, each layer's body runs
    inside ``torch.utils.checkpoint`` (once in the forward, once more in the
    backward's recompute); without a parameter requiring grad (serving's
    prefill) or under ``no_grad``, it runs once, unwrapped."""
    from repro_torch.models import common, transformer

    calls = []
    apply = transformer.dense_block_apply
    monkeypatch.setattr(transformer, "dense_block_apply",
                        lambda *a: calls.append(1) or apply(*a))
    _, _, model, params = both("llama3.2-1b")
    n = model.cfg.n_layers
    batch = {k: torch.from_numpy(v) for k, v in _batch(model.cfg).items()}
    model.prefill(params, {"tokens": batch["tokens"]})
    assert len(calls) == n
    with torch.no_grad():
        model.loss(params, batch)
    assert len(calls) == 2 * n
    for t in tree_leaves(params):
        t.requires_grad_(True)
    model.loss(params, batch).backward()
    assert len(calls) == 4 * n
    with pytest.raises(ValueError, match="remat policy"):
        common.maybe_remat(lambda x: x, type("C", (), {"remat": True, "remat_policy": "x"}))


# ------------------------------------------------------- SSD under autograd --


def _ssd_inputs(seed, Bt=2, L=64, H=4, Pd=8, N=16):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((Bt, L, H, Pd), dtype=f)
    la = (-np.abs(rng.standard_normal((Bt, L, H), dtype=f)) * 0.3).astype(f)
    B = rng.standard_normal((Bt, L, N), dtype=f)
    C = rng.standard_normal((Bt, L, N), dtype=f)
    dt = np.logaddexp(rng.standard_normal((Bt, L, H), dtype=f), f(0)).astype(f)
    w = rng.standard_normal((Bt, L, H, Pd), dtype=f)
    return (x, la, B, C, dt), w


@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_function_backward_matches_jax_grad(monkeypatch, chunk):
    """The Function with the kernel entry replaced by the plain version:
    its forward runs that entry once, its output carries the Function's
    backward, and the gradients of all five inputs are within 1e-5 of
    max|ref| of ``jax.grad`` of the reference ``ssd_chunked``."""
    calls = []
    monkeypatch.setattr(ssd_ops, "ssd_scan_cuda",
                        lambda *a: calls.append(1) or ssd_chunked(*a))
    inputs, w = _ssd_inputs(7)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    y = ssd_ops.SSDScan.apply(*ts, chunk)
    assert calls == [1] and type(y.grad_fn).__name__ == "SSDScanBackward"
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum(), ts)
    assert calls == [1]  # the backward recomputes the plain version, not the entry

    def f(*a):
        return jnp.sum(J.ssd_chunked(*a, chunk) * w)

    want = jax.grad(f, argnums=tuple(range(5)))(*(jnp.asarray(a) for a in inputs))
    for name, g, r in zip(("x", "log_a", "B", "C", "dt"), grads, want):
        r = np.asarray(r)
        assert g.shape == r.shape and g.dtype == torch.float32, name
        assert np.abs(g.numpy() - r).max() <= 1e-5 * np.abs(r).max(), name


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_backward_spec_matches_jax_grad(chunk, groups):
    """``ref.ssd_chunked_grads``, the blocked backward the CUDA backward
    kernel computes (states by a forward walk, dS' by a reverse walk, dGm
    summed over a group's heads, dcum from dy·y and xdt·dxdt), against
    ``jax.grad`` of the reference ``ssd_chunked``: each of the five
    gradients within 1e-5 of its max|ref|, with B and C shared (one group)
    or in two groups (each group's heads scanned with its own B and C)."""
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_grads

    (x, la, B, C, dt), w = _ssd_inputs(11 + groups)
    if groups > 1:
        rng = np.random.default_rng(3)
        B, C = (rng.standard_normal(B.shape[:2] + (groups, B.shape[2]), dtype=np.float32)
                for _ in range(2))
    hg = x.shape[2] // groups

    def f(x, la, B, C, dt):
        if groups == 1:
            return jnp.sum(J.ssd_chunked(x, la, B, C, dt, chunk) * w)
        heads = [slice(g * hg, (g + 1) * hg) for g in range(groups)]
        ys = [J.ssd_chunked(x[:, :, s], la[..., s], B[:, :, g], C[:, :, g], dt[..., s], chunk)
              for g, s in enumerate(heads)]
        return jnp.sum(jnp.concatenate(ys, axis=2) * w)

    inputs = (x, la, B, C, dt)
    want = jax.grad(f, argnums=tuple(range(5)))(*(jnp.asarray(a) for a in inputs))
    got = ssd_chunked_grads(*(torch.from_numpy(a) for a in inputs), chunk, torch.from_numpy(w))
    for name, g, r, a in zip(("x", "log_a", "B", "C", "dt"), got, want, inputs):
        r = np.asarray(r)
        assert g.shape == a.shape == r.shape and g.dtype == torch.float32, name
        assert np.abs(g.numpy() - r).max() <= 1e-5 * np.abs(r).max(), name


def test_ssd_function_skips_gradients_nobody_needs(monkeypatch):
    monkeypatch.setattr(ssd_ops, "ssd_scan_cuda", lambda *a: ssd_chunked(*a))
    inputs, _ = _ssd_inputs(8)
    ts = [torch.from_numpy(a).requires_grad_(i in (0, 4)) for i, a in enumerate(inputs)]
    gx, gdt = torch.autograd.grad(ssd_ops.SSDScan.apply(*ts, 16).sum(), [ts[0], ts[4]])
    rx, rdt = torch.autograd.grad(ssd_chunked(*ts, 16).sum(), [ts[0], ts[4]])
    torch.testing.assert_close(gx, rx, rtol=0, atol=0)
    torch.testing.assert_close(gdt, rdt, rtol=0, atol=0)


def test_a_scan_off_the_cpu_under_grad_always_has_a_grad_fn(monkeypatch):
    """The routing of ``ops.ssd_scan`` on tensors that are not on the CPU
    (``meta`` here, sent down the CUDA route by taking it out of
    ``PLAIN_DEVICES``, since the CPU tests have no card): under grad,
    with an input requiring it, the output comes from the Function and has
    its ``grad_fn``; under ``no_grad``, or with no input requiring grad,
    the kernel entry is called directly.  The plain version is never
    reached in the forward."""
    entry = []
    monkeypatch.setattr(ssd_ops, "PLAIN_DEVICES", ("cpu",))
    monkeypatch.setattr(ssd_ops, "ssd_scan_cuda",
                        lambda x, *a: entry.append(x.requires_grad) or torch.empty_like(x))
    plain = []
    from repro_torch.kernels.ssd_scan import ref
    monkeypatch.setattr(ref, "ssd_chunked", lambda *a: plain.append(1))
    shapes = [(2, 32, 4, 8), (2, 32, 4), (2, 32, 16), (2, 32, 16), (2, 32, 4)]

    def inputs(grad):
        return [torch.empty(s, device="meta").requires_grad_(grad and i == 2)
                for i, s in enumerate(shapes)]

    y = ssd_ops.ssd_scan(*inputs(True), chunk=16)
    assert y.device.type == "meta" and y.grad_fn is not None
    assert type(y.grad_fn).__name__ == "SSDScanBackward"
    with torch.no_grad():
        assert ssd_ops.ssd_scan(*inputs(True), chunk=16).grad_fn is None
    assert ssd_ops.ssd_scan(*inputs(False), chunk=16).grad_fn is None
    assert entry == [False, False, False] and plain == []


def test_the_cpu_scan_stays_plain_under_grad():
    inputs, _ = _ssd_inputs(9)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    before = ssd_scan_cuda.launches
    y = ssd_ops.ssd_scan(*ts, chunk=16)
    assert type(y.grad_fn).__name__ != "SSDScanBackward"
    torch.testing.assert_close(y, ssd_chunked(*ts, 16), rtol=0, atol=0)
    assert ssd_scan_cuda.launches == before


# ------------------------------------------------------------ train steps --


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_every_arch(arch):
    """tests/test_arch_smoke.py's train step: a finite loss in the band, the
    step counter advanced, every parameter finite and of its shape, and
    the loss that of the JAX ``Model.loss`` on the same weights."""
    j_model, j_params, model, params = both(arch)
    batch = _batch(model.cfg)
    shapes = {k: tuple(v.shape) for k, v in flat(params).items()}
    step = make_train_step(model.loss, OptConfig(warmup_steps=1, total_steps=10))
    params, opt, metrics = step(params, init_opt_state(params),
                                {k: torch.from_numpy(v) for k, v in batch.items()})
    loss = metrics["loss"].item()
    np.testing.assert_allclose(loss, float(j_model.loss(j_params, batch)), **TOL)
    assert np.isfinite(metrics["grad_norm"].item()) and int(opt.step) == 1
    for k, v in flat(params).items():
        assert tuple(v.shape) == shapes[k] and bool(torch.isfinite(v).all()), k


def test_run_matches_jax_step_for_step(tmp_path):
    """Reduced llama3.2-1b: both packages resume from one checkpoint that
    the JAX ``run`` wrote at step 0 (its weights), then train 6 steps on
    the same batches; every step's loss within TOL."""
    from repro.launch.train import run as j_run

    j_run("llama3.2-1b", steps=0, batch=2, seq=32, ckpt_dir=str(tmp_path / "init"),
          log_every=100)
    for d in ("j", "t"):
        shutil.copytree(tmp_path / "init", tmp_path / d)
    want = j_run("llama3.2-1b", steps=6, batch=2, seq=32, ckpt_dir=str(tmp_path / "j"),
                 ckpt_every=3, log_every=100)
    got = train.run("llama3.2-1b", steps=6, batch=2, seq=32, ckpt_dir=str(tmp_path / "t"),
                    ckpt_every=3, log_every=100, device="cpu")
    assert len(got["losses"]) == len(want["losses"]) == 6 == len(got["step_s"])
    np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
    assert got["losses"][-1] < got["losses"][0]
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == [
        "step_00000000", "step_00000003", "step_00000006"]


def test_run_refuses_the_mesh():
    """The production mesh holds 256 devices and the port runs on one: it
    raises, naming both counts, as the reference's does on such a host."""
    with pytest.raises(RuntimeError, match="needs 256 devices; the port runs on 1"):
        train.run("llama3.2-1b", steps=1, use_mesh=True, device="cpu")


def test_run_rolls_back_a_non_finite_step(tmp_path, monkeypatch):
    """A NaN loss at one step rolls back to the last checkpoint and goes on
    past the offending data, as the reference's loop does."""
    from repro_torch.optim import adamw

    make = adamw.make_train_step
    seen = []

    def poisoned(loss_fn, opt_cfg):
        step = make(loss_fn, opt_cfg)

        def wrapped(params, opt, batch):
            params, opt, metrics = step(params, opt, batch)
            seen.append(int(opt.step))
            if len(seen) == 3:
                metrics["loss"] = torch.tensor(float("nan"))
            return params, opt, metrics

        return wrapped

    monkeypatch.setattr(train, "make_train_step", poisoned)
    out = train.run("llama3.2-1b", steps=4, batch=2, seq=16, ckpt_dir=str(tmp_path),
                    ckpt_every=2, log_every=100, device="cpu")
    # steps 0, 1 (checkpoint 2), 2 is bad -> back to 2, then 2, 3 again
    assert seen == [1, 2, 3, 3, 4]
    assert np.isnan(out["losses"][2]) and np.isfinite(out["losses"][-1])
    assert len(out["losses"]) == 5
