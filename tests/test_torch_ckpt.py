"""The port's checkpoints and supervision (``checkpoint/ckpt.py``,
``runtime/ft.py``, ``launch/train.py``'s restart) on the CPU.

Twins of every test in ``tests/test_ft.py`` (round trip, the COMMITTED
marker, rollback on NaN, periodic checkpoints and their garbage
collection, straggler detection, a restarted run reproducing its data,
and, for ``elastic_remesh``, a restore onto another device), and a
cross-load both ways: a train state ``{"params", "opt"}`` that the JAX
``ckpt.save`` wrote restores bit-equal in the port, bf16 leaves and the
optimiser's ``opt/.step`` included, and one that the port wrote restores
bit-equal in JAX.
"""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
msgpack = pytest.importorskip("msgpack")
ml_dtypes = pytest.importorskip("ml_dtypes")

import jax
import jax.numpy as jnp

from repro.checkpoint import ckpt as j_ckpt
from repro.optim.adamw import init_opt_state as j_init_opt_state

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.optim.adamw import OptState, init_opt_state
from repro_torch.tree import tree_leaves
from repro_torch.runtime.ft import StragglerMonitor, Supervisor


@pytest.fixture(autouse=True)
def x64_off():
    with jax.enable_x64(False):
        yield


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 8), generator=g),
                   "b": torch.zeros((8,), dtype=torch.bfloat16)},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def test_checkpoint_roundtrip(tmp_path):
    state = _state()
    ckpt_lib.save(str(tmp_path), 10, state)
    assert ckpt_lib.latest_step(str(tmp_path)) == 10
    restored = ckpt_lib.restore(str(tmp_path), 10, state, device="cpu")
    assert torch.equal(restored["params"]["w"], state["params"]["w"])
    assert restored["params"]["b"].dtype == torch.bfloat16
    assert restored["step"].dtype == torch.int32 and int(restored["step"]) == 7


def test_checkpoint_atomicity_marker(tmp_path):
    d = ckpt_lib.save(str(tmp_path), 5, _state())
    # remove the COMMITTED marker -> checkpoint invisible to latest_step
    os.unlink(os.path.join(d, "COMMITTED"))
    assert ckpt_lib.latest_step(str(tmp_path)) is None
    assert ckpt_lib.latest_step(str(tmp_path / "nowhere")) is None


def test_restore_checks_shapes(tmp_path):
    state = _state()
    ckpt_lib.save(str(tmp_path), 1, state)
    state["params"]["w"] = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="shape mismatch at params/w"):
        ckpt_lib.restore(str(tmp_path), 1, state, device="cpu")


def test_supervisor_rollback_on_nan(tmp_path):
    sup = Supervisor(str(tmp_path), ckpt_every=1)
    state = _state()
    sup.checkpoint(3, state)
    action, rb = sup.on_step(4, 0.1, {"loss": float("nan"), "grad_norm": 1.0}, state)
    assert action == "rollback" and rb == 3
    action, rb = sup.on_step(4, 0.1, {"loss": torch.tensor(1.0),
                                      "grad_norm": torch.tensor(float("inf"))}, state)
    assert action == "rollback" and rb == 3


def test_supervisor_periodic_checkpoint_and_gc(tmp_path):
    sup = Supervisor(str(tmp_path), ckpt_every=2, keep_last=2)
    state = _state()
    for step in range(2, 11, 2):
        sup.on_step(step, 0.1, {"loss": 1.0, "grad_norm": 1.0}, state)
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(steps) == 2  # gc kept only last 2
    assert ckpt_lib.latest_step(str(tmp_path)) == 10


def test_supervisor_checkpoints_and_exits_on_sigterm(tmp_path):
    import signal

    sup = Supervisor(str(tmp_path), ckpt_every=100)
    previous = signal.getsignal(signal.SIGTERM)
    try:
        sup.install_signal_handler()
        os.kill(os.getpid(), signal.SIGTERM)
        action, rb = sup.on_step(3, 0.1, {"loss": 1.0, "grad_norm": 1.0}, _state())
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert (action, rb) == ("checkpoint_and_exit", None)
    assert ckpt_lib.latest_step(str(tmp_path)) == 3


def test_straggler_detection():
    mon = StragglerMonitor(factor=3.0)
    for i in range(10):
        assert not mon.observe(i, 0.1)
    assert mon.observe(10, 1.0)  # 10x median
    assert mon.events and mon.events[0][0] == 10


def test_train_restart_reproduces_data(tmp_path):
    """Restarted training resumes from the checkpoint and regenerates the
    same data sequence (pure-function pipeline); the reference's 1e-5."""
    from repro_torch.launch.train import run

    kw = dict(steps=6, batch=2, seq=32, reduced=True, ckpt_every=3, log_every=100,
              device="cpu")
    out1 = run("llama3.2-1b", ckpt_dir=str(tmp_path / "a"), **kw)
    # same run, but crash after step 3: replay from the step-3 checkpoint
    run("llama3.2-1b", ckpt_dir=str(tmp_path / "b"), **kw)
    shutil.rmtree(tmp_path / "b" / "step_00000006")  # "crash" lost the tail
    out2 = run("llama3.2-1b", ckpt_dir=str(tmp_path / "b"), **kw)
    assert len(out2["losses"]) == 3
    assert abs(out1["final_loss"] - out2["final_loss"]) < 1e-5


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_restore_onto_another_device(tmp_path, device):
    """``elastic_remesh``'s one-card counterpart: the checkpoint holds whole
    host arrays, so it restores onto whatever device the caller names
    (``meta`` here stands for the card, which the CPU tests lack)."""
    state = _state()
    ckpt_lib.save(str(tmp_path), 1, state)
    restored = Supervisor(str(tmp_path)).restore(1, state, device)
    assert all(t.device.type == device for t in tree_leaves(restored["params"]))
    assert restored["params"]["b"].dtype == torch.bfloat16
    if device == "cpu":
        assert torch.equal(restored["params"]["w"], state["params"]["w"])


# ------------------------------------------------------------ cross-load ---


def _train_state_numpy(seed=0):
    """A train state's numpy leaves: bf16 and f32 parameters, f32 moments."""
    rng = np.random.default_rng(seed)
    bf = ml_dtypes.bfloat16
    params = {
        "embed": {"emb": (rng.standard_normal((16, 8)) * 3).astype(bf)},
        "blocks": {"attn": {"wq": {"w": rng.standard_normal((2, 8, 8)).astype(bf)}},
                   "A_log": rng.standard_normal((2, 4)).astype(np.float32)},
        "final_norm": {"scale": rng.standard_normal(8).astype(np.float32)},
    }
    moments = lambda: jax.tree_util.tree_map(  # noqa: E731
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    return params, moments(), moments()


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _port_bits(t):
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()


def _torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def test_a_jax_checkpoint_restores_bit_equal_in_the_port(tmp_path):
    params, m, v = _train_state_numpy()
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    opt = j_init_opt_state(j_params)._replace(
        step=jnp.int32(42), m=jax.tree_util.tree_map(jnp.asarray, m),
        v=jax.tree_util.tree_map(jnp.asarray, v))
    j_ckpt.save(str(tmp_path), 42, {"params": j_params, "opt": opt})

    like_params = jax.tree_util.tree_map(lambda a: torch.zeros(a.shape, dtype=_torch(a).dtype),
                                         params)
    like = {"params": like_params, "opt": init_opt_state(like_params)}
    assert ckpt_lib.latest_step(str(tmp_path)) == 42
    got = ckpt_lib.restore(str(tmp_path), 42, like, device="cpu")
    assert isinstance(got["opt"], OptState)
    assert got["opt"].step.dtype == torch.int32 and int(got["opt"].step) == 42
    for want, have in ((params, got["params"]), (m, got["opt"].m), (v, got["opt"].v)):
        flat_w = jax.tree_util.tree_leaves(want)
        flat_h = tree_leaves(have)
        assert len(flat_w) == len(flat_h)
        for a, t in zip(flat_w, flat_h):
            assert t.dtype == _torch(a).dtype
            np.testing.assert_array_equal(_port_bits(t), _bits(a))


def test_a_port_checkpoint_restores_bit_equal_in_jax(tmp_path):
    params, m, v = _train_state_numpy(1)
    t_params = jax.tree_util.tree_map(_torch, params)
    opt = OptState(torch.tensor(9, dtype=torch.int32), jax.tree_util.tree_map(_torch, m),
                   jax.tree_util.tree_map(_torch, v))
    ckpt_lib.save(str(tmp_path), 9, {"params": t_params, "opt": opt})

    # the same keys as a checkpoint the JAX package writes of the same tree
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    j_like = {"params": j_params, "opt": j_init_opt_state(j_params)}
    j_ckpt.save(str(tmp_path / "j"), 9, j_like)
    keys = lambda p: sorted(msgpack.unpackb(  # noqa: E731
        (p / "step_00000009" / "state.msgpack").read_bytes(), raw=False))
    assert keys(tmp_path) == keys(tmp_path / "j")
    assert "opt/.step" in keys(tmp_path) and "opt/.m/embed/emb" in keys(tmp_path)

    got = j_ckpt.restore(str(tmp_path), 9, j_like)
    assert got["opt"].step.dtype == jnp.int32 and int(got["opt"].step) == 9
    for want, have in ((params, got["params"]), (m, got["opt"].m), (v, got["opt"].v)):
        for a, b in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(have)):
            assert np.asarray(b).dtype == np.asarray(a).dtype
            np.testing.assert_array_equal(_bits(b), _bits(a))
