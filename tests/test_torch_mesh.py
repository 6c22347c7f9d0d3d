"""The port's mesh layouts and sharding-spec trees against the JAX package's.

``repro_torch.launch.mesh`` describes the production layouts as data (no
devices), and every family module carries the reference's spec trees over
the port's own parameter, cache and optimiser trees.  Here, for every
registry arch at its published widths:

* the param specs (``train`` and ``serve``), the cache specs (batch- and
  sequence-sharded), the AdamW and ZeRO-1 optimiser specs and the batch
  specs of every shape equal the reference's ``PartitionSpec``\\ s as
  tuples, leaf for leaf, keyed as the port's trees, and each spec has its
  leaf's rank;
* ``fit_spec`` equals the reference's for every leaf shape, the reference
  run against ``jax.sharding.AbstractMesh`` layouts of (data 16, model 16)
  and (pod 2, data 16, model 16), which need no devices;
* ``elastic_remesh`` restores on a one-device layout and refuses the
  256-device one, naming both counts.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
from jax.sharding import AbstractMesh
from jax.tree_util import DictKey, GetAttrKey, SequenceKey

import repro.launch.mesh as r_mesh
import repro.optim.adamw as r_adamw
from repro.configs import get_config as r_get_config
from repro.models.model_api import build_model as r_build_model

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import mesh
from repro_torch.launch.dryrun import MetaGenerator
from repro_torch.launch.mesh import P
from repro_torch.models.model_api import FAMILIES, SHAPES, build_model
from repro_torch.optim import adamw
from repro_torch.runtime.ft import elastic_remesh
from repro_torch.tree import tree_items

R_MESHES = {"16x16": AbstractMesh((16, 16), ("data", "model")),
            "pod2x16x16": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}


def _key(path):
    parts = []
    for k in path:
        if isinstance(k, DictKey):
            parts.append(str(k.key))
        elif isinstance(k, GetAttrKey):
            parts.append(f".{k.name}")
        elif isinstance(k, SequenceKey):
            parts.append(str(k.idx))
        else:
            raise TypeError(k)
    return "/".join(parts)


def _ref_specs(tree):
    """key -> spec entries of a reference spec tree, keyed as the port's."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {_key(path): tuple(s) for path, s in leaves}


def _ref_shapes(tree):
    return {_key(path): tuple(a.shape) for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_specs(tree):
    out = {}
    for k, s in tree_items(tree):
        assert isinstance(s, P), (k, s)
        out[k] = tuple(s)
    return out


def _same_and_fitting(got_specs, want_specs, tree):
    got = _port_specs(got_specs)
    assert got == _ref_specs(want_specs)
    leaves = dict(tree_items(tree))
    assert set(got) == set(leaves)
    for k, s in got.items():
        assert len(s) == leaves[k].dim(), (k, s, tuple(leaves[k].shape))


_CACHE = {}


def _both(arch):
    """(port model, its meta params, reference model, its abstract params),
    at published widths, built once per arch."""
    if arch not in _CACHE:
        model = build_model(get_config(arch), "meta")
        rmodel = r_build_model(r_get_config(arch))
        _CACHE[arch] = (model, model.init(MetaGenerator()), rmodel,
                        jax.eval_shape(rmodel.init, jax.random.PRNGKey(0)))
    return _CACHE[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_equal_the_reference(arch):
    model, params, rmodel, rparams = _both(arch)
    assert {k: tuple(t.shape) for k, t in tree_items(params)} == _ref_shapes(rparams)
    opt = adamw.init_opt_state(params)
    ropt = jax.eval_shape(r_adamw.init_opt_state, rparams)
    for mode in ("train", "serve"):
        pspecs, rpspecs = model.param_specs(mode), rmodel.param_specs(mode)
        _same_and_fitting(pspecs, rpspecs, params)
        _same_and_fitting(adamw.opt_state_specs(pspecs), r_adamw.opt_state_specs(rpspecs), opt)
        _same_and_fitting(adamw.zero1_opt_specs(pspecs, opt),
                          r_adamw.zero1_opt_specs(rpspecs, ropt), opt)
        assert _port_specs(adamw.zero1_opt_specs(pspecs)) == _ref_specs(
            r_adamw.zero1_opt_specs(rpspecs))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seq_shard", [False, True])
def test_cache_specs_equal_the_reference(arch, seq_shard):
    model, _, rmodel, _ = _both(arch)
    cfg = model.cfg
    cache = FAMILIES[cfg.family][2](cfg, 2, 64, torch.device("meta"))
    rcache = jax.eval_shape(lambda: rmodel.init_cache(2, 64))
    assert {k: tuple(t.shape) for k, t in tree_items(cache)} == _ref_shapes(rcache)
    _same_and_fitting(model.cache_specs(seq_shard), rmodel.cache_specs(seq_shard), cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_batch_specs_equal_the_reference(arch):
    """``input_specs`` gives ``meta`` tensors of the reference's shapes and
    dtypes (the decode position is a Python int, the cache's last)."""
    model, _, rmodel, _ = _both(arch)
    for shape, sh in SHAPES.items():
        got, want = model.input_specs(shape), rmodel.input_specs(shape)
        if sh.kind == "decode":
            assert got.pop("pos") == sh.seq_len - 1
            want.pop("pos")
        flat = dict(tree_items(got))
        assert all(t.device.type == "meta" for t in flat.values())
        assert {k: (tuple(t.shape), str(t.dtype).split(".")[-1]) for k, t in flat.items()} == {
            _key(p): (tuple(a.shape), str(a.dtype))
            for p, a in jax.tree_util.tree_flatten_with_path(want)[0]}
        assert _port_specs(model.batch_specs(shape)) == _ref_specs(rmodel.batch_specs(shape))


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "pod2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_fit_spec_equals_the_reference(arch, multi_pod):
    layout = mesh.make_production_mesh(multi_pod=multi_pod)
    rlayout = R_MESHES[layout.name]
    assert layout.size == int(np.prod(list(rlayout.shape.values())))
    model, params, rmodel, rparams = _both(arch)
    cfg = model.cfg
    cache = FAMILIES[cfg.family][2](cfg, 128, 32768, torch.device("meta"))
    leaves = {**{f"p/{k}": t for k, t in tree_items(params)},
              **{f"c/{k}": t for k, t in tree_items(cache)}}
    for mode in ("train", "serve"):
        specs = {**{f"p/{k}": s for k, s in tree_items(model.param_specs(mode))},
                 **{f"c/{k}": s for k, s in tree_items(model.cache_specs(False))}}
        fitted = dict(tree_items(mesh.fitted_shardings(specs, leaves, layout)))
        for k, s in specs.items():
            shape = tuple(leaves[k].shape)
            want = r_mesh.fit_spec(jax.sharding.PartitionSpec(*s), shape, rlayout)
            assert tuple(mesh.fit_spec(s, shape, layout)) == tuple(want), (k, s, shape)
            assert fitted[k] == mesh.fit_spec(s, shape, layout)
            assert tuple(mesh.resolve_spec(s, layout)) == tuple(
                r_mesh.resolve_spec(jax.sharding.PartitionSpec(*s), rlayout))
            per = mesh.shard_shape(shape, fitted[k], layout)
            assert all(d * n == full for d, n, full in zip(
                per, [mesh._axis_size(layout, e) for e in tuple(fitted[k])] + [1] * 8, shape))


def test_layouts_and_per_device_bytes():
    one, prod = mesh.one_device_mesh(), mesh.make_production_mesh()
    assert (one.size, one.name, prod.size, prod.name) == (1, "1x1", 256, "16x16")
    assert mesh.make_production_mesh(multi_pod=True).name == "pod2x16x16"
    tree = {"w": torch.empty((512, 64), dtype=torch.bfloat16, device="meta"),
            "b": torch.empty((64,), dtype=torch.float32, device="meta")}
    specs = {"w": P(("pod", "data"), "model"), "b": P(None)}
    assert mesh.per_device_bytes(specs, tree, one) == 512 * 64 * 2 + 64 * 4
    assert mesh.per_device_bytes(specs, tree, prod) == 512 * 64 * 2 // 256 + 64 * 4
    assert mesh.named_shardings(specs, prod) == {"w": P("data", "model"), "b": P(None)}
    with pytest.raises(ValueError, match="different keys"):
        mesh.fitted_shardings({"w": P(None)}, tree, prod)
    assert P(None, "model") == P(None, "model") != P("model", None)
    assert len(P()) == 0 and list(P("a", ("b", "c"))) == ["a", ("b", "c")]


def test_elastic_remesh_restores_on_one_device_and_refuses_256(tmp_path):
    params = {"blocks": {"w": torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)},
              "emb": torch.ones((8, 4), dtype=torch.bfloat16)}
    specs = {"blocks": {"w": P(None, ("pod", "data"), "model")}, "emb": P("model", ("pod", "data"))}
    ckpt_lib.save(str(tmp_path), 3, params)
    like = {k: (torch.zeros_like(v) if torch.is_tensor(v) else
                {kk: torch.zeros_like(vv) for kk, vv in v.items()}) for k, v in params.items()}
    got = elastic_remesh(str(tmp_path), 3, like, mesh.one_device_mesh(), specs, device="cpu")
    assert torch.equal(got["blocks"]["w"], params["blocks"]["w"])
    assert torch.equal(got["emb"], params["emb"]) and got["emb"].dtype == torch.bfloat16
    with pytest.raises(RuntimeError, match="needs 256 devices; the port runs on 1"):
        elastic_remesh(str(tmp_path), 3, like, mesh.make_production_mesh(), specs, device="cpu")


def test_train_on_a_one_device_layout_equals_training_without_it():
    """``train.run(use_mesh=True)`` on a layout of size 1 trains as without
    a layout; the production layout is refused (``tests/test_torch_train.py``)."""
    from repro_torch.launch import train

    kw = dict(steps=3, batch=2, seq=16, log_every=100, device="cpu")
    plain = train.run("llama3.2-1b", **kw)
    meshed = train.run("llama3.2-1b", use_mesh=True, mesh=mesh.one_device_mesh(), **kw)
    assert meshed["losses"] == plain["losses"] and len(plain["losses"]) == 3
