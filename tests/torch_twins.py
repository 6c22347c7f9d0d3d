"""One model in both packages with the very same weights, for the port's differential tests.

numpy draws every leaf into the shapes of ``jax.eval_shape(model.init,
key)`` at a scale that keeps the model stable; the JAX side takes the
arrays as they are, the port takes them through
``convert.params_from_numpy`` (which checks each leaf's shape against the
JAX tree's).  Configs are the registry's ``reduced(dtype="float32", ...)``
in both packages, checked equal field by field.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as j_get_config
from repro.models.model_api import build_model as j_build_model

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models.model_api import build_model

#: tests/test_model_consistency.py's tolerance on logits and caches
TOL = dict(atol=2e-4, rtol=2e-3)


def cfgs(arch, **over):
    """The reduced f32 config of ``arch`` in both packages (JAX, port)."""
    over = dict(dtype="float32", **over)
    j_cfg = j_get_config(arch).reduced(**over)
    cfg = get_config(arch).reduced(**over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
    return j_cfg, cfg


def leaf_path(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def draw(where, shape, rng):
    """A leaf drawn with numpy at a scale that keeps the model stable."""
    a = rng.standard_normal(shape, dtype=np.float32)
    name = where.split("/")[-1]
    if name in ("scale", "D"):
        return 1.0 + 0.1 * a
    if name == "conv_w":
        return 0.2 * a
    if name == "A_log":
        return np.log(rng.uniform(1.0, 16.0, shape)).astype(np.float32)
    if name == "dt_bias":
        return np.log(np.expm1(rng.uniform(1e-3, 0.1, shape))).astype(np.float32)
    return 0.02 * a  # linears, expert banks, routers, the embedding, conv_b


def numpy_params(j_model, seed=0):
    """(numpy tree in the JAX layout, {path: shape}) for ``j_model``."""
    shapes = jax.eval_shape(j_model.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    leaves, expect = [], {}
    for path, sds in flat:
        where = leaf_path(path)
        leaves.append(draw(where, sds.shape, rng).astype(sds.dtype))
        expect[where] = sds.shape
    return jax.tree_util.tree_unflatten(treedef, leaves), expect


def both(arch, seed=0, **over):
    """(JAX model, its params, the port's model on the CPU, its params)."""
    j_cfg, cfg = cfgs(arch, **over)
    j_model = j_build_model(j_cfg)
    np_params, expect = numpy_params(j_model, seed)
    model = build_model(cfg, device="cpu")
    return (j_model, jax.tree_util.tree_map(jnp.asarray, np_params), model,
            params_from_numpy(np_params, device="cpu", expect=expect))


def tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape, dtype=np.int32)


def flat(tree, path=()):
    """{"a/b/w": leaf} of a nested dict."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat(sub, path + (key,)).items()}
    return {"/".join(path): tree}


def init_matches_jax(arch, scales, **over):
    """The port's own init against the JAX init's tree: the same paths,
    shapes and dtypes, norms at 1, and each of ``scales`` (path -> std)
    drawn at that scale in both packages."""
    import torch

    j_cfg, cfg = cfgs(arch, **over)
    j_params = j_build_model(j_cfg).init(jax.random.PRNGKey(0))
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    flat_j = {leaf_path(p): a for p, a in jax.tree_util.tree_flatten_with_path(j_params)[0]}
    flat_t = flat(params)
    assert sorted(flat_t) == sorted(flat_j)
    for where, a in flat_j.items():
        assert tuple(flat_t[where].shape) == a.shape, where
        assert str(flat_t[where].dtype).split(".")[1] == str(a.dtype), where
        if where.endswith("scale"):
            assert bool((flat_t[where] == 1).all()) and bool((a == 1).all()), where
    for where, want in scales.items():
        assert abs(flat_t[where].float().std().item() / want - 1) < 0.05, where
        assert abs(float(np.std(np.asarray(flat_j[where], dtype=np.float32))) / want - 1) < 0.05, where
    return cfg, flat_t
