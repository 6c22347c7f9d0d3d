"""The float32 reference against the port on the CPU, at small widths and in
float32 on both sides: prefill logits, the loss and every gradient, three
AdamW steps; and the benchmark's input trees against the port's own at
the published widths."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from h100bench.tests.bench_root import OPT, TINY

from h100bench import harness, inputs, program  # noqa: E402
from h100bench.reference import model as ref  # noqa: E402

TOL = 1e-4  # of the largest reference value: float32 against float32, other orders of sums
SEED = 2**32 + 3


def spec_of(name, dtype="float32"):
    t = TINY[name]
    keep = {"tie_embeddings", "norm_eps", "ssm_expand", "ssm_conv_width"}
    return dict(name=name, dtype=dtype, reduced=[k for k in t["widths"] if k not in keep], **t)


def close(got, want, tol=TOL):
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.parametrize("name", sorted(TINY))
def test_prefill_logits(name):
    spec = spec_of(name)
    w = harness.widths(spec)
    _, model = program.build(spec, "cpu")
    params = inputs.weights(w, SEED, "cpu")
    toks = inputs.tokens(w, SEED, (2, 48), "cpu")
    assert close(model.prefill(params, {"tokens": toks}), ref.prefill_logits(w, params, toks))


@pytest.mark.parametrize("name", sorted(TINY))
def test_loss_and_every_gradient(name):
    spec = spec_of(name)
    w = harness.widths(spec)
    _, model = program.build(spec, "cpu")
    params = inputs.weights(w, SEED, "cpu")
    toks = inputs.tokens(w, SEED, (2, 33), "cpu")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    leaves = list(ref.named_leaves(params))
    for _, t in leaves:
        t.requires_grad_(True)
    got = model.loss(params, batch)
    g_got = torch.autograd.grad(got, [t for _, t in leaves])
    p32 = ref._unflatten({n: t.detach().clone().requires_grad_(True) for n, t in leaves})
    with ref.exact_matmul():
        want = ref.loss(w, p32, batch["tokens"], batch["labels"])
        g_want = torch.autograd.grad(want, [t for _, t in ref.named_leaves(p32)])
    got, want = float(got.detach()), float(want.detach())
    assert abs(got - want) <= 1e-6 * abs(want)
    for (n, _), a, b in zip(leaves, g_got, g_want):
        assert close(a, b), n


@pytest.mark.parametrize("name", sorted(TINY))
def test_three_adamw_steps(name):
    from repro_torch.optim.adamw import OptConfig, init_opt_state, make_train_step

    spec = spec_of(name)
    w = harness.widths(spec)
    _, model = program.build(spec, "cpu")
    opt_cfg = OptConfig(**dict(OPT, warmup_steps=1))
    toks = inputs.tokens(w, SEED, (3, 2, 17), "cpu")
    batches = [(t[:, :-1], t[:, 1:]) for t in toks]
    params = inputs.weights(w, SEED, "cpu")
    opt = init_opt_state(params)
    step = make_train_step(model.loss, opt_cfg)
    losses = []
    for k, (tk, lb) in enumerate(batches):
        params, opt, met = step(params, opt, {"tokens": tk, "labels": lb})
        losses.append(float(met["loss"]))
        if k == 0:
            first = {n: v / (1 - opt_cfg.b1) for n, v in ref.unit_norms(opt.m).items()}
    with torch.no_grad():
        start = inputs.weights(w, SEED, "cpu")
        change = {n: float(torch.linalg.vector_norm(a.float() - b.float()))
                  for (n, a), (_, b) in zip(ref.leaf_units(params), ref.leaf_units(start))}
    want = ref.train(w, inputs.weights(w, SEED, "cpu"), batches,
                     {k: getattr(opt_cfg, k) for k in dataclasses.asdict(opt_cfg)})
    assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(losses, want["losses"]))
    assert ref.gaps(first, want["first_grad"])[0] <= 1e-4
    assert ref.gaps(change, want["change"])[0] <= 1e-3


class MetaGenerator(torch.Generator):
    """A generator whose device is ``meta``: a tree drawn on it is shapes
    and dtypes alone."""

    @property
    def device(self):
        return torch.device("meta")


@pytest.mark.parametrize("arch", ["mamba2-1.3b"])
def test_input_trees_have_the_ports_layout(arch, monkeypatch):
    """At the published widths (on ``meta``, nothing allocated): the
    benchmark's weights have the port's keys, shapes and dtypes."""
    monkeypatch.setattr(inputs, "generator", lambda seed, stream, device: MetaGenerator())
    spec = harness.read_json(harness.Path(__file__).resolve().parents[1] / "configs"
                             / f"{arch}.json")
    w = harness.widths(spec)
    _, model = program.build(spec, "meta")
    ours = inputs.weights(w, 0, "meta")
    theirs = model.init(MetaGenerator())
    shape = lambda tree: {n: (tuple(t.shape), t.dtype) for n, t in ref.named_leaves(tree)}  # noqa: E731
    assert shape(ours) == shape(theirs)


def test_widths_differing_from_the_registry_are_refused():
    spec = spec_of("tiny-mamba2")
    spec["reduced"].remove("d_model")
    with pytest.raises(ValueError, match="d_model"):
        program.model_config(spec)


def test_float8_rounding():
    """The largest magnitude maps to float8's largest value and back exactly;
    every other value is within e4m3's half step (1/16 of it)."""
    x = torch.tensor([0.0, 1.0, -3.0, 4.48, 0.1])
    q = ref.fp8(x)
    assert float(q.abs().max()) == pytest.approx(4.48) and q[0] == 0
    assert bool(((q - x).abs() <= x.abs() / 16 + 1e-7).all())
    assert not torch.equal(q, x)
