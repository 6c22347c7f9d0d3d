"""The port's spans (``repro_torch.spans``) on the CPU: where they sit,
how they nest, what they cost with no profiler, and that they change no
number.

Under ``torch.profiler`` (CPU activity) a reduced model's prefill and
training step record the spans the benchmark's reduction reads
(``h100bench/spans.py``).  The SSD ``autograd.Function`` runs with its
kernel entry monkeypatched to the plain scan (the CPU route never builds
it).  The ``cuda`` case runs on the card: there autograd's backward runs
on a thread of its own, and the backward's spans are recorded there.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunked
from repro_torch.models.model_api import build_model
from repro_torch.optim.adamw import OptConfig, init_opt_state, make_train_step
from repro_torch.tree import tree_leaves, tree_map

BLOCK_CHILDREN = ["mamba.in_proj", "ssd_scan", "mamba.out_proj"]


def _model(arch, device="cpu"):
    cfg = dataclasses.replace(get_config(arch).reduced(dtype="float32"), remat=True,
                              remat_policy="full")
    model = build_model(cfg, device)
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, model, model.init(gen)


def _batch(cfg, device="cpu", B=2, L=32):
    gen = torch.Generator(device=device).manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (B, L + 1), generator=gen, device=device)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _recorded(fn):
    """``fn()`` under the profiler; its result and its spans as
    ``(start, end, name, thread)`` in time order, each with the index of
    its innermost enclosing span on its thread (or -1)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    got = sorted(((e.start_ns(), e.end_ns(), e.name(), e.start_thread_id())
                  for e in prof.profiler.kineto_results.events()
                  if e.is_user_annotation() and e.device_type() == torch.autograd.DeviceType.CPU),
                 key=lambda s: (s[0], -s[1]))
    parents = []
    for i, (s, e, _, th) in enumerate(got):
        outer = [j for j in range(i) if got[j][3] == th and got[j][0] <= s and e <= got[j][1]]
        parents.append(outer[-1] if outer else -1)
    return out, got, parents


def _children(got, parents, i):
    return [got[j][2] for j in range(len(got)) if parents[j] == i]


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_prefill_spans_nest(arch):
    """One ``model.prefill`` holding one ``mamba.block`` a Mamba layer,
    each holding exactly its two projections and its scan, in order, and
    one ``flash_attention`` a hybrid's attention site."""
    cfg, model, params = _model(arch)
    _, got, parents = _recorded(lambda: model.prefill(params, {"tokens": _batch(cfg)["tokens"]}))
    names = [g[2] for g in got]
    assert names.count("model.prefill") == 1 and parents[names.index("model.prefill")] == -1
    blocks = [i for i, n in enumerate(names) if n == "mamba.block"]
    assert len(blocks) == cfg.n_layers
    assert all(names[parents[i]] == "model.prefill" for i in blocks)
    for i in blocks:
        assert _children(got, parents, i) == BLOCK_CHILDREN
    sites = [i for i, n in enumerate(names) if n == "flash_attention"]
    want_sites = cfg.n_layers // cfg.hybrid_attn_every if cfg.family == "hybrid" else 0
    assert len(sites) == want_sites and all(names[parents[i]] == "model.prefill" for i in sites)
    assert set(names) == {"model.prefill", "mamba.block", *BLOCK_CHILDREN} | (
        {"flash_attention"} if want_sites else set())


def test_train_step_spans():
    """``model.loss`` with a block a layer inside it, remat's recompute of
    every block after it (two ``mamba.block`` a layer in all), then one
    ``adamw.update``."""
    cfg, model, params = _model("mamba2-1.3b")
    step = make_train_step(model.loss, OptConfig(warmup_steps=0))
    opt = init_opt_state(params)
    _, got, parents = _recorded(lambda: step(params, opt, _batch(cfg)))
    names = [g[2] for g in got]
    assert names.count("model.loss") == 1 and names.count("adamw.update") == 1
    loss, update = names.index("model.loss"), names.index("adamw.update")
    assert got[loss][1] <= got[update][0]
    blocks = [i for i, n in enumerate(names) if n == "mamba.block"]
    assert len(blocks) == 2 * cfg.n_layers
    forward = [i for i in blocks if parents[i] == loss]
    recompute = [i for i in blocks if parents[i] == -1]
    assert len(forward) == len(recompute) == cfg.n_layers
    assert all(got[loss][1] <= got[i][0] and got[i][1] <= got[update][0] for i in recompute)
    assert all(_children(got, parents, i) == BLOCK_CHILDREN for i in blocks)
    assert _children(got, parents, update) == []
    assert "ssd_scan.backward" not in names  # the CPU route differentiates the plain scan


def _ssd_inputs(B=2, L=32, H=2, P=8, N=4, device="cpu"):
    gen = torch.Generator(device=device).manual_seed(2)
    x = torch.randn((B, L, H, P), generator=gen, device=device)
    log_a = -torch.rand((B, L, H), generator=gen, device=device)
    Bm, Cm = (torch.randn((B, L, N), generator=gen, device=device) for _ in range(2))
    dt = torch.rand((B, L, H), generator=gen, device=device)
    return [t.requires_grad_(True) for t in (x, log_a, Bm, Cm, dt)]


def test_ssd_backward_span_and_counter(monkeypatch):
    """The Function's backward is one ``ssd_scan.backward`` span and one count."""
    monkeypatch.setattr(ssd_ops, "ssd_scan_cuda", lambda *a: ssd_chunked(*a))
    args = _ssd_inputs()
    before = ssd_ops.SSDScan.backward_calls

    def fn():
        y = ssd_ops.SSDScan.apply(*args, 8)
        return torch.autograd.grad(y.square().sum(), args)

    grads, got, parents = _recorded(fn)
    assert ssd_ops.SSDScan.backward_calls == before + 1
    assert [(g[2], p) for g, p in zip(got, parents)] == [("ssd_scan.backward", -1)]
    want = torch.autograd.grad(ssd_chunked(*args, 8).square().sum(), args)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    def fail(name):
        raise AssertionError("record_function built with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", fail)
    assert not torch.autograd._profiler_enabled()
    assert spans.span("a") is spans.span("b") is spans._OFF
    with spans.span("outer"):
        with spans.span("inner"):
            pass


def test_span_under_a_profiler_is_a_record_function():
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(spans.span("a"), torch.profiler.record_function)
    assert spans.span("a") is spans._OFF


def _train_once(model, cfg, params):
    params = tree_map(lambda t: t.detach().clone(), params)
    step = make_train_step(model.loss, OptConfig(warmup_steps=0))
    params, opt, met = step(params, init_opt_state(params), _batch(cfg))
    return [met["loss"].detach()] + [t.detach() for t in tree_leaves((params, opt.m, opt.v))]


def test_numbers_are_bit_identical_with_and_without_a_profiler():
    """Prefill logits, and a training step's loss, parameters and moments."""
    cfg, model, params = _model("mamba2-1.3b")
    tokens = {"tokens": _batch(cfg)["tokens"]}
    plain = [model.prefill(params, tokens)] + _train_once(model, cfg, params)
    traced, _, _ = _recorded(lambda: [model.prefill(params, tokens)]
                             + _train_once(model, cfg, params))
    assert len(plain) == len(traced)
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_backward_spans_on_the_autograd_thread(card):
    """On the card a training step's backward runs on autograd's device
    thread: its ``ssd_scan.backward`` spans, one a layer, and remat's
    recomputed blocks are recorded there, not on the calling thread."""
    cfg, model, params = _model("mamba2-1.3b", card)
    step = make_train_step(model.loss, OptConfig(warmup_steps=0))
    opt = init_opt_state(params)
    before = ssd_ops.SSDScan.backward_calls
    _, got, parents = _recorded(lambda: step(params, opt, _batch(cfg, card)))
    torch.cuda.synchronize()
    assert ssd_ops.SSDScan.backward_calls == before + cfg.n_layers
    main = next(g[3] for g in got if g[2] == "model.loss")
    backward = [g for g in got if g[2] == "ssd_scan.backward"]
    assert len(backward) == cfg.n_layers and all(g[3] != main for g in backward)
    recompute = [g for g, p in zip(got, parents) if g[2] == "mamba.block" and p == -1]
    assert len(recompute) == cfg.n_layers and all(g[3] != main for g in recompute)
