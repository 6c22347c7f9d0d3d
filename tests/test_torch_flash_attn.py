"""Prefill attention's route and the kernel's plan (``repro_torch.kernels.flash_attn``) on the CPU.

* The route of ``common.flash_attention``: CPU and ``meta`` tensors take the
  plain ``common._flash_attention``; with ``ops.PLAIN_DEVICES`` narrowed to
  the CPU, so that a ``meta`` tensor stands for a CUDA one, the kernel's
  route is taken exactly by a bf16 call that autograd does not record (grad
  off, or none of q, k, v requiring grad), and never by a float32 one; a
  training step (remat full: the forward and its recompute) never takes
  it; every family's bf16 prefill takes it once an attention site; the
  span ``flash_attention`` holds either route.
* The wrapper's refusals, on ``meta`` tensors, before anything is built.
* The plan: each instantiation's shared memory within the 227 KB a block
  may use, with the tile constants the CUDA source declares, the (d, d)
  head dims and latent attention's split pair (q and k of 192, v of 128).
* Coverage: every configuration, and its reduced twin, has head dims the
  kernel takes.

No JAX here; ``tests/test_torch_prefill.py`` holds the plain version to the
JAX package, and the kernel itself is held on the card
(``tests/test_torch_cuda.py``).
"""

import dataclasses
import importlib.util
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.port_only import PORT_ARCHS, get_port_config
from repro_torch.kernels.flash_attn import kernel, ops
from repro_torch.kernels.flash_attn.kernel import (
    HEAD_DIMS, SMEM_LIMIT, SPLIT_HEADS, flash_attn_cuda, smem_bytes,
)
from repro_torch.models import common
from repro_torch.models.model_api import ShapeSpec, build_model
from repro_torch.tree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path(kernel.__file__).resolve().parents[2] / "csrc" / "flash_attn.cu"


class _Routes:
    """Counts the calls that reach each route; the kernel's returns an
    empty output on the inputs' device, inside a span of its own."""

    def __init__(self, monkeypatch):
        self.plain = self.kernel = 0
        plain = common._flash_attention

        def spy_plain(*a):
            self.plain += 1
            with torch.profiler.record_function("route.plain"):
                return plain(*a)

        def spy_kernel(q, k, v, causal, scale):
            self.kernel += 1
            with torch.profiler.record_function("route.kernel"):
                return torch.empty_like(q)

        monkeypatch.setattr(common, "_flash_attention", spy_plain)
        monkeypatch.setattr(ops, "flash_attn_cuda", spy_kernel)


def _qkv(device="cpu", dtype=torch.float32, B=2, Lq=5, Lk=5, H=4, Hkv=2, Dh=32, seed=0, Dv=None):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((B, Lq, H, Dh), generator=gen).to(dtype)
    k = torch.randn((B, Lk, Hkv, Dh), generator=gen).to(dtype)
    v = torch.randn((B, Lk, Hkv, Dh if Dv is None else Dv), generator=gen).to(dtype)
    return tuple(t.to(device) for t in (q, k, v))


def _meta(t):
    return t.to("meta") if isinstance(t, torch.Tensor) else t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_cpu_and_meta_take_the_plain_route(monkeypatch, device, dtype):
    routes = _Routes(monkeypatch)
    q, k, v = _qkv(device, dtype)
    with torch.no_grad():
        out = common.flash_attention(q, k, v, causal=True, q_chunk=4, k_chunk=4)
    assert (routes.plain, routes.kernel) == (1, 0)
    assert tuple(out.shape) == tuple(q.shape) and out.device.type == device


def test_the_plain_route_is_the_former_function():
    """On the CPU the routed call is ``_flash_attention`` itself, bit for
    bit, with the chunks and the scale it is given."""
    q, k, v = _qkv(Lq=7, Lk=7)
    got = common.flash_attention(q, k, v, causal=True, q_chunk=4, k_chunk=2, scale=0.3)
    assert torch.equal(got, common._flash_attention(q, k, v, True, 4, 2, 0.3))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grad,needs,route", [
    (False, "", "kernel"),
    (False, "qkv", "kernel"),
    (True, "", "kernel"),
    (True, "q", "plain"),
    (True, "k", "plain"),
    (True, "v", "plain"),
    (True, "qkv", "plain"),
])
def test_only_a_call_that_autograd_records_leaves_the_kernel(monkeypatch, grad, needs, route,
                                                             dtype):
    """On a device outside ``PLAIN_DEVICES`` (``meta``, with the CPU the only
    plain device), grad on and q, k or v requiring grad is the plain route;
    anything else the kernel's in bf16.  A float32 call is the plain route
    whatever grad says."""
    monkeypatch.setattr(ops, "PLAIN_DEVICES", ("cpu",))
    routes = _Routes(monkeypatch)
    q, k, v = (t.requires_grad_(n in needs) for t, n in zip(_qkv("meta", dtype), "qkv"))
    with torch.set_grad_enabled(grad):
        common.flash_attention(q, k, v, causal=True, q_chunk=4, k_chunk=4)
    plain = route == "plain" or dtype == torch.float32
    assert (routes.plain, routes.kernel) == ((1, 0) if plain else (0, 1))


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_the_span_holds_either_route(monkeypatch, route):
    """One ``flash_attention`` span a call, the route's own work inside it."""
    if route == "kernel":
        monkeypatch.setattr(ops, "PLAIN_DEVICES", ("cpu",))
    routes = _Routes(monkeypatch)
    q, k, v = _qkv("cpu" if route == "plain" else "meta", torch.bfloat16)
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
        common.flash_attention(q, k, v, causal=True, q_chunk=4, k_chunk=4)
    got = {e.name(): (e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
           if e.is_user_annotation()}
    assert set(got) == {"flash_attention", f"route.{route}"}
    (s0, e0), (s1, e1) = got["flash_attention"], got[f"route.{route}"]
    assert s0 <= s1 and e1 <= e0
    assert (routes.plain, routes.kernel) == ((1, 0) if route == "plain" else (0, 1))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: zamba2's tiny twin (``tests/test_torch_zamba2.py``'s): its ``reduced()`` keeps
#: the release's site layers, which a two-layer model does not have
ZAMBA2_TINY = dict(n_layers=7, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=96,
                   vocab_size=96, ssm_state=16, ssm_headdim=16, ssm_chunk=16,
                   hybrid_layer_ids=(1, 3, 4, 6), adapter_rank=8, attn_q_chunk=16,
                   attn_k_chunk=32, logits_chunk=32)


def _config(arch):
    return (get_config if arch in ARCHS else get_port_config)(arch)


def _small(arch):
    if arch == "zamba2-7b":
        return dataclasses.replace(get_port_config(arch), dtype="bfloat16", **ZAMBA2_TINY)
    return _config(arch).reduced(dtype="bfloat16")


@pytest.mark.parametrize("arch", ARCHS + PORT_ARCHS)
def test_every_family_prefill_takes_the_kernel_once_a_site(monkeypatch, arch):
    """A reduced bf16 prefill on ``meta`` standing for the card, grad off: one
    kernel call an attention site (as ``chip_smoke.py`` counts the sites it
    holds each prefill phase to), none of the plain version; no test of the
    model's name decides it."""
    monkeypatch.setattr(ops, "PLAIN_DEVICES", ("cpu",))
    routes = _Routes(monkeypatch)
    cfg = _small(arch)
    model = build_model(cfg, "meta")
    params = tree_map(_meta, build_model(cfg, "cpu").init(torch.Generator().manual_seed(0)))
    batch = model.input_specs(ShapeSpec("tiny", 16, 1, "prefill"))
    with torch.no_grad():
        model.prefill(params, batch)
    assert (routes.plain, routes.kernel) == (0, _chip_smoke()._attention_sites(cfg))


def test_a_training_step_with_remat_never_takes_the_kernel(monkeypatch):
    """A bf16 remat-full loss and its gradient, on ``meta`` standing for the
    card: each layer's forward and its recompute take the plain version; a
    prefill with grad off, the kernel."""
    monkeypatch.setattr(ops, "PLAIN_DEVICES", ("cpu",))
    routes = _Routes(monkeypatch)
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(dtype="bfloat16"), remat=True,
                              remat_policy="full")
    model = build_model(cfg, "meta")
    params = tree_map(_meta, build_model(cfg, "cpu").init(torch.Generator().manual_seed(0)))
    leaves = tree_leaves(params)
    for t in leaves:
        if t.is_floating_point():
            t.requires_grad_(True)
    tok = torch.zeros((2, 16), dtype=torch.long, device="meta")
    loss = model.loss(params, {"tokens": tok, "labels": tok})
    torch.autograd.grad(loss, [t for t in leaves if t.requires_grad])
    assert (routes.plain, routes.kernel) == (2 * cfg.n_layers, 0)
    with torch.no_grad():
        model.prefill(params, {"tokens": tok})
    assert routes.kernel == cfg.n_layers


def _strided(shape, strides, dtype=torch.bfloat16):
    return torch.empty_strided(shape, strides, dtype=dtype, device="meta")


@pytest.mark.parametrize("case,match", [
    ("float16", "all in bfloat16"),
    ("float32", "all in bfloat16"),
    ("mixed", "all in bfloat16"),
    ("head_dim_48", r"head dims \(32, 64, 80, 128, 224, 256\)"),
    ("groups", "not whole groups"),
    ("last_dim", "contiguous last dim"),
    ("stride", "multiples of 16 bytes"),
    ("rank", r"q \[B, Lq, H, Dh\]"),
    ("kv_shape", "do not match"),
    ("split_192_64", r"\(q and k, v\) of \(\(192, 128\),\)"),
    ("split_128_192", r"\(q and k, v\) of \(\(192, 128\),\)"),
    ("meta", "CUDA device"),
    ("split_meta", "CUDA device"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, match):
    """On ``meta`` tensors, before anything is built or counted; a call the
    kernel would take raises only for want of a CUDA device."""
    q, k, v = _qkv("meta", torch.bfloat16, Dh=64)
    if case == "float16":
        q, k, v = (t.half() for t in (q, k, v))
    elif case == "float32":
        q, k, v = (t.float() for t in (q, k, v))
    elif case == "mixed":
        q = q.float()
    elif case == "head_dim_48":
        q, k, v = _qkv("meta", torch.bfloat16, Dh=48)
    elif case == "groups":
        q, k, v = _qkv("meta", torch.bfloat16, H=6, Hkv=4)
    elif case == "last_dim":
        q = torch.empty((2, 5, 64, 4), dtype=torch.bfloat16, device="meta").transpose(2, 3)
    elif case == "stride":
        q = _strided((2, 5, 4, 64), (5 * 4 * 68, 4 * 68, 68, 1))
    elif case == "rank":
        q = q[0]
    elif case == "kv_shape":
        v = v[:, :4]
    elif case == "split_192_64":
        q, k, v = _qkv("meta", torch.bfloat16, Dh=192, Dv=64)
    elif case == "split_128_192":
        q, k, v = _qkv("meta", torch.bfloat16, Dh=128, Dv=192)
    elif case == "split_meta":
        q, k, v = _qkv("meta", torch.bfloat16, Dh=192, Dv=128)
    before = flash_attn_cuda.launches
    with pytest.raises(ValueError, match=match):
        flash_attn_cuda(q, k, v)
    assert kernel.LIBRARY._lib is None and flash_attn_cuda.launches == before


def test_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attn_cuda(*_qkv("cpu", torch.bfloat16))
    assert kernel.LIBRARY._lib is None


def _source_constants():
    text = SOURCE.read_text()
    consts = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (\w+) = (\d+);", text)}
    cases = tuple(int(d) for d in re.findall(r"case (\d+): return launch<\1, \1>", text))
    split = tuple((int(a), int(b)) for a, b, c, d in re.findall(
        r"if \(Dh == (\d+) && Dv == (\d+)\) return launch<(\d+), (\d+)>", text) if (a, b) == (c, d))
    return consts, cases, split


def test_plan_constants_are_the_sources():
    """The Python plan reads the tiles the CUDA source declares, and the
    source instantiates exactly the head dims the wrapper takes, (d, d) and
    split."""
    consts, cases, split = _source_constants()
    assert (consts["BM"], consts["BN"], consts["CW"], consts["STAGES"]) == (
        kernel.BLOCK_M, kernel.BLOCK_N, kernel.CHUNK, kernel.STAGES)
    assert consts["TMAP_ERROR"] == kernel.TMAP_ERROR
    assert cases == HEAD_DIMS
    assert split == SPLIT_HEADS


@pytest.mark.parametrize("head_dim", HEAD_DIMS + SPLIT_HEADS)
def test_shared_memory_fits_at_every_head_dim(head_dim):
    """Q + STAGES x (K + V), aligned, at most 232,448 bytes a block; at
    zamba2-7b's 224 (four 64-column chunks): 64 KB of Q and two stages of
    32 KB of K and 32 KB of V; at latent attention's (192, 128): 48 KB of Q
    and two stages of 24 KB of K and 16 KB of V."""
    need = smem_bytes(*head_dim) if isinstance(head_dim, tuple) else smem_bytes(head_dim)
    assert 0 < need <= SMEM_LIMIT == 232448
    if head_dim == 224:
        assert need == 1024 + 4 * 128 * 128 + 2 * 2 * 4 * 64 * 128 + 40 == 197672
    if head_dim == (192, 128):
        assert need == 1024 + 3 * 128 * 128 + 2 * (3 + 2) * 64 * 128 + 40 == 132136


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS + PORT_ARCHS)
def test_every_configuration_has_a_head_dim_the_kernel_takes(arch, reduced):
    """q's and k's head dim, with v as wide, or (q and k, v) a split pair
    (latent attention's ``v_head_dim``)."""
    cfg = _config(arch)
    cfg = cfg.reduced() if reduced else cfg
    dims = (cfg.resolved_head_dim, getattr(cfg, "v_head_dim", cfg.resolved_head_dim))
    assert dims[0] == dims[1] and dims[0] in HEAD_DIMS or dims in SPLIT_HEADS
    assert cfg.n_heads % cfg.n_kv_heads == 0
