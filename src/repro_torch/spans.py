"""Named spans at the program's layer boundaries, for a profiler to read.

``span(name)`` is ``torch.profiler.record_function(name)`` while a
profiler records (``torch.autograd._profiler_enabled()``; autograd's
backward threads inherit the recording thread's state, so a span in a
``Function.backward`` is recorded too), and one shared
``contextlib.nullcontext()`` otherwise.  With no profiler a span costs
that flag check, about a microsecond, where an idle ``record_function``
costs ten.  Nothing turns the spans on but a running profiler.

The spans and where they sit:

=========================  ==================================================
``model.prefill``          ``models.model_api.Model.prefill``, any family
``model.loss``             ``optim.adamw.make_train_step``: the forward
``mamba.block``            ``models.mamba2.mamba_block_apply`` (and remat's
                           recompute of it)
``mamba.in_proj``,         the block's two projections
``mamba.out_proj``
``ssd_scan``               ``kernels.ssd_scan.ops.ssd_scan``, whatever route
                           computes the scan
``ssd_scan.backward``      ``kernels.ssd_scan.ops.SSDScan.backward``
``adamw.update``           ``optim.adamw.adamw_update``
``zamba2.shared_block``    ``models.zamba2.shared_block``: a whole hybrid
                           site (concat, norms, attention, MLP, adapter, the
                           site's linear)
``flash_attention``        ``models.common.flash_attention``, any family
``nemotron_h.moe``         ``models.nemotron_h.moe_layer_apply``: a whole MoE
                           layer (norm, router, dispatch, experts, combine,
                           shared expert, residual)
``moe.router``             ``models.moe_dropless.moe_apply``: the router's
                           scores, top-k and weights
``moe.experts``            the routed experts' up and down products and
                           their activation (the grouped GEMMs on the grouped
                           route)
``moe.shared_expert``      the shared expert's products and activation
``mla.attention``          ``models.deepseek_v3.mla``: a whole MLA block
                           (norm, projections, rope, attention, W_o, residual)
``mla.q_proj``,            its low-rank q and kv projections, their norms,
``mla.kv_proj``            the rope and the k / v assembly
``deepseek.dense_mlp``     ``models.deepseek_v3.dense_mlp``: a whole dense
                           SwiGLU block
``deepseek.moe``           ``models.deepseek_v3.moe_layer_apply``: a whole MoE
                           layer on the held experts
=========================  ==================================================

Counters beside them, kept on the host: ``models.zamba2.shared_block.calls``,
``models.deepseek_v3.mla.calls`` (MLA blocks), ``models.moe_dropless.calls``
(MoE layer calls) and ``models.moe_dropless.routed_rows`` (routes
dispatched to the experts); on the device, with no sync,
``models.moe_dropless.held_rows`` (routes to held experts, where a layer
holds a share of them; read by ``held_count``).
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` while a profiler records, else a shared no-op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
