#!/usr/bin/env python3
"""Smoke run of the torch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and ``nvcc``; without a card, or without the
repository beside it, it exits non-zero before printing any result.
Phases, each on lines of its own; any failure exits non-zero:

1. card: ``nvidia-smi`` name and power limit, and the torch device;
2. build: the s2d-conv, decode-attention, SSD-scan, SSD-backward and
   Mamba-pass kernels compiled from ``csrc/s2d_conv.cu``,
   ``csrc/decode_attn.cu``, ``csrc/ssd_scan.cu``, ``csrc/ssd_scan_bwd.cu``
   and ``csrc/mamba_passes.cu``, one ``nvcc`` each,
   started together (seconds of each);
3. kernel: each kernel against its plain version on the card.
   s2d-conv (``ref.s2d_conv_ref``): at the ``tests/test_kernels.py``
   shapes and at every pointwise variant layer the ``multicam_heavy`` @
   ``6k_1ws2os`` plans select, for batches 1 and 8 in f32 and bf16;
   tolerances: f32 max|d| <= 1e-4 max|ref| (split-TF32 products summed in
   another order), bf16 <= 2e-2 max|ref| (bf16 output rounding); then
   each main-path GEMM's launch plan (tile, split, blocks) and the
   kernel's time at every split the planner weighs.  Decode attention
   (``ref.decode_attention``): at the ``tests/test_kernels.py`` shapes
   and at the serving shapes of llama3.2-1b (B=8, L=2048, H=32, Hkv=8,
   Dh=64), gemma-7b (B=8, L=2048, H=16, Hkv=16, Dh=256) and zamba2-2.7b
   (B=8, L=2048, H=32, Hkv=32, Dh=80) with 256 and 2048 valid positions,
   and phase (viii)'s serving shapes with the cache full: whisper-base's
   self- and cross-attention (B=8, H=Hkv=8, Dh=64; L=448 with 256 valid,
   L=1500), llava-next-34b's (B=8, L=4352, 56 heads over 8 of 128),
   llama4-maverick's (L=4160, 40 over 8) and qwen3-moe's (L=4160, 64 over
   4), in f32 and bf16, the grid sized from the valid
   length as the serving path sizes it from ``pos + 1``; tolerances: f32
   |d| <= 1e-5 + 1e-4 |ref| (another summation order), bf16 max|d| <=
   2e-2 max|ref| (both versions round the softmax weights to bf16, the
   kernel before normalising them).
   SSD scan (``ref.ssd_chunked``): at the ``tests/test_kernels.py`` shapes
   in f32 and bf16 (x, B, C in the dtype; log_a, dt f32, as the model
   feeds them), and at the prefill paths' shapes (mamba2-1.3b: Bt=8,
   L=4096, H=64, P=64, N=128, Q=256; zamba2-2.7b: H=80, N=64; zamba2-7b:
   H=112, N=64, B and C [Bt, L, 2, N] in two groups) in the model's dtypes
   and in all-f32; tolerances:
   f32 max|d| < 1e-5 max|ref| at the test shapes (``tests/test_kernels.py``'s),
   1e-4 at the prefill shapes (the cumsum of 256 log-decays, taken in
   another order, moves each exp(cum_i - cum_j) by up to ~1e-5
   relative), bf16 output 2e-2 max|ref| (bf16 rounding of y).
   Device times (CUDA-graph replay) of the kernel, the plain version and
   one library call (``torch.matmul`` on the reshaped views;
   ``scaled_dot_product_attention(..., enable_gqa=True)`` on transposed
   copies of the valid positions: yardsticks the port never calls; no
   single PyTorch call computes the SSD scan), the bound max(bytes /
   3.35 TB/s, operations / peak; for s2d-conv in f32 the faster of the
   CUDA cores and split TF32, three products at the TF32 peak; for the
   SSD scan the products it needs: the causal half, and C Bᵀ once per
   batch row and chunk, not per head, its f32 products at the faster of
   the CUDA cores and split TF32, beside the CUDA-core-only figure of
   earlier runs), and the kernel wrapper's cost per call when launched
   back to back from Python.  At the prefill shapes, the device kernels of
   an SSD call (``torch.profiler`` over four calls: must be 2, C Bᵀ and
   the scan, each recorded in three or four of the calls, as the profiler
   may drop a window's first event) and each one's time.  At the serving shapes
   the decode kernel and SDPA are also timed cold (calls taking turns
   over copies of the cache twice the 50 MB L2), and the kernels line
   takes those (phase (viii)'s shapes are timed cold too); at
   llama3.2-1b's, zamba2-2.7b's, llava-next-34b's and qwen3-moe's serving
   shapes in bf16, the device kernels of a decode call (``torch.profiler`` over four
   calls: must be 1, recorded in three or four of them) and the cold time
   of every split of the cache (1 to 8 blocks a cluster) beside the
   planner's;
4. main paths, each with its launch count set to 0 just before and read
   just after:
   (i) ``simulate_batch`` on the card for (a) ``multicam_heavy`` @
   ``6k_1ws2os``, terastal, default arrivals, 8 seeds, 0.3 s and (b)
   ``saturation_5x`` @ ``4k_1ws2os``, terastal, poisson, 32 seeds, 0.1 s;
   then the pointwise variant layers of the models that applied variants
   in (a) run through ``run_pointwise_variants`` (the s2d-conv kernel).
   Every lane's fingerprint must equal the host ``simulate(engine="soa")``,
   (a) must apply variants, and the variant outputs must match the plain
   version.  Then one pass of the variant layers under ``torch.profiler``
   (device time, device ops, the kernel's share), and the engine runs
   cell (b) again under it, cut to 0.02 s: the device's busy share (device
   time an iteration over the first run's wall an iteration), and device
   ops per loop iteration;
   (ii) serving: ``repro_torch.launch.serve`` at the published widths of
   ``llama3.2-1b`` in bf16 (16 layers, d_model 2048, 32 heads over 8 KV
   heads, vocab 128256), batch 8, a 2048-position cache, 256 greedy
   tokens: ``serve.run``'s two halves, ``load`` and ``decode``, so that
   the weights, built once, serve the replay too.  The decode kernel must
   run 16 x 256 times.  The same steps are then replayed through the
   plain attention, fed the kernel run's tokens; every step's logits
   must agree within rms|d| <= 5e-2 rms|ref| and max|d| <= 0.1 max|ref|
   (bf16: the kernel keeps the softmax weights in f32, the plain version
   rounds them, and the difference compounds over layers and steps).
   Beside the plain replay runs a planted fault, the kernel without the
   newest position (its valid length one short from step 1 on), whose gap
   to the plain replay is read against the same limit and printed, not
   held.  Then the
   first 64 steps of the decode loop run once more under
   ``torch.profiler``: the device's busy share (device time a step over
   the first run's wall a step), device ops per step, and the decode
   kernel's share of device time;
   (iii) ssm prefill: after the llama weights are freed, ``serve.load`` of
   ``mamba2-1.3b`` at its published widths in bf16 (48 layers, d_model
   2048, d_inner 4096, 64 heads of 64, N=128, chunk 256, vocab 50280,
   tied embeddings) and ``model.prefill(params, {"tokens": ...})`` on B=8
   prompts of L=4096 tokens drawn from a numpy seed (``prefill_32k``,
   B=32 L=32768, cut to B=8 L=4096).  The SSD kernel must run exactly 48
   times, and so must the Mamba passes' kernels (``mamba_passes_cuda``,
   one count a block call: grad is off); the flash kernel not at all.  The same prefill is replayed
   with ``ssd_scan`` swapped for the plain ``ssd_chunked``, and once more with a planted fault (the kernel
   with the state dropped at every chunk boundary, so no inter-chunk
   C S term); the last-position logits of each are read against the
   plain replay.  In bf16 that is a reading, not a check: the two sound
   runs differ by some 4% of the logits (their f32 scans are summed in
   another order, which flips the bf16 rounding of a few outputs per
   layer, and the bf16 residual stream carries each flip through 48
   random layers), and the planted fault moves them by about as much.
   The check is in f32, on the same weights and two of the prompts: the
   kernel within 1e-4 of max|ref| and rms|ref| of the plain replay (f32
   summation order only), the planted fault outside that limit.  Then a
   timed prefill (ms, prompt tokens/s, peak memory) and one under
   ``torch.profiler`` (the device's busy share, the kernel's share of
   device time);
   (iii.b) the Mamba block's pass kernels (``mamba_passes_row``) at the
   prefill cell's shape (mamba2-1.3b, B=64, L=4096) and at zamba2-2.7b's,
   zamba2-7b's and nemotron-3-nano-30b-a3b's (B=8, L=4096; two and eight
   B/C groups), bf16: each of the three kernels and the residual add
   timed (CUDA events) beside its byte floor (``kernel.floor_bytes`` at
   3.35 TB/s), the plain passes (``ref.mamba_passes`` with the scan's
   output given, less its two projections) and ``F.rms_norm`` as the
   norm's yardstick; each kernel held to the plain pass on the plain
   block's own inputs within 4 bf16 ulps of max|ref| (dt and log_a, f32,
   within 2e-6); a block call through ``ops.mamba_passes`` with grad off
   counts one, one under autograd one (its Functions), and its backward
   one block backward (``backward_calls``).  Then the passes' backward
   (``mamba_passes_backward_row``) at (p)'s training shape (mamba2-1.3b,
   B=8, L=2048) and at zamba2-7b's block (two B/C groups) at the same B
   and L, bf16: each Function's gradients (every input and leaf) held to
   autograd through the plain pass on the same inputs and output gradient
   within 4 bf16 ulps of max|ref|; each backward kernel (with its
   parameter gradients' sums) timed beside its byte floor
   (``kernel.backward_floor_bytes``), the forward kernels at that shape,
   and a pass's forward and backward on the Functions against the plain
   pass's under autograd, summed over the three passes, and the passes of
   a training step's layer (a forward, remat's recompute and a backward):
   the kernels' device times against the plain passes';
   (iii.c) the prefill attention kernel (``flash_attn_row``) at zamba2-7b's
   site (B=8, L=4096, 32 heads of 224, causal, scale (Dh/2)^-1/2), bf16:
   one launch through ``common.flash_attention`` with grad off, held to
   the plain ``common._flash_attention`` on the same inputs, each output
   row within four bf16 ulps of its own max|ref|, timed (CUDA events)
   beside its bound (the causal products at the bf16 peak), the plain
   route and ``scaled_dot_product_attention`` (a yardstick the port never
   calls); a build with a planted fault (the middle tile of keys left out
   of rows that read 32 tiles or more) read above four times that limit;
   in f32 on two rows (the benchmark's float32 check) the plain route: no
   launch, bit for bit ``common._flash_attention``, timed; then the kernel
   at nemotron-3-nano-30b-a3b's site (``flash_gqa_row``: B=8, L=4096, 32
   query heads over 2 KV heads of 128, causal, scale Dh^-1/2), one launch,
   held to the plain route row by row as above and timed beside its bound
   and the plain route; then at deepseek-v3's latent attention site
   (``flash_mla_row``: B=2, L=16,384, 128 heads, q and k of 192, v of 128 a
   view of W_kvb's output, causal), one launch, held to the plain route row
   by row on a slice of 8 heads and timed whole beside its bound and
   ``scaled_dot_product_attention`` where a backend of it takes the heads;
   (iii.d) nemotron-3-nano-30b-a3b's dropless MoE layer (``moe_grouped_row``)
   at its published widths on the benchmark item's 32,768 tokens, bf16: the
   grouped route's expert outputs held to the plain route's within 1e-2 of
   max|ref|; the router, the grouped route, its two grouped GEMMs and relu²
   (their operands taken from the route's own calls), the combine, the
   shared expert and the layer timed, the GEMMs beside their bound, with a
   per-expert matmul loop over the same sorted rows and the plain route as
   yardsticks;
   (iv) ssm decode: ``serve.decode`` of the same model, B=8, 256 greedy
   tokens: no SSD or decode-attention launch (the recurrent step uses
   no kernel); ms/token, tokens/s, and under ``torch.profiler`` over 64
   steps the busy share (device time a step over the unprofiled run's
   wall a step) and device ops per step.  Then the JAX package's cross-path
   check (``tests/test_model_consistency.py::test_decode_matches_train_forward``)
   at full width and, as there, in f32: one 512-token prompt (two
   chunks) through ``decode_step`` token by token against
   ``model.prefill`` on the same tokens; the last logits within that
   test's |d| <= 2e-4 + 2e-3 |ref|;
   (vii) after (iv), once the mamba2 weights are freed: (h) dense
   prefill, ``serve.load`` of ``llama3.2-1b`` at its published widths in
   bf16 and ``model.prefill`` on B=8 prompts of 4096 tokens
   (``prefill_32k`` cut as (iii) is), which launches the flash kernel once
   a layer and no other kernel of the port; ms, prompt tokens/s, peak
   memory, and under ``torch.profiler`` the busy share and attention's
   share of device time (the flash kernels in the prefill's trace, read
   where it holds each launch), every call held to the plain route on its own
   inputs (four bf16 ulps of each row's max|ref|), the first timed through the kernel, the
   plain route and ``scaled_dot_product_attention`` (a yardstick the port
   never calls) beside its bound.  In f32 on the same weights: two
   prompts against a replay through ``naive_attention``, last logits
   within 1e-4 of max|ref| (summation order only), and ``decode_step``
   token by token through the decode kernel against ``model.prefill`` on
   an 1100-token prompt (three query chunks, the last padded, and a
   padded key chunk) within |d| <= 2e-4 + 2e-3 |ref|.  (i) ``zamba2-2.7b``
   at its published widths in bf16 (54 Mamba2 blocks, d_model 2560,
   d_inner 5120, 80 heads of 64, N=64, chunk 256; one shared attention
   block of 32 heads of 80 at 9 sites; d_ff 10240; vocab 32000), B=8 prompts
   of 4096: the SSD kernel and the pass kernels must run exactly 54 times,
   the flash kernel 9 times, and nothing else;
   the bf16 replay with the plain ``ssd_chunked`` is read, and the f32
   one on two prompts held to 1e-4 of max|ref| and rms|ref| as in (iii);
   the same readings as (h), the SSD kernel's share too.  (j) its
   decode: ``serve.decode``, B=8, a 2048-position cache, 256 greedy
   tokens: the decode kernel must run exactly 9 x 256 times and the SSD
   kernel not at all.  Then, fed the kernel run's tokens, with the kernel
   stepped again beside them (its logits printed against the first run's):
   every step through the plain attention from the kernel run's own state
   at that step (its KV caches and Mamba states), within (ii)'s limit at
   every step; over the first 32 steps the plain attention from its own
   state (a free-running replay, as (ii) replays llama), read against the
   same limit and not held, since the 54 bf16 Mamba blocks carry the two runs' rounding
   differences forward in their states and a sound kernel's free-running
   gap exceeds it (PERF.md section 6); and over the first 16 steps a planted
   fault (the kernel without the newest position) from the kernel run's
   state, read against the limit.  ms/token, tokens/s, and under
   ``torch.profiler`` over 64 steps the device time and device ops per
   step, the busy share (device time a step over the unprofiled run's wall
   a step) and the kernel's share; then the f32 decode vs prefill check on
   a 512-token prompt (two SSD chunks);
   (viii) after (vii), the encdec, vlm and moe families at their published
   widths in bf16 (random weights of seed 0), each model freed before the
   next: (k) ``whisper-base`` (6 + 6 layers, d_model 512, 8 heads of 64,
   vocab 51865): prefill of B=8 rows of 1500 frame embeddings and 448 text
   tokens, then ``encode``, ``encdec_prefill_cross`` and 256 greedy tokens
   from token 0 (``serve.decode`` handed that cache), 12 decode-kernel
   launches a step (self- and cross-attention); (l) ``llava-next-34b`` cut to
   8 of 60 layers (d_model 7168, 56 heads over 8 of 128, d_ff 20480): prefill
   of B=8 rows of 2880 patch embeddings and 1216 tokens (L=4096), its keys
   and values kept in a 4352-position cache, then 256 greedy tokens from the
   prompt's argmax at position 4096, 8 launches a step; (m)
   ``llama4-maverick-400b-a17b`` cut to 1 of 24 groups (a dense and an MoE
   block; 128 experts of 5120 x 8192, top-1; 40 heads over 8 of 128) and (n)
   ``qwen3-moe-235b-a22b`` cut to 2 of 94 layers (128 experts of 4096 x
   1536, top-8; 64 heads over 4 of 128): prefill of B=8 prompts of 4096,
   then 64 tokens as (l).  Each prefill launches the flash kernel once an
   attention site (whisper: its encoder's layers once, its decoder's twice)
   and no other kernel of the port, every call held to the plain route as
   in (h); each decode exactly (sites x steps) decode-kernel launches and
   nothing else.
   Held: every replayed step, from the kernel run's own state, once through
   the kernel (every attention site within 2e-2 max|ref| of the plain
   version on its inputs) and once through the plain attention with the
   kernel run's experts forced into every MoE site (``_forced_topk`` in
   place of ``moe.moe_topk``), the logits within (ii)'s serving limit on every step (a
   router flip, where the plain step's own top-k would differ, a discrete
   change, is counted and read); in f32
   on a twin of the same seed (llama4's with 16 of its 128 experts: the f32
   bank does not fit): the prefill of two rows within 1e-4 of max|ref| of a
   ``naive_attention`` replay, and decode vs prefill of a 520-token prompt
   (whisper: 448 tokens after the frames' cross K/V; the moe cells with a
   capacity factor of E/K, so that no path drops a token) within
   ``2e-4 + 2e-3 |ref|``.  Read: ms a prefill, prompt positions/s, peak
   memory, busy share, attention's share of device time (its kernels in
   the prefill's trace) and the MoE layers' (their calls replayed alone),
   one attention call beside
   ``scaled_dot_product_attention``; ms a token, tokens/s, device ops a
   step, busy share and the kernel's share over the first 32 (moe: 16)
   profiled steps;
   (ix) after (viii), training through ``repro_torch.launch.train.run``
   at the published widths and depths, bf16 weights, f32 AdamW moments,
   remat ``full``, random weights of seed 0, B=8, L=2048 (``train_4k``,
   B=256 L=4096, cut: flash_attention's saved f32 score blocks), 6 steps,
   2 to warm up, no checkpoint: (o) ``llama3.2-1b`` (16 layers, d_model
   2048, 32 heads over 8 of 64, vocab 128256; no kernel of the port) and
   (p) ``mamba2-1.3b`` (48 layers), whose SSD kernel must be called
   exactly 96 times a step (a forward and a remat recompute a layer, each
   inside ``ops.SSDScan``), the SSD backward kernel 48 times (the
   Function's backward), the plain ``ssd_chunked`` and ``plain_grads``
   never; the Mamba passes' kernels 96
   block calls a step (inside their Functions) and 48 block backwards.  Held: the first loss in
   (0.5 ln V, 2 ln V), every loss and grad norm finite, the optimiser's
   step counter 1..6.  Read: ms a step, tokens/s, peak memory, every
   loss; one more step under ``torch.profiler``: device time (its forward
   and backward apart from its AdamW update), the busy share, AdamW's
   share, attention's (its calls replayed alone, two forwards and a
   backward a layer) and the SSD kernel's plus its backward's (four
   backward calls replayed alone through the backward kernel and through
   ``plain_grads``: ms a layer each).  Held in (p): those four
   calls' saved inputs (bf16 x, B, C; f32 log_a, dt) through the kernel,
   each output within 2e-2 of max|ref| of the plain ``ssd_chunked`` on
   the same inputs, a planted fault (the state dropped between chunks)
   outside that, and the kernel, the plain version and the bound timed
   at that shape; the backward kernel on the same calls and output
   gradients, bf16 gradients within 4 bf16 ulps of max|ref| of
   ``plain_grads``'s and f32 ones within 1e-4, timed beside the plain
   backward and its bound.  Then, held: one mamba2 layer at its published widths
   in f32 at (p)'s B=8, L=2048, the SSD Function's input and weight
   gradients (its backward the backward kernel) within 1e-4 of max|ref| of autograd through the plain
   ``ssd_chunked``, and a planted fault (the kernel's output without the
   Function) at least 100x that; the six families' reduced f32 train
   step (llama3.2-1b, qwen3-moe, mamba2, zamba2, whisper-base, llava) on
   the card against the CPU on the same weights and batch: loss and
   every gradient within ``2e-4 + 2e-3 |ref|``, AdamW from the CPU's
   gradients within 1e-6 of max|ref|; and, under
   ``torch.use_deterministic_algorithms``, a reduced llama3.2-1b run of 6
   steps checkpointed every 3, its last checkpoint deleted and the run
   resumed, its losses within 1e-5 of the uninterrupted run's, and two
   planted faults (the moments left at zero on resume; the data
   restarted at step 0) at least 10x that;
   (v) the paper's method (no kernel of the port; the counts must stay
   0): Algorithm 1 (``core/budget_torch``) on the card for every model
   of every catalog scenario on its own platforms, one call each and
   each cell's models as one padded batch, ``rho`` and ``feasible`` equal
   to the numpy ``budget.distribute_budgets`` and budgets within rtol
   1e-5 (the total is summed in another order), with us per call and the
   device ops of one call; the Terastal round (``core/scheduler_torch``,
   one CUDA graph per bucket): ``simulate(engine="soa",
   round_kernel="jax")`` of ``saturation_5x`` @ ``4k_1ws2os``, 0.3 s,
   for each backfill mode, fingerprint-equal to ``round_kernel="python"``,
   its device rounds by NJ bucket (reaching 64), and at states of the
   NJ-16 and NJ-64 buckets the graph replay, the eager ops on the card
   and on the host equal, with us per round beside the host's vectorized
   and scalar rounds and device ops per round (``torch.profiler``); the
   campaign stack: ``Campaign(engine="batch").run()`` of PERF.md's cells
   (a) and (b) with fcfs, edf, dream and terastal over seeds 0-7, every
   ``TrialResult`` field but ``wall_s`` equal to the host ``soa`` grid's,
   trials/s; and ``run_adaptive`` on the batched engine with a journal,
   equal to the host sampler and resumed from its journal with no trial
   run again;
   (vi) the fault lane of the batched engine (no kernel of the port; the
   counts must stay 0), through ``Campaign(engine="batch")``, every
   ``TrialResult`` field but ``wall_s`` equal to the host ``soa`` grid's:
   (f) ``multicam_heavy`` @ ``6k_1ws2os``, terastal, seeds 0-1 (from
   0-7), 0.2 s, under ``down``, ``throttle`` and ``intermittent
   ...retighten=true`` specs on accelerator 1, and the same cell
   fault-free.  For each seed group: trials/s, engine
   iterations, us an iteration, evictions, re-timings, ghost pops and
   variants undone; the ratio of us an iteration faulted / fault-free;
   device ops an iteration faulted and fault-free (``torch.profiler``);
   (x) the serving control plane and the dry run on the H100's constants
   (``repro_torch.launch.analytics``): (x.1) right after phase (ii), one
   16-token chunk of the loaded llama3.2-1b at the end of its
   2048-position cache (the decode kernel 16 x 16 times), wall, device
   time and busy share beside ``serve_runtime.decode_chunk_latency``'s
   one-card prediction, whose memory term must not exceed the measured
   device time; after phase (vi), the same for (m) llama4-maverick from
   phase (viii)'s decode numbers, with the bytes its loaded weights and
   cache hold beside what ``active_params`` counts; (x.2)
   ``benchmarks/bench_lm_serving.py``'s four-model mix, its rates
   recomputed through the port's ``build_serving_plan`` on the H100
   partitions, under every scheduler for 2.0 s (the ms a chunk by
   partition; miss %, accuracy loss %, utilisation; each model's
   released = completed + dropped + in flight held, "terastal <= the
   baselines" read); (x.3) ``launch.dryrun.run_cell`` on ``meta`` for
   (h)'s prefill and (o)'s training step, each count held to
   ``dryrun.dense_count`` within 1e-12, and its share of the bf16 peak
   over (h)'s and (o)'s measured times;
   after each phase, the seconds it took and the seconds since the start;
5. the ``{"kernels": [...]}`` line, then the card line, then
   ``{"ok": true, "device": {...}}`` as the last line.

All rows also go to ``chiprun_out/chip_smoke.json``.
"""

import dataclasses
import inspect
import itertools
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BPS = 3.35e12                      # H100 SXM data sheet
L2_BYTES = 50e6                        # H100 SXM data sheet
PEAK = {"float32": 67e12, "bfloat16": 989e12,   # f32 CUDA cores; bf16 dense tensor
        "tf32": 495e12}                          # dense TF32 tensor
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TEST_SHAPES = [  # (B, H, W, C, K, g), tests/test_kernels.py
    (2, 8, 8, 16, 32, 2), (1, 16, 16, 64, 64, 2), (2, 12, 12, 36, 72, 3),
    (1, 8, 8, 256, 128, 2), (1, 4, 4, 512, 512, 2),
]
DECODE_SHAPES = [  # (B, L, H, Hkv, Dh, valid): tests/test_kernels.py, then serving
    (2, 64, 8, 2, 16, 64), (1, 128, 4, 4, 32, 81), (3, 256, 16, 8, 64, 256),
    (1, 64, 8, 1, 128, 11), (8, 2048, 32, 8, 64, 256), (8, 2048, 32, 8, 64, 2048),
    (8, 2048, 16, 16, 256, 256), (8, 2048, 16, 16, 256, 2048),  # gemma-7b's heads
    (8, 2048, 32, 32, 80, 256), (8, 2048, 32, 32, 80, 2048),  # zamba2-2.7b's heads
    # phase (viii)'s serving shapes, the cache full at the last step: whisper-base's
    # self- and cross-attention, llava-next-34b's (G 7), llama4-maverick's (G 5) and
    # qwen3-moe's (G 16) after a 4096-position prompt
    (8, 448, 8, 8, 64, 256), (8, 1500, 8, 8, 64, 1500), (8, 4352, 56, 8, 128, 4352),
    (8, 4160, 40, 8, 128, 4160), (8, 4160, 64, 4, 128, 4160),
]
#: (H, Dh) of the serving shapes whose device kernels per call and cold time at
#: every split are printed: llama3.2-1b's and zamba2-2.7b's, and at their own
#: serving shapes llava-next-34b's and qwen3-moe's
PLAN_HEADS = ((32, 64), (32, 80), (56, 128), (64, 128))
#: (B, L, H, Hkv, Dh) of phase (viii)'s rows, timed cold as the serving shape is
NEW_PATH_SHAPES = {(8, 448, 8, 8, 64): "whisper-base self", (8, 1500, 8, 8, 64): "whisper-base cross",
                   (8, 4352, 56, 8, 128): "llava-next-34b", (8, 4160, 40, 8, 128): "llama4-maverick",
                   (8, 4160, 64, 4, 128): "qwen3-moe"}
SSD_SHAPES = [  # (Bt, L, H, P, N, Q): tests/test_kernels.py, then the prefill paths
    (2, 64, 4, 8, 16, 16), (1, 128, 2, 64, 128, 32), (2, 32, 8, 16, 8, 32),
    (1, 64, 1, 128, 64, 64), (8, 4096, 64, 64, 128, 256), (8, 4096, 80, 64, 64, 256),
]
#: (Bt, L, H, P, N, Q, G): B and C in G groups, head h reading group h G / H: zamba2-7b's
#: and nemotron-3-nano-30b-a3b's (eight groups, chunk 128)
SSD_GROUPED_SHAPES = [(8, 4096, 112, 64, 64, 256, 2), (8, 4096, 64, 64, 128, 128, 8)]
#: the SSD shapes of the prefill paths: mamba2-1.3b's (the kernels line's), zamba2-2.7b's,
#: zamba2-7b's (in its two groups) and nemotron-3-nano-30b-a3b's (in its eight)
SSD_PATHS = {(8, 4096, 64, 64, 128, 256): "mamba2-1.3b", (8, 4096, 80, 64, 64, 256): "zamba2-2.7b",
             (8, 4096, 112, 64, 64, 256): "zamba2-7b",
             (8, 4096, 64, 64, 128, 128): "nemotron-3-nano-30b-a3b"}
# SSD scan vs ssd_chunked, max|d| / max|ref|: f32 at the test shapes (test_kernels.py),
# f32 at the prefill shape (cumsum of 256 log-decays in another order), bf16 output
SSD_TOL = {"float32": 1e-5, "float32@prefill": 1e-4, "bfloat16": 2e-2}
SERVE = dict(arch="llama3.2-1b", batch=8, ctx=2048, tokens=256, profile_tokens=64)
# logits, kernel run vs plain replay, at every step: rms|d| <= 5e-2 rms|ref| and
# max|d| <= 0.1 max|ref|.  The two runs differ by bf16 rounding of the softmax
# weights, which compounds over 16 layers and over the steps' cached keys and
# values.  A planted fault (the kernel without the newest position) is replayed
# beside it and read against the same limit, as a reading: it does not fail the run.
SERVE_TOL = dict(rms=5e-2, max=0.1)
SSM = dict(arch="mamba2-1.3b", batch=8, prompt=4096, tokens=256, check_prompt=512,
           profile_tokens=64)
# last-position logits, f32 kernel prefill vs the plain-ssd_chunked replay (see
# docstring)
PREFILL_F32_TOL = dict(rms=1e-4, max=1e-4)
# (vii) dense prefill: llama3.2-1b at its published widths, B=8 prompts of 4096
# (prefill_32k cut as cell (d) is); its f32 checks: two prompts against a replay
# through naive_attention, and decode vs prefill on an 1100-token prompt (three
# query chunks of 512, the last padded, and a padded second key chunk of 1024)
DENSE = dict(arch="llama3.2-1b", batch=8, prompt=4096, check_prompt=1100)
# last logits, f32 flash-attention prefill vs the naive_attention replay: the two
# differ only in summation order
DENSE_F32_TOL = 1e-4
# (vii) zamba2-2.7b at its published widths: prefill as DENSE; decode as SERVE
# (B=8, a 2048-position cache, 256 greedy tokens); the f32 decode vs prefill
# check on 512 tokens (two SSD chunks)
HYBRID = dict(arch="zamba2-2.7b", batch=8, prompt=4096, ctx=2048, tokens=256,
              check_prompt=512, fault_steps=16, free_steps=32, profile_tokens=64)
# (viii) the remaining families at their published widths, bf16, random weights of
# seed 0, each cut in depth alone (`cut`): prefill of B=8 prompts, then greedy
# decode from the prompt's cache (whisper: from token 0 after the cross K/V).
# `widths` are the published widths the run checks; `check_prompt` the f32 decode
# vs prefill check's length (two query chunks of 512, the second padded, and a
# padded key chunk; whisper: its 448-token text context); `twin` what the f32
# twin changes where the bf16 model's f32 copy does not fit (llama4's bank)
WHISPER = dict(arch="whisper-base", batch=8, text=448, tokens=256, profile_tokens=32,
               check_prompt=448, cut={},
               widths=dict(n_layers=6, n_encoder_layers=6, encoder_seq=1500, d_model=512,
                           n_heads=8, n_kv_heads=8, head_dim=64, d_ff=2048,
                           vocab_size=51865, tie_embeddings=True, dtype="bfloat16"))
VLM = dict(arch="llava-next-34b", batch=8, text=1216, tokens=256, profile_tokens=32,
           check_prompt=520, cut=dict(n_layers=8),
           widths=dict(d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128, d_ff=20480,
                       vocab_size=64000, n_patches=2880, dtype="bfloat16"))
MOE_CELLS = [
    dict(label="m", arch="llama4-maverick-400b-a17b", batch=8, prompt=4096, tokens=64,
         profile_tokens=16, check_prompt=520, cut=dict(n_layers=2), twin=dict(n_experts=16),
         widths=dict(d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128, d_ff=8192,
                     vocab_size=202048, n_experts=128, experts_per_token=1, moe_d_ff=8192,
                     moe_every=2, dtype="bfloat16")),
    dict(label="n", arch="qwen3-moe-235b-a22b", batch=8, prompt=4096, tokens=64,
         profile_tokens=16, check_prompt=520, cut=dict(n_layers=2), twin={},
         widths=dict(d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128, d_ff=1536,
                     vocab_size=151936, n_experts=128, experts_per_token=8, moe_d_ff=1536,
                     moe_every=1, dtype="bfloat16")),
]
# each attention site of a replayed step: the kernel against the plain version on
# the same inputs, max|d| <= 2e-2 max|ref| (section 2's bf16 kernel limit)
SITE_TOL = 2e-2
# every prefill attention call of phases (vii) and (viii), the flash kernel against
# the plain common._flash_attention on the call's own inputs, each output row (one
# query of one head) against its own max|ref| (``_row_rel``: rows that see many keys
# are a few hundredths where the first rows are near one): four bf16 ulps (2^-8 of
# the row's max|ref| each; P is rounded to bf16 against other running maxima, the
# plain route rounds each chunk's P·V, both round the output; tests/test_torch_cuda.py's
# limit).  The kernel is bf16 only: a float32 call takes the plain route
FLASH_TOL = 4 * 2.0**-8
# a planted fault of phase (iii.c) that the first rows cannot show: a warpgroup of
# the bf16 kernel that reads 32 tiles of keys or more leaves out its middle one; it
# must read above FLASH_FAULT_TIMES x the limit
FLASH_MIDDLE_TILE = ("        if (j < mine) {",
                     "        if (j < mine && (mine < 32 || j != mine / 2)) {")
FLASH_FAULT_TIMES = 4
# the flash kernel's row: zamba2-7b's attention site (B=8, L=4096, 32 heads of 224,
# causal, scale (Dh/2)^-1/2), bf16
FLASH_SITE = dict(B=8, L=4096, H=32, Dh=224)
# and nemotron-3-nano-30b-a3b's (32 query heads over 2 KV heads of 128, scale Dh^-1/2)
FLASH_GQA_SITE = dict(B=8, L=4096, H=32, Hkv=2, Dh=128)
# and deepseek-v3's (128 heads, q and k of 128 + 64, v of 128, its 16k prompts; the
# plain route on a slice of FLASH_MLA_SLICE heads)
FLASH_MLA_SITE = dict(B=2, L=16384, H=128, Dqk=192, Dv=128)
FLASH_MLA_SLICE = 8
# (ix) training at the published widths and depths through launch.train.run:
# bf16 weights, f32 AdamW moments, remat "full", random weights of seed 0, no
# checkpoint (ckpt_every past the last step).  train_4k (B=256, L=4096) cut to
# B=8, L=2048: flash_attention's f32 score blocks, which autograd saves, rule out
# L=4096 (one [B, H, L, L] f32 tensor is 17 GB at B=8 for llama's 32 heads); L=2048
# peaked at 39 GB in both cells (PERF.md section 4).  6 steps, 2 to warm up;
# `ssd_calls`: SSD-kernel calls a step (a forward and a remat recompute a layer)
TRAIN_CELLS = [
    dict(label="o", arch="llama3.2-1b", batch=8, seq=2048, steps=6, warm=2, ssd_calls=0,
         pass_calls=0,
         widths=dict(n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
                     d_ff=8192, vocab_size=128256, dtype="bfloat16", remat=True,
                     remat_policy="full")),
    dict(label="p", arch="mamba2-1.3b", batch=8, seq=2048, steps=6, warm=2, ssd_calls=96,
         pass_calls=96,
         widths=dict(n_layers=48, d_model=2048, ssm_state=128, ssm_headdim=64, ssm_chunk=256,
                     vocab_size=50280, dtype="bfloat16", remat=True, remat_policy="full")),
]
# SSD calls of (p)'s profiled step kept (the Function's saved inputs): each
# replayed through the kernel and the plain ssd_chunked, the kernel's output
# held to SSD_TOL of its dtype (bf16 2e-2 max|ref|) with a planted fault (the
# state dropped between chunks) read outside it; the backward replayed alone
# to time it (ms a layer)
TRAIN_SSD_REPLAY = 4
# the backward kernel on those calls against ops.plain_grads: bf16 gradients
# within SSD_BWD_ULPS bf16 ulps of max|ref|, f32 ones within SSD_BWD_F32
# (tests/test_torch_cuda.py's limits)
SSD_BWD_ULPS, SSD_BWD_F32 = 4, 1e-4
# (ix) one mamba2 layer at its published widths in f32 at (p)'s B=8, L=2048
# (eight SSD chunks): the SSD Function's input and weight gradients against
# autograd through the plain ssd_chunked, max|d| <= 1e-4 max|ref| a leaf (the
# kernel's forward differs from the plain one's by f32 summation order, 1e-4
# at the prefill shape); a planted fault (the kernel's output without the
# Function, so no gradient through the scan) must read at least 100x that
TRAIN_LAYER = dict(batch=TRAIN_CELLS[1]["batch"], seq=TRAIN_CELLS[1]["seq"], tol=1e-4)
# (ix) the six families' reduced f32 train step, card against CPU on the same
# weights and batch: loss and every gradient within tests/torch_twins.py's TOL
# (CROSS_TOL), and AdamW on the card from the CPU's gradients within 1e-6 of
# max|ref| of the CPU's (the same f32 operations)
TRAIN_TWINS = ("llama3.2-1b", "qwen3-moe-235b-a22b", "mamba2-1.3b", "zamba2-2.7b",
               "whisper-base", "llava-next-34b")
TRAIN_OPT_TOL = 1e-6
# (ix) resume on the card, tests/test_ft.py's: reduced llama3.2-1b, 6 steps with
# a checkpoint every 3, the step-6 checkpoint deleted and the run restarted; its
# losses within the CPU twin's 1e-5 of the uninterrupted run's, both runs under
# torch.use_deterministic_algorithms (else the loss's gather backward on the card
# accumulates with atomics, and two runs differ in the last bits).  Two planted
# faults, the moments left at zero on resume and the data restarted at step 0,
# must each read at least 10x that (the first moves three steps' updates only:
# 5.4e-4 on the CPU)
RESUME = dict(arch="llama3.2-1b", steps=6, every=3, batch=2, seq=32, tol=1e-5)
# (v) the paper's method.  Budgets vs numpy: tests/test_budget.py's rtol (the
# card sums the reference total in another order than numpy).
BUDGET_RTOL = 1e-5
MODES = ("ef", "paper", "positive")
SCHEDULERS = ("fcfs", "edf", "dream", "terastal")
# every block round of this trial on the device round; 0.3 s is the shortest
# duration whose ready queue reaches the NJ-64 bucket (it peaks at 145)
ROUND_CELL = dict(scenario="saturation_5x", platform="4k_1ws2os", duration=0.3)
# PERF.md section 4's cells (a) and (b), 4 schedulers x seeds 0-7 each, cut
# from 0.1 s: (a) to 0.05 s (40 variants applied), (b) to 0.01 s (~13,000
# engine iterations at 0.1 s), so that the host-paced engine (5-10 ms an
# iteration) fits
CAMPAIGN_CELLS = [
    ("a", "multicam_heavy", "6k_1ws2os", "periodic", 0.05),
    ("b", "saturation_5x", "4k_1ws2os", "poisson", 0.01),
]
ADAPTIVE_CELL = ("a", "multicam_heavy", "6k_1ws2os", "poisson", 0.02)
# phase (i)'s profiled rerun of cell (b), cut from its 0.1 s
WHERE_B_DURATION = 0.02
# (vi) the fault lane.  (f): PERF.md section 4's cell (a), default arrivals,
# terastal, under three restart-policy fault specs on accelerator 1 whose
# windows open inside 0.2 s (the down and throttle windows also close there;
# every spec evicts or re-times a running layer on both seeds, in the host
# soa engine too).  The host-bound engine's time is its iterations, and each
# group of seeds is one host loop, so the cuts are of horizon and of groups:
# from 8 seeds, edf and terastal at 0.35 s (where edf was needed for an
# eviction on accelerator 0).  Fig. 10's gate cell (fault_dropout, whose
# outage opens at 0.5 s, so no shorter horizon reaches it) is left to the
# tests (tests/test_torch_campaign.py): at 56 s a group it did not fit the
# run's time limit.  The phase took 413 s uncut, 309 s at 0.35 s with that
# cell (PERF.md section 6)
FAULT_SPECS = (
    "down(acc=1,start=0.05,duration=0.1)",
    "throttle(acc=1,start=0.05,duration=0.1,factor=2.5)",
    "intermittent(acc=1,rate=20.0,mean_down=0.02,retighten=true)",
)
FAULT_CELLS = [
    dict(label="f", scenario="multicam_heavy", platform="6k_1ws2os", faults=FAULT_SPECS,
         schedulers=("terastal",), seeds=2, seeds_from=8, duration=0.2,
         cut="terastal alone (from edf and terastal), duration {duration} s (from 0.35 s)"),
    dict(label="f, fault-free", scenario="multicam_heavy", platform="6k_1ws2os",
         faults=("none",), schedulers=("terastal",), seeds=2, seeds_from=8, duration=0.2),
]
# device ops an iteration, faulted against fault-free: (f)'s terastal cell
# under torch.profiler.  The lane is a static branch whose every op runs each
# iteration whether a fault fires or not, so a short horizon (no window open
# yet) gives the same count at a fraction of the profiler's cost
FAULT_PROFILE = dict(spec=FAULT_SPECS[0], seeds=4, duration=0.05)
# last logits, token-by-token decode vs prefill of a 512-token prompt, f32:
# tests/test_model_consistency.py's assert_allclose(atol, rtol)
CROSS_TOL = dict(atol=2e-4, rtol=2e-3)
# (x) the serving control plane and the dry run, on the H100's constants
# (repro_torch.launch.analytics).  (x.1): cell (c)'s llama3.2-1b as
# benchmarks/bench_lm_serving.py's mix serves it (B=8, a 2048-position cache,
# 16-token chunks): one chunk at the end of the cache, timed, beside the
# one-card prediction of serve_runtime.decode_chunk_latency; its memory term
# must not exceed the measured device time (a roofline is a floor)
FLOOR = dict(chunk=16, ctx=SERVE["ctx"], batch=SERVE["batch"])
# (x.2) bench_lm_serving.py's four-model mix (arch, ctx, batch, redundancy) and
# its _calibrated_rates shares, recomputed on the port's H100 partitions; every
# scheduler for 2.0 s, seed 0
LM_MIX = (("llama3.2-1b", 2048, 8, 0.5), ("gemma-7b", 4096, 8, 0.7),
          ("mistral-nemo-12b", 8192, 8, 0.7), ("qwen3-moe-235b-a22b", 4096, 4, 0.85))
LM_SHARES = (0.9, 0.7, 0.55, 0.45)
LM_DURATION = 2.0
# (x.3) the dry run's count of (h)'s prefill and (o)'s train step on meta against
# repro_torch.launch.dryrun.dense_count: tests/test_torch_dryrun.py's 1e-12
DRYRUN_CELLS = (("h", "prefill", DENSE["prompt"], DENSE["batch"]),
                ("o", "train", TRAIN_CELLS[0]["seq"], TRAIN_CELLS[0]["batch"]))
FLOP_RTOL = 1e-12


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(*parts):
    print(*parts, flush=True)


_CLOCK = [0.0, 0.0]  # start of the run, end of the last phase


def phase_done(label):
    """Print the seconds ``label`` took and the seconds since the start."""
    now = time.perf_counter()
    say(f"[time] {label} took {now - _CLOCK[1]:.1f} s; {now - _CLOCK[0]:.1f} s since the start")
    _CLOCK[1] = now


def paced_ms(torch, fn, reps=50, warm=5):
    """Mean time of one ``fn`` call launched back to back from Python
    (CUDA events around ``reps`` calls): what a caller pays per call when
    the host, not the card, sets the pace."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(torch, fn, reps=50, warm=3):
    """Mean device time of one ``fn`` call: ``reps`` calls captured in one
    CUDA graph and replayed, so no host launch gap separates them (inputs
    stay warm in L2 between calls)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warm):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def event_ms(torch, fn, reps=3, warm=1):
    """Mean device time of one ``fn`` call timed with CUDA events around
    ``reps`` calls launched from Python: for calls of many milliseconds,
    whose launch gaps are negligible and whose intermediates are too large
    to keep for a graph."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def cold_graph_ms(torch, calls, reps=50):
    """``graph_ms`` of calls that take turns over ``calls``, each reading
    its own copy of the inputs: with copies together larger than the L2
    cache, every call finds its inputs in device memory, as a layer of
    the serving loop finds its cache between the weight products."""
    turn = itertools.cycle(calls)
    return graph_ms(torch, lambda: next(turn)(), reps)


def device_activity(torch, fn):
    """``{name: (count, device_ms)}``: the device activities (kernels,
    copies) that ``torch.profiler`` records over one call of ``fn``,
    summed by name.  The raw event list is read rather than
    ``prof.events()``, whose per-event tree building takes minutes at the
    engine's millions of launches.  Once the process has profiled a session
    of very many launches, the profiler loses the last records of each
    later session (PERF.md section 7): read a kernel where others follow
    it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            n, ms = by_name.get(e.name(), (0, 0.0))
            by_name[e.name()] = (n + 1, ms + e.duration_ns() / 1e6)
    return by_name


def logits_gap(got, ref):
    """(max|d| / max|ref|, rms|d| / rms|ref|, argmax agreement) of two logit tensors."""
    d = (got - ref).float()
    ref = ref.float()
    return ((d.abs().max() / ref.abs().max()).item(),
            (d.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()).item(),
            (got.argmax(-1) == ref.argmax(-1)).float().mean().item())


def bound(t_bytes, t_ops):
    """Least time (ms) for work whose bytes take ``t_bytes`` at the HBM
    rate and whose operations take ``t_ops`` at the type's peak."""
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def floor_times(x, w, out):
    """(ms over HBM, ms at peak) for one call: every input read once and
    the output written once; 2*M*Cv*Kv operations.  An f32-accurate
    product takes the faster of the CUDA cores and split TF32 (three
    products at the TF32 peak)."""
    nbytes = (x.numel() + w.numel() + out.numel()) * x.element_size()
    ops = 2.0 * (x.numel() // w.shape[0]) * w.shape[0] * w.shape[1]
    dn = str(x.dtype).split(".")[1]
    t_ops = ops / PEAK[dn]
    if dn == "float32":
        t_ops = min(t_ops, 3 * ops / PEAK["tf32"])
    return nbytes / HBM_BPS * 1e3, t_ops * 1e3


def ssd_floor(x, la, B, C, dt, Q):
    """``t_bytes_ms``, ``t_ops_ms`` and ``cuda_core_bound_ms`` of one SSD
    scan: x [Bt, L, H, P] and B, C [Bt, L, N] (or [Bt, L, G, N]) in their
    dtype, log_a and dt f32, read once, y written once.  The products the
    function needs, causal half only (Q(Q+1)/2 pairs j <= i): C B^T once per
    (b, chunk, group), as B and C are shared by a group's heads, at the inputs' type (bf16 products
    are exact in f32); scores xdt, C S and the state update per (b, h,
    chunk) in f32 (xdt and the decays are f32).  An f32-accurate product
    runs at the faster of the CUDA cores and split TF32 (three products at
    the TF32 peak; two for C S where C is bf16, exact in TF32); the
    CUDA-core-only figure is the bound that earlier versions of this script
    printed."""
    Bt, L, H, Pd = x.shape
    N, G = B.shape[-1], (B.shape[2] if B.dim() == 4 else 1)
    dn = str(x.dtype).split(".")[1]
    nbytes = (2 * x.numel() * x.element_size() + (B.numel() + C.numel()) * B.element_size()
              + (la.numel() + dt.numel()) * la.element_size())
    n_chunks = Bt * (L // Q)
    ops_cb = n_chunks * G * Q * (Q + 1) * N
    ops_cs = n_chunks * H * 2 * Q * N * Pd
    ops_f32 = n_chunks * H * (Q * (Q + 1) * Pd + 2 * Q * N * Pd) + ops_cs
    f32_s = min(1 / PEAK["float32"], 3 / PEAK["tf32"])
    cs_s = min(1 / PEAK["float32"], 2 / PEAK["tf32"]) if dn == "bfloat16" else f32_s
    t_bytes = nbytes / HBM_BPS * 1e3
    return dict(
        t_bytes_ms=t_bytes,
        t_ops_ms=(ops_cb * (1 / PEAK[dn] if dn == "bfloat16" else f32_s)
                  + (ops_f32 - ops_cs) * f32_s + ops_cs * cs_s) * 1e3,
        cuda_core_bound_ms=max(t_bytes, (ops_cb / PEAK[dn] + ops_f32 / PEAK["float32"]) * 1e3))


def ssd_bwd_floor(x, la, B, C, dt, Q):
    """``t_bytes_ms`` and ``t_ops_ms`` of one SSD backward (``csrc/ssd_scan_bwd.cu``):
    x, dy [Bt, L, H, P] and B, C in their dtype, log_a and dt f32 read once,
    the five gradients written once.  The products its algorithm needs, causal
    halves counted exactly (Q(Q+1)/2 pairs): C Bᵀ and, summed over a group's
    heads, dGm B and dGmᵀ C once per (b, chunk, group); per (b, h, chunk) the
    two chunk-local states, y recomputed (scores xdt and C S), dxdt (scoresᵀ
    dy and dS'ᵀ B), dy xdtᵀ, and the state terms of dC and dB.  As in
    :func:`ssd_floor`, an f32-accurate product takes the faster of the CUDA
    cores and split TF32: three products where both operands are f32 (the
    state of xdt, scores xdt, xdt dS'ᵀ), two where one is bf16 (exact in TF32)
    and the decay can be applied to the output; C Bᵀ of bf16 at its peak."""
    Bt, L, H, Pd = x.shape
    N, G = B.shape[-1], (B.shape[2] if B.dim() == 4 else 1)
    dn = str(x.dtype).split(".")[1]
    nbytes = (4 * x.numel() * x.element_size() + 2 * (B.numel() + C.numel()) * B.element_size()
              + 2 * (la.numel() + dt.numel()) * la.element_size())
    n_chunks = Bt * (L // Q)
    pairs, state = Q * (Q + 1), 2 * Q * N * Pd  # flops of a causal product over P or N; of a state
    ops_cb = n_chunks * G * pairs * N
    both_f32 = n_chunks * H * (2 * state + pairs * Pd)
    one_exact = n_chunks * (H * (4 * state + 2 * pairs * Pd) + G * 2 * pairs * N)
    f32_s = min(1 / PEAK["float32"], 3 / PEAK["tf32"])
    ex_s = min(1 / PEAK["float32"], 2 / PEAK["tf32"]) if dn == "bfloat16" else f32_s
    return dict(t_bytes_ms=nbytes / HBM_BPS * 1e3,
                t_ops_ms=(ops_cb * (1 / PEAK[dn] if dn == "bfloat16" else f32_s)
                          + both_f32 * f32_s + one_exact * ex_s) * 1e3)


def ssd_state_dropped(scan, x, la, B, C, dt, chunk):
    """A planted SSD fault: ``scan`` with the state dropped at every chunk
    boundary (no inter-chunk C S term), each chunk scanned as a row of its
    own."""
    n = x.shape[0] * (x.shape[1] // chunk)
    rows = [t.contiguous().reshape(n, chunk, *t.shape[2:]) for t in (x, la, B, C, dt)]
    return scan(*rows, chunk).reshape(x.shape)


def _trial_fields(t):
    """A TrialResult as JSON, without ``wall_s`` and the engine (NaN == NaN)."""
    d = dataclasses.asdict(t)
    d.pop("wall_s")
    d["spec"].pop("engine")
    return json.dumps(d, sort_keys=True)


def paper_method(torch, report):
    """Phase (v): Algorithm 1, the Terastal round and the campaign stack on the card."""
    import collections

    from repro_torch.core import (
        SATURATION_SCENARIOS, Campaign, SamplerConfig, engine_soa, make_scheduler,
        run_adaptive, scheduler_torch, simulate,
    )
    from repro_torch.core import campaign as campaign_mod
    from repro_torch.core.budget import distribute_budgets
    from repro_torch.core.budget_torch import (
        distribute_budgets_batch, distribute_budgets_torch, pack_levels,
    )
    from repro_torch.core.workload import SCENARIO_CATALOGS
    from repro_torch.costmodel.maestro import PLATFORMS

    out = report["paper"] = {}

    # 1. Algorithm 1: every model of every catalog scenario on its own
    # platforms, one call each, then each cell's models as one padded batch
    worst = [0.0]

    def check(feasible, rho, budgets, ref, what):
        if bool(feasible) != ref.feasible or rho.tolist() != ref.rho.tolist():
            fail(f"budgets of {what}: feasible/rho differ from the numpy reference")
        if ref.feasible:
            rel = float(np.max(np.abs(budgets.cpu().numpy() - ref.budgets) / ref.budgets))
            worst[0] = max(worst[0], rel)
            if rel > BUDGET_RTOL:
                fail(f"budgets of {what}: relative difference {rel:.3e} > {BUDGET_RTOL}")

    distribute_budgets_torch(*pack_levels(np.array([[2.0, 1.0]])), 1.5, device="cuda")
    single_s, batch_s, host_s, batch_m = [], [], [], []
    n_models = n_infeasible = 0
    biggest = None
    for cat, scenarios in SCENARIO_CATALOGS.items():
        for name, sc in scenarios.items():
            for plat in sc.platform_names:
                plans, _ = sc.plans(PLATFORMS[plat])
                models = [(p.lat, p.deadline) for p in plans]
                refs = []
                for m, (lat, dl) in enumerate(models):
                    t0 = time.perf_counter()
                    refs.append(distribute_budgets(lat, dl))
                    host_s.append(time.perf_counter() - t0)
                    packed, R = pack_levels(lat)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = distribute_budgets_torch(packed, R, dl, device="cuda")
                    res.rho.cpu()
                    single_s.append(time.perf_counter() - t0)
                    check(res.feasible, res.rho, res.budgets, refs[m], f"{name}@{plat} model {m}")
                    n_models += 1
                    n_infeasible += not refs[m].feasible
                    if biggest is None or lat.shape[0] > biggest[0].shape[0]:
                        biggest = (lat, dl)
                M, L = len(models), max(lat.shape[0] for lat, _ in models)
                r_max = max(int(pack_levels(lat)[1].max()) for lat, _ in models)
                levels_b = np.zeros((M, L, r_max))
                R_b = np.ones((M, L), np.int32)
                mask_b = np.zeros((M, L), bool)
                for m, (lat, _) in enumerate(models):
                    n = lat.shape[0]
                    levels_b[m, :n], R_b[m, :n] = pack_levels(lat, r_max)
                    mask_b[m, :n] = True
                deadlines = np.array([dl for _, dl in models])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = distribute_budgets_batch(levels_b, R_b, deadlines, mask_b, device="cuda")
                res.rho.cpu()
                batch_s.append(time.perf_counter() - t0)
                batch_m.append(M)
                for m, (lat, _) in enumerate(models):
                    n = lat.shape[0]
                    check(res.feasible[m], res.rho[m, :n], res.budgets[m, :n], refs[m],
                          f"{name}@{plat} model {m}, batched")
    big_packed, big_R = pack_levels(biggest[0])
    dev = device_activity(torch, lambda: distribute_budgets_torch(
        big_packed, big_R, biggest[1], device="cuda").rho.cpu())
    out["budget"] = b = dict(
        models=n_models, infeasible=n_infeasible, cells=len(batch_s), rtol=BUDGET_RTOL,
        max_rel_diff=worst[0], us_per_call=float(np.mean(single_s)) * 1e6,
        median_us_per_call=float(np.median(single_s)) * 1e6,
        batched_us_per_cell=float(np.mean(batch_s)) * 1e6, models_per_cell=float(np.mean(batch_m)),
        numpy_us_per_call=float(np.mean(host_s)) * 1e6, largest_layers=int(biggest[0].shape[0]),
        device_ops_largest=sum(n for n, _ in dev.values()),
    )
    say("[budget] {models} catalog models ({infeasible} infeasible) in {cells} cells: rho and "
        "feasible equal to numpy, budgets within rtol {rtol} (largest relative difference "
        "{max_rel_diff:.3e}); us per call {us_per_call:.1f} (median {median_us_per_call:.1f}), "
        "batched {batched_us_per_cell:.1f} per cell of {models_per_cell:.1f} models, numpy "
        "{numpy_us_per_call:.1f}; device ops of one call on the largest model ({largest_layers} "
        "layers): {device_ops_largest}".format(**b))

    # 2. the Terastal round: every block round of a saturation trial on the
    # device round (a CUDA graph per bucket), each backfill mode
    cell = ROUND_CELL
    plans, tasks = SATURATION_SCENARIOS[cell["scenario"]].plans(PLATFORMS[cell["platform"]])
    n_acc = plans[0].platform.n_acc
    seen = collections.Counter()
    states = {16: [], 64: []}
    recorded = engine_soa._jax_round

    def recording(B, now, busy, idle_mask, n_acc_, mode, device=None):
        bucket = scheduler_torch.bucket_nj(B.n)
        seen[bucket] += 1
        # states near the top of the bucket, spread over the trial
        if (bucket in states and mode == "ef" and len(states[bucket]) < 8
                and B.n > 3 * bucket // 4 and seen[bucket] % 7 == 0):
            states[bucket].append((B.clone(), now, list(busy), idle_mask))
        return recorded(B, now, busy, idle_mask, n_acc_, mode, device)

    say(f"[round] cut: duration {cell['duration']} s, seed 0")
    out["round_trials"] = []
    engine_soa._jax_round = recording
    try:
        for mode in MODES:
            sched = make_scheduler(f"terastal(backfill_mode={mode})")
            calls = scheduler_torch.terastal_round.calls
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = simulate(plans, tasks, cell["duration"], sched, seed=0, engine="soa",
                           round_kernel="jax", device="cuda")
            wall = time.perf_counter() - t0
            n_dev = scheduler_torch.terastal_round.calls - calls
            t0 = time.perf_counter()
            want = simulate(plans, tasks, cell["duration"], sched, seed=0, engine="soa",
                            round_kernel="python")
            py_wall = time.perf_counter() - t0
            if got.fingerprint() != want.fingerprint():
                fail(f"{cell['scenario']} {mode}: the device round's fingerprint != the python round's")
            line = dict(mode=mode, device_rounds=n_dev, rounds=got.rounds, wall_s=wall,
                        python_wall_s=py_wall, us_per_device_round=wall / max(n_dev, 1) * 1e6)
            out["round_trials"].append(line)
            say("[round] {s} @ {p} {d} s terastal({mode}): {device_rounds} device rounds of "
                "{rounds} rounds in {wall_s:.3f} s ({us_per_device_round:.1f} us a round, the "
                "trial's host work included); python round {python_wall_s:.3f} s; fingerprints "
                "equal".format(s=cell["scenario"], p=cell["platform"], d=cell["duration"], **line))
    finally:
        engine_soa._jax_round = recorded
    buckets = sorted(seen)
    say(f"[round] device rounds by NJ bucket: {dict(sorted(seen.items()))}")
    if max(buckets) < 64:
        fail(f"the device rounds reached NJ bucket {max(buckets)}, not 64")

    def stage(B, now, busy, idle_mask, device):
        n = B.n
        perm = np.argsort(B.rid_arr[:n])
        return scheduler_torch.pack_arrays(
            B.vdl_arr[:n][perm], B.vdl_next_arr[:n][perm], B.next_min_arr[:n][perm],
            B.lat_arr[:, :n].T[perm], B.latv_arr[:, :n].T[perm],
            np.array([b if b > now else now for b in busy]),
            np.array([bool(idle_mask >> k & 1) for k in range(n_acc)]), device=device)

    def per_call_us(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e6

    out["round_buckets"] = []
    for bucket, sts in states.items():
        if not sts:
            fail(f"no device round was recorded in the NJ-{bucket} bucket")
        for B, now, busy, idle_mask in sts:
            n_idle = bin(idle_mask).count("1")
            ref = engine_soa._kern_terastal(B, now, busy, idle_mask, n_idle, "ef")
            if engine_soa._jax_round(B, now, busy, idle_mask, n_acc, "ef", "cuda") != ref:
                fail(f"NJ {B.n}: the device round's assignments != the python round's")
            inp = stage(B, now, busy, idle_mask, "cuda")
            graph = [t.cpu() for t in scheduler_torch.terastal_round(inp, mode="ef")]
            eager = [t.cpu() for t in scheduler_torch._round(inp, "ef")]
            host = scheduler_torch._round(stage(B, now, busy, idle_mask, "cpu"), "ef")
            if not all(torch.equal(a, b) and torch.equal(a, c)
                       for a, b, c in zip(graph, eager, host)):
                fail(f"NJ {B.n}: graph replay, eager card and host rounds differ")
        k = len(sts)
        args = [(B, now, busy, idle_mask, bin(idle_mask).count("1")) for B, now, busy, idle_mask in sts]
        inps = [stage(B, now, busy, idle_mask, "cuda") for B, now, busy, idle_mask, _ in args]
        dev = device_activity(torch, lambda: [engine_soa._jax_round(
            B, now, busy, idle_mask, n_acc, "ef", "cuda") for B, now, busy, idle_mask, _ in args])
        line = dict(
            bucket=bucket, states=k, nj=[B.n for B, *_ in args],
            device_round_us=per_call_us(lambda: [engine_soa._jax_round(
                B, now, busy, idle_mask, n_acc, "ef", "cuda")
                for B, now, busy, idle_mask, _ in args], 25) / k,
            eager_card_round_us=per_call_us(lambda: [scheduler_torch.device_get(
                scheduler_torch._round(inp, "ef")) for inp in inps], 3) / k,
            host_vec_round_us=per_call_us(lambda: [engine_soa._kern_terastal_vec(
                B, now, busy, idle_mask, n_idle, "ef") for B, now, busy, idle_mask, n_idle in args],
                200) / k,
            host_scalar_round_us=per_call_us(lambda: [engine_soa._kern_terastal(
                B, now, busy, idle_mask, n_idle, "ef") for B, now, busy, idle_mask, n_idle in args],
                200) / k,
            device_ops_per_round=sum(n for n, _ in dev.values()) / k,
            device_us_per_round=sum(ms for _, ms in dev.values()) / k * 1e3,
        )
        out["round_buckets"].append(line)
        say("[round] NJ-{bucket} bucket ({states} states, NJ {nj}): device round {device_round_us:.1f} "
            "us (staging, graph replay and fetch), eager on the card {eager_card_round_us:.1f} us, "
            "host vectorized round {host_vec_round_us:.1f} us, host scalar round "
            "{host_scalar_round_us:.1f} us; {device_ops_per_round:.1f} device ops and "
            "{device_us_per_round:.1f} us of device time a round; graph, eager and host outputs "
            "equal".format(**line))

    # 3. the campaign stack: Campaign.run on the batched engine for each cell
    # of PERF.md section 4, held field for field against the host soa grid
    out["campaigns"] = []
    for label, scen, plat, arrival, dur in CAMPAIGN_CELLS:
        if dur != 0.1:
            say(f"[campaign] ({label}) cut: duration {dur} s (from 0.1 s)")
        say(f"[campaign] ({label}) cut: seeds 0-7")
        camp = Campaign(scenarios=(scen,), platforms=(plat,), schedulers=SCHEDULERS,
                        arrivals=(arrival,), seeds=tuple(range(8)), duration=dur, engine="batch")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = camp.run(device="cuda")
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = dataclasses.replace(camp, engine="soa").run(parallel=False)
        host_wall = time.perf_counter() - t0
        if [_trial_fields(t) for t in res.trials] != [_trial_fields(t) for t in host.trials]:
            fail(f"campaign ({label}): batch results != the host soa grid's")
        line = dict(cell=label, scenario=scen, platform=plat, arrival=arrival, duration=dur,
                    trials=len(res.trials), wall_s=wall, trials_per_s=len(res.trials) / wall,
                    host_soa_wall_s=host_wall,
                    released=sum(t.released for t in res.trials),
                    variants_applied=sum(t.variants_applied for t in res.trials))
        out["campaigns"].append(line)
        say("[campaign] ({cell}) {scenario} @ {platform} {arrival} {duration} s, 4 schedulers x 8 "
            "seeds, engine=batch: {trials} trials in {wall_s:.3f} s = {trials_per_s:.3f} trials/s "
            "(host soa grid {host_soa_wall_s:.3f} s); {released} requests released, {variants_applied} "
            "variants applied; every result equal to the host soa grid's".format(**line))

    # the sequential sampler with a journal on the batched engine, then
    # resumed from the journal with nothing run again
    journal = ROOT / "chiprun_out" / "sampler_journal.jsonl"
    journal.parent.mkdir(exist_ok=True)
    journal.unlink(missing_ok=True)
    label, scen, plat, arrival, dur = ADAPTIVE_CELL
    say(f"[campaign] run_adaptive cut: duration {dur} s")
    say("[campaign] run_adaptive cut: seeds 0-3, edf and terastal")
    camp = Campaign(scenarios=(scen,), platforms=(plat,), schedulers=("edf", "terastal"),
                    arrivals=(arrival,), seeds=(0, 1, 2, 3), duration=dur, engine="batch")
    cfg = SamplerConfig(min_seeds=2)
    t0 = time.perf_counter()
    ad = run_adaptive(camp, cfg, journal=str(journal), device="cuda")
    wall = time.perf_counter() - t0
    host = run_adaptive(dataclasses.replace(camp, engine="soa"), cfg, parallel=False)
    if ([_trial_fields(t) for t in ad.trials] != [_trial_fields(t) for t in host.trials]
            or [v.winner for v in ad.verdicts] != [v.winner for v in host.verdicts]):
        fail("run_adaptive on the batched engine != the host soa sampler")
    batch_fn = campaign_mod.run_trial_batch

    def no_rerun(*args, **kwargs):
        fail("run_adaptive re-ran a trial that its journal holds")

    campaign_mod.run_trial_batch = no_rerun
    try:
        again = run_adaptive(camp, cfg, journal=str(journal), device="cuda")
    finally:
        campaign_mod.run_trial_batch = batch_fn
    if [_trial_fields(t) for t in again.trials] != [_trial_fields(t) for t in ad.trials]:
        fail("run_adaptive resumed from its journal gave other results")
    out["adaptive"] = a = dict(cell=label, scenario=scen, platform=plat, duration=dur,
                               trials=len(ad.trials), rounds=ad.rounds, cap=ad.n_trials_cap,
                               wall_s=wall, verdicts=[v.winner for v in ad.verdicts])
    say("[campaign] run_adaptive ({cell}) {scenario} @ {platform} {duration} s, edf vs terastal, "
        "seeds 0-3, engine=batch, journal: {trials} of {cap} trials in {rounds} looks, {wall_s:.3f} s, "
        "verdicts {verdicts}; equal to the host soa sampler; resumed from the journal with no "
        "trial run again".format(**a))


def fault_lane(torch, report):
    """Phase (vi): the batched engine's fault lane on the card, through the
    campaign stack, each cell held against the host soa grid."""
    from repro_torch.core import SCENARIOS, Campaign, engine_batch, make_scheduler
    from repro_torch.costmodel.maestro import PLATFORMS

    out = report["faults"] = {"cells": []}
    real = engine_batch.simulate_batch
    calls = []

    def recording(plans, tasks, duration, scheduler, seeds, **kwargs):
        stats = kwargs.setdefault("stats", {})
        t0 = time.perf_counter()
        res = real(plans, tasks, duration, scheduler, seeds, **kwargs)
        calls.append(dict(scheduler=scheduler.name, faults=str(kwargs.get("faults")),
                          seeds=len(seeds), wall_s=time.perf_counter() - t0, **stats))
        return res

    for cell in FAULT_CELLS:
        seeds = tuple(range(cell["seeds"]))
        say(f"[faults] ({cell['label']}) cut: seeds 0-{seeds[-1]}"
            f" (from 0-{cell['seeds_from'] - 1})")
        if "cut" in cell:
            say(f"[faults] ({cell['label']}) cut: " + cell["cut"].format(**cell))
        camp = Campaign(scenarios=(cell["scenario"],), platforms=(cell["platform"],),
                        schedulers=cell["schedulers"], faults=cell["faults"], seeds=seeds,
                        duration=cell["duration"], engine="batch")
        calls.clear()
        engine_batch.simulate_batch = recording
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = camp.run(device="cuda")
            wall = time.perf_counter() - t0
        finally:
            engine_batch.simulate_batch = real
        t0 = time.perf_counter()
        host = dataclasses.replace(camp, engine="soa").run(parallel=False)
        host_wall = time.perf_counter() - t0
        if [_trial_fields(t) for t in res.trials] != [_trial_fields(t) for t in host.trials]:
            fail(f"faults ({cell['label']}): batch results != the host soa grid's")
        if len(calls) != len(cell["schedulers"]) * len(cell["faults"]):
            fail(f"faults ({cell['label']}): {len(calls)} engine calls for "
                 f"{len(cell['schedulers']) * len(cell['faults'])} seed groups")
        line = dict(cell=cell["label"], scenario=cell["scenario"], platform=cell["platform"],
                    duration=cell["duration"], trials=len(res.trials), wall_s=wall,
                    trials_per_s=len(res.trials) / wall, host_soa_wall_s=host_wall,
                    evicted=sum(t.evicted for t in res.trials),
                    remapped=sum(t.remapped for t in res.trials), groups=[])
        for c in calls:
            c.update(trials_per_s=c["seeds"] / c["wall_s"],
                     us_per_iteration=c["wall_s"] / c["iterations"] * 1e6)
            line["groups"].append(c)
            say("[faults] ({cell}) {scheduler} faults={faults}: {seeds} seeds in {wall_s:.3f} s = "
                "{trials_per_s:.3f} trials/s; {iterations} iterations (bound {max_it}), "
                "{us_per_iteration:.1f} us an iteration; evictions {evictions}, re-timings "
                "{retimings}, ghost pops {ghost_pops}, variants undone {variant_undos}".format(
                    cell=cell["label"], **c))
        out["cells"].append(line)
        say("[faults] ({cell}) {scenario} @ {platform} {duration} s, engine=batch: {trials} trials "
            "in {wall_s:.3f} s = {trials_per_s:.3f} trials/s (host soa grid {host_soa_wall_s:.3f} s); "
            "{evicted} layers evicted, {remapped} remapped; every result equal to the host soa "
            "grid's".format(**line))

    # the fault lane's price on one host pace: (f)'s terastal cell, faulted
    # (the down spec) against fault-free, from this call
    (free,) = [c for c in out["cells"][1]["groups"]]
    (down,) = [c for c in out["cells"][0]["groups"]
               if c["scheduler"] == "terastal" and c["faults"] == FAULT_SPECS[0]]
    out["us_ratio"] = down["us_per_iteration"] / free["us_per_iteration"]
    say(f"[faults] (f) terastal, us an iteration faulted ({FAULT_SPECS[0]}) / fault-free: "
        f"{down['us_per_iteration']:.1f} / {free['us_per_iteration']:.1f} = {out['us_ratio']:.3f}")

    prof = FAULT_PROFILE
    plans, tasks = SCENARIOS["multicam_heavy"].plans(PLATFORMS["6k_1ws2os"])
    seeds = list(range(prof["seeds"]))
    out["profile"] = {}
    for label, spec in (("faulted", prof["spec"]), ("fault-free", "none")):
        stats = {}
        dev = device_activity(torch, lambda: engine_batch.simulate_batch(
            plans, tasks, prof["duration"], make_scheduler("terastal"), seeds, faults=spec,
            device="cuda", stats=stats))
        n_dev = sum(n for n, _ in dev.values())
        out["profile"][label] = p = dict(
            faults=spec, iterations=stats["iterations"], device_ops=n_dev,
            device_ops_per_iteration=n_dev / stats["iterations"],
            device_us_per_iteration=sum(ms for _, ms in dev.values()) / stats["iterations"] * 1e3)
        if n_dev:
            say("[faults] device ops ({label}, terastal, {n} seeds, {d} s, faults={faults}): "
                "{device_ops} over {iterations} iterations = {device_ops_per_iteration:.1f} an "
                "iteration, {device_us_per_iteration:.1f} us of device time an iteration".format(
                    label=label, n=prof["seeds"], d=prof["duration"], **p))
        else:
            say(f"[faults] device ops ({label}): not measured "
                "(torch.profiler recorded no device activity)")
    f, g = out["profile"]["faulted"], out["profile"]["fault-free"]
    if f["device_ops"] and g["device_ops"]:
        out["ops_ratio"] = f["device_ops_per_iteration"] / g["device_ops_per_iteration"]
        say(f"[faults] device ops an iteration faulted / fault-free: {out['ops_ratio']:.3f}")


def _max_rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _row_rel(got, ref):
    """Max over the output rows (the last dim is the head dim) of
    max|d_row| / max|ref_row|."""
    d = (got.float() - ref.float()).abs().amax(-1)
    return (d / ref.float().abs().amax(-1).clamp_min(1e-30)).max().item()


def _attention_bound(q, k, causal):
    """(ms, what bounds it) of one attention call at the card's peak: the
    products of the (query, key) pairs it computes (each query's keys up to
    its own position where causal) at the dtype's tensor rate, or q, k, v
    and the output read and written once at the HBM rate."""
    B, Lq, H, Dh = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    pairs = Lq * Lk
    if causal:
        seen = min(Lq, Lk)
        pairs = seen * (seen + 1) // 2 + (Lq - seen) * Lk
    flops = 4 * B * H * Dh * pairs
    nbytes = (2 * B * Lq * H + 2 * B * Lk * Hkv) * Dh * q.element_size()
    return bound(nbytes / HBM_BPS * 1e3, flops / PEAK[str(q.dtype).split(".")[1]] * 1e3)


def _plain_attention(q, k, v, kw):
    """``common.flash_attention(q, k, v, **kw)``'s plain route,
    ``common._flash_attention``, with the same defaults, on the card."""
    from repro_torch.models import common

    call = inspect.signature(common.flash_attention).bind(q, k, v, **kw)
    call.apply_defaults()
    return common._flash_attention(*call.arguments.values())


def _prefill_where(torch, model, params, batch_in, mods=None, positions=None):
    """A timed prefill (ms, peak memory), then one under torch.profiler that
    keeps every flash_attention call's inputs (and every ``moe_ffn_apply``
    call's, whose calls are then replayed alone under the profiler);
    attention's share is the flash kernels' device time in the prefill's
    own trace, read where that trace holds each launch once (a replay of
    the flash launches alone lost its records: PERF.md section 7); every
    kept attention call through the flash kernel held to the plain route
    on its own inputs (``_row_rel`` within ``FLASH_TOL``), and the first
    call's inputs timed through the kernel, the plain route and
    ``scaled_dot_product_attention`` (a yardstick the port never calls)
    beside the call's bound.  ``mods``: the modules whose
    ``flash_attention`` the prefill calls (``transformer`` when None);
    ``positions``: prompt positions a row (the tokens' count when None)."""
    from repro_torch.models import moe, transformer

    mods = mods or (transformer,)
    flash = transformer.flash_attention
    ffn = moe.moe_ffn_apply
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(params, batch_in)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    calls, ffn_calls = [], []

    def keep(q, k, v, **kw):
        calls.append((q, k, v, kw))
        return flash(q, k, v, **kw)

    def keep_ffn(cfg, p, x):
        ffn_calls.append((cfg, p, x))
        return ffn(cfg, p, x)

    dev = device_activity(torch, lambda: _with_patches(
        [(m, "flash_attention", keep) for m in mods] + [(moe, "moe_ffn_apply", keep_ffn)],
        lambda: model.prefill(params, batch_in)))
    moe_dev = device_activity(torch, lambda: [ffn(*c) for c in ffn_calls]) if ffn_calls else {}
    held = max(_row_rel(flash(q, k, v, **kw), _plain_attention(q, k, v, kw))
               for q, k, v, kw in calls)
    q, k, v, kw = calls[0]
    shape = [list(t.shape) for t in (q, k, v)]
    bound_ms, bound_by = _attention_bound(q, k, kw.get("causal", True))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flash_ms = event_ms(torch, lambda: flash(q, k, v, **kw))
    plain_ms = event_ms(torch, lambda: _plain_attention(q, k, v, kw), reps=2)
    sdpa_ms = event_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=kw.get("causal", True),
                                           scale=kw.get("scale"), enable_gqa=True))
    sites, moe_sites = len(calls), len(ffn_calls)
    del calls, ffn_calls, q, k, v, qt, kt, vt
    in_trace = sum(n for name, (n, _) in dev.items() if "flash_fwd" in name)
    attn_ms = (sum(ms for name, (_, ms) in dev.items() if "flash_fwd" in name)
               if in_trace == sites else None)
    dev_ms = sum(ms for _, ms in dev.values())
    n_dev = sum(n for n, _ in dev.values())
    moe_ms = sum(ms for _, ms in moe_dev.values())
    ssd_ms = sum(ms for name, (_, ms) in dev.items() if "ssd_scan" in name)
    top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:6]
    B, L = batch_in["tokens"].shape
    positions = positions or L
    if not held <= FLASH_TOL:
        fail(f"a prefill attention call through the flash kernel reads {held:.3e} of a row's "
             f"max|ref| from the plain route (limit {FLASH_TOL:.3e})")
    return dict(
        wall_s=wall, ms_per_prefill=wall * 1e3, prompt_positions=positions,
        prompt_tokens_per_s=B * positions / wall,
        peak_mem_gb=peak, device_ms=dev_ms, device_ops=n_dev,
        device_busy_share=dev_ms / (wall * 1e3) if n_dev else None,
        ssd_scan_ms=ssd_ms, ssd_scan_share=ssd_ms / dev_ms if n_dev else None,
        attention_sites=sites, flash_in_trace=in_trace, attention_ms=attn_ms,
        attention_share=attn_ms / dev_ms if n_dev and attn_ms is not None else None,
        moe_sites=moe_sites, moe_ms=moe_ms, moe_share=moe_ms / dev_ms if n_dev else None,
        attention_qkv_shapes=shape, attention_held_row_rel=held,
        flash_ms_per_call=flash_ms, plain_ms_per_call=plain_ms, sdpa_ms_per_call=sdpa_ms,
        flash_bound_ms=bound_ms, flash_bound_by=bound_by,
        top_device=[dict(name=k, ops=n, ms=ms) for k, (n, ms) in top],
    )


def _say_where(label, line):
    if line["device_ops"]:
        attention = ("{attention_ms:.3f} ms = {attention_share:.4f} of device time".format(**line)
                     if line["attention_ms"] is not None else
                     "not measured (the trace holds {flash_in_trace} of the {attention_sites} "
                     "launches)".format(**line))
        say(f"[where] {label}: device busy {{device_ms:.3f}} ms = {{device_busy_share:.4f}} of the "
            "wall; {device_ops} device ops; ssd_scan {ssd_scan_ms:.3f} ms = {ssd_scan_share:.4f} "
            "of device time; attention (the {attention_sites} flash_attention calls' kernels "
            f"in the trace) {attention}; one call: flash "
            "kernel {flash_ms_per_call:.3f} ms against a bound of {flash_bound_ms:.3f} ms "
            "({flash_bound_by}), the plain route {plain_ms_per_call:.3f} ms, "
            "scaled_dot_product_attention on the same inputs {sdpa_ms_per_call:.3f} ms; every "
            "call held to the plain route: max over rows of max|d|/max|ref| "
            "{attention_held_row_rel:.3e}"
            .format(**line)
            + ("; MoE ({moe_sites} moe_ffn_apply calls, replayed alone) {moe_ms:.3f} ms = "
               "{moe_share:.4f} of device time".format(**line) if line["moe_sites"] else ""))
        for d in line["top_device"]:
            say(f"[where]   {d['ms']:.3f} ms in {d['ops']} x {d['name'][:100]}")
    else:
        say(f"[where] {label}: device time not measured "
            "(torch.profiler recorded no device activity)")


def _kernels():
    """The launch-counted wrappers of the port's kernels (the Mamba passes'
    count block calls, three launches each)."""
    from repro_torch.kernels.decode_attn.kernel import decode_attn_cuda
    from repro_torch.kernels.flash_attn.kernel import flash_attn_cuda
    from repro_torch.kernels.mamba_passes.kernel import mamba_passes_cuda
    from repro_torch.kernels.s2d_conv.kernel import s2d_conv_cuda
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda

    return dict(s2d_conv=s2d_conv_cuda, decode_attn=decode_attn_cuda, ssd_scan=ssd_scan_cuda,
                mamba_passes=mamba_passes_cuda, flash_attn=flash_attn_cuda)


def _attention_sites(cfg):
    """``flash_attention`` calls a prefill of ``cfg`` makes: one a layer
    (dense, vlm, moe), one a shared-block site (hybrid, zamba2), one an
    attention layer of the pattern (nemotron_h), the encoder's layers once
    and the decoder's twice, self and cross (encdec)."""
    if cfg.family == "nemotron_h":
        return cfg.layer_pattern.count("*")
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_every
    if cfg.family == "zamba2":
        return cfg.n_sites
    if cfg.family == "encdec":
        return cfg.n_encoder_layers + 2 * cfg.n_layers
    return 0 if cfg.family == "ssm" else cfg.n_layers


def _prefill_counts(cfg, ssd=0, passes=0):
    """The launch counts a prefill of ``cfg`` must read: its attention sites'
    flash kernel, ``ssd`` SSD-kernel launches, ``passes`` pass-kernel block
    calls, and nothing else."""
    return dict(s2d_conv=0, decode_attn=0, ssd_scan=ssd, mamba_passes=passes,
                flash_attn=_attention_sites(cfg))


def _flash_launches(tree):
    """The flash kernel's launches in every counted path of the report
    (each ``launches`` dict's ``flash_attn``)."""
    if isinstance(tree, list):
        return sum(_flash_launches(t) for t in tree)
    if not isinstance(tree, dict):
        return 0
    own = tree.get("launches")
    return (own.get("flash_attn", 0) if isinstance(own, dict) else 0) + sum(
        _flash_launches(t) for key, t in tree.items() if key != "launches")


def _zero_counts(torch):
    for k in _kernels().values():
        k.launches = 0
    torch.cuda.synchronize()


def _counts():
    return {name: k.launches for name, k in _kernels().items()}


def _with_patch(mod, name, fn, call):
    """``call()`` with ``mod.name`` replaced by ``fn``."""
    return _with_patches([(mod, name, fn)], call)


def _with_patches(patches, call):
    """``call()`` with each ``(mod, name, fn)``'s ``mod.name`` replaced by ``fn``."""
    kept = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        return call()
    finally:
        for mod, name, fn in reversed(kept):
            setattr(mod, name, fn)


def _f32_twin(torch, cfg, **over):
    """The model in f32 with the weights of the same seed (the bf16 weights
    before their rounding), or of a config changed by ``over``."""
    from repro_torch.models.model_api import build_model

    m = build_model(dataclasses.replace(cfg, dtype="float32", **over), "cuda")
    return m, m.init(torch.Generator(device="cuda").manual_seed(0))


def _cross_path(torch, m, p, prompt, seed, extra=None, cache=None):
    """The JAX package's cross-path check: ``prompt`` tokens through
    decode_step one by one against prefill (given ``extra`` inputs: whisper's
    frames, whose cross K/V the caller wrote into ``cache``); (max rel, rms
    rel, excess over rtol |ref|, decode-kernel launches)."""
    dec = _kernels()["decode_attn"]
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, m.cfg.vocab_size, (1, prompt), dtype=np.int64)).cuda()
    pre = m.prefill(p, {"tokens": toks, **(extra or {})})
    before = dec.launches
    cache = m.init_cache(1, prompt) if cache is None else cache
    for i in range(prompt):
        step, cache = m.decode_step(p, toks[:, i], cache, i)
    if not bool(torch.isfinite(step).all()):
        fail(f"{m.cfg.name} f32 decode produced non-finite logits")
    c_max, c_rms, _ = logits_gap(step, pre)
    excess = ((step - pre).abs() - CROSS_TOL["rtol"] * pre.abs()).max().item()
    return c_max, c_rms, excess, dec.launches - before


# (iii.b) the Mamba block's pass kernels: (arch, B, L) of the prefill cell,
# zamba2-2.7b's prefill, zamba2-7b's (two B/C groups) and nemotron-3-nano-30b-a3b's
# (eight B/C groups, d_inner 4096 from 64 heads of 64; the port-only lookup), bf16,
# one block at the published widths (seed 0)
PASS_CELLS = [("mamba2-1.3b", 64, 4096), ("zamba2-2.7b", 8, 4096), ("zamba2-7b", 8, 4096),
              ("nemotron-3-nano-30b-a3b", 8, 4096)]
PASS_ULPS = 4  # each kernel vs the plain pass on its inputs: tests/test_torch_cuda.py's limit
# (iii.b) the passes' backward: (arch, B, L) of (p)'s training step, and
# zamba2-7b's block (two B/C groups) at the same B and L, bf16, seed 0
PASS_BWD_CELLS = [("mamba2-1.3b", 8, 2048), ("zamba2-7b", 8, 2048)]


def _bf16_ulps(got, want):
    """max|got - want| in bf16 ulps of max|want|: 2^(e - 7), e its binade."""
    m = want.float().abs().max().item()
    return (got.float() - want.float()).abs().max().item() / 2.0 ** (math.floor(math.log2(m)) - 7)


def ssd_scan_rows(torch, rng):
    """Phase 3's SSD rows: the kernel against ``ssd_chunked`` on the same
    inputs at every ``SSD_SHAPES`` entry (B and C shared by the heads) and
    every ``SSD_GROUPED_SHAPES`` entry (B and C in G groups), in f32 and
    bf16, each held to ``SSD_TOL`` and timed beside the plain version and
    its floor; at a prefill path's shape, the device kernels of a call."""
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    ssd_rows = []
    for Bt, L, H, Pd, N, Q, G in [s + (1,) for s in SSD_SHAPES] + SSD_GROUPED_SHAPES:
        prefill_shape = (Bt, L, H, Pd, N, Q) in SSD_PATHS
        bc = (Bt, L, N) if G == 1 else (Bt, L, G, N)
        f32 = np.float32
        x32, la, B32, C32, dt = (torch.from_numpy(np.ascontiguousarray(a, dtype=f32)).cuda() for a in (
            rng.standard_normal((Bt, L, H, Pd), dtype=f32),
            -np.abs(rng.standard_normal((Bt, L, H), dtype=f32)) * 0.3,
            rng.standard_normal(bc, dtype=f32), rng.standard_normal(bc, dtype=f32),
            np.logaddexp(rng.standard_normal((Bt, L, H), dtype=f32), f32(0))))
        for dtype in (torch.float32, torch.bfloat16):
            # x, B, C in the dtype; log_a and dt f32, as the model feeds them
            x, B, C = x32.to(dtype), B32.to(dtype), C32.to(dtype)
            got = ssd_kernel.ssd_scan_cuda(x, la, B, C, dt, Q)
            ref = ssd_chunked(x, la, B, C, dt, Q)
            torch.cuda.synchronize()
            if got.shape != ref.shape or not bool(torch.isfinite(got.float()).all()):
                fail(f"ssd_scan {(Bt, L, H, Pd, N, Q, G)} {dtype}: bad output")
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            dn = str(dtype).split(".")[1]
            tol = SSD_TOL[dn + ("@prefill" if prefill_shape and dn == "float32" else "")] * scale
            ok = err <= tol
            reps = 5 if prefill_shape else 50
            row = dict(
                shape=f"Bt{Bt}.L{L}.H{H}.P{Pd}.N{N}.Q{Q}" + (f".G{G}" if G > 1 else ""),
                Bt=Bt, L=L, H=H, P=Pd, N=N, Q=Q, G=G,
                dtype=dn, max_abs_err=err, max_abs_ref=scale, tol=tol, ok=ok,
                kernel_ms=graph_ms(torch, lambda: ssd_kernel.ssd_scan_cuda(x, la, B, C, dt, Q),
                                   reps),
                plain_ms=(event_ms(torch, lambda: ssd_chunked(x, la, B, C, dt, Q))
                          if prefill_shape else
                          graph_ms(torch, lambda: ssd_chunked(x, la, B, C, dt, Q))),
                library_ms=None,  # no single PyTorch call computes the SSD scan
                call_ms=paced_ms(torch, lambda: ssd_scan(x, la, B, C, dt, Q), reps, 1),
            )
            row.update(ssd_floor(x, la, B, C, dt, Q))
            row["bound_ms"], row["bound_by"] = bound(row["t_bytes_ms"], row["t_ops_ms"])
            row["path"] = SSD_PATHS.get((Bt, L, H, Pd, N, Q))
            ssd_rows.append(row)
            say("[kernel] ssd_scan {shape} {dtype} max_abs_err={max_abs_err:.3e} tol={tol:.3e} "
                "kernel_ms={kernel_ms:.5f} plain_ms={plain_ms:.5f} library_ms=None "
                "bound_ms={bound_ms:.5f} ({bound_by}) cuda_core_bound_ms={cuda_core_bound_ms:.5f} "
                "call_ms={call_ms:.5f} ok={ok}".format(**row))
            if not ok:
                fail(f"ssd_scan {row['shape']} {dn}: max|d| {err} > tol {tol}")
            if prefill_shape:
                # the device kernels of a call (C B^T, then the scan), over four calls:
                # the profiler may drop a window's first events, so each kernel must be
                # recorded in three or four of them, and is timed by its mean
                calls = 4
                dev = device_activity(torch, lambda: [
                    ssd_kernel.ssd_scan_cuda(x, la, B, C, dt, Q) for _ in range(calls)])
                row["device_kernels_per_call"] = len(dev)
                row["device_launches_by_kernel"] = {k: n for k, (n, _) in dev.items()}
                row["device_ms_by_kernel"] = {k: ms / n for k, (n, ms) in dev.items()}
                say(f"[plan] ssd_scan {row['shape']} {dn}: device kernels per call "
                    f"{row['device_kernels_per_call']}: " + "; ".join(
                        f"{k[:70]} {ms:.5f} ms ({dev[k][0]} of {calls} calls recorded)"
                        for k, ms in row["device_ms_by_kernel"].items()))
                if len(dev) != 2 or any(not calls - 1 <= n <= calls for n, _ in dev.values()):
                    fail(f"{calls} ssd_scan calls ran device kernels {dev}, not 2 a call")
        del x32, la, B32, C32, dt, x, B, C, got, ref
    say(f"[kernel] {len(ssd_rows)} ssd_scan comparisons within tolerance; "
        f"launches while comparing = {ssd_kernel.ssd_scan_cuda.launches}")
    return ssd_rows


def mamba_passes_row(torch, report):
    """Phase (iii.b): the Mamba pass kernels at ``PASS_CELLS``: each held
    to the plain pass on the plain block's own intermediates, timed beside
    its byte floor, the plain passes and ``F.rms_norm``; the router's
    counter read with grad off and under autograd; the block's SSD kernel
    call timed on its own inputs."""
    import torch.nn.functional as F

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.configs.port_only import get_port_config
    from repro_torch.kernels.mamba_passes import kernel as mp
    from repro_torch.kernels.mamba_passes import ops, ref
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.models.common import linear
    from repro_torch.models.mamba2 import init_mamba_block
    from repro_torch.tree import tree_map

    rows = report["mamba_passes"] = []
    for arch, B, L in PASS_CELLS:
        cfg = dataclasses.replace((get_config if arch in ARCHS else get_port_config)(arch),
                                  n_layers=1)
        G = ref.ssm_groups(cfg)
        gen = torch.Generator(device="cuda").manual_seed(0)
        p = init_mamba_block(gen, cfg, torch.bfloat16)
        x = torch.randn((B, L, cfg.d_model), generator=gen, device="cuda").bfloat16()
        H, Pd, eps = cfg.ssm_nheads, cfg.ssm_headdim, cfg.norm_eps
        seen, conv = [], []

        def spy(w, t):
            o = linear(w, t)
            seen.append((t, o))
            return o

        def scan(xh, la, Bm, Cm, dt, chunk):
            y = ssd_scan(xh, la, Bm, Cm, dt, chunk)
            conv.extend([xh.reshape(B, L, -1).contiguous(), Bm, Cm, dt, la, y])
            return y

        with torch.no_grad():
            _with_patch(ref, "linear", spy, lambda: ref.mamba_passes(cfg, p, x, scan))
            (h, zx), (g, _) = seen
            y = conv[5]
            conv_args = (p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"], cfg.d_inner,
                         cfg.ssm_state, H, G)
            gate_args = (p["D"], p["out_norm"]["scale"], eps, Pd, G)
            got_conv = mp.conv_silu_cuda(zx, *conv_args)
            ulps = dict(norm=_bf16_ulps(mp.rmsnorm_cuda(x, p["norm"]["scale"], eps), h),
                        conv=max(_bf16_ulps(a, b) for a, b in zip(got_conv[:3], conv[:3])),
                        gate_norm=_bf16_ulps(mp.gate_norm_cuda(y, conv[0], zx, *gate_args), g))
            f32_rel = max(((a - b).abs().max() / b.abs().max()).item()
                          for a, b in zip(got_conv[3:], conv[3:5]))
            del got_conv
            calls = dict(
                norm=lambda: mp.rmsnorm_cuda(x, p["norm"]["scale"], eps),
                conv=lambda: mp.conv_silu_cuda(zx, *conv_args),
                gate_norm=lambda: mp.gate_norm_cuda(y, conv[0], zx, *gate_args),
                add=lambda: x + h,  # the residual add: two reads and a write of [B, L, d_model]
            )
            ms = {k: event_ms(torch, fn, reps=10, warm=2) for k, fn in calls.items()}
            scan_in = tuple(t.contiguous() for t in (conv[0].view(B, L, H, Pd), conv[4], conv[1],
                                                     conv[2], conv[3]))
            scan_ms = event_ms(torch, lambda: ssd_scan(*scan_in, cfg.ssm_chunk), reps=5)
            proj_ms = (event_ms(torch, lambda: linear(p["in_proj"], h), reps=5)
                       + event_ms(torch, lambda: linear(p["out_proj"], g), reps=5))
            plain_ms = event_ms(torch, lambda: ref.mamba_passes(cfg, p, x, lambda *a: y)) - proj_ms
            library_ms = event_ms(torch, lambda: F.rms_norm(
                x, (cfg.d_model,), p["norm"]["scale"].bfloat16(), eps), reps=10, warm=2)
            before = mp.mamba_passes_cuda.launches
            ops.mamba_passes(cfg, p, x, ssd_scan)
            launched = mp.mamba_passes_cuda.launches - before
        del seen, conv, h, zx, g, y
        pg = tree_map(lambda t: t.detach().clone().requires_grad_(True), p)
        before = (mp.mamba_passes_cuda.launches, mp.mamba_passes_cuda.backward_calls)
        out = ops.mamba_passes(cfg, pg, x[:1, :cfg.ssm_chunk], ssd_scan)
        under_grad = mp.mamba_passes_cuda.launches - before[0]
        out.float().sum().backward()
        backwards = mp.mamba_passes_cuda.backward_calls - before[1]
        del out
        floor = {k: v / HBM_BPS * 1e3 for k, v in mp.floor_bytes(cfg, B * L, 2).items()}
        row = dict(arch=arch, B=B, L=L, groups=G, scan_ms=scan_ms, dtype="bfloat16",
                   max_ulps=max(ulps.values()),
                   ulps=ulps, f32_max_rel=f32_rel, launches=launched, launches_under_grad=under_grad,
                   backward_calls=backwards,
                   **{f"{k}_ms": v for k, v in ms.items()},
                   **{f"{k}_bound_ms": v for k, v in floor.items()},
                   passes_ms=sum(ms.values()), bound_ms=sum(floor.values()),
                   plain_ms=plain_ms, library_norm_ms=library_ms)
        rows.append(row)
        say("[passes] {arch} B={B} L={L} G={groups} bf16: SSD call {scan_ms:.4f} ms; "
            .format(**row) + ", ".join(
            f"{k} {ms[k]:.4f} ms (floor {floor[k]:.4f}, {floor[k] / ms[k]:.1%})" for k in ms)
            + "; passes {passes_ms:.4f} ms against a floor of {bound_ms:.4f} ms and the plain "
            "passes' {plain_ms:.4f} ms; F.rms_norm {library_norm_ms:.4f} ms; max ulps vs plain "
            "{ulps}, dt/log_a max rel {f32_max_rel:.2e}; block calls counted {launches} (grad "
            "off), {launches_under_grad} (under autograd), block backwards {backward_calls}"
            .format(**row))
        if row["max_ulps"] > PASS_ULPS or not f32_rel <= 2e-6:
            fail(f"a Mamba pass kernel at {arch} B={B} L={L} is {ulps} bf16 ulps from the plain "
                 f"pass (limit {PASS_ULPS}), dt/log_a {f32_rel:.2e} (limit 2e-6)")
        if (launched, under_grad, backwards) != (1, 1, 1):
            fail(f"mamba_passes_cuda counted {launched} block calls with grad off, "
                 f"{under_grad} under autograd and {backwards} block backwards, not 1, 1 and 1")
        del p, pg, x
        torch.cuda.empty_cache()


def mamba_passes_backward_row(torch, report):
    """Phase (iii.b), backward: at ``PASS_BWD_CELLS`` each pass's Function
    held to autograd through the plain pass on the same inputs and output
    gradient; each backward kernel timed beside its byte floor; each pass's
    forward and backward on the Functions and on the plain pass, and the
    passes of a training step's layer on each route."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.configs.port_only import get_port_config
    from repro_torch.kernels.mamba_passes import kernel as mp
    from repro_torch.kernels.mamba_passes import ref
    from repro_torch.models.common import linear, rmsnorm
    from repro_torch.models.mamba2 import init_mamba_block

    bf16, f32 = torch.bfloat16, torch.float32
    rows = report["mamba_passes_backward"] = []
    for arch, B, L in PASS_BWD_CELLS:
        cfg = dataclasses.replace((get_config if arch in ARCHS else get_port_config)(arch),
                                  n_layers=1)
        G, Din, N = ref.ssm_groups(cfg), cfg.d_inner, cfg.ssm_state
        H, Pd, eps = cfg.ssm_nheads, cfg.ssm_headdim, cfg.norm_eps
        gen = torch.Generator(device="cuda").manual_seed(0)
        p = init_mamba_block(gen, cfg, bf16)

        def draw(shape, dt=bf16):
            return torch.randn(shape, generator=gen, device="cuda").to(dt)

        x, y = draw((B, L, cfg.d_model)), draw((B, L, H, Pd))
        with torch.no_grad():
            zx = linear(p["in_proj"], rmsnorm(p["norm"], x, eps))
            xs = ref.conv_pass(cfg, p, zx, bf16)[0].reshape(B, L, Din).contiguous()
        bc = (B, L, N) if G == 1 else (B, L, G, N)
        dh, dg, dskip = draw(x.shape), draw((B, L, Din)), draw((B, L, Din))
        dconv = (draw((B, L, Din)), draw(bc), draw(bc), draw((B, L, H), f32),
                 draw((B, L, H), f32))
        names = ("conv_w", "conv_b", "dt_bias", "A_log")
        dzx = torch.empty_like(zx)  # the input projection's gradient, as the gate's backward hands it

        def leaves(*ts):
            return [t.detach().clone().requires_grad_(True) for t in ts]

        def norm_fb(fused):
            a, s = leaves(x, p["norm"]["scale"])
            h = mp.RMSNormFn.apply(a, s, eps) if fused else rmsnorm({"scale": s}, a, eps)
            return torch.autograd.grad(h, (a, s), dh)

        def conv_fb(fused):
            ts = leaves(zx, *(p[k] for k in names))
            if fused:  # the D skip's dx and the projection's gradient through the link
                link = mp.Link()
                link.dx, link.dzx = dskip, dzx
                outs = mp.ConvSiluFn.apply(*ts, Din, N, H, G, link)
                gs = dconv
            else:  # autograd adds the D skip's dx to the scan's
                xh, la, Bm, Cm, dt = ref.conv_pass(cfg, dict(zip(names, ts[1:])), ts[0], bf16)
                outs, gs = (xh.reshape(B, L, Din), Bm, Cm, dt, la), (dconv[0] + dskip,) + dconv[1:]
            got = torch.autograd.grad(outs, ts, gs)
            return (got[0][..., Din:],) + got[1:]

        def gate_fb(fused):
            ts = leaves(y, xs, zx, p["D"], p["out_norm"]["scale"])
            if fused:
                link = mp.Link()
                g = mp.GateNormFn.apply(*ts, eps, Pd, G, link)
                dy, dD, dsc = torch.autograd.grad(g, (ts[0], ts[3], ts[4]), dg)
                return dy, link.dx, link.dzx[..., :Din], dD, dsc
            g = ref.gate_pass(cfg, {"D": ts[3], "out_norm": {"scale": ts[4]}}, ts[0],
                              ts[1].view(y.shape), ts[2], bf16)
            dy, dx_, dz, dD, dsc = torch.autograd.grad(g, ts, dg)
            return dy, dx_, dz[..., :Din], dD, dsc

        passes = dict(norm=norm_fb, conv=conv_fb, gate_norm=gate_fb)
        ulps = {}
        for k, fb in passes.items():
            ulps[k] = max(_bf16_ulps(a, b) for a, b in zip(fb(True), fb(False)))
        conv_args = (p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"], Din, N, H, G)
        gate_args = (p["D"], p["out_norm"]["scale"], eps, Pd, G)
        with torch.no_grad():
            fwd = dict(
                norm=lambda: mp.rmsnorm_cuda(x, p["norm"]["scale"], eps),
                conv=lambda: mp.conv_silu_cuda(zx, *conv_args),
                gate_norm=lambda: mp.gate_norm_cuda(y, xs, zx, *gate_args))
            bwd = dict(
                norm=lambda: mp.rmsnorm_bwd_cuda(x, p["norm"]["scale"], dh, eps),
                conv=lambda: mp.conv_silu_bwd_cuda(zx, *conv_args[:4], *dconv, *conv_args[4:],
                                                   dx_extra=dskip, dzx=dzx),
                gate_norm=lambda: mp.gate_norm_bwd_cuda(y, xs, zx, *gate_args[:2], dg,
                                                        *gate_args[2:], dzx=dzx))
            plain_fwd = dict(
                norm=lambda: rmsnorm(p["norm"], x, eps),
                conv=lambda: ref.conv_pass(cfg, p, zx, bf16),
                gate_norm=lambda: ref.gate_pass(cfg, p, y, xs.view(y.shape), zx, bf16))
            fwd_ms = {k: event_ms(torch, fn, reps=10, warm=2) for k, fn in fwd.items()}
            bwd_ms = {k: event_ms(torch, fn, reps=10, warm=2) for k, fn in bwd.items()}
            plain_fwd_ms = sum(event_ms(torch, fn, reps=5) for fn in plain_fwd.values())
        fb_ms = {route: sum(event_ms(torch, lambda fb=fb: fb(fused), reps=5)
                            for fb in passes.values())
                 for route, fused in (("fused", True), ("plain", False))}
        floor = {k: v / HBM_BPS * 1e3
                 for k, v in mp.backward_floor_bytes(cfg, B * L, 2).items()}
        row = dict(arch=arch, B=B, L=L, groups=G, dtype="bfloat16", ulps=ulps,
                   max_ulps=max(ulps.values()),
                   **{f"{k}_bwd_ms": v for k, v in bwd_ms.items()},
                   **{f"{k}_bwd_bound_ms": v for k, v in floor.items()},
                   **{f"{k}_fwd_ms": v for k, v in fwd_ms.items()},
                   backward_ms=sum(bwd_ms.values()), backward_bound_ms=sum(floor.values()),
                   forward_ms=sum(fwd_ms.values()), fused_fb_ms=fb_ms["fused"],
                   plain_fb_ms=fb_ms["plain"], plain_forward_ms=plain_fwd_ms,
                   fused_step_ms=2 * sum(fwd_ms.values()) + sum(bwd_ms.values()),
                   plain_step_ms=fb_ms["plain"] + plain_fwd_ms)
        rows.append(row)
        say("[passes] backward {arch} B={B} L={L} G={groups} bf16: ".format(**row) + ", ".join(
            f"{k} {bwd_ms[k]:.4f} ms (floor {floor[k]:.4f}, {floor[k] / bwd_ms[k]:.1%})"
            for k in bwd_ms) + "; backward {backward_ms:.4f} ms against a floor of "
            "{backward_bound_ms:.4f} ms; forward kernels {forward_ms:.4f} ms; a pass's forward "
            "and backward summed: Functions {fused_fb_ms:.4f} ms (launched from Python, paced "
            "by the host at this size), plain {plain_fb_ms:.4f} ms; a training step's layer "
            "(forward, recompute, backward): kernels {fused_step_ms:.4f} ms (two forwards and a "
            "backward), plain {plain_step_ms:.4f} ms; max ulps vs autograd through the plain "
            "pass {ulps}".format(**row))
        if row["max_ulps"] > PASS_ULPS:
            fail(f"a Mamba pass backward at {arch} B={B} L={L} is {ulps} bf16 ulps from "
                 f"autograd through the plain pass (limit {PASS_ULPS})")
        del p, x, y, zx, xs, dzx, dh, dg, dskip, dconv
        torch.cuda.empty_cache()


def moe_grouped_row(torch, report, T=32768, seed=0):
    """Phase (iii.d): nemotron-3-nano-30b-a3b's dropless MoE layer
    (``models/moe_dropless``) at its published widths on ``T`` tokens (the
    benchmark cell's item), bf16, the benchmark's weight scales: the grouped
    route's expert outputs held to the plain route's (every expert over
    every token, masked) within 1e-2 of max|ref|; each part timed with CUDA
    events: the router, the grouped route (sort, gather, GEMMs, back), its
    two grouped GEMMs and relu² on the operands its own ``torch._grouped_mm``
    calls were given, beside their bound (4 rows D F FLOPs at the bf16 peak,
    against every expert's weights and the rows in and out at the HBM
    rate), a per-expert ``torch.matmul`` loop over the same sorted rows (its
    group ends read back to the host), the combine, the shared expert and
    the layer."""
    from repro_torch.configs.port_only import get_port_config
    from repro_torch.models import moe_dropless as md
    from repro_torch.models.common import linear

    cfg = get_port_config("nemotron-3-nano-30b-a3b")
    D, E, F, Fs, k = (cfg.d_model, cfg.n_experts, cfg.moe_d_ff, cfg.moe_shared_d_ff,
                      cfg.experts_per_token)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(shape, std, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(dtype)

    p = {"router": {"w": draw((D, E), 0.02, torch.float32)},
         "e_bias": draw((E,), 0.01, torch.float32),
         "w_up": draw((E, D, F), 0.02), "w_down": draw((E, F, D), 0.002),
         "shared_up": {"w": draw((D, Fs), 0.02)}, "shared_down": {"w": draw((Fs, D), 0.002)}}
    x = draw((T, D), 1.0)
    calls = []

    def spy(a, b, offs):
        calls.append((a, b, offs))
        return real(a, b, offs=offs)

    real = torch._grouped_mm
    with torch.no_grad():
        ids, w = md.route(cfg, p, x)
        y = _with_patch(torch, "_grouped_mm", spy, lambda: md.experts_grouped(p, x, ids))
        (rows, w_up, ends), (h, w_down, _) = calls
        want = md.experts_plain(p, x, ids)
        rel = _max_rel(y, want)
        del want

        def per_expert():
            out, st = torch.empty_like(rows), 0
            for e, end in enumerate(ends.tolist()):
                if end > st:
                    out[st:end] = md.relu2(rows[st:end] @ w_up[e]) @ w_down[e]
                st = end
            return out

        ms = dict(router=event_ms(torch, lambda: md.route(cfg, p, x), reps=5),
                  experts=event_ms(torch, lambda: md.experts_grouped(p, x, ids), reps=5),
                  up=event_ms(torch, lambda: real(rows, w_up, offs=ends), reps=5),
                  relu2=event_ms(torch, lambda: md.relu2(h), reps=5),
                  down=event_ms(torch, lambda: real(h, w_down, offs=ends), reps=5),
                  combine=event_ms(torch, lambda: md.combine(y, w), reps=5),
                  shared=event_ms(torch, lambda: linear(
                      p["shared_down"], md.relu2(linear(p["shared_up"], x))), reps=5),
                  layer=event_ms(torch, lambda: md.moe_apply(cfg, p, x[None]), reps=5),
                  per_expert=event_ms(torch, per_expert, reps=3),
                  plain=event_ms(torch, lambda: md.experts_plain(p, x, ids), reps=1))
    R = T * k
    t_ops = 4.0 * R * D * F / PEAK["bfloat16"]
    t_bytes = (2 * E * D * F + 2 * R * D) * 2 / HBM_BPS
    bound_ms = max(t_ops, t_bytes) * 1e3
    counts = torch.bincount(ids.reshape(-1), minlength=E)
    gemms_ms = ms["up"] + ms["relu2"] + ms["down"]
    row = dict(T=T, routes=R, rel=rel, bound_ms=bound_ms, gemms_ms=gemms_ms,
               roofline=bound_ms / gemms_ms, largest_rows=int(counts.max()), mean_rows=R / E,
               **{f"{name}_ms": v for name, v in ms.items()})
    report["moe_grouped"] = row
    say("[moe] nemotron-3-nano-30b-a3b T={T}, {routes} routes (largest expert {largest_rows}, "
        "mean {mean_rows:.0f}): grouped GEMMs + relu² {gemms_ms:.4f} ms (up {up_ms:.4f}, relu² "
        "{relu2_ms:.4f}, down {down_ms:.4f}) against a bound of {bound_ms:.4f} ms "
        "({roofline:.1%}); the grouped route (sort, gather, GEMMs, back) {experts_ms:.4f} ms; "
        "per-expert matmul loop {per_expert_ms:.4f} ms; plain route {plain_ms:.4f} ms; router "
        "{router_ms:.4f}, combine {combine_ms:.4f}, shared expert {shared_ms:.4f}; the layer "
        "{layer_ms:.4f} ms; grouped vs plain max rel {rel:.3e}".format(**row))
    if not rel < 1e-2:
        fail(f"the grouped experts are {rel:.3e} of max|ref| from the plain route (limit 1e-2)")
    del p, x, y, rows, h, calls
    torch.cuda.empty_cache()


def flash_attn_row(torch, report):
    """Phase (iii.c): the flash kernel at zamba2-7b's attention site
    (``FLASH_SITE``, bf16, causal, scale (Dh/2)^-1/2), reached through
    ``common.flash_attention`` with grad off (one launch) and held to the
    plain route on the same inputs, each row against its own max|ref|
    (``_row_rel``); timed with CUDA events beside its bound (the causal
    products at the bf16 peak), the plain route and
    ``scaled_dot_product_attention`` (a yardstick the port never calls); a
    build of the source with ``FLASH_MIDDLE_TILE`` planted must read above
    ``FLASH_FAULT_TIMES`` x the limit on the same inputs; in f32 on the first
    two rows (the size of the benchmark's float32 check), the plain route
    through ``flash_attention``: no launch, bit for bit
    ``common._flash_attention``, and timed."""
    import tempfile

    from repro_torch.kernels.flash_attn import kernel
    from repro_torch.kernels.nvcc import CSRC, CudaLibrary
    from repro_torch.models.common import _flash_attention, flash_attention

    flash_attn_cuda = kernel.flash_attn_cuda
    B, L, H, Dh = (FLASH_SITE[k] for k in ("B", "L", "H", "Dh"))
    scale = (Dh / 2) ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((B, L, H, Dh), generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    plain = lambda q, k, v: _flash_attention(q, k, v, True, 512, 1024, scale)  # noqa: E731
    want = plain(q, k, v)
    before = flash_attn_cuda.launches
    with torch.no_grad():
        got = flash_attention(q, k, v, causal=True, scale=scale)
    launched = flash_attn_cuda.launches - before
    rel, rel_all = _row_rel(got, want), _max_rel(got, want)
    src = (CSRC / "flash_attn.cu").read_text()
    sound, planted = FLASH_MIDDLE_TILE
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "flash_attn_middle_tile.cu"
        path.write_text(src.replace(sound, planted))
        faulty = CudaLibrary(str(path), kernel._bind).load() if src.count(sound) == 1 else None
    if faulty is None:
        fail("flash_attn.cu no longer holds the line FLASH_MIDDLE_TILE plants its fault in")
    got = kernel.launch(faulty, q, k, v, True, scale)
    fault_rel, fault_rel_all = _row_rel(got, want), _max_rel(got, want)
    del got, want
    ms = event_ms(torch, lambda: flash_attn_cuda(q, k, v, True, scale), reps=10, warm=2)
    plain_ms = event_ms(torch, lambda: plain(q, k, v), reps=2)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa_ms = event_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=scale), reps=10, warm=2)
    del qt, kt, vt
    bound_ms, bound_by = _attention_bound(q, k, True)
    q32, k32, v32 = (t[:2].float() for t in (q, k, v))
    before32 = flash_attn_cuda.launches
    with torch.no_grad():
        plain32 = torch.equal(flash_attention(q32, k32, v32, causal=True, scale=scale),
                              plain(q32, k32, v32))
        ms32 = event_ms(torch, lambda: flash_attention(q32, k32, v32, causal=True, scale=scale),
                        reps=3)
    launched32 = flash_attn_cuda.launches - before32
    row = report["flash_attn"] = dict(
        B=B, L=L, H=H, Dh=Dh, dtype="bfloat16", launches=launched, row_rel=rel,
        max_rel=rel_all, fault_row_rel=fault_rel, fault_max_rel=fault_rel_all, ms=ms,
        bound_ms=bound_ms, bound_by=bound_by, plain_ms=plain_ms, sdpa_ms=sdpa_ms,
        roofline=bound_ms / ms, f32_rows=2, f32_plain_equal=plain32, f32_launches=launched32,
        f32_plain_ms=ms32)
    say("[flash] zamba2-7b's site B={B} L={L} H={H} Dh={Dh} bf16 causal: kernel {ms:.4f} ms "
        "against a bound of {bound_ms:.4f} ms ({bound_by}; {roofline:.1%}), the plain route "
        "{plain_ms:.4f} ms, scaled_dot_product_attention {sdpa_ms:.4f} ms; against the plain "
        "route, max over rows of max|d|/max|ref| {row_rel:.3e} (max|d|/max|ref| over the "
        "tensor {max_rel:.3e}); the middle tile left out of rows of 32 tiles or more "
        "{fault_row_rel:.3e} ({fault_max_rel:.3e}); {launches} launch through "
        "flash_attention; f32 on {f32_rows} rows through flash_attention: the plain route "
        "{f32_plain_ms:.4f} ms, {f32_launches} launches, equal to it bit for bit "
        "{f32_plain_equal}".format(**row))
    if not rel <= FLASH_TOL or launched != 1:
        fail(f"the flash kernel at zamba2-7b's site: {rel:.3e} of a row's max|ref| from the "
             f"plain route (limit {FLASH_TOL:.3e}); {launched} launches, not 1")
    if not plain32 or launched32:
        fail(f"f32 attention at zamba2-7b's site through flash_attention: {launched32} flash "
             f"launches, not 0, or not the plain route bit for bit ({plain32})")
    if not fault_rel > FLASH_FAULT_TIMES * FLASH_TOL:
        fail(f"the planted fault (the middle tile of keys left out of long rows) reads "
             f"{fault_rel:.3e}, not above {FLASH_FAULT_TIMES} x the limit {FLASH_TOL:.3e}")
    del q, k, v, q32, k32, v32
    torch.cuda.empty_cache()


def flash_gqa_row(torch, report):
    """Phase (iii.c), GQA: the flash kernel at nemotron-3-nano-30b-a3b's
    attention site (``FLASH_GQA_SITE``: 32 query heads over 2 KV heads of
    128, bf16, causal, scale Dh^-1/2) through ``common.flash_attention``
    with grad off (one launch), held to the plain route on the same inputs
    row by row (``_row_rel``, ``FLASH_TOL``) and timed with CUDA events
    beside its bound and the plain route."""
    from repro_torch.kernels.flash_attn import kernel
    from repro_torch.models.common import _flash_attention, flash_attention

    B, L, H, Hkv, Dh = (FLASH_GQA_SITE[k] for k in ("B", "L", "H", "Hkv", "Dh"))
    scale = Dh ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((B, L, H, Dh), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((B, L, Hkv, Dh), generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    plain = lambda: _flash_attention(q, k, v, True, 512, 1024, scale)  # noqa: E731
    want = plain()
    before = kernel.flash_attn_cuda.launches
    with torch.no_grad():
        got = flash_attention(q, k, v, causal=True, scale=scale)
    launched = kernel.flash_attn_cuda.launches - before
    rel, rel_all = _row_rel(got, want), _max_rel(got, want)
    del got, want
    ms = event_ms(torch, lambda: kernel.flash_attn_cuda(q, k, v, True, scale), reps=10, warm=2)
    plain_ms = event_ms(torch, plain, reps=2)
    bound_ms, bound_by = _attention_bound(q, k, True)
    row = report["flash_attn_gqa"] = dict(
        B=B, L=L, H=H, Hkv=Hkv, Dh=Dh, dtype="bfloat16", launches=launched, row_rel=rel,
        max_rel=rel_all, ms=ms, bound_ms=bound_ms, bound_by=bound_by, plain_ms=plain_ms,
        roofline=bound_ms / ms)
    say("[flash] nemotron-3-nano-30b-a3b's site B={B} L={L} H={H} over Hkv={Hkv} Dh={Dh} bf16 "
        "causal: kernel {ms:.4f} ms against a bound of {bound_ms:.4f} ms ({bound_by}; "
        "{roofline:.1%}), the plain route {plain_ms:.4f} ms; against the plain route, max over "
        "rows of max|d|/max|ref| {row_rel:.3e} (over the tensor {max_rel:.3e}); {launches} "
        "launch through flash_attention".format(**row))
    if not rel <= FLASH_TOL or launched != 1:
        fail(f"the flash kernel at nemotron's site: {rel:.3e} of a row's max|ref| from the plain "
             f"route (limit {FLASH_TOL:.3e}); {launched} launches, not 1")
    del q, k, v
    torch.cuda.empty_cache()


def flash_mla_row(torch, report):
    """Phase (iii.c), latent attention: the flash kernel at deepseek-v3's
    MLA site (``FLASH_MLA_SITE``: q and k of 192, v of 128 a view of a
    [B, L, H, 256] tensor, bf16, causal, scale 192^-1/2 YaRN's mscale²)
    through ``common.flash_attention`` with grad off (one launch), held to
    the plain route row by row on ``FLASH_MLA_SLICE`` heads (the plain route
    over all 128 heads takes a second), and timed with CUDA events beside
    its bound and ``scaled_dot_product_attention`` (a yardstick the port
    never calls; "not measured" where no backend of it takes the heads)."""
    from repro_torch.kernels.flash_attn import kernel
    from repro_torch.models.common import _flash_attention, flash_attention

    B, L, H, Dqk, Dv = (FLASH_MLA_SITE[k] for k in ("B", "L", "H", "Dqk", "Dv"))
    scale = Dqk ** -0.5 * (0.1 * np.log(40.0) + 1.0) ** 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k = (torch.randn((B, L, H, Dqk), generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    v = torch.randn((B, L, H, 256), generator=gen, device="cuda").bfloat16()[..., 256 - Dv:]
    before = kernel.flash_attn_cuda.launches
    with torch.no_grad():
        got = flash_attention(q, k, v, causal=True, scale=scale)
    launched = kernel.flash_attn_cuda.launches - before
    n = FLASH_MLA_SLICE
    want = _flash_attention(q[:, :, :n], k[:, :, :n], v[:, :, :n], True, 512, 1024, scale)
    rel = _row_rel(got[:, :, :n], want)
    del got, want
    ms = event_ms(torch, lambda: kernel.flash_attn_cuda(q, k, v, True, scale), reps=5, warm=1)
    bound_ms = 2 * B * H * L * (L + 1) / 2 * (Dqk + Dv) / PEAK["bfloat16"] * 1e3
    sdpa_ms = None
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    try:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION]):
            sdpa_ms = event_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, scale=scale), reps=5, warm=1)
    except RuntimeError as e:
        say(f"[flash] scaled_dot_product_attention at deepseek-v3's site: not measured ({e})"[:300])
    del qt, kt, vt
    row = report["flash_attn_mla"] = dict(
        B=B, L=L, H=H, Dqk=Dqk, Dv=Dv, dtype="bfloat16", launches=launched, row_rel=rel,
        rel_heads=n, ms=ms, bound_ms=bound_ms, bound_by="operations", sdpa_ms=sdpa_ms,
        roofline=bound_ms / ms)
    say("[flash] deepseek-v3's MLA site B={B} L={L} H={H} Dqk={Dqk} Dv={Dv} bf16 causal: kernel "
        "{ms:.4f} ms against a bound of {bound_ms:.4f} ms ({bound_by}; {roofline:.1%}), "
        "scaled_dot_product_attention {sdpa_ms} ms; against the plain route on {rel_heads} "
        "heads, max over rows of max|d|/max|ref| {row_rel:.3e}; {launches} launch through "
        "flash_attention".format(**row))
    if not rel <= FLASH_TOL or launched != 1:
        fail(f"the flash kernel at deepseek-v3's site: {rel:.3e} of a row's max|ref| from the "
             f"plain route (limit {FLASH_TOL:.3e}); {launched} launches, not 1")
    del q, k, v
    torch.cuda.empty_cache()


def dense_prefill(torch, report):
    """Phase (vii) (h): llama3.2-1b prefill at its published widths, with
    the kernel counts set to 0 just before it and read just after."""
    from repro_torch.launch import serve
    from repro_torch.models import common, transformer

    def naive(q, k, v, causal=True, q_chunk=None, k_chunk=None):
        return common.naive_attention(q, k, v, causal=causal)

    arch, Bp, Lp = DENSE["arch"], DENSE["batch"], DENSE["prompt"]
    model, params = serve.load(arch, reduced=False, device="cuda", seed=0)
    cfg = model.cfg
    if (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_ff,
            cfg.vocab_size, cfg.attn_q_chunk, cfg.attn_k_chunk, cfg.dtype) != (
            16, 2048, 32, 8, 64, 8192, 128256, 512, 1024, "bfloat16"):
        fail(f"{arch} is not at its published widths: {cfg}")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (Bp, Lp), dtype=np.int64)).cuda()
    batch_in = {"tokens": toks}
    _zero_counts(torch)
    t0 = time.perf_counter()
    logits = model.prefill(params, batch_in)
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    c = _counts()
    say(f"[dense] counts read after the dense prefill path: {c} (flash_attn a layer, no other "
        "kernel of the port: the products are torch.matmul)")
    if c != _prefill_counts(cfg):
        fail(f"the dense prefill path launched {c}, not flash_attn x {cfg.n_layers} alone")
    if tuple(logits.shape) != (Bp, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        fail(f"dense prefill returned {tuple(logits.shape)} logits, or non-finite ones")
    line = _prefill_where(torch, model, params, batch_in)
    del model, params, logits
    torch.cuda.empty_cache()
    # f32 on the same weights: two prompts against a replay through naive_attention
    f32_model, f32_params = _f32_twin(torch, cfg)
    f32_in = {"tokens": toks[:2]}
    ref = _with_patch(transformer, "flash_attention", naive,
                      lambda: f32_model.prefill(f32_params, f32_in))
    d_max, d_rms, _ = logits_gap(f32_model.prefill(f32_params, f32_in), ref)
    del ref
    c_max, c_rms, c_excess, c_launch = _cross_path(torch, f32_model, f32_params,
                                                   DENSE["check_prompt"], 4)
    del f32_model, f32_params
    torch.cuda.empty_cache()
    line.update(arch=arch, batch=Bp, prompt=Lp, dtype=cfg.dtype, first_wall_s=first_wall,
                launches=c, f32_logits_max_rel=d_max, f32_logits_rms_rel=d_rms,
                cross_prompt=DENSE["check_prompt"], cross_max_rel=c_max, cross_rms_rel=c_rms,
                cross_max_excess=c_excess, cross_decode_attn_launches=c_launch)
    report["dense_prefill"] = line
    say("[dense] {arch} {dtype} B={batch} L={prompt}: first={first_wall_s:.3f} s "
        "ms/prefill={ms_per_prefill:.3f} prompt tokens/s={prompt_tokens_per_s:.1f} "
        "peak={peak_mem_gb:.2f} GB; f32 vs the naive_attention replay: max|d|/max|ref| "
        "{f32_logits_max_rel:.3e}, rms|d|/rms|ref| {f32_logits_rms_rel:.3e}; f32 decode vs "
        "prefill of a {cross_prompt}-token prompt ({cross_decode_attn_launches} decode_attn "
        "launches): max|d|/max|ref| {cross_max_rel:.4e}, rms|d|/rms|ref| {cross_rms_rel:.4e}, "
        "max(|d| - rtol |ref|) {cross_max_excess:.3e}".format(**line))
    _say_where("dense prefill", line)
    if d_max > DENSE_F32_TOL:
        fail(f"f32 dense prefill logits vs the naive_attention replay: max|d|/max|ref| "
             f"{d_max:.3e} > {DENSE_F32_TOL}")
    if c_launch != cfg.n_layers * DENSE["check_prompt"]:
        fail(f"the dense decode check launched the decode kernel {c_launch} times")
    if c_excess > CROSS_TOL["atol"]:
        fail(f"f32 dense decode vs prefill of a {DENSE['check_prompt']}-token prompt: |d| "
             f"exceeds {CROSS_TOL['atol']} + {CROSS_TOL['rtol']} |ref| by {c_excess:.3e}")


def hybrid(torch, report):
    """Phase (vii) (i) and (j): zamba2-2.7b prefill and decode at its
    published widths, each with the kernel counts set to 0 just before it
    and read just after."""
    from repro_torch.kernels.decode_attn import kernel as dec_kernel
    from repro_torch.kernels.decode_attn.ref import decode_attention
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    from repro_torch.launch import serve
    from repro_torch.models import mamba2, transformer

    def plain_scan(x, la, B, C, dt, chunk):
        return ssd_chunked(x, la, B, C, dt, chunk)

    # (i) prefill, bf16
    arch, Bp, Lp = HYBRID["arch"], HYBRID["batch"], HYBRID["prompt"]
    t0 = time.perf_counter()
    model, params = serve.load(arch, reduced=False, device="cuda", seed=0)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cfg = model.cfg
    if (cfg.family, cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_nheads, cfg.ssm_headdim,
            cfg.ssm_state, cfg.ssm_chunk, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.hybrid_attn_every, cfg.tie_embeddings, cfg.dtype) != (
            "hybrid", 54, 2560, 5120, 80, 64, 64, 256, 32, 32, 80, 10240, 32000, 6, True,
            "bfloat16"):
        fail(f"{arch} is not at its published widths: {cfg}")
    sites = cfg.n_layers // cfg.hybrid_attn_every
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (Bp, Lp), dtype=np.int64)).cuda()
    batch_in = {"tokens": toks}
    _zero_counts(torch)
    t0 = time.perf_counter()
    logits = model.prefill(params, batch_in)
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    c = _counts()
    say(f"[hybrid] counts read after the zamba2 prefill path: {c}")
    if c != _prefill_counts(cfg, cfg.n_layers, cfg.n_layers):
        fail(f"the zamba2 prefill path launched {c}, not ssd_scan and mamba_passes x "
             f"{cfg.n_layers} and flash_attn x {sites} alone")
    if tuple(logits.shape) != (Bp, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        fail(f"zamba2 prefill returned {tuple(logits.shape)} logits, or non-finite ones")
    # bf16: read against the plain-ssd_chunked replay, not held (as in phase (iii))
    ref = _with_patch(mamba2, "ssd_scan", plain_scan, lambda: model.prefill(params, batch_in))
    b_max, b_rms, b_agree = logits_gap(logits, ref)
    del ref, logits
    line = _prefill_where(torch, model, params, batch_in)
    # f32 on the same weights, two prompts: the kernel within the limit of the
    # plain replay (the model kept for the decode check of (j))
    f32_model, f32_params = _f32_twin(torch, cfg)
    f32_in = {"tokens": toks[:2]}
    ref = _with_patch(mamba2, "ssd_scan", plain_scan,
                      lambda: f32_model.prefill(f32_params, f32_in))
    f_max, f_rms, _ = logits_gap(f32_model.prefill(f32_params, f32_in), ref)
    del ref
    line.update(arch=arch, batch=Bp, prompt=Lp, dtype=cfg.dtype, load_s=load_s,
                first_wall_s=first_wall, launches=c, logits_max_rel=b_max, logits_rms_rel=b_rms,
                argmax_agree=b_agree, f32_logits_max_rel=f_max, f32_logits_rms_rel=f_rms)
    report["hybrid_prefill"] = line
    say("[hybrid] {arch} {dtype} B={batch} L={prompt}: load={load_s:.2f} s "
        "first={first_wall_s:.3f} s ms/prefill={ms_per_prefill:.3f} prompt tokens/s="
        "{prompt_tokens_per_s:.1f} peak={peak_mem_gb:.2f} GB; plain-ssd replay: bf16 "
        "max|d|/max|ref| {logits_max_rel:.4e}, rms|d|/rms|ref| {logits_rms_rel:.4e}, argmax "
        "agrees {argmax_agree:.4f} (read); f32 max {f32_logits_max_rel:.3e}, rms "
        "{f32_logits_rms_rel:.3e}".format(**line))
    _say_where("zamba2 prefill", line)
    if not (f_max <= PREFILL_F32_TOL["max"] and f_rms <= PREFILL_F32_TOL["rms"]):
        fail(f"f32 zamba2 prefill logits vs the plain replay: max|d|/max|ref| {f_max:.3e}, "
             f"rms|d|/rms|ref| {f_rms:.3e} (limits {PREFILL_F32_TOL})")

    # (j) decode, bf16, through serve.decode
    batch, ctx, n_tok = HYBRID["batch"], HYBRID["ctx"], HYBRID["tokens"]
    kept = []
    decode_step = model.decode_step

    def keep_logits(p, t, cache, pos):
        out, cache = decode_step(p, t, cache, pos)
        kept.append(out)
        return out, cache

    model.decode_step = keep_logits
    _zero_counts(torch)
    t0 = time.perf_counter()
    seq = serve.decode(model, params, tokens=n_tok, batch=batch, ctx=ctx)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    model.decode_step = decode_step
    c = _counts()
    say(f"[hybrid] counts read after the zamba2 decode path: {c}")
    if c != dict(s2d_conv=0, decode_attn=sites * n_tok, ssd_scan=0, mamba_passes=0,
                 flash_attn=0):
        fail(f"the zamba2 decode path launched {c}, not decode_attn x {sites} x {n_tok} alone")
    if tuple(seq.shape) != (batch, n_tok) or len(kept) != n_tok:
        fail(f"zamba2 serve returned {tuple(seq.shape)} ids and {len(kept)} logits")
    if not bool(((seq >= 0) & (seq < cfg.vocab_size)).all()):
        fail("zamba2 serve returned ids outside the vocabulary")
    if not all(bool(torch.isfinite(lg).all()) for lg in kept):
        fail("zamba2 serve produced non-finite logits")

    # checks (after the counts were read), fed the kernel run's tokens, the
    # kernel stepped again beside them from its own state: (1) each step through
    # the plain attention from the kernel run's state at that step, held to the
    # serving limit; (2) the plain attention from its own state (free-running, as
    # phase (ii) replays llama) over the first steps, read against the same
    # limit: the 54 bf16 Mamba blocks carry the two runs' rounding differences
    # from step to step in their states; (3) over the first steps, a planted
    # fault (the kernel without the newest position) from the kernel run's
    # state, read
    def plain_attention(q, k, v, pos, valid_len=None):
        return decode_attention(q, k, v, pos)

    def fault_attention(q, k, v, pos, valid_len=None):
        vl = torch.full((q.shape[0],), pos, dtype=torch.int32, device=q.device).clamp(min=1)
        return dec_kernel.decode_attn_cuda(q[:, 0], k, v, vl, bound=pos + 1)[:, None]

    def step_with(attention, cache, i):
        return _with_patch(transformer, "gqa_decode_attention", attention,
                           lambda: model.decode_step(params, tok, cache, i))

    def gap(got, ref):
        d = got - ref
        return torch.stack([d.abs().max(), ref.abs().max(), d.pow(2).mean().sqrt(),
                            ref.pow(2).mean().sqrt()])

    forced, free, fault, rerun, agree = [], [], [], [], 0
    cache = model.init_cache(batch, ctx)
    free_cache = model.init_cache(batch, ctx)
    tok = torch.zeros((batch,), dtype=torch.int32, device="cuda")
    for i in range(n_tok):
        before = {k: v.clone() for k, v in cache.items()}
        if i < HYBRID["fault_steps"]:
            bad, _ = step_with(fault_attention, {k: v.clone() for k, v in before.items()}, i)
        got, cache = model.decode_step(params, tok, cache, i)
        ref, _ = step_with(plain_attention, before, i)
        forced.append(gap(got, ref))
        if i < HYBRID["fault_steps"]:
            fault.append(gap(bad, ref))
        rerun.append((got - kept[i]).abs().max())
        if i < HYBRID["free_steps"]:
            ref, free_cache = step_with(plain_attention, free_cache, i)
            free.append(gap(kept[i], ref))
            agree += int((ref.argmax(-1) == seq[:, i]).sum())
        tok = seq[:, i]
    del cache, free_cache, before, kept

    def rel(stats):
        d_max, r_max, d_rms, r_rms = torch.stack(stats).cpu().numpy().T
        return d_max / r_max, d_rms / r_rms

    f_max, f_rms = rel(forced)
    fr_max, fr_rms = rel(free)
    fa_max, fa_rms = rel(fault)
    fault_inside = bool((fa_max <= SERVE_TOL["max"]).all() and (fa_rms <= SERVE_TOL["rms"]).all())
    n_prof = HYBRID["profile_tokens"]
    dev = device_activity(torch, lambda: serve.decode(model, params, tokens=n_prof, batch=batch,
                                                      ctx=ctx))
    dev_ms = sum(ms for _, ms in dev.values())
    n_dev = sum(n for n, _ in dev.values())
    dec_ms = sum(ms for name, (_, ms) in dev.items() if "decode_attn" in name)
    top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:6]
    del model, params
    torch.cuda.empty_cache()
    c_max, c_rms, c_excess, c_launch = _cross_path(torch, f32_model, f32_params,
                                                   HYBRID["check_prompt"], 6)
    del f32_model, f32_params
    torch.cuda.empty_cache()
    report["hybrid_decode"] = line = dict(
        arch=arch, batch=batch, ctx=ctx, tokens=n_tok, dtype=cfg.dtype, sites=sites, wall_s=wall,
        ms_per_token=wall / n_tok * 1e3, tokens_per_s=batch * n_tok / wall, launches=c,
        worst_max_rel=float(f_max.max()), worst_max_rel_step=int(np.argmax(f_max)),
        worst_rms_rel=float(f_rms.max()), worst_rms_rel_step=int(np.argmax(f_rms)),
        median_rms_rel=float(np.median(f_rms)),
        free_worst_max_rel=float(fr_max.max()), free_worst_rms_rel=float(fr_rms.max()),
        free_median_max_rel=float(np.median(fr_max)),
        free_median_rms_rel=float(np.median(fr_rms)), free_steps=len(free),
        free_argmax_agree=agree / (batch * len(free)),
        fault_steps=len(fault), fault_worst_max_rel=float(fa_max.max()),
        fault_worst_rms_rel=float(fa_rms.max()), fault_median_max_rel=float(np.median(fa_max)),
        fault_median_rms_rel=float(np.median(fa_rms)), fault_inside_limit=fault_inside,
        rerun_max_abs_diff=float(torch.stack(rerun).max().item()),
        profiled_tokens=n_prof, device_ms_per_step=dev_ms / n_prof,
        device_ops_per_step=n_dev / n_prof,
        device_busy_share=dev_ms / n_prof / (wall / n_tok * 1e3) if n_dev else None,
        decode_attn_share=dec_ms / dev_ms if n_dev else None,
        top_device=[dict(name=k, ops=n, ms=ms) for k, (n, ms) in top],
        cross_prompt=HYBRID["check_prompt"], cross_max_rel=c_max, cross_rms_rel=c_rms,
        cross_max_excess=c_excess, cross_decode_attn_launches=c_launch,
    )
    say("[hybrid] {arch} {dtype} decode B={batch} ctx={ctx} {tokens} tokens: wall={wall_s:.3f} s "
        "ms/token={ms_per_token:.3f} tokens/s={tokens_per_s:.1f}; each step through the plain "
        "attention from the kernel run's state: worst max|d|/max|ref| {worst_max_rel:.4f} (step "
        "{worst_max_rel_step}), rms|d|/rms|ref| {worst_rms_rel:.4f} (step {worst_rms_rel_step}, "
        "median {median_rms_rel:.4f}); the kernel stepped again: max|d| {rerun_max_abs_diff:.3e}; "
        "free-running plain replay over the first {free_steps} steps (read): worst max "
        "{free_worst_max_rel:.4f} (median {free_median_max_rel:.4f}), rms {free_worst_rms_rel:.4f} "
        "(median {free_median_rms_rel:.4f}), argmax agrees {free_argmax_agree:.4f}".format(**line))
    say("[hybrid] planted fault (the kernel without the newest position) over the first "
        "{fault_steps} steps, from the kernel run's state: worst max|d|/max|ref| "
        "{fault_worst_max_rel:.4f} (median {fault_median_max_rel:.4f}), rms|d|/rms|ref| "
        "{fault_worst_rms_rel:.4f} (median {fault_median_rms_rel:.4f}); limits max {tol_max}, rms "
        "{tol_rms}: the fault reads {where} the limit".format(
            tol_max=SERVE_TOL["max"], tol_rms=SERVE_TOL["rms"],
            where="inside" if fault_inside else "outside", **line))
    say("[hybrid] f32 decode vs prefill of a {cross_prompt}-token prompt "
        "({cross_decode_attn_launches} decode_attn launches): max|d|/max|ref| {cross_max_rel:.4e}, "
        "rms|d|/rms|ref| {cross_rms_rel:.4e}, max(|d| - rtol |ref|) {cross_max_excess:.3e}"
        .format(**line))
    if n_dev:
        say("[where] zamba2 decode ({profiled_tokens} steps profiled): device {device_ms_per_step:.3f} "
            "ms a step = {device_busy_share:.4f} of the unprofiled wall a step; "
            "{device_ops_per_step:.1f} device ops a step; decode_attn {decode_attn_share:.4f} of "
            "device time".format(**line))
        for d in line["top_device"]:
            say(f"[where]   {d['ms']:.3f} ms in {d['ops']} x {d['name'][:100]}")
    else:
        say("[where] zamba2 decode: device time not measured "
            "(torch.profiler recorded no device activity)")
    for name, r in (("max", f_max), ("rms", f_rms)):
        if not (r <= SERVE_TOL[name]).all():
            i = int(np.argmax(r))
            fail(f"zamba2 serve step {i} from the kernel run's state: logits {name}|d| = "
                 f"{r[i]:.4f} of {name}|ref| > {SERVE_TOL[name]}")
    if c_launch != sites * HYBRID["check_prompt"]:
        fail(f"the zamba2 decode check launched the decode kernel {c_launch} times")
    if c_excess > CROSS_TOL["atol"]:
        fail(f"f32 zamba2 decode vs prefill of a {HYBRID['check_prompt']}-token prompt: |d| "
             f"exceeds {CROSS_TOL['atol']} + {CROSS_TOL['rtol']} |ref| by {c_excess:.3e}")


def _load_cut(torch, cell):
    """``cell``'s model at its published widths (checked), cut in depth
    alone, its weights drawn on the card from seed 0; (model, params, s)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_api import build_model

    cfg = dataclasses.replace(get_config(cell["arch"]), **cell["cut"])
    widths = {k: getattr(cfg, k) for k in cell["widths"]}
    if widths != cell["widths"]:
        fail(f"{cell['arch']} is not at its published widths: {widths}")
    t0 = time.perf_counter()
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    return model, params, time.perf_counter() - t0


def _kv_slots(cfg, cache):
    """Each attention block's (k, v) cache, in the order a prefill runs
    the blocks (a moe group's dense blocks ahead of its MoE block)."""
    if cfg.family != "moe":
        return [(cache["k"][i], cache["v"][i]) for i in range(cfg.n_layers)]
    slots = []
    for g in range(cache["moe_k"].shape[0]):
        for i in range(cfg.moe_every - 1):
            slots.append((cache["dense_k"][g, i], cache["dense_v"][g, i]))
        slots.append((cache["moe_k"][g], cache["moe_v"][g]))
    return slots


def _prefill_into_cache(torch, model, params, batch_in, cache):
    """``model.prefill`` with each block's keys and values, as
    flash_attention receives them (after RoPE), copied into the first
    positions of its cache: the cache a serving loop holds after the
    prompt, which decode then extends."""
    from repro_torch.models import transformer

    flash = transformer.flash_attention
    slots = iter(_kv_slots(model.cfg, cache))

    def keep(q, k, v, **kw):
        ck, cv = next(slots)
        ck[:, :k.shape[1]].copy_(k)
        cv[:, :v.shape[1]].copy_(v)
        return flash(q, k, v, **kw)

    return _with_patch(transformer, "flash_attention", keep, lambda: model.prefill(params, batch_in))


def _serve_held(torch, model, params, cache, first, start, n_tok, ctx, mods, sites, tag):
    """Greedy decode of ``n_tok`` tokens through ``serve.decode`` from
    ``cache`` (positions ``< start`` filled) and ``first``, with the kernel
    counts set to 0 just before and read just after (``sites`` launches a
    step, nothing else); then the held replay: every step again from the
    kernel run's own state, once through the kernel (each attention site
    held against the plain version on its inputs, SITE_TOL) and once
    through the plain attention with the kernel run's experts forced into
    every MoE site (``_forced_topk`` in place of ``moe.moe_topk``), the logits held to the
    serving limit on every step; a router flip (the plain step's own top-k
    differing, a discrete change) is counted and read.  ``mods``: the modules whose
    ``gqa_decode_attention`` the step calls (``transformer`` when None)."""
    from repro_torch.kernels.decode_attn.ref import decode_attention
    from repro_torch.launch import serve
    from repro_torch.models import moe, transformer

    mods = mods or (transformer,)

    batch = first.shape[0]
    start_cache = {k: v.clone() for k, v in cache.items()}
    kept, decode_step = [], model.decode_step

    def keep_logits(p, t, c, pos):
        out, c = decode_step(p, t, c, pos)
        kept.append(out)
        return out, c

    model.decode_step = keep_logits
    _zero_counts(torch)
    t0 = time.perf_counter()
    seq = serve.decode(model, params, tokens=n_tok, batch=batch, ctx=ctx, cache=cache,
                       start=start, first=first)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    model.decode_step = decode_step
    c = _counts()
    say(f"[{tag}] counts read after the {model.cfg.name} decode path: {c}")
    if c != dict(s2d_conv=0, decode_attn=sites * n_tok, ssd_scan=0, mamba_passes=0,
                 flash_attn=0):
        fail(f"the {model.cfg.name} decode path launched {c}, not decode_attn x {sites} x "
             f"{n_tok} alone")
    if tuple(seq.shape) != (batch, n_tok) or len(kept) != n_tok:
        fail(f"{model.cfg.name} serve returned {tuple(seq.shape)} ids and {len(kept)} logits")
    if not bool(((seq >= 0) & (seq < model.cfg.vocab_size)).all()):
        fail(f"{model.cfg.name} serve returned ids outside the vocabulary")
    if not all(bool(torch.isfinite(lg).all()) for lg in kept):
        fail(f"{model.cfg.name} serve produced non-finite logits")
    del cache

    kernel_attention = mods[0].gqa_decode_attention
    topk = moe.moe_topk
    site_gaps, chosen, flips_now = [], [], []

    def checked(q, k, v, pos, valid_len=None):
        out = kernel_attention(q, k, v, pos, valid_len)
        ref = decode_attention(q, k, v, pos)
        site_gaps.append(torch.stack([(out.float() - ref.float()).abs().max(),
                                      ref.float().abs().max()]))
        return out

    def plain(q, k, v, pos, valid_len=None):
        return decode_attention(q, k, v, pos)

    def recording(cfg, gates):
        out = topk(cfg, gates)
        chosen.append(out[2])
        return out

    def forcing(cfg, gates):
        # the kernel run's experts at this site; a flip is where the plain
        # step's own top-k would differ
        want = chosen.pop(0)
        own = topk(cfg, gates)[2]
        flips_now.append(torch.stack([(a != b).any() for a, b in zip(own, want)]).any())
        return _forced_topk(gates, want)

    def step(attention, routing, c, tok, i):
        out, _ = _with_patches([(m, "gqa_decode_attention", attention) for m in mods]
                               + [(moe, "moe_topk", routing)],
                               lambda: model.decode_step(params, tok, c, i))
        return out

    def gap(got, ref):
        d = got - ref
        return torch.stack([d.abs().max(), ref.abs().max(), d.pow(2).mean().sqrt(),
                            ref.pow(2).mean().sqrt()])

    stats, flips, rerun = [], [], []
    state = {k: v.clone() for k, v in start_cache.items()}
    tok = first
    for j in range(n_tok):
        before = {k: v.clone() for k, v in state.items()}
        chosen.clear()
        flips_now.clear()
        got = step(checked, recording, state, tok, start + j)
        ref = step(plain, forcing, before, tok, start + j)
        if chosen:
            fail(f"{model.cfg.name}: the plain replay routed {len(chosen)} sites fewer")
        stats.append(gap(got, ref))
        flips.append(torch.stack([torch.zeros((), dtype=torch.bool, device="cuda")]
                                 + flips_now).any())
        rerun.append((got - kept[j]).abs().max())
        tok = seq[:, j]
    del before, state, kept
    d_max, r_max, d_rms, r_rms = torch.stack(stats).cpu().numpy().T
    rel_max, rel_rms = d_max / r_max, d_rms / r_rms
    flipped = torch.stack(flips).cpu().numpy()
    sg = torch.stack(site_gaps).cpu().numpy()
    site_rel = sg[:, 0] / sg[:, 1]
    return dict(seq=seq, wall=wall, launches=c, start_cache=start_cache, rel_max=rel_max,
                rel_rms=rel_rms, flipped=flipped, site_rel=site_rel,
                rerun=float(torch.stack(rerun).max().item()))


def _forced_topk(gates, route):
    """``moe.moe_topk``'s ``(gates, one-hots, indices)`` with the experts of
    ``route`` (K index tensors ``[G,S]``, another run's choice) in place of
    its argmax, each with this call's gate."""
    import torch.nn.functional as F

    g, sel_gate, sel_onehot = gates, [], []
    for idx in route:
        oh = F.one_hot(idx, gates.shape[-1]).float()
        sel_gate.append((g * oh).sum(-1))
        sel_onehot.append(oh)
        g = g * (1.0 - oh)
    return sel_gate, sel_onehot, list(route)


def _decode_where(torch, model, params, start_cache, first, start, n_prof, ctx, wall, n_tok):
    """``n_prof`` steps of the same decode under torch.profiler, from the
    prompt's cache: device ms and ops a step, busy share, the kernel's
    share, the top device activities."""
    from repro_torch.launch import serve

    c = {k: v.clone() for k, v in start_cache.items()}
    dev = device_activity(torch, lambda: serve.decode(
        model, params, tokens=n_prof, batch=first.shape[0], ctx=ctx, cache=c, start=start,
        first=first))
    dev_ms = sum(ms for _, ms in dev.values())
    n_dev = sum(n for n, _ in dev.values())
    dec_ms = sum(ms for name, (_, ms) in dev.items() if "decode_attn" in name)
    top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:6]
    return dict(profiled_tokens=n_prof, device_ms_per_step=dev_ms / n_prof,
                device_ops_per_step=n_dev / n_prof,
                device_busy_share=dev_ms / n_prof / (wall / n_tok * 1e3) if n_dev else None,
                decode_attn_share=dec_ms / dev_ms if n_dev else None,
                top_device=[dict(name=k, ops=n, ms=ms) for k, (n, ms) in top])


def _report_decode(tag, cfg, line, out):
    """Print a decode cell's lines and hold its checks (``out``: the
    replay's arrays from :func:`_serve_held`)."""
    say("[{tag}] {arch} {dtype} decode B={batch} from position {start}, {tokens} tokens: "
        "wall={wall_s:.3f} s ms/token={ms_per_token:.3f} tokens/s={tokens_per_s:.1f}; each "
        "step from the kernel run's state, kernel vs plain attention, the plain step on the "
        "kernel run's experts: every step worst max|d|/max|ref| {worst_max_rel:.4f}, "
        "rms|d|/rms|ref| {worst_rms_rel:.4f} (median {median_rms_rel:.4f}); router flips "
        "(read) on {flip_steps} of {tokens} steps, there worst max {flip_worst_max_rel}, rms "
        "{flip_worst_rms_rel}; every attention site ({sites_checked}): worst max|d|/max|ref| "
        "{site_worst_rel:.4e}; the kernel stepped again: max|d| {rerun_max_abs_diff:.3e}"
        .format(tag=tag, **line))
    if line["device_busy_share"] is not None:
        say("[where] {arch} decode ({profiled_tokens} steps profiled): device "
            "{device_ms_per_step:.3f} ms a step = {device_busy_share:.4f} of the unprofiled wall "
            "a step; {device_ops_per_step:.1f} device ops a step; decode_attn "
            "{decode_attn_share:.4f} of device time".format(**line))
        for d in line["top_device"]:
            say(f"[where]   {d['ms']:.3f} ms in {d['ops']} x {d['name'][:100]}")
    else:
        say(f"[where] {cfg.name} decode: device time not measured "
            "(torch.profiler recorded no device activity)")
    if line["site_worst_rel"] > SITE_TOL:
        fail(f"{cfg.name} decode: an attention site's kernel output is "
             f"{line['site_worst_rel']:.4e} of max|ref| from the plain version's > {SITE_TOL}")
    for name, r in (("max", out["rel_max"]), ("rms", out["rel_rms"])):
        if not (r <= SERVE_TOL[name]).all():
            fail(f"{cfg.name} serve, step {int(np.argmax(r))}: logits {name}|d| = "
                 f"{r.max():.4f} of {name}|ref| > {SERVE_TOL[name]}")


def _decode_line(cfg, batch, start, n_tok, out, where):
    fl = out["flipped"]
    return dict(
        arch=cfg.name, dtype=cfg.dtype, batch=batch, start=start, tokens=n_tok,
        wall_s=out["wall"], ms_per_token=out["wall"] / n_tok * 1e3,
        tokens_per_s=batch * n_tok / out["wall"], launches=out["launches"],
        flip_steps=int(fl.sum()), worst_max_rel=float(out["rel_max"].max()),
        worst_rms_rel=float(out["rel_rms"].max()),
        median_rms_rel=float(np.median(out["rel_rms"])),
        flip_worst_max_rel=float(out["rel_max"][fl].max()) if fl.any() else None,
        flip_worst_rms_rel=float(out["rel_rms"][fl].max()) if fl.any() else None,
        sites_checked=len(out["site_rel"]), site_worst_rel=float(out["site_rel"].max()),
        rerun_max_abs_diff=out["rerun"], **where)


def _f32_checks(torch, tag, cfg, f32_in, check_prompt, seed, mods=None, cross_extra=None,
                cross_over=None, **twin):
    """On the f32 twin: the prefill of ``f32_in`` against a replay through
    naive_attention (last logits within DENSE_F32_TOL of max|ref|), and
    decode vs prefill of a ``check_prompt``-token prompt (CROSS_TOL) on the
    twin's weights under ``cross_over`` (a config change for that check).
    ``cross_extra(model, params)`` -> (extra prefill inputs, cache) for
    whisper.  ``mods``: the modules whose ``flash_attention`` the prefill
    calls (``transformer`` when None)."""
    from repro_torch.models import common, transformer
    from repro_torch.models.model_api import build_model

    mods = mods or (transformer,)

    def naive(q, k, v, causal=True, q_chunk=None, k_chunk=None):
        return common.naive_attention(q, k, v, causal=causal)

    m, p = _f32_twin(torch, cfg, **twin)
    ref = _with_patches([(mod, "flash_attention", naive) for mod in mods],
                        lambda: m.prefill(p, f32_in))
    d_max, d_rms, _ = logits_gap(m.prefill(p, f32_in), ref)
    del ref
    if cross_over:
        m = build_model(dataclasses.replace(m.cfg, **cross_over), "cuda")
    extra, cache = cross_extra(m, p) if cross_extra else (None, None)
    c_max, c_rms, c_excess, c_launch = _cross_path(torch, m, p, check_prompt, seed, extra, cache)
    del m, p, extra, cache
    torch.cuda.empty_cache()
    line = dict(f32_twin=dict(twin), f32_logits_max_rel=d_max, f32_logits_rms_rel=d_rms,
                cross_prompt=check_prompt, cross_over=dict(cross_over or {}), cross_max_rel=c_max,
                cross_rms_rel=c_rms, cross_max_excess=c_excess, cross_decode_attn_launches=c_launch)
    say("[{tag}] f32 twin {f32_twin}: prefill vs the naive_attention replay max|d|/max|ref| "
        "{f32_logits_max_rel:.3e}, rms {f32_logits_rms_rel:.3e}; decode vs prefill of a "
        "{cross_prompt}-token prompt {cross_over} ({cross_decode_attn_launches} decode_attn "
        "launches): max|d|/max|ref| {cross_max_rel:.4e}, rms {cross_rms_rel:.4e}, max(|d| - rtol "
        "|ref|) {cross_max_excess:.3e}".format(tag=tag, **line))
    if d_max > DENSE_F32_TOL:
        fail(f"f32 {cfg.name} prefill vs the naive_attention replay: max|d|/max|ref| "
             f"{d_max:.3e} > {DENSE_F32_TOL}")
    if c_excess > CROSS_TOL["atol"]:
        fail(f"f32 {cfg.name} decode vs prefill of a {check_prompt}-token prompt: |d| exceeds "
             f"{CROSS_TOL['atol']} + {CROSS_TOL['rtol']} |ref| by {c_excess:.3e}")
    return line, c_launch


def _prefill_cell(torch, tag, model, params, batch_in, mods, positions, load_s, cache=None):
    """The counted prefill (the flash kernel once an attention site and no
    other kernel of the port: the products and the MoE einsums are
    torch.matmul), with the prompt's keys and values kept in ``cache``
    where given, then its readings."""
    _zero_counts(torch)
    t0 = time.perf_counter()
    if cache is None:
        logits = model.prefill(params, batch_in)
    else:
        logits = _prefill_into_cache(torch, model, params, batch_in, cache)
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    c = _counts()
    say(f"[{tag}] counts read after the {model.cfg.name} prefill path: {c}")
    if c != _prefill_counts(model.cfg):
        fail(f"the {model.cfg.name} prefill path launched {c}, not flash_attn x "
             f"{_attention_sites(model.cfg)} alone")
    B = batch_in["tokens"].shape[0]
    if tuple(logits.shape) != (B, model.cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        fail(f"{model.cfg.name} prefill returned {tuple(logits.shape)} logits, or non-finite ones")
    line = _prefill_where(torch, model, params, batch_in, mods, positions)
    line.update(arch=model.cfg.name, dtype=model.cfg.dtype, batch=B, load_s=load_s,
                first_wall_s=first_wall, launches=c)
    say("[{tag}] {arch} {dtype} prefill B={batch}, {prompt_positions} positions a row: "
        "load={load_s:.2f} s first={first_wall_s:.3f} s ms/prefill={ms_per_prefill:.3f} prompt "
        "positions/s={prompt_tokens_per_s:.1f} peak={peak_mem_gb:.2f} GB".format(tag=tag, **line))
    _say_where(f"{model.cfg.name} prefill", line)
    return logits, line


def whisper_cell(torch, report):
    """Phase (viii) (k): whisper-base at its published widths and depth."""
    from repro_torch.models import transformer, whisper

    cell = WHISPER
    model, params, load_s = _load_cut(torch, cell)
    cfg, B = model.cfg, cell["batch"]
    rng = np.random.default_rng(11)
    frames = torch.from_numpy(rng.standard_normal((B, cfg.encoder_seq, cfg.d_model),
                                                  dtype=np.float32)).cuda()
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, cell["text"]),
                                         dtype=np.int64)).cuda()
    batch_in = {"frames": frames.to(torch.bfloat16), "tokens": toks}
    mods = (transformer, whisper)
    _, pre = _prefill_cell(torch, "whisper", model, params, batch_in, mods,
                           cfg.encoder_seq + cell["text"], load_s)
    # serving: the encoder over the frames, their cross K/V, then greedy decode
    # from token 0 (as serve.run), self- and cross-attention through the kernel
    cache = whisper.encdec_prefill_cross(cfg, params, whisper.encode(cfg, params,
                                                                     batch_in["frames"]),
                                         model.init_cache(B, cell["text"]))
    first = torch.zeros((B,), dtype=torch.int32, device="cuda")
    n_tok = cell["tokens"]
    out = _serve_held(torch, model, params, cache, first, 0, n_tok, cell["text"], mods,
                      2 * cfg.n_layers, "whisper")
    where = _decode_where(torch, model, params, out["start_cache"], first, 0,
                          cell["profile_tokens"], cell["text"], out["wall"], n_tok)
    dec = _decode_line(cfg, B, 0, n_tok, out, where)
    _report_decode("whisper", cfg, dec, out)
    del model, params, out
    torch.cuda.empty_cache()

    def cross_extra(m, p):
        f1 = frames[:1]
        return {"frames": f1}, whisper.encdec_prefill_cross(
            m.cfg, p, whisper.encode(m.cfg, p, f1), m.init_cache(1, cell["check_prompt"]))

    f32, c_launch = _f32_checks(torch, "whisper", cfg, {"frames": frames[:2], "tokens": toks[:2]},
                                cell["check_prompt"], 12, mods, cross_extra)
    if c_launch != 2 * cfg.n_layers * cell["check_prompt"]:
        fail(f"the whisper decode check launched the decode kernel {c_launch} times")
    report["whisper"] = dict(prefill=pre, decode=dec, f32=f32)


def vlm_cell(torch, report):
    """Phase (viii) (l): llava-next-34b at its published widths, cut in depth."""
    cell = VLM
    model, params, load_s = _load_cut(torch, cell)
    cfg, B = model.cfg, cell["batch"]
    rng = np.random.default_rng(13)
    patches = torch.from_numpy(rng.standard_normal((B, cfg.n_patches, cfg.d_model),
                                                   dtype=np.float32)).cuda()
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, cell["text"]),
                                         dtype=np.int64)).cuda()
    batch_in = {"patch_embeds": patches.to(torch.bfloat16), "tokens": toks}
    prompt = cfg.n_patches + cell["text"]
    ctx = prompt + cell["tokens"]
    cache = model.init_cache(B, ctx)
    logits, pre = _prefill_cell(torch, "vlm", model, params, batch_in, None, prompt, load_s,
                                cache)
    first = torch.argmax(logits, dim=-1).to(torch.int32)
    out = _serve_held(torch, model, params, cache, first, prompt, cell["tokens"], ctx, None,
                      cfg.n_layers, "vlm")
    where = _decode_where(torch, model, params, out["start_cache"], first, prompt,
                          cell["profile_tokens"], ctx, out["wall"], cell["tokens"])
    dec = _decode_line(cfg, B, prompt, cell["tokens"], out, where)
    _report_decode("vlm", cfg, dec, out)
    del model, params, out, cache
    torch.cuda.empty_cache()
    f32, c_launch = _f32_checks(torch, "vlm", cfg, {"patch_embeds": patches[:2],
                                                    "tokens": toks[:2]},
                                cell["check_prompt"], 14)
    if c_launch != cfg.n_layers * cell["check_prompt"]:
        fail(f"the llava decode check launched the decode kernel {c_launch} times")
    report["vlm"] = dict(prefill=pre, decode=dec, f32=f32)


def moe_cell(torch, report, cell):
    """Phase (viii) (m) and (n): an MoE model at its published widths, cut
    in depth: prefill, decode from the prompt's cache, the f32 checks."""
    model, params, load_s = _load_cut(torch, cell)
    cfg, B, L = model.cfg, cell["batch"], cell["prompt"]
    tag = f"moe {cell['label']}"
    toks = torch.from_numpy(np.random.default_rng(15).integers(
        0, cfg.vocab_size, (B, L), dtype=np.int64)).cuda()
    ctx = L + cell["tokens"]
    cache = model.init_cache(B, ctx)
    tree_bytes = dict(params=_tree_bytes(params), cache=_tree_bytes(cache), ctx=ctx)
    logits, pre = _prefill_cell(torch, tag, model, params, {"tokens": toks}, None, L, load_s,
                                cache)
    first = torch.argmax(logits, dim=-1).to(torch.int32)
    out = _serve_held(torch, model, params, cache, first, L, cell["tokens"], ctx, None,
                      cfg.n_layers, tag)
    where = _decode_where(torch, model, params, out["start_cache"], first, L,
                          cell["profile_tokens"], ctx, out["wall"], cell["tokens"])
    dec = _decode_line(cfg, B, L, cell["tokens"], out, where)
    _report_decode(tag, cfg, dec, out)
    del model, params, out, cache, logits
    torch.cuda.empty_cache()
    # the cross check with capacity for every token (E/K): the reference's
    # capacity depends on a group's token count (the prompt's in prefill, one
    # in a decode step), and where it drops a token the paths differ
    E = cell["twin"].get("n_experts", cfg.n_experts)
    f32, c_launch = _f32_checks(torch, tag, cfg, {"tokens": toks[:2]}, cell["check_prompt"], 16,
                                cross_over=dict(capacity_factor=E / cfg.experts_per_token),
                                **cell["twin"])
    if c_launch != cfg.n_layers * cell["check_prompt"]:
        fail(f"the {cfg.name} decode check launched the decode kernel {c_launch} times")
    report[f"moe_{cell['label']}"] = dict(prefill=pre, decode=dec, f32=f32, tree_bytes=tree_bytes)


def new_families(torch, report):
    """Phase (viii): whisper (k), llava (l), llama4-maverick (m), qwen3-moe (n)."""
    whisper_cell(torch, report)
    phase_done("phase (viii) (k)")
    vlm_cell(torch, report)
    phase_done("phase (viii) (l)")
    for cell in MOE_CELLS:
        moe_cell(torch, report, cell)
        phase_done(f"phase (viii) ({cell['label']})")


def _train_cell(torch, report, cell):
    """Phase (ix) (o) or (p): ``launch.train.run`` at the published widths,
    the kernel counts set to 0 just before and read just after, every step's
    loss, grad norm and step counter held; then one step profiled."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.launch import train

    tag, arch, steps = f"train {cell['label']}", cell["arch"], cell["steps"]
    cfg = get_config(arch)
    widths = {k: getattr(cfg, k) for k in cell["widths"]}
    if widths != cell["widths"]:
        fail(f"{arch} is not at its published widths: {widths}")
    from repro_torch.kernels.ssd_scan.kernel_bwd import ssd_scan_bwd_cuda

    make, chunked, plain_grads = train.make_train_step, ssd_ref.ssd_chunked, ssd_ops.plain_grads
    seen, plain = [], dict(calls=0, backward=0)

    def recording(loss_fn, opt_cfg):
        step = make(loss_fn, opt_cfg)

        def wrapped(params, opt, batch):
            params, opt, metrics = step(params, opt, batch)
            seen.append(torch.stack([metrics["grad_norm"], opt.step.float()]))
            return params, opt, metrics

        return wrapped

    def counted_plain(*a):
        plain["calls"] += 1
        return chunked(*a)

    def counted_grads(*a):
        plain["backward"] += 1
        return plain_grads(*a)

    from repro_torch.kernels.mamba_passes.kernel import mamba_passes_cuda

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(torch)
    backwards, ssd_backwards = mamba_passes_cuda.backward_calls, ssd_scan_bwd_cuda.launches
    t0 = time.perf_counter()
    out = _with_patches(
        [(train, "make_train_step", recording), (ssd_ref, "ssd_chunked", counted_plain),
         (ssd_ops, "plain_grads", counted_grads)],
        lambda: train.run(arch, steps=steps, batch=cell["batch"], seq=cell["seq"], reduced=False,
                          ckpt_every=steps + 1, log_every=1, device="cuda"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = _counts()
    backwards = mamba_passes_cuda.backward_calls - backwards
    ssd_backwards = ssd_scan_bwd_cuda.launches - ssd_backwards
    peak = torch.cuda.max_memory_allocated() / 1e9
    say(f"[{tag}] counts read after the {arch} training path: {c}; Mamba pass block backwards "
        f"{backwards}; SSD backward kernel {ssd_backwards}; plain ssd_chunked {plain['calls']}, "
        f"plain SSD backward (plain_grads) {plain['backward']}")
    if c != dict(s2d_conv=0, decode_attn=0, ssd_scan=cell["ssd_calls"] * steps,
                 mamba_passes=cell["pass_calls"] * steps, flash_attn=0):
        fail(f"the {arch} training path launched {c}, not ssd_scan x {cell['ssd_calls']} and "
             f"mamba_passes x {cell['pass_calls']} x {steps} alone")
    if backwards != cell["pass_calls"] // 2 * steps:
        fail(f"the {arch} training path ran {backwards} Mamba pass block backwards, not "
             f"{cell['pass_calls'] // 2} x {steps}")
    if ssd_backwards != cell["ssd_calls"] // 2 * steps:
        fail(f"the {arch} training path launched the SSD backward kernel {ssd_backwards} times, "
             f"not {cell['ssd_calls'] // 2} x {steps}")
    if plain["calls"] or plain["backward"]:
        fail(f"the {arch} training path ran the plain SSD scan {plain['calls']} times and its "
             f"plain backward {plain['backward']} times")
    losses, lnv = out["losses"], float(np.log(cfg.vocab_size))
    gn, opt_steps = torch.stack(seen).cpu().numpy().T
    if len(losses) != steps or not np.isfinite(losses).all() or not np.isfinite(gn).all():
        fail(f"{arch} training: losses {losses}, grad norms {gn.tolist()}")
    if not 0.5 * lnv < losses[0] < 2 * lnv:
        fail(f"{arch} training: first loss {losses[0]:.4f} outside (0.5 ln V, 2 ln V) = "
             f"({0.5 * lnv:.3f}, {2 * lnv:.3f})")
    if opt_steps.tolist() != list(range(1, steps + 1)):
        fail(f"{arch} training: the optimiser's step counter read {opt_steps.tolist()}")
    B, L = cell["batch"], cell["seq"]
    ms = float(np.mean(out["step_s"][cell["warm"]:])) * 1e3
    line = dict(arch=arch, dtype=cfg.dtype, batch=B, seq=L, steps=steps, wall_s=wall,
                step_ms=[t * 1e3 for t in out["step_s"]], ms_per_step=ms,
                tokens_per_s=B * L / ms * 1e3, peak_mem_gb=peak, losses=losses,
                grad_norms=gn.tolist(), launches=c, ssd_backward_launches=ssd_backwards)
    say("[{tag}] {arch} {dtype} B={batch} L={seq}, {steps} steps ({warm} to warm up): "
        "ms/step={ms_per_step:.3f} tokens/s={tokens_per_s:.1f} peak={peak_mem_gb:.2f} GB; "
        "losses {lo}; grad norms {gno}".format(
            tag=tag, warm=cell["warm"], lo=[round(x, 5) for x in losses],
            gno=[round(x, 4) for x in gn.tolist()], **line))
    line.update(_train_where(torch, cfg, out.pop("params"), cell, ms))
    del out
    torch.cuda.empty_cache()
    report[f"train_{cell['label']}"] = line
    return line


def _train_where(torch, cfg, params, cell, ms_per_step):
    """One more step of the same model under torch.profiler, its forward and
    backward apart from its AdamW update; then its attention calls (o) or
    SSD backward calls (p) replayed alone: the shares of device time."""
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import transformer
    from repro_torch.models.model_api import build_model
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves, tree_map

    model = build_model(cfg, "cuda")
    batch = next(Pipeline(cfg, DataConfig(cell["batch"], cell["seq"], seed=1234),
                          start_step=cell["steps"], device="cuda"))
    opt_cfg = adamw.OptConfig(warmup_steps=max(1, cell["steps"] // 20), total_steps=cell["steps"])
    opt = adamw.init_opt_state(params)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    flash, plain_grads = transformer.flash_attention, ssd_ops.plain_grads
    ssd_bwd = ssd_ops.ssd_scan_bwd_cuda
    attn_calls, ssd_calls, grads = [], [], []

    def keep_flash(q, k, v, **kw):
        attn_calls.append((q.detach(), k.detach(), v.detach(), kw))
        return flash(q, k, v, **kw)

    def keep_bwd(x, la, B, C, dt, dy, chunk, needs):
        if len(ssd_calls) < TRAIN_SSD_REPLAY:
            ssd_calls.append(([t.detach() for t in (x, la, B, C, dt)], needs, chunk, dy.detach()))
        return ssd_bwd(x, la, B, C, dt, dy, chunk, needs)

    def fwd_bwd():
        loss = model.loss(params, batch)
        grads.append(torch.autograd.grad(loss, leaves))

    fb = device_activity(torch, lambda: _with_patches(
        [(transformer, "flash_attention", keep_flash), (ssd_ops, "ssd_scan_bwd_cuda", keep_bwd)],
        fwd_bwd))
    it = iter(grads.pop())
    g = tree_map(lambda _: next(it), params)
    upd = device_activity(torch, lambda: adamw.adamw_update(opt_cfg, params, g, opt))
    del g, opt, params, leaves
    fb_ms = sum(ms for _, ms in fb.values())
    upd_ms = sum(ms for _, ms in upd.values())
    dev_ms, n_dev = fb_ms + upd_ms, sum(n for n, _ in fb.values()) + sum(n for n, _ in upd.values())
    ssd_fwd_ms = sum(ms for name, (_, ms) in fb.items() if "ssd_scan" in name)
    # attention: the forward's calls (the first n_layers; the remat recomputes
    # repeat them) replayed forward and backward, and forward once more
    first = attn_calls[:cfg.n_layers]
    del attn_calls

    def attn_fb():
        for q, k, v, kw in first:
            q, k, v = (t.requires_grad_(True) for t in (q.clone(), k.clone(), v.clone()))
            o = flash(q, k, v, **kw)
            torch.autograd.grad(o, (q, k, v), torch.ones_like(o))

    def attn_f():
        with torch.no_grad():
            for q, k, v, kw in first:
                flash(q, k, v, **kw)

    attn_ms = (sum(ms for _, ms in device_activity(torch, attn_fb).values())
               + sum(ms for _, ms in device_activity(torch, attn_f).values())) if first else 0.0
    del first
    # the backward kernel and the plain backward on the same calls, side by side
    kernel_bwd = device_activity(torch, lambda: [ssd_bwd(*i, dy, q, n) for i, n, q, dy in ssd_calls])
    plain_bwd = device_activity(torch, lambda: [plain_grads(*a) for a in ssd_calls])
    ssd_bwd_layer = (sum(ms for _, ms in kernel_bwd.values()) / len(ssd_calls)) if ssd_calls else 0.0
    ssd_bwd_plain_layer = (sum(ms for _, ms in plain_bwd.values()) / len(ssd_calls)
                           if ssd_calls else 0.0)
    n_ssd_layers = cell["ssd_calls"] // 2
    if cell["ssd_calls"] and len(ssd_calls) != TRAIN_SSD_REPLAY:
        fail(f"the profiled {cfg.name} step kept {len(ssd_calls)} SSD calls, not "
             f"{TRAIN_SSD_REPLAY}")
    held = _train_ssd_held(torch, ssd_calls) if ssd_calls else None
    bwd_held = _train_ssd_bwd_held(torch, ssd_calls) if ssd_calls else None
    del ssd_calls
    torch.cuda.empty_cache()
    top = sorted(fb.items(), key=lambda kv: -kv[1][1])[:6]
    where = dict(
        device_ms_per_step=dev_ms, device_ops_per_step=n_dev,
        device_busy_share=dev_ms / ms_per_step if n_dev else None,
        forward_backward_ms=fb_ms, optimizer_ms=upd_ms,
        optimizer_share=upd_ms / dev_ms if n_dev else None,
        attention_ms=attn_ms, attention_share=attn_ms / dev_ms if n_dev else None,
        ssd_forward_ms=ssd_fwd_ms, ssd_backward_ms_per_layer=ssd_bwd_layer,
        ssd_backward_plain_ms_per_layer=ssd_bwd_plain_layer,
        ssd_forward_ms_per_call=ssd_fwd_ms / cell["ssd_calls"] if cell["ssd_calls"] else 0.0,
        ssd_share=(ssd_fwd_ms + ssd_bwd_layer * n_ssd_layers) / dev_ms if n_dev else None,
        ssd_held=held, ssd_bwd_held=bwd_held, top_device=[dict(name=k, ops=n, ms=ms) for k, (n, ms) in top])
    if n_dev:
        say("[where] train {label} ({arch}, one step profiled): device {device_ms_per_step:.3f} ms "
            "a step = {device_busy_share:.4f} of the unprofiled wall a step; {device_ops_per_step} "
            "device ops; forward and backward {forward_backward_ms:.3f} ms, AdamW "
            "{optimizer_ms:.3f} ms = {optimizer_share:.4f}; attention (its calls replayed alone, "
            "two forwards and a backward a layer) {attention_ms:.3f} ms = {attention_share:.4f}; "
            "SSD kernel {ssd_forward_ms:.3f} ms ({ssd_forward_ms_per_call:.4f} ms a call) + SSD "
            "backward kernel (its calls replayed alone) {ssd_backward_ms_per_layer:.3f} ms a layer "
            "= {ssd_share:.4f} of device time; the plain backward (recompute and autograd) on the "
            "same calls {ssd_backward_plain_ms_per_layer:.3f} ms a layer".format(
                label=cell["label"], arch=cfg.name, **where))
        for d in where["top_device"]:
            say(f"[where]   {d['ms']:.3f} ms in {d['ops']} x {d['name'][:100]}")
    else:
        say(f"[where] train {cell['label']}: device time not measured "
            "(torch.profiler recorded no device activity)")
    return where


def _train_ssd_held(torch, calls):
    """Phase (ix) (p): the SSD kernel at the training path's own shape and
    dtypes, on the inputs that calls of its profiled step gave it (the
    Function's saved x, log_a, B, C, dt): each call's output held against
    the plain ``ssd_chunked`` on the same inputs, a planted fault (the
    state dropped between chunks) read outside the limit, and the kernel,
    the plain version and the bound timed on the first call's inputs."""
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    def rel(got, ref):
        return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()

    sound = [rel(ssd_scan_cuda(*inputs, chunk), ssd_chunked(*inputs, chunk))
             for inputs, _, chunk, _ in calls]
    (x, la, B, C, dt), _, chunk, _ = calls[0]
    planted = rel(ssd_state_dropped(ssd_scan_cuda, x, la, B, C, dt, chunk),
                  ssd_chunked(x, la, B, C, dt, chunk))
    dn = str(x.dtype).split(".")[1]
    tol = SSD_TOL["bfloat16" if dn == "bfloat16" else "float32@prefill"]
    (Bt, L, H, Pd), N = x.shape, B.shape[-1]
    row = dict(shape=f"Bt{Bt}.L{L}.H{H}.P{Pd}.N{N}.Q{chunk}", dtypes=[
        str(t.dtype).split(".")[1] for t in (x, la, B, C, dt)], calls=len(calls),
        max_rel=max(sound), rel=sound, tol=tol, fault_rel=planted,
        kernel_ms=graph_ms(torch, lambda: ssd_scan_cuda(x, la, B, C, dt, chunk), 5),
        plain_ms=event_ms(torch, lambda: ssd_chunked(x, la, B, C, dt, chunk)),
        library_ms=None)
    row.update(ssd_floor(x, la, B, C, dt, chunk))
    row["bound_ms"], row["bound_by"] = bound(row["t_bytes_ms"], row["t_ops_ms"])
    say("[train] SSD kernel at (p)'s shape {shape} (x, log_a, B, C, dt in {dtypes}), {calls} "
        "calls of the profiled step: max|d|/max|ref| vs the plain ssd_chunked {max_rel:.3e} "
        "(limit {tol:.0e}); planted fault (state dropped between chunks) {fault_rel:.3e}; "
        "kernel_ms={kernel_ms:.5f} plain_ms={plain_ms:.5f} bound_ms={bound_ms:.5f} "
        "({bound_by})".format(**row))
    if max(sound) > tol:
        fail(f"the SSD kernel at (p)'s shape is {max(sound):.3e} of max|ref| from the plain "
             f"ssd_chunked (> {tol})")
    if planted <= tol:
        fail(f"the SSD limit {tol} at (p)'s shape passes the planted fault ({planted:.3e})")
    return row


def _train_ssd_bwd_held(torch, calls):
    """Phase (ix) (p): the SSD backward kernel on the calls of the profiled
    step (the Function's saved inputs and output gradient): each call's five
    gradients against ``ops.plain_grads`` on the same inputs, bf16 ones within
    SSD_BWD_ULPS bf16 ulps of max|ref| and f32 ones within SSD_BWD_F32; the
    kernel and the plain backward timed with CUDA events on the first call,
    beside the kernel's bound."""
    import math

    from repro_torch.kernels.ssd_scan.kernel_bwd import ssd_scan_bwd_cuda
    from repro_torch.kernels.ssd_scan.ops import plain_grads

    def gap(got, want):
        d = (got.float() - want.float()).abs().max().item()
        m = want.float().abs().max().item()
        if want.dtype == torch.bfloat16:
            return d / 2.0 ** (math.floor(math.log2(m)) - 7), SSD_BWD_ULPS
        return d / m, SSD_BWD_F32

    gaps = []
    for inputs, needs, chunk, dy in calls:
        got = ssd_scan_bwd_cuda(*inputs, dy, chunk, needs)
        want = plain_grads(inputs, needs, chunk, dy)
        gaps.append([gap(g, w) for g, w in zip(got, want) if w is not None])
    worst = max((g / lim, g, lim) for row in gaps for g, lim in row)
    (x, la, B, C, dt), needs, chunk, dy = calls[0]
    (Bt, L, H, Pd), N = x.shape, B.shape[-1]
    row = dict(shape=f"Bt{Bt}.L{L}.H{H}.P{Pd}.N{N}.Q{chunk}", calls=len(calls),
               gaps=[[g for g, _ in r] for r in gaps], worst_gap=worst[1], worst_limit=worst[2],
               kernel_ms=event_ms(torch, lambda: ssd_scan_bwd_cuda(x, la, B, C, dt, dy, chunk,
                                                                   needs), 5),
               plain_ms=event_ms(torch, lambda: plain_grads((x, la, B, C, dt), needs, chunk, dy)))
    row.update(ssd_bwd_floor(x, la, B, C, dt, chunk))
    row["bound_ms"], row["bound_by"] = bound(row["t_bytes_ms"], row["t_ops_ms"])
    say("[train] SSD backward kernel at (p)'s shape {shape}, {calls} calls of the profiled step: "
        "worst gradient gap {worst_gap:.3e} (limit {worst_limit:.0e}: bf16 ulps of max|ref|, "
        "or f32 max|d|/max|ref|); kernel_ms={kernel_ms:.5f} plain_ms={plain_ms:.5f} "
        "bound_ms={bound_ms:.5f} ({bound_by})".format(**row))
    if worst[0] > 1:
        fail(f"the SSD backward kernel at (p)'s shape is {worst[1]:.3e} from the plain backward "
             f"(> {worst[2]})")
    return row


def _train_layer_grads(torch, report):
    """Phase (ix): one mamba2 layer at its published widths in f32 at (p)'s
    batch and length, the SSD Function's input and weight gradients (its
    backward the backward kernel, launched once) against autograd through
    the plain ``ssd_chunked``, and the planted fault (no Function) read."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    from repro_torch.models import mamba2
    from repro_torch.models.model_api import build_model
    from repro_torch.models.transformer import _layer
    from repro_torch.tree import tree_items, tree_leaves, tree_map

    cell = TRAIN_LAYER
    cfg = dataclasses.replace(get_config(SSM["arch"]), dtype="float32", n_layers=1)
    block = _layer(build_model(cfg, "cuda").init(
        torch.Generator(device="cuda").manual_seed(0))["blocks"], 0)
    rng = np.random.default_rng(21)
    shape = (cell["batch"], cell["seq"], cfg.d_model)
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()
    r = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()

    def grads(scan):
        xs = x.clone().requires_grad_(True)
        ps = tree_map(lambda t: t.detach().clone().requires_grad_(True), block)
        y = _with_patch(mamba2, "ssd_scan", scan, lambda: mamba2.mamba_block_apply(cfg, ps, xs))
        # the planted fault leaves the scan's inputs (A_log, dt_bias) without a gradient
        return torch.autograd.grad((y * r).sum(), [xs] + tree_leaves(ps), allow_unused=True,
                                   materialize_grads=True)

    def detached(x_, la, B, C, dt, chunk):
        return ssd_scan_cuda(*(t.contiguous() for t in (x_, la, B, C, dt)), chunk)

    from repro_torch.kernels.ssd_scan.kernel_bwd import ssd_scan_bwd_cuda

    before, before_bwd = ssd_scan_cuda.launches, ssd_scan_bwd_cuda.launches
    got = grads(ssd_ops.ssd_scan)
    launched = ssd_scan_cuda.launches - before
    launched_bwd = ssd_scan_bwd_cuda.launches - before_bwd
    ref = grads(ssd_chunked)
    fault = grads(detached)

    def rel(a, b):
        return [((u - v).abs().max() / v.abs().max()).item() for u, v in zip(a, b)]

    names = ["x"] + [k for k, _ in tree_items(block)]
    sound, planted = rel(got, ref), rel(fault, ref)
    worst = max(range(len(names)), key=lambda i: sound[i])
    worst_fault = max(range(len(names)), key=lambda i: planted[i])
    line = dict(batch=cell["batch"], seq=cell["seq"], launches=launched,
                backward_launches=launched_bwd,
                rel=dict(zip(names, sound)), fault_rel=dict(zip(names, planted)))
    say(f"[train] SSD Function at one {cfg.name} layer, f32 B={cell['batch']} L={cell['seq']} "
        f"({launched} kernel calls, {launched_bwd} backward kernel calls): gradients vs autograd "
        f"through the plain ssd_chunked, worst "
        f"max|d|/max|ref| {sound[worst]:.3e} ({names[worst]}); the planted fault (the kernel's "
        f"output without the Function): worst {planted[worst_fault]:.3e} "
        f"({names[worst_fault]})")
    report["train_layer"] = line
    if launched != 1 or launched_bwd != 1:
        fail(f"the mamba2 layer's SSD Function launched the kernel {launched} times and the "
             f"backward kernel {launched_bwd} times, not once each")
    if sound[worst] > cell["tol"]:
        fail(f"SSD Function gradient of {names[worst]}: max|d|/max|ref| {sound[worst]:.3e} > "
             f"{cell['tol']}")
    if planted[worst_fault] < 100 * cell["tol"]:
        fail(f"the planted SSD backward fault reads only {planted[worst_fault]:.3e}")


def _train_twins(torch, report):
    """Phase (ix): the six families' reduced f32 train step on the card
    against the same step on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.models.model_api import build_model
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves, tree_map

    rows = {}
    for arch in TRAIN_TWINS:
        cfg = get_config(arch).reduced(dtype="float32")
        p_cpu = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
        host = synth_batch(cfg, DataConfig(global_batch=4, seq_len=48, seed=5), 0)

        def loss_grads(dev, params):
            m = build_model(cfg, dev)
            leaves = tree_leaves(params)
            for t in leaves:
                t.requires_grad_(True)
            loss = m.loss(params, {k: torch.from_numpy(v).to(dev) for k, v in host.items()})
            return loss.detach(), torch.autograd.grad(loss, leaves)

        p_card = tree_map(lambda t: t.detach().cuda(), p_cpu)
        before = ssd_scan_cuda.launches
        l_card, g_card = loss_grads("cuda", p_card)
        launched = ssd_scan_cuda.launches - before
        l_cpu, g_cpu = loss_grads("cpu", p_cpu)
        excess = max(((a.cpu() - b).abs() - CROSS_TOL["rtol"] * b.abs()).max().item()
                     for a, b in zip(g_card, g_cpu))
        loss_gap = abs(l_card.item() - l_cpu.item())
        # AdamW on both devices from the CPU's gradients
        opt_cfg = adamw.OptConfig(warmup_steps=1, total_steps=10)

        def update(dev):
            p = tree_map(lambda t: t.detach().to(dev, copy=True), p_cpu)
            it = iter(g_cpu)
            g = tree_map(lambda _: next(it).to(dev), p)
            return tree_leaves(adamw.adamw_update(opt_cfg, p, g, adamw.init_opt_state(p))[0])

        opt_gap = max(((a.cpu() - b).abs().max() / b.abs().max()).item()
                      for a, b in zip(update("cuda"), update("cpu")))
        rows[arch] = dict(loss_card=l_card.item(), loss_cpu=l_cpu.item(), loss_gap=loss_gap,
                          grad_max_excess=excess, ssd_launches=launched, opt_max_rel=opt_gap)
        say(f"[train] twin {cfg.name} ({cfg.family}): loss card {l_card.item():.6f} cpu "
            f"{l_cpu.item():.6f}; every gradient max(|d| - rtol |ref|) {excess:.3e}; AdamW on "
            f"the CPU's gradients max|d|/max|ref| {opt_gap:.3e}; SSD-kernel calls {launched}")
        want_ssd = 2 * cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
        if launched != want_ssd:
            fail(f"the reduced {arch} step called the SSD kernel {launched} times, not {want_ssd}")
        if loss_gap > CROSS_TOL["atol"] + CROSS_TOL["rtol"] * abs(l_cpu.item()):
            fail(f"reduced {arch} train step: loss on the card {l_card.item()} vs CPU "
                 f"{l_cpu.item()}")
        if excess > CROSS_TOL["atol"]:
            fail(f"reduced {arch} train step: a gradient exceeds the twins' TOL by {excess:.3e}")
        if opt_gap > TRAIN_OPT_TOL:
            fail(f"reduced {arch}: AdamW on the card is {opt_gap:.3e} of max|ref| from the CPU's")
    report["train_twins"] = rows


def _train_resume(torch, report):
    """Phase (ix): a reduced run on the card, checkpointed, its tail lost
    and resumed, against the uninterrupted run, in deterministic mode; then
    the same resume with each planted fault."""
    import os
    import shutil
    import tempfile

    from repro_torch.launch import train
    from repro_torch.optim.adamw import OptState
    from repro_torch.runtime.ft import Supervisor
    from repro_torch.tree import tree_map

    cell = RESUME
    kw = dict(steps=cell["steps"], batch=cell["batch"], seq=cell["seq"], reduced=True,
              ckpt_every=cell["every"], log_every=100, device="cuda")
    restore, pipeline = Supervisor.restore, train.Pipeline

    def moments_lost(self, step, like, device=None):
        state = restore(self, step, like, device)
        opt = state["opt"]
        return dict(state, opt=OptState(opt.step, tree_map(torch.zeros_like, opt.m),
                                        tree_map(torch.zeros_like, opt.v)))

    def data_from_zero(cfg, dcfg, start_step=0, device=None):
        return pipeline(cfg, dcfg, start_step=0, device=device)

    def gap(losses, tail):
        return (float(np.max(np.abs(np.subtract(losses, tail))))
                if len(losses) == len(tail) else float("inf"))

    # deterministic cuBLAS needs its workspace setting in the environment
    kept = (torch.are_deterministic_algorithms_enabled(), os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as d:
            whole = train.run(cell["arch"], ckpt_dir=f"{d}/whole", **kw)
            tail, gaps = whole["losses"][cell["every"]:], {}
            for name, patches in (("sound", []), ("moments_lost", [(Supervisor, "restore",
                                                                    moments_lost)]),
                                  ("data_from_zero", [(train, "Pipeline", data_from_zero)])):
                shutil.copytree(f"{d}/whole", f"{d}/{name}")
                shutil.rmtree(f"{d}/{name}/step_{cell['steps']:08d}")  # the "crash" lost the tail
                resumed = _with_patches(patches, lambda: train.run(
                    cell["arch"], ckpt_dir=f"{d}/{name}", **kw))
                gaps[name] = gap(resumed["losses"], tail)
    finally:
        torch.use_deterministic_algorithms(kept[0])
        if kept[1] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = kept[1]
    say(f"[train] resume on the card (reduced {cell['arch']}, {cell['steps']} steps, a checkpoint "
        f"every {cell['every']}, the last lost; deterministic algorithms): {len(tail)} steps rerun, "
        f"losses max|d| {gaps['sound']:.3e} from the uninterrupted run's (limit {cell['tol']:.0e}); "
        f"planted faults: moments left at zero {gaps['moments_lost']:.3e}, data restarted at "
        f"step 0 {gaps['data_from_zero']:.3e}")
    report["train_resume"] = dict(steps_rerun=len(tail), max_abs_diff=gaps["sound"],
                                  fault_moments_lost=gaps["moments_lost"],
                                  fault_data_from_zero=gaps["data_from_zero"])
    if gaps["sound"] > cell["tol"]:
        fail(f"the resumed run's losses are {gaps['sound']:.3e} from the uninterrupted run's "
             f"(> {cell['tol']})")
    for name in ("moments_lost", "data_from_zero"):
        if gaps[name] < 10 * cell["tol"]:
            fail(f"the planted resume fault {name} reads only {gaps[name]:.3e}")


def train_path(torch, report):
    """Phase (ix): llama3.2-1b (o) and mamba2-1.3b (p) trained at full width
    through ``launch.train.run``, then the checks of the training path."""
    for cell in TRAIN_CELLS:
        _train_cell(torch, report, cell)
        phase_done(f"phase (ix) ({cell['label']})")
    _train_layer_grads(torch, report)
    _train_twins(torch, report)
    _train_resume(torch, report)
    phase_done("phase (ix) checks")


def _tree_bytes(tree):
    from repro_torch.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _chunk_prediction(cfg, chunk, ctx, batch):
    """serve_runtime's one-card prediction of a decode chunk, and its
    memory term (weights and a full cache read a step), in ms."""
    from repro_torch.launch.analytics import HBM_BW, active_params, cache_bytes
    from repro_torch.models.model_api import ShapeSpec
    from repro_torch.runtime.serve_runtime import MeshPartition, decode_chunk_latency

    pred = decode_chunk_latency(cfg, MeshPartition("h100", 1, 0.0), chunk, ctx, batch)
    step_bytes = active_params(cfg) * 2 + cache_bytes(cfg, ShapeSpec("x", ctx, batch, "decode"))
    return pred * 1e3, chunk * step_bytes / HBM_BW * 1e3, step_bytes


def decode_floor_c(torch, report, model, params):
    """Phase (x.1) (c): one 16-token chunk of cell (c)'s loaded llama3.2-1b
    at the end of its 2048-position cache, the decode kernel's counts set
    to 0 just before and read just after: wall, device time (a profiled
    rerun) and busy share beside the one-card prediction; the prediction's
    memory term held under the measured device time."""
    from repro_torch.launch import serve

    cfg = model.cfg
    n, ctx, B = FLOOR["chunk"], FLOOR["ctx"], FLOOR["batch"]
    start = ctx - n
    cache = model.init_cache(B, ctx)
    first = torch.zeros((B,), dtype=torch.int32, device="cuda")

    def chunk():
        return serve.decode(model, params, tokens=n, batch=B, ctx=ctx, cache=cache,
                            start=start, first=first)

    chunk()  # warm: the kernel's grid at these bounds
    _zero_counts(torch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = chunk()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    c = _counts()
    say(f"[floor] counts read after the (c) chunk: {c}")
    if c != dict(s2d_conv=0, decode_attn=cfg.n_layers * n, ssd_scan=0, mamba_passes=0,
                 flash_attn=0):
        fail(f"the (c) decode chunk launched {c}, not decode_attn x {cfg.n_layers} x {n} alone")
    if tuple(seq.shape) != (B, n) or not bool(((seq >= 0) & (seq < cfg.vocab_size)).all()):
        fail(f"the (c) decode chunk returned {tuple(seq.shape)} ids, or ids outside the vocabulary")
    dev = device_activity(torch, chunk)
    dev_ms = sum(ms for _, ms in dev.values())
    pred_ms, mem_ms, step_bytes = _chunk_prediction(cfg, n, ctx, B)
    line = dict(arch=cfg.name, chunk=n, ctx=ctx, batch=B, start=start, launches=c,
                wall_ms=wall_ms, device_ms=dev_ms if dev else None,
                busy_share=dev_ms / wall_ms if dev else None, predicted_ms=pred_ms,
                predicted_memory_ms=mem_ms, predicted_step_bytes=step_bytes,
                device_over_predicted=dev_ms / pred_ms if dev else None,
                wall_over_predicted=wall_ms / pred_ms)
    report.setdefault("decode_floor", {})["c"] = line
    say("[floor] (c) {arch} bf16 B={batch}, a {chunk}-token chunk from position {start} of a "
        "{ctx}-position cache: wall {wall_ms:.3f} ms, device {device_ms} ms, busy {busy_share}; "
        "one-card prediction {predicted_ms:.4f} ms (memory term {predicted_memory_ms:.4f} ms, "
        "{predicted_step_bytes:.4e} bytes a step); device / predicted {device_over_predicted}, "
        "wall / predicted {wall_over_predicted:.3f}".format(**line))
    if not dev:
        fail("the (c) decode chunk: torch.profiler recorded no device activity")
    if mem_ms > dev_ms:
        fail(f"the (c) prediction's memory term {mem_ms:.4f} ms exceeds the measured device "
             f"time {dev_ms:.4f} ms: a wrong constant or count")


def decode_floor_m(torch, report):
    """Phase (x.1) (m): llama4-maverick at its cut depth, from phase (viii)'s
    own decode numbers: the prediction beside the measured device time a
    step, and the bytes the loaded trees hold beside what active_params
    counts (the dense dispatch reads every expert)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.analytics import HBM_BW

    (cell,) = [c for c in MOE_CELLS if c["label"] == "m"]
    got = report["moe_m"]
    cfg = dataclasses.replace(get_config(cell["arch"]), **cell["cut"])
    dec, tb, n = got["decode"], got["tree_bytes"], FLOOR["chunk"]
    dev_ms = dec["device_ms_per_step"] * n
    wall_ms = dec["ms_per_token"] * n
    pred_ms, mem_ms, step_bytes = _chunk_prediction(cfg, n, tb["ctx"], dec["batch"])
    line = dict(arch=cfg.name, n_layers=cfg.n_layers, chunk=n, ctx=tb["ctx"], batch=dec["batch"],
                device_ms=dev_ms, wall_ms=wall_ms, predicted_ms=pred_ms,
                predicted_memory_ms=mem_ms, active_step_bytes=step_bytes,
                tree_step_bytes=tb["params"] + tb["cache"],
                hbm_bytes_in_device_time=dec["device_ms_per_step"] / 1e3 * HBM_BW,
                device_over_predicted=dev_ms / pred_ms, wall_over_predicted=wall_ms / pred_ms)
    line["tree_over_active"] = line["tree_step_bytes"] / step_bytes
    report.setdefault("decode_floor", {})["m"] = line
    say("[floor] (m) {arch} at {n_layers} layers, B={batch}, cache {ctx}, 16 of phase (viii)'s "
        "steps: device {device_ms:.3f} ms, wall {wall_ms:.3f} ms; one-card prediction "
        "{predicted_ms:.4f} ms (memory term {predicted_memory_ms:.4f}); device / predicted "
        "{device_over_predicted:.3f}, wall / predicted {wall_over_predicted:.3f}".format(**line))
    say("[floor] (m) bytes a step: active_params counts {active_step_bytes:.4e} (the top-1 "
        "expert); the loaded weights and cache hold {tree_step_bytes:.4e} = "
        "{tree_over_active:.2f}x (the dense dispatch reads all 128 experts); the HBM rate "
        "moves {hbm_bytes_in_device_time:.4e} in the step's device time".format(**line))
    if mem_ms > dev_ms:
        fail(f"the (m) prediction's memory term {mem_ms:.4f} ms exceeds the measured device "
             f"time {dev_ms:.4f} ms: a wrong constant or count")


def serving_plane(torch, report):
    """Phase (x.2): bench_lm_serving's mix through the port's serving
    control plane on its H100 partitions: the heterogeneity table, then
    every scheduler's miss, accuracy loss and utilisation, with each
    model's request bookkeeping held."""
    from repro_torch.configs import get_config
    from repro_torch.core.scheduler import ALL_SCHEDULERS
    from repro_torch.runtime.serve_runtime import (
        ServingModel, build_serving_plan, default_partitions, serve_workload,
    )

    parts = default_partitions()
    models = [ServingModel(get_config(a), tokens_out=64, chunk=16, ctx_len=ctx, batch=b,
                           redundancy=r) for a, ctx, b, r in LM_MIX]
    rates, table = [], {}
    for sm, share in zip(models, LM_SHARES):  # bench_lm_serving._calibrated_rates
        probe = build_serving_plan(sm, parts, deadline=10.0, enable_variants=False)
        min_sum = float(probe.min_lat.sum())
        rates.append(round(min(share / min_sum, 1.0 / (min_sum * 1.3)), 1))
        table[sm.cfg.name] = [float(x) * 1e3 for x in probe.lat[0]]
    say(f"[plane] H100 partitions {[(p.name, p.n_chips, p.collective_overhead_s) for p in parts]}; "
        f"calibrated rates (req/s) {rates}")
    for name, ms in table.items():
        say(f"[plane]   ms a chunk on {[p.name for p in parts]}: {name} "
            f"{[round(x, 4) for x in ms]}")
    rows = []
    for sched in ALL_SCHEDULERS:
        t0 = time.perf_counter()
        res = serve_workload(models, rates, scheduler=sched, duration=LM_DURATION, seed=0)
        wall = time.perf_counter() - t0
        for m, s in res.per_model.items():
            if s.released != s.completed + s.dropped + s.in_flight:
                fail(f"[plane] {sched} model {m}: released {s.released} != completed "
                     f"{s.completed} + dropped {s.dropped} + in flight {s.in_flight}")
            if not 0.0 <= s.miss_rate <= 1.0:
                fail(f"[plane] {sched} model {m}: miss rate {s.miss_rate}")
        losses = [s.mean_norm_accuracy_loss for s in res.per_model.values() if s.completed]
        rows.append(dict(scheduler=sched, miss_rate_pct=100 * res.mean_miss_rate,
                         acc_loss_pct=100 * float(np.mean(losses)) if losses else 0.0,
                         util=float(np.mean(res.utilization())), wall_s=wall,
                         released=[s.released for s in res.per_model.values()]))
        say("[plane] {scheduler}: miss {miss_rate_pct:.2f}%, accuracy loss {acc_loss_pct:.3f}%, "
            "utilisation {util:.4f}, released {released} ({wall_s:.2f} s on the host)"
            .format(**rows[-1]))
    by = {r["scheduler"]: r["miss_rate_pct"] for r in rows}
    holds = by["terastal"] <= min(by["fcfs"], by["edf"], by["dream"]) + 1e-9
    say(f"[plane] read, not held: terastal <= the baselines on LM serving: {holds}")
    report["serving_plane"] = dict(partitions=[p.name for p in parts], rates=rates,
                                   chunk_ms=table, rows=rows, terastal_leq_baselines=holds)


def dry_run(torch, report):
    """Phase (x.3): the dry run of (h)'s prefill and (o)'s train step on
    ``meta``, its count held to dense_count, and the share of the H100's
    peak that (h)'s and (o)'s measured times give it."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.analytics import PEAK_FLOPS
    from repro_torch.models.model_api import ShapeSpec

    cfg = get_config(DENSE["arch"])
    measured = {"h": (report["dense_prefill"]["ms_per_prefill"], report["dense_prefill"]["device_ms"]),
                "o": (report["train_o"]["ms_per_step"], report["train_o"]["device_ms_per_step"])}
    rows = []
    for label, kind, L, B in DRYRUN_CELLS:
        shape = ShapeSpec(label, L, B, kind)
        rep = dryrun.run_cell(DENSE["arch"], shape, False, verbose=False)
        want = dryrun.dense_count(cfg, shape)
        wall_ms, dev_ms = measured[label]
        row = dict(cell=label, kind=kind, batch=B, seq=L, flops=rep["flops"], dense_count=want,
                   model_flops=rep["model_flops"], count_s=rep["count_s"],
                   argument_bytes=rep["argument_bytes"], fits_one_h100=rep["fits_one_h100"],
                   argument_bytes_per_device=rep["argument_bytes_per_device"],
                   measured_ms=wall_ms, device_ms=dev_ms,
                   peak_share=rep["flops"] / (wall_ms / 1e3 * PEAK_FLOPS),
                   peak_share_device=rep["flops"] / (dev_ms / 1e3 * PEAK_FLOPS) if dev_ms else None)
        rows.append(row)
        say("[dryrun] ({cell}) llama3.2-1b {kind} B={batch} L={seq} on meta: counted {flops:.6e} "
            "FLOPs (dense_count {dense_count:.6e}, model_flops {model_flops:.6e}; {count_s} s); "
            "arguments {argument_bytes:.4e} bytes (one H100: {fits_one_h100}; per device "
            "{argument_bytes_per_device}); over the measured {measured_ms:.3f} ms: "
            "{peak_share:.4f} of the H100's bf16 peak ({peak_share_device} over its device time)"
            .format(**row))
        if abs(rep["flops"] - want) > FLOP_RTOL * want:
            fail(f"the dry run of ({label}) counted {rep['flops']:.6e} FLOPs, not dense_count's "
                 f"{want:.6e} (rtol {FLOP_RTOL})")
    report["dryrun"] = rows


def main():
    _CLOCK[:] = [time.perf_counter()] * 2
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        fail(f"src/repro_torch not found beside {Path(__file__).name}: run it "
             "from the root of a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.core import (
        SATURATION_SCENARIOS, SCENARIOS, make_scheduler, simulate, simulate_batch,
    )
    from repro_torch.core.simulator import make_arrival_process
    from repro_torch.core.variant_exec import (
        pointwise_variants, run_pointwise_variants, variant_inputs,
    )
    from repro_torch.costmodel.maestro import PLATFORMS
    from repro_torch.kernels.decode_attn import kernel as dec_kernel
    from repro_torch.kernels.decode_attn.ops import gqa_decode_attention
    from repro_torch.kernels.decode_attn.ref import decode_attention
    from repro_torch.kernels.mamba_passes import kernel as mp_kernel
    from repro_torch.kernels.s2d_conv import kernel as s2d_kernel
    from repro_torch.kernels.s2d_conv.ref import s2d_conv_ref
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import kernel_bwd as ssd_bwd_kernel
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    from repro_torch.launch import serve
    from repro_torch.models import mamba2, transformer

    # the plain version and the library yardstick compute in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}

    # ---- 1. card -----------------------------------------------------------
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        fail(f"nvidia-smi did not run: {e}")
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed ({smi.returncode}): {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    say(f"[card] {card}")
    say(f"[card] torch {torch.__version__} cuda {torch.version.cuda} device {kind} x{count}")
    report["card"] = card
    report["device"] = kind

    # ---- 2. build: one nvcc per source, started together --------------------
    def timed_build(mod):
        t0 = time.perf_counter()
        lib = mod.build(verbose=True)
        return lib, time.perf_counter() - t0

    kernel_mods = {"s2d_conv": s2d_kernel, "decode_attn": dec_kernel, "ssd_scan": ssd_kernel,
                   "ssd_scan_bwd": ssd_bwd_kernel, "mamba_passes": mp_kernel}
    with ThreadPoolExecutor(len(kernel_mods)) as pool:
        futures = {name: pool.submit(timed_build, mod) for name, mod in kernel_mods.items()}
        built = {name: f.result() for name, f in futures.items()}
    report["build_s"] = {}
    for name, mod in kernel_mods.items():
        mod.load()
        lib, build_s = built[name]
        say(f"[build] {name} {lib.name} built and loaded in {build_s:.2f} s")
        report["build_s"][name] = build_s
    phase_done("build")

    # ---- 3. kernel against its plain version --------------------------------
    mc_plans, _ = SCENARIOS["multicam_heavy"].plans(PLATFORMS["6k_1ws2os"])
    main_layers = [v for p in mc_plans for v in pointwise_variants(p)]
    if not main_layers:
        fail("multicam_heavy plans select no pointwise variant layers")
    shapes = {}  # (H, W, C, K, g) -> label, test shapes first
    for _, H, W, C, K, g in TEST_SHAPES:
        shapes.setdefault((H, W, C, K, g), f"test[{H}x{W}x{C}->{K},g{g}]")
    for v in main_layers:
        shapes.setdefault((v.H, v.W, v.C, v.K, v.gamma), v.name)
    rng = np.random.default_rng(0)
    rows = []
    for (H, W, C, K, g), label in shapes.items():
        for batch in (1, 8):
            x32 = torch.from_numpy(rng.standard_normal((batch, H, W, C), dtype=np.float32)).cuda()
            w32 = torch.from_numpy(rng.standard_normal((C // (g * g), K // (g * g)),
                                                       dtype=np.float32)).cuda()
            for dtype in (torch.float32, torch.bfloat16):
                x, w = x32.to(dtype), w32.to(dtype)
                got = s2d_kernel.s2d_conv_cuda(x, w, g)
                ref = s2d_conv_ref(x, w, g)
                torch.cuda.synchronize()
                if got.shape != ref.shape or not bool(torch.isfinite(got.float()).all()):
                    fail(f"s2d_conv {label} B={batch} {dtype}: bad output {tuple(got.shape)}")
                err = (got.float() - ref.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                dn = str(dtype).split(".")[1]
                ok = err <= TOL[dn] * scale
                xm = x.reshape(-1, w.shape[0])
                row = dict(
                    shape=label, B=batch, dtype=dn, x=list(x.shape), w=list(w.shape),
                    max_abs_err=err, max_abs_ref=scale, tol=TOL[dn] * scale, ok=ok,
                    kernel_ms=graph_ms(torch, lambda: s2d_kernel.s2d_conv_cuda(x, w, g)),
                    plain_ms=graph_ms(torch, lambda: s2d_conv_ref(x, w, g)),
                    library_ms=graph_ms(torch, lambda: torch.matmul(xm, w)),
                    call_ms=paced_ms(torch, lambda: s2d_kernel.s2d_conv_cuda(x, w, g)),
                )
                row["t_bytes_ms"], row["t_ops_ms"] = floor_times(x, w, got)
                row["bound_ms"], row["bound_by"] = bound(row["t_bytes_ms"], row["t_ops_ms"])
                row["main_path"] = label in {v.name for v in main_layers}
                rows.append(row)
                say("[kernel] s2d_conv {shape} B={B} {dtype} x={x} w={w} "
                    "max_abs_err={max_abs_err:.3e} tol={tol:.3e} kernel_ms={kernel_ms:.5f} "
                    "plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} "
                    "bound_ms={bound_ms:.5f} ({bound_by}) call_ms={call_ms:.5f} "
                    "ok={ok}".format(**row))
                if not ok:
                    fail(f"s2d_conv {label} B={batch} {dn}: max|d| {err} > {TOL[dn]} * {scale}")
    say(f"[kernel] {len(rows)} comparisons within tolerance; "
        f"launches while comparing = {s2d_kernel.s2d_conv_cuda.launches}")
    report["kernel_rows"] = rows
    # the launch plan of each main-path GEMM (B=1)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gemms = {}
    for v in main_layers:
        g2 = v.gamma * v.gamma
        gemms.setdefault((v.H * v.W * g2, v.C // g2, v.K // g2), []).append(v.name)
    # and the kernel's time at every split the planner weighs (B=1, warm L2)
    report["s2d_plans"] = []
    for (M, Cv, Kv), names in gemms.items():
        x32 = torch.from_numpy(rng.standard_normal((1, M, 1, Cv), dtype=np.float32)).cuda()
        w32 = torch.from_numpy(rng.standard_normal((Cv, Kv), dtype=np.float32)).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            x, w = x32.to(dtype), w32.to(dtype)
            plan = s2d_kernel.plan_s2d(M, Cv, Kv, dtype, n_sm)
            line = dict(M=M, Cv=Cv, Kv=Kv, dtype=str(dtype).split(".")[1], layers=names,
                        tile=[s2d_kernel.TILE_M, s2d_kernel.TILE_N, plan.tile_k],
                        slabs=plan.slabs, split=plan.split, blocks=plan.blocks, sms=n_sm,
                        ms_by_split={S: graph_ms(torch, lambda S=S: s2d_kernel.s2d_conv_cuda(
                            x, w, 1, split=S)) for S in s2d_kernel.SPLITS if S <= plan.slabs})
            report["s2d_plans"].append(line)
            say("[plan] s2d_conv {M}x{Cv}x{Kv} {dtype} ({n} layers): tile {tile}, {slabs} slabs, "
                "split {split}, {blocks} blocks on {sms} SMs; ms by split ".format(
                    n=len(names), **line)
                + " ".join(f"{S}:{ms:.5f}" for S, ms in line["ms_by_split"].items()))

    dec_rows = []
    for B, L, H, Hkv, Dh, valid in DECODE_SHAPES:
        q32, k32, v32 = (
            torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda()
            for shape in ((B, 1, H, Dh), (B, L, Hkv, Dh), (B, L, Hkv, Dh))
        )
        pos = valid - 1
        vl = torch.full((B,), valid, dtype=torch.int32, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
            q3 = q[:, 0]
            got = dec_kernel.decode_attn_cuda(q3, k, v, vl, bound=valid)[:, None]
            ref = decode_attention(q, k, v, pos)
            torch.cuda.synchronize()
            if got.shape != ref.shape or not bool(torch.isfinite(got.float()).all()):
                fail(f"decode_attn B={B} L={L} valid={valid} {dtype}: bad output")
            d = (got.float() - ref.float()).abs()
            err = d.max().item()
            scale = ref.float().abs().max().item()
            dn = str(dtype).split(".")[1]
            if dtype == torch.float32:
                ok = bool((d <= 1e-5 + 1e-4 * ref.abs()).all())
                tol = 1e-5 + 1e-4 * scale
            else:
                tol = TOL["bfloat16"] * scale
                ok = err <= tol
            # the library yardstick: [B, H, 1, Dh] against the valid positions, transposed
            qt = q.transpose(1, 2)
            kt = k[:, :valid].transpose(1, 2).contiguous()
            vt = v[:, :valid].transpose(1, 2).contiguous()
            sdpa = torch.nn.functional.scaled_dot_product_attention
            row = dict(
                shape=f"B{B}.L{L}.H{H}.Hkv{Hkv}.Dh{Dh}", B=B, L=L, H=H, Hkv=Hkv, Dh=Dh,
                valid=valid, dtype=dn, path=NEW_PATH_SHAPES.get((B, L, H, Hkv, Dh)),
                splits=dec_kernel.plan_splits(B, Hkv, valid, 2 * Dh * q.element_size(), n_sm),
                max_abs_err=err, max_abs_ref=scale, tol=tol, ok=ok,
                kernel_ms=graph_ms(torch, lambda: dec_kernel.decode_attn_cuda(q3, k, v, vl,
                                                                              bound=valid)),
                plain_ms=graph_ms(torch, lambda: decode_attention(q, k, v, pos)),
                library_ms=graph_ms(torch, lambda: sdpa(qt, kt, vt, enable_gqa=True)),
                call_ms=paced_ms(torch, lambda: gqa_decode_attention(q, k, v, pos, vl)),
            )
            nbytes = (q.numel() + 2 * B * valid * Hkv * Dh + got.numel()) * q.element_size()
            if (B, L) == (SERVE["batch"], SERVE["ctx"]) or (B, L, H, Hkv, Dh) in NEW_PATH_SHAPES:
                # serving shapes: also cold-L2, on copies of the cache twice the L2 in all
                n_copies = int(-(-2 * L2_BYTES // nbytes))
                copies = [(k.clone(), v.clone()) for _ in range(n_copies)]
                row["cold_ms"] = cold_graph_ms(torch, [
                    lambda kc=kc, vc=vc: dec_kernel.decode_attn_cuda(q3, kc, vc, vl, bound=valid)
                    for kc, vc in copies])
                if dn == "bfloat16" and (H, Dh) in PLAN_HEADS:
                    # llama3.2-1b's and zamba2-2.7b's heads: the device kernels of
                    # one call, and the cold time of every split beside the planner's
                    # over four calls: the profiler may drop a window's first
                    # events, so the one kernel must be recorded in three or four
                    calls = 4
                    dev = device_activity(torch, lambda: [dec_kernel.decode_attn_cuda(
                        q3, k, v, vl, bound=valid) for _ in range(calls)])
                    row["device_kernels_per_call"] = len(dev)
                    row["device_launches_recorded"] = sum(n for n, _ in dev.values())
                    row["cold_ms_by_splits"] = {S: cold_graph_ms(torch, [
                        lambda kc=kc, vc=vc, S=S: dec_kernel.decode_attn_cuda(q3, kc, vc, vl,
                                                                                splits=S)
                        for kc, vc in copies]) for S in range(1, dec_kernel.MAX_SPLIT + 1)}
                    say(f"[plan] decode_attn {row['shape']} valid={valid} {dn}: device kernels "
                        f"per call {row['device_kernels_per_call']} ({sorted(dev)}, recorded in "
                        f"{row['device_launches_recorded']} of {calls} calls); planner "
                        f"splits {row['splits']}; cold ms by splits "
                        + " ".join(f"{S}:{ms:.5f}" for S, ms in row["cold_ms_by_splits"].items()))
                    if len(dev) != 1 or not calls - 1 <= row["device_launches_recorded"] <= calls:
                        fail(f"{calls} decode_attn calls ran device kernels {dev}, not 1 a call")
                copies = [(kc[:, :valid].transpose(1, 2).contiguous(),
                           vc[:, :valid].transpose(1, 2).contiguous()) for kc, vc in copies]
                row["library_cold_ms"] = cold_graph_ms(torch, [
                    lambda kc=kc, vc=vc: sdpa(qt, kc, vc, enable_gqa=True)
                    for kc, vc in copies])
                del copies
            row["t_bytes_ms"] = nbytes / HBM_BPS * 1e3
            row["t_ops_ms"] = 4.0 * B * H * valid * Dh / PEAK[dn] * 1e3
            row["bound_ms"], row["bound_by"] = bound(row["t_bytes_ms"], row["t_ops_ms"])
            dec_rows.append(row)
            cold = (" cold_ms={cold_ms:.5f} library_cold_ms={library_cold_ms:.5f}"
                    .format(**row) if "cold_ms" in row else "")
            say("[kernel] decode_attn {shape} valid={valid} {dtype} splits={splits} "
                "max_abs_err={max_abs_err:.3e} tol={tol:.3e} kernel_ms={kernel_ms:.5f} "
                "plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} "
                "bound_ms={bound_ms:.5f} ({bound_by}) call_ms={call_ms:.5f}".format(**row)
                + cold + f" ok={ok}")
            if not ok:
                fail(f"decode_attn {row['shape']} valid={valid} {dn}: max|d| {err} > tol {tol}")
    say(f"[kernel] {len(dec_rows)} decode_attn comparisons within tolerance; "
        f"launches while comparing = {dec_kernel.decode_attn_cuda.launches}")
    report["decode_rows"] = dec_rows

    report["ssd_rows"] = ssd_scan_rows(torch, rng)

    phase_done("kernel phase")

    # ---- 4. main paths ------------------------------------------------------
    # (i) the batched-trial engine and the variant layers
    cells = [
        ("a", SCENARIOS["multicam_heavy"], "6k_1ws2os", None, 8, 0.3),
        ("b", SATURATION_SCENARIOS["saturation_5x"], "4k_1ws2os", "poisson", 32, 0.1),
    ]
    _zero_counts(torch)
    runs = []
    for name, scen, plat, arrival, n_seeds, dur in cells:
        plans, tasks = scen.plans(PLATFORMS[plat])
        procs = None
        if arrival is not None:
            proc = make_arrival_process(arrival)
            procs = [t.arrival or proc for t in tasks]
        seeds = list(range(n_seeds))
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = simulate_batch(plans, tasks, dur, make_scheduler("terastal"), seeds,
                             processes=procs, device="cuda", stats=stats)
        wall = time.perf_counter() - t0
        runs.append((name, scen, plat, plans, tasks, procs, seeds, dur, res, stats, wall))
    # the variant layers of the models that applied variants in (a)
    _, _, _, a_plans, _, _, _, _, a_res, _, _ = runs[0]
    applied = sorted({m for r in a_res for m, s in r.per_model.items() if s.variants_applied})
    run_layers = [v for m in applied for v in pointwise_variants(a_plans[m])]
    t0 = time.perf_counter()
    outs = run_pointwise_variants([a_plans[m] for m in applied], device="cuda")
    torch.cuda.synchronize()
    var_wall = time.perf_counter() - t0
    launches = s2d_kernel.s2d_conv_cuda.launches
    say(f"[main] counts read after the main path: s2d_conv launches = {launches}, "
        f"decode_attn launches = {dec_kernel.decode_attn_cuda.launches}, "
        f"ssd_scan launches = {ssd_kernel.ssd_scan_cuda.launches}")
    if launches == 0:
        fail("the main path launched the s2d_conv kernel no time")

    # checks (after the counts were read; these launches are not counted)
    report["main"] = []
    for name, scen, plat, plans, tasks, procs, seeds, dur, res, stats, wall in runs:
        va = [sum(s.variants_applied for s in r.per_model.values()) for r in res]
        for s, r in zip(seeds, res):
            want = simulate(plans, tasks, dur, make_scheduler("terastal"), seed=s,
                            processes=procs, engine="soa").fingerprint()
            if r.fingerprint() != want:
                fail(f"cell ({name}) seed {s}: batch fingerprint != host soa")
        if name == "a" and min(va) <= 0:
            fail(f"cell (a) lanes applied no variants: {va}")
        it = stats["iterations"]
        line = dict(cell=name, scenario=scen.name, platform=plat, seeds=len(seeds),
                    duration=dur, wall_s=wall, trials_per_s=len(seeds) / wall,
                    iterations=it, max_it=stats["max_it"], us_per_iteration=wall / it * 1e6,
                    variants_applied=va, fingerprints_equal_soa=True)
        report["main"].append(line)
        say("[main] ({cell}) {scenario} @ {platform} terastal B={seeds} {duration} s: "
            "wall={wall_s:.3f} s trials/s={trials_per_s:.3f} iterations={iterations} "
            "(bound {max_it}) us/iteration={us_per_iteration:.1f} variants_applied={variants_applied} "
            "fingerprints == host soa".format(**line))
    max_err = 0.0
    for v, x, w in variant_inputs(run_layers, device="cuda"):
        out = outs[v.name]
        ref = s2d_conv_ref(x, w, v.gamma)
        if out.shape != (1, v.H, v.W, v.K) or not bool(torch.isfinite(out).all()):
            fail(f"variant layer {v.name}: bad output {tuple(out.shape)}")
        err = (out - ref).abs().max().item()
        if err > TOL["float32"] * ref.abs().max().item():
            fail(f"variant layer {v.name}: max|d| {err} vs plain")
        max_err = max(max_err, err)
    say(f"[main] {len(run_layers)} pointwise variant layers of models {applied} ran in "
        f"{var_wall * 1e3:.3f} ms wall; outputs match the plain version (max|d| {max_err:.3e})")

    # where the variant layers' time goes: one pass under torch.profiler
    dev = device_activity(torch, lambda: run_pointwise_variants(
        [a_plans[m] for m in applied], device="cuda"))
    dev_ms = sum(ms for _, ms in dev.values())
    n_dev = sum(n for n, _ in dev.values())
    s2d_ms = sum(ms for name, (_, ms) in dev.items() if "s2d_conv" in name)
    s2d_n = sum(n for name, (n, _) in dev.items() if "s2d_conv" in name)
    top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:5]
    report["variant_where"] = vw = dict(
        layers=len(run_layers), wall_ms=var_wall * 1e3, device_ms=dev_ms, device_ops=n_dev,
        device_busy_share=dev_ms / (var_wall * 1e3) if n_dev else None,
        s2d_conv_ms=s2d_ms, s2d_conv_kernels=s2d_n,
        s2d_conv_share=s2d_ms / dev_ms if n_dev else None,
        top_device=[dict(name=k, ops=n, ms=ms) for k, (n, ms) in top],
    )
    if n_dev:
        say("[where] variant layers: wall={wall_ms:.3f} ms; device busy {device_ms:.4f} ms = "
            "{device_busy_share:.4f} of the wall; {device_ops} device ops; s2d_conv "
            "{s2d_conv_ms:.4f} ms in {s2d_conv_kernels} kernels = {s2d_conv_share:.4f} of device "
            "time".format(**vw))
        for d in vw["top_device"]:
            say(f"[where]   {d['ms']:.4f} ms in {d['ops']} x {d['name'][:100]}")
    else:
        say("[where] variant layers: device time not measured "
            "(torch.profiler recorded no device activity)")

    # where the engine's time goes: cell (b) once more, under torch.profiler,
    # at a shorter horizon (every iteration runs the same ops; the profiler's
    # own host cost, and its sorting of a million events, stretch only this
    # run), so the device busy share is device time an iteration over the
    # unprofiled run's wall an iteration
    _, _, _, b_plans, b_tasks, b_procs, b_seeds, _, _, b_stats, b_wall = runs[1]
    p_stats = {}
    dev = device_activity(torch, lambda: simulate_batch(
        b_plans, b_tasks, WHERE_B_DURATION, make_scheduler("terastal"), b_seeds,
        processes=b_procs, device="cuda", stats=p_stats))
    it, p_it = b_stats["iterations"], p_stats["iterations"]
    dev_ms = sum(ms for _, ms in dev.values())
    n_dev = sum(n for n, _ in dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:5]
    report["where"] = where = dict(
        cell="b", iterations=it, wall_ms=b_wall * 1e3, profiled_duration=WHERE_B_DURATION,
        profiled_iterations=p_it, device_ms=dev_ms, device_ops=n_dev,
        device_ops_per_iteration=n_dev / p_it,
        device_busy_share=dev_ms / p_it / (b_wall * 1e3 / it) if n_dev else None,
        top_device=[dict(name=k, ops=n, ms=ms) for k, (n, ms) in top],
    )
    if n_dev:
        say("[where] (b): wall={wall_ms:.3f} ms over {iterations} iterations; profiled at "
            "{profiled_duration} s, {profiled_iterations} iterations: device busy {device_ms:.3f} "
            "ms, {device_busy_share:.4f} of the unprofiled wall an iteration; {device_ops} device "
            "ops ({device_ops_per_iteration:.1f} per iteration)".format(**where))
        for d in where["top_device"]:
            say(f"[where]   {d['ms']:.3f} ms in {d['ops']} x {d['name'][:100]}")
    else:
        say("[where] (b): device time not measured "
            "(torch.profiler recorded no device activity)")

    phase_done("phase (i)")

    # (ii) serving: llama3.2-1b at its published widths, bf16, through
    # serve.run's two halves so that the replay below reuses the weights
    arch, batch, ctx, n_tok = SERVE["arch"], SERVE["batch"], SERVE["ctx"], SERVE["tokens"]
    t0 = time.perf_counter()
    model, params = serve.load(arch, reduced=False, device="cuda", seed=0)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cfg = model.cfg
    if (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.dtype) != (16, 2048, 32, 8, 64, 8192, 128256,
                                                      "bfloat16"):
        fail(f"{arch} is not at its published widths: {cfg}")
    serve_heads = (cfg.n_heads, cfg.resolved_head_dim)
    kept = []  # every step's logits, for the replay
    decode_step = model.decode_step

    def keep_logits(p, t, c, pos):
        logits, c = decode_step(p, t, c, pos)
        kept.append(logits)
        return logits, c

    model.decode_step = keep_logits
    _zero_counts(torch)
    t0 = time.perf_counter()
    seq = serve.decode(model, params, tokens=n_tok, batch=batch, ctx=ctx)
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    dec_launches = dec_kernel.decode_attn_cuda.launches
    model.decode_step = decode_step
    say(f"[serve] counts read after the serving path: decode_attn launches = {dec_launches}, "
        f"s2d_conv launches = {s2d_kernel.s2d_conv_cuda.launches}, "
        f"ssd_scan launches = {ssd_kernel.ssd_scan_cuda.launches}")
    if dec_launches != cfg.n_layers * n_tok:
        fail(f"the serving path launched the decode kernel {dec_launches} times, "
             f"not {cfg.n_layers} x {n_tok}")

    # checks (after the counts were read): shape, ids, finite logits, then the
    # same steps through the plain attention, fed the kernel run's tokens
    if tuple(seq.shape) != (batch, n_tok) or len(kept) != n_tok:
        fail(f"serve returned {tuple(seq.shape)} ids and {len(kept)} logits")
    if not bool(((seq >= 0) & (seq < cfg.vocab_size)).all()):
        fail("serve returned ids outside the vocabulary")
    kernel_attention = transformer.gqa_decode_attention

    def plain_attention(q, k, v, pos, valid_len=None):
        return decode_attention(q, k, v, pos)

    # a planted fault: the kernel with the last valid position (the newest
    # token's own key and value) dropped from step 1 on, replayed beside the
    # plain one on the same tokens and read against the same limit
    def fault_attention(q, k, v, pos, valid_len=None):
        vl = torch.full((q.shape[0],), pos, dtype=torch.int32, device=q.device).clamp(min=1)
        return dec_kernel.decode_attn_cuda(q[:, 0], k, v, vl, bound=pos + 1)[:, None]

    stats, fault_stats, agree = [], [], 0
    try:
        cache = model.init_cache(batch, ctx)
        fault_cache = model.init_cache(batch, ctx)
        tok = torch.zeros((batch,), dtype=torch.int32, device="cuda")
        for i in range(n_tok):
            transformer.gqa_decode_attention = plain_attention
            ref, cache = model.decode_step(params, tok, cache, i)
            transformer.gqa_decode_attention = fault_attention
            bad, fault_cache = model.decode_step(params, tok, fault_cache, i)
            d = kept[i] - ref
            stats.append(torch.stack([d.abs().max(), ref.abs().max(),
                                      d.pow(2).mean().sqrt(), ref.pow(2).mean().sqrt()]))
            fd = bad - ref
            fault_stats.append(torch.stack([fd.abs().max(), fd.pow(2).mean().sqrt()]))
            agree += int((ref.argmax(-1) == seq[:, i]).sum())
            tok = seq[:, i]
    finally:
        transformer.gqa_decode_attention = kernel_attention
    del fault_cache
    if dec_kernel.decode_attn_cuda.launches != dec_launches + cfg.n_layers * n_tok:
        fail("the plain replay launched the decode kernel, or the faulty one did not")
    if not all(bool(torch.isfinite(lg).all()) for lg in kept):
        fail("serve produced non-finite logits")
    d_max, r_max, d_rms, r_rms = torch.stack(stats).cpu().numpy().T
    rel_max, rel_rms = d_max / r_max, d_rms / r_rms
    f_max, f_rms = torch.stack(fault_stats).cpu().numpy().T
    f_rel_max, f_rel_rms = f_max / r_max, f_rms / r_rms
    fault_inside = bool((f_rel_max <= SERVE_TOL["max"]).all() and (f_rel_rms <= SERVE_TOL["rms"]).all())
    for name, rel in (("max", rel_max), ("rms", rel_rms)):
        if not (rel <= SERVE_TOL[name]).all():
            i = int(np.argmax(rel))
            fail(f"serve step {i}: logits {name}|d| = {rel[i]:.4f} of {name}|ref| "
                 f"> {SERVE_TOL[name]}")
    del kept
    report["serve"] = serve_line = dict(
        arch=arch, batch=batch, ctx=ctx, tokens=n_tok, dtype=cfg.dtype, load_s=load_s,
        wall_s=serve_wall, ms_per_token=serve_wall / n_tok * 1e3,
        tokens_per_s=batch * n_tok / serve_wall, launches=dec_launches,
        logits_max_abs_err=float(d_max.max()), logits_max_abs_ref=float(r_max.max()),
        worst_max_rel=float(rel_max.max()), worst_max_rel_step=int(np.argmax(rel_max)),
        worst_rms_rel=float(rel_rms.max()), worst_rms_rel_step=int(np.argmax(rel_rms)),
        median_rms_rel=float(np.median(rel_rms)), argmax_agree=agree / (batch * n_tok),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        fault_worst_max_rel=float(f_rel_max.max()), fault_worst_rms_rel=float(f_rel_rms.max()),
        fault_median_max_rel=float(np.median(f_rel_max)),
        fault_median_rms_rel=float(np.median(f_rel_rms)), fault_inside_limit=fault_inside,
    )
    say("[serve] {arch} {dtype} B={batch} ctx={ctx} {tokens} tokens: load={load_s:.2f} s "
        "wall={wall_s:.3f} s ms/token={ms_per_token:.3f} tokens/s={tokens_per_s:.1f}; "
        "plain replay: logits max|d| {logits_max_abs_err:.4e} (max|ref| "
        "{logits_max_abs_ref:.3f}); worst step max|d|/max|ref| {worst_max_rel:.4f} (step "
        "{worst_max_rel_step}), rms|d|/rms|ref| {worst_rms_rel:.4f} (step "
        "{worst_rms_rel_step}, median {median_rms_rel:.4f}); argmax agrees "
        "{argmax_agree:.4f}".format(**serve_line))
    say("[serve] planted fault (the kernel without the newest position) vs the plain replay: "
        "worst step max|d|/max|ref| {fault_worst_max_rel:.4f} (median {fault_median_max_rel:.4f}), "
        "rms|d|/rms|ref| {fault_worst_rms_rel:.4f} (median {fault_median_rms_rel:.4f}); sound "
        "kernel {worst_max_rel:.4f}, {worst_rms_rel:.4f}; limits max {tol_max}, rms {tol_rms}: "
        "the fault reads {where} the limit".format(
            tol_max=SERVE_TOL["max"], tol_rms=SERVE_TOL["rms"],
            where="inside" if fault_inside else "outside", **serve_line))

    # where the serving time goes: the first steps of the decode loop once
    # more, under torch.profiler
    n_prof = SERVE["profile_tokens"]
    dev = device_activity(torch, lambda: serve.decode(model, params, tokens=n_prof,
                                                      batch=batch, ctx=ctx))
    dev_ms = sum(ms for _, ms in dev.values())
    n_dev = sum(n for n, _ in dev.values())
    dec_ms = sum(ms for name, (_, ms) in dev.items() if "decode_attn" in name)
    top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:6]
    report["serve_where"] = where = dict(
        steps=n_tok, wall_ms=serve_wall * 1e3, profiled_tokens=n_prof, device_ms=dev_ms,
        device_ops=n_dev, device_ops_per_step=n_dev / n_prof,
        device_busy_share=dev_ms / n_prof / (serve_wall * 1e3 / n_tok) if n_dev else None,
        decode_attn_ms=dec_ms, decode_attn_share=dec_ms / dev_ms if n_dev else None,
        top_device=[dict(name=k, ops=n, ms=ms) for k, (n, ms) in top],
    )
    if n_dev:
        say("[where] serve: wall={wall_ms:.3f} ms over {steps} steps; {profiled_tokens} steps "
            "profiled: device busy {device_ms:.3f} ms, {device_busy_share:.4f} of the unprofiled "
            "wall a step; {device_ops} device ops ({device_ops_per_step:.1f} per step); "
            "decode_attn {decode_attn_ms:.3f} ms = {decode_attn_share:.4f} of device time"
            .format(**where))
        for d in where["top_device"]:
            say(f"[where]   {d['ms']:.3f} ms in {d['ops']} x {d['name'][:100]}")
    else:
        say("[where] serve: device time not measured "
            "(torch.profiler recorded no device activity)")

    phase_done("phase (ii)")

    # (x.1) (c): a decode chunk of the loaded llama3.2-1b against the analytic floor
    decode_floor_c(torch, report, model, params)
    phase_done("phase (x.1) (c)")

    # (iii) ssm prefill: mamba2-1.3b at its published widths, bf16, after the
    # llama weights are freed
    del model, params, cache, seq
    torch.cuda.empty_cache()
    arch, Bp, Lp = SSM["arch"], SSM["batch"], SSM["prompt"]
    t0 = time.perf_counter()
    model, params = serve.load(arch, reduced=False, device="cuda", seed=0)
    torch.cuda.synchronize()
    ssm_load_s = time.perf_counter() - t0
    cfg = model.cfg
    if (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
            cfg.ssm_chunk, cfg.vocab_size, cfg.tie_embeddings, cfg.dtype) != (
            48, 2048, 4096, 64, 64, 128, 256, 50280, True, "bfloat16"):
        fail(f"{arch} is not at its published widths: {cfg}")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (Bp, Lp), dtype=np.int64)).cuda()
    batch_in = {"tokens": toks}
    _zero_counts(torch)
    t0 = time.perf_counter()
    logits = model.prefill(params, batch_in)
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    ssd_launches = ssd_kernel.ssd_scan_cuda.launches
    say(f"[prefill] counts read after the prefill path: ssd_scan launches = {ssd_launches}, "
        f"decode_attn launches = {dec_kernel.decode_attn_cuda.launches}, "
        f"s2d_conv launches = {s2d_kernel.s2d_conv_cuda.launches}")
    if ssd_launches != cfg.n_layers:
        fail(f"the prefill path launched the SSD kernel {ssd_launches} times, not {cfg.n_layers}")
    pass_calls = mp_kernel.mamba_passes_cuda.launches
    flash_calls = _counts()["flash_attn"]
    say(f"[prefill] mamba_passes block calls = {pass_calls}, flash_attn launches = {flash_calls}")
    if pass_calls != cfg.n_layers:
        fail(f"the prefill path ran the Mamba pass kernels in {pass_calls} block calls, not "
             f"{cfg.n_layers}")
    if flash_calls:
        fail(f"the prefill path of a model without attention launched the flash kernel "
             f"{flash_calls} times")

    # checks (after the counts were read): shape, finite, then the same prefill
    # with the plain ssd_chunked in place of the kernel
    if tuple(logits.shape) != (Bp, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
        fail(f"prefill returned {tuple(logits.shape)} logits, or non-finite ones")
    def prefill_with(scan, m, p, inp):
        return _with_patch(mamba2, "ssd_scan", scan, lambda: m.prefill(p, inp))

    def plain_scan(x, la, B, C, dt, chunk):
        return ssd_chunked(x, la, B, C, dt, chunk)

    def state_dropped(x, la, B, C, dt, chunk):
        return ssd_state_dropped(ssd_kernel.ssd_scan_cuda, x, la, B, C, dt, chunk)

    ref = prefill_with(plain_scan, model, params, batch_in)
    torch.cuda.synchronize()
    if ssd_kernel.ssd_scan_cuda.launches != ssd_launches:
        fail("the plain prefill replay launched the SSD kernel")
    # bf16: read, not held to a limit (see docstring)
    rel_max, rel_rms, agree = logits_gap(logits, ref)
    bad_max, bad_rms, _ = logits_gap(prefill_with(state_dropped, model, params, batch_in), ref)
    del ref
    # the same weights in f32 (kept for the decode check below), two prompts: the
    # kernel within the limit of the plain replay, the planted fault outside it
    f32_model, f32_params = _f32_twin(torch, cfg)
    f32_in = {"tokens": toks[:2]}
    ref32 = prefill_with(plain_scan, f32_model, f32_params, f32_in)
    f32_max, f32_rms, _ = logits_gap(f32_model.prefill(f32_params, f32_in), ref32)
    bad32_max, bad32_rms, _ = logits_gap(
        prefill_with(state_dropped, f32_model, f32_params, f32_in), ref32)
    del ref32
    say(f"[prefill] vs the plain replay, max|d|/max|ref| and rms|d|/rms|ref|: bf16 kernel "
        f"{rel_max:.4e} {rel_rms:.4e}, bf16 planted fault {bad_max:.4e} {bad_rms:.4e}; f32 kernel "
        f"{f32_max:.3e} {f32_rms:.3e}, f32 planted fault {bad32_max:.3e} {bad32_rms:.3e}")
    if not (f32_max <= PREFILL_F32_TOL["max"] and f32_rms <= PREFILL_F32_TOL["rms"]):
        fail(f"f32 prefill logits vs the plain replay: max|d|/max|ref| {f32_max:.3e}, "
             f"rms|d|/rms|ref| {f32_rms:.3e} (limits {PREFILL_F32_TOL})")
    if bad32_max <= PREFILL_F32_TOL["max"] and bad32_rms <= PREFILL_F32_TOL["rms"]:
        fail(f"the f32 prefill limits {PREFILL_F32_TOL} pass the planted fault "
             f"(max {bad32_max:.3e}, rms {bad32_rms:.3e})")
    # steady state: a timed prefill, its peak memory, then one under torch.profiler
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(params, batch_in)
    torch.cuda.synchronize()
    pre_wall = time.perf_counter() - t0
    dev = device_activity(torch, lambda: model.prefill(params, batch_in))
    dev_ms = sum(ms for _, ms in dev.values())
    n_dev = sum(n for n, _ in dev.values())
    ssd_ms = sum(ms for name, (_, ms) in dev.items() if "ssd_scan" in name)
    top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:6]
    report["prefill"] = pre_line = dict(
        arch=arch, batch=Bp, prompt=Lp, dtype=cfg.dtype, load_s=ssm_load_s,
        first_wall_s=first_wall, wall_s=pre_wall, ms_per_prefill=pre_wall * 1e3,
        prompt_tokens_per_s=Bp * Lp / pre_wall, launches=ssd_launches,
        logits_max_rel=rel_max, logits_rms_rel=rel_rms, argmax_agree=agree,
        fault_logits_max_rel=bad_max, fault_logits_rms_rel=bad_rms,
        f32_fault_logits_max_rel=bad32_max, f32_fault_logits_rms_rel=bad32_rms,
        f32_logits_max_rel=f32_max, f32_logits_rms_rel=f32_rms,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        device_ms=dev_ms, device_ops=n_dev,
        device_busy_share=dev_ms / (pre_wall * 1e3) if n_dev else None,
        ssd_scan_ms=ssd_ms, ssd_scan_share=ssd_ms / dev_ms if n_dev else None,
        top_device=[dict(name=k, ops=n, ms=ms) for k, (n, ms) in top],
    )
    say("[prefill] {arch} {dtype} B={batch} L={prompt}: load={load_s:.2f} s first={first_wall_s:.3f} s "
        "ms/prefill={ms_per_prefill:.3f} prompt tokens/s={prompt_tokens_per_s:.1f} "
        "peak={peak_mem_gb:.2f} GB; plain replay: logits max|d|/max|ref| {logits_max_rel:.4e}, "
        "rms|d|/rms|ref| {logits_rms_rel:.4e}, argmax agrees {argmax_agree:.4f}; in f32: "
        "max {f32_logits_max_rel:.3e}, rms {f32_logits_rms_rel:.3e}".format(**pre_line))
    if n_dev:
        say("[where] prefill: device busy {device_ms:.3f} ms = {device_busy_share:.4f} of the wall; "
            "{device_ops} device ops; ssd_scan {ssd_scan_ms:.3f} ms = {ssd_scan_share:.4f} of "
            "device time".format(**pre_line))
        for d in pre_line["top_device"]:
            say(f"[where]   {d['ms']:.3f} ms in {d['ops']} x {d['name'][:100]}")
    else:
        say("[where] prefill: device time not measured "
            "(torch.profiler recorded no device activity)")

    phase_done("phase (iii)")
    mamba_passes_row(torch, report)
    mamba_passes_backward_row(torch, report)
    phase_done("phase (iii.b)")
    flash_attn_row(torch, report)
    flash_gqa_row(torch, report)
    flash_mla_row(torch, report)
    phase_done("phase (iii.c)")
    moe_grouped_row(torch, report)
    phase_done("phase (iii.d)")

    # (iv) ssm decode: the O(1) recurrent step, which launches no kernel
    n_tok = SSM["tokens"]
    _zero_counts(torch)
    t0 = time.perf_counter()
    seq = serve.decode(model, params, tokens=n_tok, batch=Bp, ctx=n_tok)
    torch.cuda.synchronize()
    ssm_wall = time.perf_counter() - t0
    counts = (ssd_kernel.ssd_scan_cuda.launches, dec_kernel.decode_attn_cuda.launches,
              mp_kernel.mamba_passes_cuda.launches)
    say(f"[decode] counts read after the ssm decode path: ssd_scan launches = {counts[0]}, "
        f"decode_attn launches = {counts[1]}, mamba_passes block calls = {counts[2]}")
    if counts != (0, 0, 0):
        fail(f"the ssm decode path launched kernels: ssd_scan, decode_attn, mamba_passes = "
             f"{counts}")
    if tuple(seq.shape) != (Bp, n_tok) or not bool(((seq >= 0) & (seq < cfg.vocab_size)).all()):
        fail(f"ssm decode returned {tuple(seq.shape)} ids, or ids outside the vocabulary")
    n_prof = SSM["profile_tokens"]
    dev = device_activity(torch, lambda: serve.decode(model, params, tokens=n_prof, batch=Bp,
                                                      ctx=n_tok))
    dev_ms = sum(ms for _, ms in dev.values())
    n_dev = sum(n for n, _ in dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:6]
    # the JAX package's cross-path check at full width, in f32 as there: one
    # prompt of two chunks, token by token through decode_step, against prefill
    Lc = SSM["check_prompt"]
    c_max, c_rms, c_excess, _ = _cross_path(torch, f32_model, f32_params, Lc, 2)
    del f32_model, f32_params
    report["ssm_decode"] = sd_line = dict(
        arch=arch, batch=Bp, tokens=n_tok, dtype=cfg.dtype, wall_s=ssm_wall,
        ms_per_token=ssm_wall / n_tok * 1e3, tokens_per_s=Bp * n_tok / ssm_wall,
        ssd_scan_launches=counts[0], decode_attn_launches=counts[1],
        profiled_tokens=n_prof, device_ms_per_step=dev_ms / n_prof,
        device_ops_per_step=n_dev / n_prof,
        device_busy_share=dev_ms / n_prof / (ssm_wall / n_tok * 1e3) if n_dev else None,
        top_device=[dict(name=k, ops=n, ms=ms) for k, (n, ms) in top],
        cross_prompt=Lc, cross_max_rel=c_max, cross_rms_rel=c_rms, cross_max_excess=c_excess,
    )
    say("[decode] {arch} {dtype} B={batch} {tokens} tokens: wall={wall_s:.3f} s "
        "ms/token={ms_per_token:.3f} tokens/s={tokens_per_s:.1f}; f32 decode vs prefill of a "
        "{cross_prompt}-token prompt: max|d|/max|ref| {cross_max_rel:.4e}, rms|d|/rms|ref| "
        "{cross_rms_rel:.4e}, max(|d| - rtol |ref|) {cross_max_excess:.3e}".format(**sd_line))
    if n_dev:
        say("[where] ssm decode ({profiled_tokens} steps profiled): device {device_ms_per_step:.3f} "
            "ms a step = {device_busy_share:.4f} of the unprofiled wall a step; "
            "{device_ops_per_step:.1f} device ops a step".format(**sd_line))
        for d in sd_line["top_device"]:
            say(f"[where]   {d['ms']:.3f} ms in {d['ops']} x {d['name'][:100]}")
    else:
        say("[where] ssm decode: device time not measured "
            "(torch.profiler recorded no device activity)")
    if c_excess > CROSS_TOL["atol"]:
        fail(f"f32 decode vs prefill of a {Lc}-token prompt: |d| exceeds "
             f"{CROSS_TOL['atol']} + {CROSS_TOL['rtol']} |ref| by {c_excess:.3e}")

    phase_done("phase (iv)")

    # (vii) dense prefill, and the zamba2 hybrid's prefill and decode, after the
    # mamba2 weights are freed
    del model, params, seq
    torch.cuda.empty_cache()
    dense_prefill(torch, report)
    phase_done("phase (vii) (h)")
    hybrid(torch, report)
    phase_done("phase (vii) (i) and (j)")

    # (viii) the encdec, vlm and moe families at their published widths
    new_families(torch, report)

    # (ix) training at the published widths, then the training path's checks
    train_path(torch, report)

    # (v) the paper's method: no kernel of the port on this path
    _zero_counts(torch)
    paper_method(torch, report)
    counts = (s2d_kernel.s2d_conv_cuda.launches, dec_kernel.decode_attn_cuda.launches,
              ssd_kernel.ssd_scan_cuda.launches)
    say(f"[paper] counts read after phase (v): s2d_conv, decode_attn, ssd_scan launches = "
        f"{counts}")
    phase_done("phase (v)")
    if counts != (0, 0, 0):
        fail(f"phase (v) launched kernels of the port: {counts}")

    # (vi) the fault lane of the batched engine: no kernel of the port either
    _zero_counts(torch)
    fault_lane(torch, report)
    counts = (s2d_kernel.s2d_conv_cuda.launches, dec_kernel.decode_attn_cuda.launches,
              ssd_kernel.ssd_scan_cuda.launches)
    say(f"[faults] counts read after phase (vi): s2d_conv, decode_attn, ssd_scan launches = "
        f"{counts}")
    phase_done("phase (vi)")
    if counts != (0, 0, 0):
        fail(f"phase (vi) launched kernels of the port: {counts}")

    # (x) the serving control plane and the dry run: no kernel of the port
    _zero_counts(torch)
    decode_floor_m(torch, report)
    serving_plane(torch, report)
    dry_run(torch, report)
    counts = _counts()
    say(f"[plane] counts read after phase (x.1) (m), (x.2) and (x.3): {counts}")
    phase_done("phase (x)")
    if any(counts.values()):
        fail(f"phase (x) launched kernels of the port: {counts}")

    # ---- 5. kernels line -----------------------------------------------------
    # the main path's work: its variant layers once each, B=1, f32
    main_rows = {r["shape"]: r for r in rows if r["B"] == 1 and r["dtype"] == "float32"}
    sel = [main_rows[shapes[(v.H, v.W, v.C, v.K, v.gamma)]] for v in run_layers]
    bound_ms, bound_by = bound(sum(r["t_bytes_ms"] for r in sel),
                               sum(r["t_ops_ms"] for r in sel))
    entry = dict(
        name="s2d_conv", route="cuda", source="src/repro_torch/csrc/s2d_conv.cu",
        replaces="src/repro/kernels/s2d_conv/kernel.py:24",
        launches=launches, max_abs_err=max_err,
        ms=sum(r["kernel_ms"] for r in sel),
        plain_ms=sum(r["plain_ms"] for r in sel),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=sum(r["library_ms"] for r in sel),
    )
    # decode attention at the serving shape with the full cache valid, bf16; the
    # kernel and SDPA cold-L2, as a layer of the serving loop meets its cache
    (main,) = [r for r in dec_rows if (r["B"], r["L"], (r["H"], r["Dh"]), r["valid"], r["dtype"])
               == (batch, ctx, serve_heads, ctx, "bfloat16")]
    dec_entry = dict(
        name="decode_attn", route="cuda", source="src/repro_torch/csrc/decode_attn.cu",
        replaces="src/repro/kernels/decode_attn/kernel.py:24",
        launches=dec_launches, max_abs_err=main["max_abs_err"],
        ms=main["cold_ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=main["library_cold_ms"],
    )
    # the SSD scan at the prefill path's shape in the model's dtypes
    (main,) = [r for r in report["ssd_rows"]
               if r["path"] == SSM["arch"] and r["dtype"] == "bfloat16"]
    ssd_entry = dict(
        name="ssd_scan", route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:27",
        launches=ssd_launches, max_abs_err=main["max_abs_err"],
        ms=main["kernel_ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=None,
    )
    # the Mamba passes at the prefill cell's shape: the three kernels, no TPU kernel
    (main,) = [r for r in report["mamba_passes"] if r["arch"] == SSM["arch"]]
    passes_entry = dict(
        name="mamba_passes", route="cuda", source="src/repro_torch/csrc/mamba_passes.cu",
        replaces=None, launches=pass_calls, max_ulps=main["max_ulps"],
        ms=main["passes_ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by="bytes", library_ms=main["library_norm_ms"],
    )
    # prefill attention at zamba2-7b's site: no TPU kernel (XLA fused the lax version)
    fa = report["flash_attn"]
    flash_entry = dict(
        name="flash_attn", route="cuda", source="src/repro_torch/csrc/flash_attn.cu",
        replaces=None, launches=_flash_launches(report),
        row_rel=fa["row_rel"], ms=fa["ms"], plain_ms=fa["plain_ms"], bound_ms=fa["bound_ms"],
        bound_by=fa["bound_by"], library_ms=fa["sdpa_ms"],
    )
    report["kernels"] = [entry, dec_entry, ssd_entry, passes_entry, flash_entry]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    say(json.dumps({"kernels": report["kernels"]}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
