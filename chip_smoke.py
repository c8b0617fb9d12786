#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--out numbers.json] [--seed N]   # one GPU

Phases:
  1. device  — the card's name and power limit;
  2. build   — nvcc builds every kernel from ``src/repro_torch/csrc``
               (build seconds, ptxas registers / shared memory);
  3. kernels — each CUDA kernel at its AlexNet layer shapes (batch 8) held
               against its plain PyTorch version on the card, and timed
               beside it and beside its roofline bound: the conv kernels
               beside the F.conv2d-based ``conv2d_ref`` of the same layer,
               on f32 slabs and again on the ``conv_bfp`` slabs,
               the BFP matmul (fc6-fc8, bit-equal to its plain version,
               its pre-pass's bytes equal to ``quantize_activations``)
               beside the f32 ``x @ w`` that ``fc_bfp`` replaces (TF32
               off; timed only, the port never calls either);
  4. serve   — full-width AlexNet (random weights from a seed) through
               ``CnnEngine(max_batch=8)``, 32 requests in mixed group sizes,
               twice: on route ``pallas`` in f32 (agreement with the
               ``direct`` route), then with ``fc_bfp`` and ``conv_bfp``
               (agreement with the f32 model within the BFP error); each
               with launch counts and bit-equality to ``apply`` at the
               served bucket; then one more batch of 8 traced with
               ``torch.profiler`` (device busy ms, the conv kernels' device
               ms, the Winograd kernels' by stage, the device idle share);
  4b. sdc    — the ABFT/SDC defense at full width (f32, route ``pallas``):
               each conv layer's armed kernel bit-equal to its unarmed
               kernel with verdict 0 on a clean slab, its verdict equal to
               the plain version's count (and above 0) for 32 seeded
               single-bit flips a layer plus one each in a checksum row,
               in padding where the layer has any, in a sign and in an
               exponent bit, on the f32 slabs and on conv3's ``conv_bfp``
               slab, timed armed and unarmed; then BENCH_sdc's four
               scenarios through ``CnnEngine(max_batch=8)``: clean (16
               requests with the defense off and armed: bit-identical
               logits, no false positive, the overhead ratio), bitflip
               (every slab bit flip caught by the verdict, every request
               completed), verify (a flipped and a stale slab caught by
               their fingerprints before dispatch) and plausible (a finite
               1e8 logit offset screened); one ``sdc:`` line each;
  4c. autotune — the measured autotuner (``core/autotune.py``) over conv1-5
               at full width, batch 8, f32: every candidate block tile's
               output bit-equal to the default plan's, the armed kernel at
               each winning tile bit-equal to the unarmed default with
               verdict 0, tuned <= default device time in every layer;
               the cache written to a temporary file and 16 requests served
               through ``CnnEngine`` with it and with no plans, logits
               bit-equal and ``tuned_layers`` naming every layer with a
               hit; the reference's ``results/plans/alexnet.json`` loads no
               plan on the card; one ``autotune:`` line a layer (default
               and tuned ms, winning tile, candidates);
  3b. kernels-bf16 — kernels 1-3 at AlexNet's five layer shapes (batch 8)
               in bf16 (bf16 x and bias; the direct slab bf16, the
               Winograd slab f32, as the reference packs them): kernels
               2-3 bit-equal to the same kernel on the widened inputs
               rounded to bf16 at every block tile of their launcher,
               armed (verdict 0) and unarmed; kernel 1 on its bf16 slab
               (the tensor-core route) under rule (a)-(d) at every tile
               of its list (``mma_rule``), timed beside the f32 kernel on
               the widened inputs and each launch by name; each within
               one bf16 step of the plain version; the armed direct
               kernel's verdict equal to the plain count for 32 seeded
               flips and one each in a checksum row, a sign and an
               exponent bit of each bf16 slab (conv1, conv2); timed
               beside bf16 ``F.conv2d`` (cuDNN) and the bound;
  3c. kernels-vgg — kernels 2-3 at VGG-16's twelve layer geometries (224
               to 14 px, C_in 3 to 512, five with the 2x2/2 pool), batch
               8, f32 (within TOL_KERNEL of the plain version) and bf16
               (the bf16 rule, one bf16 step of the plain version), timed
               beside ``F.conv2d`` + pool and the bound; then the device
               ms of a whole VGG-16 feature pass in f32 and bf16;
  4e. alexnet-bf16 — 32 bf16 AlexNet requests through ``CnnEngine``:
               bit-equal to bf16 ``apply`` at the served bucket, within
               TOL_BF16 of the f32 model on the same weights; then
               BENCH_sdc's clean and bitflip scenarios in bf16;
  4d. vgg    — full-width VGG-16 (random weights from a seed) through
               ``CnnEngine(max_batch=8)`` on route pallas: 32 f32 requests
               (kernel 2 launched 8 and kernel 3 5 times a forward,
               bit-equal to ``apply``, within TOL_ROUTE of the direct
               route, one traced batch), then 16 bf16 requests (bit-equal
               to bf16 ``apply``, within TOL_BF16 of the f32 model);
  4f. fleet  — ``ModelRegistry(slot_budget=32)`` serving full-width
               AlexNet and VGG-16 (f32, max_batch=8): each warm engine's
               service ms at bucket 8, ``arm_slo(1.6 x service ms,
               admission=True)``, then a 3 s open-loop trace from
               ``--seed`` (AlexNet diurnal at 0.5x its capacity, VGG-16
               Poisson at 0.35x), held to the fleet benchmark's gates
               (every engine drained, shed requests reported and never
               served, the engines' counts equal to the front door's,
               accounting balanced); one ``fleet:`` line a model;
  4g. supervised — worker processes (``serving/supervisor.py``), each with
               its own CUDA context loading the parent's kernel build:
               (a) ``BENCH_supervisor``'s shape at full width: f32 AlexNet
               on route pallas, ``CnnServeConfig(max_batch=8)``, 2 workers,
               ``max_restarts=2``, 24 bursts of 3 every 15 ms, deadline
               2,000 ms, retries 3, served undisturbed and with
               ``worker.crash`` at w0's pump opportunity 8; (b) each worker
               serving f32 AlexNet and bf16 VGG-16 from a checkpoint
               directory, a second checkpoint torn (a byte of one leaf of
               each model flipped), w0 killed mid-flight and served through
               after its respawn.  Gates: balanced accounting, goodput > 0,
               the kill fails over requests bit-equal to ``apply``, every
               completed request bit-equal to ``apply`` at its served
               bucket, every worker on the card with conv launches > 0
               (the respawned one too), no degraded bucket, the respawn
               restored step 1 and step 1's bf16 leaves are init's bits;
               img/s, goodput, p50/p99, the kill-to-ready seconds;
  5. decode  — kernel 5 (decode attention) at smollm-360m's decode geometry
               (B=8, S=512, H=15, KV=5, D=64), llama3.2-3b's (H=24,
               KV=8, D=128, S=2048), the latter also with skewed lengths
               (one slot at S, seven at 1), granite-moe-1b-a400m's (H=16,
               KV=8, D=64, S=512), phi4-mini-3.8b's (H=24, KV=8,
               D=128, S=512), whisper-tiny's self decode (H=KV=6, D=64,
               S=448) and cross decode over 1,500 encoder rows (all
               full, and one slot full with seven at 750) and
               phi-3-vision-4.2b's (H=KV=32, D=96, S=1088: 576 patches
               and 512 text positions), f32 and bf16, held against its
               plain version (and, within one bf16 step, against the plain
               version with f32 probabilities, the kernel's arithmetic),
               two calls bit-equal, and timed in bf16 beside its bytes
               bound and ``scaled_dot_product_attention`` (timed only);
  6. lm      — full-width smollm-360m (random weights from a seed) through
               the token ``Engine(max_batch=8, max_len=512)``: 24 requests
               of 8-200 prompt tokens, 32 new tokens each, kernel 5 counted
               on every decode step, the logits of one mid-run step held
               against the plain decode attention on the same cache, and a
               reduced model's tokens against the CPU engine's;
  7. ssm     — kernel 6 (the chunked SSD scan) at mamba2-2.7b's served
               prefill geometry (L=200, one chunk) in bf16 and f32, at
               L=472 (two chunks) and at L=2048 (8 chunks) in bf16, and
               kernel 7 (the depthwise causal Winograd conv) on its x
               stream (C=5120, L=200 and 2048, bf16 and f32), each held
               against its plain version and timed beside its bound;
               kernel 6's launches timed apart from a ``torch.profiler``
               trace, kernel 7 also beside ``F.conv1d`` and beside a bare
               read and write of x's bytes (no single PyTorch call computes
               an SSD scan);
  8. mamba   — full-width mamba2-2.7b (64 layers, random weights drawn on
               the card from a seed) through ``Engine(max_batch=8,
               max_len=512)``: 24 requests of 8-480 prompt tokens, 32 new
               tokens each; kernels 6 and 7 counted on every layer of every
               prefill; one prefill re-run with the kernels and on the
               plain route (``pallas=False``), with f32 activations (the
               same function) and with the served bf16 ones (the kernels
               no further from the f32 model than the plain route); and a
               reduced model's tokens against the CPU engine's;
  9. train   — (a) kernel 7's backward at mamba2-2.7b's training shapes
               (x and dy (1, 512, 5120) and (1, 2048, 5120) bf16, (1, 512,
               5120) f32): dx bit-equal to flip(kernel 7(flip(dy))), dw
               within 1e-4 * max|dw| and db within one bf16 step of their
               plain versions, two wgrad runs bit-equal; timed beside the
               plain versions, the autograd backward of the same depthwise
               ``F.conv1d`` and the bound; (b) smollm-360m at published
               widths (f32 params, bf16 compute, remat) trained 30 steps of
               8 x 256 tokens through ``Trainer``: finite losses and grad
               norms, the loss falls, and so does the loss on step 0's
               batch from before the run to after it; step ms, tokens/s,
               peak memory, one
               traced step's device busy ms and idle share; (c) mamba2-2.7b
               at published widths (64 layers), 1 x 512 tokens: one loss
               and gradient on the kernel route against the plain route,
               in f32 activations within 1e-3 (loss) and 2e-2 * max|g|
               (each leaf), in the trained bf16 the loss within 1e-3 of the
               f32 loss and the gradients no further from the f32 ones than
               the plain route's; then 4
               ``Trainer`` steps, each launching kernel 7 128 times (the
               forward and the remat recompute), its backward kernels 64
               times each and kernel 6 never, and one more step traced;
               (d) recovery: smollm-360m's
               widths at 4 layers, 20 steps, a checkpoint every 10, a
               failure at step 15: one recovery that restored, the final
               params within rtol 1e-4, atol 1e-5 of an uninterrupted run;
               (e) granite-moe-1b-a400m at published widths (f32 params,
               bf16 compute, remat) trained 10 steps of 8 x 256 tokens
               through ``Trainer``, the router loss in every step: finite
               losses, router losses and grad norms, the loss on step 0's
               batch lower after the run than before it; step ms,
               tokens/s, peak memory, one traced step's idle share; (f)
               deepseek-v2-lite-16b's widths cut to its dense first layer
               and 3 MoE layers, 4 steps of 1 x 512: finite, and step 0's
               batch's loss falls too.
  10. moe    — (a) granite-moe-1b-a400m at published widths (f32
               parameters drawn on the card, bf16 activations) through
               ``Engine(max_batch=8, max_len=512, prefill_bucket=64)``: 24
               requests of 8-200 prompt tokens, 32 new tokens each; kernel
               5 launched 24 times a decode step; tok/s, p50/p99, peak
               memory and one traced decode step; (b) an f32-activation
               granite engine's decode step 12 re-run on copies of its
               cache with kernel 5 and with the plain decode attention:
               kernel 5 24 times then 0, every MoE layer routed alike,
               logits within 1e-4 * max|logit|; phi4-mini-3.8b (f32
               parameters) serving 4 requests of 8 tokens, kernel 5 32
               times a step; (c) deepseek-v2-lite-16b (bf16 parameters,
               31.4 GB, drawn on the card): 16 requests of 16 tokens, no
               kernel launched (MLA decodes in the absorbed form); (d) its
               f32 decode step re-run with the absorbed and the
               materialised MLA, held as in (b); (e) reduced granite and
               deepseek: the card's greedy tokens equal the CPU engine's.
  11. encdec/vlm — (a) whisper-tiny at published widths (4 + 4 layers,
               f32 parameters drawn on the card, bf16 activations) through
               ``Engine(max_batch=8, max_len=448, cross_len=1500)``: 24
               requests of 4-64 prompt tokens with 1,500 frames (750 for
               every third), 32 new tokens each; kernel 5 launched 8
               times a decode step (each decoder layer's self and cross
               decode); the probe step's logits of a full-frame and a
               half-frame slot against teacher forcing (``encdec.apply``
               over the same frames) within 5e-2 * max|logit|, and in an
               f32-activation engine within 1e-4; (b) phi-3-vision-4.2b
               at published widths (32 layers, MHA at head_dim 96, f32
               parameters drawn on the card, bf16 activations) through
               ``Engine(max_batch=8, max_len=512)``: 16 requests of 8-200
               prompt tokens with 576 x 1024 patches, 32 new tokens each,
               every one of them delivered; kernel 5 32 times a step; an
               f32 decode step with kernel 5 against the plain decode
               attention within 1e-4 * max|logit|; (c) reduced whisper and
               phi-3-vision: the card's greedy tokens equal the CPU
               engine's.
  12. hybrid — (a) jamba-v0.1-52b at published widths cut to two periods
               of 8 layers (2 attention, 14 Mamba-2 at d_state 16, 8 MoE
               of 16 experts top-2; 26.0 B bf16 parameters drawn on the
               card) through ``Engine(max_batch=8, max_len=512)``: 16
               requests of 8-200 prompt tokens, 16 new tokens each, every
               one delivered; kernel 5 launched 2 times a decode step,
               kernels 6 and 7 14 times a prefill; tok/s, p50/p99, peak
               memory, one traced decode step; (b) an f32-activation
               engine's decode step re-run with kernel 5 and with the
               plain decode attention, and a 200-token prefill with
               kernels 6 and 7 and on the plain route: logits within 1e-4
               * max|logit|, every MoE layer routed alike; (c) all 32
               layers as the reference's bfp8 serving weights (each layer
               drawn in bf16 on the card and compressed by
               ``quantize_linear_tree`` before the next; at the reduced
               config that build equals ``lm.init``'s tree compressed,
               bit for bit): resident and peak memory, 8 requests of 8-32 tokens, 8 new each, kernel
               5 4 times a step, kernels 6 and 7 28 times a prefill; (d)
               the reduced model as it is and BFP-compressed: the card's
               greedy tokens equal the CPU engine's.  Phases 5 and 7 hold
               and time kernel 5 at jamba's decode (G = 4) and kernels 6
               (N = 16) and 7 (8,192 channels) at its prefill shapes.
Slice 17's phases, in the order they run:
  3e. kernels-bf16-bfp — 3b's checks on a bf16 model's ``conv_bfp``
               slabs, which the reference dequantizes to f32: kernel 1
               with bf16 x on an f32 slab, kernels 2-3 on the BFP slabs,
               each bit-equal at every tile, armed and unarmed, to the f32
               kernel on the widened inputs rounded to bf16;
  3f. bfp-bf16 — kernel 4 at fc6-fc8 on a bf16 BFP model's activations:
               the pre-pass reads bf16 x, bit-equal to the f32 kernel on
               ``x.float()`` and to the plain version; timed beside the
               bf16 ``x @ w`` and the int8 stream's bound;
  3d. winograd-m — kernels 2-3 at AlexNet's conv3-conv5 (batch 8) at
               F(m,3), m in WINO_MS: within max(TOL_KERNEL, 3 e(m)) of the
               plain version (e(m) its own error against ``conv2d_ref`` in
               float64), every tile bit-equal to the default armed and
               unarmed, a flipped slab bit's verdict the plain count, the
               bf16 rule; timed in f32 and bf16 beside ``F.conv2d`` and the
               bound at F(m,3)'s own count;
  4h. serve-bf16-bfp — full-width AlexNet and VGG-16 in bf16 with
               ``fc_bfp`` and ``conv_bfp`` through ``CnnEngine(max_batch=
               8)``, 32 requests each: delivered, finite, bit-equal to
               ``apply``, within TOL_BF16 of the f32 model with the same
               quantization, and within TOL_BFP of the f32 model where
               the quantization's own error, measured by the kernels'
               plain versions on the CPU, is under it (else within that
               error + TOL_BF16: VGG-16); the card held to that witness
               layer by layer; kernels 1-4's launches, one traced batch;
               an armed bf16 BFP AlexNet's verdict 0 on clean slabs,
               bit-equal to unarmed;
  3d (after 8). kernel 7 at DW1D_TAPS taps (the reference's m for each)
               at mamba2-2.7b's (1,200,5120) and (1,2048,5120) bf16: the
               forward, dx (bit-equal to flip(kernel 7(flip(dy)))) and
               dw/db against their plain versions, timed beside
               ``F.conv1d`` (its autograd backward) and the bound; a
               reduced mamba2-2.7b at ``conv_kernel=3``: the card's tokens
               equal the CPU engine's, a training step's loss and
               gradients on the kernel route equal the plain route's
               within 9c's tolerances;
  9g. train-audio-vlm — whisper-tiny at published widths (4 + 4 layers)
               and phi-3-vision-4.2b's widths cut to 8 of 32 layers through
               ``Trainer`` (f32 params, bf16 compute, remat; whisper-tiny
               at lr 3e-3, phi-3-vision at TRAIN_VLM_SCHEDULE's 3e-4,
               each after 2 warmup steps), on batches with 128 frames or
               576 x 1,024
               patches a row: finite losses and grad norms, step 0's
               batch's loss lower after the run; step ms, tokens/s, peak
               memory, one traced step's idle share;
  14. mesh — the mesh on the card (``parallel/``, ``launch/mesh.py``): one
               NCCL rank (a ``HashStore``) and a (1, 1) ("data",
               "model") mesh; (a) ``Trainer(mesh=)`` trains smollm-360m
               at published widths (8 x 256, 3 steps) and mamba2-2.7b's
               widths cut to 4 layers (1 x 512, 3 steps: kernel 7 forward
               and backward inside the mesh step, counted), each held to
               the meshless ``Trainer`` from the same params (rtol 1e-4,
               atol 1e-5), step ms and peak memory beside the meshless
               run's; (b) ``reshard_state`` onto the same mesh and one
               more step, equal to continuing, and a ``save`` /
               ``restore(shardings=)`` round trip of the params with
               equal bits and placements; (c) ``CnnEngine(data_parallel=
               True)`` over the card's one-device mesh serves f32 AlexNet
               (32 requests in groups of 1-8), logits bit-equal to
               ``data_parallel=False``, img/s beside it; (d) ``bfp_psum``
               and ``make_compressed_grad_sync`` on the one-rank group
               return their input.  ``mesh:`` lines;
  13. model — the analytic model (``core/roofline.py``, ``core/dse.py``,
               ``core/winograd.py::conv2d_hbm_bytes``/``conv_flops``)
               against what this run measured, launching nothing (the
               paper's Fig. 9 check on the card): each AlexNet conv layer's
               roofline at batch 8 beside phase 3's kernel_ms (its
               t_compute equal to phase 3's operation bound, the kernel no
               faster than the model); the served forward (conv1-5 and
               fc6-8) beside phase 4's traced batch and its img/s as a
               share of the FP32 peak; smollm-360m's and
               granite-moe-1b-a400m's decode step by ``dse.lm_cost``
               beside their served steps (device ms at least the model's);
               smollm-360m's phase-9 step by ``model_flops_estimate`` as a
               share of the bf16 peak over its host and device ms (in
               (0, 1]).  One ``model:`` line an item;
  15. dryrun — the dry run (``launch/specs.py``, ``launch/dryrun.py``,
               ``core/opcount.py``), last: (a) ``python -m
               repro_torch.launch.dryrun`` on three cells at once
               (smollm-360m ``train_4k`` on 16x16, mamba2-2.7b
               ``decode_32k`` on 2x16x16, jamba-v0.1-52b ``decode_32k``
               in ``bfp8`` on 16x16: meta tensors in a fake world, no
               card), each record ``ok``; (b) smollm-360m's and
               mamba2-2.7b's decode steps and mamba2-2.7b's prefill at 8 x
               512, smollm-360m's train step at 8 x 256 (the steps of
               ``launch/specs.py``), each counted on meta, then run on the
               card from a seed: kernel launches by kernel equal to
               ``launch_counts()``, the counted peak over the arguments
               within 10% of ``max_memory_allocated()`` over the step's
               start, the modelled step ms beside the device ms.
               ``dryrun:`` lines.
  17. cnn-train — training the image models (``models/alexnet.py::
               loss_fn``), after phase 15: (a) full-width AlexNet at 227
               px, f32, batch 128, on route winograd (the plain Winograd
               transforms; conv1/conv2 through ``F.conv2d``), 2 warm-up
               and 5 timed AdamW steps on ``synthetic_images``: step ms,
               img/s, peak memory, finite losses, the loss on step 0's
               batch lower after the run, no port kernel launched, one
               step traced (device busy ms, idle share, top device ops),
               route winograd's gradients against route direct's on
               the whole batch: each conv layer's backward within 1e-3
               of its max, one step's through loss_fn within 3e-2 of
               each leaf's norm; (b) the same model
               in bf16, one timed step after one warm-up; (c) VGG-16 at
               224 px, f32, batch 16, 1 + 2 steps, as (a); (d) a gradient
               asked for on route pallas, under fc_bfp and under sdc_abft
               raises, naming the reason; (e) the example twins in this
               process: ``serve_batch_torch.py --arch alexnet --route
               pallas`` (kernels 1-3 launched), ``--arch smollm-360m``
               (kernel 5), ``quickstart_torch.py`` and
               ``alexnet_winograd_torch.py``, each printing its OK line.
               ``cnn-train:`` lines.
The last line is ``{"ok": true, "device": {...}}``; any failed check exits
nonzero, and so does a run without a card or without the repository.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
try:
    # the card's peaks, in the port's one place for them, and each kernel's
    # work function, the one the dry run counts with
    from repro_torch.core.roofline import H100_SXM as HW
    from repro_torch.kernels.conv.winograd import dw1d_bwd_work, dw1d_work
    from repro_torch.kernels.decode_attn.decode_attn import decode_work
    from repro_torch.kernels.ssd.ssd import ssd_work
except ImportError:     # no repository around the script: main() exits 2
    HW = None
# kernel vs its plain version: both FP32 with different summation orders;
# a TF32 or other lower-precision body would miss this by far
TOL_KERNEL = 1e-5           # max|diff| <= TOL_KERNEL * max|plain|
TOL_ROUTE = 1e-3            # served vs direct route: <= TOL_ROUTE * max|logit|
# BFP served vs the f32 model: the JAX package's own bound for fc_bfp and
# conv_bfp (tests/test_fused_pipeline.py), <= TOL_BFP * max|logit|
TOL_BFP = 5e-2
# a bf16 model served vs the f32 model on the same (bf16-representable)
# weights: the JAX package's bf16 bound (tests/test_serve_fleet.py),
# <= TOL_BF16 * max|logit|
TOL_BF16 = 5e-2
# kernel 5 vs its plain version: the JAX package's bounds for its decode
# kernel (tests/test_kernels.py), rtol = atol; in bf16 the plain version
# rounds its probabilities to bf16, the kernel keeps them in f32
TOL_DECODE = {"float32": 1e-5, "bfloat16": 5e-2}
# kernel 5 vs the plain version with f32 probabilities (the arithmetic of
# the TPU kernel and of the CUDA kernel), (atol, rtol): in bf16 the two
# differ by their rounding to bf16, at most one step (2**-7 relative)
TOL_DECODE_F32P = {"float32": (1e-5, 1e-5), "bfloat16": (1e-4, 1e-2)}
# served decode logits with kernel 5 vs the plain decode attention on the
# same cache: <= TOL_LM * max|logit| (bf16 activations through 32 layers)
TOL_LM = 2e-2
# (name, B, S, H, KV, D, lengths): smollm-360m's and llama3.2-3b's decode
# geometry with random lengths in [1, S], and llama3.2-3b's with one slot
# at S and the rest at 1 (the longest slot sets the time unless it is
# split); granite's and phi4-mini's; whisper-tiny's self cache (its 448
# positions full) and its cross cache of 1,500 encoder rows (all full, and
# one slot full with the rest at 750), MHA at D = 64; phi-3-vision-4.2b's
# 576 patches + 512 text positions, full, MHA at D = 96; jamba-v0.1-52b's
# GQA (G = 4, D = 128) over the served max_len
DECODE_GEOMETRIES = (("smollm-360m", 8, 512, 15, 5, 64, None),
                     ("llama3.2-3b", 8, 2048, 24, 8, 128, None),
                     ("llama3.2-3b skewed", 8, 2048, 24, 8, 128,
                      (2048, 1, 1, 1, 1, 1, 1, 1)),
                     ("granite-moe-1b-a400m", 8, 512, 16, 8, 64, None),
                     ("phi4-mini-3.8b", 8, 512, 24, 8, 128, None),
                     ("whisper-tiny self", 8, 448, 6, 6, 64, (448,) * 8),
                     ("whisper-tiny cross", 8, 1500, 6, 6, 64, (1500,) * 8),
                     ("whisper-tiny cross skewed", 8, 1500, 6, 6, 64,
                      (1500,) + (750,) * 7),
                     ("phi-3-vision-4.2b", 8, 1088, 32, 32, 96, (1088,) * 8),
                     ("jamba-v0.1-52b", 8, 512, 32, 8, 128, None))
LM_ARCH = "smollm-360m"
LM_REQUESTS = 24
LM_MAX_NEW = 32
LM_PROBE_STEP = 40          # the decode step whose logits are re-checked
# kernels 6 and 7 vs their plain versions: both f32 inside, with the same
# prefix sum of dt * A; in f32 max|diff| <= TOL_KERNEL * max|plain|; in
# bf16 the outputs round f32 values that differ by f32 noise, so they may
# differ by one bf16 step: |diff| <= BF16_STEP * |plain| + TOL_KERNEL *
# max|plain|; the SSD state is f32 in both (TOL_KERNEL)
BF16_STEP = 2.0 ** -7
# (name, B, L, H, P, G, N, chunk, dtype): mamba2-2.7b's heads at a served
# prefill length of one chunk (200 rows), at a served one of two chunks
# with a ragged last chunk (472 = 256 + 216, the state carried), and over
# 8 chunks (a long prompt, past the served max_len); jamba-v0.1-52b's 128
# heads at d_state 16 (under every state slice) at a served prefill and
# over 8 chunks
SSD_GEOMETRIES = (("served", 1, 200, 80, 64, 1, 128, 256, "bfloat16"),
                  ("served", 1, 200, 80, 64, 1, 128, 256, "float32"),
                  ("served 2 chunks", 1, 472, 80, 64, 1, 128, 256,
                   "bfloat16"),
                  ("8 chunks", 1, 2048, 80, 64, 1, 128, 256, "bfloat16"),
                  ("jamba served", 1, 200, 128, 64, 1, 16, 256, "bfloat16"),
                  ("jamba 8 chunks", 1, 2048, 128, 64, 1, 16, 256,
                   "bfloat16"))
# (name, B, L, C, dtype): mamba2-2.7b's x stream (C = d_inner), and
# jamba-v0.1-52b's (C = 8192)
DW1D_GEOMETRIES = (("served", 1, 200, 5120, "bfloat16"),
                   ("served", 1, 200, 5120, "float32"),
                   ("long", 1, 2048, 5120, "bfloat16"),
                   ("long", 1, 2048, 5120, "float32"),
                   ("jamba served", 1, 200, 8192, "bfloat16"),
                   ("jamba long", 1, 2048, 8192, "bfloat16"))
# the mamba probe: with f32 activations the kernels' route and the plain
# route (pallas=False: the pure-torch Winograd and chunked twins) are one
# function summed in other orders, <= TOL_SSM_F32 * max|logit| (the CPU
# tests' bound for the model); with the served bf16 activations the plain
# route rounds inside its conv and scan (its Winograd transform in bf16)
# while the kernels stay f32 inside, so the two differ by more than the
# kernels' own error: the kernels' logits must be no further from the f32
# model than the plain route's are
TOL_SSM_F32 = 1e-4
SSM_ARCH = "mamba2-2.7b"
SSM_PROMPTS = (8, 480)      # prompt lengths: some prefills span 2 chunks
BATCH = 8
# phase 9 (training): kernel 7's backward at mamba2-2.7b's training shapes
# (B, L, C, dtype); dw against its plain version within TOL_WGRAD *
# max|dw| (f32 sums of B * L terms in other orders), db also within one
# bf16 step where dy is bf16 (the reference rounds db to dy's dtype)
TRAIN_DW1D_GEOMETRIES = ((1, 512, 5120, "bfloat16"),
                         (1, 2048, 5120, "bfloat16"),
                         (1, 512, 5120, "float32"))
TOL_WGRAD = 1e-4
TRAIN_DENSE_ARCH = "smollm-360m"
TRAIN_DENSE_SHAPE = (8, 256, 30)      # batch, seq, steps
TRAIN_SSM_SHAPE = (1, 512, 4)         # two 256-token chunks
TRAIN_SSM_LAYERS = 64                 # all of mamba2-2.7b's
# the mamba probe: kernel route vs plain route (the reference model's own
# route: the pure-torch Winograd conv, differentiated); in f32 (one
# function) the loss within TOL_TRAIN_LOSS relative and each leaf's
# gradient within TOL_TRAIN_GRAD of its max|g|; in the trained bf16 the
# plain route rounds inside its Winograd transforms (its loss 1.45e-3 off
# the f32 one at full width) and the kernels stay f32 inside, so the
# kernels' bf16 loss must be within TOL_TRAIN_LOSS of the f32 loss and
# their gradients no further from the f32 ones than the plain route's
# (phase 8's rule)
TOL_TRAIN_LOSS = 1e-3                 # relative
TOL_TRAIN_GRAD = 2e-2                 # of each leaf's max|g|
# 9e, 9f: MoE training through Trainer at published widths (f32 params,
# bf16 compute, remat): granite-moe-1b-a400m whole, deepseek-v2-lite-16b
# cut to its dense first layer and 3 MoE layers; (batch, seq, steps)
TRAIN_MOE_SHAPE = (8, 256, 10)
TRAIN_MLA_SHAPE = (1, 512, 4)
TRAIN_MLA_LAYERS = 4
# their schedule: the trainer's default warmup (20 steps) is longer than
# these runs.  It was set after granite's stream loss rose at the default
# schedule (119.22 -> 119.68 in 10 steps); that loss is read on a new
# batch each step, whose patterns are new too, so both runs are held to
# the loss on step 0's batch before and after the run instead
TRAIN_MOE_SCHEDULE = {"base_lr": 3e-3, "warmup": 2}
# phase 10 (mixture of experts and MLA): granite-moe-1b-a400m (GQA + MoE
# on every layer: kernel 5 in each), phi4-mini-3.8b (dense GQA, 128-wide
# heads) and deepseek-v2-lite-16b (MLA + MoE after one dense layer: no
# kernel) at published widths through the token Engine; (requests, new
# tokens) of each, prompts of MOE_PROMPTS tokens (129-192 pad to 192, so
# the MoE's second group of 128 holds 64 zero rows)
MOE_ARCH = "granite-moe-1b-a400m"
MLA_ARCH = "deepseek-v2-lite-16b"
PHI_ARCH = "phi4-mini-3.8b"
MOE_SHAPE = (24, 32)
PHI_SHAPE = (4, 8)
MLA_SHAPE = (16, 16)
MOE_PROMPTS = (8, 200)
MOE_PROBE_STEP = 12
# the f32 probes (granite: kernel 5 against the plain decode attention;
# deepseek: the absorbed MLA decode against the materialised one) re-run
# one function summed in other orders: logits <= TOL_PROBE * max|logit|
# (the CPU tests' bound for the models), every MoE layer routed alike.  In
# bf16 the routers' near-ties flip under any rounding difference, so a
# bf16 comparison would measure routing, not the attention
TOL_PROBE = 1e-4
# phase 11 (encoder-decoder and vision-language serving) at published
# widths.  whisper-tiny through Engine(max_batch=8, max_len=448 (its
# decoder's context), cross_len=1500): (requests, new tokens), prompts of
# ENCDEC_PROMPTS tokens, 1,500 encoder frames a request and 750 for every
# third; kernel 5 twice a decoder layer a step, over the self and the
# cross cache.  The probe step's logits of a full-frame and a half-frame
# slot against teacher forcing (``encdec.apply`` in train mode over the
# same frames): in the served bf16 within TOL_BF16 * max|logit| (the two
# round in other places), in an f32-activation engine within TOL_PROBE
ENCDEC_ARCH = "whisper-tiny"
ENCDEC_SHAPE = (24, 32)
ENCDEC_PROMPTS = (4, 64)
ENCDEC_MAX_LEN = 448
ENCDEC_CROSS = 1500
# phi-3-vision-4.2b (MHA, head_dim 96) through Engine(max_batch=8,
# max_len=512): 576 x 1024 patches a request, prompts of VLM_PROMPTS
# tokens; every request gets its tokens (the reference retires them after
# 2: its max_len test counts the patch prefix)
VLM_ARCH = "phi-3-vision-4.2b"
VLM_SHAPE = (16, 32)
VLM_PROMPTS = (8, 200)
# phase 12 (the hybrid family): jamba-v0.1-52b at published widths.  (a)
# bf16 parameters drawn on the card, depth cut to HYBRID_PERIODS periods of
# 8 layers (2 attention, 14 Mamba, 8 MoE), through Engine(max_batch=8,
# max_len=512): (requests, new tokens), prompts of HYBRID_PROMPTS tokens;
# (b) an f32-activation engine's decode step and one prefill re-run on
# the plain routes (TOL_PROBE, every MoE layer routed alike); (c) all 32
# layers with every large linear BFP-compressed as the reference's bfp8
# serving dtype builds them (bf16, then quantize_linear_tree), each layer
# drawn and compressed before the next; (d) the reduced model's tokens
HYBRID_ARCH = "jamba-v0.1-52b"
HYBRID_PERIODS = 2
HYBRID_SHAPE = (16, 16)
HYBRID_PROMPTS = (8, 200)
HYBRID_PROBE_PROMPT = 200
HYBRID_BFP_SHAPE = (8, 8)
HYBRID_BFP_PROMPTS = (8, 32)
# ABFT: seeded single-bit flips a layer, beside one each in a checksum row,
# in padding, in a sign bit and in an exponent bit
# slice 17 (3d): kernels 2-3 at F(m,3) beside the served F(4,3), kernel 7
# at r taps beside the served 4 (the reference's m for each), and the
# reduced Mamba-2 served and trained at MAMBA_TAPS taps; within
# max(TOL_KERNEL, 3 e(m)) of max|y| of the plain version, e(m) the plain
# version's own error against conv2d_ref in float64 (the transform's
# conditioning grows with m)
WINO_MS = (2, 3, 6, 8, 10)
DW1D_TAPS = (2, 3, 5, 8, 11)
MAMBA_TAPS = 3
# 9g: whisper-tiny at published widths (batch, seq, steps; 128 frames a
# row, min(seq, 128)) and phi-3-vision-4.2b's widths cut to
# VLM_TRAIN_LAYERS layers (576 x 1,024 patches a row)
TRAIN_ENCDEC_SHAPE = (8, 256, 10)
TRAIN_VLM_SHAPE = (1, 512, 4)
VLM_TRAIN_LAYERS = 8
# phi-3-vision's widths (d_model 3,072) at 9e's lr 3e-3 took step 0's
# batch's loss from 10.77 up to 14.13 on an H100: its lr is scaled down
# with the width, as smollm-360m's 1e-3 is at d_model 960
TRAIN_VLM_SCHEDULE = {"base_lr": 3e-4, "warmup": 2}
# 4h's witness of the BFP quantization's own error: images of the f32 BFP
# model run by the kernels' plain versions on the host's CPU
WITNESS_IMAGES = 4
ABFT_FLIPS = 32
SDC_SEED = 0
ARRIVALS = (1, 3, 8, 5, 2, 7, 6)   # 32 requests in mixed group sizes
BF16_ARRIVALS = (1, 3, 8, 4)       # 16
TIMING_ITERS = 20
# the autotune phase: candidates a layer, timed calls a candidate (their
# median decides), requests served with and without the tuned plans
AUTOTUNE_BUDGET = 8
AUTOTUNE_ITERS = 10
AUTOTUNE_REQUESTS = 16
# BENCH_supervisor's shape (benchmarks/serve_fleet.py::run_supervised): a
# 2-worker fleet, the identical bursty trace served undisturbed and with
# worker.crash at w0's pump opportunity SUP_KILL_AT; goodput counts the
# images served within SUP_SLO_MS
SUP_BURSTS, SUP_BURST, SUP_GAP_S = 24, 3, 0.015
SUP_DEADLINE_MS = 2000.0
SUP_RETRIES = 3
SUP_SLO_MS = 300.0
SUP_KILL_AT = 8
SUP_RESTARTS = 2


# the card the token engines of phases 10 and 11 serve on
DEVICE = "cuda"


class CheckFailed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"


def time_ms(torch, fn, iters=TIMING_ITERS):
    """(device ms, host ms) of one call, each the mean over ``iters``
    samples of ``repro_torch.core.timing.CudaSampler``: device time by CUDA
    events around the call, the L2 flushed by a 64 MB read and a spin
    kernel queued ahead of the start event before each; host time, what
    the call takes to return (to enqueue its work)."""
    from repro_torch.core.timing import CudaSampler
    sampler = CudaSampler(fn)
    device = host = 0.0
    for _ in range(iters):
        d, h = sampler.sample()
        device += d
        host += h
    return device / iters / 1e3, host / iters / 1e3


def layer_cases(torch, np, cfg, params):
    """(kernel name, layer, spec, x, w, b, slab, plan) at the main path's
    shapes: each layer's input as the served forward gives it."""
    from repro_torch.models import alexnet
    from repro_torch.nn.conv import _kernel_weight_plan, _spec_fusion, \
        dispatch_conv, plan_knobs, resolve_kernel
    rng = np.random.default_rng(0)
    specs = [s.with_route("pallas") for s in alexnet.layer_specs(cfg)]
    slabs = alexnet.pack_serving_slabs(params, cfg, BATCH)
    x = torch.as_tensor(rng.standard_normal(
        (BATCH, cfg.image_size, cfg.image_size, cfg.in_channels)),
        dtype=alexnet.DTYPES[cfg.dtype], device="cuda")
    cases = []
    for i, spec in enumerate(specs):
        name = f"conv{i + 1}"
        p = params[name]
        kernel = resolve_kernel(spec, in_hw=x.shape[1])
        lrn, pool = _spec_fusion(spec)
        plan = _kernel_weight_plan(spec, kernel, tuple(x.shape),
                                   tuple(p["w"].shape), lrn=lrn, pool=pool,
                                   knobs=plan_knobs())
        kname = ("conv_direct" if kernel == "cuda-direct"
                 else "conv_winograd_fused" if plan.fused
                 else "conv_winograd")
        cases.append((kname, name, spec, x, p["w"], p["b"],
                      slabs[name].data, plan))
        # the next layer's input: this layer's output on the plain route
        x = dispatch_conv(spec.with_route("direct"), x, p["w"], p["b"])
    return cases


def flops_bytes(kname, x, out, plan, slab=None):
    """(operations, bytes) the layer must do and move: each input, weight,
    bias and output byte once (the slab's real entries, not its channel or
    K padding, which no kernel reads; at the slab's element size, 4 bytes
    when None), x, bias and output at their element size; multiply-adds
    count 2 operations, in the Winograd domain for the Winograd kernels
    at the plan's F(m,3) (``core.winograd.conv_flops``)."""
    from repro_torch.core.winograd import conv_flops
    m = None if kname == "conv_direct" else plan.m
    direct, wino = conv_flops(plan.out_h, plan.out_w, plan.C, plan.Kfull,
                              plan.r, m)
    madds = x.shape[0] * (direct if m is None else wino)
    taps = plan.r * plan.r if m is None else plan.n * plan.n
    weights = taps * plan.C * plan.Kfull
    wsize = 4 if slab is None else slab.element_size()
    nbytes = (x.element_size() * (x.numel() + plan.Kfull)
              + wsize * weights + out.element_size() * out.numel())
    return 2 * madds, nbytes


def conv_entry(kname, spec):
    """The kernel wrapper of one AlexNet layer as ``f(x, w, b, slab,
    **kw)`` (``checksum=True`` and ``verdict`` run the armed variant)."""
    from repro_torch.kernels.conv import direct, winograd
    lrn = spec.lrn if spec.fuse_lrn else None
    pool = (spec.pool_window, spec.pool_stride) if spec.fuse_pool else None
    if kname == "conv_direct":
        return functools.partial(
            direct.conv2d_direct, stride=spec.stride, padding=spec.padding,
            relu=True, groups=spec.groups, lrn=lrn, pool=pool)
    return functools.partial(winograd.conv2d_winograd, padding=spec.padding,
                             relu=True, groups=spec.groups, lrn=lrn,
                             pool=pool)


def phase_kernels(torch, np, cfg, params):
    """The conv kernels on ``cfg``'s serving slabs (BFP-quantized under
    ``cfg.conv_bfp``)."""
    from repro_torch.kernels.conv import direct, winograd
    from repro_torch.kernels.conv.ref import conv2d_ref
    slab_kind = "conv_bfp" if cfg.conv_bfp else "f32"
    rows = {}
    for kname, layer, spec, x, w, b, slab, plan in layer_cases(
            torch, np, cfg, params):
        lrn = spec.lrn if spec.fuse_lrn else None
        pool = (spec.pool_window, spec.pool_stride) if spec.fuse_pool else None
        entry = conv_entry(kname, spec)

        def kern():
            return entry(x, w, b, slab)

        if kname == "conv_direct":
            def plain():
                return direct.conv2d_direct_plain(x, slab, b, plan,
                                                  relu=True, lrn=lrn,
                                                  pool=pool)
        else:
            def plain():
                return winograd.conv2d_winograd_plain(x, slab, b, plan,
                                                      relu=True, lrn=lrn,
                                                      pool=pool)

        def library():
            return conv2d_ref(x, w, b, stride=spec.stride,
                              padding=spec.padding, groups=spec.groups,
                              relu=True, lrn=lrn, pool=pool)

        got = kern()
        torch.cuda.synchronize()
        ref = plain()
        check(got.shape == ref.shape, f"{layer}: shape {tuple(got.shape)} "
              f"!= {tuple(ref.shape)}")
        check(bool(torch.isfinite(got).all()), f"{layer}: non-finite output")
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        lib_err = float((got - library()).abs().max())
        (ms, host_ms), (plain_ms, _), (lib_ms, _) = (
            time_ms(torch, kern), time_ms(torch, plain),
            time_ms(torch, library))
        flops, nbytes = flops_bytes(kname, x, got, plan, slab)
        smem = (direct.smem_bytes if kname == "conv_direct"
                else winograd.smem_bytes)(plan)
        bound, bound_by = _bound(flops, nbytes)
        print(f"kernel {kname} {layer} ({slab_kind} slab): in "
              f"{tuple(x.shape)} out "
              f"{tuple(got.shape)} slab {tuple(slab.shape)} | max_abs_err "
              f"{err:.3e} (max|plain| {scale:.3e}, rel {err / scale:.3e}, "
              f"tol {TOL_KERNEL:g} rel; "
              f"vs conv2d_ref {lib_err:.3e}) | kernel_ms {ms:.4f} (host "
              f"enqueue {host_ms:.4f} ms) plain_ms "
              f"{plain_ms:.4f} library_ms(conv2d_ref, F.conv2d TF32 off) "
              f"{lib_ms:.4f} bound_ms {bound:.4f} ({bound_by}: "
              f"{flops:.3e} flop, {nbytes:.3e} B) | kernel_ms/library_ms "
              f"{ms / lib_ms:.3f} bound_ms/kernel_ms {bound / ms:.4f} | "
              f"dynamic smem/block {smem} B")
        check(err <= TOL_KERNEL * scale,
              f"{layer}: kernel disagrees with its plain version: {err} > "
              f"{TOL_KERNEL} * {scale}")
        row = rows.setdefault(kname, {
            "name": kname, "layers": [], "max_abs_err": 0.0, "ms": 0.0,
            "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
            "flop": 0, "bytes": 0, "per_layer": []})
        row["layers"].append(layer)
        row["per_layer"].append({
            "layer": layer, "in": list(x.shape), "out": list(got.shape),
            "slab": list(slab.shape), "max_abs_err": err,
            "max_abs_plain": scale, "ms": ms, "host_ms": host_ms,
            "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound, "bound_by": bound_by,
            "kernel_over_library": ms / lib_ms, "bound_over_kernel":
            bound / ms, "flop": flops, "bytes": nbytes, "smem_bytes": smem})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("bound_ms", bound), ("library_ms", lib_ms),
                         ("flop", flops), ("bytes", nbytes)):
            row[key] += val
    return rows


def phase_bfp(torch, np, cfg, params):
    """Kernel 4 at fc6, fc7 and fc8 with M = 8 rows: each layer's input as
    the served BFP forward gives it (conv features of the BFP config on the
    ``direct`` route, then the plain fc chain)."""
    from repro_torch.core import bfp as core_bfp
    from repro_torch.kernels.bfp_matmul import bfp_matmul as bfp
    from repro_torch.kernels.bfp_matmul.ops import fc_block, \
        quantize_weights
    from repro_torch.kernels.bfp_matmul.ref import exact_matmul
    from repro_torch.models import alexnet
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal(
        (BATCH, cfg.image_size, cfg.image_size, cfg.in_channels)),
        dtype=torch.float32, device="cuda")
    cfg_d = dataclasses.replace(cfg, use_winograd=False, use_pallas=False)
    x = alexnet.features(params, cfg_d, x)
    row = {"name": "bfp_matmul", "layers": [], "max_abs_err": 0.0,
           "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
           "flop": 0, "bytes": 0, "per_layer": []}
    for j in range(len(cfg.fc_dims)):
        layer = f"fc{j + 6}"
        w, b = params[layer]["w"], params[layer]["b"]
        K, N = w.shape
        block = fc_block(K)
        wq, we = quantize_weights(w, block=block)
        w_deq = core_bfp.dequantize(bfp.reference_layout(wq, block), we,
                                    axis=0)

        def kern():
            return bfp.bfp_matmul(x, wq, we, block=block)

        def plain():
            return bfp.bfp_matmul_plain(x, wq, we, block=block)

        def library():
            return exact_matmul(x, w_deq)

        got, scratch = bfp._bfp_matmul_cuda(x, wq, we, block=block)
        torch.cuda.synchronize()
        ref = plain()
        words, exps = bfp.quantize_activations(x, block)
        check(torch.equal(scratch[:words.numel()].view(words.shape), words)
              and torch.equal(scratch[words.numel():].view(exps.shape), exps),
              f"{layer}: the pre-pass's bytes differ from "
              "quantize_activations")
        check(got.shape == ref.shape == (BATCH, N),
              f"{layer}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
        check(bool(torch.isfinite(got).all()), f"{layer}: non-finite output")
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        lib_err = float((got - library()).abs().max())
        (ms, host_ms), (plain_ms, _), (lib_ms, _) = (
            time_ms(torch, kern), time_ms(torch, plain),
            time_ms(torch, library))
        flops = 2 * BATCH * K * N
        nbytes = (4 * x.numel() + wq.numel() + we.numel()
                  + 4 * got.numel())
        bound, bound_by = _bound(flops, nbytes, "int8")
        print(f"kernel bfp_matmul {layer}: x {tuple(x.shape)} w ({K}, {N}) "
              f"block {block} grid {bfp.bfp_grid(BATCH, N)} (pre-pass bytes "
              f"= quantize_activations) | max_abs_err {err:.3e} (max|plain| "
              f"{scale:.3e}, gate: bit-equal; vs f32 x @ w_deq {lib_err:.3e})"
              f" | kernel_ms {ms:.4f} (host enqueue {host_ms:.4f} ms) "
              f"plain_ms {plain_ms:.4f} library_ms(the f32 FC that fc_bfp "
              f"replaces, x @ w TF32 off; not the same function) "
              f"{lib_ms:.4f} bound_ms {bound:.4f} ({bound_by}: "
              f"{flops:.3e} int8 op, {nbytes:.3e} B)")
        check(torch.equal(got, ref), f"{layer}: kernel is not bit-equal to "
              f"its plain version (max|diff| {err})")
        row["layers"].append(layer)
        row["per_layer"].append({
            "layer": layer, "in": list(x.shape), "w": [K, N],
            "block": block, "grid": list(bfp.bfp_grid(BATCH, N)),
            "max_abs_err": err, "max_abs_plain": scale,
            "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound, "bound_by": bound_by,
            "flop": flops, "bytes": nbytes})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("bound_ms", bound), ("library_ms", lib_ms),
                         ("flop", flops), ("bytes", nbytes)):
            row[key] += val
        x = ref + b
        if j < len(cfg.fc_dims) - 1:
            x = torch.relu(x)
    return row


def _count_modules():
    from repro_torch.kernels.bfp_matmul import ops as bfp_ops
    from repro_torch.kernels.conv import ops
    from repro_torch.kernels.decode_attn import ops as dec_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    return ops, bfp_ops, dec_ops, ssd_ops


def launch_counts():
    counts = {}
    for mod in _count_modules():
        counts.update(mod.launch_counts())
    return counts


def reset_launch_counts():
    for mod in _count_modules():
        mod.reset_launch_counts()


def warm_buckets(eng, requests):
    """Pack every bucket's slabs and launch each shape once, then zero the
    engine's metrics."""
    warm = requests(sum(eng.buckets))
    for size in eng.buckets:
        for r in warm[:size]:
            eng.submit(r)
        warm = warm[size:]
        eng.run_until_done()
    eng.reset_metrics()


def conv_launches_per_forward(cfg):
    """Conv-kernel launches one forward of ``cfg`` on route pallas makes:
    the direct kernel's, and the Winograd kernels' unfused and fused."""
    from repro_torch.models import alexnet
    from repro_torch.nn.conv import resolve_kernel
    counts = {"conv_direct": 0, "conv_winograd": 0, "conv_winograd_fused": 0}
    h = cfg.image_size
    for spec in alexnet.layer_specs(cfg):
        if resolve_kernel(spec.with_route("pallas"), in_hw=h) == \
                "cuda-direct":
            counts["conv_direct"] += 1
        elif spec.fuse_pool or spec.fuse_lrn:
            counts["conv_winograd_fused"] += 1
        else:
            counts["conv_winograd"] += 1
        h = spec.out_hw(h)
    return counts


def phase_serve(*args, **kw):
    """``serve_and_check``'s numbers."""
    return serve_and_check(*args, **kw)[0]


def serve_and_check(torch, np, cfg, params, *, cfg_f32=None,
                    params_f32=None, tol=TOL_BFP, arrivals=ARRIVALS,
                    label=None):
    """Serve ``arrivals`` requests; with ``cfg_f32`` (a BFP or bf16
    config's f32 twin, on ``params_f32``, by default ``params``) the logits
    are held against that model within ``tol`` * max|logit|, else against
    the ``direct`` route, and one more batch is traced.  Returns (numbers,
    the served logits, their images), the last two as numpy arrays."""
    from repro_torch.models import alexnet
    from repro_torch.serving import CnnEngine, CnnServeConfig, ImageRequest
    rng = np.random.default_rng(1)
    label = label or ("bfp" if cfg.fc_bfp else "f32")

    def requests(n):
        return [ImageRequest(image=rng.standard_normal(
            (cfg.image_size, cfg.image_size, cfg.in_channels))
            .astype(np.float32)) for _ in range(n)]

    eng = CnnEngine(cfg, CnnServeConfig(max_batch=BATCH), params=params,
                    device="cuda")
    warm_buckets(eng, requests)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reqs = requests(sum(arrivals))
    reset_launch_counts()
    i = 0
    for size in arrivals:
        for r in reqs[i:i + size]:
            eng.submit(r)
        i += size
        eng.step()
    eng.run_until_done()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    s = eng.stats()

    acc = s["accounting"]
    check(acc["completed"] == len(reqs) and acc["balanced"],
          f"serve accounting: {acc}")
    check(all(r.done for r in reqs), "a request did not complete")
    check(s["batches_failed"] == 0 and not s["degradations"],
          f"failed batches or degradation: {s['batches_failed']} "
          f"{s['degradations']}")
    nb = s["batches_run"]
    check(nb > 0, "no batch ran")
    per_forward = {**conv_launches_per_forward(cfg),
                   "bfp_matmul": len(cfg.fc_dims) if cfg.fc_bfp else 0}
    for k, n in per_forward.items():
        check(counts[k] == n * nb, f"{k}: {counts[k]} launches for {nb} "
              f"batches, expected {n} per forward")

    served = np.stack([r.logits for r in reqs])
    check(served.shape == (len(reqs), cfg.num_classes)
          and np.isfinite(served).all(), "served logits malformed")
    by_uid = {r.uid: r for r in reqs}
    groups = {r.served_group for r in reqs}
    for grp in groups:
        first = by_uid[grp[0]]
        x = np.zeros((first.served_bucket, cfg.image_size, cfg.image_size,
                      cfg.in_channels), np.float32)
        for row, uid in enumerate(grp):
            x[row] = by_uid[uid].image
        ref = alexnet.apply(params, cfg, torch.as_tensor(x, device="cuda"))
        ref = ref.float().cpu().numpy()
        for row, uid in enumerate(grp):
            check(np.array_equal(by_uid[uid].logits, ref[row]),
                  f"served logits of request {uid} are not bit-equal to "
                  f"apply at bucket {first.served_bucket}")
    images = torch.as_tensor(np.stack([r.image for r in reqs]),
                             device="cuda")
    if cfg_f32 is None:
        what, tol = "the direct route", TOL_ROUTE
        other = alexnet.apply(params, dataclasses.replace(
            cfg, use_winograd=False, use_pallas=False), images)
    else:
        what = "the f32 model"
        other = alexnet.apply(params if params_f32 is None else params_f32,
                              cfg_f32, images.float())
    other = other.float().cpu().numpy()
    dmax = float(np.abs(served - other).max())
    lmax = float(np.abs(other).max())
    print(f"serve {label}: served vs {what} max|d| {dmax:.3e} "
          f"(max|logit| {lmax:.3e}, rel {dmax / lmax:.3e}, tol {tol:g})")
    check(dmax <= tol * lmax, f"served logits off {what}: {dmax} > {tol} * "
          f"{lmax}")
    if cfg_f32 is not None:
        check(dmax > 0, f"{label} logits equal the f32 model's: the "
              "quantized or bf16 path did not run")
    trace = profile_batch(torch, eng, requests, label)
    lat = s["latency_ms"]
    return {**trace, "completed": acc["completed"], "batches": nb,
            "bucket_counts": s["bucket_counts"],
            "imgs_per_s": s["imgs_per_s"], "p50_ms": lat["p50"],
            "p99_ms": lat["p99"], "peak_mem_bytes": peak,
            "launches": counts, "per_forward": per_forward,
            "tuned_layers": s["tuned_layers"],
            "requests": len(reqs), "served_vs_reference": what,
            "served_vs_reference_max_abs": dmax,
            "max_abs_logit": lmax}, served, images.cpu().numpy()


def profile_batch(torch, eng, requests, label="f32"):
    """Where one served batch of BATCH images goes (submit to the last
    retire, the engine's own H2D copy and host sync included): its wall
    time untraced, and from a ``torch.profiler`` trace its device busy
    time, the conv kernels' device time and the device idle share."""
    def serve_batch():
        for r in requests(BATCH):
            eng.submit(r)
        eng.run_until_done()

    stages = tuple(f"conv_winograd_{s}"
                   for s in ("input", "gemm", "inverse", "epilogue"))
    wall, busy, events, marks, top = profile_decode(
        torch, serve_batch, marks=("conv_direct", "conv_winograd", *stages))
    if busy is None:
        print(f"serve {label} batch of {BATCH}: {wall:.3f} ms wall | the "
              "profiler trace holds no device events; device busy time not "
              "measured")
        return {"batch_wall_ms": wall, "batch_device_busy_ms": None}
    idle = 1.0 - busy / wall
    print(f"serve {label} batch of {BATCH}: {wall:.3f} ms wall (untraced) | "
          f"traced: device busy {busy:.3f} ms in {events:.0f} events, "
          f"conv_direct {marks['conv_direct']:.4f} ms, conv_winograd "
          f"{marks['conv_winograd']:.4f} ms ("
          + ", ".join(f"{m[14:]} {marks[m]:.4f}" for m in stages)
          + f") | device idle share {idle:.4f} "
          "| top: " + "; ".join(f"{n} {ms:.4f} ms" for n, ms in top))
    return {"batch_wall_ms": wall, "batch_device_busy_ms": busy,
            "batch_device_events": events,
            "batch_conv_direct_ms": marks["conv_direct"],
            "batch_conv_winograd_ms": marks["conv_winograd"],
            "batch_conv_winograd_stages_ms": {m: marks[m] for m in stages},
            "batch_device_idle_share": idle, "batch_top": top}


def flip_bits(torch, slab, bits):
    """A copy of ``slab`` on its device with each bit of ``bits`` (indices
    into its bytes, little-endian within a byte) flipped."""
    bad = slab.clone()
    flat = bad.view(-1).view(torch.uint8)
    for bit in bits:
        flat[bit // 8] ^= 1 << (bit % 8)
    return bad


def flip_positions(np, slab, plan, rng):
    """ABFT_FLIPS seeded bit positions over the whole armed slab (n,
    *spatial, Cb + 1, Kb), then one each in a checksum row, in padding
    where the plan has any (a channel row past C, else a column past K),
    and in a weight's sign and exponent bits (f32 or bf16 elements)."""
    idx = np.arange(slab.numel()).reshape(tuple(slab.shape))
    bpe = 8 * slab.element_size()
    nbits = bpe * slab.numel()
    bits = {f"random{i}": int(v)
            for i, v in enumerate(rng.integers(0, nbits, ABFT_FLIPS))}
    bits["checksum_row"] = bpe * int(idx[-1, ..., -1, 1].flat[-1]) + 5
    bits["sign"] = bpe * int(idx[0, ..., 0, 0].flat[0]) + bpe - 1
    bits["exponent"] = bpe * int(idx[0, ..., 1, 0].flat[0]) + bpe - 5
    if plan.Cp > plan.C:
        # group 0's channel C: C block C // Cb, row C % Cb
        bits["padding"] = bpe * int(idx[plan.C // plan.Cb, ...,
                                        plan.C % plan.Cb, 0].flat[0]) + 3
    elif getattr(plan, "Kp", plan.K) > plan.K:
        # group 0's last K block, its last column (past K)
        bits["padding"] = bpe * int(idx[(plan.nkb - 1) * plan.ncb, ...,
                                        0, plan.Kb - 1].flat[0]) + 3
    return bits


def sdc_layer(torch, np, kname, layer, spec, x, w, b, slab, armed, plan,
              rng, slab_kind):
    """One layer's armed kernel: bit-equal to the unarmed kernel with
    verdict 0 on a clean slab; the verdict equal to the plain version's
    count (``dma.checksum_mismatches``) and above 0 for each flip; timed
    armed and unarmed."""
    from repro_torch.kernels.conv import dma
    entry = conv_entry(kname, spec)
    check(torch.equal(armed[..., :-1, :], slab)
          and int(dma.checksum_mismatches(armed)) == 0,
          f"{layer} ({slab_kind}): the armed slab is not the unarmed slab "
          "plus its checksum rows")
    base = entry(x, w, b, slab)
    y, v = entry(x, w, b, armed, checksum=True)
    torch.cuda.synchronize()
    check(torch.equal(y, base) and int(v) == 0,
          f"{layer} ({slab_kind}): armed output differs from unarmed or a "
          f"clean slab gave verdict {int(v)}")
    flips = flip_positions(np, armed, plan, rng)
    misses = []
    for where, bit in flips.items():
        bad = flip_bits(torch, armed, [bit])
        _, v = entry(x, w, b, bad, checksum=True)
        got, want = int(v), int(dma.checksum_mismatches(bad))
        if not got == want > 0:
            misses.append((where, bit, got, want))
    check(not misses, f"{layer} ({slab_kind}): verdict off the plain "
          f"version's count (where, bit, verdict, plain): {misses}")
    verdict = torch.zeros((), dtype=torch.int32, device="cuda")
    (ms, _), (ms_abft, _) = (
        time_ms(torch, lambda: entry(x, w, b, slab)),
        time_ms(torch, lambda: entry(x, w, b, armed, checksum=True,
                                     verdict=verdict)))
    check(int(verdict) == 0, f"{layer}: verdict {int(verdict)} while timing "
          "a clean slab")
    named = ", ".join(k for k in flips if not k.startswith("random"))
    print(f"sdc kernel {kname} {layer} ({slab_kind} slab "
          f"{tuple(armed.shape)}): armed = unarmed bit for bit, verdict 0 "
          f"clean; {len(flips)} single-bit flips ({named} and "
          f"{ABFT_FLIPS} seeded) each verdict = plain count > 0 | "
          f"kernel_ms {ms:.4f} armed {ms_abft:.4f} (x{ms_abft / ms:.3f})")
    return {"layer": layer, "kernel": kname, "slab": slab_kind,
            "armed_slab": list(armed.shape), "flips": len(flips),
            "flip_bits": flips, "ms": ms, "ms_abft": ms_abft}


def sdc_requests(np, cfg, rng):
    from repro_torch.serving import ImageRequest

    def requests(n, retries=3):
        return [ImageRequest(image=rng.standard_normal(
            (cfg.image_size, cfg.image_size, cfg.in_channels)).astype(
                np.float32), retries=retries) for _ in range(n)]
    return requests


def phase_sdc(torch, np, cfg, params, rows):
    """The ABFT/SDC defense at full width (f32, route ``pallas``): each conv
    layer's armed kernel against the unarmed one and against its plain
    version's count for seeded flips, on the f32 slabs and on conv3's
    ``conv_bfp`` slab; then BENCH_sdc's four serving scenarios through
    ``CnnEngine(max_batch=8)``.  Adds ``ms_abft`` and
    ``abft_flips_checked`` to the conv rows of ``rows``."""
    from repro_torch.nn.conv import pack_conv_weights
    t0 = time.perf_counter()
    card = card_line()
    rng = np.random.default_rng(SDC_SEED)
    layers = []
    for kname, layer, spec, x, w, b, slab, plan in layer_cases(
            torch, np, cfg, params):
        armed_plan = dataclasses.replace(plan, checksum=True)
        armed = pack_conv_weights(spec, tuple(x.shape), w, abft=True).data
        layers.append(sdc_layer(torch, np, kname, layer, spec, x, w, b, slab,
                                armed, armed_plan, rng, "f32"))
        row = rows[kname]
        row["ms_abft"] = row.get("ms_abft", 0.0) + layers[-1]["ms_abft"]
        row["abft_flips_checked"] = (row.get("abft_flips_checked", 0)
                                     + layers[-1]["flips"])
        if layer == "conv3":
            bfp = pack_conv_weights(spec, tuple(x.shape), w, bfp_pack=True)
            bfp_armed = pack_conv_weights(spec, tuple(x.shape), w,
                                          bfp_pack=True, abft=True)
            layers.append(sdc_layer(torch, np, kname, layer, spec, x, w, b,
                                    bfp.data, bfp_armed.data, armed_plan,
                                    rng, "conv_bfp"))
            row["abft_flips_checked"] += layers[-1]["flips"]

    scen = sdc_scenarios(torch, np, cfg, params, rng, card,
                         ("clean", "bitflip", "verify", "plausible"))
    seconds = time.perf_counter() - t0
    print(f"sdc: phase {seconds:.1f} s")
    return {"layers": layers, **scen, "seconds": seconds}


def sdc_scenarios(torch, np, cfg, params, rng, card, which, label=""):
    """BENCH_sdc's serving scenarios named in ``which`` (clean, bitflip,
    verify, plausible) through ``CnnEngine(max_batch=8)`` on ``cfg``;
    returns each one's numbers, and ``launches``: the armed clean run's
    counts."""
    from repro_torch.serving import CnnEngine, CnnServeConfig, \
        FaultInjector, FaultSpec, ImageRequest, derive_seed
    out = {}
    cfg_abft = dataclasses.replace(cfg, sdc_abft=True)
    requests = sdc_requests(np, cfg, rng)

    def engine(cfg_run, **kw):
        eng = CnnEngine(cfg_run, CnnServeConfig(
            max_batch=BATCH, retry_backoff_ms=0.5, **kw), params=params,
            device="cuda")
        warm_buckets(eng, requests)
        return eng

    def serve(eng, reqs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        return time.perf_counter() - t

    def balanced(eng, reqs):
        acc = eng.accounting()
        return (acc["balanced"] and acc["in_flight"] == 0
                and all(r.done for r in reqs))

    armed_kw = dict(verify_slabs=True, screen_abs_max=1e6)
    # 1. clean: the same requests with the defense off and fully armed
    probe = requests(16)
    e_off = engine(cfg)
    rs_off = [ImageRequest(image=r.image) for r in probe]
    wall_off = serve(e_off, rs_off)
    e_on = engine(cfg_abft, **armed_kw)
    rs_on = [ImageRequest(image=r.image) for r in probe]
    reset_launch_counts()
    wall_on = serve(e_on, rs_on)
    counts = launch_counts()
    nb = e_on.batches_run
    for k, n in conv_launches_per_forward(cfg).items():
        check(counts[k] == n * nb, f"sdc{label} clean: {k} {counts[k]} "
              f"launches for {nb} armed batches, expected {n} a forward")
    slabs = e_on._slabs(BATCH)
    fp_ms = _host_ms(torch, lambda: e_on._slabs_intact(BATCH, False))
    clean = {
        "requests": len(probe),
        "bit_identical": all(np.array_equal(a.logits, b.logits)
                             for a, b in zip(rs_off, rs_on)),
        "detections": e_on.sdc_detections,
        "slab_integrity_failures": e_on.slab_integrity_failures,
        "screen_magnitude": e_on.screen_magnitude,
        "false_positive_rate": (e_on.sdc_detections
                                + e_on.slab_integrity_failures
                                + e_on.screen_magnitude) / max(nb, 1),
        "wall_off_s": wall_off, "wall_armed_s": wall_on,
        "overhead_ratio": wall_on / wall_off,
        "fingerprint_check_ms": fp_ms,
        "slab_bytes": sum(v.data.numel() * v.data.element_size()
                          for v in slabs.values() if hasattr(v, "kernel")
                          and v.data is not None),
        "batches": nb, "launches": counts,
        "accounting_balanced": balanced(e_off, rs_off)
        and balanced(e_on, rs_on)}
    check(clean["bit_identical"], f"sdc{label} clean: armed logits differ "
          "from the unarmed engine's")
    check(clean["false_positive_rate"] == 0.0 and clean["accounting_balanced"],
          f"sdc{label} clean: false positives or unbalanced accounting: "
          f"{clean}")
    print(f"sdc{label}: clean {len(probe)} requests off vs armed (ABFT + "
          f"fingerprints + |logit| <= 1e6): bit_identical yes, detections 0,"
          f" integrity failures 0, magnitude screens 0, false_positive_rate "
          f"0.0 | wall off {wall_off * 1e3:.1f} ms armed {wall_on * 1e3:.1f}"
          f" ms overhead_ratio {clean['overhead_ratio']:.3f} (fingerprint "
          f"check {fp_ms:.2f} ms a batch over "
          f"{clean['slab_bytes'] / 2 ** 20:.1f} MiB of slabs) | on {card}")

    out.update(clean=clean, launches=counts)
    if "bitflip" in which:
        # 2. bitflip: fingerprints off, so the kernels' verdict detects
        flips_at = (0, 2, 4)
        eng = engine(cfg_abft)
        eng.arm_faults(FaultInjector(
            seed=derive_seed(SDC_SEED, "sdc-bitflip"),
            specs={"slab.bitflip": FaultSpec(at=flips_at)}))
        reqs = requests(BATCH * (max(flips_at) + 2))
        serve(eng, reqs)
        fired = eng.faults.summary()["slab.bitflip"]["fired"]
        bitflip = {"requests": len(reqs), "flips_fired": fired,
                   "detections": eng.sdc_detections,
                   "detection_rate": (eng.sdc_detections / fired if fired
                                      else 0.0),
                   "completed": sum(r.done for r in reqs),
                   "retried": eng.images_retried,
                   "batches_failed": eng.batches_failed,
                   "accounting_balanced": balanced(eng, reqs),
                   "faults": eng.faults.summary()}
        check(fired == len(flips_at) and bitflip["detection_rate"] == 1.0
              and bitflip["accounting_balanced"],
              f"sdc{label} bitflip: a flip was missed or a request lost: "
              f"{bitflip}")
        print(f"sdc{label}: bitflip {fired} slab bit flips over {len(reqs)} "
              f"requests (fingerprints off): detections "
              f"{eng.sdc_detections}, detection_rate 1.0, completed "
              f"{bitflip['completed']}/{len(reqs)}, retried "
              f"{eng.images_retried}, accounting balanced | on {card}")
        out["bitflip"] = bitflip
    if "verify" in which:
        # 3. verify: fingerprints catch a flipped and a stale slab before
        # dispatch
        eng = engine(cfg_abft, **armed_kw)
        eng.arm_faults(FaultInjector(
            seed=derive_seed(SDC_SEED, "sdc-verify"),
            specs={"slab.bitflip": FaultSpec(at=(0,)),
                   "slab.stale": FaultSpec(at=(1,))}))
        reqs = requests(12)
        serve(eng, reqs)
        verify = {"requests": len(reqs),
                  "faults_fired": sum(v["fired"] for p, v in
                                      eng.faults.summary().items()
                                      if p.startswith("slab.")),
                  "slab_integrity_failures": eng.slab_integrity_failures,
                  "abft_detections": eng.sdc_detections,
                  "completed": sum(r.done for r in reqs),
                  "accounting_balanced": balanced(eng, reqs),
                  "faults": eng.faults.summary()}
        check(verify["faults_fired"] == 2
              and verify["slab_integrity_failures"] == 2
              and verify["abft_detections"] == 0
              and verify["accounting_balanced"],
              f"sdc{label} verify: a slab fault reached a forward: {verify}")
        print(f"sdc{label}: verify slab.bitflip + slab.stale over "
              f"{len(reqs)} requests: both caught before dispatch (integrity "
              f"failures 2, ABFT detections 0), completed "
              f"{verify['completed']}/{len(reqs)}, accounting balanced | on "
              f"{card}")
        out["verify"] = verify
    if "plausible" in which:
        # 4. plausible: a finite 1e8 offset on one row, caught by the
        # |logit| bound
        eng = engine(cfg_abft, **armed_kw)
        eng.arm_faults(FaultInjector(
            seed=derive_seed(SDC_SEED, "sdc-plausible"),
            specs={"retire.plausible": FaultSpec(at=(0,), magnitude=1e8)}))
        reqs = requests(8)
        serve(eng, reqs)
        plausible = {"requests": len(reqs),
                     "fired":
                         eng.faults.summary()["retire.plausible"]["fired"],
                     "screen_magnitude": eng.screen_magnitude,
                     "screen_nonfinite": eng.screen_nonfinite,
                     "completed": sum(r.done for r in reqs),
                     "retried": eng.images_retried,
                     "accounting_balanced": balanced(eng, reqs)}
        check(plausible["fired"] == 1 and plausible["screen_magnitude"] == 1
              and plausible["screen_nonfinite"] == 0
              and plausible["accounting_balanced"],
              f"sdc{label} plausible: the corrupted row was not screened: "
              f"{plausible}")
        print(f"sdc{label}: plausible retire.plausible (1e8) over "
              f"{len(reqs)} requests: screen_magnitude 1, screen_nonfinite 0, "
              f"completed {plausible['completed']}/{len(reqs)}, accounting "
              f"balanced | on {card}")
        out["plausible"] = plausible
    return out


def phase_autotune(torch, np, cfg, params):
    """The measured autotuner at full width on the card (batch 8, f32)."""
    import tempfile
    from repro_torch.core import autotune
    from repro_torch.models import alexnet
    from repro_torch.nn.conv import ConvPlan, dispatch_conv, \
        pack_conv_weights
    from repro_torch.serving import CnnEngine, CnnServeConfig, ImageRequest
    t0 = time.perf_counter()
    card = card_line()
    cache = autotune.PlanCache()
    results = autotune.autotune_alexnet(
        cfg, BATCH, device="cuda", iters=AUTOTUNE_ITERS,
        max_candidates=AUTOTUNE_BUDGET, check_equal=True, cache=cache)
    tune_s = time.perf_counter() - t0
    by_layer = {r["layer"]: r for r in results}
    layers = []
    for kname, layer, spec, x, w, b, _, _ in layer_cases(
            torch, np, cfg, params):
        r = by_layer[layer]
        check(r["tuned_us"] <= r["default_us"],
              f"autotune {layer}: tuned {r['tuned_us']} us > default "
              f"{r['default_us']} us")
        plan = ConvPlan.from_dict(r["plan"])
        shape = tuple(x.shape)
        w_def = pack_conv_weights(spec, shape, w)
        w_tuned = pack_conv_weights(spec, shape, w, plan=plan)
        y_def = dispatch_conv(spec, x, w, b, w_packed=w_def)
        y_arm, v_arm = dispatch_conv(
            spec, x, w, b, plan=plan, abft=True,
            w_packed=pack_conv_weights(spec, shape, w, abft=True, plan=plan))
        _, v_def = dispatch_conv(
            spec, x, w, b, abft=True,
            w_packed=pack_conv_weights(spec, shape, w, abft=True))
        check(autotune.bit_equal(y_def, y_arm),
              f"autotune {layer}: the armed kernel at tile {r['tile']} is "
              f"not bit-equal to the unarmed default")
        check(int(v_arm) == 0 and int(v_def) == 0,
              f"autotune {layer}: verdict {int(v_arm)} at tile {r['tile']}, "
              f"{int(v_def)} at the default tile, on a clean slab")
        default_ms, _ = time_ms(torch, lambda: dispatch_conv(
            spec, x, w, b, w_packed=w_def))
        tuned_ms, _ = time_ms(torch, lambda: dispatch_conv(
            spec, x, w, b, w_packed=w_tuned, plan=plan))
        layers.append({"layer": layer, "kernel": kname,
                       "default_tile": r["default_tile"], "tile": r["tile"],
                       "candidates": r["candidates"],
                       "default_us": r["default_us"],
                       "tuned_us": r["tuned_us"], "steady": r["steady"],
                       "default_ms": default_ms, "tuned_ms": tuned_ms,
                       "rows": r["rows"]})
        print(f"autotune: {layer} ({kname}) default {default_ms:.4f} ms "
              f"(tile {r['default_tile']}) tuned {tuned_ms:.4f} ms (tile "
              f"{r['tile']}) | sweep medians {r['default_us']:.2f} -> "
              f"{r['tuned_us']:.2f} us over {r['candidates']} candidates, "
              f"steady {r['steady']} | armed at the tile: bit-equal, "
              f"verdict 0 | on {card}")

    rng = np.random.default_rng(2)
    images = [rng.standard_normal((cfg.image_size, cfg.image_size,
                                   cfg.in_channels)).astype(np.float32)
              for _ in range(AUTOTUNE_REQUESTS)]
    with tempfile.TemporaryDirectory() as tmp:
        path = cache.save(os.path.join(tmp, "alexnet_torch.json"))
        empty = autotune.PlanCache().save(os.path.join(tmp, "empty.json"))
        hits = sorted(alexnet.load_tuned_plans(cfg, BATCH, path=path,
                                                  device="cuda"))
        tuned, untuned = (CnnEngine(cfg, CnnServeConfig(
            max_batch=BATCH, plan_cache=p), params=params, device="cuda")
            for p in (path, empty))

    def requests(n):
        return [ImageRequest(image=rng.standard_normal(
            (cfg.image_size, cfg.image_size, cfg.in_channels)).astype(
                np.float32)) for _ in range(n)]

    served = {}
    for name, eng in (("tuned", tuned), ("untuned", untuned)):
        warm_buckets(eng, requests)
        reqs = [ImageRequest(image=im) for im in images]
        reset_launch_counts()
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        served[name] = (reqs, launch_counts(), eng.stats())
    (rs_t, counts, stats_t), (rs_u, _, stats_u) = (served["tuned"],
                                                   served["untuned"])
    check(all(r.done for r in rs_t + rs_u), "autotune: a request did not "
          "complete")
    check(all(np.array_equal(a.logits.view(np.int32), b.logits.view(np.int32))
              for a, b in zip(rs_t, rs_u)),
          "autotune: the tuned engine's logits are not bit-equal to the "
          "untuned engine's")
    check(stats_t["tuned_layers"] == hits == [f"conv{i}" for i in
                                              range(1, 6)]
          and stats_u["tuned_layers"] == [],
          f"autotune: tuned_layers {stats_t['tuned_layers']} / "
          f"{stats_u['tuned_layers']}, cache hits {hits}")
    nb = stats_t["batches_run"]
    for k, n in (("conv_direct", 2), ("conv_winograd", 2),
                 ("conv_winograd_fused", 1)):
        check(counts[k] == n * nb, f"autotune serve: {k} {counts[k]} "
              f"launches for {nb} batches, expected {n} a forward")
    ref_cache = os.path.join(ROOT, "results", "plans", "alexnet.json")
    ref_plans = alexnet.load_tuned_plans(cfg, BATCH, path=ref_cache,
                                         device="cuda")
    check(ref_plans == {}, f"autotune: the reference's cache gives plans "
          f"on the card: {sorted(ref_plans)}")
    committed = sorted(alexnet.load_tuned_plans(cfg, BATCH, device="cuda"))
    backend = autotune.backend_kind("cuda")
    phase_s = time.perf_counter() - t0
    print(f"autotune: {AUTOTUNE_REQUESTS} requests served tuned and "
          f"untuned, logits bit-equal, tuned_layers {stats_t['tuned_layers']}"
          f" | the reference's cache: 0 plans on the card | the committed "
          f"cache: {len(committed)} plans for {backend} | "
          f"sweep {tune_s:.1f} s, phase {phase_s:.1f} s")
    return {"layers": layers, "backend": backend,
            "launches": counts, "tuned_layers": stats_t["tuned_layers"],
            "reference_cache_plans": len(ref_plans),
            "committed_cache_plans": committed, "sweep_s": tune_s,
            "phase_s": phase_s}


# ---------------------------------------------------------------------------
# bf16 and VGG-16: phases 3b, 3c, 4d, 4e, 4f
# ---------------------------------------------------------------------------
def library_conv(torch, x, w, b, spec):
    """The library's layer in x's dtype: ``F.conv2d`` (cuDNN; tensor
    cores for bf16), bias, ReLU, then the LRN and pool in x's dtype."""
    import torch.nn.functional as F
    from repro_torch.kernels.conv.ref import same_pad
    from repro_torch.nn.pooling import apply_epilogue
    xc = x.permute(0, 3, 1, 2)
    if spec.padding == "SAME":
        _, h_lo, h_hi = same_pad(x.shape[1], spec.kernel, spec.stride)
        _, w_lo, w_hi = same_pad(x.shape[2], spec.kernel, spec.stride)
        xc = F.pad(xc, (w_lo, w_hi, h_lo, h_hi))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), b, stride=spec.stride,
                 groups=spec.groups)
    y = torch.relu(y).permute(0, 2, 3, 1)
    lrn = spec.lrn if spec.fuse_lrn else None
    pool = (spec.pool_window, spec.pool_stride) if spec.fuse_pool else None
    return apply_epilogue(y, lrn, pool)


def bf16_excess(torch, got, ref):
    """max of |got - ref| - (one bf16 step of |ref| + TOL_KERNEL *
    max|ref|): <= 0 when the two agree within one bf16 step."""
    got, ref = got.float(), ref.float()
    return float(((got - ref).abs() - BF16_STEP * ref.abs()
                  - TOL_KERNEL * ref.abs().max()).max())


def bf16_rule(torch, entry, x, w, b, slab, armed, tiles, layer):
    """The bf16 rule at every tile of ``tiles``: the bf16 call bit-equal to
    the call on the widened inputs rounded to bf16, armed and unarmed, the
    armed verdict 0 on the clean slab."""
    x32, w32, b32 = x.float(), w.float(), b.float()
    for tile in tiles:
        kw = dict(tile_rows=tile[0], tile_cols=tile[1])
        y = entry(x, w, b, slab, **kw)
        want = entry(x32, w32, b32, slab.float(), **kw).to(torch.bfloat16)
        y_arm, v = entry(x, w, b, armed, checksum=True, **kw)
        want_arm, _ = entry(x32, w32, b32, armed.float(), checksum=True,
                            **kw)
        torch.cuda.synchronize()
        check(y.dtype is torch.bfloat16
              and torch.equal(y.view(torch.int16), want.view(torch.int16)),
              f"{layer} tile {tile}: the bf16 kernel is not the f32 kernel "
              "on the widened inputs rounded to bf16")
        check(torch.equal(y_arm.view(torch.int16), y.view(torch.int16))
              and torch.equal(want_arm.to(torch.bfloat16).view(torch.int16),
                              y.view(torch.int16)) and int(v) == 0,
              f"{layer} tile {tile}: armed bf16 differs from unarmed or "
              f"a clean slab gave verdict {int(v)}")


def steps_apart(torch, got, want):
    """max over the outputs finite in both of |got - want| - (one bf16 step
    at the larger magnitude + TOL_KERNEL * max|want|): <= 0 when no output
    is more than one bf16 step from the other (the floor lets a ReLU output
    near zero round from f32 noise)."""
    got, want = got.float(), want.float()
    fin = torch.isfinite(got) & torch.isfinite(want)
    g, w = got[fin].double(), want[fin].double()
    mag = torch.maximum(g.abs(), w.abs())
    _, e = torch.frexp(torch.where(mag > 0, mag, torch.ones_like(mag)))
    step = torch.where(mag > 0, torch.ldexp(torch.ones_like(mag), e - 8),
                       torch.zeros_like(mag))
    return float((((g - w).abs() - step)
                  - TOL_KERNEL * float(w.abs().max())).max())


def mma_rule(torch, entry, x, w, b, slab, armed, tiles, layer, ref):
    """Kernel 1's bf16-slab (tensor-core) route under rule (a)-(d) at every
    tile of ``tiles``: (a) within one bf16 step of its plain version
    ``ref``; (b) every tile, the armed call (verdict 0 on the clean slab)
    and a second call of the default tile bit-equal to the default tile;
    (c) no output more than one bf16 step from the f32 kernel on the
    widened inputs rounded to bf16; (d) non-finite wherever that one is.
    Returns (the share of outputs that differ from it, its worst margin
    under (c))."""
    base = entry(x, w, b, slab)
    want = entry(x.float(), w.float(), b.float(),
                 slab.float()).to(torch.bfloat16)
    calls = [("again", entry(x, w, b, slab))]
    for tile in tiles:
        kw = dict(tile_rows=tile[0], tile_cols=tile[1])
        calls.append((f"tile {tile}", entry(x, w, b, slab, **kw)))
        y_arm, v = entry(x, w, b, armed, checksum=True, **kw)
        calls.append((f"tile {tile} armed (verdict {int(v)})",
                      y_arm if int(v) == 0 else None))
    torch.cuda.synchronize()
    for what, y in calls:
        check(y is not None and y.dtype is torch.bfloat16
              and torch.equal(y.view(torch.int16), base.view(torch.int16)),
              f"{layer} bf16 slab: {what} is not the default tile's bits")
    excess = bf16_excess(torch, base, ref)
    check(excess <= 0, f"{layer} bf16 slab: more than one bf16 step off "
          f"the plain version (excess {excess})")
    apart = steps_apart(torch, base, want)
    check(apart <= 0, f"{layer} bf16 slab: an output more than one bf16 "
          f"step from the f32 kernel on the widened inputs ({apart})")
    check(bool((~torch.isfinite(base) >= ~torch.isfinite(want)).all()),
          f"{layer} bf16 slab: finite where the f32 kernel is not")
    return float((base.float() != want.float()).float().mean()), apart


# kernel 1's launches by kernel name, in launch order: the bf16-slab
# (tensor-core) conv stage, the FFMA conv stage, the LRN/pool epilogue
DIRECT_STAGES = ("conv_direct_mma", "conv_direct_gemm",
                 "conv_direct_epilogue")


def launch_split(st):
    """``stage_ms``'s launches as text."""
    return ("not measured (no device events)" if st is None else
            ", ".join(f"{k.removeprefix('conv_direct_')} {v:.4f}"
                      for k, v in st.items() if v is not None))


def new_row(name):
    return {"name": name, "layers": [], "max_abs_err": 0.0, "ms": 0.0,
            "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "flop": 0,
            "bytes": 0, "per_layer": []}


def add_layer(row, layer, **nums):
    """Add one layer's numbers to an aggregate kernel row."""
    row["layers"].append(layer)
    row["per_layer"].append({"layer": layer, **nums})
    row["max_abs_err"] = max(row["max_abs_err"], nums["max_abs_err"])
    for key in ("ms", "plain_ms", "bound_ms", "library_ms", "flop",
                "bytes"):
        row[key] += nums[key]


def conv_bound(kname, x, flops, nbytes):
    """(bound ms, bound_by): kernel 1 in bf16 at the bf16 tensor-core peak
    (its products are bf16 x bf16, exact in an f32 accumulator), the rest
    at the FP32 peak (a Winograd-domain V is not bf16-representable)."""
    return _bound(flops, nbytes, "bfloat16" if kname == "conv_direct"
                  and x.element_size() == 2 else "float32")


# kernels 2-3's launches by kernel name, in launch order
WINO_STAGES = ("conv_winograd_input", "conv_winograd_gemm",
               "conv_winograd_inverse", "conv_winograd_epilogue")


def wino_launches(torch, kern, armed_kern):
    """Kernels 2-3 in bf16: the armed call's device ms and each launch's
    (``stage_ms``: input transform, GEMM, inverse transform, epilogue) for
    the row, and their part of the row's line."""
    out = {"armed_ms": time_ms(torch, armed_kern)[0],
           "stages_ms": stage_ms(torch, kern, WINO_STAGES)}
    st = out["stages_ms"]
    launches = ("not measured (no device events)" if st is None else
                ", ".join(f"{k.removeprefix('conv_winograd_')} {v:.4f}"
                          for k, v in st.items() if v is not None))
    return out, (f" | armed kernel_ms {out['armed_ms']:.4f} | launches "
                 f"{launches}")


def phase_kernels_bf16(torch, np, cfg, params):
    """3b: kernels 1-3 at AlexNet's five layer shapes, batch 8, in bf16:
    the bf16 rule at every tile of each launcher's grid, armed and
    unarmed; within one bf16 step of the plain version; the armed direct
    kernels' verdicts for seeded flips of their bf16 slabs; timed beside
    bf16 ``F.conv2d`` and the bound, kernels 2-3 also armed and each
    launch by name (``wino_launches``).  Under ``cfg.conv_bfp`` (3e) every
    slab is the reference's f32 BFP slab, kernel 1's too (bf16 x on an f32
    slab), and the flips and launch times are left to 3b."""
    from repro_torch.kernels.conv import direct, winograd
    from repro_torch.nn.conv import pack_conv_weights
    rng = np.random.default_rng(SDC_SEED + 1)
    card = card_line()
    rows, flips = {}, []
    for kname, layer, spec, x, w, b, slab, plan in layer_cases(
            torch, np, cfg, params):
        mod = direct if kname == "conv_direct" else winograd
        lrn = spec.lrn if spec.fuse_lrn else None
        pool = (spec.pool_window, spec.pool_stride) if spec.fuse_pool else None
        entry = conv_entry(kname, spec)
        want_slab = (torch.bfloat16 if kname == "conv_direct"
                     and not cfg.conv_bfp else torch.float32)
        check(x.dtype is torch.bfloat16 and slab.dtype is want_slab,
              f"{layer}: x {x.dtype}, slab {slab.dtype}; the reference "
              f"packs {want_slab}")
        armed = pack_conv_weights(spec, tuple(x.shape), w, abft=True,
                                  bfp_pack=cfg.conv_bfp).data
        mma = kname == "conv_direct" and direct.mma_route(slab.dtype)
        tiles = (list(direct.MMA_TILES) if mma else
                 [t for t in mod.TILES
                  if t in mod.ANY_SLAB_TILES or plan.Kb % 4 == 0])
        if not mma:
            bf16_rule(torch, entry, x, w, b, slab, armed, tiles, layer)
        if kname == "conv_direct" and not cfg.conv_bfp:
            armed_plan = dataclasses.replace(plan, checksum=True)
            flips.append(sdc_layer(torch, np, kname, layer, spec, x, w, b,
                                   slab, armed, armed_plan, rng, "bf16"))

        def kern():
            return entry(x, w, b, slab)

        def plain():
            fn = (direct.conv2d_direct_plain if kname == "conv_direct"
                  else winograd.conv2d_winograd_plain)
            return fn(x, slab, b, plan, relu=True, lrn=lrn, pool=pool)

        def library():
            return library_conv(torch, x, w, b, spec)

        got = kern()
        torch.cuda.synchronize()
        ref = plain()
        excess = bf16_excess(torch, got, ref)
        err = float((got.float() - ref.float()).abs().max())
        lib_err = float((got.float() - library().float()).abs().max())
        check(excess <= 0, f"{layer} bf16: kernel more than one bf16 step "
              f"off its plain version (excess {excess})")
        rule = "bf16 rule bit-equal"
        if mma:
            share, apart = mma_rule(torch, entry, x, w, b, slab, armed,
                                    tiles, layer, ref)
            rule = (f"rule (a)-(d) ({share:.3e} of outputs one bf16 step "
                    f"off the f32 kernel on the widened inputs, margin "
                    f"{apart:.3e}) bit-equal")
        (ms, host_ms), (plain_ms, _), (lib_ms, _) = (
            time_ms(torch, kern), time_ms(torch, plain),
            time_ms(torch, library))
        flops, nbytes = flops_bytes(kname, x, got, plan, slab)
        bound, bound_by = conv_bound(kname, x, flops, nbytes)
        kind = "conv_bfp slab" if cfg.conv_bfp else "slab"
        nums, extra = {}, ""
        if kname != "conv_direct" and not cfg.conv_bfp:
            nums, extra = wino_launches(torch, kern, lambda: entry(
                x, w, b, armed, checksum=True))
        if mma:
            x32, w32, b32, s32 = x.float(), w.float(), b.float(), \
                slab.float()

            def widened():
                return entry(x32, w32, b32, s32)

            nums = {"armed_ms": time_ms(torch, lambda: entry(
                        x, w, b, armed, checksum=True))[0],
                    "widened_ms": time_ms(torch, widened)[0],
                    "stages_ms": stage_ms(torch, kern, DIRECT_STAGES),
                    "widened_stages_ms": stage_ms(torch, widened,
                                                  DIRECT_STAGES),
                    "differ_share": share}
            extra = (f" | armed kernel_ms {nums['armed_ms']:.4f} | launches "
                     f"{launch_split(nums['stages_ms'])} | f32 kernel on "
                     f"the widened inputs {nums['widened_ms']:.4f} ms "
                     f"(launches {launch_split(nums['widened_stages_ms'])})"
                     f", kernel_ms/widened {ms / nums['widened_ms']:.3f}")
        print(f"kernel {kname} {layer} (bf16 x, {str(slab.dtype)[6:]} "
              f"{kind}): {rule} at tiles {tiles}, armed and "
              f"unarmed | max_abs_err {err:.3e} vs plain (within one bf16 "
              f"step; vs bf16 F.conv2d {lib_err:.3e}) | kernel_ms {ms:.4f} "
              f"plain_ms {plain_ms:.4f} library_ms(bf16 F.conv2d, cuDNN) "
              f"{lib_ms:.4f} bound_ms {bound:.4f} ({bound_by}: {flops:.3e} "
              f"flop, {nbytes:.3e} B) | kernel_ms/library_ms "
              f"{ms / lib_ms:.3f}{extra} | on {card}")
        add_layer(rows.setdefault(kname, new_row(kname)), layer,
                  max_abs_err=err, ms=ms, host_ms=host_ms,
                  plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                  bound_by=bound_by, flop=flops, bytes=nbytes,
                  tiles=[list(t) for t in tiles], slab=list(slab.shape),
                  slab_dtype=str(slab.dtype)[6:], **nums)
    return rows, flips


# VGG-16's conv geometries at 224 px, each (H, C_in, C_out, pooled) once
VGG_GEOMETRIES = ((224, 3, 64, False), (224, 64, 64, True),
                  (112, 64, 128, False), (112, 128, 128, True),
                  (56, 128, 256, False), (56, 256, 256, False),
                  (56, 256, 256, True), (28, 256, 512, False),
                  (28, 512, 512, False), (28, 512, 512, True),
                  (14, 512, 512, False), (14, 512, 512, True))


def phase_kernels_vgg(torch, np, cfg, params, params16):
    """3c: kernels 2-3 at VGG-16's layer geometries, batch 8, f32 and bf16:
    f32 within TOL_KERNEL of the plain version, bf16 under the bf16 rule
    and within one bf16 step of its plain version; each timed beside
    ``F.conv2d`` + pool (f32 TF32 off; bf16 on cuDNN) and the bound, bf16
    also armed and each launch by name (``wino_launches``); then the
    device ms of whole feature passes of the model."""
    from repro_torch.kernels.conv import winograd
    from repro_torch.kernels.conv.ref import conv2d_ref
    from repro_torch.models import alexnet
    from repro_torch.nn.conv import ConvSpec
    rng = np.random.default_rng(3)
    card = card_line()
    rows = {"float32": {}, "bfloat16": {}}
    for H, c_in, c_out, pooled in VGG_GEOMETRIES:
        spec = ConvSpec(kernel=3, relu=True, fuse_pool=pooled,
                        pool_window=2, pool_stride=2, route="pallas")
        pool = (2, 2) if pooled else None
        kname = "conv_winograd_fused" if pooled else "conv_winograd"
        layer = f"{H}x{H}x{c_in}->{c_out}{' pool 2/2' if pooled else ''}"
        x32 = torch.as_tensor(rng.standard_normal((BATCH, H, H, c_in)),
                              dtype=torch.float32, device="cuda")
        w32 = torch.as_tensor(rng.standard_normal((3, 3, c_in, c_out))
                              * (9 * c_in) ** -0.5, dtype=torch.float32,
                              device="cuda")
        b32 = torch.as_tensor(rng.standard_normal(c_out) * 0.1,
                              dtype=torch.float32, device="cuda")
        plan = winograd.plan(tuple(x32.shape), tuple(w32.shape), pool=pool)
        for dtype in ("float32", "bfloat16"):
            td = alexnet.DTYPES[dtype]
            x, w, b = x32.to(td), w32.to(td), b32.to(td)
            slab = winograd.pack_weights(w, plan)       # f32 either way
            if dtype == "bfloat16":
                armed = winograd.pack_weights(w, dataclasses.replace(
                    plan, checksum=True))
                bf16_rule(torch, conv_entry(kname, spec), x, w, b, slab,
                          armed, [(winograd.BM, winograd.BN)], layer)

            def kern():
                return winograd.conv2d_winograd(x, w, b, slab, relu=True,
                                                pool=pool)

            def plain():
                return winograd.conv2d_winograd_plain(x, slab, b, plan,
                                                      relu=True, lrn=None,
                                                      pool=pool)

            def library():
                if dtype == "float32":
                    return conv2d_ref(x, w, b, relu=True, pool=pool)
                return library_conv(torch, x, w, b, spec)

            got = kern()
            torch.cuda.synchronize()
            ref = plain()
            err = float((got.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            if dtype == "float32":
                check(err <= TOL_KERNEL * scale, f"vgg {layer}: kernel off "
                      f"its plain version: {err} > {TOL_KERNEL} * {scale}")
            else:
                excess = bf16_excess(torch, got, ref)
                check(excess <= 0, f"vgg {layer} bf16: more than one bf16 "
                      f"step off the plain version ({excess})")
            (ms, host_ms), (plain_ms, _), (lib_ms, _) = (
                time_ms(torch, kern), time_ms(torch, plain),
                time_ms(torch, library))
            flops, nbytes = flops_bytes(kname, x, got, plan, slab)
            bound, bound_by = conv_bound(kname, x, flops, nbytes)
            lib_name = ("F.conv2d TF32 off" if dtype == "float32"
                        else "bf16 F.conv2d, cuDNN")
            wino, extra = {}, ""
            if dtype == "bfloat16":
                wino, extra = wino_launches(
                    torch, kern, lambda: winograd.conv2d_winograd(
                        x, w, b, armed, relu=True, pool=pool,
                        checksum=True))
            print(f"kernel {kname} vgg {layer} ({dtype}): max_abs_err "
                  f"{err:.3e} (max|plain| {scale:.3e}) | kernel_ms {ms:.4f} "
                  f"plain_ms {plain_ms:.4f} library_ms({lib_name} + pool) "
                  f"{lib_ms:.4f} bound_ms {bound:.4f} ({bound_by}) | "
                  f"kernel_ms/library_ms {ms / lib_ms:.3f}{extra} | on "
                  f"{card}")
            add_layer(rows[dtype].setdefault(kname, new_row(kname)), layer,
                      max_abs_err=err, max_abs_plain=scale, ms=ms,
                      host_ms=host_ms, plain_ms=plain_ms, library_ms=lib_ms,
                      bound_ms=bound, bound_by=bound_by, flop=flops,
                      bytes=nbytes, **wino)
        del x32, w32, b32, x, w, b, slab, armed
    passes = {}
    for dtype, p in (("float32", params), ("bfloat16", params16)):
        c = dataclasses.replace(cfg, dtype=dtype)
        x = torch.as_tensor(rng.standard_normal(
            (BATCH, c.image_size, c.image_size, 3)), dtype=torch.float32,
            device="cuda")
        packed = alexnet.pack_serving_slabs(p, c, BATCH)
        passes[dtype], _ = time_ms(torch, lambda: alexnet.features(
            p, c, x, packed=packed), iters=5)
        print(f"vgg16 feature pass ({dtype}, batch {BATCH}, 13 convs on "
              f"kernels 2-3): {passes[dtype]:.3f} device ms | on {card}")
    return rows, passes


def phase_vgg(torch, np, cfg, params, params16):
    """4d: full-width VGG-16 through ``CnnEngine(max_batch=8)`` on route
    pallas: f32 (32 requests, the bit-equal and direct-route checks, a
    traced batch), then bf16 (16 requests, bit-equal to bf16 ``apply``,
    within TOL_BF16 of the f32 model on the same bf16-representable
    weights)."""
    per = conv_launches_per_forward(cfg)
    check(per == {"conv_direct": 0, "conv_winograd": 8,
                  "conv_winograd_fused": 5},
          f"vgg16 launches a forward: {per}")
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    f32 = phase_serve(torch, np, cfg, params, label="vgg16 f32")
    bf16 = phase_serve(torch, np, cfg16, params16, cfg_f32=cfg,
                       params_f32=to_f32(params16), tol=TOL_BF16,
                       arrivals=BF16_ARRIVALS, label="vgg16 bf16")
    check(f32["tuned_layers"] == bf16["tuned_layers"] == [],
          "a plan tuned for AlexNet in f32 steered VGG-16")
    return {"f32": f32, "bf16": bf16}


def to_f32(params):
    return {k: {n: t.float() for n, t in v.items()}
            for k, v in params.items()}


def phase_alexnet_bf16(torch, np, cfg, params16):
    """4e: bf16 AlexNet through ``CnnEngine(max_batch=8)``: 32 requests
    bit-equal to bf16 ``apply`` and within TOL_BF16 of the f32 model on the
    same weights; then BENCH_sdc's clean and bitflip scenarios in bf16."""
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    serve = phase_serve(torch, np, cfg16, params16, cfg_f32=cfg,
                        params_f32=to_f32(params16), tol=TOL_BF16,
                        label="alexnet bf16")
    check(serve["tuned_layers"] == [], "a plan tuned in f32 steered bf16 "
          "AlexNet (the plan keys carry the dtype)")
    sdc = sdc_scenarios(torch, np, cfg16, params16,
                        np.random.default_rng(SDC_SEED + 2), card_line(),
                        ("clean", "bitflip"), label=" bf16")
    return {"serve": serve, "sdc": sdc}


def poisson_trace(rate_hz, duration_s, rng):
    """Open-loop Poisson arrivals: exponential inter-arrival gaps."""
    out, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / rate_hz)
        if t >= duration_s:
            return out
        out.append(t)


def diurnal_trace(base_hz, duration_s, period_s, rng, depth=0.8):
    """Nonhomogeneous Poisson arrivals with a sinusoidal rate, sampled by
    thinning against the peak rate."""
    peak = base_hz * (1 + depth)
    out, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / peak)
        if t >= duration_s:
            return out
        if rng.uniform() * peak <= base_hz * (
                1 + depth * math.sin(2 * math.pi * t / period_s)):
            out.append(t)


def phase_fleet(torch, np, cfgs, params, seed):
    """4f: ``ModelRegistry(slot_budget=32)`` serving full-width AlexNet
    and VGG-16 (f32, max_batch=8): each warm engine's service ms at bucket
    8, ``arm_slo(1.6 x service ms, admission=True)``, then a 3 s open-loop
    trace from ``seed`` (AlexNet diurnal at 0.5x its capacity, VGG-16
    Poisson at 0.35x), held to the fleet benchmark's gates."""
    from repro_torch.serving import CnnServeConfig, ImageRequest, \
        ModelRegistry
    names = ("alexnet", "vgg16")
    rng = np.random.default_rng(seed)
    pool = {n: rng.standard_normal((16, cfgs[n].image_size,
                                    cfgs[n].image_size, 3)).astype(
                                        np.float32) for n in names}
    count = {n: 0 for n in names}

    def image(n):
        count[n] += 1
        return pool[n][count[n] % len(pool[n])]

    reg = ModelRegistry(slot_budget=32)
    for n in names:
        reg.register(n, cfgs[n], CnnServeConfig(max_batch=BATCH),
                     params=params[n], device="cuda")
        warm_buckets(reg[n], lambda k, n=n: [ImageRequest(image=image(n))
                                             for _ in range(k)])
    svc_ms = {}
    for n in names:
        samples = []
        for _ in range(5):
            reqs = [ImageRequest(image=image(n)) for _ in range(BATCH)]
            for r in reqs:
                reg[n].submit(r)
            reg[n].run_until_done()
            samples.append(np.median([r.t_done - r.t_submit for r in reqs]))
        reg[n].reset_metrics()
        svc_ms[n] = float(np.median(samples)) * 1e3
    slos = {n: 1.6 * svc_ms[n] for n in names}
    for n in names:
        reg[n].arm_slo(slos[n], admission=True)
    dur = 3.0
    cap_hz = {n: BATCH * 1e3 / svc_ms[n] for n in names}
    arrivals = sorted(
        [(t, "alexnet") for t in diurnal_trace(
            0.5 * cap_hz["alexnet"], dur, dur / 1.5, rng)]
        + [(t, "vgg16") for t in poisson_trace(0.35 * cap_hz["vgg16"], dur,
                                               rng)])
    reqs = {n: [] for n in names}
    shed = {n: [] for n in names}
    reset_launch_counts()
    t0 = time.perf_counter()
    i = 0
    while True:
        now = time.perf_counter() - t0
        check(now < dur * 20 + 60, "fleet: the open-loop run did not end")
        while i < len(arrivals) and arrivals[i][0] <= now:
            n = arrivals[i][1]
            req = ImageRequest(image=image(n))
            (reqs if reg.submit(n, req) else shed)[n].append(req)
            i += 1
        if i == len(arrivals) and reg.idle:
            break
        if reg.idle:
            time.sleep(min(arrivals[i][0] - now, 0.02))
            continue
        reg.step()
    wall_s = time.perf_counter() - t0
    counts = launch_counts()
    s = reg.stats()
    card = card_line()
    per = {}
    for n in names:
        e = s["models"][n]
        eng = reg[n]
        check(eng.drained and eng.sched.occupancy == 0,
              f"fleet: {n} did not drain")
        check(all(r.shed and not r.done for r in shed[n]),
              f"fleet: {n} has a shed request that was served")
        check(all(r.done for r in reqs[n]), f"fleet: {n} lost a request")
        check(e["images_shed"] == len(shed[n])
              and e["images_completed"] == len(reqs[n]),
              f"fleet: {n} counts {e['images_shed']} shed / "
              f"{e['images_completed']} completed against the front door's "
              f"{len(shed[n])} / {len(reqs[n])}")
        check(e["accounting"]["balanced"], f"fleet: {n} accounting "
              f"{e['accounting']}")
        lat = np.asarray([r.t_done - r.t_submit for r in reqs[n]]) * 1e3
        p50, p99 = ((float(np.percentile(lat, 50)),
                     float(np.percentile(lat, 99))) if lat.size
                    else (0.0, 0.0))
        per[n] = {"service_ms": svc_ms[n], "slo_ms": slos[n],
                  "offered_hz": (0.5 if n == "alexnet" else 0.35)
                  * cap_hz[n], "submitted": len(reqs[n]) + len(shed[n]),
                  "completed": len(reqs[n]), "shed": len(shed[n]),
                  "within_slo": e["images_within_slo"],
                  "imgs_per_s": len(reqs[n]) / wall_s,
                  "engine_imgs_per_s": e["imgs_per_s"],
                  "goodput_imgs_per_s": e["images_within_slo"] / wall_s,
                  "p50_ms": p50, "p99_ms": p99}
        print(f"fleet: {n} | service {svc_ms[n]:.3f} ms at bucket {BATCH}, "
              f"SLO {slos[n]:.3f} ms, offered {per[n]['offered_hz']:.1f} "
              f"img/s | {per[n]['completed']}/{per[n]['submitted']} served"
              f", shed {per[n]['shed']} | {per[n]['imgs_per_s']:.2f} img/s"
              f" goodput {per[n]['goodput_imgs_per_s']:.2f} img/s | p50 "
              f"{p50:.3f} ms p99 {p99:.3f} ms | on {card}")
    print(f"fleet: {len(arrivals)} arrivals over {dur:.1f} s, wall "
          f"{wall_s:.3f} s, every engine drained, shed requests reported "
          f"and not served, front-door counts = engine counts, accounting "
          f"balanced | launches {counts}")
    return {"models": per, "wall_s": wall_s, "arrivals": len(arrivals),
            "slots_used": s["fleet"]["slots_used"], "launches": counts}


def drive_open_loop(arrivals, submit, step, idle, max_wall_s=300.0):
    """Replay arrival offsets (seconds) in real time: due requests are
    submitted, then the fleet ticks; sleep only when idle and the next
    arrival is ahead (``benchmarks/serve_fleet.py::drive_open_loop``).
    One arrival time (a burst) a tick: when a slow tick makes several
    bursts due, each still gets its own tick, so a pump-indexed fault
    lands mid-trace whatever the host's speed."""
    t0 = time.perf_counter()
    i = 0
    while True:
        now = time.perf_counter() - t0
        check(now <= max_wall_s, "supervised: the open-loop run did not end")
        while i < len(arrivals) and arrivals[i] <= now:
            submit()
            i += 1
            if i < len(arrivals) and arrivals[i] != arrivals[i - 1]:
                break
        if i == len(arrivals) and idle():
            return
        if idle():
            time.sleep(min(arrivals[i] - now, 0.02))
            continue
        step()


def worker_launches(sup):
    """Each worker incarnation's kernel launches since its ready (a dead
    one's as of its last heartbeat), as (worker, counts) pairs."""
    out = [(e["worker"] + " (killed)", e["launches"]) for e in sup.events
           if e["event"] == "death"]
    return out + [(h.name, h.last_launches) for h in sup.workers.values()
                  if h.alive]


def check_workers(sup, kind, label, require):
    """Every spawned worker names the card and launched the conv kernels
    in its warm-up; each worker in ``require`` launched them serving; no
    engine degraded a bucket."""
    spawns = [e for e in sup.events if e["event"] == "spawn"]
    check(spawns and all(e["device_name"] == kind for e in spawns),
          f"supervised {label}: a worker is not on {kind}: "
          f"{[e['device_name'] for e in spawns]}")
    check(all(e["warmup_launches"]["conv_direct"] > 0
              and e["warmup_launches"]["conv_winograd"] > 0 for e in spawns),
          f"supervised {label}: a worker's warm-up launched no conv kernel: "
          f"{[e['warmup_launches'] for e in spawns]}")
    check(not [e for e in sup.events if e["event"] == "spawn-failed"],
          f"supervised {label}: a spawn failed: {sup.events}")
    for name in require:
        h = sup.workers[name]
        check(h.alive and h.last_launches.get("conv_direct", 0) > 0
              and h.last_launches.get("conv_winograd", 0) > 0,
              f"supervised {label}: {name} launched no conv kernel: "
              f"{h.last_launches}")
    for h in sup.workers.values():
        check(not any(h.last_degradations.values()),
              f"supervised {label}: {h.name} degraded a bucket: "
              f"{h.last_degradations}")


def all_bit_equal(sup, label, params=None):
    """Every completed request bit-equal to ``apply`` at its served
    bucket, on the card."""
    done = [u for u, (_, r) in sup.requests.items() if r.done]
    par = sup.verify_bit_parity(uids=done, params=params)
    check(par["checked"] == len(done) > 0 and par["mismatched"] == 0,
          f"supervised {label}: served logits not bit-equal to apply: {par}")
    return par


def supervised_run(torch, np, cfg, params, kind, card, kill):
    """Part (a): BENCH_supervisor's run at full width, on the card."""
    from repro_torch.serving import (CnnServeConfig, FaultSpec, ImageRequest,
                                     Supervisor, SupervisorConfig,
                                     WorkerModel)
    label = "killed" if kill else "baseline"
    chaos = ({"worker.crash": FaultSpec(at=(SUP_KILL_AT,), limit=1)}
             if kill else None)
    sup = Supervisor((WorkerModel("alexnet", cfg,
                                  CnnServeConfig(max_batch=BATCH)),),
                     SupervisorConfig(n_workers=2, max_restarts=SUP_RESTARTS,
                                      checkpoint_on_start=False),
                     chaos=chaos, chaos_workers=("w0",), device="cuda")
    rng = np.random.default_rng(11)
    trace = [i * SUP_GAP_S for i in range(SUP_BURSTS)
             for _ in range(SUP_BURST)]
    reqs = []

    def submit():
        reqs.append(ImageRequest(image=rng.standard_normal(
            (cfg.image_size, cfg.image_size, cfg.in_channels)).astype(
                np.float32), deadline_ms=SUP_DEADLINE_MS,
            retries=SUP_RETRIES))
        sup.submit("alexnet", reqs[-1])

    t_up = time.perf_counter()
    with sup:
        up_s = time.perf_counter() - t_up
        t0 = time.perf_counter()
        drive_open_loop(trace, submit, sup.step, lambda: sup.drained)
        sup.run_until_done()
        wall = time.perf_counter() - t0
        sup.step()                      # refresh the heartbeat reports
        acc = sup.accounting()
        check(acc["balanced"] and acc["in_flight"] == 0
              and acc["submitted"] == acc["completed"] + acc["shed"]
              + acc["expired"], f"supervised {label}: accounting {acc}")
        within = sum(1 for r in reqs if r.done
                     and (r.t_done - r.t_submit) * 1e3 <= SUP_SLO_MS)
        check(within > 0, f"supervised {label}: zero goodput")
        failover = (sup.verify_bit_parity(params=params)
                    if sup.failover_uids
                    else {"checked": 0, "mismatched": 0, "bad_uids": []})
        deaths = [e for e in sup.events if e["event"] == "death"]
        if kill:
            check(deaths, "supervised: the seeded worker.crash never fired")
            check(acc["failed_over"] > 0, "supervised: the kill failed "
                  "over no request (it landed on an idle worker)")
            check(failover["checked"] > 0 and failover["mismatched"] == 0,
                  f"supervised: failover bit-parity violated: {failover}")
            # the trace drains before the respawn is up: wait for it, so
            # its card and warm-up launches are checked too
            while not sup.workers["w0"].alive:
                check(time.perf_counter() - t0 < 300,
                      "supervised: w0 did not come back")
                sup.step()
                time.sleep(0.01)
        check_workers(sup, kind, label, ("w1",) if kill else ("w0", "w1"))
        par = all_bit_equal(sup, label, params)
        lat = np.asarray([r.t_done - r.t_submit for r in reqs if r.done])
        respawn = [e for e in sup.events if e["event"] == "spawn"
                   and e["restarts"] > 0]
        out = {"accounting": acc, "imgs_per_s": acc["completed"] / wall,
               "goodput_imgs_per_s": within / wall, "wall_s": wall,
               "start_s": up_s,
               "p50_ms": float(np.percentile(lat, 50)) * 1e3,
               "p99_ms": float(np.percentile(lat, 99)) * 1e3,
               "deaths": [{"worker": e["worker"], "reason": e["reason"]}
                          for e in deaths],
               "kill_to_ready_s": (respawn[0]["t"] - deaths[0]["t"]
                                   if respawn and deaths else None),
               "failover_parity": failover, "parity": par,
               "launches": worker_launches(sup)}
    print(f"supervised {label}: {acc['completed']}/{acc['submitted']} "
          f"served (shed {acc['shed']}, expired {acc['expired']}, failed "
          f"over {acc['failed_over']}) | {out['imgs_per_s']:.2f} img/s, "
          f"goodput {out['goodput_imgs_per_s']:.2f} img/s (SLO "
          f"{SUP_SLO_MS:g} ms) | p50 {out['p50_ms']:.3f} ms p99 "
          f"{out['p99_ms']:.3f} ms | fleet up in {up_s:.2f} s | failover "
          f"parity {failover['checked']} checked, {failover['mismatched']} "
          f"mismatched; all {par['checked']} bit-equal | kill to ready "
          f"{out['kill_to_ready_s']} s | on {card}")
    return out


def supervised_restart(torch, np, cfgs, params, kind, card):
    """Part (b): a two-model fleet (f32 AlexNet, bf16 VGG-16) restarts
    crash-consistently past a torn checkpoint."""
    import tempfile

    from repro_torch import checkpoint as ckpt
    from repro_torch.models import alexnet
    from repro_torch.serving import (CnnServeConfig, ImageRequest,
                                     Supervisor, SupervisorConfig,
                                     WorkerModel)
    models = (WorkerModel("alexnet", cfgs["alexnet"],
                          CnnServeConfig(max_batch=BATCH), seed=0),
              WorkerModel("vgg16", cfgs["vgg16"],
                          CnnServeConfig(max_batch=BATCH), seed=1))
    rng = np.random.default_rng(12)

    def image(m):
        c = cfgs[m]
        return rng.standard_normal((c.image_size, c.image_size,
                                    c.in_channels)).astype(np.float32)

    def traffic(n):
        # each model's requests back to back: round-robin gives each
        # model's to both workers
        for m in ("alexnet", "vgg16"):
            for _ in range(n):
                sup.submit(m, ImageRequest(image=image(m),
                                           deadline_ms=60_000.0))

    with tempfile.TemporaryDirectory() as tmp:
        sup = Supervisor(models, SupervisorConfig(
            n_workers=2, max_restarts=SUP_RESTARTS), ckpt_dir=tmp,
            device="cuda")
        t_up = time.perf_counter()
        with sup:
            up_s = time.perf_counter() - t_up
            t_ck = time.perf_counter()
            check(sup.checkpoint()["step"] == 2, "supervised restart: the "
                  "second checkpoint is not step 2")
            ckpt_s = time.perf_counter() - t_ck
            for m, leaf in (("alexnet", "params__conv1__w.npy"),
                            ("vgg16", "params__fc6__w.npy")):
                path = os.path.join(tmp, m, "step_0000000002", leaf)
                with open(path, "r+b") as f:        # tear step 2
                    f.seek(-1, os.SEEK_END)
                    b = f.read(1)
                    f.seek(-1, os.SEEK_END)
                    f.write(bytes([b[0] ^ 0x01]))
            traffic(BATCH)          # queued at both workers, not stepped
            sup.kill_worker("w0", "chip_smoke: kill")
            t_kill = time.perf_counter()
            while not sup.workers["w0"].alive:
                check(time.perf_counter() - t_kill < 300,
                      "supervised restart: w0 did not come back")
                sup.step()
                time.sleep(0.01)
            kill_to_ready = next(e["t"] for e in sup.events
                                 if e["event"] == "spawn"
                                 and e["restarts"] == 1) - next(
                e["t"] for e in sup.events if e["event"] == "death")
            h = sup.workers["w0"]
            check(h.restored == {"alexnet": 1, "vgg16": 1},
                  f"supervised restart: w0 restored {h.restored}, not step "
                  f"1 past the torn step 2")
            for _ in range(5):
                traffic(BATCH)
                sup.run_until_done()
                sup.step()
                served = {m: a["completed"]
                          for m, a in h.last_accounting.items()}
                if all(served.get(m, 0) > 0 for m in cfgs):
                    break
            check(all(served.get(m, 0) > 0 for m in cfgs),
                  f"supervised restart: the respawned w0 served {served}")
            acc = sup.accounting()
            check(acc["balanced"] and acc["in_flight"] == 0
                  and acc["submitted"] == acc["completed"] + acc["shed"]
                  + acc["expired"] and acc["failed_over"] > 0,
                  f"supervised restart: accounting {acc}")
            check_workers(sup, kind, "restart", ("w0", "w1"))
            check(h.last_launches.get("conv_winograd_fused", 0) > 0,
                  f"supervised restart: w0 launched no fused Winograd "
                  f"kernel: {h.last_launches}")
            # the workers' params are init(seed)'s: served logits bit-equal
            # to apply on init's params prove the restored bf16 leaves
            par = all_bit_equal(sup, "restart", params)
            got = ckpt.restore(os.path.join(tmp, "vgg16"), {
                "step": 0, "params": alexnet.empty_params(
                    cfgs["vgg16"], device="cuda")}, step=1)["params"]
            check(all(got[l][k].dtype == torch.bfloat16 and torch.equal(
                got[l][k].view(torch.int16),
                params["vgg16"][l][k].view(torch.int16))
                for l in got for k in got[l]),
                "supervised restart: the bf16 leaves of step 1 are not "
                "init's bits")
            launches = worker_launches(sup)
    print(f"supervised restart: AlexNet f32 + VGG-16 bf16 on 2 workers, "
          f"up in {up_s:.2f} s, checkpoint {ckpt_s:.2f} s; w0 killed and "
          f"back in {kill_to_ready:.2f} s with step 1 past the torn step "
          f"2; {acc['completed']}/{acc['submitted']} served, failed over "
          f"{acc['failed_over']}; all {par['checked']} bit-equal to apply "
          f"| on {card}")
    return {"accounting": acc, "start_s": up_s, "checkpoint_s": ckpt_s,
            "kill_to_ready_s": kill_to_ready, "restored": h.restored,
            "parity": par, "launches": launches}


def phase_supervised(torch, np, cfgs, params, kind):
    """4g: BENCH_supervisor at full width (part a) and a crash-consistent
    restart of a two-model fleet (part b), kernels 1-3 in every worker.
    ``params``: init(0) of f32 AlexNet and init(1) of bf16 VGG-16, what
    the workers draw."""
    card = card_line()
    t0 = time.perf_counter()
    alex = {"alexnet": params["alexnet"]}
    runs = {"baseline": supervised_run(torch, np, cfgs["alexnet"], alex,
                                       kind, card, kill=False),
            "killed": supervised_run(torch, np, cfgs["alexnet"], alex, kind,
                                     card, kill=True)}
    gp = runs["baseline"]["goodput_imgs_per_s"]
    ratio = runs["killed"]["goodput_imgs_per_s"] / gp
    restart = supervised_restart(torch, np, cfgs, params, kind, card)
    totals = {k: 0 for k in launch_counts()}
    for out in (*runs.values(), restart):
        for _, counts in out["launches"]:
            for k, n in counts.items():
                totals[k] += n
    seconds = time.perf_counter() - t0
    print(f"supervised: goodput_under_kill_ratio {ratio:.4f} | workers' "
          f"launches {totals} | phase {seconds:.1f} s | on {card}")
    return {**runs, "restart": restart, "goodput_under_kill_ratio": ratio,
            "launches": totals, "seconds": seconds}

def phase_decode(torch, np):
    """Kernel 5 at each decode geometry: held against its plain version in
    f32 and bf16, timed in bf16 (the served dtype) beside its bound and
    beside SDPA with the same length mask (``library_ms``)."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attn import decode_attn as dec
    from repro_torch.kernels.decode_attn.ref import decode_attention_f32_ref
    rng = np.random.default_rng(3)
    row = {"name": "decode_attn", "geometries": [], "max_abs_err": 0.0}
    for name, B, S, H, KV, D, fixed in DECODE_GEOMETRIES:
        lens = torch.as_tensor(rng.integers(1, S + 1, B) if fixed is None
                               else fixed, dtype=torch.int32, device="cuda")
        base = [torch.as_tensor(rng.standard_normal(shape),
                                dtype=torch.float32, device="cuda")
                for shape in ((B, 1, H, D), (B, S, KV, D), (B, S, KV, D))]
        geo = {"arch": name, "B": B, "S": S, "H": H, "KV": KV, "D": D,
               "lengths": lens.tolist(),
               "split_rows": dec.split_rows(B, S, KV, H // KV, D),
               "grid": list(dec.decode_grid(B, S, KV, H // KV, D))}
        for dtype_name in ("float32", "bfloat16"):
            q, k, v = (t.to(getattr(torch, dtype_name)) for t in base)
            got = dec.decode_attention(q, k, v, lens)
            torch.cuda.synchronize()
            ref = dec.decode_attention_ref(q, k, v, lens)
            ref32 = decode_attention_f32_ref(q, k, v, lens)
            check(got.shape == ref.shape and got.dtype == q.dtype,
                  f"decode_attn {name}: {tuple(got.shape)} {got.dtype}")
            check(bool(torch.isfinite(got).all()),
                  f"decode_attn {name}: non-finite output")
            diff = (got.float() - ref.float()).abs()
            tol = TOL_DECODE[dtype_name]
            excess = float((diff - tol * ref.float().abs()).max())
            err = float(diff.max())
            diff32 = (got.float() - ref32.float()).abs()
            atol, rtol = TOL_DECODE_F32P[dtype_name]
            excess32 = float((diff32 - rtol * ref32.float().abs()).max())
            err32 = float(diff32.max())
            print(f"kernel decode_attn {name} {dtype_name}: q {tuple(q.shape)}"
                  f" cache {tuple(k.shape)} split rows {geo['split_rows']} "
                  f"grid {tuple(geo['grid'])} (two calls bit-equal) | "
                  f"max_abs_err {err:.3e} "
                  f"(max|plain| {float(ref.float().abs().max()):.3e}, gate "
                  f"rtol = atol = {tol:g}, worst excess {excess:.3e}) | vs "
                  f"f32-probability plain {err32:.3e} (gate atol {atol:g} "
                  f"rtol {rtol:g}, worst excess {excess32:.3e})")
            check(excess <= tol, f"decode_attn {name} {dtype_name}: kernel "
                  f"disagrees with its plain version: |diff| exceeds "
                  f"{tol} + {tol} * |plain| by {excess}")
            check(excess32 <= atol, f"decode_attn {name} {dtype_name}: "
                  f"kernel disagrees with the f32-probability plain version:"
                  f" |diff| exceeds {atol} + {rtol} * |plain| by {excess32}")
            again = dec.decode_attention(q, k, v, lens)
            check(torch.equal(got.view(torch.int8), again.view(torch.int8)),
                  f"decode_attn {name} {dtype_name}: two calls differ")
            geo[f"max_abs_err_{dtype_name}"] = err
            geo[f"max_abs_err_f32p_{dtype_name}"] = err32
            row["max_abs_err"] = max(row["max_abs_err"], err)
        # timed in bf16, the dtype of the served caches
        mask = (torch.arange(S, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

        def kern():
            return dec.decode_attention(q, k, v, lens)

        def plain():
            return dec.decode_attention_ref(q, k, v, lens)

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True).transpose(1, 2)

        lib_err = float((kern().float() - library().float()).abs().max())
        (ms, host_ms), (plain_ms, _), (lib_ms, _) = (
            time_ms(torch, kern), time_ms(torch, plain),
            time_ms(torch, library))
        valid = int(lens.clamp(max=S).sum())
        flops, nbytes = decode_work(B, H, KV, D, valid, k.element_size())
        bound, bound_by = _bound(flops, nbytes, "bfloat16")
        print(f"kernel decode_attn {name} bfloat16: kernel_ms {ms:.4f} (host "
              f"enqueue {host_ms:.4f} ms) plain_ms {plain_ms:.4f} "
              f"library_ms(SDPA, enable_gqa, length mask) {lib_ms:.4f} "
              f"(vs kernel {lib_err:.3e}) bound_ms {bound:.4f} ({bound_by}: "
              f"{flops:.3e} flop, {nbytes:.3e} B over {valid} valid rows)")
        geo.update(ms=ms, host_ms=host_ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound, bound_by=bound_by,
                   flop=flops, bytes=nbytes, library_vs_kernel=lib_err)
        row["geometries"].append(geo)
    # the entry's numbers: the served geometry (smollm-360m's)
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"):
        row[key] = row["geometries"][0][key]
    return row


def _requests(rng, vocab, n, lo, hi, max_new):
    from repro_torch.serving import Request
    return [Request(prompt=rng.integers(1, vocab, size=int(
        rng.integers(lo, hi + 1))).tolist(), max_new=max_new)
        for _ in range(n)]


def profile_decode(torch, decode, steps=3, marks=("decode_attn",)):
    """Where ``decode()``'s time goes (any call: a decode step, a
    prefill, a served batch): (wall ms per call, untraced, with a
    host sync after each call as a served step has; then from a
    ``torch.profiler`` trace of ``steps`` calls: device busy ms per call,
    device events per call, the ms per call of the kernels whose names
    hold each of ``marks``, and the 6 largest kernels by time).  The
    trace's entries are None when it holds no device events."""
    from torch.profiler import ProfilerActivity, profile
    decode()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        decode()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            decode()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return wall_ms, None, None, None, None
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    by_mark = {m: sum(us for name, us in by_name.items() if m in name)
               / steps / 1e3 for m in marks}
    return (wall_ms, sum(by_name.values()) / steps / 1e3, len(dev) / steps,
            by_mark, [(name[:60], us / steps / 1e3) for name, us in top])


# kernel 6's launches (csrc/ssd.cu), by kernel: the front launches (one
# chunk: C.B^T, then chunk 0's y beside the state contributions; two chunks
# or more: C.B^T beside every chunk's state contribution), the state pass,
# and the y of every chunk (two chunks or more)
SSD_STAGES = ("ssd_cb_kernel", "ssd_front_kernel", "ssd_pass_kernel",
              "ssd_y_kernel")


def stage_ms(torch, fn, stages, calls=5):
    """Device ms of each launch of one call of ``fn`` (``stages``: kernel
    names in launch order, each launched at most once a call), from a
    ``torch.profiler`` trace of ``calls`` calls, each after the L2 flush of
    ``time_ms``: {stage: mean duration, or None if it never ran}, and
    ``"span"``: the mean time from the first launch's start to the last
    one's end.  Launches started programmatically dependent overlap the
    one before, so the durations may sum to more than the span.  None
    when the trace holds no device events."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.zeros(64 * 2 ** 20 // 4, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.sum()
            fn()
            torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and any(st in e.name for st in stages)),
                 key=lambda e: e.time_range.start)
    if not evs:
        return None
    # a call's launches come in the order of ``stages``: an event whose
    # stage is not after the last one's starts the next call
    per, spans, call, last = {st: [] for st in stages}, [], [], -1
    for e in evs + [None]:
        k = None if e is None else next(
            i for i, st in enumerate(stages) if st in e.name)
        if call and (e is None or k <= last):
            spans.append(max(c.time_range.end for c in call)
                         - min(c.time_range.start for c in call))
            call = []
        if e is None:
            break
        call.append(e)
        last = k
        per[stages[k]].append(e.time_range.elapsed_us())
    out = {st: (sum(v) / len(v) / 1e3 if v else None)
           for st, v in per.items()}
    out["span"] = sum(spans) / len(spans) / 1e3
    return out


def _copy_cache(cache):
    return [{kind: {n: t.clone() for n, t in bufs.items()}
             for kind, bufs in c.items()} for c in cache]


def phase_lm(torch, np):
    """Full-width smollm-360m through the token Engine; kernel 5 counted on
    every decode step; one mid-run step's logits re-run with the plain
    decode attention on a copy of the same cache."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn import ops as dec_ops
    from repro_torch.models import lm
    from repro_torch.serving import Engine, ServeConfig
    cfg = get_config(LM_ARCH)
    scfg = ServeConfig(max_batch=BATCH, max_len=512, prefill_bucket=64)
    rng = np.random.default_rng(4)
    t0 = time.perf_counter()
    params = lm.init(0, cfg, device="cuda")
    init_s = time.perf_counter() - t0
    # warm-up: cuBLAS handles and every kernel once
    warm = Engine(cfg, scfg, params=params, device="cuda")
    for r in _requests(rng, cfg.vocab_size, 2, 8, 70, 2):
        warm.submit(r)
    warm.run_until_done()
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    eng = Engine(cfg, scfg, params=params, device="cuda")
    reqs = _requests(rng, cfg.vocab_size, LM_REQUESTS, 8, 200,
                     LM_MAX_NEW)
    probe = {}

    def snapshot(e):
        """Copies of what the probe step's batched decode reads, and for
        each active slot its request and the index of the token the step
        will emit."""
        if e.decode_steps == LM_PROBE_STEP:
            mask = e.active.copy()
            probe.update(tokens=e.last_tokens.clone(),
                         lengths=e.lengths.copy(), mask=mask,
                         cache=_copy_cache(e.cache),
                         emits=[(e.slot_req[s], len(e.slot_req[s].generated))
                                for s in np.nonzero(mask)[0]])

    reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run_until_done(before_decode=snapshot)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    check(all(r.done and len(r.generated) == LM_MAX_NEW for r in reqs),
          f"lm serve: {sum(r.done for r in reqs)}/{len(reqs)} done, tokens "
          f"{sorted({len(r.generated) for r in reqs})}")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          "lm serve: a token outside the vocabulary")
    steps = eng.decode_steps
    check(counts["decode_attn"] == cfg.num_layers * steps,
          f"decode_attn: {counts['decode_attn']} launches for {steps} decode "
          f"steps, expected {cfg.num_layers} per step")
    check(bool(probe), f"the run ended before decode step {LM_PROBE_STEP}")

    # the probe step again, on copies of its cache: kernel 5, then plain;
    # the launch counts show which attention each re-run took
    def logits_of(cache):
        return eng.decode(probe["tokens"], probe["lengths"], cache)

    def kernel5_launches():
        return dec_ops.launch_counts()["decode_attn"]

    n0 = kernel5_launches()
    kern = logits_of(_copy_cache(probe["cache"]))
    n1 = kernel5_launches()
    with plain_decode_attention():
        plain = logits_of(probe["cache"])
    n2 = kernel5_launches()
    check(n1 - n0 == cfg.num_layers and n2 == n1, f"lm probe: kernel 5 ran "
          f"{n1 - n0} times in the kernel re-run and {n2 - n1} in the plain "
          f"one; expected {cfg.num_layers} and 0")
    torch.cuda.synchronize()
    act = torch.as_tensor(probe["mask"], device="cuda")
    kern, plain = kern[act], plain[act]
    check(bool(torch.isfinite(kern).all()) and kern.shape[-1]
          == cfg.vocab_size, "lm probe: logits malformed")
    dmax = float((kern - plain).abs().max())
    lmax = float(plain.abs().max())
    emitted = np.array([req.generated[i] for req, i in probe["emits"]])
    same = int((kern.argmax(-1).cpu().numpy() == emitted).sum())
    print(f"lm probe step {LM_PROBE_STEP}: {int(probe['mask'].sum())} active "
          f"slots | kernel-5 vs plain decode logits max|d| {dmax:.3e} "
          f"(max|logit| {lmax:.3e}, rel {dmax / lmax:.3e}, tol {TOL_LM:g}) | "
          f"argmax = emitted token on {same}/{len(emitted)} slots")
    check(dmax <= TOL_LM * lmax, f"lm probe: kernel-5 logits off the plain "
          f"version's: {dmax} > {TOL_LM} * {lmax}")
    check(same == len(emitted), "lm probe: the re-run step's argmax is not "
          "the token the engine emitted")

    # where a decode step's time goes: the probe step re-run on its cache
    # copy, its wall time untraced and its device busy time traced; the
    # served steps' mean host time beside it
    step_ms = eng.decode_seconds / steps * 1e3
    probe_ms, busy_ms, events, marks, top = profile_decode(
        torch, lambda: logits_of(probe["cache"]))
    kernel5_ms = None if marks is None else marks["decode_attn"]
    if busy_ms is None:
        idle = None
        print(f"lm decode step: {step_ms:.3f} ms host time a served step, "
              f"{probe_ms:.3f} ms the probe step | the profiler trace holds"
              " no device events; device busy time not measured")
    else:
        idle = 1.0 - busy_ms / probe_ms
        print(f"lm decode step: {step_ms:.3f} ms host time a served step "
              f"(mean) | probe step {probe_ms:.3f} ms wall, device busy "
              f"{busy_ms:.3f} ms in {events:.0f} device events (profiled), "
              f"kernel 5 {kernel5_ms:.4f} ms of it | device idle share of "
              f"the probe step {idle:.4f} | top: "
              + "; ".join(f"{n} {ms:.4f} ms" for n, ms in top))

    # a reduced model: the card's greedy tokens are the CPU engine's
    reduced_on_card(torch, np, LM_ARCH, 1)

    lat = eng.latency.percentiles_ms()
    return {"arch": LM_ARCH, "completed": sum(r.done for r in reqs),
            "max_len": scfg.max_len,
            "tokens": eng.tokens_generated, "decode_steps": steps,
            "decode_tokens_per_s": eng.decode_tokens_per_s,
            "wall_tokens_per_s": eng.tokens_generated / wall,
            "wall_s": wall, "decode_s": eng.decode_seconds,
            "p50_ms": lat["p50"], "p99_ms": lat["p99"],
            "peak_mem_bytes": peak, "launches": counts,
            "init_s": init_s, "probe_max_abs": dmax, "probe_max_logit": lmax,
            "step_ms": step_ms, "probe_step_ms": probe_ms,
            "device_busy_ms_per_step": busy_ms,
            "device_events_per_step": events, "device_idle_share": idle,
            "kernel5_ms_per_step": kernel5_ms,
            "prompt_lengths": [len(r.prompt) for r in reqs]}


def _excess(got, ref, rel_step):
    """(worst excess of |got - ref| over its bound, max|diff|, max|ref|):
    the bound is TOL_KERNEL * max|ref|, plus one bf16 step of |ref| where
    the output was rounded to bf16 (``rel_step``); the check is excess <=
    0."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    scale = float(ref.abs().max())
    bound = TOL_KERNEL * scale
    if rel_step:
        bound = bound + BF16_STEP * ref.abs()
    return float((diff - bound).max()), float(diff.max()), scale


def _bound(flops, nbytes, dtype="float32"):
    """(bound ms, bound_by): the larger of ``flops`` at the card's
    ``dtype`` peak and ``nbytes`` at its memory rate."""
    t_ops, t_bytes = flops / HW.peak(dtype), nbytes / HW.hbm_bw
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def stream_copy(x):
    """A bare read and write of x's bytes (``Tensor.copy_`` into a buffer of
    its shape): the floor a kernel streaming x in and out can reach."""
    buf = x.new_empty(x.shape)
    return lambda: buf.copy_(x)


def phase_ssm(torch, np, ssd_geometries=SSD_GEOMETRIES,
              dw1d_geometries=DW1D_GEOMETRIES, seed=5):
    """Kernels 6 and 7 at mamba2-2.7b's prefill shapes (or the given
    geometries), on inputs in the model's ranges (dt after softplus in
    [1e-3, 1e-1], A = -exp(A_log) on mamba's [-16, -1] grid): held against
    their plain versions, timed beside them and beside their bounds
    (kernel 7 also beside F.conv1d)."""
    import torch.nn.functional as F

    from repro_torch.kernels.conv import winograd as wino
    from repro_torch.kernels.ssd import ssd
    rng = np.random.default_rng(seed)

    def dev(a, dtype):
        return torch.as_tensor(a, dtype=torch.float32,
                               device="cuda").to(dtype)

    row6 = {"name": "ssd", "geometries": [], "max_abs_err": 0.0,
            "library_ms": None,
            "library": "none: no single PyTorch call computes an SSD scan"}
    for name, B, L, H, P, G, N, chunk, dtype_name in ssd_geometries:
        dtype = getattr(torch, dtype_name)
        x = dev(rng.standard_normal((B, L, H, P)), dtype)
        dt = dev(rng.uniform(1e-3, 1e-1, (B, L, H)), torch.float32)
        A = dev(-np.linspace(1.0, 16.0, H), torch.float32)
        Bm = dev(rng.standard_normal((B, L, G, N)), dtype)
        Cm = dev(rng.standard_normal((B, L, G, N)), dtype)

        def kern():
            return ssd.ssd_chunked_pallas(x, dt, A, Bm, Cm, chunk=chunk)

        def plain():
            return ssd.ssd_chunked_plain(x, dt, A, Bm, Cm, chunk=chunk)

        y, st = kern()
        torch.cuda.synchronize()
        y_ref, st_ref = plain()
        check(y.shape == y_ref.shape and y.dtype == dtype
              and st.shape == st_ref.shape and st.dtype == torch.float32,
              f"ssd {name} {dtype_name}: {tuple(y.shape)} {y.dtype} "
              f"{tuple(st.shape)} {st.dtype}")
        check(bool(torch.isfinite(y).all() and torch.isfinite(st).all()),
              f"ssd {name} {dtype_name}: non-finite output")
        ex_y, err_y, max_y = _excess(y, y_ref, dtype == torch.bfloat16)
        ex_s, err_s, max_s = _excess(st, st_ref, False)
        Q = min(chunk, L)
        (ms, host_ms), (plain_ms, _) = (time_ms(torch, kern),
                                        time_ms(torch, plain))
        stages = stage_ms(torch, kern, SSD_STAGES)
        flops, nbytes = ssd_work(B, L, H, P, G, N, Q, x.element_size())
        bound, bound_by = _bound(flops, nbytes)
        print(f"kernel ssd {name} {dtype_name}: x {tuple(x.shape)} B/C "
              f"{tuple(Bm.shape)} Q {Q} chunks {-(-L // Q)} | y max_abs_err "
              f"{err_y:.3e} (max|plain| {max_y:.3e}, worst excess "
              f"{ex_y:.3e}) state {err_s:.3e} (max|plain| {max_s:.3e}, "
              f"worst excess {ex_s:.3e}; gate excess <= 0) | kernel_ms "
              f"{ms:.4f} (host enqueue {host_ms:.4f} ms) plain_ms "
              f"{plain_ms:.4f} library_ms none bound_ms {bound:.4f} "
              f"({bound_by}: {flops:.3e} flop, {nbytes:.3e} B) | launches "
              f"(rows {ssd.row_tile(B, L, H, Q)}, state rows "
              f"{ssd.state_slice(B, L, H, N, Q)}), device ms from a trace: "
              + ("not measured (no device events)" if stages is None else
                 " ".join(f"{k} {v:.4f}" for k, v in stages.items()
                          if v is not None)))
        check(ex_y <= 0 and ex_s <= 0, f"ssd {name} {dtype_name}: kernel "
              f"disagrees with its plain version (y excess {ex_y}, state "
              f"excess {ex_s})")
        row6["geometries"].append({
            "geometry": name, "dtype": dtype_name, "B": B, "L": L, "H": H,
            "P": P, "G": G, "N": N, "Q": Q, "max_abs_err_y": err_y,
            "max_abs_err_state": err_s, "max_abs_plain_y": max_y, "ms": ms,
            "host_ms": host_ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "flop": flops, "bytes": nbytes,
            "rows": ssd.row_tile(B, L, H, Q),
            "state_rows": ssd.state_slice(B, L, H, N, Q),
            "stages_ms": stages})
        row6["max_abs_err"] = max(row6["max_abs_err"], err_y, err_s)

    row7 = {"name": "dw1d", "geometries": [], "max_abs_err": 0.0}
    for name, B, L, C, dtype_name in dw1d_geometries:
        dtype = getattr(torch, dtype_name)
        x = dev(rng.standard_normal((B, L, C)), dtype)
        w = dev(rng.standard_normal((4, C)) * 0.1, torch.float32)
        b = dev(rng.standard_normal((C,)) * 0.1, torch.float32)
        xt, wl, bl = x.transpose(1, 2), w.T[:, None, :].to(dtype), b.to(dtype)

        def kern():
            return wino.conv1d_depthwise_causal(x, w, b)

        def plain():
            return wino.conv1d_depthwise_causal_plain(x, w, b)

        def library():
            # full f32 (cuDNN runs an f32 conv in TF32 by default)
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                return F.conv1d(xt, wl, bl, padding=3, groups=C)[..., :L]

        got = kern()
        torch.cuda.synchronize()
        ref = plain()
        check(got.shape == ref.shape and got.dtype == dtype,
              f"dw1d {name} {dtype_name}: {tuple(got.shape)} {got.dtype}")
        check(bool(torch.isfinite(got).all()),
              f"dw1d {name} {dtype_name}: non-finite output")
        ex, err, scale = _excess(got, ref, dtype == torch.bfloat16)
        lib_err = float((got.float() - library().transpose(1, 2).float())
                        .abs().max())
        (ms, host_ms), (plain_ms, _), (lib_ms, _), (floor_ms, _) = (
            time_ms(torch, kern), time_ms(torch, plain),
            time_ms(torch, library), time_ms(torch, stream_copy(x)))
        flops, nbytes = dw1d_work(B, L, C, x.element_size())
        bound, bound_by = _bound(flops, nbytes)
        print(f"kernel dw1d {name} {dtype_name}: x {tuple(x.shape)} | "
              f"max_abs_err {err:.3e} (max|plain| {scale:.3e}, worst excess "
              f"{ex:.3e}, gate excess <= 0; vs F.conv1d {lib_err:.3e}) | "
              f"kernel_ms {ms:.4f} (host enqueue {host_ms:.4f} ms) plain_ms "
              f"{plain_ms:.4f} library_ms(F.conv1d, groups=C, TF32 off) "
              f"{lib_ms:.4f} bound_ms {bound:.4f} ({bound_by}: "
              f"{flops:.3e} flop, {nbytes:.3e} B) stream floor "
              f"{floor_ms:.4f} (a bare read and write of x's bytes) | "
              f"tiles a block {wino.dw1d_launch(B, L, C)}")
        check(ex <= 0, f"dw1d {name} {dtype_name}: kernel disagrees with its"
              f" plain version (excess {ex})")
        row7["geometries"].append({
            "geometry": name, "dtype": dtype_name, "B": B, "L": L, "C": C,
            "max_abs_err": err, "max_abs_plain": scale, "ms": ms,
            "host_ms": host_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_vs_kernel": lib_err, "bound_ms": bound,
            "bound_by": bound_by, "flop": flops, "bytes": nbytes,
            "stream_floor_ms": floor_ms,
            "tiles": wino.dw1d_launch(B, L, C)})
        row7["max_abs_err"] = max(row7["max_abs_err"], err)
    # the entries' numbers: the served geometry in bf16 (the served dtype)
    for row, keys in ((row6, ("ms", "plain_ms", "bound_ms", "bound_by")),
                      (row7, ("ms", "plain_ms", "library_ms", "bound_ms",
                              "bound_by", "stream_floor_ms"))):
        for key in keys:
            row[key] = row["geometries"][0][key]
    return {"ssd": row6, "dw1d": row7}


@contextlib.contextmanager
def plain_ssm_route():
    """The SSM mixer's conv and scan on the plain route (``pallas=False``:
    the pure-torch Winograd and chunked twins) while inside."""
    from repro_torch.kernels.conv import ops as conv_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    real = ssd_ops.ssd_chunked, conv_ops.conv1d_depthwise_causal
    ssd_ops.ssd_chunked = functools.partial(real[0], pallas=False)
    conv_ops.conv1d_depthwise_causal = functools.partial(real[1],
                                                         pallas=False)
    try:
        yield
    finally:
        ssd_ops.ssd_chunked, conv_ops.conv1d_depthwise_causal = real


def _host_ms(torch, fn, iters=3):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def phase_mamba(torch, np):
    """Full-width mamba2-2.7b through the token Engine; kernels 6 and 7
    counted on every layer of every prefill; the longest prompt's prefill
    re-run with the kernels and on the plain route."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving import Engine, Request, ServeConfig
    cfg = get_config(SSM_ARCH)
    scfg = ServeConfig(max_batch=BATCH, max_len=512)
    rng = np.random.default_rng(6)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # drawn on the card: 2.7 B truncated-normal draws on the host take long
    params = lm.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                     device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    warm = Engine(cfg, scfg, params=params, device="cuda")
    for r in _requests(rng, cfg.vocab_size, 2, 8, 70, 2):
        warm.submit(r)
    warm.run_until_done()
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    eng = Engine(cfg, scfg, params=params, device="cuda")
    reqs = _requests(rng, cfg.vocab_size, LM_REQUESTS, *SSM_PROMPTS,
                     LM_MAX_NEW)
    reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    check(all(r.done and len(r.generated) == LM_MAX_NEW for r in reqs),
          f"mamba serve: {sum(r.done for r in reqs)}/{len(reqs)} done, "
          f"tokens {sorted({len(r.generated) for r in reqs})}")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          "mamba serve: a token outside the vocabulary")
    prefills = len(reqs)
    for k in ("ssd", "dw1d"):
        check(counts[k] == cfg.num_layers * prefills,
              f"{k}: {counts[k]} launches for {prefills} prefills, expected "
              f"{cfg.num_layers} per prefill")
    others = {k: n for k, n in counts.items() if k not in ("ssd", "dw1d")}
    check(not any(others.values()), f"mamba serve launched {others}")

    # the longest prompt's prefill again: kernels, then the plain route,
    # with the served bf16 activations and with f32 ones; the launch counts
    # show which route each re-run took
    probe_req = max(reqs, key=lambda r: len(r.prompt))
    toks = torch.tensor([probe_req.prompt], device="cuda")
    cfg32 = dataclasses.replace(cfg, dtype="float32")

    def prefill(c=cfg):
        return lm.apply(params, c, toks, mode="prefill",
                        caches=lm.cache_init(c, 1, scfg.max_len,
                                             device="cuda"))[0]

    n0 = launch_counts()
    kern = prefill()
    n1 = launch_counts()
    with plain_ssm_route():
        plain = prefill()
        plain32 = prefill(cfg32)
    n2 = launch_counts()
    kern32 = prefill(cfg32)
    ran = {k: (n1[k] - n0[k], n2[k] - n1[k]) for k in ("ssd", "dw1d")}
    check(all(r == (cfg.num_layers, 0) for r in ran.values()),
          f"mamba probe: kernel launches (kernel re-run, plain re-runs) "
          f"{ran}; expected ({cfg.num_layers}, 0) each")
    torch.cuda.synchronize()
    check(bool(torch.isfinite(kern).all() and torch.isfinite(kern32).all())
          and kern.shape == (1, len(probe_req.prompt), cfg.vocab_size),
          "mamba probe: logits malformed")
    lmax = float(plain32.abs().max())
    d32 = float((kern32 - plain32).abs().max())
    dmax = float((kern - plain).abs().max())
    err_k = float((kern - plain32).abs().max())
    err_p = float((plain - plain32).abs().max())
    first = int(kern[0, -1].argmax())
    print(f"mamba probe prefill ({len(probe_req.prompt)} tokens, "
          f"{-(-len(probe_req.prompt) // cfg.ssm.chunk)} chunks; max|logit| "
          f"of the f32 model {lmax:.3e}): f32 activations, kernels vs plain "
          f"route max|d| {d32:.3e} (rel {d32 / lmax:.3e}, tol "
          f"{TOL_SSM_F32:g}) | bf16 activations, kernels vs plain route "
          f"{dmax:.3e} (rel {dmax / lmax:.3e}); off the f32 model: kernels "
          f"{err_k:.3e} (rel {err_k / lmax:.3e}), plain route {err_p:.3e} "
          f"(rel {err_p / lmax:.3e}), gate kernels <= plain | argmax "
          f"{first}, served first token {probe_req.generated[0]}")
    check(d32 <= TOL_SSM_F32 * lmax, f"mamba probe: with f32 activations "
          f"the kernels' logits are off the plain route's: {d32} > "
          f"{TOL_SSM_F32} * {lmax}")
    check(err_k <= err_p, f"mamba probe: in bf16 the kernels' logits are "
          f"further from the f32 model ({err_k}) than the plain route's "
          f"({err_p})")
    check(first == probe_req.generated[0], "mamba probe: the re-run "
          "prefill's argmax is not the engine's first token")
    del kern, plain, kern32, plain32

    # where the time goes: the probe's prefill (kernels, then the plain
    # route) on the host clock, its device time traced; one batched decode
    # step of all slots likewise
    prefill_ms = _host_ms(torch, prefill)
    with plain_ssm_route():
        prefill_plain_ms = _host_ms(torch, prefill)
    pre_wall, pre_busy, pre_events, pre_marks, pre_top = profile_decode(
        torch, prefill, marks=SSD_STAGES + ("dw1d_kernel",))
    step_ms = eng.decode_seconds / eng.decode_steps * 1e3
    dec_wall, dec_busy, dec_events, _, dec_top = profile_decode(
        torch, lambda: eng.decode(eng.last_tokens, eng.lengths, eng.cache))
    print(f"mamba prefill ({len(probe_req.prompt)} tokens): {prefill_ms:.3f}"
          f" ms wall with the kernels, {prefill_plain_ms:.3f} ms on the plain"
          f" route | traced: device busy "
          + ("not measured (no device events)" if pre_busy is None else
             f"{pre_busy:.3f} ms in {pre_events:.0f} events, kernel 6 "
             f"{sum(pre_marks[k] for k in SSD_STAGES):.4f} ms ("
             + ", ".join(f"{k} {pre_marks[k]:.4f}" for k in SSD_STAGES)
             + f"), kernel 7 {pre_marks['dw1d_kernel']:.4f} ms | top: "
             + "; ".join(f"{n} {ms:.4f} ms" for n, ms in pre_top)))
    print(f"mamba decode step: {step_ms:.3f} ms host time a served step "
          f"(mean) | re-run {dec_wall:.3f} ms wall, device busy "
          + ("not measured" if dec_busy is None else
             f"{dec_busy:.3f} ms in {dec_events:.0f} events, idle share "
             f"{1.0 - dec_busy / dec_wall:.4f} | top: "
             + "; ".join(f"{n} {ms:.4f} ms" for n, ms in dec_top)))

    # a reduced model: the card's greedy tokens are the CPU engine's,
    # prompts of 1 and 2 tokens (shorter than the conv window) included
    small = get_config(SSM_ARCH).reduced()
    sp = lm.init(1, small, device="cpu")
    prompts = [r.prompt[:20] for r in reqs[:4]] + [[5], [9, 2]]
    toks_by = {}
    for dev in ("cpu", "cuda"):
        e = Engine(small, ServeConfig(max_batch=3, max_len=64),
                   params=lm.to_device(sp, dev), device=dev)
        rs = [Request(prompt=[t % small.vocab_size for t in p], max_new=6)
              for p in prompts]
        for r in rs:
            e.submit(r)
        e.run_until_done()
        toks_by[dev] = [r.generated for r in rs]
    check(toks_by["cpu"] == toks_by["cuda"], "reduced mamba2-2.7b: the "
          "card's greedy tokens differ from the CPU engine's")

    lat = eng.latency.percentiles_ms()
    return {"arch": SSM_ARCH, "completed": sum(r.done for r in reqs),
            "tokens": eng.tokens_generated, "decode_steps": eng.decode_steps,
            "prefills": prefills,
            "decode_tokens_per_s": eng.decode_tokens_per_s,
            "wall_tokens_per_s": eng.tokens_generated / wall,
            "wall_s": wall, "decode_s": eng.decode_seconds,
            "p50_ms": lat["p50"], "p99_ms": lat["p99"],
            "peak_mem_bytes": peak, "launches": counts, "init_s": init_s,
            "probe_tokens": len(probe_req.prompt), "probe_max_logit": lmax,
            "probe_f32_kernel_vs_plain": d32,
            "probe_bf16_kernel_vs_plain": dmax,
            "probe_bf16_kernel_vs_f32": err_k,
            "probe_bf16_plain_vs_f32": err_p, "prefill_ms": prefill_ms,
            "prefill_plain_ms": prefill_plain_ms,
            "prefill_device_busy_ms": pre_busy,
            "prefill_device_events": pre_events,
            "prefill_kernel_ms": pre_marks, "prefill_top": pre_top,
            "step_ms": step_ms, "decode_rerun_ms": dec_wall,
            "decode_device_busy_ms": dec_busy,
            "decode_device_events": dec_events, "decode_top": dec_top,
            "prompt_lengths": [len(r.prompt) for r in reqs]}


# ---------------------------------------------------------------------------
# phase 9: training
# ---------------------------------------------------------------------------
def _wgrad_excess(got, ref, rel_step):
    """(worst excess over 1e-4 * max|ref| (+ one bf16 step of |ref| where
    ``rel_step``), max|diff|, max|ref|)."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    scale = float(ref.abs().max())
    bound = TOL_WGRAD * scale
    if rel_step:
        bound = bound + BF16_STEP * ref.abs()
    return float((diff - bound).max()), float(diff.max()), scale


def phase_train_kernels(torch, np, geometries=TRAIN_DW1D_GEOMETRIES,
                        seed=9):
    """9a: kernel 7's backward at mamba2-2.7b's training shapes (or the
    given geometries): dx bit-equal to flip(kernel 7(flip(dy))), dw and db
    against the reference's formula; timed beside the plain versions, the
    autograd backward of the same depthwise ``F.conv1d`` and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.conv import winograd as wino
    rng = np.random.default_rng(seed)
    rows = {k: {"name": k, "geometries": [], "max_abs_err": 0.0}
            for k in ("dw1d_bwd", "dw1d_wgrad")}
    for B, L, C, dtype_name in geometries:
        dtype = getattr(torch, dtype_name)
        bf16 = dtype == torch.bfloat16

        def dev(a, dt=dtype):
            return torch.as_tensor(a, dtype=torch.float32,
                                   device="cuda").to(dt)
        x = dev(rng.standard_normal((B, L, C)))
        dy = dev(rng.standard_normal((B, L, C)))
        w = dev(rng.standard_normal((4, C)) * 0.1, torch.float32)
        zero = torch.zeros((C,), device="cuda")
        flip = wino.conv1d_depthwise_causal(dy.flip(1).contiguous(), w,
                                            zero).flip(1)
        dx = wino.conv1d_depthwise_causal_dx(dy, w)
        dw, db = wino.conv1d_depthwise_causal_wgrad(x, dy, 4)
        dw2, db2 = wino.conv1d_depthwise_causal_wgrad(x, dy, 4)
        torch.cuda.synchronize()
        check(dx.dtype == dtype and torch.equal(dx, flip),
              f"dw1d_bwd ({B},{L},{C}) {dtype_name}: dx is not bit-equal to "
              f"flip(kernel 7(flip(dy)))")
        check(torch.equal(dw, dw2) and torch.equal(db, db2),
              f"dw1d_wgrad ({B},{L},{C}) {dtype_name}: two runs differ")
        dx_plain = wino.conv1d_depthwise_causal_dx_plain(dy, w)
        pdw, pdb = wino.conv1d_depthwise_causal_wgrad_plain(x, dy, 4)
        ex_x, err_x, max_x = _excess(dx, dx_plain, bf16)
        ex_w, err_w, max_w = _wgrad_excess(dw, pdw, False)
        ex_b, err_b, max_b = _wgrad_excess(db, pdb, bf16)
        check(ex_x <= 0 and ex_w <= 0 and ex_b <= 0,
              f"kernel 7's backward ({B},{L},{C}) {dtype_name} disagrees "
              f"with its plain version: dx excess {ex_x}, dw {ex_w}, db "
              f"{ex_b}")

        # the library: the autograd backward of the same depthwise conv
        xt = x.transpose(1, 2).detach().requires_grad_(True)
        wl = w.T[:, None, :].to(dtype).detach().requires_grad_(True)
        bl = zero.to(dtype).requires_grad_(True)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yl = F.conv1d(xt, wl, bl, padding=3, groups=C)[..., :L]
        gy = dy.transpose(1, 2)

        def library():
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                return torch.autograd.grad(yl, (xt, wl, bl), gy,
                                           retain_graph=True)
        (ms_x, host_x), (ms_w, host_w) = (
            time_ms(torch, lambda: wino.conv1d_depthwise_causal_dx(dy, w)),
            time_ms(torch, lambda: wino.conv1d_depthwise_causal_wgrad(
                x, dy, 4)))
        (plain_x, _), (plain_w, _), (lib_ms, _) = (
            time_ms(torch, lambda: wino.conv1d_depthwise_causal_dx_plain(
                dy, w)),
            time_ms(torch, lambda: wino.conv1d_depthwise_causal_wgrad_plain(
                x, dy, 4)),
            time_ms(torch, library))
        for kname, kind, ms, host, plain_ms, err, scale in (
                ("dw1d_bwd", "dx", ms_x, host_x, plain_x, err_x, max_x),
                ("dw1d_wgrad", "wgrad", ms_w, host_w, plain_w,
                 max(err_w, err_b), max(max_w, max_b))):
            flops, nbytes = dw1d_bwd_work(B, L, C, x.element_size(), kind)
            bound, bound_by = _bound(flops, nbytes)
            print(f"kernel {kname} ({B},{L},{C}) {dtype_name}: "
                  + (f"bit-equal to flip(kernel 7(flip(dy))); vs plain "
                     f"{err_x:.3e} (max|plain| {max_x:.3e})" if kind == "dx"
                     else f"dw vs plain {err_w:.3e} (max|plain| "
                     f"{max_w:.3e}), db {err_b:.3e} (max|plain| "
                     f"{max_b:.3e}), two runs bit-equal")
                  + f" | kernel_ms {ms:.4f} (host enqueue {host:.4f} ms) "
                  f"plain_ms {plain_ms:.4f} library_ms(F.conv1d autograd "
                  f"backward: dx, dw, db) {lib_ms:.4f} bound_ms {bound:.4f} "
                  f"({bound_by}: {flops:.3e} flop, {nbytes:.3e} B)"
                  + (f" | tiles a block {wino.dw1d_launch(B, L, C)}"
                     if kind == "dx" else
                     f" | rows a block {wino.dw1d_wgrad_rows(B, L, C)}"))
            rows[kname]["geometries"].append({
                "B": B, "L": L, "C": C, "dtype": dtype_name,
                "max_abs_err": err, "max_abs_plain": scale, "ms": ms,
                "host_ms": host, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": bound, "bound_by": bound_by, "flop": flops,
                "bytes": nbytes})
            rows[kname]["max_abs_err"] = max(rows[kname]["max_abs_err"], err)
        del xt, wl, bl, yl
    for row in rows.values():
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"):
            row[key] = row["geometries"][0][key]
    return rows


def _train_batch(torch, np, vocab, B, S, seed):
    from repro_torch.data.pipeline import synthetic_batches
    b = next(synthetic_batches(batch=B, seq_len=S, vocab=vocab, seed=seed))
    return {k: torch.from_numpy(v).to("cuda") for k, v in b.items()}


def _loss_and_grads(torch, params, cfg, batch):
    from repro_torch.models import lm
    from repro_torch.nn.module import tree_leaves
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = lm.loss_fn(params, cfg, batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _train_report(hist, tokens):
    dts = sorted(h["dt"] for h in hist[1:])
    step_ms = dts[len(dts) // 2] * 1e3
    return {"steps": len(hist), "losses": [h["loss"] for h in hist],
            "grad_norms": [h["grad_norm"] for h in hist],
            "step_ms": step_ms, "first_step_ms": hist[0]["dt"] * 1e3,
            "tokens_per_s": tokens / step_ms * 1e3}


def held_batch_loss(torch, cfg, params, batch) -> float:
    """The cross entropy of ``params`` on ``batch``, no gradient."""
    from repro_torch.models import model_for
    with torch.no_grad():
        return float(model_for(cfg).loss_fn(params, cfg, batch)[1]["loss"])


def train_through_trainer(torch, np, card, cfg, shape, *, falls=True,
                          schedule=None):
    """``cfg`` (published widths, f32 params drawn on the card, bf16
    compute, remat) trained ``shape`` = (batch, seq, steps) through
    ``Trainer`` (``schedule``: its base_lr and warmup, else the
    trainer's): finite losses and grad norms (and router losses), the
    loss on the first step's batch lower after the run than before it,
    and the stream's loss falling when ``falls`` (each step's batch has
    patterns of its own, so that loss falls only over a long run); then
    one step traced.  The audio and vlm families' batches carry their
    frames or patches, as the trainer's stream makes them."""
    from repro_torch.data.pipeline import synthetic_batches
    from repro_torch.models import model_for
    from repro_torch.nn.module import count_params
    from repro_torch.runtime import Trainer, TrainerConfig
    B, S, steps = shape
    params = model_for(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    n_params = count_params(params)
    tcfg = TrainerConfig(steps=steps, batch=B, seq_len=S, log_every=1,
                         **(schedule or {}))
    # the trainer's step-keyed stream at step 0
    held = {k: torch.from_numpy(v).to("cuda") for k, v in next(
        synthetic_batches(batch=B, seq_len=S, vocab=cfg.vocab_size,
                          seed=tcfg.seed, steps=1, family=cfg.family,
                          d_model=cfg.d_model, num_patches=cfg.num_patches,
                          frames_len=min(S, 128))).items()}
    before = held_batch_loss(torch, cfg, params, held)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, tcfg, params=params, device="cuda")
    hist = tr.run()
    peak = torch.cuda.max_memory_allocated()
    check(len(hist) == steps and all(
        math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
        and math.isfinite(h["aux_loss"]) for h in hist),
        f"train {cfg.name}: a non-finite loss, router loss or grad norm: "
        f"{[(h['loss'], h['aux_loss'], h['grad_norm']) for h in hist]}")
    check(abs(before - hist[0]["loss"]) <= TOL_TRAIN_LOSS * abs(before),
          f"train {cfg.name}: the held batch's loss {before} is not step "
          f"0's {hist[0]['loss']}")
    after = held_batch_loss(torch, cfg, tr.state["params"], held)
    check(after < before, f"train {cfg.name}: the loss on step 0's batch "
          f"did not fall over {steps} steps ({before} -> {after})")
    check(not falls or hist[-1]["loss"] < hist[0]["loss"], f"train "
          f"{cfg.name}: the loss did not fall ({hist[0]['loss']} -> "
          f"{hist[-1]['loss']})")
    check(cfg.moe is None or all(h["aux_loss"] > 0 for h in hist),
          f"train {cfg.name}: no router loss in a step")
    rep = _train_report(hist, B * S)
    batch = next(tr.data)
    wall, busy, events, _, top = profile_decode(
        torch, lambda: tr.train_step(batch), steps=2, marks=())
    rep.update(arch=cfg.name, layers=cfg.num_layers, params=n_params,
               batch=B, seq_len=S, peak_mem_bytes=peak,
               extra_rows={k: list(v.shape[1:]) for k, v in held.items()
                           if k in ("frames", "patches")},
               held_loss_before=before, held_loss_after=after,
               aux_losses=[h["aux_loss"] for h in hist],
               traced_wall_ms=wall, device_busy_ms=busy,
               device_events=events, top=top,
               idle_share=None if busy is None else 1.0 - busy / wall)
    aux = ("" if cfg.moe is None else
           f" | router loss {hist[0]['aux_loss']:.5f} -> "
           f"{hist[-1]['aux_loss']:.5f}")
    print(f"train {cfg.name} (published widths, {cfg.num_layers} layers, "
          f"{n_params / 1e9:.3f} B params, batch {B} x {S}, remat, {steps} "
          f"steps): loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, "
          f"on step 0's batch {before:.4f} -> {after:.4f}, "
          f"grad norm {hist[0]['grad_norm']:.3f} -> "
          f"{hist[-1]['grad_norm']:.3f}{aux} | step {rep['step_ms']:.2f} ms "
          f"median (first {rep['first_step_ms']:.1f} ms), "
          f"{rep['tokens_per_s']:.1f} tokens/s | peak mem "
          f"{peak / 2 ** 30:.2f} GiB | traced step: {wall:.2f} ms wall, "
          + ("device busy not measured (no device events)" if busy is None
             else f"device busy {busy:.2f} ms in {events:.0f} events, idle "
             f"share {1.0 - busy / wall:.4f} | top: "
             + "; ".join(f"{n} {ms:.3f} ms" for n, ms in top))
          + f" | on {card}")
    del tr, params
    torch.cuda.empty_cache()
    return rep


def phase_train_smollm(torch, np, card):
    """9b: smollm-360m at published widths (f32 params, bf16 compute,
    remat) trained through ``Trainer`` on the card, then one step traced."""
    from repro_torch.configs import get_config
    return train_through_trainer(torch, np, card,
                                 get_config(TRAIN_DENSE_ARCH),
                                 TRAIN_DENSE_SHAPE)


def phase_train_moe(torch, np, card):
    """9e, 9f: the mixture-of-experts family through ``Trainer`` (its
    router loss in every step's loss): granite-moe-1b-a400m at published
    widths, and deepseek-v2-lite-16b's widths cut to its dense first layer
    and 3 MoE layers."""
    from repro_torch.configs import get_config
    granite = train_through_trainer(torch, np, card, get_config(MOE_ARCH),
                                    TRAIN_MOE_SHAPE, falls=False,
                                    schedule=TRAIN_MOE_SCHEDULE)
    cut = dataclasses.replace(get_config(MLA_ARCH),
                              num_layers=TRAIN_MLA_LAYERS)
    deepseek = train_through_trainer(torch, np, card, cut, TRAIN_MLA_SHAPE,
                                     falls=False,
                                     schedule=TRAIN_MOE_SCHEDULE)
    return {"granite": granite, "deepseek": deepseek}


def phase_train_mamba(torch, np, card):
    """9c: mamba2-2.7b at published widths: one loss and gradient on the
    kernel route against the plain route (no optimizer state), then
    ``Trainer`` steps with kernel 7 forward and backward counted on every
    layer of every step."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.runtime import Trainer, TrainerConfig
    cfg = get_config(SSM_ARCH)
    if TRAIN_SSM_LAYERS != cfg.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=TRAIN_SSM_LAYERS)
    B, S, steps = TRAIN_SSM_SHAPE
    L = cfg.num_layers
    want = {"dw1d": 2 * L, "dw1d_bwd": L, "dw1d_wgrad": L, "ssd": 0}
    params = lm.init(torch.Generator(device="cuda").manual_seed(1), cfg,
                     device="cuda")
    batch = _train_batch(torch, np, cfg.vocab_size, B, S, seed=3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def both_routes(c):
        """(loss, grads) on the kernel route and on the plain route, and
        the seconds of each."""
        out = []
        for plain in (False, True):
            t0 = time.perf_counter()
            with plain_ssm_route() if plain else contextlib.nullcontext():
                lg = _loss_and_grads(torch, params, c, batch)
                torch.cuda.synchronize()
            out.append((*lg, time.perf_counter() - t0))
        return out

    def worst_leaf(a, b):
        return max(float((x - y).abs().max()) / max(float(y.abs().max()),
                                                    1e-30)
                   for x, y in zip(a, b))

    def rel_norm(a, b):
        num = sum(float(((x - y).float() ** 2).sum()) for x, y in zip(a, b))
        den = sum(float((y.float() ** 2).sum()) for y in b)
        return math.sqrt(num / den)

    # f32 activations: the two routes are one function summed in other
    # orders; the trained bf16 activations: the plain route rounds inside
    # its Winograd conv, the kernels stay f32 inside, so the kernels'
    # gradients must be no further from the f32 ones than the plain route's
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    reset_launch_counts()
    (l32k, g32k, s32k), (l32p, g32p, s32p) = both_routes(cfg32)
    n = launch_counts()
    check(all(n[k] == v for k, v in want.items()),
          f"train {SSM_ARCH} probe: launches {n} on the kernel route, then "
          f"none on the plain route; expected {want}")
    rel32 = abs(float(l32k) - float(l32p)) / abs(float(l32p))
    worst32 = worst_leaf(g32k, g32p)
    del g32p
    (lk, gk, sk), (lp, gp, sp) = both_routes(cfg)
    rel16 = abs(float(lk) - float(lp)) / abs(float(lp))
    worst16 = worst_leaf(gk, gp)
    k_off, p_off = rel_norm(gk, g32k), rel_norm(gp, g32k)
    k_loss_off = abs(float(lk) - float(l32k)) / abs(float(l32k))
    p_loss_off = abs(float(lp) - float(l32k)) / abs(float(l32k))
    finite = all(bool(torch.isfinite(g).all()) for g in gk)
    probe_peak = torch.cuda.max_memory_allocated()
    del g32k, gk, gp
    print(f"train {SSM_ARCH} probe ({L} layers, batch {B} x {S}): f32 "
          f"activations, loss kernels {float(l32k):.6f} plain route "
          f"{float(l32p):.6f} (rel {rel32:.3e}, gate {TOL_TRAIN_LOSS:g}), "
          f"worst leaf gradient {worst32:.3e} of its max|g| (gate "
          f"{TOL_TRAIN_GRAD:g}) | bf16 activations, loss {float(lk):.6f} vs "
          f"{float(lp):.6f} (rel {rel16:.3e}; off the f32 loss: kernels "
          f"{k_loss_off:.3e} (gate {TOL_TRAIN_LOSS:g}), plain route "
          f"{p_loss_off:.3e}), worst leaf {worst16:.3e}; gradients off "
          f"the f32 kernel route's (relative norm): kernels {k_off:.3e}, "
          f"plain route {p_off:.3e} (gate kernels <= plain) | fwd+bwd ms "
          f"kernels / plain: f32 "
          f"{s32k * 1e3:.1f} / {s32p * 1e3:.1f}, bf16 {sk * 1e3:.1f} / "
          f"{sp * 1e3:.1f} | peak mem {probe_peak / 2 ** 30:.2f} GiB | "
          f"launches {n}")
    check(finite and math.isfinite(float(lk)),
          f"train {SSM_ARCH} probe: a non-finite loss or gradient")
    check(rel32 <= TOL_TRAIN_LOSS and worst32 <= TOL_TRAIN_GRAD
          and k_loss_off <= TOL_TRAIN_LOSS and k_off <= p_off,
          f"train {SSM_ARCH} probe: the kernel route is off the plain "
          f"route: f32 loss rel {rel32}, worst leaf {worst32}; bf16 loss "
          f"off f32 {k_loss_off} (the plain route's {p_loss_off}), "
          f"gradients {k_off} against the plain route's {p_off}")
    kern_s, plain_s = sk, sp
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    snaps = []
    tr = Trainer(cfg, TrainerConfig(steps=steps, batch=B, seq_len=S,
                                    log_every=1), params=params,
                 device="cuda",
                 failure_injector=lambda s: snaps.append(launch_counts())
                 and False)
    reset_launch_counts()
    hist = tr.run()
    snaps.append(launch_counts())
    peak = torch.cuda.max_memory_allocated()
    per_step = [{k: b[k] - a[k] for k in want}
                for a, b in zip(snaps, snaps[1:])]
    check(len(per_step) == steps and all(p == want for p in per_step),
          f"train {SSM_ARCH}: launches a step {per_step}, expected {want}")
    check(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
              for h in hist), f"train {SSM_ARCH}: a non-finite loss or grad "
          f"norm: {[(h['loss'], h['grad_norm']) for h in hist]}")
    rep = _train_report(hist, B * S)
    batch = next(tr.data)
    wall, busy, events, marks, top = profile_decode(
        torch, lambda: tr.train_step(batch), steps=1,
        marks=("dw1d_kernel", "dw1d_wgrad"))
    rep.update(traced_wall_ms=wall, device_busy_ms=busy,
               device_events=events, kernel7_ms=marks, top=top,
               idle_share=None if busy is None else 1.0 - busy / wall)
    rep.update(arch=SSM_ARCH, layers=L, batch=B, seq_len=S,
               peak_mem_bytes=peak, probe_peak_mem_bytes=probe_peak,
               probe_f32_loss_rel=rel32, probe_f32_worst_leaf_rel=worst32,
               probe_bf16_loss_rel=rel16, probe_bf16_worst_leaf_rel=worst16,
               probe_bf16_kernel_off_f32=k_off,
               probe_bf16_plain_off_f32=p_off,
               probe_bf16_kernel_loss_off_f32=k_loss_off,
               probe_bf16_plain_loss_off_f32=p_loss_off,
               probe_kernel_ms=kern_s * 1e3, probe_plain_ms=plain_s * 1e3,
               launches=snaps[-1], launches_per_step=per_step[0])
    print(f"train {SSM_ARCH} ({L} layers, published widths, batch {B} x "
          f"{S}, remat, {steps} steps): losses "
          + " ".join(f"{h['loss']:.4f}" for h in hist)
          + f" | grad norms " + " ".join(f"{h['grad_norm']:.3f}"
                                         for h in hist)
          + f" | step {rep['step_ms']:.1f} ms median (first "
          f"{rep['first_step_ms']:.1f} ms) | peak mem {peak / 2 ** 30:.2f} "
          f"GiB | launches a step {per_step[0]} | traced step: {wall:.1f} "
          f"ms wall, "
          + ("device busy not measured (no device events)" if busy is None
             else f"device busy {busy:.1f} ms in {events:.0f} events, idle "
             f"share {1.0 - busy / wall:.4f}, kernel 7 forward and dx "
             f"{marks['dw1d_kernel']:.3f} ms, wgrad "
             f"{marks['dw1d_wgrad']:.3f} ms | top: "
             + "; ".join(f"{n} {ms:.3f} ms" for n, ms in top))
          + f" | on {card}")
    del tr, params
    torch.cuda.empty_cache()
    return rep


def phase_train_recovery(torch, np, card):
    """9d: smollm-360m's widths at 4 layers, a failure injected at step
    15 with checkpoints every 10: one recovery that restored, and the
    final params those of an uninterrupted run (the test's bound)."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.nn.module import tree_leaves
    from repro_torch.runtime import Trainer, TrainerConfig
    cfg = dataclasses.replace(get_config(TRAIN_DENSE_ARCH), num_layers=4)
    params = lm.init(torch.Generator(device="cuda").manual_seed(2), cfg,
                     device="cuda")
    init = [t.clone() for t in tree_leaves(params)]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        tcfg = TrainerConfig(steps=20, batch=4, seq_len=128, ckpt_every=10,
                             ckpt_dir=d, log_every=0)
        fails = {15}
        tr = Trainer(cfg, tcfg, params=params, device="cuda",
                     failure_injector=lambda s: s in fails and
                     not fails.discard(s))
        tr.run()
        rec = tr.events.recoveries
    ref_params = lm.init(torch.Generator(device="cuda").manual_seed(2), cfg,
                         device="cuda")
    for t, a in zip(tree_leaves(ref_params), init):
        t.copy_(a)
    ref = Trainer(cfg, dataclasses.replace(tcfg, ckpt_every=0, ckpt_dir=""),
                  params=ref_params, device="cuda")
    ref.run()
    seconds = time.perf_counter() - t0
    worst = 0.0
    close = True
    with torch.no_grad():
        for a, b in zip(tree_leaves(tr.state["params"]),
                        tree_leaves(ref.state["params"])):
            diff = (a - b).abs()
            close &= bool((diff <= 1e-5 + 1e-4 * b.abs()).all())
            worst = max(worst, float(diff.max()))
    print(f"train recovery ({TRAIN_DENSE_ARCH} widths, 4 layers, 20 steps, "
          f"checkpoint every 10, failure at 15): recoveries {rec} | final "
          f"params vs uninterrupted: max|diff| {worst:.3e} (gate rtol 1e-4 "
          f"atol 1e-5) | {seconds:.1f} s | on {card}")
    check(len(rec) == 1 and rec[0]["restored"] and rec[0]["step"] == 15,
          f"train recovery: recoveries {rec}")
    check(int(tr.state["step"]) == 20 and close,
          f"train recovery: step {int(tr.state['step'])}, params off the "
          f"uninterrupted run by {worst}")
    return {"recoveries": rec, "max_abs_diff": worst, "seconds": seconds}


def phase_train(torch, np, card):
    """Phase 9: 9a-9g."""
    t0 = time.perf_counter()
    rows = phase_train_kernels(torch, np)
    dense = phase_train_smollm(torch, np, card)
    ssm = phase_train_mamba(torch, np, card)
    recovery = phase_train_recovery(torch, np, card)
    moe = phase_train_moe(torch, np, card)
    audio_vlm = phase_train_audio_vlm(torch, np, card)
    seconds = time.perf_counter() - t0
    print(f"train: phase 9 {seconds:.1f} s")
    return rows, {"dense": dense, "ssm": ssm, "recovery": recovery,
                  "moe": moe, "audio_vlm": audio_vlm, "phase_s": seconds}


# --- phase 14: the mesh on the card ------------------------------------------
MESH_DENSE_SHAPE = (8, 256, 3)        # smollm-360m: batch, seq, steps
MESH_SSM_SHAPE = (1, 512, 3)          # mamba2-2.7b's widths at 4 layers
MESH_SSM_LAYERS = 4
# the mesh trainer vs the meshless one: phase 9d's recovery bound
MESH_RTOL, MESH_ATOL = 1e-4, 1e-5
MESH_TIMED_PAIRS = 4      # (meshless, mesh, mesh, meshless) rounds timed


def _max_diff(torch, got, want):
    """(max|got - want| over the leaves, every leaf within the mesh
    bound)."""
    worst, close = 0.0, True
    with torch.no_grad():
        for a, b in zip(got, want, strict=True):
            d = (a.float() - b.float()).abs()
            worst = max(worst, float(d.max()))
            close &= bool((d <= MESH_ATOL + MESH_RTOL * b.float().abs())
                          .all())
    return worst, close


def mesh_train_pair(torch, np, card, mesh, cfg, shape, seed, want=None):
    """``cfg`` trained ``shape`` = (batch, seq, steps) from one set of
    params drawn on the card, first by the meshless ``Trainer``, then on
    ``mesh``: losses and params within the mesh bound, each run's peak
    memory above what was allocated before it (the mesh run's includes
    its placement's copy of the params, the meshless run's its clone of
    them), then, after one untimed step of each, 2 x MESH_TIMED_PAIRS
    more steps of each on one batch in turns (meshless, mesh, mesh,
    meshless, ...) for their median ms.  ``want``: kernel launches a step of the mesh
    run (counted from 0 over it).  Returns (the mesh trainer, numbers)."""
    from repro_torch.models import lm
    from repro_torch.nn.module import tree_leaves, tree_map
    from repro_torch.parallel import sharding as sh
    from repro_torch.runtime import Trainer, TrainerConfig
    B, S, steps = shape
    params = lm.init(torch.Generator(device="cuda").manual_seed(seed), cfg,
                     device="cuda")
    tcfg = TrainerConfig(steps=steps, batch=B, seq_len=S, log_every=1)

    def window():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    before = window()
    plain = Trainer(cfg, tcfg, params=tree_map(
        lambda t: t.detach().clone(), params), device="cuda")
    plain_hist = plain.run()
    torch.cuda.synchronize()
    plain_peak = torch.cuda.max_memory_allocated() - before

    before = window()
    reset_launch_counts()
    tr = Trainer(cfg, tcfg, mesh=mesh, params=params, device="cuda")
    del params
    hist = tr.run()
    torch.cuda.synchronize()
    n = launch_counts()
    peak = torch.cuda.max_memory_allocated() - before
    check(all(sh.is_dtensor(t) for t in tree_leaves(tr.state["params"])),
          f"mesh {cfg.name}: the mesh trainer's params are not DTensors")
    worst_loss = max(abs(a["loss"] - b["loss"])
                     for a, b in zip(hist, plain_hist))
    loss_close = all(abs(a["loss"] - b["loss"])
                     <= MESH_ATOL + MESH_RTOL * abs(b["loss"])
                     for a, b in zip(hist, plain_hist))
    got = [t.full_tensor() for t in tree_leaves(tr.state["params"])]
    ref = [t.detach() for t in tree_leaves(plain.state["params"])]
    worst, close = _max_diff(torch, got, ref)
    check(loss_close and close, f"mesh {cfg.name}: off the meshless "
          f"trainer: losses {worst_loss}, params {worst}")
    # the tensor-parallel layers at one rank: the meshless step's bits
    bits = worst_loss == 0 and all(torch.equal(a, b)
                                   for a, b in zip(got, ref))
    del got, ref
    check(bits, f"mesh {cfg.name}: the tensor-parallel step on one rank "
          f"is not bit-equal to the meshless step (params max|d| {worst})")
    # the step's time, the two trainers in turns on one batch
    batch = next(plain.data)
    for trainer in (plain, tr):          # the allocator settles
        trainer.train_step(batch)
    times = {"meshless": [], "mesh": []}
    for _ in range(MESH_TIMED_PAIRS):
        for kind in ("meshless", "mesh", "mesh", "meshless"):
            trainer = tr if kind == "mesh" else plain
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(batch)
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t0) * 1e3)
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    del plain
    torch.cuda.empty_cache()
    print(f"mesh {cfg.name} ({cfg.num_layers} layers, batch {B} x {S}, "
          f"{steps} steps) on the (1, 1) NCCL mesh through the "
          f"tensor-parallel layers vs meshless: bit-equal | losses "
          + " ".join(f"{h['loss']:.5f}" for h in hist)
          + f" (max|d| {worst_loss:.3e}), params max|d| {worst:.3e} (gate "
          f"rtol {MESH_RTOL:g} atol {MESH_ATOL:g}) | step in turns "
          f"{med['mesh']:.2f} ms vs {med['meshless']:.2f} ms (ratio "
          f"{med['mesh'] / med['meshless']:.4f}; medians of "
          f"{2 * MESH_TIMED_PAIRS}) | peak {peak / 2 ** 30:.3f} GiB vs "
          f"{plain_peak / 2 ** 30:.3f} GiB over the allocated | launches "
          f"{n} | on {card}")
    if want is not None:
        total = {k: v * steps for k, v in want.items()}
        check(all(n[k] == v for k, v in total.items()),
              f"mesh {cfg.name}: launches {n}, expected {total}")
    return tr, {
        "arch": cfg.name, "layers": cfg.num_layers, "batch": B,
        "seq_len": S, "steps": steps, "losses": [h["loss"] for h in hist],
        "meshless_losses": [h["loss"] for h in plain_hist],
        "max_abs_loss_diff": worst_loss, "max_abs_param_diff": worst,
        "bit_equal": bits, "tensor_parallel": True,
        "step_ms": med["mesh"], "meshless_step_ms": med["meshless"],
        "step_ms_turns": times, "run_step_ms": _train_report(
            hist, B * S)["step_ms"],
        "meshless_run_step_ms": _train_report(plain_hist, B * S)["step_ms"],
        "peak_over_bytes": peak, "meshless_peak_over_bytes": plain_peak,
        "launches": n}


def mesh_fsdp_step(torch, np, card, mesh, cfg, shape, seed, want=None):
    """14e: ``cfg``'s training step (``launch/specs.py::make_train_step``)
    with the state placed by ``state_shardings(..., fsdp=True)``: inside
    ``tensor_parallel_at_one`` (which the caller enters) the one-rank
    "data" axis splits the parameters and each layer gathers its leaves
    with one-rank NCCL collectives and reduce-scatters their gradients.
    Beside it the same step on ``state_shardings(..., fsdp=False)``
    (ZeRO-1 moments, the params whole) and the meshless step, from one
    set of params drawn on the card and the same batches: ``steps`` steps
    of each, bit-equal, each run's peak memory over what was allocated
    before it; then one untimed step of each and 2 x MESH_TIMED_PAIRS
    more in turns (meshless, zero1, fsdp, fsdp, zero1, meshless) on one
    batch for their median ms.  ``want``: kernel launches a step of the
    FSDP run.  Returns its numbers."""
    from repro_torch.launch import specs
    from repro_torch.models import lm
    from repro_torch.nn.module import tree_leaves, tree_map
    from repro_torch.optim import init_state
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import sharding as sh
    B, S, steps = shape
    params = lm.init(torch.Generator(device="cuda").manual_seed(seed), cfg,
                     device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    batches = [{k: torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                 device="cuda", dtype=torch.int32)
                for k in ("inputs", "targets")} for _ in range(steps)]
    states, runs = {}, ("meshless", "zero1", "fsdp")
    with sh.use_mesh_rules(mesh):
        for kind in runs[1:]:
            st = init_state(tree_map(lambda t: t.detach(), params))
            states[kind] = specs.place_state(st, specs.state_shardings(
                cfg, st, mesh, fsdp=kind == "fsdp"))
    states["meshless"] = init_state(params)
    del params
    split = sum(bool(sh.gathered_axes(p))
                for p in tree_leaves(states["fsdp"]["params"]))
    check(split > 0 and not any(sh.gathered_axes(p) for p in tree_leaves(
        states["zero1"]["params"])), f"mesh fsdp {cfg.name}: {split} "
        "leaves split over 'data' under fsdp=True")
    step = {"meshless": specs.make_train_step(cfg),
            **{k: specs.make_train_step(cfg, mesh=mesh) for k in runs[1:]}}
    gathers = [0]
    real = coll.gather_many

    def counting(xs, dims, share):
        gathers[0] += 1
        return real(xs, dims, share)

    losses, peaks = {}, {}
    coll.gather_many = counting
    try:
        for kind in runs:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            if kind == "fsdp":
                reset_launch_counts()
                gathers[0] = 0
            losses[kind] = [float(step[kind](states[kind], b)["loss"])
                            for b in batches]
            torch.cuda.synchronize()
            peaks[kind] = torch.cuda.max_memory_allocated() - before
            if kind == "fsdp":
                n, per_step = launch_counts(), gathers[0] / steps
    finally:
        coll.gather_many = real
    bits = all(losses[k] == losses["meshless"] for k in runs[1:]) and all(
        torch.equal(sh.full(a), b)
        for k in runs[1:] for part in ("params", "m", "v")
        for a, b in zip(tree_leaves(states[k][part]),
                        tree_leaves(states["meshless"][part]), strict=True))
    check(bits, f"mesh fsdp {cfg.name}: the one-rank FSDP or ZeRO-1 step "
          f"is not bit-equal to the meshless step (losses {losses})")
    check(per_step >= cfg.num_layers, f"mesh fsdp {cfg.name}: {per_step} "
          f"per-layer gathers a step, {cfg.num_layers} layers")
    for kind in runs:                     # the allocator settles
        step[kind](states[kind], batches[0])
    times = {k: [] for k in runs}
    for _ in range(MESH_TIMED_PAIRS):
        for kind in runs + runs[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step[kind](states[kind], batches[0])
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t0) * 1e3)
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    del states
    torch.cuda.empty_cache()
    gib = {k: v / 2 ** 30 for k, v in peaks.items()}
    print(f"mesh fsdp {cfg.name} ({cfg.num_layers} layers, batch {B} x {S}, "
          f"{steps} steps) on the (1, 1) NCCL mesh, the state placed by "
          f"state_shardings(fsdp=True) ({split} leaves split over 'data', "
          f"{per_step:g} per-layer gathers a step with one-rank "
          f"collectives) and by fsdp=False (ZeRO-1) vs meshless: bit-equal "
          f"| losses " + " ".join(f"{x:.5f}" for x in losses["fsdp"])
          + f" | step in turns fsdp {med['fsdp']:.2f} ms, zero1 "
          f"{med['zero1']:.2f} ms, meshless {med['meshless']:.2f} ms "
          f"(ratios {med['fsdp'] / med['meshless']:.4f} and "
          f"{med['zero1'] / med['meshless']:.4f}; medians of "
          f"{2 * MESH_TIMED_PAIRS}) | peak over the allocated fsdp "
          f"{gib['fsdp']:.3f} GiB, zero1 {gib['zero1']:.3f} GiB, meshless "
          f"{gib['meshless']:.3f} GiB | launches {n} | on {card}")
    if want is not None:
        total = {k: v * steps for k, v in want.items()}
        check(all(n[k] == v for k, v in total.items()),
              f"mesh fsdp {cfg.name}: launches {n}, expected {total}")
    return {"arch": cfg.name, "layers": cfg.num_layers, "batch": B,
            "seq_len": S, "steps": steps, "losses": losses,
            "bit_equal": bits, "split_leaves": split,
            "gathers_per_step": per_step, "step_ms": med,
            "step_ms_turns": times, "peak_over_bytes": peaks,
            "launches": n}


def mesh_reshard(torch, np, card, mesh, tr):
    """14b: the mesh trainer's state resharded onto the same mesh and one
    more step, against the trainer continuing; then its params saved
    and restored with ``shardings=``."""
    import tempfile

    from repro_torch import checkpoint as ckpt
    from repro_torch.nn.module import tree_leaves, tree_map
    from repro_torch.parallel import sharding as sh
    from repro_torch.runtime import Trainer, reshard_state
    t0 = time.perf_counter()
    st = reshard_state(tr.state, mesh)
    step = int(tr.state["step"])
    tcfg = dataclasses.replace(tr.tcfg, steps=step + 1)
    again = Trainer(tr.cfg, tcfg, mesh=mesh,
                    params=tree_map(sh.full, st["params"]), device="cuda")
    again.state = st
    tr.tcfg, tr.data = tcfg, None        # its stream realigned to `step`
    tr.run()
    again.run()
    check(int(tr.state["step"]) == int(again.state["step"]) == step + 1,
          f"mesh reshard: steps {int(tr.state['step'])} and "
          f"{int(again.state['step'])}, expected {step + 1}")
    worst, close = _max_diff(
        torch, [t.full_tensor() for t in tree_leaves(again.state["params"])],
        [t.full_tensor() for t in tree_leaves(tr.state["params"])])
    del again, st
    state = {"step": tr.state["step"], "params": tr.state["params"]}
    with tempfile.TemporaryDirectory() as d:
        t1 = time.perf_counter()
        ckpt.save(d, state)
        t2 = time.perf_counter()
        with sh.use_mesh_rules(mesh):
            shard = sh.param_shardings(state["params"], mesh)
        got = ckpt.restore(d, tree_map(lambda t: torch.empty(0), state),
                           shardings={"params": shard})
        t3 = time.perf_counter()
    bits = all(torch.equal(a.to_local(), b.to_local()) and
               a.placements == b.placements == s.placements
               for a, b, s in zip(tree_leaves(got["params"]),
                                  tree_leaves(state["params"]),
                                  tree_leaves(shard)))
    nbytes = sum(t.to_local().numel() * t.to_local().element_size()
                 for t in tree_leaves(state["params"]))
    del got
    print(f"mesh reshard {tr.cfg.name}: resharded onto the (1, 1) mesh + 1 "
          f"step vs continuing: params max|d| {worst:.3e} | save "
          f"{(t2 - t1) * 1e3:.0f} ms, restore(shardings=) "
          f"{(t3 - t2) * 1e3:.0f} ms of {nbytes / 2 ** 30:.2f} GiB params, "
          f"bits and placements {'equal' if bits else 'DIFFER'} | "
          f"{time.perf_counter() - t0:.1f} s | on {card}")
    check(close, f"mesh reshard: off continuing by {worst}")
    check(bits, "mesh reshard: restore(shardings=) changed bits or "
          "placements")
    return {"max_abs_param_diff": worst, "save_ms": (t2 - t1) * 1e3,
            "restore_ms": (t3 - t2) * 1e3, "param_bytes": nbytes}


def mesh_serve(torch, np, card):
    """14c: f32 AlexNet through ``CnnEngine(data_parallel=True)`` over the
    card's one-device data mesh, against ``data_parallel=False``: both
    engines warmed, then served the same requests in turns (single, data
    parallel, data parallel, single), each round's launches counted from
    0 over it."""
    from repro_torch.configs import get_config
    from repro_torch.models import alexnet
    from repro_torch.serving import CnnEngine, CnnServeConfig, ImageRequest
    cfg = dataclasses.replace(get_config("alexnet"), use_pallas=True)
    params = alexnet.init(0, cfg, device="cuda")
    rng = np.random.default_rng(14)
    images = rng.standard_normal((sum(ARRIVALS), cfg.image_size,
                                  cfg.image_size, cfg.in_channels)
                                 ).astype(np.float32)
    engines = {}
    for dp in (False, True):
        engines[dp] = CnnEngine(cfg, CnnServeConfig(max_batch=BATCH,
                                                    data_parallel=dp),
                                params=params, device="cuda")
        warm_buckets(engines[dp], lambda n: [ImageRequest(image=im)
                                             for im in images[:n]])
    per = conv_launches_per_forward(cfg)
    rounds = []
    for dp in (False, True, True, False):
        eng = engines[dp]
        eng.reset_metrics()
        reqs = [ImageRequest(image=im) for im in images]
        reset_launch_counts()
        i = 0
        for size in ARRIVALS:
            for r in reqs[i:i + size]:
                eng.submit(r)
            i += size
            eng.step()
        eng.run_until_done()
        torch.cuda.synchronize()
        counts = launch_counts()
        s = eng.stats()
        check(all(r.done for r in reqs) and s["accounting"]["balanced"],
              f"mesh serve (data_parallel={dp}): {s['accounting']}")
        check(all(counts[k] == n * s["batches_run"] for k, n in per.items()),
              f"mesh serve (data_parallel={dp}): launches {counts} for "
              f"{s['batches_run']} batches, {per} a forward")
        rounds.append({"data_parallel": dp, "imgs_per_s": s["imgs_per_s"],
                       "launches": counts, "batches": s["batches_run"],
                       "logits": np.stack([r.logits for r in reqs])})
    equal = all(np.array_equal(r["logits"], rounds[0]["logits"])
                for r in rounds)
    dp_rounds = [r for r in rounds if r["data_parallel"]]
    single = [r for r in rounds if not r["data_parallel"]]
    devices = [str(d) for d in engines[True].devices]
    print(f"mesh serve alexnet f32 (data_parallel over {devices}): "
          f"{sum(ARRIVALS)} requests in groups {ARRIVALS}, logits "
          f"{'bit-equal' if equal else 'DIFFER'} to data_parallel=False | "
          f"img/s in turns single / dp / dp / single: "
          + " / ".join(f"{r['imgs_per_s']:.2f}" for r in rounds)
          + f" | launches a dp round {dp_rounds[0]['launches']} | on {card}")
    check(equal, "mesh serve: data-parallel logits differ from "
          "data_parallel=False")
    return {"devices": devices,
            "imgs_per_s_turns": [r["imgs_per_s"] for r in rounds],
            "data_parallel": {k: dp_rounds[0][k] for k in ("launches",
                                                           "batches")},
            "single": {k: single[0][k] for k in ("launches", "batches")}}


def mesh_collectives(torch, card, mesh):
    """14d: the reference's n = 1 path of the compressed collectives."""
    from repro_torch.parallel.collectives import (bfp_psum,
                                                  make_compressed_grad_sync)
    gen = torch.Generator(device="cuda").manual_seed(14)
    x = torch.randn(4096, device="cuda", generator=gen)
    y = bfp_psum(x, mesh.get_group("data"))
    grads = {"big": x.reshape(64, 64), "small": x[:100].clone()}
    synced = make_compressed_grad_sync(mesh)(grads)
    same = torch.equal(y, x) and all(torch.equal(synced[k], grads[k])
                                     for k in grads)
    print(f"mesh collectives on the one-rank NCCL group: bfp_psum and "
          f"make_compressed_grad_sync return their input: "
          f"{'yes' if same else 'NO'} | on {card}")
    check(same, "mesh collectives: a one-rank sum changed its input")
    return {"identity": same}


def phase_mesh(torch, np, card):
    """Phase 14: 14a-14e on one NCCL rank; the two mesh trainers run the
    tensor-parallel layers on their one-rank ``model`` axis
    (``sharding.tensor_parallel_at_one``), bit-equal to the meshless
    trainer, and so do the two FSDP-placed steps (14e), which gather
    their parameters per layer over the one-rank "data" axis."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_process_group, make_mesh
    from repro_torch.parallel.sharding import tensor_parallel_at_one
    t0 = time.perf_counter()
    init_process_group("cuda", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        check(mesh.device_type == "cuda" and dist.get_backend() == "nccl",
              f"mesh: a {mesh.device_type} mesh on {dist.get_backend()}")
        with tensor_parallel_at_one():
            dense, dense_rep = mesh_train_pair(
                torch, np, card, mesh, get_config(TRAIN_DENSE_ARCH),
                MESH_DENSE_SHAPE, seed=14)
        reshard = mesh_reshard(torch, np, card, mesh, dense)
        del dense
        torch.cuda.empty_cache()
        cut = dataclasses.replace(get_config(SSM_ARCH),
                                  num_layers=MESH_SSM_LAYERS)
        L = MESH_SSM_LAYERS
        with tensor_parallel_at_one():
            ssm, ssm_rep = mesh_train_pair(
                torch, np, card, mesh, cut, MESH_SSM_SHAPE, seed=15,
                want={"dw1d": 2 * L, "dw1d_bwd": L, "dw1d_wgrad": L,
                      "ssd": 0})
        del ssm
        torch.cuda.empty_cache()
        # 14e: the per-layer gather under --fsdp placements at one rank
        with tensor_parallel_at_one():
            fsdp_dense = mesh_fsdp_step(
                torch, np, card, mesh, get_config(TRAIN_DENSE_ARCH),
                MESH_DENSE_SHAPE, seed=16)
            torch.cuda.empty_cache()
            fsdp_ssm = mesh_fsdp_step(
                torch, np, card, mesh, cut, MESH_SSM_SHAPE, seed=17,
                want={"dw1d": 2 * L, "dw1d_bwd": L, "dw1d_wgrad": L,
                      "ssd": 0})
        torch.cuda.empty_cache()
        serve = mesh_serve(torch, np, card)
        coll = mesh_collectives(torch, card, mesh)
    finally:
        dist.destroy_process_group()
    seconds = time.perf_counter() - t0
    print(f"mesh: phase 14 {seconds:.1f} s")
    return {"dense": dense_rep, "ssm": ssm_rep, "reshard": reshard,
            "fsdp_dense": fsdp_dense, "fsdp_ssm": fsdp_ssm,
            "serve": serve, "collectives": coll, "phase_s": seconds,
            "launches": ssm_rep["launches"]}


# --- phase 16: tensor-parallel compute over "model" ------------------------
# kernel 5's lse mode at the decode_32k block shapes of a 16-way cache_seq
# split, (name, B, block rows, KV, D, H), the slots' lengths over the
# 32,768-row cache (the blocks past a slot's length empty)
TP_BLOCKS = 16
TP_DECODE = (("smollm-360m decode_32k", 8, 2048, 5, 64, 15),
             ("llama3.2-3b decode_32k", 8, 2048, 8, 128, 24))
TP_LENGTHS = (1, 700, 2048, 2049, 9000, 16384, 30001, 32768)
# a block's lse against the plain version's: <= TOL_LSE * (1 + |plain|)
TOL_LSE = 1e-4
# kernels 6 and 7 at a 16-way split of mamba2-2.7b (80 / 16 = 5 heads,
# 5,120 / 16 = 320 channels) and jamba-v0.1-52b (128 / 16 = 8 heads, 8,192
# / 16 = 512 channels), as phase 7 runs them whole; kernel 7's backward at
# 320 channels
TP_SSD_GEOMETRIES = (
    ("mamba2-2.7b / 16", 1, 200, 5, 64, 1, 128, 256, "bfloat16"),
    ("mamba2-2.7b / 16 8 chunks", 1, 2048, 5, 64, 1, 128, 256, "bfloat16"),
    ("jamba-v0.1-52b / 16", 1, 200, 8, 64, 1, 16, 256, "bfloat16"),
    ("jamba-v0.1-52b / 16 8 chunks", 1, 2048, 8, 64, 1, 16, 256,
     "bfloat16"))
TP_DW1D_GEOMETRIES = (("mamba2-2.7b / 16", 1, 200, 320, "bfloat16"),
                      ("mamba2-2.7b / 16 long", 1, 2048, 320, "bfloat16"),
                      ("jamba-v0.1-52b / 16", 1, 200, 512, "bfloat16"),
                      ("jamba-v0.1-52b / 16 long", 1, 2048, 512,
                       "bfloat16"))
TP_TRAIN_DW1D_GEOMETRIES = ((1, 512, 320, "bfloat16"),
                            (1, 2048, 320, "bfloat16"),
                            (1, 512, 320, "float32"))


def tp_decode_case(torch, dec, merge_blocks, q, kb, vb, lens):
    """Kernel 5's lse mode over each block of a cache split along rows:
    (the blocks' outputs, lses, merged output, empty (slot, block) pairs,
    whether each block's output is bit-equal to the mode without lse
    where it has valid rows, 0 and -inf where not)."""
    Lb = kb[0].shape[1]
    outs, lses, empty, bits = [], [], 0, True
    for r, (k, v) in enumerate(zip(kb, vb)):
        ln = (lens - r * Lb).clamp(0, Lb)
        o, lse = dec.decode_attention(q, k, v, ln, return_lse=True)
        plain = dec.decode_attention(q, k, v, ln)
        full = ln > 0
        empty += int((~full).sum())
        bits &= torch.equal(o[full].view(torch.int8),
                            plain[full].view(torch.int8))
        bits &= bool((o[~full] == 0).all()) and bool(
            torch.isneginf(lse[~full]).all())
        outs.append(o)
        lses.append(lse)
    mo, mlse = merge_blocks(torch.stack(outs), torch.stack(lses))
    return outs, lses, mo, mlse, empty, bits


def phase_tp_decode(torch, np):
    """16a: kernel 5's lse mode at smollm-360m's and llama3.2-3b's
    decode_32k block shapes (16 blocks of 2,048 rows of a 32,768-row
    cache, lengths leaving whole blocks empty): each block against the
    plain version's lse mode and bit-equal to the mode without lse where
    it has rows; the blocks merged by ``merge_blocks`` (the layer's merge)
    against the whole-cache kernel and the whole cache's plain version, in
    f32 and bf16; timed in bf16 on block 0 beside the mode without lse,
    its bound, the plain version and SDPA, and the merge."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attn import decode_attn as dec
    from repro_torch.kernels.decode_attn.ref import (decode_attention_ref,
                                                      merge_blocks)
    rng = np.random.default_rng(16)
    row = {"name": "decode_attn lse", "geometries": [], "max_abs_err": 0.0}
    for name, B, Lb, KV, D, H in TP_DECODE:
        lens = torch.tensor(TP_LENGTHS[:B], dtype=torch.int32,
                            device="cuda")
        shapes = [(B, 1, H, D)] + [(B, Lb, KV, D)] * (2 * TP_BLOCKS)
        base = [torch.as_tensor(rng.standard_normal(s), dtype=torch.float32,
                                device="cuda") for s in shapes]
        geo = {"arch": name, "B": B, "block_rows": Lb, "blocks": TP_BLOCKS,
               "H": H, "KV": KV, "D": D, "lengths": lens.tolist()}
        for dtype_name in ("float32", "bfloat16"):
            dt = getattr(torch, dtype_name)
            q = base[0].to(dt)
            kb = [t.to(dt) for t in base[1:1 + TP_BLOCKS]]
            vb = [t.to(dt) for t in base[1 + TP_BLOCKS:]]
            k, v = torch.cat(kb, 1), torch.cat(vb, 1)
            whole = dec.decode_attention(q, k, v, lens)
            plain, plain_lse = decode_attention_ref(q, k, v, lens,
                                                    return_lse=True)
            outs, lses, mo, mlse, empty, bits = tp_decode_case(
                torch, dec, merge_blocks, q, kb, vb, lens)
            torch.cuda.synchronize()
            tol = TOL_DECODE[dtype_name]
            worst_blk = worst_lse = 0.0
            for r, (o, lse) in enumerate(zip(outs, lses)):
                ln = (lens - r * Lb).clamp(0, Lb)
                po, pl = decode_attention_ref(q, kb[r], vb[r], ln,
                                              return_lse=True)
                d = (o.float() - po.float()).abs()
                worst_blk = max(worst_blk, float(
                    (d - tol * po.float().abs()).max()))
                fin = torch.isfinite(pl)
                check(bool((torch.isfinite(lse) == fin).all()),
                      f"tp decode {name} {dtype_name} block {r}: lse "
                      f"-inf where the plain version's is not")
                worst_lse = max(worst_lse, float(
                    ((lse[fin] - pl[fin]).abs()
                     - TOL_LSE * (1 + pl[fin].abs())).max())
                    if fin.any() else -1.0)
            errs = {}
            for tag, want in (("whole_kernel", whole), ("plain", plain)):
                d = (mo.float() - want.float()).abs()
                errs[tag] = (float(d.max()), float(
                    (d - tol * want.float().abs()).max()))
            lse_err = float((mlse - plain_lse).abs().max())
            print(f"tp decode {name} {dtype_name}: q {tuple(q.shape)} "
                  f"{TP_BLOCKS} blocks of {tuple(kb[0].shape)}, lengths "
                  f"{lens.tolist()} ({empty} empty (slot, block) pairs) | "
                  f"each block vs plain lse mode: worst excess {worst_blk:.3e}"
                  f" (gate rtol = atol = {tol:g}), lse worst excess "
                  f"{worst_lse:.3e} (gate {TOL_LSE:g} (1 + |lse|)), bit-equal"
                  f" to the mode without lse where it has rows, 0 and -inf "
                  f"where not: {'yes' if bits else 'NO'} | merged vs the "
                  f"whole-cache kernel max|d| {errs['whole_kernel'][0]:.3e} "
                  f"vs the whole cache's plain version "
                  f"{errs['plain'][0]:.3e} (gate rtol = atol = {tol:g}), "
                  f"merged lse vs plain {lse_err:.3e}")
            check(empty > 0, f"tp decode {name}: no empty block")
            check(bits, f"tp decode {name} {dtype_name}: the lse mode's "
                  f"output differs from the mode without it")
            check(worst_blk <= tol and worst_lse <= 0,
                  f"tp decode {name} {dtype_name}: a block disagrees with "
                  f"the plain lse mode (excess {worst_blk}, lse {worst_lse})")
            check(all(ex <= tol for _, ex in errs.values()),
                  f"tp decode {name} {dtype_name}: merged blocks disagree "
                  f"with the whole cache: {errs}")
            geo[f"max_abs_err_{dtype_name}"] = max(e for e, _ in
                                                   errs.values())
            geo[f"lse_err_{dtype_name}"] = lse_err
            row["max_abs_err"] = max(row["max_abs_err"],
                                     geo[f"max_abs_err_{dtype_name}"])
        # timed in bf16 on block 0 (every slot has rows there)
        q0, k0, v0 = q, kb[0], vb[0]
        ln0 = lens.clamp(0, Lb)
        mask = (torch.arange(Lb, device="cuda")[None, :]
                < ln0[:, None])[:, None, None, :]
        qt, kt, vt = (t.transpose(1, 2) for t in (q0, k0, v0))
        stacked = (torch.stack(outs), torch.stack(lses))
        (ms, host_ms), (nolse_ms, _), (plain_ms, _), (lib_ms, _), \
            (merge_ms, _), (whole_ms, _) = (
                time_ms(torch, lambda: dec.decode_attention(
                    q0, k0, v0, ln0, return_lse=True)),
                time_ms(torch, lambda: dec.decode_attention(q0, k0, v0,
                                                            ln0)),
                time_ms(torch, lambda: decode_attention_ref(
                    q0, k0, v0, ln0, return_lse=True)),
                time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)),
                time_ms(torch, lambda: merge_blocks(*stacked)),
                time_ms(torch, lambda: dec.decode_attention(q, k, v, lens)))
        valid = int(ln0.sum())
        flops, nbytes = decode_work(B, H, KV, D, valid, 2)
        nbytes += 4 * B * H                     # the lse written
        bound, bound_by = _bound(flops, nbytes, "bfloat16")
        print(f"tp decode {name} bfloat16 block 0 ({valid} valid rows): "
              f"kernel_ms (lse) {ms:.4f} (host enqueue {host_ms:.4f} ms) "
              f"vs without lse {nolse_ms:.4f} | plain_ms {plain_ms:.4f} "
              f"library_ms(SDPA, enable_gqa, length mask; no lse) "
              f"{lib_ms:.4f} bound_ms {bound:.4f} ({bound_by}: "
              f"{flops:.3e} flop, {nbytes:.3e} B) | merge of "
              f"{TP_BLOCKS} blocks {merge_ms:.4f} ms | the whole "
              f"{TP_BLOCKS * Lb}-row cache in one launch {whole_ms:.4f} ms")
        geo.update(ms=ms, host_ms=host_ms, nolse_ms=nolse_ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                   bound_by=bound_by, flop=flops, bytes=nbytes,
                   merge_ms=merge_ms, whole_cache_ms=whole_ms)
        row["geometries"].append(geo)
        del base, kb, vb, k, v
        torch.cuda.empty_cache()
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"):
        row[key] = row["geometries"][0][key]
    return row


def phase_tp(torch, np):
    """Phase 16: kernel 5's lse mode (16a) and kernels 6 and 7, kernel 7's
    backward too, at the local shapes of a 16-way ``model`` split (16b;
    phase 7's and 9a's checks at those geometries).  The one-rank
    tensor-parallel step is phase 14's."""
    t0 = time.perf_counter()
    out = {"decode_attn": phase_tp_decode(torch, np)}
    out.update(phase_ssm(torch, np, TP_SSD_GEOMETRIES, TP_DW1D_GEOMETRIES,
                         seed=161))
    out.update(phase_train_kernels(torch, np, TP_TRAIN_DW1D_GEOMETRIES,
                                   seed=162))
    seconds = time.perf_counter() - t0
    print(f"tp: phase 16 {seconds:.1f} s")
    return out, seconds


# --- phase 10: mixture-of-experts and MLA serving ---------------------------
@contextlib.contextmanager
def plain_decode_attention():
    """GQA decode on kernel 5's plain version while inside."""
    from repro_torch.kernels.decode_attn import ops as dec_ops
    from repro_torch.nn import flash
    real = flash.decode_attention
    flash.decode_attention = functools.partial(dec_ops.decode_attention,
                                               pallas=False)
    try:
        yield
    finally:
        flash.decode_attention = real


@contextlib.contextmanager
def materialised_mla():
    """MLA decode with per-head K and V at cache length while inside."""
    from repro_torch.nn import attention
    real = attention.mla_decode
    attention.mla_decode = attention.mla_decode_materialised
    try:
        yield
    finally:
        attention.mla_decode = real


@contextlib.contextmanager
def recorded_routing(store):
    """Every MoE layer's routed expert indices appended to ``store``."""
    from repro_torch.nn import moe
    real = moe.route

    def route(p, cfg, xg):
        out = real(p, cfg, xg)
        store.append(out[2])
        return out
    moe.route = route
    try:
        yield
    finally:
        moe.route = real


def _snapshot_at(step, probe):
    """A ``before_decode`` hook: copies of what decode step ``step`` reads,
    and each active slot's request with its count of generated tokens."""
    def hook(e):
        if e.decode_steps == step:
            probe.update(tokens=e.last_tokens.clone(),
                         lengths=e.lengths.copy(), mask=e.active.copy(),
                         cache=_copy_cache(e.cache),
                         slots={int(s): (e.slot_req[s],
                                         len(e.slot_req[s].generated))
                                for s in e.active.nonzero()[0]})
    return hook


def serve_lm_full(torch, np, cfg, params, n_req, max_new, rng, label, *,
                  scfg=None, reqs=None, keep=None, tag="moe"):
    """Serve ``n_req`` requests of MOE_PROMPTS prompt tokens and
    ``max_new`` new ones (or ``reqs``) through ``Engine(max_batch=8,
    max_len=512, prefill_bucket=64)`` (or ``scfg``) after a warm-up; the
    launch counts of the run, its numbers, and one decode step (step
    ``max_new // 2``, on a copy of its cache) traced as ``phase_lm``
    traces smollm-360m's; ``keep`` receives that step's snapshot.  A MoE
    model's run must pad a MoE group in some prefill where a prefill is
    longer than one group."""
    from repro_torch.serving import Engine, ServeConfig
    if scfg is None:
        scfg = ServeConfig(max_batch=BATCH, max_len=512, prefill_bucket=64)
    warm = Engine(cfg, scfg, params=params, device=DEVICE)
    for r in _requests(rng, cfg.vocab_size, 2, 8, 70, 2):
        warm.submit(r)
    warm.run_until_done()
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, scfg, params=params, device=DEVICE)
    if reqs is None:
        reqs = _requests(rng, cfg.vocab_size, n_req, *MOE_PROMPTS, max_new)
    probe = {}
    reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run_until_done(before_decode=_snapshot_at(max_new // 2, probe))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(all(r.done and len(r.generated) == max_new for r in reqs),
          f"{label} serve: {sum(r.done for r in reqs)}/{len(reqs)} done, "
          f"tokens {sorted({len(r.generated) for r in reqs})}")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated),
          f"{label} serve: a token outside the vocabulary")
    check(bool(probe), f"{label}: the run ended before decode step "
          f"{max_new // 2}")
    # prefills whose padded length is no multiple of the MoE's group: their
    # last group holds zero rows, routed like tokens (the pad-row ties)
    lens = [eng._pad_len(len(r.prompt)) for r in reqs]
    group = cfg.moe.group_size if cfg.moe is not None else max(lens)
    padded = sum(n > group and n % group > 0 for n in lens)
    check(max(lens) <= group or padded > 0, f"{label}: no prefill padded "
          "a MoE group")
    steps = eng.decode_steps
    step_ms = eng.decode_seconds / steps * 1e3
    probe_ms, busy_ms, events, marks, top = profile_decode(
        torch, lambda: eng.decode(probe["tokens"], probe["lengths"],
                                  probe["cache"]))
    idle = None if busy_ms is None else 1.0 - busy_ms / probe_ms
    lat = eng.latency.percentiles_ms()
    out = {"arch": cfg.name, "param_dtype": cfg.param_dtype,
           "dtype": cfg.dtype, "requests": n_req, "max_len": scfg.max_len,
           "completed": sum(r.done for r in reqs),
           "tokens": eng.tokens_generated, "decode_steps": steps,
           "decode_tokens_per_s": eng.decode_tokens_per_s,
           "wall_tokens_per_s": eng.tokens_generated / wall, "wall_s": wall,
           "p50_ms": lat["p50"], "p99_ms": lat["p99"],
           "peak_mem_bytes": peak, "launches": counts, "step_ms": step_ms,
           "probe_step_ms": probe_ms, "device_busy_ms_per_step": busy_ms,
           "device_events_per_step": events, "device_idle_share": idle,
           "kernel5_ms_per_step": None if marks is None
           else marks["decode_attn"], "top_device_ops": top,
           "prompt_lengths": [len(r.prompt) for r in reqs],
           "moe_padded_prefills": padded}
    if busy_ms is None:
        trace = "the profiler trace holds no device events; device busy " \
            "time not measured"
    else:
        trace = (f"device busy {busy_ms:.3f} ms in {events:.0f} device "
                 f"events (profiled), kernel 5 "
                 f"{out['kernel5_ms_per_step']:.4f} ms of it, idle share "
                 f"{idle:.4f} | top: "
                 + "; ".join(f"{n} {ms:.4f} ms" for n, ms in top))
    if keep is not None:
        keep.update(probe)
    print(f"{tag} serve {label} ({cfg.param_dtype} params, {cfg.dtype} "
          f"activations): {out['completed']}/{n_req} requests, "
          f"{out['tokens']} tokens over {steps} decode steps, {padded} "
          f"prefills with zero rows in a MoE group | "
          f"{out['decode_tokens_per_s']:.2f} tok/s in decode, "
          f"{out['wall_tokens_per_s']:.2f} tok/s wall | p50 "
          f"{out['p50_ms']:.3f} ms p99 {out['p99_ms']:.3f} ms | peak mem "
          f"{peak / 2 ** 30:.2f} GiB | {step_ms:.3f} ms host a served step "
          f"(mean), probe step {probe_ms:.3f} ms wall, {trace}")
    return out


def f32_probe(torch, np, cfg, params, alt, label, *, decorate=None,
              tag="moe"):
    """One mid-run decode step of an f32-activation engine, re-run on
    copies of its cache on the served route and under ``alt`` (the plain
    decode attention, or the materialised MLA): logits within TOL_PROBE *
    max|logit|, every MoE layer's routing equal (a model with MoE layers);
    kernel 5's launches in each re-run.  ``decorate(rng, request)`` gives
    a request its patches."""
    from repro_torch.kernels.decode_attn import ops as dec_ops
    from repro_torch.serving import Engine, ServeConfig
    eng = Engine(cfg, ServeConfig(max_batch=BATCH, max_len=512,
                                  prefill_bucket=64),
                 params=params, device=DEVICE)
    rng = np.random.default_rng(12)
    for r in _requests(rng, cfg.vocab_size, BATCH, *MOE_PROMPTS,
                       MOE_PROBE_STEP + 4):
        if decorate is not None:
            decorate(rng, r)
        eng.submit(r)
    probe = {}
    hook = _snapshot_at(MOE_PROBE_STEP, probe)
    while not probe:
        eng.step(hook)
    runs = []
    for ctx in (contextlib.nullcontext(), alt()):
        routes = []
        n0 = dec_ops.launch_counts()["decode_attn"]
        with ctx, recorded_routing(routes):
            logits = eng.decode(probe["tokens"], probe["lengths"],
                                _copy_cache(probe["cache"]))
        torch.cuda.synchronize()
        runs.append((logits, routes,
                     dec_ops.launch_counts()["decode_attn"] - n0))
    (got, r_got, k_got), (ref, r_ref, k_ref) = runs
    act = torch.as_tensor(probe["mask"], device=DEVICE)
    got, ref = got[act], ref[act]
    check(bool(torch.isfinite(got).all()) and got.shape[-1]
          == cfg.vocab_size, f"{label} probe: logits malformed")
    same = sum(int(torch.equal(a, b)) for a, b in zip(r_got, r_ref))
    dmax = float((got - ref).abs().max())
    lmax = float(ref.abs().max())
    print(f"{tag} probe {label} (f32 activations, decode step "
          f"{MOE_PROBE_STEP}, {int(probe['mask'].sum())} active slots): "
          f"logits max|d| {dmax:.3e} (max|logit| {lmax:.3e}, rel "
          f"{dmax / lmax:.3e}, tol {TOL_PROBE:g}) | MoE layers routed "
          f"alike {same}/{len(r_ref)} | kernel 5 launches {k_got} then "
          f"{k_ref}")
    if cfg.moe is None:
        check(not r_got and not r_ref, f"{label} probe: routed with no MoE")
    else:
        check(len(r_got) == len(r_ref) > 0 and same == len(r_ref),
              f"{label} probe: {len(r_ref) - same} MoE layers routed "
              "otherwise")
    check(dmax <= TOL_PROBE * lmax, f"{label} probe: logits off: {dmax} > "
          f"{TOL_PROBE} * {lmax}")
    return {"max_abs": dmax, "max_logit": lmax, "moe_layers": len(r_ref),
            "moe_layers_equal": same, "kernel5_launches": [k_got, k_ref]}


def reduced_on_card(torch, np, arch, seed, quantized=False, cfg=None):
    """A reduced model's greedy tokens on the card equal the CPU
    engine's (f32); ``quantized``: with every linear BFP-compressed
    (``lm.quantize_linear_tree`` at a ``min_size`` of 256).  The
    encoder-decoder's requests carry 16, 8, 3, 16 and 12 frames over a
    cross cache of 16 rows; the VLM's carry patches.  ``cfg``: that
    reduced config instead of ``arch``'s."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm, model_for
    from repro_torch.serving import Engine, Request, ServeConfig
    small = cfg or get_config(arch).reduced()
    sp = model_for(small).init(seed, small, device="cpu")
    if quantized:
        sp = lm.quantize_linear_tree(sp, small, min_size=256)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, small.vocab_size, size=n).tolist()
               for n in (5, 17, 20, 9, 12)]
    extras = [{} for _ in prompts]
    if small.family == "audio":
        extras = [{"frames": (rng.standard_normal((T, small.d_model))
                              * 0.5).astype(np.float32)}
                  for T in (16, 8, 3, 16, 12)]
    elif small.family == "vlm":
        extras = [{"patches": (rng.standard_normal((small.num_patches,
                                                    1024)) * 0.1)
                   .astype(np.float32)} for _ in prompts]
    toks = {}
    for dev in ("cpu", "cuda"):
        e = Engine(small, ServeConfig(
            max_batch=3, max_len=64, prefill_bucket=8,
            cross_len=16 if small.family == "audio" else 0),
            params=lm.to_device(sp, dev), device=dev)
        rs = [Request(prompt=p, max_new=6, **x)
              for p, x in zip(prompts, extras)]
        for r in rs:
            e.submit(r)
        e.run_until_done()
        toks[dev] = [r.generated for r in rs]
    check(toks["cpu"] == toks["cuda"], f"reduced {arch}: the card's greedy "
          "tokens differ from the CPU engine's")
    return len(prompts)


def phase_moe(torch, np):
    """Phase 10: 10a-10e."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.nn.module import tree_bytes
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    out = {}
    # 10a, 10b: granite-moe-1b-a400m, f32 parameters drawn on the card
    cfg = get_config(MOE_ARCH)
    params = lm.init(gen.manual_seed(0), cfg, device="cuda")
    g = serve_lm_full(torch, np, cfg, params, *MOE_SHAPE,
                      np.random.default_rng(10), "granite")
    k5 = g["launches"]["decode_attn"]
    check(k5 == cfg.num_layers * g["decode_steps"], f"granite: kernel 5 "
          f"{k5} launches for {g['decode_steps']} decode steps, expected "
          f"{cfg.num_layers} a step")
    others = {k: n for k, n in g["launches"].items() if k != "decode_attn"}
    check(not any(others.values()), f"granite serve launched {others}")
    g["probe"] = f32_probe(torch, np,
                           dataclasses.replace(cfg, dtype="float32"),
                           params, plain_decode_attention, "granite")
    check(g["probe"]["kernel5_launches"] == [cfg.num_layers, 0],
          f"granite probe: kernel 5 ran {g['probe']['kernel5_launches']} "
          f"times in the kernel and plain re-runs; expected "
          f"[{cfg.num_layers}, 0]")
    out["granite"] = g
    del params
    torch.cuda.empty_cache()
    # phi4-mini-3.8b: dense GQA with 128-wide heads, f32 parameters
    cfg = get_config(PHI_ARCH)
    params = lm.init(gen.manual_seed(1), cfg, device="cuda")
    ph = serve_lm_full(torch, np, cfg, params, *PHI_SHAPE,
                       np.random.default_rng(11), "phi4-mini")
    check(ph["launches"]["decode_attn"] == cfg.num_layers
          * ph["decode_steps"], f"phi4-mini: kernel 5 "
          f"{ph['launches']['decode_attn']} launches for "
          f"{ph['decode_steps']} steps, expected {cfg.num_layers} a step")
    out["phi4"] = ph
    del params
    torch.cuda.empty_cache()
    # 10c, 10d: deepseek-v2-lite-16b, bf16 parameters drawn on the card
    cfg = dataclasses.replace(get_config(MLA_ARCH), param_dtype="bfloat16")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    params = lm.init(gen.manual_seed(2), cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t1
    d = serve_lm_full(torch, np, cfg, params, *MLA_SHAPE,
                      np.random.default_rng(12), "deepseek")
    d["init_s"] = init_s
    d["param_bytes"] = tree_bytes(params)
    check(not any(d["launches"].values()), f"deepseek serve launched "
          f"{d['launches']}; MLA decodes with no kernel")
    d["probe"] = f32_probe(torch, np,
                           dataclasses.replace(cfg, dtype="float32"),
                           params, materialised_mla, "deepseek")
    out["deepseek"] = d
    del params
    torch.cuda.empty_cache()
    # 10e: the reduced models, card against CPU
    out["reduced"] = {arch: reduced_on_card(torch, np, arch, 3)
                      for arch in (MOE_ARCH, MLA_ARCH)}
    out["phase_s"] = time.perf_counter() - t0
    print(f"moe: reduced {MOE_ARCH} and {MLA_ARCH} tokens equal to the CPU "
          f"engine's | phase 10 {out['phase_s']:.1f} s")
    return out


# --- phase 11: encoder-decoder and vision-language serving -------------------
def encdec_requests(np, cfg, rng, n, max_new):
    """``n`` requests of ENCDEC_PROMPTS prompt tokens with 0.1 * N(0, 1)
    frames: ENCDEC_CROSS rows, half that for every third request."""
    reqs = _requests(rng, cfg.vocab_size, n, *ENCDEC_PROMPTS, max_new)
    for i, r in enumerate(reqs):
        rows = ENCDEC_CROSS // 2 if i % 3 == 2 else ENCDEC_CROSS
        r.frames = rng.standard_normal((rows, cfg.d_model),
                                       dtype=np.float32) * 0.1
    return reqs


def encdec_scfg():
    from repro_torch.serving import ServeConfig
    return ServeConfig(max_batch=BATCH, max_len=ENCDEC_MAX_LEN,
                       prefill_bucket=64, cross_len=ENCDEC_CROSS)


def teacher_forced(torch, np, eng, probe, tol, label):
    """The probe step re-run on a copy of its cache; the logits of its
    first full-frame and first half-frame slot against ``encdec.apply``
    in train mode over the slot's prompt, its tokens so far and its
    frames: within ``tol`` * max|logit|, argmax the token the engine
    emitted.  Kernel 5's launches in the re-run."""
    from repro_torch.kernels.decode_attn import ops as dec_ops
    from repro_torch.models import encdec
    cfg = eng.cfg
    n0 = dec_ops.launch_counts()["decode_attn"]
    logits = eng.decode(probe["tokens"], probe["lengths"],
                        _copy_cache(probe["cache"]))
    launched = dec_ops.launch_counts()["decode_attn"] - n0
    picked = {}
    for s, (req, g) in sorted(probe["slots"].items()):
        picked.setdefault(req.frames.shape[0], (s, req, g))
    check(set(picked) == {ENCDEC_CROSS, ENCDEC_CROSS // 2},
          f"{label}: the probe step has slots with {sorted(picked)} frames")
    out = {"kernel5_launches": launched}
    for rows, (s, req, g) in sorted(picked.items()):
        check(int(probe["lengths"][s]) == len(req.prompt) + g - 1,
              f"{label}: slot {s} length {int(probe['lengths'][s])}")
        toks = torch.tensor([req.prompt + req.generated[:g]], device=DEVICE)
        with torch.no_grad():
            tf, _, _ = encdec.apply(
                eng.params, cfg, toks,
                frames=torch.from_numpy(req.frames)[None].to(DEVICE))
        ref, got = tf[0, -1], logits[s]
        dmax = float((got - ref).abs().max())
        lmax = float(ref.abs().max())
        emitted = req.generated[g]
        print(f"encdec probe {label} ({cfg.dtype} activations) slot {s}, "
              f"{rows} frames, position {len(toks[0]) - 1}: decode vs "
              f"teacher forcing max|d| {dmax:.3e} (max|logit| {lmax:.3e}, "
              f"rel {dmax / lmax:.3e}, tol {tol:g}) | argmax "
              f"{int(got.argmax())}, emitted {emitted}")
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite logits")
        check(dmax <= tol * lmax, f"{label} slot {s} ({rows} frames): "
              f"decode logits off teacher forcing: {dmax} > {tol} * {lmax}")
        check(int(got.argmax()) == emitted, f"{label} slot {s}: the re-run "
              "step's argmax is not the token the engine emitted")
        out[f"frames_{rows}"] = {"slot": s, "max_abs": dmax,
                                 "max_logit": lmax}
    return out


def phase_encdec(torch, np, gen):
    """11a: whisper-tiny at published widths."""
    from repro_torch.configs import get_config
    from repro_torch.models import encdec
    from repro_torch.serving import Engine
    cfg = get_config(ENCDEC_ARCH)
    params = encdec.init(gen.manual_seed(3), cfg, device=DEVICE)
    rng = np.random.default_rng(13)
    n_req, max_new = ENCDEC_SHAPE
    probe = {}
    w = serve_lm_full(torch, np, cfg, params, n_req, max_new, rng,
                      ENCDEC_ARCH, scfg=encdec_scfg(),
                      reqs=encdec_requests(np, cfg, rng, n_req, max_new),
                      keep=probe, tag="encdec")
    k5 = w["launches"]["decode_attn"]
    check(k5 == 2 * cfg.num_layers * w["decode_steps"], f"whisper: kernel "
          f"5 {k5} launches for {w['decode_steps']} decode steps, expected "
          f"{2 * cfg.num_layers} a step (self and cross)")
    others = {k: n for k, n in w["launches"].items() if k != "decode_attn"}
    check(not any(others.values()), f"whisper serve launched {others}")
    eng = Engine(cfg, encdec_scfg(), params=params, device=DEVICE)
    w["probe_bf16"] = teacher_forced(torch, np, eng, probe, TOL_BF16,
                                     "whisper served")
    # the same check in an f32-activation engine
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    eng = Engine(cfg32, encdec_scfg(), params=params, device=DEVICE)
    for r in encdec_requests(np, cfg32, np.random.default_rng(14), BATCH,
                             MOE_PROBE_STEP + 4):
        eng.submit(r)
    probe32 = {}
    hook = _snapshot_at(MOE_PROBE_STEP, probe32)
    while not probe32:
        eng.step(hook)
    w["probe_f32"] = teacher_forced(torch, np, eng, probe32, TOL_PROBE,
                                    "whisper f32")
    for key in ("probe_bf16", "probe_f32"):
        check(w[key]["kernel5_launches"] == 2 * cfg.num_layers,
              f"whisper {key}: kernel 5 ran {w[key]['kernel5_launches']} "
              f"times in the re-run step")
    return w


def phase_vlm(torch, np, gen):
    """11b: phi-3-vision-4.2b at published widths."""
    from repro_torch.configs import get_config
    from repro_torch.models import vlm
    from repro_torch.nn.module import tree_bytes
    cfg = get_config(VLM_ARCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = vlm.init(gen.manual_seed(4), cfg, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(15)
    n_req, max_new = VLM_SHAPE

    def patches(rng, r):
        r.patches = rng.standard_normal((cfg.num_patches, vlm.CLIP_DIM),
                                        dtype=np.float32) * 0.1

    reqs = _requests(rng, cfg.vocab_size, n_req, *VLM_PROMPTS, max_new)
    for r in reqs:
        patches(rng, r)
    v = serve_lm_full(torch, np, cfg, params, n_req, max_new, rng, VLM_ARCH,
                      reqs=reqs, tag="vlm")
    v["init_s"] = init_s
    v["param_bytes"] = tree_bytes(params)
    k5 = v["launches"]["decode_attn"]
    check(k5 == cfg.num_layers * v["decode_steps"], f"phi-3-vision: kernel "
          f"5 {k5} launches for {v['decode_steps']} decode steps, expected "
          f"{cfg.num_layers} a step")
    others = {k: n for k, n in v["launches"].items() if k != "decode_attn"}
    check(not any(others.values()), f"phi-3-vision serve launched {others}")
    v["probe"] = f32_probe(torch, np,
                           dataclasses.replace(cfg, dtype="float32"),
                           params, plain_decode_attention, "phi-3-vision",
                           decorate=patches, tag="vlm")
    check(v["probe"]["kernel5_launches"] == [cfg.num_layers, 0],
          f"phi-3-vision probe: kernel 5 ran "
          f"{v['probe']['kernel5_launches']} times in the kernel and plain "
          f"re-runs; expected [{cfg.num_layers}, 0]")
    return v


def phase_encdec_vlm(torch, np):
    """Phase 11: 11a whisper-tiny, 11b phi-3-vision-4.2b, 11c the reduced
    models' card tokens against the CPU engine's."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE)
    out = {"whisper": phase_encdec(torch, np, gen)}
    torch.cuda.empty_cache()
    out["phi3v"] = phase_vlm(torch, np, gen)
    torch.cuda.empty_cache()
    out["reduced"] = {arch: reduced_on_card(torch, np, arch, 3)
                      for arch in (ENCDEC_ARCH, VLM_ARCH)}
    out["phase_s"] = time.perf_counter() - t0
    print(f"encdec/vlm: reduced {ENCDEC_ARCH} and {VLM_ARCH} tokens equal "
          f"to the CPU engine's | phase 11 {out['phase_s']:.1f} s")
    return out


# --- phase 12: the hybrid family --------------------------------------------
def hybrid_prefill_probe(torch, np, cfg, params, label):
    """One prefill of HYBRID_PROBE_PROMPT tokens with f32 activations, on
    the served route (kernels 6 and 7 in every Mamba layer) and on the
    plain route (``plain_ssm_route``): logits within TOL_PROBE *
    max|logit|, every MoE layer routed alike; each route's launches."""
    from repro_torch.models import lm
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    rng = np.random.default_rng(21)
    toks = torch.as_tensor(rng.integers(
        1, cfg.vocab_size, (1, HYBRID_PROBE_PROMPT)), device=DEVICE)
    runs = []
    for ctx in (contextlib.nullcontext(), plain_ssm_route()):
        routes = []
        n0 = launch_counts()
        with ctx, recorded_routing(routes):
            logits = lm.apply(params, cfg32, toks, mode="prefill",
                              caches=lm.cache_init(cfg32, 1, 512,
                                                   device=DEVICE))[0]
        torch.cuda.synchronize()
        n1 = launch_counts()
        runs.append((logits, routes, {k: n1[k] - n0[k]
                                      for k in ("ssd", "dw1d")}))
    (got, r_got, k_got), (ref, r_ref, k_ref) = runs
    check(bool(torch.isfinite(got).all()) and got.shape == (
        1, HYBRID_PROBE_PROMPT, cfg.vocab_size),
        f"{label} prefill probe: logits malformed")
    same = sum(int(torch.equal(a, b)) for a, b in zip(r_got, r_ref))
    dmax = float((got - ref).abs().max())
    lmax = float(ref.abs().max())
    n_ssm = sum(m == "ssm" for m, _ in (cfg.layer_kind(i)
                                        for i in range(cfg.num_layers)))
    print(f"hybrid probe {label} prefill (f32 activations, "
          f"{HYBRID_PROBE_PROMPT} tokens): kernels vs plain route max|d| "
          f"{dmax:.3e} (max|logit| {lmax:.3e}, rel {dmax / lmax:.3e}, tol "
          f"{TOL_PROBE:g}) | MoE layers routed alike {same}/{len(r_ref)} | "
          f"launches kernel route {k_got}, plain route {k_ref}")
    check(k_got == {"ssd": n_ssm, "dw1d": n_ssm}
          and k_ref == {"ssd": 0, "dw1d": 0}, f"{label} prefill probe: "
          f"launches {k_got} then {k_ref}; expected {n_ssm} then 0")
    check(len(r_got) == len(r_ref) > 0 and same == len(r_ref),
          f"{label} prefill probe: {len(r_ref) - same} MoE layers routed "
          "otherwise")
    check(dmax <= TOL_PROBE * lmax, f"{label} prefill probe: logits off: "
          f"{dmax} > {TOL_PROBE} * {lmax}")
    return {"max_abs": dmax, "max_logit": lmax, "moe_layers": len(r_ref),
            "moe_layers_equal": same, "launches": [k_got, k_ref]}


def check_hybrid_launches(cfg, run, prefills, label):
    """Kernel 5 once per attention layer a decode step, kernels 6 and 7
    once per Mamba layer a prefill, nothing else."""
    kinds = [cfg.layer_kind(i)[0] for i in range(cfg.num_layers)]
    n_attn, n_ssm = kinds.count("attn"), kinds.count("ssm")
    got = run["launches"]
    want = {"decode_attn": n_attn * run["decode_steps"],
            "ssd": n_ssm * prefills, "dw1d": n_ssm * prefills}
    check({k: got[k] for k in want} == want, f"{label}: launches "
          f"{ {k: got[k] for k in want} }, expected {want} ({n_attn} a "
          f"decode step, {n_ssm} a prefill)")
    others = {k: n for k, n in got.items() if k not in want}
    check(not any(others.values()), f"{label} launched {others}")
    return n_attn, n_ssm


def bfp8_hybrid(torch, cfg, gen):
    """``lm.quantize_linear_tree(lm.init(gen, cfg), cfg)``, the reference's
    ``bfp8`` serving dtype when ``cfg.param_dtype`` is bf16, drawn on the
    card one layer at a time, each layer compressed before the next is
    drawn: no uncompressed copy of the whole model is ever made.  It
    draws ``lm.init``'s leaves in ``lm.init``'s order, so the two trees
    are equal (``check_bfp8_hybrid``)."""
    from repro_torch.core import bfp
    from repro_torch.models import lm
    from repro_torch.nn import blocks, layers
    from repro_torch.nn.module import torch_dtype
    dtype = torch_dtype(cfg.param_dtype)
    n_prefix = lm._n_prefix(cfg)
    groups = (cfg.num_layers - n_prefix) // cfg.pattern_period()
    params = {"embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                         dtype)}
    params["stack"] = [
        bfp.quantize_linear_tree(
            lm.to_device(blocks.block_init(gen, cfg, *kind), DEVICE),
            stack=0 if i < n_prefix else groups)
        for i, kind in enumerate(blocks.stack_kinds(cfg))]
    params["final_norm"] = layers.norm_init(cfg.norm_type, cfg.d_model,
                                            dtype)
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.linear_init(gen, cfg.d_model,
                                               cfg.vocab_size, dtype)
    return lm.quantize_linear_tree(lm.to_device(params, DEVICE), cfg)


def check_bfp8_hybrid(torch, cfg, gen):
    """``bfp8_hybrid`` equal, leaf for leaf and bit for bit, to
    ``lm.quantize_linear_tree(lm.init(...))`` at ``cfg`` from one seed.
    Returns the number of compressed weights."""
    from repro_torch.models import lm
    from repro_torch.nn.module import tree_leaves, tree_map
    got = bfp8_hybrid(torch, cfg, gen.manual_seed(5))
    want = lm.quantize_linear_tree(
        lm.init(gen.manual_seed(5), cfg, device=DEVICE), cfg)
    same = (tree_map(lambda t: None, got) == tree_map(lambda t: None, want)
            and all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
                    zip(tree_leaves(got), tree_leaves(want))))
    n_q = sum(t.dtype == torch.int8 for t in tree_leaves(want)) // 2
    check(same and n_q > 0, f"bfp8_hybrid at {cfg.name} {cfg.num_layers} "
          f"layers, d_model {cfg.d_model}: not lm.init's tree compressed "
          f"({n_q} weights compressed)")
    return n_q


def phase_hybrid(torch, np, card):
    """Phase 12: 12a two periods of jamba-v0.1-52b served, 12b its probes,
    12c all 32 layers in bfp8 served, 12d the reduced model on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.nn.module import count_params, tree_bytes, tree_leaves
    from repro_torch.serving import ServeConfig
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE)
    full = dataclasses.replace(get_config(HYBRID_ARCH),
                               param_dtype="bfloat16")
    scfg = ServeConfig(max_batch=BATCH, max_len=512)
    out = {}
    # 12a: published widths, two periods, bf16 parameters drawn on the card
    cfg = dataclasses.replace(full, num_layers=HYBRID_PERIODS
                              * full.pattern_period())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    params = lm.init(gen.manual_seed(0), cfg, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t1
    n_params, nbytes = count_params(params), tree_bytes(params)
    print(f"hybrid {HYBRID_ARCH} at published widths, {cfg.num_layers} "
          f"layers: {n_params / 1e9:.3f} B bf16 parameters "
          f"({nbytes / 1e9:.2f} GB) drawn on the card in {init_s:.2f} s")
    rng = np.random.default_rng(22)
    n_req, max_new = HYBRID_SHAPE
    a = serve_lm_full(torch, np, cfg, params, n_req, max_new, rng, "jamba",
                      scfg=scfg, reqs=_requests(rng, cfg.vocab_size, n_req,
                                                *HYBRID_PROMPTS, max_new),
                      tag="hybrid")
    n_attn, n_ssm = check_hybrid_launches(cfg, a, n_req, "jamba serve")
    a.update(init_s=init_s, params=n_params, param_bytes=nbytes,
             layers=cfg.num_layers, attn_layers=n_attn, ssm_layers=n_ssm)
    # 12b: the probes, f32 activations on the same bf16 weights
    a["probe"] = f32_probe(torch, np,
                           dataclasses.replace(cfg, dtype="float32"),
                           params, plain_decode_attention, "jamba",
                           tag="hybrid")
    check(a["probe"]["kernel5_launches"] == [n_attn, 0], f"jamba probe: "
          f"kernel 5 ran {a['probe']['kernel5_launches']} times in the "
          f"kernel and plain re-runs; expected [{n_attn}, 0]")
    a["prefill_probe"] = hybrid_prefill_probe(torch, np, cfg, params,
                                              "jamba")
    out["jamba"] = a
    del params
    torch.cuda.empty_cache()
    # 12c: all 32 layers, every large linear BFP-compressed
    small = dataclasses.replace(full.reduced(), param_dtype="bfloat16")
    small_q = check_bfp8_hybrid(torch, small, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    params = bfp8_hybrid(torch, full, gen.manual_seed(1))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    build_peak = torch.cuda.max_memory_allocated()
    resident = torch.cuda.memory_allocated()
    nbytes = tree_bytes(params)
    n_q = sum(t.dtype == torch.int8 for t in tree_leaves(params)) // 2
    print(f"hybrid {HYBRID_ARCH} bfp8, all {full.num_layers} layers: "
          f"{nbytes / 1e9:.2f} GB of parameters ({n_q} weights "
          f"compressed) built in {build_s:.2f} s | resident "
          f"{resident / 1e9:.2f} GB, peak while building "
          f"{build_peak / 1e9:.2f} GB | at the reduced config equal to "
          f"lm.init's tree compressed ({small_q} weights) | on {card}")
    rng = np.random.default_rng(23)
    n_req, max_new = HYBRID_BFP_SHAPE
    c = serve_lm_full(torch, np, full, params, n_req, max_new, rng,
                      "jamba bfp8", scfg=scfg,
                      reqs=_requests(rng, full.vocab_size, n_req,
                                     *HYBRID_BFP_PROMPTS, max_new),
                      tag="hybrid")
    check_hybrid_launches(full, c, n_req, "jamba bfp8 serve")
    c.update(build_s=build_s, build_peak_mem_bytes=build_peak,
             resident_bytes=resident, param_bytes=nbytes,
             layers=full.num_layers, compressed_weights=n_q)
    out["jamba_bfp8"] = c
    del params
    torch.cuda.empty_cache()
    # 12d: the reduced model, as it is and BFP-compressed
    out["reduced"] = {q: reduced_on_card(torch, np, HYBRID_ARCH, 3,
                                         quantized=q == "bfp8")
                      for q in ("bf16", "bfp8")}
    out["phase_s"] = time.perf_counter() - t0
    print(f"hybrid: reduced {HYBRID_ARCH} tokens equal to the CPU engine's, "
          f"as it is and BFP-compressed | phase 12 {out['phase_s']:.1f} s")
    return out


# --- slice 17: BFP in bf16, F(m,3) at every m, kernel 7 at every tap count,
# --- training the audio and vlm families ------------------------------------
def phase_bfp_bf16(torch, np, cfg16, params16):
    """3f: kernel 4 at fc6, fc7 and fc8, M = 8, on a bf16 BFP model's
    activations (its conv features on the ``direct`` route, then the
    classifier's chain: each layer's f32 output plus the f32 bias,
    rounded to bf16): the pre-pass reads bf16 x, bit-equal to the f32
    kernel on ``x.float()`` and to the plain version; timed beside the
    bf16 ``x @ w`` a bf16 model without ``fc_bfp`` runs and the bound (the
    int8 stream's bytes)."""
    from repro_torch.kernels.bfp_matmul import bfp_matmul as bfp
    from repro_torch.kernels.bfp_matmul.ops import fc_block, \
        quantize_weights
    from repro_torch.models import alexnet
    rng = np.random.default_rng(2)
    card = card_line()
    x = torch.as_tensor(rng.standard_normal(
        (BATCH, cfg16.image_size, cfg16.image_size, cfg16.in_channels)),
        dtype=torch.bfloat16, device="cuda")
    cfg_d = dataclasses.replace(cfg16, use_winograd=False, use_pallas=False)
    x = alexnet.features(params16, cfg_d, x)
    row = new_row("bfp_matmul")
    for j in range(len(cfg16.fc_dims)):
        layer = f"fc{j + 6}"
        w, b = params16[layer]["w"], params16[layer]["b"]
        K, N = w.shape
        block = fc_block(K)
        wq, we = quantize_weights(w, block=block)
        check(x.dtype is torch.bfloat16 and w.dtype is torch.bfloat16,
              f"{layer}: x {x.dtype}, w {w.dtype}")

        def kern():
            return bfp.bfp_matmul(x, wq, we, block=block)

        def plain():
            return bfp.bfp_matmul_plain(x, wq, we, block=block)

        def library():
            return x @ w

        got, scratch = bfp._bfp_matmul_cuda(x, wq, we, block=block)
        got32 = bfp.bfp_matmul(x.float(), wq, we, block=block)
        torch.cuda.synchronize()
        ref = plain()
        words, exps = bfp.quantize_activations(x, block)
        check(torch.equal(scratch[:words.numel()].view(words.shape), words)
              and torch.equal(scratch[words.numel():].view(exps.shape), exps),
              f"{layer} bf16: the pre-pass's bytes differ from "
              "quantize_activations")
        check(torch.equal(got, got32) and torch.equal(got, ref),
              f"{layer} bf16: the kernel on bf16 x is not bit-equal to the "
              "f32 kernel on x.float() and to its plain version")
        check(bool(torch.isfinite(got).all()), f"{layer}: non-finite output")
        lib_err = float((got - library().float()).abs().max())
        scale = float(ref.abs().max())
        (ms, host_ms), (plain_ms, _), (lib_ms, _) = (
            time_ms(torch, kern), time_ms(torch, plain),
            time_ms(torch, library))
        flops = 2 * BATCH * K * N
        nbytes = (2 * x.numel() + wq.numel() + we.numel()
                  + 4 * got.numel())
        bound, bound_by = _bound(flops, nbytes, "int8")
        print(f"kernel bfp_matmul {layer} (bf16 x): x {tuple(x.shape)} w "
              f"({K}, {N}) block {block} | bit-equal to the f32 kernel on "
              f"x.float() and to plain (max|plain| {scale:.3e}; vs bf16 "
              f"x @ w {lib_err:.3e}) | kernel_ms {ms:.4f} (host enqueue "
              f"{host_ms:.4f} ms) plain_ms {plain_ms:.4f} library_ms(bf16 "
              f"x @ w, the FC of a bf16 model without fc_bfp) {lib_ms:.4f} "
              f"bound_ms {bound:.4f} ({bound_by}: {nbytes:.3e} B) | on "
              f"{card}")
        add_layer(row, layer, max_abs_err=0.0, ms=ms, host_ms=host_ms,
                  plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                  bound_by=bound_by, flop=flops, bytes=nbytes)
        x = (ref + b.float()).to(torch.bfloat16)
        if j < len(cfg16.fc_dims) - 1:
            x = torch.relu(x)
    return row


def on_cpu(torch, obj):
    """A copy on the CPU of params or ``pack_serving_slabs``' dict (slabs,
    FC streams)."""
    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if isinstance(obj, dict):
        return {k: on_cpu(torch, v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(on_cpu(torch, v) for v in obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, data=on_cpu(torch, obj.data))
    return obj


def phase_serve_bf16_bfp(torch, np, cfg_alex, params_alex16, cfg_vgg,
                         params_vgg16):
    """4h: full-width AlexNet and VGG-16 in bf16 with ``fc_bfp`` and
    ``conv_bfp`` through ``CnnEngine(max_batch=8)``: 32 requests each in
    groups of 1-8, every request delivered, bit-equal to ``apply``, within
    TOL_BF16 of the f32 model with the same quantization (the bf16 gate:
    bf16 against the same function in f32), launches per forward (kernels
    1-4), one batch traced.  Against the f32 model without quantization
    (the direct route, no kernel) the served logits are held to TOL_BFP
    where the quantization's own error allows it: that error is measured
    on the first WITNESS_IMAGES images by the same f32 BFP function with
    every kernel replaced by its plain version on the host's CPU, on the
    card's slabs and FC streams (packed once, so both quantize alike).
    The card is held to that witness layer by layer: its conv features
    within TOL_ROUTE of the plain versions', and its FC layers on the
    plain features bit-equal to theirs.  (Whole-model logits are printed,
    not held: the FC layers quantize their activations to 8-bit
    mantissas, so an f32 difference in the last bits of a feature can
    move it a whole step.)  Where the quantization's own error exceeds
    TOL_BFP no port could meet that gate, and the served logits are held
    to it plus TOL_BF16 instead.  The plain route's BFP (raw filters
    quantized, no Winograd-domain slab) is measured beside it.  Then an
    armed bf16 BFP AlexNet on clean slabs: verdict 0 and bit-equal to the
    unarmed model."""
    from repro_torch.models import alexnet
    out = {}
    card = card_line()
    rng = np.random.default_rng(SDC_SEED + 3)
    for name, cfg, params16 in (("alexnet", cfg_alex, params_alex16),
                                ("vgg16", cfg_vgg, params_vgg16)):
        quant = dict(fc_bfp=True, conv_bfp=True)
        plain_route = dict(use_pallas=False, use_winograd=False)
        cfg16 = dataclasses.replace(cfg, dtype="bfloat16", **quant)
        cfg_q32 = dataclasses.replace(cfg, **quant)
        params32 = to_f32(params16)
        res, served, images = serve_and_check(
            torch, np, cfg16, params16, cfg_f32=cfg_q32, params_f32=params32,
            tol=TOL_BF16, label=f"{name} bf16 bfp")
        images = torch.as_tensor(images, device="cuda")
        f32 = alexnet.apply(params32, dataclasses.replace(
            cfg, **plain_route), images).cpu().numpy()
        d, lmax = float(np.abs(served - f32).max()), float(np.abs(f32).max())
        xw = images[:WITNESS_IMAGES]
        slabs = alexnet.pack_serving_slabs(params32, cfg_q32,
                                           WITNESS_IMAGES)
        params_c, slabs_c = on_cpu(torch, params32), on_cpu(torch, slabs)
        feats = alexnet.features(params32, cfg_q32, xw, packed=slabs)
        feats_c = alexnet.features(params_c, cfg_q32, xw.cpu(),
                                   packed=slabs_c)
        q_cpu = alexnet.classifier(params_c, cfg_q32, feats_c,
                                   packed=slabs_c)
        fc_card = alexnet.classifier(params32, cfg_q32, feats_c.cuda(),
                                     packed=slabs).cpu()
        q_card = alexnet.classifier(params32, cfg_q32, feats,
                                    packed=slabs).cpu()
        q_route = alexnet.apply(params32, dataclasses.replace(
            cfg_q32, **plain_route), xw).cpu()
        fw = torch.as_tensor(f32[:WITNESS_IMAGES])
        lw = float(fw.abs().max())
        d_feat = float((feats.cpu() - feats_c).abs().max())
        f_max = float(feats_c.abs().max())
        d_route = float((q_card - q_cpu).abs().max())
        e_q = float((q_cpu - fw).abs().max()) / lw
        e_route = float((q_route - fw).abs().max()) / lw
        gate = TOL_BFP if e_q <= TOL_BFP else e_q + TOL_BF16
        print(f"serve {name} bf16 bfp: served vs the f32 model (direct "
              f"route) max|d| {d:.3e} (max|logit| {lmax:.3e}, rel "
              f"{d / lmax:.3e}, tol {gate:.4g}"
              + ("" if gate == TOL_BFP else
                 f": the quantization's own {e_q:.3e} + TOL_BF16") + ") | "
              f"on {WITNESS_IMAGES} images, the f32 BFP model on the card vs "
              f"its kernels' plain versions on the CPU: features max|d| "
              f"{d_feat:.3e} (tol {TOL_ROUTE:g} of {f_max:.3e}), FC layers "
              f"on the same features bit-equal, logits max|d| {d_route:.3e}"
              f" (rel {d_route / lw:.3e}); the quantization's own error vs "
              f"f32 (plain versions) {e_q:.3e}, the plain route's BFP (raw "
              f"filters) {e_route:.3e} | on {card}")
        check(d_feat <= TOL_ROUTE * f_max, f"{name}: the f32 BFP model's "
              f"conv features on the card are {d_feat} off its plain "
              "versions'")
        check(torch.equal(fc_card, q_cpu), f"{name}: the f32 BFP model's FC "
              "layers on the card differ from their plain versions on the "
              "same features")
        check(d <= gate * lmax, f"{name} bf16 bfp: served logits off the "
              f"f32 model: {d} > {gate} * {lmax}")
        out[name] = res | {"vs_f32": {
            "max_abs": d, "max_abs_logit": lmax, "tol": gate},
            "witness": {"images": WITNESS_IMAGES,
                        "features_card_vs_plain_max_abs": d_feat,
                        "logits_card_vs_plain_max_abs": d_route,
                        "quantization_rel": e_q,
                        "plain_route_quantization_rel": e_route}}
    cfg16 = dataclasses.replace(cfg_alex, dtype="bfloat16", fc_bfp=True,
                                conv_bfp=True)
    x = torch.as_tensor(rng.standard_normal(
        (BATCH, cfg16.image_size, cfg16.image_size, cfg16.in_channels)),
        dtype=torch.float32, device="cuda")
    plain = alexnet.apply(params_alex16, cfg16, x)
    logits, sdc = alexnet.apply(params_alex16, dataclasses.replace(
        cfg16, sdc_abft=True), x)
    torch.cuda.synchronize()
    check(int(sdc) == 0 and torch.equal(logits, plain),
          f"armed bf16 BFP AlexNet: verdict {int(sdc)} on clean slabs, or "
          "its logits differ from the unarmed model's")
    print(f"serve alexnet bf16 bfp armed: verdict 0 on clean slabs, logits "
          f"bit-equal to unarmed | on {card_line()}")
    out["armed_clean"] = {"verdict": int(sdc), "bit_equal": True}
    return out


def _wino_case(winograd, x, w, spec, m, armed=False):
    """(plan, slab) of one Winograd layer at F(m,3)."""
    lrn = spec.lrn if spec.fuse_lrn else None
    pool = (spec.pool_window, spec.pool_stride) if spec.fuse_pool else None
    p = winograd.plan(tuple(x.shape), tuple(w.shape), m=m,
                      groups=spec.groups, lrn=lrn, pool=pool,
                      checksum=armed)
    return p, winograd.pack_weights(w, p)


def phase_winograd_m(torch, np, cfg, params):
    """3d (kernels 2-3): AlexNet's conv3-conv5 at batch 8 at F(m,3), m in
    WINO_MS, f32 and bf16 x.  f32: within max(TOL_KERNEL, 3 e(m)) of
    max|y| of the plain version, e(m) the plain version's own error
    against ``conv2d_ref`` in float64 on the same layer; every tile
    bit-equal to the default, armed and unarmed, verdict 0 on a clean slab
    and the plain count (1) for a flipped slab bit; timed beside
    ``F.conv2d`` (TF32 off) and the bound at F(m,3)'s own count
    (operations and slab bytes at that m).  bf16 x: the bf16 rule at the
    default tile, timed beside bf16 ``F.conv2d``."""
    from repro_torch.kernels.conv import dma, winograd
    from repro_torch.kernels.conv.ref import conv2d_ref
    card = card_line()
    rows = {}
    for kname, layer, spec, x, w, b, _, _ in layer_cases(
            torch, np, cfg, params):
        if kname == "conv_direct":
            continue
        lrn = spec.lrn if spec.fuse_lrn else None
        pool = (spec.pool_window, spec.pool_stride) if spec.fuse_pool else None
        entry = conv_entry(kname, spec)
        ref64 = conv2d_ref(x.double(), w.double(), b.double(),
                           padding=spec.padding, groups=spec.groups,
                           relu=True, lrn=lrn, pool=pool)
        x16, b16 = x.to(torch.bfloat16), b.to(torch.bfloat16)
        for m in WINO_MS:
            p, slab = _wino_case(winograd, x, w, spec, m)
            _, armed = _wino_case(winograd, x, w, spec, m, armed=True)

            def kern(x=x, b=b, slab=slab, m=m):
                return entry(x, w, b, slab, m=m)

            def plain(x=x, b=b, slab=slab, p=p):
                return winograd.conv2d_winograd_plain(
                    x, slab, b, p, relu=True, lrn=lrn, pool=pool)

            def library():
                return conv2d_ref(x, w, b, padding=spec.padding,
                                  groups=spec.groups, relu=True, lrn=lrn,
                                  pool=pool)

            def library16():
                return library_conv(torch, x16, w.to(torch.bfloat16), b16,
                                    spec)

            got = kern()
            torch.cuda.synchronize()
            ref = plain()
            scale = float(ref.abs().max())
            e_m = float((ref.double() - ref64).abs().max()) / float(
                ref64.abs().max())
            err = float((got - ref).abs().max())
            tol = max(TOL_KERNEL, 3 * e_m)
            check(bool(torch.isfinite(got).all()) and err <= tol * scale,
                  f"{layer} F({m},3): kernel off its plain version: {err} "
                  f"> {tol:.3e} * {scale} (e(m) {e_m:.3e})")
            base = got.view(torch.int32)
            tiles = [t for t in winograd.TILES
                     if t in winograd.ANY_SLAB_TILES or p.Kb % 4 == 0]
            for tile in tiles:
                kw = dict(m=m, tile_rows=tile[0], tile_cols=tile[1])
                y = entry(x, w, b, slab, **kw)
                y_arm, v = entry(x, w, b, armed, checksum=True, **kw)
                torch.cuda.synchronize()
                check(torch.equal(y.view(torch.int32), base)
                      and torch.equal(y_arm.view(torch.int32), base)
                      and int(v) == 0,
                      f"{layer} F({m},3) tile {tile}: not the default "
                      f"tile's bits armed or unarmed, or verdict {int(v)}")
            bad = armed.clone()
            bad.view(-1).view(torch.int32)[7 * armed.numel() // 11] ^= 1 << 9
            _, v = entry(x, w, b, bad, checksum=True, m=m)
            want_v = int(dma.checksum_mismatches(bad.cpu()))
            check(int(v) == want_v == 1, f"{layer} F({m},3): a flipped "
                  f"slab bit gave verdict {int(v)}, the plain count "
                  f"{want_v}")
            # bf16 x: the bf16 rule at the default tile
            y16 = entry(x16, w, b16, slab, m=m)
            want16 = entry(x16.float(), w, b16.float(), slab, m=m)
            torch.cuda.synchronize()
            check(torch.equal(y16.view(torch.int16),
                              want16.to(torch.bfloat16).view(torch.int16)),
                  f"{layer} F({m},3) bf16: not the f32 kernel on the "
                  "widened x rounded to bf16")
            (ms, host_ms), (plain_ms, _), (lib_ms, _) = (
                time_ms(torch, kern), time_ms(torch, plain),
                time_ms(torch, library))
            (ms16, _), (plain16, _), (lib16, _) = (
                time_ms(torch, lambda: kern(x16, b16)),
                time_ms(torch, lambda: plain(x16, b16)),
                time_ms(torch, library16))
            flops, nbytes = flops_bytes(kname, x, got, p, slab)
            flops16, nbytes16 = flops_bytes(kname, x16, y16, p, slab)
            bound, bound_by = _bound(flops, nbytes)
            bound16, _ = _bound(flops16, nbytes16)
            print(f"kernel {kname} {layer} F({m},3): n {m + 2}, T "
                  f"{winograd.num_tiles(p, BATCH)}, grid "
                  f"{winograd.gemm_grid(p, BATCH)} | max_abs_err {err:.3e} "
                  f"(max|plain| {scale:.3e}, rel {err / scale:.3e}; tol "
                  f"{tol:.3e} = max({TOL_KERNEL:g}, 3 e(m)), e(m) "
                  f"{e_m:.3e}) | tiles {tiles} bit-equal armed and unarmed,"
                  f" flip verdict 1 | f32 kernel_ms {ms:.4f} (host "
                  f"{host_ms:.4f}) plain_ms {plain_ms:.4f} library_ms"
                  f"(F.conv2d TF32 off) {lib_ms:.4f} bound_ms {bound:.4f} "
                  f"({bound_by} at F({m},3): {flops:.3e} flop, "
                  f"{nbytes:.3e} B) | bf16 x: "
                  f"rule bit-equal, kernel_ms {ms16:.4f} plain_ms "
                  f"{plain16:.4f} library_ms(bf16 F.conv2d) {lib16:.4f} "
                  f"bound_ms {bound16:.4f} | on {card}")
            add_layer(rows.setdefault(f"{kname} m={m}",
                                      new_row(f"{kname} m={m}")), layer,
                      max_abs_err=err, ms=ms, host_ms=host_ms,
                      plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                      bound_by=bound_by, flop=flops, bytes=nbytes,
                      e_m=e_m, tol=tol, tiles=[list(t) for t in tiles],
                      ms_bf16=ms16, plain_ms_bf16=plain16,
                      library_ms_bf16=lib16, bound_ms_bf16=bound16, m=m)
    return rows


def phase_dw1d_taps(torch, np):
    """3d (kernel 7): mamba2-2.7b's x stream, (1,200,5120) and
    (1,2048,5120) bf16, at r in DW1D_TAPS taps (the reference's m for
    each): the forward against its plain version, dx bit-equal to
    flip(kernel 7(flip(dy))) and within one bf16 step of its plain
    version, dw and db against theirs and two runs bit-equal; each timed
    beside its plain version, ``F.conv1d`` (its autograd backward for dx
    and wgrad) and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.conv import winograd as wino
    rng = np.random.default_rng(17)
    card = card_line()
    rows = {}
    for r in DW1D_TAPS:
        m = wino.dw1d_m(r)
        for B, L, C in ((1, 200, 5120), (1, 2048, 5120)):
            def dev(a, dt=torch.bfloat16):
                return torch.as_tensor(a, dtype=torch.float32,
                                       device="cuda").to(dt)
            x = dev(rng.standard_normal((B, L, C)))
            dy = dev(rng.standard_normal((B, L, C)))
            w = dev(rng.standard_normal((r, C)) * r ** -0.5, torch.float32)
            b = dev(rng.standard_normal((C,)) * 0.1, torch.float32)
            zero = torch.zeros((C,), device="cuda")
            y = wino.conv1d_depthwise_causal(x, w, b)
            dx = wino.conv1d_depthwise_causal_dx(dy, w)
            flip = wino.conv1d_depthwise_causal(dy.flip(1).contiguous(), w,
                                                zero).flip(1)
            dw, db = wino.conv1d_depthwise_causal_wgrad(x, dy, r)
            dw2, db2 = wino.conv1d_depthwise_causal_wgrad(x, dy, r)
            torch.cuda.synchronize()
            ex_y, err_y, max_y = _excess(
                y, wino.conv1d_depthwise_causal_plain(x, w, b), True)
            ex_x, err_x, max_x = _excess(
                dx, wino.conv1d_depthwise_causal_dx_plain(dy, w), True)
            pdw, pdb = wino.conv1d_depthwise_causal_wgrad_plain(x, dy, r)
            ex_w, err_w, max_w = _wgrad_excess(dw, pdw, False)
            ex_b, err_b, max_b = _wgrad_excess(db, pdb, True)
            tag = f"F({m},{r}) ({B},{L},{C}) bf16"
            check(torch.equal(dx, flip) and torch.equal(dw, dw2)
                  and torch.equal(db, db2),
                  f"dw1d {tag}: dx is not flip(kernel 7(flip(dy))) or two "
                  "wgrad runs differ")
            check(max(ex_y, ex_x, ex_w, ex_b) <= 0, f"dw1d {tag}: off its "
                  f"plain versions: y {ex_y}, dx {ex_x}, dw {ex_w}, db "
                  f"{ex_b}")
            xt = x.transpose(1, 2)
            wl = w.T[:, None, :].to(torch.bfloat16)
            bl = b.to(torch.bfloat16)

            def lib_fwd():
                with torch.backends.cudnn.flags(enabled=True,
                                                allow_tf32=False):
                    return F.conv1d(xt, wl, bl, padding=r - 1,
                                    groups=C)[..., :L]
            xg = xt.detach().requires_grad_(True)
            wg = wl.detach().requires_grad_(True)
            bg = bl.detach().requires_grad_(True)
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                yl = F.conv1d(xg, wg, bg, padding=r - 1, groups=C)[..., :L]
            gy = dy.transpose(1, 2)

            def lib_bwd():
                with torch.backends.cudnn.flags(enabled=True,
                                                allow_tf32=False):
                    return torch.autograd.grad(yl, (xg, wg, bg), gy,
                                               retain_graph=True)
            times = {
                "fwd": (time_ms(torch, lambda: wino.conv1d_depthwise_causal(
                    x, w, b))[0], time_ms(torch, lambda:
                    wino.conv1d_depthwise_causal_plain(x, w, b))[0],
                    time_ms(torch, lib_fwd)[0]),
                "dx": (time_ms(torch, lambda: wino.conv1d_depthwise_causal_dx(
                    dy, w))[0], time_ms(torch, lambda:
                    wino.conv1d_depthwise_causal_dx_plain(dy, w))[0], None),
                "wgrad": (time_ms(torch, lambda:
                          wino.conv1d_depthwise_causal_wgrad(x, dy, r))[0],
                          time_ms(torch, lambda:
                          wino.conv1d_depthwise_causal_wgrad_plain(
                              x, dy, r))[0], None)}
            lib_b = time_ms(torch, lib_bwd)[0]
            for kind, kname, err, scale in (
                    ("fwd", "dw1d", err_y, max_y),
                    ("dx", "dw1d_bwd", err_x, max_x),
                    ("wgrad", "dw1d_wgrad", max(err_w, err_b),
                     max(max_w, max_b))):
                ms, plain_ms, lib_ms = times[kind]
                lib_ms = lib_b if lib_ms is None else lib_ms
                lib = ("F.conv1d" if kind == "fwd" else
                       "F.conv1d autograd backward: dx, dw, db")
                flops, nbytes = (dw1d_work(B, L, C, 2, r) if kind == "fwd"
                                 else dw1d_bwd_work(B, L, C, 2, kind, r))
                bound, bound_by = _bound(flops, nbytes)
                print(f"kernel {kname} {tag}: max_abs_err {err:.3e} "
                      f"(max|plain| {scale:.3e})"
                      + (" | dx bit-equal to flip(kernel 7(flip(dy)))"
                         if kind == "dx" else "")
                      + (" | two runs bit-equal" if kind == "wgrad" else "")
                      + f" | kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
                      f"library_ms({lib}) {lib_ms:.4f} bound_ms "
                      f"{bound:.4f} ({bound_by}: {flops:.3e} flop, "
                      f"{nbytes:.3e} B) | on {card}")
                row = rows.setdefault(f"{kname} r={r}", {
                    "name": f"{kname} r={r}", "geometries": [],
                    "max_abs_err": 0.0})
                row["geometries"].append({
                    "B": B, "L": L, "C": C, "r": r, "m": m,
                    "dtype": "bfloat16", "max_abs_err": err,
                    "max_abs_plain": scale, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_ms": bound,
                    "bound_by": bound_by, "flop": flops, "bytes": nbytes})
                row["max_abs_err"] = max(row["max_abs_err"], err)
            del xg, wg, bg, yl
    for row in rows.values():
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"):
            row[key] = row["geometries"][0][key]
    return rows


def phase_mamba_taps(torch, np):
    """3d (the model): a reduced mamba2-2.7b with ``conv_kernel=3``
    (kernel 7 at F(4,3)): the card's greedy tokens through ``Engine``
    equal the CPU engine's, and one training loss and gradient on the
    kernel route (kernel 7 forward twice a layer with remat, its backward
    once) equal the plain route's within phase 9c's tolerances."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.conv.winograd import dw1d_m
    from repro_torch.models import lm
    base = get_config(SSM_ARCH).reduced()
    cfg = dataclasses.replace(base, remat=True, ssm=dataclasses.replace(
        base.ssm, conv_kernel=MAMBA_TAPS))
    reset_launch_counts()
    n = reduced_on_card(torch, np, SSM_ARCH, 3, cfg=cfg)
    served = launch_counts()
    check(served["dw1d"] > 0 and served["ssd"] > 0, f"reduced mamba at "
          f"{MAMBA_TAPS} taps: kernels 6 and 7 not launched: {served}")
    params = lm.init(torch.Generator(device="cuda").manual_seed(2), cfg,
                     device="cuda")
    batch = _train_batch(torch, np, cfg.vocab_size, 2, 40, seed=4)
    reset_launch_counts()
    loss_k, grads_k = _loss_and_grads(torch, params, cfg, batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    with plain_ssm_route():
        loss_p, grads_p = _loss_and_grads(torch, params, cfg, batch)
    L = cfg.num_layers
    check((counts["dw1d"], counts["dw1d_bwd"], counts["dw1d_wgrad"])
          == (2 * L, L, L), f"reduced mamba at {MAMBA_TAPS} taps: kernel 7 "
          f"launches in a training step {counts}")
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    worst = max(float((g - r).abs().max()) / max(float(r.abs().max()),
                                                 1e-30)
                for g, r in zip(grads_k, grads_p))
    check(rel <= TOL_TRAIN_LOSS and worst <= TOL_TRAIN_GRAD,
          f"reduced mamba at {MAMBA_TAPS} taps: kernel route vs plain "
          f"route loss rel {rel}, worst gradient {worst}")
    print(f"mamba {MAMBA_TAPS} taps (reduced, F({dw1d_m(MAMBA_TAPS)},"
          f"{MAMBA_TAPS})): {n} requests' card tokens = CPU tokens, kernels "
          f"6/7 launched {served['ssd']}/{served['dw1d']} | a training step"
          f": loss {float(loss_k):.6f} vs plain route {float(loss_p):.6f} "
          f"(rel {rel:.2e}, tol {TOL_TRAIN_LOSS:g}), worst gradient leaf "
          f"{worst:.2e} of its max|g| (tol {TOL_TRAIN_GRAD:g}), kernel 7 "
          f"{counts['dw1d']} forward, {counts['dw1d_bwd']} dx, "
          f"{counts['dw1d_wgrad']} wgrad | on {card_line()}")
    return {"requests": n, "serve_launches": served,
            "train_launches": counts, "loss_rel": rel,
            "worst_grad_rel": worst}


def phase_train_audio_vlm(torch, np, card):
    """9g: whisper-tiny at published widths (4 + 4 layers) and
    phi-3-vision-4.2b's widths cut to VLM_TRAIN_LAYERS layers through
    ``Trainer`` (f32 params, bf16 compute, remat) on batches with their
    frames (min(seq, 128) a row) or patches (576 x 1,024): whisper-tiny
    at 9e's schedule (lr 3e-3 after 2 warmup steps), phi-3-vision at
    TRAIN_VLM_SCHEDULE."""
    from repro_torch.configs import get_config
    whisper = train_through_trainer(torch, np, card, get_config(ENCDEC_ARCH),
                                    TRAIN_ENCDEC_SHAPE, falls=False,
                                    schedule=TRAIN_MOE_SCHEDULE)
    cut = dataclasses.replace(get_config(VLM_ARCH),
                              num_layers=VLM_TRAIN_LAYERS)
    phi3v = train_through_trainer(torch, np, card, cut, TRAIN_VLM_SHAPE,
                                  falls=False, schedule=TRAIN_VLM_SCHEDULE)
    return {"whisper": whisper, "phi3v": phi3v}


# --- phase 13: the analytic model against this run's measurements ----------
def _model_line(text, card):
    print(f"model: {text} | on {card}")


def model_alexnet(cfg, card, rows, serve):
    """13a-b: the roofline of each served f32 AlexNet conv layer at batch
    BATCH (the pallas route's traffic at the default plan's blocks, the
    weight prefetch on; the layer's datapath operations at the FP32 peak)
    beside phase 3's kernel; the served forward beside phase 4's batch."""
    from repro_torch.core.dse import ALEXNET_CONV, ALEXNET_FC
    from repro_torch.core.roofline import (ConvLayerRoofline,
                                           conv_layer_roofline,
                                           network_conv_roofline)
    from repro_torch.core.winograd import conv2d_hbm_bytes, conv_flops
    from repro_torch.models import alexnet
    from repro_torch.nn.conv import (MODEL_ROUTES, conv_out_hw, plan_knobs,
                                     resolve_kernel)
    knobs = plan_knobs()
    measured = {p["layer"]: (kname, p) for kname in
                ("conv_direct", "conv_winograd", "conv_winograd_fused")
                for p in rows[kname]["per_layer"]}
    h, c_in = cfg.image_size, cfg.in_channels
    convs, out = [], {"layers": []}
    for i, (spec, c_out) in enumerate(zip(alexnet.layer_specs(cfg),
                                          cfg.conv_channels)):
        name, spec = f"conv{i + 1}", spec.with_route("pallas")
        kernel = resolve_kernel(spec, in_hw=h)
        route, wino = MODEL_ROUTES[kernel]
        m = spec.winograd_m if wino else None
        hbm = conv2d_hbm_bytes(
            BATCH, h, h, c_in, c_out, spec.kernel, m, stride=spec.stride,
            padding=spec.padding, relu=spec.relu, fuse_lrn=spec.fuse_lrn,
            fuse_pool=spec.fuse_pool, pool_window=spec.pool_window,
            pool_stride=spec.pool_stride, groups=spec.groups, route=route,
            batch_block=knobs.batch_block, k_block=knobs.k_block,
            c_block=knobs.c_block, pool_row_block=knobs.pool_row_block,
            weight_prefetch=True, row_parallel=knobs.row_parallel)
        hw_out = conv_out_hw(h, spec.kernel, spec.stride, spec.padding)
        direct, wmadds = conv_flops(hw_out, hw_out, c_in // spec.groups,
                                    c_out, spec.kernel, m)
        lr = conv_layer_roofline(name, hbm, flops=2 * BATCH * (
            wmadds if wino else direct), hw=HW, dtype="float32")
        kname, p = measured[name]
        t_ms = max(lr.t_compute, lr.t_memory) * 1e3
        if p["bound_by"] == "operations":
            check(abs(lr.t_compute * 1e3 - p["bound_ms"])
                  <= 1e-9 * p["bound_ms"], f"model {name}: t_compute "
                  f"{lr.t_compute * 1e3} ms is not phase 3's operation "
                  f"bound {p['bound_ms']} ms")
        check(p["ms"] >= t_ms, f"model {name}: kernel_ms {p['ms']} is "
              f"under the model's {t_ms} ms: the model or its count is "
              "wrong")
        _model_line(
            f"{name} ({kname}, {kernel}, route {route}"
            f"{f', F({m},3)' if wino else ''}) batch {BATCH}: t_compute "
            f"{lr.t_compute * 1e3:.4f} ms ({lr.flops:.4e} flop at FP32 "
            f"peak), t_memory {lr.t_memory * 1e3:.4f} ms "
            f"({lr.exposed_bytes:.4e} B exposed of {lr.total_bytes:.4e}), "
            f"{lr.bound}-bound "
            f"{t_ms:.4f} ms | phase 3: bound_ms {p['bound_ms']:.4f} "
            f"({p['bound_by']}), kernel_ms {p['ms']:.4f} | kernel_ms / "
            f"model {p['ms'] / t_ms:.3f}", card)
        out["layers"].append(lr.to_json() | {
            "kernel": kname, "datapath": kernel, "kernel_ms": p["ms"],
            "phase3_bound_ms": p["bound_ms"], "model_ms": t_ms,
            "kernel_over_model": p["ms"] / t_ms})
        convs.append(lr)
        h, c_in = spec.out_hw(h), c_out
    fcs = [ConvLayerRoofline(
        name, flops=2 * BATCH * k_in * k_out,
        feature_bytes=4 * BATCH * (k_in + k_out),
        weight_bytes=4 * k_in * k_out + 4 * k_out,
        weight_exposed_bytes=4 * k_in * k_out + 4 * k_out, hw=HW,
        dtype="float32")
        for name, k_in, k_out in zip(
            ("fc6", "fc7", "fc8"),
            (alexnet.fc_input_dim(cfg), *cfg.fc_dims[:-1]), cfg.fc_dims)]
    net_conv = network_conv_roofline(convs, hw=HW, dtype="float32")
    net = network_conv_roofline(convs + fcs, hw=HW, dtype="float32")
    conv_ms = max(net_conv["t_compute"], net_conv["t_memory"]) * 1e3
    fwd_ms = max(net["t_compute"], net["t_memory"]) * 1e3
    busy = serve["batch_device_busy_ms"]
    conv_dev = (None if busy is None else serve["batch_conv_direct_ms"]
                + serve["batch_conv_winograd_ms"])
    if busy is not None:
        check(conv_dev >= conv_ms and busy >= fwd_ms, f"model forward: the "
              f"traced batch's conv kernels {conv_dev} ms or device busy "
              f"{busy} ms under the model's {conv_ms} / {fwd_ms} ms")
    # the paper's count of a forward: direct multiply-adds x 2 an image
    ops_img = 2 * (sum(k * (c // g) * p * q * r * s_
                       for _, c, k, p, q, r, s_, _, g in ALEXNET_CONV)
                   + sum(c * k for _, c, k in ALEXNET_FC))
    share = ops_img * serve["imgs_per_s"] / HW.peak("float32")
    check(0 < share <= 1, f"model forward: served share {share} of the "
          "FP32 peak not in (0, 1]")
    dev = ("not measured (no device events)" if busy is None else
           f"conv kernels {conv_dev:.4f} ms ({conv_dev / conv_ms:.3f}x), "
           f"device busy {busy:.4f} ms ({busy / fwd_ms:.3f}x)")
    _model_line(
        f"served f32 AlexNet forward, batch {BATCH}: conv1-5 "
        f"{net_conv['flops']:.4e} flop on their datapaths, {conv_ms:.4f} ms "
        f"({net_conv['bound']}); + fc6-8 {net['flops']:.4e} flop, "
        f"{net['feature_bytes'] + net['weight_exposed_bytes']:.4e} B, "
        f"{fwd_ms:.4f} ms ({net['bound']}) | phase 4's traced batch: {dev}, "
        f"wall {serve['batch_wall_ms']:.3f} ms | {ops_img:.4e} flop an image "
        f"(direct count) x {serve['imgs_per_s']:.2f} img/s = "
        f"{share:.5f} of the FP32 peak", card)
    out.update(conv=net_conv | {"model_ms": conv_ms, "device_ms": conv_dev},
               forward=net | {"model_ms": fwd_ms, "device_busy_ms": busy,
                              "batch_wall_ms": serve["batch_wall_ms"]},
               flop_per_image=ops_img, imgs_per_s=serve["imgs_per_s"],
               share_of_fp32_peak=share)
    return out


def model_decode(card, arch, run):
    """13c: ``dse.lm_cost`` of one decode step of ``arch`` at the served
    batch and max_len on one card (all its parameters streamed at the
    param dtype's bytes, the whole cache in bf16) beside the served
    step's device ms (a traced step) and host ms."""
    from repro_torch.configs import get_config
    from repro_torch.core.dse import ModelInput, lm_cost
    from repro_torch.core.roofline import (active_param_count,
                                           total_param_count)
    cfg = get_config(arch)
    itemsize = {"float32": 4, "bfloat16": 2}
    cache_tok = (2 * cfg.num_layers * cfg.num_kv_heads * cfg.d_head
                 * itemsize[cfg.dtype])
    inp = ModelInput(n_active=active_param_count(cfg),
                     n_total=total_param_count(cfg), seq_len=run["max_len"],
                     global_batch=BATCH, kind="decode", d_model=cfg.d_model,
                     num_layers=cfg.num_layers,
                     cache_bytes_per_token=cache_tok)
    cost = lm_cost(inp, data=1, model=1,
                   dtype_bytes=itemsize[cfg.param_dtype], hw=HW)
    t_ms = cost["step_time"] * 1e3
    busy, host = run["device_busy_ms_per_step"], run["step_ms"]
    # without device events in the trace the host's step time is the floor
    # held (it is never under the device's)
    held = host if busy is None else busy
    check(held >= t_ms, f"model decode {arch}: {held} ms a step is under "
          f"the model's {t_ms} ms")
    _model_line(
        f"decode {arch} batch {BATCH}, max_len {run['max_len']} "
        f"({cfg.param_dtype} params {inp.n_total:.4e} of them, "
        f"{inp.n_active:.4e} active; cache {cache_tok} B a token): "
        f"t_compute {cost['t_compute'] * 1e3:.4f} ms, t_memory "
        f"{cost['t_memory'] * 1e3:.4f} ms, {cost['bound']}-bound "
        f"{t_ms:.4f} ms | served step: device "
        + ("not measured" if busy is None else
           f"{busy:.3f} ms ({busy / t_ms:.2f}x)")
        + f", host {host:.3f} ms ({host / t_ms:.2f}x)", card)
    return cost | {"arch": arch, "n_active": inp.n_active,
                   "n_total": inp.n_total, "cache_bytes_per_token": cache_tok,
                   "model_ms": t_ms, "device_ms": busy, "host_ms": host}


def model_train(card, rep):
    """13d: ``model_flops_estimate`` of smollm-360m's phase-9 step as a
    share of the bf16 peak over its host-clock and device busy ms."""
    from repro_torch.config import ShapeCfg
    from repro_torch.configs import get_config
    from repro_torch.core.roofline import model_flops_estimate
    B, S, _ = TRAIN_DENSE_SHAPE
    flops = model_flops_estimate(get_config(TRAIN_DENSE_ARCH),
                                 ShapeCfg("phase9", S, B, "train"))
    shares = {}
    for key, ms in (("host", rep["step_ms"]), ("device", rep["device_busy_ms"])):
        share = None if ms is None else flops / (HW.peak("bfloat16") * ms
                                                 / 1e3)
        check(share is None or (math.isfinite(share) and 0 < share <= 1),
              f"model train: {key} share {share} of the bf16 peak not in "
              "(0, 1]")
        shares[key] = share
    _model_line(
        f"train {TRAIN_DENSE_ARCH} {B} x {S}: 6 N D = {flops:.4e} flop a "
        f"step | host {rep['step_ms']:.2f} ms -> {shares['host']:.5f} of the "
        f"bf16 peak; device busy "
        + ("not measured" if shares["device"] is None else
           f"{rep['device_busy_ms']:.2f} ms -> {shares['device']:.5f}"), card)
    return {"arch": TRAIN_DENSE_ARCH, "flops": flops,
            "host_ms": rep["step_ms"], "device_ms": rep["device_busy_ms"],
            "share_of_bf16_peak_host": shares["host"],
            "share_of_bf16_peak_device": shares["device"]}


def phase_model(cfg, card, rows, serve, lm_serve, granite, train_dense):
    """13: the analytic model against this run's numbers; no launch."""
    t0 = time.perf_counter()
    out = {"alexnet": model_alexnet(cfg, card, rows, serve),
           "decode": {LM_ARCH: model_decode(card, LM_ARCH, lm_serve),
                      MOE_ARCH: model_decode(card, MOE_ARCH, granite)},
           "train": model_train(card, train_dense)}
    out["phase_s"] = time.perf_counter() - t0
    print(f"model: phase 13 {out['phase_s']:.3f} s")
    return out


def _digest(torch, t) -> str:
    """The first 16 hex digits of sha256 over ``t``'s bytes."""
    import hashlib
    t = t.detach().contiguous().cpu()
    return hashlib.sha256(t.view(-1).view(torch.uint8).numpy()
                          .tobytes()).hexdigest()[:16]


def dump_bits(torch, np, path) -> int:
    """``--bits OUT``: every output of kernels 1-5 and 7 at the main path's
    shapes hashed, and each kernel's device time, into the JSON file OUT.
    Run from another tree (a copy of this script beside its ``src``), it
    holds that tree's kernels to this one's with ``--compare-bits``.
    Cases: AlexNet conv1-conv5 at batch 8 (``layer_cases``) in f32 and
    bf16 at every block tile of the route their slab takes, armed and
    unarmed; fc6-fc8 (f32 x); kernel 5 (without its lse) at every
    phase-5 decode geometry in f32 and bf16;
    kernel 7's forward, dx and wgrad at mamba2-2.7b's (1,200,5120) and
    (1,2048,5120) bf16 and (1,512,5120) f32."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.bfp_matmul import bfp_matmul as bfp
    from repro_torch.kernels.bfp_matmul.ops import quantize_weights
    from repro_torch.kernels.conv import direct, winograd
    from repro_torch.models import alexnet
    from repro_torch.nn.conv import pack_conv_weights
    hashes, times = {}, {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_config("alexnet"), use_pallas=True,
                                  dtype=dtype)
        params = alexnet.init(0, cfg, device="cuda")
        for kname, layer, spec, x, w, b, slab, plan in layer_cases(
                torch, np, cfg, params):
            mod = direct if kname == "conv_direct" else winograd
            entry = conv_entry(kname, spec)
            armed = pack_conv_weights(spec, tuple(x.shape), w,
                                      abft=True).data
            mma = mod is direct and direct.mma_route(slab.dtype)
            for tile in direct.MMA_TILES if mma else mod.TILES:
                if not mma and tile not in mod.ANY_SLAB_TILES \
                        and plan.Kb % 4:
                    continue
                kw = dict(tile_rows=tile[0], tile_cols=tile[1])
                key = f"{layer} {dtype} {tile[0]}x{tile[1]}"
                hashes[key] = _digest(torch, entry(x, w, b, slab, **kw))
                y, v = entry(x, w, b, armed, checksum=True, **kw)
                hashes[f"{key} armed"] = f"{_digest(torch, y)} v{int(v)}"
            times[f"{layer} {dtype}"] = time_ms(
                torch, lambda: entry(x, w, b, slab))[0]
    rng = np.random.default_rng(27)

    def dev(shape, scale=1.0, dt=torch.float32):
        return torch.as_tensor(rng.standard_normal(shape) * scale,
                               dtype=torch.float32, device="cuda").to(dt)
    x = dev((BATCH, 9216))
    for name, (K, N) in (("fc6", (9216, 4096)), ("fc7", (4096, 4096)),
                         ("fc8", (4096, 1000))):
        wq, we = quantize_weights(dev((K, N), K ** -0.5), block=32)
        xk = x[:, :K].contiguous()
        hashes[name] = _digest(torch, bfp.bfp_matmul(xk, wq, we, block=32))
        times[name] = time_ms(
            torch, lambda: bfp.bfp_matmul(xk, wq, we, block=32))[0]
    from repro_torch.kernels.decode_attn import decode_attn as dec
    for name, B, S, H, KV, D, fixed in DECODE_GEOMETRIES:
        lens = torch.as_tensor(rng.integers(1, S + 1, B) if fixed is None
                               else fixed, dtype=torch.int32, device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (dev(shape, dt=dt) for shape in (
                (B, 1, H, D), (B, S, KV, D), (B, S, KV, D)))
            tag = f"decode_attn {name} {str(dt)[6:]}"
            hashes[tag] = _digest(torch, dec.decode_attention(q, k, v, lens))
            times[tag] = time_ms(
                torch, lambda: dec.decode_attention(q, k, v, lens))[0]
    for B, L, C, dt in ((1, 200, 5120, torch.bfloat16),
                        (1, 2048, 5120, torch.bfloat16),
                        (1, 512, 5120, torch.float32)):
        x, dy = dev((B, L, C), dt=dt), dev((B, L, C), dt=dt)
        w, b = dev((4, C), 0.5), dev((C,), 0.1)
        tag = f"({B},{L},{C}) {str(dt)[6:]}"
        calls = {
            "dw1d": lambda: winograd.conv1d_depthwise_causal(x, w, b),
            "dw1d_bwd": lambda: winograd.conv1d_depthwise_causal_dx(dy, w),
            "dw1d_wgrad": lambda: winograd.conv1d_depthwise_causal_wgrad(
                x, dy, 4)}
        for kname, fn in calls.items():
            out = fn()
            hashes[f"{kname} {tag}"] = "".join(
                _digest(torch, t) for t in (out if isinstance(out, tuple)
                                            else (out,)))
            times[f"{kname} {tag}"] = time_ms(torch, fn)[0]
    torch.cuda.synchronize()
    card = card_line()
    with open(path, "w") as f:
        json.dump({"card": card, "hashes": hashes, "times_ms": times}, f,
                  indent=1)
    print(f"bits: {len(hashes)} outputs, {len(times)} timings -> {path} | "
          f"on {card}")
    return 0


def compare_bits(paths) -> int:
    """``--compare-bits A B [B A ...]``: ``--bits`` files of two trees run
    in turns in one call (A, B, B, A, ...).  Every output of the first file
    must have the second's hash; each timing prints in every file with the
    ratio of the B side's median to the A side's (one stray sample does
    not move it).  Exits 1 on a mismatch."""
    import statistics
    runs = [json.load(open(p)) for p in paths]
    a, b = runs[0], runs[1]
    bad = [k for k in a["hashes"] if a["hashes"][k] != b["hashes"].get(k)]
    print(f"bits: {len(a['hashes']) - len(bad)}/{len(a['hashes'])} outputs "
          f"bit-equal ({paths[0]} vs {paths[1]}) | on {a['card']}")
    for k in bad:
        print(f"  DIFFERS: {k}: {a['hashes'][k]} vs {b['hashes'].get(k)}")
    side_a = [r for i, r in enumerate(runs) if i % 4 in (0, 3)]
    side_b = [r for i, r in enumerate(runs) if i % 4 in (1, 2)]
    for k in a["times_ms"]:
        ta = [r["times_ms"][k] for r in side_a]
        tb = [r["times_ms"][k] for r in side_b if k in r["times_ms"]]
        print(f"  {k}: A {' / '.join(f'{t:.4f}' for t in ta)} ms, B "
              f"{' / '.join(f'{t:.4f}' for t in tb)} ms, B/A "
              f"{statistics.median(tb) / statistics.median(ta):.4f}")
    return 1 if bad else 0


def summary(row):
    """A kernel row's numbers for the ``kernels`` line (``bound_by`` its
    layers' when they agree, else ``mixed``)."""
    return {k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "library_ms", "layers")} | {
        "bound_by": ("operations" if all(
            p["bound_by"] == "operations" for p in row["per_layer"])
            else "bytes" if all(p["bound_by"] == "bytes"
                                for p in row["per_layer"]) else "mixed")}


# ---------------------------------------------------------------------------
# phase 15: the dry run
# ---------------------------------------------------------------------------
DRYRUN_CELLS = (
    ("smollm-360m", "train_4k", ["--mesh", "single"]),
    ("smollm-360m", "train_4k", ["--mesh", "single", "--fsdp"]),
    ("mamba2-2.7b", "decode_32k", ["--mesh", "multi"]),
    ("jamba-v0.1-52b", "decode_32k", ["--mesh", "single", "--serve-dtype",
                                      "bfp8"]),
)
DRYRUN_TIMEOUT = 300
# 15b's steps: the served engines' batch and length, phase 9's training
# length
DRYRUN_BATCH = 8
DRYRUN_LEN = 512
DRYRUN_TRAIN_SEQ = 256
# the counted peak over the arguments against the card's over the step's
# start
TOL_DRYRUN_PEAK = 0.10
# the kernels whose meta branches 15b holds against the card's launches
DRYRUN_KERNELS = {"decode_attn", "ssd", "dw1d", "dw1d_bwd", "dw1d_wgrad"}


def phase_dryrun_cli():
    """15a: ``python -m repro_torch.launch.dryrun`` for four cells (one
    under ``--fsdp``), each in its own process (a fake world of 256 or 512 ranks on meta tensors,
    no card), all at once: every record ``ok``."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for i, (arch, shape, extra) in enumerate(DRYRUN_CELLS):
            out = os.path.join(tmp, f"{i}_{arch}_{shape}.jsonl")
            procs.append((out, "--fsdp" in extra, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--out", out, *extra],
                cwd=tmp, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        recs = []
        try:
            for out, fsdp, p in procs:
                log, _ = p.communicate(timeout=DRYRUN_TIMEOUT)
                for line in log.splitlines():
                    if line.startswith("["):
                        print("dryrun:", line.strip())
                check(p.returncode == 0,
                      f"dryrun cli: exit {p.returncode}: {log[-2000:]}")
                with open(out) as f:
                    recs += [dict(json.loads(line), fsdp=fsdp)
                             for line in f]
        finally:
            for _, _, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for r in recs:
        check(r["status"] == "ok", f"dryrun {r['arch']} {r['shape']}: "
              f"{r['status']}: {r.get('error')}")
        t, mem = r["roofline"], r["memory"]
        print(f"dryrun: {r['arch']} {r['shape']} {r['mesh']} "
              f"serve_dtype {r['serve_dtype']}"
              f"{' --fsdp' if r['fsdp'] else ''}: t_count_s {r['t_count_s']} "
              f"ops {r['ops']} launches {r['launches']} | modelled "
              f"(H100_SXM data sheet at 700 W, counted on meta, no card "
              f"time): step {t['step_time'] * 1e3:.2f} ms, bound "
              f"{t['bound']}, useful_flops_ratio "
              f"{t['useful_flops_ratio']:.4f}, per-rank memory "
              f"{(mem['argument_size'] + mem['temp_size']) / 2 ** 30:.2f}"
              " GiB")
    return recs


def _dryrun_steps(torch):
    """15b's steps: (label, cfg, shape, step, meta arguments, card
    arguments from a generator on the card)."""
    from repro_torch.config import ShapeCfg
    from repro_torch.configs import get_config
    from repro_torch.launch import specs as sp
    from repro_torch.models import lm
    from repro_torch.nn.module import tree_map
    from repro_torch.optim import init_state

    def serve(arch, kind):
        cfg = get_config(arch)
        shape = ShapeCfg(kind, DRYRUN_LEN, DRYRUN_BATCH, kind)
        step = (sp.make_decode_step(cfg, shape) if kind == "decode"
                else sp.make_prefill_step(cfg))
        S = 1 if kind == "decode" else DRYRUN_LEN

        def args(dev, gen=None):
            params = lm.init(gen if dev == "cuda" else 0, cfg, device=dev)
            tokens = (torch.randint(0, cfg.vocab_size, (DRYRUN_BATCH, S),
                                    generator=gen, device=dev,
                                    dtype=torch.int32) if dev == "cuda"
                      else torch.empty((DRYRUN_BATCH, S), dtype=torch.int32,
                                       device=dev))
            return (params, {"tokens": tokens},
                    lm.cache_init(cfg, DRYRUN_BATCH, DRYRUN_LEN, device=dev))
        return (f"{arch} {kind} {DRYRUN_BATCH} x {DRYRUN_LEN}", cfg, shape,
                step, args)

    def train(arch, B=DRYRUN_BATCH, S=DRYRUN_TRAIN_SEQ, layers=None):
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        shape = ShapeCfg("train", S, B, "train")
        step = sp.make_train_step(cfg)

        def args(dev, gen=None):
            if dev == "meta":
                state = sp.state_specs(cfg)
            else:
                state = init_state(lm.init(gen, cfg, device=dev))
            batch = tree_map(
                lambda t: (torch.randint(0, cfg.vocab_size, tuple(t.shape),
                                         generator=gen, device=dev,
                                         dtype=t.dtype)
                           if dev == "cuda" else t),
                sp.batch_specs(cfg, shape))
            return state, batch
        cut = "" if layers is None else f" at {layers} layers"
        return (f"{arch} train {B} x {S}{cut}", cfg, shape, step, args)

    # mamba2-2.7b's train step at phase 14's size: kernel 7's forward, dx
    # and wgrad on the main path's shapes
    B, S, _ = MESH_SSM_SHAPE
    return [serve("smollm-360m", "decode"), serve("mamba2-2.7b", "decode"),
            serve("mamba2-2.7b", "prefill"), train("smollm-360m"),
            train("mamba2-2.7b", B, S, MESH_SSM_LAYERS)]


def phase_dryrun_card(torch, card):
    """15b: each step counted on meta (``launch/dryrun.py::count_step``),
    then run on the card from a seed (once to warm, once measured):
    launches by kernel equal to ``launch_counts()``, the counted peak over
    the arguments within 10% of ``max_memory_allocated()`` over the step's
    start, and the modelled step time beside the step's device ms."""
    from repro_torch.core import roofline as rl
    from repro_torch.launch.dryrun import count_step
    rows = []
    for label, cfg, shape, step, args in _dryrun_steps(torch):
        meta_args = args("meta")
        counter, _, memory = count_step(
            step, *meta_args,
            outputs=(lambda a, r: (a[0], r)) if shape.kind == "train"
            else None)
        terms = rl.from_counted(counter, arch=cfg.name, shape=label,
                                mesh="1", chips=1,
                                model_flops=rl.model_flops_estimate(
                                    cfg, shape), memory=memory)
        del meta_args
        gen = torch.Generator(device="cuda").manual_seed(0)
        card_args = args("cuda", gen)
        step(*card_args)                     # warm: workspaces, tickets
        torch.cuda.synchronize()
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        step(*card_args)
        t1.record()
        torch.cuda.synchronize()
        device_ms = t0.elapsed_time(t1)
        peak = torch.cuda.max_memory_allocated() - start
        launched = {k: v for k, v in launch_counts().items() if v}
        counted = dict(counter.launches)
        temp = memory["temp_size"]
        err = abs(temp - peak) / max(peak, 1)
        ratio = device_ms / (terms.step_time * 1e3)
        print(f"dryrun: {label}: launches counted {counted} card "
              f"{launched} | peak over the start counted "
              f"{temp / 2 ** 20:.2f} MiB card {peak / 2 ** 20:.2f} MiB "
              f"(off {err:.4f}) | modelled step {terms.step_time * 1e3:.4f} "
              f"ms bound {terms.bound} (H100_SXM data sheet at 700 W, "
              f"counted on meta) vs device {device_ms:.4f} ms: ratio "
              f"{ratio:.3f} | on {card}")
        check(counted == launched, f"dryrun {label}: counted launches "
              f"{counted} != the card's {launched}")
        check(err <= TOL_DRYRUN_PEAK, f"dryrun {label}: counted peak "
              f"{temp} B vs the card's {peak} B (off {err:.4f})")
        rows.append({"step": label, "launches": counted,
                     "card_launches": launched, "counted_peak_bytes": temp,
                     "card_peak_bytes": peak, "peak_off": err,
                     "device_ms": device_ms,
                     "modelled_step_ms": terms.step_time * 1e3,
                     "modelled_bound": terms.bound, "ratio": ratio,
                     "ops": counter.ops, "memory": memory,
                     "roofline": terms.to_json()})
        del card_args
        torch.cuda.empty_cache()
    seen = set().union(*(r["launches"] for r in rows))
    check(DRYRUN_KERNELS <= seen, f"dryrun: kernels never counted against "
          f"the card: {sorted(DRYRUN_KERNELS - seen)}")
    return rows


def phase_dryrun(torch, card):
    """15: the dry run (15a on the host, 15b against the card)."""
    t0 = time.perf_counter()
    cells = phase_dryrun_cli()
    steps = phase_dryrun_card(torch, card)
    took = time.perf_counter() - t0
    print(f"dryrun: phase 15 {took:.1f} s")
    return {"cells": cells, "steps": steps, "phase_s": took}


# 17. cnn-train: (batch, warm-up steps, timed steps) at full width on route
# winograd, f32; Krizhevsky's batch for AlexNet
CNN_TRAIN_SHAPES = {"alexnet": (128, 2, 5), "vgg16": (16, 1, 2)}
CNN_TRAIN_LR = 1e-4
# route winograd's gradients against route direct's (both f32, summed in
# different orders): each conv layer's dx, dw, db <= this * its max
TOL_CNN_GRAD = 1e-3
# and one step's gradients through loss_fn: <= this * each leaf's norm
# (read 1.1e-4 to 2.8e-3 for AlexNet, up to 7.8e-3 for VGG-16 on 16
# batches: ReLU and pool choices flip between the routes)
TOL_CNN_STEP = 3e-2
# the configs whose forward has no gradient, and the word each error names
CNN_NO_GRAD = {"pallas": ({"use_pallas": True}, "route 'pallas'"),
               "fc_bfp": ({"fc_bfp": True}, "fc_bfp"),
               "sdc_abft": ({"sdc_abft": True}, "sdc_abft")}
# the example twins phase 17 runs in this process: (file, argv, the
# kernels whose launches it must reach)
CNN_EXAMPLES = (
    ("serve_batch_torch", ["--arch", "alexnet", "--route", "pallas"],
     ("conv_direct", "conv_winograd", "conv_winograd_fused")),
    ("serve_batch_torch", ["--arch", "smollm-360m"], ("decode_attn",)),
    ("quickstart_torch", [], ()),
    ("alexnet_winograd_torch", [], ()))


def _cnn_batches(torch, cfg, B, steps, seed=0):
    from repro_torch.data.pipeline import synthetic_images
    return [{"images": torch.from_numpy(b["images"]).to("cuda"),
             "labels": torch.from_numpy(b["labels"]).long().to("cuda")}
            for b in synthetic_images(batch=B, image_size=cfg.image_size,
                                      num_classes=cfg.num_classes,
                                      seed=seed, steps=steps)]


def _cnn_grads(torch, params, cfg, batch):
    from repro_torch.models import alexnet
    from repro_torch.nn.module import tree_leaves
    leaves = tree_leaves(params)
    loss, aux = alexnet.loss_fn(params, cfg, batch)
    return loss, aux, torch.autograd.grad(loss, leaves)


def cnn_train_run(torch, card, arch, dtype="float32", shape=None, *,
                  full=True):
    """``arch`` at full width, random weights from a seed, trained on
    route winograd with AdamW on ``synthetic_images``: step ms (host,
    after a synchronize) and img/s over the timed steps, peak memory,
    finite losses; with ``full``: the loss on step 0's batch lower after
    the run than before it, one step traced (device busy ms, idle share,
    top device ops) and one step's gradients on route winograd held to
    route direct's."""
    from repro_torch.configs import get_config
    from repro_torch.models import alexnet
    from repro_torch.nn.module import count_params, tree_leaves
    from repro_torch.optim import adamw_step, init_state
    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    check(alexnet._route(cfg) == "winograd", f"cnn-train {arch}: route "
          f"{alexnet._route(cfg)}, not winograd")
    B, warm, timed = shape or CNN_TRAIN_SHAPES[arch]
    batches = _cnn_batches(torch, cfg, B, warm + timed)
    state = init_state(alexnet.init(0, cfg, device="cuda"))
    leaves = tree_leaves(state["params"])
    for p in leaves:
        p.requires_grad_()
    n_params = count_params(state["params"])

    def held_loss():
        with torch.no_grad():
            return alexnet.loss_fn(state["params"], cfg, batches[0])[0].item()

    def step(batch):
        loss, _, grads = _cnn_grads(torch, state["params"], cfg, batch)
        adamw_step(state, grads, lr=CNN_TRAIN_LR)
        return loss.detach()

    before = held_loss()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, dts = [], []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        loss = step(batch)
        torch.cuda.synchronize()
        if i >= warm:
            dts.append(time.perf_counter() - t0)
        losses.append(loss.item())
    peak = torch.cuda.max_memory_allocated()
    launches = launch_counts()
    after = held_loss()
    check(all(math.isfinite(x) for x in losses), f"cnn-train {arch} "
          f"{dtype}: a non-finite loss {losses}")
    check(not any(launches.values()), f"cnn-train {arch}: route winograd "
          f"launched a port kernel {launches}")
    check(not full or after < before, f"cnn-train {arch} {dtype}: the "
          f"loss on step 0's "
          f"batch did not fall over {len(batches)} steps ({before} -> "
          f"{after})")
    step_ms = statistics.median(dts) * 1e3
    rep = {"arch": arch, "dtype": dtype, "batch": B,
           "image_size": cfg.image_size, "params": n_params,
           "warmup_steps": warm, "timed_steps": timed, "losses": losses,
           "held_loss_before": before, "held_loss_after": after,
           "step_ms": step_ms, "step_ms_all": [d * 1e3 for d in dts],
           "imgs_per_s": B / step_ms * 1e3, "peak_mem_bytes": peak,
           "launches": launches}
    line = (f"cnn-train {arch} ({dtype}, {n_params / 1e6:.1f} M params, "
            f"{cfg.image_size} px, batch {B}, route winograd, lr "
            f"{CNN_TRAIN_LR}): {warm} + {timed} steps, loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}, on step 0's batch "
            f"{before:.4f} -> {after:.4f} | step {step_ms:.2f} ms median "
            f"({', '.join(f'{d * 1e3:.2f}' for d in dts)}), "
            f"{rep['imgs_per_s']:.1f} img/s | peak mem "
            f"{peak / 2 ** 30:.2f} GiB")
    if full:
        marks = ("cudnn", "dgrad", "wgrad", "gemm", "elementwise",
                 "unfold", "reduce")
        wall, busy, events, by_mark, top = profile_decode(
            torch, lambda: step(batches[-1]), steps=1, marks=marks)
        rep.update(traced_wall_ms=wall, device_busy_ms=busy,
                   device_events=events, device_ms_by_mark=by_mark, top=top,
                   idle_share=None if busy is None else 1.0 - busy / wall)
        line += (f" | traced step: {wall:.2f} ms wall, "
                 + ("device busy not measured (no device events)"
                    if busy is None else
                    f"device busy {busy:.2f} ms in {events:.0f} events, "
                    f"idle share {1.0 - busy / wall:.4f}, by name: "
                    + ", ".join(f"{m} {by_mark[m]:.2f}" for m in marks)
                    + " ms | top: "
                    + "; ".join(f"{n} {ms:.3f} ms" for n, ms in top)))
        rep["grad_check"] = cnn_grad_check(torch, state["params"], cfg,
                                           batches[0])
        g = rep["grad_check"]
        line += (f" | gradients winograd vs direct on all {g['batch']} "
                 f"images: each conv's backward, worst {g['worst_layer']} "
                 f"{g['layer_max_rel_err']:.3e} of its max (<= "
                 f"{TOL_CNN_GRAD}); one step through loss_fn, worst leaf "
                 f"{g['worst_leaf']} {g['step_l2_rel_err']:.3e} of its "
                 f"norm (<= {TOL_CNN_STEP}), largest difference "
                 f"{g['step_max_rel_err']:.3e} of a leaf's max|g|; route "
                 f"direct against itself {g['direct_twice_l2_rel_err']:.3e} "
                 f"of a leaf's norm")
    print(line + f" | on {card}")
    del state, leaves, batches
    torch.cuda.empty_cache()
    return rep


def cnn_grad_check(torch, params, cfg, batch):
    """Route winograd's gradients against route direct's on the whole
    batch.  Each conv layer's backward (dx, dw, db) at the layer's input
    from route direct's forward and a seeded gradient of its output:
    within TOL_CNN_GRAD of each one's max.  One step's gradients through
    ``loss_fn``: each leaf's difference within TOL_CNN_STEP of its norm;
    there a ReLU input or a pool window's runner-up within rounding of
    the winner lands on the other side in the two forwards, and route
    direct's own backward (cuDNN) moves a bias gradient summed over the
    batch between two runs (reported: route direct against itself)."""
    from repro_torch.models import alexnet
    from repro_torch.nn.conv import dispatch_conv
    x = batch["images"].to(torch.float32)
    gen = torch.Generator(device=x.device).manual_seed(0)
    layers = {}
    for i, spec in enumerate(alexnet.layer_specs(cfg)):
        name, p = f"conv{i + 1}", params[f"conv{i + 1}"]
        bare = dataclasses.replace(spec, relu=False, fuse_lrn=False,
                                   fuse_pool=False)
        xi, g, got = x.detach().requires_grad_(), None, []
        for route in ("winograd", "direct"):
            y = dispatch_conv(bare.with_route(route), xi, p["w"], p["b"])
            if g is None:
                g = torch.randn(y.shape, device=y.device, generator=gen)
            got.append(torch.autograd.grad(y, (xi, p["w"], p["b"]), g))
        layers[name] = [float((a - b).abs().max() / b.abs().max())
                        for a, b in zip(*got)]
        check(max(layers[name]) <= TOL_CNN_GRAD, f"cnn-train {cfg.name}: "
              f"{name}'s backward (dx, dw, db) on route winograd is "
              f"{layers[name]} of its max off route direct's")
        with torch.no_grad():
            x = dispatch_conv(spec.with_route("direct"), x, p["w"], p["b"])
    direct = dataclasses.replace(cfg, use_winograd=False)
    _, _, gw = _cnn_grads(torch, params, cfg, batch)
    _, _, gd = _cnn_grads(torch, params, direct, batch)
    _, _, gd2 = _cnn_grads(torch, params, direct, batch)
    names = [f"{layer}.{k}" for layer in params for k in params[layer]]
    step, again = {}, 0.0
    for name, a, b, b2 in zip(names, gw, gd, gd2):
        check(bool(torch.isfinite(a).all()) and float(b.norm()) > 0,
              f"cnn-train {cfg.name}: gradient of {name} zero or non-finite")
        step[name] = (float((a - b).norm() / b.norm()),
                      float((a - b).abs().max() / b.abs().max()))
        again = max(again, float((b2 - b).norm() / b.norm()))
    worst = max(step, key=lambda n: step[n][0])
    check(step[worst][0] <= TOL_CNN_STEP, f"cnn-train {cfg.name}: one "
          f"step's gradient of {worst} on route winograd is "
          f"{step[worst][0]:.3e} of its norm off route direct's")
    worst_layer = max(layers, key=lambda n: max(layers[n]))
    return {"batch": len(batch["labels"]), "layers": layers,
            "layer_max_rel_err": max(layers[worst_layer]),
            "worst_layer": worst_layer, "step": step, "worst_leaf": worst,
            "step_l2_rel_err": step[worst][0],
            "step_max_rel_err": max(v[1] for v in step.values()),
            "direct_twice_l2_rel_err": again}


def cnn_no_grad_routes(torch, card):
    """17d: asking for a gradient on route pallas, under fc_bfp and under
    sdc_abft raises, naming the reason (the CUDA conv kernels and the BFP
    matmul kernel have no backward; the armed forward returns its verdict
    beside the logits)."""
    from repro_torch.configs import get_config
    from repro_torch.models import alexnet
    from repro_torch.nn.module import tree_leaves
    cfg = get_config("alexnet")
    params = alexnet.init(0, cfg, device="cuda")
    for p in tree_leaves(params):
        p.requires_grad_()
    batch = _cnn_batches(torch, cfg, 2, 1, seed=1)[0]
    out = {}
    for name, (kw, reason) in CNN_NO_GRAD.items():
        try:
            alexnet.loss_fn(params, dataclasses.replace(cfg, **kw), batch)
        except ValueError as e:
            check(reason in str(e), f"cnn-train {name}: the error does not "
                  f"name {reason!r}: {e}")
            out[name] = str(e)
        else:
            raise CheckFailed(f"cnn-train: a gradient asked for under "
                              f"{name} did not raise")
        print(f"cnn-train {name}: raises ValueError: {out[name]}")
    del params
    torch.cuda.empty_cache()
    return out


def cnn_examples(torch, card):
    """17e: the example twins in this process on the card, each printing
    its OK line, the kernels each must reach counted."""
    import importlib.util
    import io
    out = []
    for name, argv, kernels in CNN_EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "examples", name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        reset_launch_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                mod.main(argv)
        finally:
            for line in buf.getvalue().splitlines():
                print(f"  {name}: {line}")
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        counts = launch_counts()
        text = buf.getvalue()
        ok = {"serve_batch_torch": "serve_batch OK",
              "quickstart_torch": "quickstart OK",
              "alexnet_winograd_torch": "alexnet_winograd OK"}[name]
        check(ok in text, f"cnn-train: examples/{name}.py {argv} printed "
              f"no {ok!r}")
        check(all(counts[k] > 0 for k in kernels), f"cnn-train: "
              f"examples/{name}.py {argv} did not reach {kernels}: {counts}")
        print(f"cnn-train example {name} {' '.join(argv)}: {ok} in "
              f"{took:.2f} s"
              + "".join(f", {k} launched {counts[k]} times" for k in kernels)
              + f" | on {card}")
        out.append({"example": name, "argv": argv, "seconds": took,
                    "launches": {k: counts[k] for k in kernels}})
    torch.cuda.empty_cache()
    return out


def phase_cnn_train(torch, card):
    """17: training the image models on the card (a-e)."""
    t0 = time.perf_counter()
    out = {"alexnet": cnn_train_run(torch, card, "alexnet")}
    shape = CNN_TRAIN_SHAPES["alexnet"]
    out["alexnet_bf16"] = cnn_train_run(
        torch, card, "alexnet", "bfloat16", (shape[0], 1, 1), full=False)
    out["vgg16"] = cnn_train_run(torch, card, "vgg16")
    out["no_grad"] = cnn_no_grad_routes(torch, card)
    out["examples"] = cnn_examples(torch, card)
    out["phase_s"] = time.perf_counter() - t0
    print(f"cnn-train: phase 17 {out['phase_s']:.1f} s")
    return out


def sass_hmma(obj, name):
    """{function: HMMA instructions in its SASS} for each function of the
    object file ``obj`` whose name holds ``name`` (``cuobjdump -sass``);
    None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", obj], capture_output=True,
                         text=True, timeout=300).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            if name in fn:
                counts[fn] = 0
        elif fn in counts and "HMMA" in line:
            counts[fn] += 1
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="On-card smoke run of the "
                                 "PyTorch/CUDA port.")
    ap.add_argument("--out", help="also write every number of the run to "
                    "this JSON file")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the fleet phase's open-loop trace")
    ap.add_argument("--bits", metavar="OUT", help="only hash every output "
                    "of kernels 1-4 and 7 and time each into OUT (see "
                    "dump_bits)")
    ap.add_argument("--compare-bits", nargs="+", metavar="FILE",
                    help="only compare --bits files of two trees run in "
                    "turns: A B [B A ...]")
    args = ap.parse_args(argv)
    if args.compare_bits:
        return compare_bits(args.compare_bits)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on the card", file=sys.stderr)
        return 2
    try:
        import numpy as np

        from repro_torch.configs import get_config
        from repro_torch.kernels import build
        from repro_torch.models import alexnet
    except ImportError as e:
        print(f"chip_smoke: cannot import the port from {ROOT}/src: {e}",
              file=sys.stderr)
        return 2

    if args.bits:
        return dump_bits(torch, np, args.bits)
    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {kind} | nvidia-smi: {card} | torch {torch.__version__}"
          f" cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{lib.build_seconds:.2f} s) -> {lib.path}")
    ptxas = []
    for line in lib.ptxas_log.splitlines():
        if "Compiling entry function" in line or "Used" in line \
                or "spill" in line:
            print("ptxas:", line.strip())
            ptxas.append(line.strip())
    hmma = sass_hmma(os.path.join(os.path.dirname(lib.path),
                                  "conv_direct_bf16.o"), "conv_direct_mma")
    if hmma is None:
        print("sass: cuobjdump not found; the bf16 conv stage's products "
              "are mma.sync in csrc/conv_direct_bf16.cu")
    else:
        print(f"sass: kernel 1's bf16 conv stage (conv_direct_mma): "
              f"{len(hmma)} instantiations, HMMA in each: "
              f"{all(hmma.values())} (HMMA counts {sorted(set(hmma.values()))})")
        check(hmma and all(hmma.values()), "kernel 1's bf16 conv stage "
              "issues no HMMA")

    cfg = dataclasses.replace(get_config("alexnet"), use_pallas=True)
    cfg_bfp = dataclasses.replace(cfg, fc_bfp=True, conv_bfp=True)
    params = alexnet.init(0, cfg, device="cuda")
    rows = phase_kernels(torch, np, cfg, params)
    rows_bfp_slabs = phase_kernels(torch, np, cfg_bfp, params)
    rows["bfp_matmul"] = phase_bfp(torch, np, cfg_bfp, params)
    serves = {"f32": phase_serve(torch, np, cfg, params),
              "bfp": phase_serve(torch, np, cfg_bfp, params, cfg_f32=cfg)}
    sdc = phase_sdc(torch, np, cfg, params, rows)
    tuned = phase_autotune(torch, np, cfg, params)
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    params16 = alexnet.init(0, cfg16, device="cuda")
    rows_bf16, bf16_flips = phase_kernels_bf16(torch, np, cfg16, params16)
    cfg16_bfp = dataclasses.replace(cfg16, fc_bfp=True, conv_bfp=True)
    rows_bf16_bfp, _ = phase_kernels_bf16(torch, np, cfg16_bfp, params16)
    rows_bf16_bfp["bfp_matmul"] = phase_bfp_bf16(torch, np, cfg16_bfp,
                                                 params16)
    rows_m = phase_winograd_m(torch, np, cfg, params)
    alex16 = phase_alexnet_bf16(torch, np, cfg, params16)
    cfg_vgg = dataclasses.replace(get_config("vgg16"), use_pallas=True)
    params_vgg = alexnet.init(1, cfg_vgg, device="cuda")
    params_vgg16 = alexnet.init(1, dataclasses.replace(
        cfg_vgg, dtype="bfloat16"), device="cuda")
    rows_vgg, vgg_passes = phase_kernels_vgg(torch, np, cfg_vgg, params_vgg,
                                             params_vgg16)
    vgg = phase_vgg(torch, np, cfg_vgg, params_vgg, params_vgg16)
    bf16_bfp = phase_serve_bf16_bfp(torch, np, cfg, params16, cfg_vgg,
                                    params_vgg16)
    del params16
    serves.update({"bf16": alex16["serve"], "vgg": vgg["f32"],
                   "vgg_bf16": vgg["bf16"],
                   "bf16_bfp": bf16_bfp["alexnet"],
                   "vgg_bf16_bfp": bf16_bfp["vgg16"]})
    fleet = phase_fleet(torch, np, {"alexnet": cfg, "vgg16": cfg_vgg},
                        {"alexnet": params, "vgg16": params_vgg}, args.seed)
    del params_vgg
    torch.cuda.empty_cache()
    supervised = phase_supervised(
        torch, np, {"alexnet": cfg, "vgg16": dataclasses.replace(
            cfg_vgg, dtype="bfloat16")},
        {"alexnet": params, "vgg16": params_vgg16}, kind)
    del params, params_vgg16
    torch.cuda.empty_cache()
    rows["decode_attn"] = phase_decode(torch, np)
    lm_serve = phase_lm(torch, np)
    torch.cuda.empty_cache()
    rows.update(phase_ssm(torch, np))
    mamba = phase_mamba(torch, np)
    torch.cuda.empty_cache()
    rows_taps = phase_dw1d_taps(torch, np)
    mamba_taps = phase_mamba_taps(torch, np)
    torch.cuda.empty_cache()
    train_rows, train = phase_train(torch, np, card)
    rows.update(train_rows)
    torch.cuda.empty_cache()
    moe = phase_moe(torch, np)
    torch.cuda.empty_cache()
    encvlm = phase_encdec_vlm(torch, np)
    torch.cuda.empty_cache()
    hybrid = phase_hybrid(torch, np, card)
    torch.cuda.empty_cache()
    mesh = phase_mesh(torch, np, card)
    torch.cuda.empty_cache()
    tp_rows, tp_s = phase_tp(torch, np)
    torch.cuda.empty_cache()
    model = phase_model(cfg, card, rows, serves["f32"], lm_serve,
                        moe["granite"], train["dense"])
    torch.cuda.empty_cache()
    dryrun = phase_dryrun(torch, card)
    torch.cuda.empty_cache()
    cnn_train = phase_cnn_train(torch, card)
    # each path's launches, counted from 0 over its own serve run
    paths = {**{path: sv["launches"] for path, sv in serves.items()},
             "sdc": sdc["launches"], "autotune": tuned["launches"],
             "sdc_bf16": alex16["sdc"]["launches"],
             "fleet": fleet["launches"],
             "supervised": supervised["launches"],
             "lm": lm_serve["launches"],
             "mamba": mamba["launches"],
             "mamba_taps": mamba_taps["serve_launches"],
             "train": train["ssm"]["launches"],
             "moe": moe["granite"]["launches"],
             "moe_phi4": moe["phi4"]["launches"],
             "moe_mla": moe["deepseek"]["launches"],
             "encdec": encvlm["whisper"]["launches"],
             "vlm": encvlm["phi3v"]["launches"],
             "hybrid": hybrid["jamba"]["launches"],
             "hybrid_bfp8": hybrid["jamba_bfp8"]["launches"],
             "mesh": mesh["launches"],
             "mesh_fsdp": mesh["fsdp_ssm"]["launches"],
             "mesh_serve": mesh["serve"]["data_parallel"]["launches"]}

    replaces = {"conv_direct": "src/repro/kernels/conv/direct.py:189",
                "conv_winograd": "src/repro/kernels/conv/winograd.py:297",
                "conv_winograd_fused":
                    "src/repro/kernels/conv/winograd.py:344",
                "bfp_matmul":
                    "src/repro/kernels/bfp_matmul/bfp_matmul.py:29",
                "decode_attn":
                    "src/repro/kernels/decode_attn/decode_attn.py:26",
                "ssd": "src/repro/kernels/ssd/ssd.py:25",
                "dw1d": "src/repro/kernels/conv/winograd.py:61",
                # the reference's VJP of kernel 7 (ops.py:47 _dw1d_bwd):
                # the Pallas kernel re-run reversed (:51), the reductions
                # (:55)
                "dw1d_bwd": "src/repro/kernels/conv/ops.py:51",
                "dw1d_wgrad": "src/repro/kernels/conv/ops.py:55"}
    sources = {"conv_direct": "src/repro_torch/csrc/conv_direct.cu",
               "conv_winograd": "src/repro_torch/csrc/conv_winograd.cu",
               "conv_winograd_fused": "src/repro_torch/csrc/conv_winograd.cu",
               "bfp_matmul": "src/repro_torch/csrc/bfp_matmul.cu",
               "decode_attn": "src/repro_torch/csrc/decode_attn.cu",
               "ssd": "src/repro_torch/csrc/ssd.cu",
               "dw1d": "src/repro_torch/csrc/dw1d.cu",
               "dw1d_bwd": "src/repro_torch/csrc/dw1d.cu",
               "dw1d_wgrad": "src/repro_torch/csrc/dw1d.cu"}
    # launches: the serve run of the slice that ported the kernel (the conv
    # kernels f32 AlexNet, kernel 4 BFP AlexNet, kernel 5 the LM, kernels
    # 6 and 7 mamba); launches_by_path: every run
    home = {"bfp_matmul": "bfp", "decode_attn": "lm", "ssd": "mamba",
            "dw1d": "mamba", "dw1d_bwd": "train", "dw1d_wgrad": "train"}
    kernels = []
    for kname, row in rows.items():
        if "geometries" in row:
            bound_by, extra = row["bound_by"], {
                "geometries": row["geometries"]}
        else:
            _, bound_by = _bound(row["flop"], row["bytes"],
                                 "int8" if kname == "bfp_matmul"
                                 else "float32")
            extra = {"layers": row["layers"]}
        entry = {
            "name": kname, "route": "cuda", "source": sources[kname],
            "replaces": replaces[kname],
            "launches": paths[home.get(kname, "f32")][kname],
            "launches_by_path": {path: counts[kname]
                                 for path, counts in paths.items()},
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": bound_by, "library_ms": row["library_ms"], **extra}
        tuned_layers = [t for t in tuned["layers"] if t["kernel"] == kname]
        if tuned_layers:
            entry["tuned_ms"] = sum(t["tuned_ms"] for t in tuned_layers)
            entry["tuned_tiles"] = {t["layer"]: t["tile"]
                                    for t in tuned_layers}
        if kname in rows_bf16:
            entry["bf16"] = summary(rows_bf16[kname])
        if kname in rows_vgg["float32"]:
            entry["vgg"] = {dt: summary(r[kname])
                            for dt, r in rows_vgg.items()}
        if kname in rows_bf16_bfp:
            entry["bf16_bfp"] = (summary(rows_bf16_bfp[kname])
                                 if kname != "bfp_matmul" else
                                 summary(rows_bf16_bfp[kname]) | {
                                     "x": "bfloat16"})
        by_m = {m: summary(rows_m[f"{kname} m={m}"]) for m in WINO_MS
                if f"{kname} m={m}" in rows_m}
        if by_m:
            entry["by_m"] = by_m
        by_taps = {r: {k: rows_taps[f"{kname} r={r}"][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "geometries")} for r in DW1D_TAPS
            if f"{kname} r={r}" in rows_taps}
        if by_taps:
            entry["by_taps"] = by_taps
        if kname in tp_rows:
            # phase 16: at the local shapes of a 16-way model split (kernel
            # 5: its lse mode over one block of the sequence-split cache)
            entry["tp_local"] = {k: tp_rows[kname][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "geometries")}
        if kname in rows_bfp_slabs:
            entry["max_abs_err_bfp_slabs"] = \
                rows_bfp_slabs[kname]["max_abs_err"]
            entry["ms_bfp_slabs"] = rows_bfp_slabs[kname]["ms"]
            entry["ms_abft"] = row["ms_abft"]
            entry["abft_flips_checked"] = row["abft_flips_checked"]
        kernels.append(entry)
    for name, serve in serves.items():
        print(f"serve {name}: {serve['completed']}/{serve['requests']} over "
              f"{serve['batches']} batches {serve['bucket_counts']} | "
              f"{serve['imgs_per_s']:.2f} img/s p50 {serve['p50_ms']:.3f} ms"
              f" p99 {serve['p99_ms']:.3f} ms peak mem "
              f"{serve['peak_mem_bytes'] / 2 ** 20:.1f} MiB | launches "
              f"{serve['launches']} | on {card}")
    print(f"serve lm {LM_ARCH}: {lm_serve['completed']}/{LM_REQUESTS} "
          f"requests, {lm_serve['tokens']} tokens over "
          f"{lm_serve['decode_steps']} decode steps | "
          f"{lm_serve['decode_tokens_per_s']:.2f} tok/s in decode, "
          f"{lm_serve['wall_tokens_per_s']:.2f} tok/s wall | p50 "
          f"{lm_serve['p50_ms']:.3f} ms p99 {lm_serve['p99_ms']:.3f} ms | "
          f"peak mem {lm_serve['peak_mem_bytes'] / 2 ** 20:.1f} MiB | "
          f"launches {lm_serve['launches']} | on {card}")
    print(f"serve mamba {SSM_ARCH}: {mamba['completed']}/{LM_REQUESTS} "
          f"requests ({mamba['prefills']} prefills), {mamba['tokens']} "
          f"tokens over {mamba['decode_steps']} decode steps | "
          f"{mamba['decode_tokens_per_s']:.2f} tok/s in decode, "
          f"{mamba['wall_tokens_per_s']:.2f} tok/s wall | p50 "
          f"{mamba['p50_ms']:.3f} ms p99 {mamba['p99_ms']:.3f} ms | peak mem "
          f"{mamba['peak_mem_bytes'] / 2 ** 20:.1f} MiB | init "
          f"{mamba['init_s']:.2f} s | launches ssd {mamba['launches']['ssd']}"
          f" dw1d {mamba['launches']['dw1d']} | on {card}")
    print(f"train: {TRAIN_DENSE_ARCH} {train['dense']['step_ms']:.2f} ms a "
          f"step, {train['dense']['tokens_per_s']:.1f} tokens/s, peak "
          f"{train['dense']['peak_mem_bytes'] / 2 ** 30:.2f} GiB | {SSM_ARCH} "
          f"{train['ssm']['step_ms']:.1f} ms a step, peak "
          f"{train['ssm']['peak_mem_bytes'] / 2 ** 30:.2f} GiB, launches "
          f"{train['ssm']['launches']} | "
          + " | ".join(f"{r['arch']} {r['step_ms']:.1f} ms a step, "
                       f"{r['tokens_per_s']:.1f} tokens/s, peak "
                       f"{r['peak_mem_bytes'] / 2 ** 30:.2f} GiB"
                       for r in train["moe"].values())
          + f" | phase 9 {train['phase_s']:.1f} s | on {card}")
    for tag, m in [("moe", moe[k]) for k in ("granite", "phi4", "deepseek")
                   ] + [("encdec", encvlm["whisper"]),
                        ("vlm", encvlm["phi3v"]),
                        ("hybrid", hybrid["jamba"]),
                        ("hybrid", hybrid["jamba_bfp8"])]:
        print(f"serve {tag} {m['arch']} ({m['param_dtype']} params): "
              f"{m['completed']}/{m['requests']} requests, {m['tokens']} "
              f"tokens over {m['decode_steps']} decode steps | "
              f"{m['decode_tokens_per_s']:.2f} tok/s in decode, "
              f"{m['wall_tokens_per_s']:.2f} tok/s wall | p50 "
              f"{m['p50_ms']:.3f} ms p99 {m['p99_ms']:.3f} ms | peak mem "
              f"{m['peak_mem_bytes'] / 2 ** 30:.2f} GiB | kernel 5 "
              f"{m['launches']['decode_attn']} | on {card}")
    for r in (train["audio_vlm"]["whisper"], train["audio_vlm"]["phi3v"]):
        print(f"train {r['arch']} ({r['layers']} layers, "
              f"{r['params'] / 1e9:.3f} B params, batch {r['batch']} x "
              f"{r['seq_len']}, {r['extra_rows']}): {r['step_ms']:.2f} ms "
              f"a step, {r['tokens_per_s']:.1f} tokens/s, peak "
              f"{r['peak_mem_bytes'] / 2 ** 30:.2f} GiB, idle share "
              f"{r['idle_share']} | on {card}")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernels": kernels, "serve": serves,
                       "sdc": sdc, "autotune": tuned,
                       "bf16": {"per_layer": {k: r["per_layer"]
                                              for k, r in rows_bf16.items()},
                                "flips": bf16_flips, "sdc": alex16["sdc"]},
                       "vgg": {"per_layer": {
                           dt: {k: r["per_layer"] for k, r in rows.items()}
                           for dt, rows in rows_vgg.items()},
                           "feature_pass_ms": vgg_passes},
                       "fleet": fleet, "supervised": supervised,
                       "lm_serve": lm_serve, "mamba_serve": mamba,
                       "train": train, "moe": moe,
                       "encdec_vlm": encvlm, "hybrid": hybrid,
                       "mesh": mesh,
                       "tp": {"kernels": tp_rows, "phase_s": tp_s},
                       "per_layer": {k: r["per_layer"]
                                     for k, r in rows.items()
                                     if "per_layer" in r},
                       "per_layer_bfp_slabs": {
                           k: r["per_layer"]
                           for k, r in rows_bfp_slabs.items()},
                       "bf16_bfp": {"per_layer": {
                           k: r["per_layer"]
                           for k, r in rows_bf16_bfp.items()},
                           "serve": bf16_bfp},
                       "winograd_m": {k: r["per_layer"]
                                      for k, r in rows_m.items()},
                       "dw1d_taps": rows_taps, "mamba_taps": mamba_taps,
                       "model": model, "dryrun": dryrun,
                       "cnn_train": cnn_train,
                       "build_seconds": lib.build_seconds,
                       "ptxas": ptxas}, f, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
