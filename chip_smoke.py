#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases (any failure propagates and the script exits non-zero):

1. device — the card's name and power limit (``nvidia-smi``) and
   ``torch.cuda.get_device_name``;
2. build — builds ``tensorflowonspark_torch/csrc/flash_attn_fwd.cu``,
   ``flash_attn_fwd_tf32.cu``, ``flash_attn_bwd.cu`` and
   ``flash_attn_bwd_tf32.cu`` from the checkout
   (one ``nvcc`` each, in parallel) and prints, per instantiation of the two ``wgmma`` kernels (the
   tiles of D 32/64/96/128/192/256 and the wide route's 192 and 256 columns
   a consumer x bf16/fp16; f32 as 3xTF32 on the tiles of D 32/64/96/128 and
   the wide route's 128, 192 and 256 columns a consumer), the registers and
   spills ptxas reports, the
   dynamic shared memory, and the counts of ``HGMMA`` (wgmma) and
   ``UTMALDG`` (TMA load) instructions in the SASS (``cuobjdump -sass``),
   failing if either is missing, a spill shows, or ptxas serialises a
   kernel's wgmma; and the registers and spills of the 3xTF32
   kernel's K/V pre-pass, the wide route's V transpose and the split-KV
   combine kernels; the backward's kernels (the Δ pass, dK/dV and dQ on
   the tiles of D 32/64/96/128 x bf16/fp16) are held to the same design
   checks as the ``wgmma`` instantiations (HGMMA and UTMALDG in the SASS,
   no spill, no serialised wgmma), and the f32 backward's ``mma.sync``
   kernels (the Δ pass, dK/dV and dQ on the same tiles) to no spill and
   HMMA in the SASS;
3. kernel — holds every route (``ops.attention._route``) against the plain
   PyTorch version (``chunk_attention``) on the card, O and lse, at the
   serving shape and at edge shapes (ragged tails, one query row,
   key-block-crossing offsets, strided q/k/v views of one packed tensor, a
   tile half fully masked), for bf16/fp16 on the tiles up to D=256 at the
   real head dim (D 8 to 256: the tiles' own widths and the head dims
   between them, the example LM's D=32 at its shape) and on the wide route
   at D 264, 320, 512 and 1000, for f32 through the 3xTF32 kernel's tiles
   at D <= 128 (and with every low mantissa bit set) and on its wide route
   at D 132, 160, 256, 320, 512 and 600 (the head-dim-256 f32 step's shape,
   the head-dim-512 steps' shapes, decode rows, decode rows whose later key
   ranges see only masked keys), and the head dims padded to whole 16-byte
   rows (bf16 D 33, f32 D 33); each case launches its route's kernel once
   and no other (``ops.attention.LAUNCHES``).  Times each as 50 launches back to back
   between two CUDA events, and the cases of ``REFERENCE_TIMED`` also
   against the plain version and ``F.scaled_dot_product_attention`` (the
   yardstick only: the port never calls it, and the record names the SDPA
   backend that answered); ``bound_ms`` is the function's own (its products
   over the live pairs at the unpadded head dim at its type's tensor-core
   rate, or its bytes), and ``bound_design_ms`` beside it what the route's
   design does (the tile's width in P V and the k-steps it runs in Q Kᵀ,
   three TF32 products apiece, Q Kᵀ once per 512-column group of O); the
   kernels one call runs (``torch.profiler``: one attention kernel, at most
   one combine on a wide route, for f32 its pre-pass) with no padding copy;
   for f32 and the wide routes also the pre-pass, the attention kernel and
   the combine apart, and which SDPA backends take f32;
4. slice — an LM serving replica at the width of the repo's chip LM
   configuration (vocab 32000, d_model 1024, 8 layers, 8 heads, bf16, 2048
   tokens), random weights from the seed in the JAX package's bundle layout:
   ``export_bundle`` → ``serving_loop`` over the node's ``DataFeed`` with
   three request batches (the last one partial), a ping and a reload; checks
   the ordered, exactly-count results, their finiteness, the kernel's launch
   count and the logits against the same bundle with plain attention; then
   times one forward, counts the kernels it launches (``torch.profiler``)
   and times the copy of its logits to the host;
   cluster — the same bundle served by the port's cluster: ``run(
   serving_loop, ..., num_executors=2)`` starts two replica node processes
   on the card, ``cluster.serve`` opens the gateway, and request batches of
   4, 4 and 3 rows go through ``gateway.predict``, one row through the TCP
   ``GatewayClient``, then a hot reload to other weights; checks ordered,
   exactly-count results, one row's logits per request against the
   in-process replica, changed predictions after the reload, each node's
   registered device (the card) and the replicas' kernel launches (8 per
   served batch, from ``cluster.metrics()``); prints per-request host
   latency beside the replicas' ``serve.node_batch_secs``;
   orbax bundle — ``tests/data/orbax_lm/``, an f32 LM bundle the JAX
   package wrote in its orbax layout (``tests/make_orbax_fixture.py``),
   read where no JAX, orbax, tensorstore or zstd library is loaded (the
   phase checks ``sys.modules``): ``load_bundle`` builds the package's zstd
   decoder from the checkout and every leaf must match ``expected.json``
   bit for bit; ``serve_and_check`` serves the bundle through the 3xTF32
   kernel (n_layers launches a batch, logits against plain attention);
   ``build_apply`` on the card against the JAX forward's logits within
   ``ORBAX_LOGIT_TOL``; prints the fixture's size, the load's cold and warm
   host-clock seconds, the decoder's output MB/s over the fixture's chunks
   and, from that rate, an estimate of loading a bundle at the LM width;
5. attention at the training shape (B=8, S=2048, H=8, D=128, causal bf16):
   the kernel's forward held against ``chunk_attention`` (O and lse) and
   timed; the backward kernels (``tos::flash_attn_bwd``) held against their
   plain version (``flash_attn_bwd_reference``: dq, dk, dv each within
   ``BWD_REL_TOL`` relative L2) and timed beside their bound, the plain
   version, the library's backward (SDPA under autograd, its backend
   named) and their three kernels apart (``torch.profiler``), there, at
   the example LM's shape (``BWD_SHAPES``: B=8 S=1024 H=8 D=32) and at
   D=64 (B=4 S=2048 H=16), and, once, the recompute VJP through
   ``blockwise_attention`` that they replace on this route; the f32
   backward kernels (3xTF32, within ``BWD_F32_REL_TOL``) the same way at
   ``BWD_F32_SHAPES`` (the f32 LM step's B=2 S=2048 H=8 D=128 and the
   example LM's), each beside the recompute VJP it replaces; then
   ``BWD_CASES`` (every tile, a head dim between tiles, a padded one,
   masked rows, offsets, a cotangent on lse or out alone, packed views,
   fp16; the same in f32) against the plain version, two runs bit-equal,
   and keys sharing a large common component against the f32 gradient
   (bf16 and f32 inputs), untimed;
6. train — the LM at the same width, B=8, S=2048, bf16 compute with f32
   master weights, AdamW as ``optax.adamw(3e-4)``, random weights from the
   seed: 3 warm-up and 10 timed steps through ``make_batch_iterator`` over a
   ``DataFeed`` that repeats one Zipf batch; checks every loss is finite,
   the last below the first, and the kernels' launches per step (n_layers
   of the forward, 2 x n_layers with remat; n_layers of the backward, remat
   or not, and no recompute VJP); one step's loss and gradients with the
   kernels against plain attention, with ``vocab_chunk`` and with
   ``remat``; prints
   step ms, tokens/s, the forward / backward / optimizer split, the peak
   memory and the model-FLOPs share of the step;
7. train→serve — the trained weights exported as a bundle and loaded with
   ``build_apply``: logits against the training model's eval forward;
8. decode — ``greedy_generate`` on the served model (B=4, a 128-token
   prompt, 64 new tokens): cached logits against a full forward at the same
   positions, the EOS stop, ms per generated token;
9. f32 train step — one AdamW step of the f32 model configuration at the
   same width (B=2, S=2048) through the 3xTF32 kernels: a finite loss,
   n_layers launches of the forward and of the f32 backward kernels, none
   of the other kernels and no recompute VJP, and the gradients against
   plain attention;
10. head dim 256 — the same step for the LM with 4 heads of 256 (depth cut
   to ``D256_LAYERS``), in bf16 (the ``wgmma`` kernel at D=256) and in f32
   (the 3xTF32 kernel's wide route): n_layers launches of the route's
   kernel, and loss and gradients against plain attention;
11. head dim 512 — the same two steps for the LM with 2 heads of 512 (depth
   cut to ``D512_LAYERS``), both on the kernels' wide routes;
11a. the example LM — ``examples/llm/train_lm.py``'s and
   ``examples_torch/llm/train_lm.py``'s defaults (``EXAMPLE_LM_CONFIG``:
   vocab 4096, d_model 256, 4 layers of 8 heads of 32, S=1024, B=8), in f32
   (the examples' default: the 3xTF32 kernel's 32-column tile) and in bf16
   (``--bf16``: the wgmma kernel's): the first step's loss and gradients
   against plain attention on the same weights, ``EXAMPLE_STEPS`` AdamW
   steps (finite, falling losses, n_layers launches of the forward and of
   the type's backward kernels a step, no recompute VJP, step ms), then
   one batch served through ``export_bundle`` → ``build_apply``: its logits
   against plain attention's, n_layers launches of the route's kernel, and
   a ``torch.profiler`` census of the forward (n_layers attention kernels,
   for f32 n_layers pre-passes, and no pad, copy or slice inside the
   operator's calls);
12. moe-slice — the MoE LM at the same width with top-2 of 8 experts
   (``MOE_CONFIG``: Mixtral 8x7B's routing, capacity factor 1.25, the sort
   dispatch; depth cut to ``MOE_LAYERS``, about 0.49 B parameters), random weights from the seed in the
   JAX package's bundle layout, through ``export_bundle`` →
   ``serving_loop`` exactly as the slice (batches of 4, 4 and 3 rows, the
   last padded, so its pad rows take expert capacity; a ping and a
   reload): ordered, exactly-count, finite results, n_layers launches a batch,
   the logits against plain attention on the padded batch at the kernel
   path's routing, and with the routing free the share of tokens a layer
   that the two paths send to other experts within a bound (in bf16 and
   f32; a control fault's share reported); one forward's time, a
   ``torch.profiler`` census (dispatch/combine, expert matmuls, the
   attention kernel, the rest) and the peak memory;
13. moe-train — ``make_train_step`` with AdamW on that model, B=8, 3
   warm-up and 10 timed steps: finite losses, aux and router-z losses, a
   falling loss, n_layers launches a step; step ms, tokens/s, the model-FLOPs
   share (top-2 of 8 experts active), the peak memory; one step's loss and
   gradients against plain attention at the kernel step's routing, and
   the share of tokens re-routed with the routing free within the bound;
14. ring — ring attention's hop loop (``parallel.sp.ring_hops``) at the
   serving shape cut into 4 sequence shards held in one process: 16
   launches at the ring's offsets (zero, negative, fully masked), O and
   lse against one causal kernel call, the gradients of q, k, v through O
   and lse against the plain version's, the loop's time;
15. resnet50 — ResNet-50 training at full width, the JAX bench's setup (224
   px, 1000 classes, bf16 compute over f32 masters, bf16 BN outputs, SGD
   Nesterov 0.9 at lr 0.1, L2 1e-4, batch 256, one batch resident on the
   card): 3 warm-up and 20 timed steps; step ms, images/s, the model-FLOPs
   share (3 x the forward FLOPs counted from the conv and dense shapes),
   peak memory, the forward / backward / optimizer split and a
   ``torch.profiler`` census of one step; gate: finite losses that fall;
16. bn-card-vs-cpu — one ``make_bn_train_step`` step of a small f32
   ``resnet_cifar`` from the same weights on the card and on the CPU: loss,
   gradients, running statistics, parameters, with cuDNN's TF32 off (held
   per parameter) and on (PyTorch's default; held as whole vectors);
17. inception — the Inception-v3 serving forward, bf16 at 299 px, batch 32,
   through ``build_apply``: ms per batch, images/s; two images' logits in
   f32 and in bf16 against the f32 model on the CPU;
18. image clusters — ``examples_torch``'s ``mnist_dist`` (STREAMING train at
   the published widths on 2 executors, export, ``inference_fun``),
   ``mnist_tfr`` and ``cifar10_train`` (DIRECT, each exporting a bundle)
   and ``inception_infer`` (64 images, exactly 64 results in order), node
   processes on the card, host-clock times.  No image model reaches an
   attention kernel: the phases check that none launched.
19. wide_deep — BASELINE config 4's model at the JAX example's widths (26 x
   100_003 hash buckets, embed 16, MLP (256, 128, 64), batch 512, optax's
   Adagrad at lr 0.01, one batch resident on the card), in f32 and in bf16:
   3 warm-up and 20 timed steps; step ms, rows/s, forward-only scoring
   rows/s, peak memory, a ``torch.profiler`` census of one step (the
   optimizer, the embedding backward, the gather, the matmuls, the rest)
   and the step's bytes bound over the tables; gate: finite losses that
   fall;
20. wide_deep card-vs-cpu — one Adagrad step of a small f32 wide_deep from
   the same weights on the card and on the CPU;
21. wide_deep sync — ``train(mode="sync")`` on 2 node processes sharing the
   card, the group's ``grad_fn`` as the step's ``cross_host_grad_fn``,
   gradients on the card: equal final parameter digests, ms and bytes per
   ``all_reduce_tree``;
22. criteo pipeline — ``examples_torch/criteo/criteo_wide_deep.py``:
   ``TorchEstimator.fit`` (4096 rows, 2 executors, 2 epochs) then
   ``TorchModel.transform`` of 256 rows, exactly counted and in order;
23. criteo sharded — the sharded tier at full width: a sync
   ``TorchEstimator`` with the fused table range-sharded over 2 nodes, 20
   steps, the sharded export, and a 2-replica serve cluster on the card
   answering through the gateway's lookup fan-out, held against the dense
   apply over the reassembled table.  No config-4 path reaches an attention
   kernel: the phases check that none launched in this process.
24. pp — the LM at full width (``LM_CONFIG``) cut into 4 pipeline stages
   of 2 blocks (``examples_torch/llm/train_lm.PipelinedLM``, the 1F1B
   schedule of ``parallel.pp`` with every stage in this process), B=8 in
   4 microbatches: its loss and the stage, head and embedding gradients
   against the sequential step of the same weights (``make_loss_fn``), the
   kernel's launches (a forward and a recompute per block per microbatch,
   2·n_layers·m), the same pipeline with plain attention (``attn_impl:
   xla``), then AdamW steps timed (ms a step, tokens/s, the GPipe bubble
   share, peak memory); and an f32 pipeline at 2 layers of the same width
   (through the 3xTF32 kernels, forward and backward, no recompute VJP)
   against its sequential step within 1e-4;
25. sharded scoring — ``TorchModel.transform(scoring="sharded")`` on a
   one-node ``torch_distributed`` cluster: the full-width LM bundle
   (``inference.sharded_bundle_inference_loop``) scores 16 rows of 2048
   ids in batches of 4 with ``postprocess="argmax"``, every row's ids
   equal to ``scoring="task"``'s on the same bundle; the node's kernel
   launches (n_layers a batch) and each transform's seconds.
26. ingest resnet50 — ResNet-50 at the resnet50 phase's width fed from
   2560 synthetic 224 px images in 20 TFRecord shards through the DIRECT
   ingest tier (``IngestFeed`` in columnar mode, ``device_prefetch`` as
   uint8, normalised on the card), after the image clusters: node-local
   readers under ``profiling.trace`` (the card's idle share) and again
   without it, then one data-service worker over two epochs (the second
   from ``ChunkCache``); images/s, step ms and the host's wait a step over
   the timed steps, the readers' decode rate alone; gates: every id
   exactly once per epoch, the first 3 steps replayed resident within 1%,
   no attention launch, the worker without a CUDA context.
27. pod — ``examples_torch/mnist/mnist_pod.py`` as a 1-rank pod
   (``GPUPodLauncher`` on ``localhost`` with the card slice ``[0]``, NCCL
   of world size 1), 2000 synthetic samples in 8 STREAMING partitions:
   the rank's ``CUDA_VISIBLE_DEVICES``, its registered device facts,
   ``chip_plan()``, every sample fed once, a falling loss, and the
   collective checkpoint's logits against the final weights'; the job's
   seconds and steps/s.  Then ``export_program``: ResNet-50 (f32, eval)
   exported on the card with a dynamic batch and scored in a fresh process
   that imports only torch and numpy, against ``build_apply`` at batches 2
   and 5 (no attention launch); then three LM programs exported on the
   card with ``tos::flash_attn_fwd`` inside (the LM at full width and
   depth in bf16 with a dynamic batch, the same width in f32 at depth 2,
   the MoE LM at depth 2 with a fixed batch), scored by one fresh process
   that imports torch, numpy and the op's module only: n_layers op nodes
   a graph, n_layers launches a forward on the route ``program.json``
   names, logits against ``build_apply``'s; the op's host cost per call
   against the undispatched implementation.

The line before the last is the ``kernels`` JSON record (the forward's two
kernels and the backward's two); the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
with 1 and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import glob
import json
import math
import os
import re
import shutil
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK_DIR = os.path.join(ROOT, "chip_smoke_work")  # bundle files, removed at exit

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16/fp16 tensor-core rate
PEAK_TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core rate
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bandwidth
# O: P is rounded to bf16/fp16 for the P·V product on the tensor cores and O
# is stored in bf16/fp16, while the plain version runs softmax and P·V in f32.
O_TOL = dict(atol=2e-2, rtol=2e-2)
# lse: the plain version's logits are a bf16/fp16 einsum (rounded before
# the f32 softmax), the kernel's are accumulated in f32.
LSE_TOL = dict(atol=1e-2, rtol=1e-2)
# f32 inputs: the 3xTF32 kernel's products are good to about 2^-20 relative
# (x = hi + lo split, the lo.lo term dropped), against the plain version's
# f32 einsums (no TF32), summed in other orders
F32_TOL = dict(atol=1e-4, rtol=1e-4)
# slice logits, served (kernel attention) vs plain attention: bf16 compute
# rounds at different places over 8 layers; held to 5% of the largest logit
LOGIT_REL_TOL = 0.05
# the same for an f32 model: 3xTF32 attention keeps within ~1e-6 of f32 and
# the matmuls run in f32 on both sides (TF32 off, phase_device); the rest is
# summation order; held to 1e-4 of the largest logit
F32_LOGIT_REL_TOL = 1e-4

LM_CONFIG = {"model": "transformer", "vocab_size": 32000, "d_model": 1024,
             "n_layers": 8, "n_heads": 8, "bf16": True, "attn_impl": "auto"}
SEQ_LEN = 2048
MAX_BATCH = 4
BATCH_ROWS = (4, 4, 3)  # three request batches; the last one is partial

# (name, B, Sq, Sk, H, D, causal, kv_offset, dtype name, packed): `packed`
# makes q, k, v strided views of one [B, S, 3, H, D] tensor (Sq == Sk)
KERNEL_CASES = [
    ("serving_shape", 4, 2048, 2048, 8, 128, True, 0, "bfloat16", False),
    ("ragged_20_52_noncausal", 2, 20, 52, 8, 128, False, 0, "bfloat16", False),
    ("ragged_20_52_causal_fp16_d64", 2, 20, 52, 8, 64, True, 0, "float16", False),
    ("kv_offset_masked_rows", 1, 100, 70, 8, 128, True, 37, "bfloat16", False),
    ("kv_offset_negative", 1, 64, 192, 4, 128, True, -64, "bfloat16", False),
    ("head_dim_64", 4, 2048, 2048, 16, 64, True, 0, "bfloat16", False),
    ("ragged_200_330_noncausal", 2, 200, 330, 8, 128, False, 0, "bfloat16", False),
    ("ragged_200_330_causal", 2, 200, 330, 8, 128, True, 0, "bfloat16", False),
    ("sq_1_noncausal", 2, 1, 300, 8, 128, False, 0, "bfloat16", False),
    ("sq_1_causal_decode_d64", 2, 1, 517, 8, 64, True, -516, "float16", False),
    ("kv_offset_129", 1, 256, 384, 8, 128, True, 129, "bfloat16", False),
    ("noncausal_64_1000", 2, 64, 1000, 8, 128, False, 0, "bfloat16", False),
    ("head_dim_64_fp16", 4, 2048, 2048, 16, 64, True, 0, "float16", False),
    ("packed_qkv_view", 2, 512, 512, 8, 128, True, 0, "bfloat16", True),
    ("packed_qkv_view_d64", 2, 300, 300, 8, 64, False, 0, "float16", True),
    # every row of the first consumer warpgroup's 64-row half sees no key
    ("consumer_half_masked", 1, 128, 128, 8, 128, True, 64, "bfloat16", False),
]
# the other routes (ops.attention._route), same fields: f32 up to D=128 on
# the 3xTF32 kernel's tiles, bf16/fp16 on the wgmma kernel's tiles at the
# head dims other than 64 and 128 up to 256, f32 above 128 and bf16/fp16
# above 256 on the two kernels' wide routes, all at the real head dim
# (padded only to whole 16-byte rows); a name with "low_bits" sets every
# low mantissa bit of the f32 inputs
GENERIC_CASES = [
    ("f32_serving_shape", 4, 2048, 2048, 8, 128, True, 0, "float32", False),
    ("f32_d64_ragged_kv_offset", 2, 200, 330, 8, 64, True, 37, "float32", False),
    # the orbax fixture LM's served shape (phase_orbax_bundle): many key blocks
    ("f32_d64_orbax_served_shape", 4, 2048, 2048, 2, 64, True, 0, "float32", False),
    ("f32_ragged_200_330_noncausal", 2, 200, 330, 8, 128, False, 0, "float32", False),
    ("f32_kv_offset_masked_rows", 1, 100, 70, 8, 128, True, 37, "float32", False),
    ("f32_kv_offset_negative", 1, 64, 192, 4, 128, True, -64, "float32", False),
    ("f32_sq_1_causal_decode", 2, 1, 517, 8, 128, True, -516, "float32", False),
    ("f32_packed_qkv_view", 2, 512, 512, 8, 128, True, 0, "float32", True),
    ("f32_consumer_half_masked", 1, 128, 128, 8, 128, True, 64, "float32", False),
    ("f32_d33_padded", 2, 70, 45, 8, 33, False, 0, "float32", False),
    ("f32_d80_packed", 2, 130, 130, 8, 80, True, 0, "float32", True),
    ("f32_low_bits", 2, 512, 512, 8, 128, True, 0, "float32", False),
    ("bf16_d32", 4, 512, 512, 8, 32, True, 0, "bfloat16", False),
    ("bf16_d96", 2, 300, 300, 8, 96, True, 0, "bfloat16", False),
    # the example LM's attention (EXAMPLE_LM_CONFIG: B=8 S=1024 H=8 D=32),
    # f32 (its default) and bf16; the 192 tile at a long causal shape
    ("example_lm_d32_f32", 8, 1024, 1024, 8, 32, True, 0, "float32", False),
    ("example_lm_d32_bf16", 8, 1024, 1024, 8, 32, True, 0, "bfloat16", False),
    ("bf16_d192", 4, 2048, 2048, 4, 192, True, 0, "bfloat16", False),
    # the tiles at the real head dim: the head dims between the tiles' widths
    # (the columns past D zero-filled by TMA), ragged tails, offsets, decodes,
    # packed views read in place; a head dim padded to whole 16-byte rows
    ("bf16_d8_ragged_noncausal", 2, 70, 45, 4, 8, False, 0, "bfloat16", False),
    ("fp16_d40_kv_offset_masked_rows", 1, 100, 70, 4, 40, True, 37, "float16", False),
    ("bf16_d80_sq_1_causal_decode", 2, 1, 517, 4, 80, True, -516, "bfloat16", False),
    ("bf16_d96_packed_qkv_view", 2, 300, 300, 4, 96, True, 0, "bfloat16", True),
    ("fp16_d32_kv_offset_negative", 1, 64, 192, 4, 32, True, -64, "float16", False),
    ("bf16_d160_ragged_noncausal", 2, 200, 330, 4, 160, False, 0, "bfloat16", False),
    ("fp16_d224_sq_1_causal_decode", 2, 1, 517, 4, 224, True, -516, "float16", False),
    ("bf16_d192_packed_qkv_view", 2, 300, 300, 2, 192, True, 0, "bfloat16", True),
    ("bf16_d33_padded", 2, 70, 45, 4, 33, True, 3, "bfloat16", False),
    ("f32_d36_ragged_kv_offset", 2, 100, 170, 4, 36, True, 5, "float32", False),
    ("f32_d96_packed_qkv_view", 2, 300, 300, 4, 96, True, 0, "float32", True),
    ("f32_d8_sq_1_causal_decode", 2, 1, 517, 4, 8, True, -516, "float32", False),
    ("f32_d40_consumer_half_masked", 1, 128, 128, 4, 40, True, 64, "float32", False),
    ("bf16_d256", 4, 2048, 2048, 4, 256, True, 0, "bfloat16", False),
    ("bf16_d256_train_shape", 8, 2048, 2048, 4, 256, True, 0, "bfloat16", False),
    ("bf16_d256_ragged_noncausal", 2, 200, 330, 4, 256, False, 0, "bfloat16", False),
    ("bf16_d256_kv_offset_masked_rows", 1, 100, 70, 4, 256, True, 37, "bfloat16", False),
    ("bf16_d256_kv_offset_negative", 1, 64, 192, 4, 256, True, -64, "bfloat16", False),
    ("fp16_d256_sq_1_causal_decode", 2, 1, 517, 4, 256, True, -516, "float16", False),
    ("bf16_d256_packed_qkv_view", 2, 512, 512, 4, 256, True, 0, "bfloat16", True),
    ("bf16_d256_consumer_half_masked", 1, 128, 128, 4, 256, True, 64, "bfloat16", False),
    ("bf16_d160", 2, 300, 300, 4, 160, True, 0, "bfloat16", False),
    ("fp16_d192_ragged_kv_offset", 2, 200, 330, 4, 192, True, 5, "float16", False),
    # the head-dim-256 f32 train step's own shape, and its decode edge
    ("f32_d256", 2, 2048, 2048, 4, 256, True, 0, "float32", False),
    ("f32_d256_sq_1_causal_decode", 2, 1, 517, 4, 256, True, -516, "float32", False),
    # the wide routes: f32 at 160, 320 and 512, each plain and as a one-row
    # decode with a kv_offset
    ("f32_d160", 2, 300, 300, 4, 160, True, 0, "float32", False),
    ("f32_d160_sq_1_causal_decode", 2, 1, 517, 4, 160, True, -516, "float32", False),
    ("f32_d320", 2, 200, 330, 2, 320, True, 5, "float32", False),
    ("f32_d320_sq_1_causal_decode", 2, 1, 517, 2, 320, True, -516, "float32", False),
    ("f32_d512", 2, 2048, 2048, 2, 512, True, 0, "float32", False),
    ("f32_d512_sq_1_causal_decode", 2, 1, 517, 2, 512, True, -516, "float32", False),
    # bf16/fp16 at 320 and 512: ragged non-causal, masked rows, a negative
    # kv_offset, a one-row decode, a packed-qkv view
    ("bf16_d320_ragged_noncausal", 2, 200, 330, 2, 320, False, 0, "bfloat16", False),
    ("fp16_d320_kv_offset_masked_rows", 1, 100, 70, 2, 320, True, 37, "float16", False),
    ("bf16_d320_kv_offset_negative", 1, 64, 192, 2, 320, True, -64, "bfloat16", False),
    ("fp16_d320_sq_1_causal_decode", 2, 1, 517, 2, 320, True, -516, "float16", False),
    ("bf16_d320_packed_qkv_view", 2, 512, 512, 2, 320, True, 0, "bfloat16", True),
    ("bf16_d512", 2, 2048, 2048, 2, 512, True, 0, "bfloat16", False),
    ("fp16_d512_ragged_noncausal", 2, 200, 330, 2, 512, False, 0, "float16", False),
    ("bf16_d512_kv_offset_masked_rows", 1, 100, 70, 2, 512, True, 37, "bfloat16", False),
    ("fp16_d512_kv_offset_negative", 1, 64, 192, 2, 512, True, -64, "float16", False),
    ("bf16_d512_sq_1_causal_decode", 2, 1, 517, 2, 512, True, -516, "bfloat16", False),
    ("fp16_d512_packed_qkv_view", 2, 512, 512, 2, 512, True, 0, "float16", True),
    ("bf16_d512_consumer_half_masked", 1, 128, 128, 2, 512, True, 64, "bfloat16", False),
    # bf16 at 320 causal at the long shape; head dims that end in a part box
    # (bf16 264, f32 132); one-row decodes whose later key ranges see only
    # masked keys (split-KV: those ranges drop out of the combine); heads
    # above 512 (column groups of 512; bf16 in two contraction passes)
    ("bf16_d320_causal", 2, 2048, 2048, 2, 320, True, 0, "bfloat16", False),
    ("bf16_d264", 2, 150, 190, 2, 264, True, 3, "bfloat16", False),
    ("f32_d132", 2, 100, 170, 2, 132, True, 5, "float32", False),
    ("bf16_d512_sq_1_masked_split", 2, 1, 517, 2, 512, True, -300, "bfloat16", False),
    ("f32_d320_sq_1_masked_split", 2, 1, 517, 2, 320, True, -300, "float32", False),
    ("fp16_d1000_ragged", 1, 70, 90, 1, 1000, False, 0, "float16", False),
    ("f32_d600_causal", 1, 70, 90, 1, 600, True, 0, "float32", False),
]
# cases timed against the plain version and the library call as well
REFERENCE_TIMED = ("serving_shape", "head_dim_64", "f32_serving_shape", "bf16_d256",
                   "bf16_d256_train_shape", "f32_d256", "bf16_d32", "bf16_d96",
                   "bf16_d192", "example_lm_d32_f32", "example_lm_d32_bf16",
                   "bf16_d512", "f32_d512",
                   "bf16_d320_ragged_noncausal", "f32_d320", "bf16_d320_causal",
                   "bf16_d512_sq_1_causal_decode", "f32_d256_sq_1_causal_decode")

# the backward kernels' cases (name, B, Sq, Sk, H, D, causal, kv_offset,
# dtype name, packed, cotangents), each held against the plain version
# (flash_attn_bwd_reference) on the same q, k, v, out, lse and cotangents:
# every tile (32, 64, 96, 128) and a head dim between two (80), a head dim
# of part 16-byte rows (36, padded to 40) at a ragged non-causal shape,
# masked rows at kv_offset 37, a negative offset, a cotangent on lse alone
# and on out alone, packed q/k/v views read in place, fp16; the same for
# f32 (the 3xTF32 kernels), its head dim of part rows 34 (padded to 36)
BWD_CASES = [
    ("bwd_d32", 2, 512, 512, 8, 32, True, 0, "bfloat16", False, "out"),
    ("bwd_d64", 2, 512, 512, 8, 64, True, 0, "bfloat16", False, "out"),
    ("bwd_d96", 2, 300, 300, 8, 96, True, 0, "bfloat16", False, "out"),
    ("bwd_d128", 2, 512, 512, 8, 128, True, 0, "bfloat16", False, "out"),
    ("bwd_d80_between_tiles", 2, 300, 300, 8, 80, True, 0, "bfloat16", False, "out"),
    ("bwd_d36_ragged_20_52_noncausal", 2, 20, 52, 8, 36, False, 0, "bfloat16", False,
     "out"),
    ("bwd_kv_offset_37_masked_rows", 1, 100, 70, 8, 128, True, 37, "bfloat16", False,
     "out+lse"),
    ("bwd_kv_offset_negative", 1, 64, 192, 4, 128, True, -64, "bfloat16", False,
     "out+lse"),
    ("bwd_lse_cotangent_only", 2, 200, 330, 8, 128, True, 5, "bfloat16", False, "lse"),
    ("bwd_out_cotangent_only", 2, 200, 330, 8, 64, False, 0, "bfloat16", False, "out"),
    ("bwd_packed_qkv_view", 2, 512, 512, 8, 128, True, 0, "bfloat16", True, "out+lse"),
    ("bwd_fp16_d64", 2, 300, 300, 8, 64, True, 0, "float16", False, "out+lse"),
    ("bwd_fp16_d128_ragged", 2, 200, 330, 8, 128, False, 0, "float16", False, "out"),
    ("bwd_f32_d32", 2, 512, 512, 8, 32, True, 0, "float32", False, "out"),
    ("bwd_f32_d64", 2, 512, 512, 8, 64, True, 0, "float32", False, "out"),
    ("bwd_f32_d96", 2, 300, 300, 8, 96, True, 0, "float32", False, "out"),
    ("bwd_f32_d128", 2, 512, 512, 8, 128, True, 0, "float32", False, "out"),
    ("bwd_f32_d80_between_tiles", 2, 300, 300, 8, 80, True, 0, "float32", False, "out"),
    ("bwd_f32_d34_ragged_20_52_noncausal", 2, 20, 52, 8, 34, False, 0, "float32", False,
     "out"),
    ("bwd_f32_kv_offset_37_masked_rows", 1, 100, 70, 8, 128, True, 37, "float32", False,
     "out+lse"),
    ("bwd_f32_kv_offset_negative", 1, 64, 192, 4, 128, True, -64, "float32", False,
     "out+lse"),
    ("bwd_f32_lse_cotangent_only", 2, 200, 330, 8, 128, True, 5, "float32", False, "lse"),
    ("bwd_f32_out_cotangent_only", 2, 200, 330, 8, 64, False, 0, "float32", False, "out"),
    ("bwd_f32_packed_qkv_view", 2, 512, 512, 8, 128, True, 0, "float32", True, "out+lse"),
]
# dq, dk, dv of the backward kernels against the plain version, relative L2
# each: the kernels round P and dS to bf16/fp16 as the A operands of their
# products and store the gradients in it (2^-9 relative in bf16), the plain
# version keeps f32 throughout; a wrong mask, tile or fragment gives errors
# of order 1
BWD_REL_TOL = 2e-2
# the same for the f32 kernels (csrc/flash_attn_bwd_tf32.cu): every product
# is 3xTF32, good to about 2^-20 relative (x = hi + lo, the lo·lo term
# dropped), and the plain version's f32 einsums sum in another order; one
# TF32 pass (about 2^-11 a product) misses it
BWD_F32_REL_TOL = 1e-4

TRAIN_BATCH = 8
TRAIN_WARMUP, TRAIN_TIMED = 3, 10
TRAIN_LR = 3e-4
VOCAB_CHUNK = 4096
SPLIT_STEPS = 3  # instrumented steps for the forward / backward / optimizer split
# one train step's loss and gradients, kernel vs plain attention, vocab_chunk
# vs dense, remat vs not: bf16 compute rounds at different places (the
# kernel's P and O in bf16, the dense loss's logits in bf16 against the
# blockwise loss's f32), about 2^-8 per element, and the differences run
# through 8 layers; held per parameter to 5% of the gradient's L2 norm, and
# the loss to 1%
GRAD_REL_TOL = 0.05
LOSS_REL_TOL = 1e-2
# train→serve: the same bf16 casts of the same f32 masters, once at load
# instead of at each use; held to bf16's rounding (2^-8) of the largest logit
SERVE_LOGIT_REL_TOL = 2.0 ** -8
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW = 4, 128, 64
F32_TRAIN_BATCH = 2  # the f32 step: f32 products, forward and backward 3xTF32
D256_HEADS, D256_LAYERS = 4, 2  # head dim 256 at the LM's width, depth cut
D512_HEADS, D512_LAYERS = 2, 2  # head dim 512 at the LM's width, depth cut
# the LM examples' defaults (examples/llm/train_lm.py:49-51,
# examples_torch/llm/train_lm.py: vocab 4096, d_model 256, 4 layers of 8
# heads of 32, S=1024, B=8; f32 unless --bf16), uncut: EXAMPLE_STEPS AdamW
# steps on one batch, then one batch served
EXAMPLE_LM_CONFIG = {"model": "transformer", "vocab_size": 4096, "d_model": 256,
                     "n_layers": 4, "n_heads": 8, "attn_impl": "auto"}
EXAMPLE_SEQ, EXAMPLE_BATCH, EXAMPLE_STEPS = 1024, 8, 3
CLUSTER_ROWS = (4, 4, 3)  # gateway.predict requests; then one row over TCP
CLUSTER_NODES = 2
# the JAX package's orbax bundle read on the card (tests/make_orbax_fixture.py)
ORBAX_FIXTURE = os.path.join(ROOT, "tests", "data", "orbax_lm")
# card logits vs the JAX package's f32 CPU logits, as a share of the largest
# |logit|: 3xTF32 attention keeps within ~1e-6 of f32 and the matmuls run in
# f32 (TF32 off, phase_device); the rest is summation order
ORBAX_LOGIT_TOL = 1e-4
ORBAX_RATE_BYTES = 64 << 20  # the decoder's rate: >= this much output a window
ORBAX_RATE_WINDOWS = 5
ORBAX_FORBIDDEN = ("jax", "jaxlib", "orbax", "tensorstore", "zstandard", "ml_dtypes",
                   "tensorflowonspark_tpu")
# SASS instructions that show the design: wgmma and TMA loads
DESIGN_SASS = ("HGMMA", "UTMALDG")
# ResNet-50 training, the JAX bench's setup (bench.py:49-110)
RESNET_CONFIG = {"model": "resnet50", "num_classes": 1000, "bf16": True}
RESNET_BATCH, RESNET_SIZE = 256, 224
RESNET_LR, RESNET_WD = 0.1, 1e-4
RESNET_WARMUP, RESNET_TIMED = 3, 20
# ResNet-50 at the same width fed from TFRecord shards through the DIRECT
# ingest tier (phase_ingest_resnet50): INGEST_IMAGES synthetic 224 px
# Examples in shards of INGEST_PER_SHARD; per epoch INGEST_WARMUP steps
# and INGEST_IMAGES / RESNET_BATCH - INGEST_WARMUP timed ones; the first
# INGEST_REPLAY steps replayed in this process within LOSS_REL_TOL
INGEST_IMAGES, INGEST_PER_SHARD = 2560, 128
INGEST_WARMUP, INGEST_REPLAY = 2, 3
INGEST_CACHE_BYTES = 1 << 30
# one BN step, card against CPU, f32 resnet_cifar (phase_bn_card_vs_cpu).
# cuDNN in f32: the CPU's own f32 gradients stray at most 6.3e-6 (relative
# L2 per parameter) from float64 ones at this model and batch; cuDNN may
# pick Winograd or FFT algorithms, whose f32 error is larger than a direct
# sum's, so per parameter 1e-3, the gradients as one vector 1e-4, the loss
# and updated parameters 1e-5, the running statistics 1e-4.  TF32 rounds
# each product to 2^-11, 8192x f32's 2^-24: the loss and the running
# statistics (means of many products) to 2e-3, the gradients and updated
# parameters as whole vectors to 2e-2
BN_CHECK_CONFIG = {"model": "resnet_cifar", "depth_blocks": 1, "width": 16, "bf16": False}
BN_CHECK_BATCH = 32
BN_F32_TOL = {"loss": 1e-5, "stats": 1e-4, "grads_all": 1e-4, "params_all": 1e-5,
              "grad_worst": 1e-3}
BN_TF32_TOL = {"loss": 2e-3, "stats": 2e-3, "grads_all": 2e-2, "params_all": 2e-2}
# Inception-v3 serving forward (BASELINE config 5): bf16 at 299 px
INCEPTION_CONFIG = {"model": "inception_v3", "num_classes": 1001, "bf16": True}
INCEPTION_BATCH, INCEPTION_SIZE = 32, 299
# the card's f32 forward (TF32 off) against the CPU's: f32 sums in other
# orders, cuDNN's algorithms included, through 94 conv/BN layers.  In bf16
# a random-init net this deep strays from f32 by about a fifth of the
# largest logit on the CPU as well (rounding at each of 94 layers, nothing
# trained to absorb it), so the card's bf16 forward is held to twice the
# CPU's own bf16 error against the same f32 logits
INCEPTION_F32_TOL = 1e-3
MNIST_SAMPLES, CIFAR_SAMPLES = 1920, 512  # the image clusters' synthetic sets
# the pod phase: examples_torch/mnist/mnist_pod.py as a 1-rank pod on the
# card (GPUPodLauncher, card slice [0]), the JAX example's data: 2000
# synthetic samples in 8 STREAMING partitions, one epoch, 64 rows a step.
# The collective checkpoint's logits against the final weights' on a fixed
# batch: both forwards run here, on the same code path and settings, so
# they agree to rounding; 1e-6 relative
POD_SAMPLES, POD_PARTITIONS, POD_PROBE = 2000, 8, 16
POD_RESTORE_RTOL = 1e-6
# its export sub-step: ResNet-50 (RESNET_CONFIG in f32, eval) through
# export_program on the card, loaded in a fresh process that imports only
# torch and numpy; logits at EXPORT_BATCHES against build_apply's, both in
# full f32 (TF32 off), within 1e-4 of the largest logit (the exported graph
# runs the same kernels; cuDNN may pick another algorithm in the other
# process)
EXPORT_BATCHES = (2, 5)
EXPORT_LOGIT_TOL = 1e-4
# its LM programs, through tos::flash_attn_fwd on the card: LM_CONFIG at
# full width and depth in bf16 with a dynamic batch, scored at
# EXPORT_LM_BATCHES; the same width in f32 at EXPORT_F32_LAYERS layers
# (the 3xTF32 route), scored at batch 1; MOE_CONFIG at EXPORT_MOE_LAYERS
# layers with the batch fixed at EXPORT_MOE_BATCH (its expert capacity
# needs a concrete batch).  Depths cut so that each model.pt2 stays near
# 0.4 GB.  All at SEQ_LEN.  Logits against build_apply's in this process:
# the same kernels and aten ops, but cuBLAS may pick another algorithm in
# the other process: f32 within EXPORT_LOGIT_TOL of the largest logit,
# bf16 within EXPORT_BF16_LOGIT_TOL; the MoE in bf16 routes a token
# otherwise when a router logit crosses a top-2 boundary, and its row
# changes whole, so its rows out of EXPORT_BF16_LOGIT_TOL are counted as
# re-routed and their share held to MOE_BF16_REROUTE_MAX
EXPORT_LM_BATCHES = (1, 2)
EXPORT_F32_LAYERS = 2
EXPORT_MOE_LAYERS, EXPORT_MOE_BATCH = 2, 2
EXPORT_BF16_LOGIT_TOL = 2e-2
# the op's host cost: OP_HOST_CALLS calls through torch.ops.tos.flash_attn_fwd
# and as many through flash_attn_fwd_cuda, in turns, at the serving shape
OP_HOST_CALLS = 200
# BASELINE config 4, wide-and-deep on Criteo, at the JAX example's widths
# (examples/criteo/criteo_wide_deep.py): 26 x 100_003 hash buckets,
# embed 16, MLP (256, 128, 64), batch 512, optax's Adagrad at lr 0.01
WD_CONFIG = {"model": "wide_deep", "vocab_size": 100_003, "embed_dim": 16,
             "hidden": (256, 128, 64)}
WD_BATCH, WD_LR = 512, 0.01
WD_WARMUP, WD_TIMED = 3, 20
# one Adagrad step of a small f32 wide_deep, card against CPU: the MLP in
# full f32 on both (phase_device turns TF32 off for matmuls, PyTorch's
# default too), the card's embedding backward sums duplicate ids in another
# order: loss, each gradient and each updated parameter to 1e-5 relative L2
WD_CHECK_CONFIG = {"model": "wide_deep", "vocab_size": 1009, "embed_dim": 4,
                   "hidden": (8, 4), "bf16": False}
WD_CHECK_TOL = 1e-5
SYNC_STEPS = 6                     # 2 nodes x 6 lockstep steps of WD_BATCH rows
CRITEO_ROWS, CRITEO_EPOCHS, CRITEO_SCORED = 4096, 2, 256
SHARDED_STEPS, SHARDED_LR = 20, 0.125
SHARDED_REQUESTS, SHARDED_REQUEST_ROWS = 8, 64
# served logits (replicas on the card) against the dense apply over the
# reassembled table on the CPU, both f32 with TF32 off: sums of 429
# products in other orders
SHARDED_TOL = dict(rtol=1e-4, atol=1e-5)
# the MoE LM: the chip LM's width with top-2 of 8 experts, Mixtral 8x7B's
# routing (arXiv:2401.04088 §2.1), and the JAX package's capacity_factor
# 1.25 and sort dispatch; served like the slice (batches of BATCH_ROWS) and
# trained like the LM (AdamW, MOE_WARMUP + MOE_TIMED steps); depth cut to
# MOE_LAYERS (of the LM's 8) to keep the script well inside its time limit
MOE_LAYERS = 4
MOE_CONFIG = {**LM_CONFIG, "n_layers": MOE_LAYERS, "n_experts": 8, "moe_top_k": 2}
MOE_TRAIN_BATCH = 8
MOE_WARMUP, MOE_TIMED = 3, 10
MOE_STAGES = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")
# the kernel path and plain attention round at different places, a router
# logit near a top-2 boundary crosses it, and the token goes to another
# expert, so the served logits and one step's gradients are held against
# plain attention at the kernel path's routing (MoEMLP.replay) with
# LOGIT_REL_TOL / GRAD_REL_TOL.  The routing left free is gated on its own:
# the share of tokens a layer whose top-2 set differs between the two
# paths.  Sound readings (H100, seed 0): bf16 served 0.6-13.2% of 8192
# tokens a layer (growing with depth), bf16 train step 0.4-4.8% of 16384;
# f32 (3xTF32 against plain f32) 0-5 of 8192.  Bounds: bf16 20%, f32 0.5%
# (41 tokens).  A control fault, plain attention that also sees the next
# token (a causal mask off by one), is run with the routing free and its
# share reported beside them (PERF.md)
MOE_BF16_REROUTE_MAX = 0.20
MOE_F32_REROUTE_MAX = 0.005
# the f32 bundle at one routing (3xTF32 against plain f32, about 2^-20
# relative, sums in other orders through 8 layers): logits within 1e-3 of
# the largest
MOE_F32_LOGIT_REL_TOL = 1e-3
# ring attention's hop loop at the serving shape (B, S, H, D; causal bf16),
# the sequence cut into RING_SHARDS shards held in one process: every hop
# is one kernel launch, RING_SHARDS² in all.  Held against one causal
# kernel call over the whole sequence with O_TOL and LSE_TOL (each hop's O
# is rounded to bf16 by the kernel before the f32 merge), and its gradients
# through O and lse against the plain version's with GRAD_REL_TOL
RING_SHAPE = (4, 2048, 8, 128)
RING_SHARDS = 4
# pipeline parallelism: the LM at full width in PP_STAGES stages of
# n_layers / PP_STAGES blocks, PP_BATCH rows in PP_MICRO microbatches, the
# 1F1B schedule with every stage in this process.  Pipeline and sequential
# step see the same rows and round in bf16 at other places (microbatches
# of 2 rows against one batch of 8): loss within LOSS_REL_TOL, each group's
# gradients (stages, head, embedding) within GRAD_REL_TOL (relative L2).
# The f32 run (PP_F32_LAYERS layers, the 3xTF32 kernel) holds them to
# PP_F32_TOL: only the order of f32 sums differs.
PP_STAGES, PP_BATCH, PP_MICRO = 4, 8, 4
PP_WARMUP, PP_TIMED = 1, 3
PP_F32_LAYERS, PP_F32_BATCH, PP_F32_MICRO = 2, 4, 2
PP_F32_TOL = 1e-4
# sharded scoring: SCORE_ROWS rows of SEQ_LEN ids in SCORE_PARTS partitions
# through TorchModel.transform on one node, batches of SCORE_BATCH rows
SCORE_ROWS, SCORE_PARTS, SCORE_BATCH = 16, 4, 4


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_launches() -> None:
    """Every kernel's launch count to 0, just before a path is driven."""
    from tensorflowonspark_torch.ops import attention as att

    for name in att.LAUNCHES:
        att.LAUNCHES[name] = 0


@functools.cache
def _spin_cycles_per_ms() -> float:
    """Cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    import torch

    cycles = 10_000_000
    torch.cuda._sleep(cycles // 10)  # warm up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def time_ms(fn, reps: int = 50, windows: int = 5, warmup: int = 3):
    """``(device_ms, host_ms)`` of one ``fn()`` call.

    Device: ``reps`` calls back to back between one pair of CUDA events,
    over ``reps``; the median of ``windows`` windows.  Each window starts
    behind a spin kernel (``torch.cuda._sleep``) that outlasts the host's
    queueing of all ``reps`` calls, so the host's work per call (argument
    checks, allocation, the launch itself) never leaves the card idle
    inside the window.  Host: the wall time of queueing one call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    spin = int(2 * host_ms * reps * _spin_cycles_per_ms()) + 100_000
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times), host_ms


def live_pairs(sq: int, sk: int, causal: bool, kv_offset: int) -> int:
    """(query, key) pairs the mask keeps: the work this input needs."""
    if not causal:
        return sq * sk
    return sum(min(sk, max(0, i - kv_offset + 1)) for i in range(sq))


# the tensor-core rate of each route's input type (f32 at the TF32 rate)
PEAK_FLOPS = {"flash_attn_fwd": PEAK_BF16_FLOPS, "flash_attn_fwd_tf32": PEAK_TF32_FLOPS}
# what bound_ms bounds: the function's own work
FUNCTION_BASIS = ("the function's own products over the live pairs at the "
                  "unpadded head dim, at its type's tensor-core rate (989 TFLOP/s "
                  "bf16/fp16, 495 TF32 for f32), or its bytes at 3.35 TB/s")
# what bound_design_ms bounds: the work of the route's design on this input
DESIGN_BASIS = {
    "flash_attn_fwd": "the design: the products at the head dim it runs at at 989 TFLOP/s",
    "flash_attn_fwd_tf32": ("the 3xTF32 design: three TF32 products per f32 "
                            "product at the head dim it runs at at 495 TFLOP/s"),
}
TILE_BASIS = "; on a tile Q Kᵀ and P V at the tile's {} columns (all its k-steps)"
WIDE_BASIS = ("; on the wide route Q Kᵀ once per query tile, and once more per "
              "further {}-column group of O")


def attention_bound(b, sq, sk, h, d, causal, kv_offset, itemsize,
                    peak=PEAK_BF16_FLOPS, products=1, qk_times=1):
    """(bound_ms, bound_by): the larger of the time of ``products`` times
    the two products over the live pairs at ``peak`` FLOP/s (Q Kᵀ done
    ``qk_times`` times) and the time to move q, k, v, O and lse."""
    flops = products * 2 * d * (qk_times + 1) * b * h * live_pairs(sq, sk, causal, kv_offset)
    nbytes = (2 * b * sq * h * d + 2 * b * sk * h * d) * itemsize + b * sq * h * 4
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# exp2 results a clock on one SM (the SFU's rate at compute capability 9.0):
# at head dims up to 64 the softmax's exps may bound a call before its
# products or bytes do
SFU_EXPS_PER_CLOCK = 16
EXP_BOUND_MAX_D = 64


@functools.cache
def max_sm_clock_hz() -> float:
    """The card's highest SM clock (``nvidia-smi clocks.max.sm``), in Hz."""
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, timeout=30, check=True).stdout
    return float(out.split()[0]) * 1e6


def exp_bound(b, sq, sk, h, causal, kv_offset) -> tuple[int, float]:
    """(exps, ms): one exp per live (query, key) pair, at the SFU's rate on
    every SM of the card at its highest clock."""
    import torch

    exps = b * h * live_pairs(sq, sk, causal, kv_offset)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return exps, exps / (sms * SFU_EXPS_PER_CLOCK * max_sm_clock_hz()) * 1e3


def design_bound(route, b, sq, sk, h, d, padded, causal, kv_offset, itemsize):
    """(bound_ms, bound_by, basis) of ``route``'s design on this input: the
    products at the ``padded`` head dim (the one ``_route`` runs it at),
    three apiece on the 3xTF32 kernel; on a tile Q Kᵀ and P V at the
    tile's width (both kernels run all of a tile's k-steps), and on a wide
    route Q Kᵀ once per group of O's columns one CTA covers (the width from
    the kernel's library: one group up to D=512).  Not the function's bound: this is what the design must
    do, padding and recomputation included."""
    from tensorflowonspark_torch.ops import attention as att

    products = 3 if route == "flash_attn_fwd_tf32" else 1
    basis = DESIGN_BASIS[route]
    tiles = att._HEAD_DIMS[route]
    if padded <= tiles[-1]:
        tile = next(t for t in tiles if padded <= t)
        t_ops = (products * 2 * 2 * tile * b * h
                 * live_pairs(sq, sk, causal, kv_offset) / PEAK_FLOPS[route] * 1e3)
        # the bytes of the head dim it reads (an infinite rate: bytes only)
        t_bytes = attention_bound(b, sq, sk, h, padded, causal, kv_offset, itemsize,
                                  peak=math.inf)[0]
        return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
                basis + TILE_BASIS.format(tile))
    cols = getattr(att._kernel_lib(route), f"tos_{route}_cta_cols")()
    groups = -(-padded // cols)
    basis += WIDE_BASIS.format(cols)
    return (*attention_bound(b, sq, sk, h, padded, causal, kv_offset, itemsize,
                             PEAK_FLOPS[route], products, groups), basis)


def sdpa_choice(q, k, v, is_causal=True, attn_mask=None) -> str:
    """The ``F.scaled_dot_product_attention`` backend PyTorch picks for a
    call on these inputs (causal unless told otherwise)."""
    import torch
    from torch.nn.attention import SDPBackend

    try:
        return SDPBackend(torch._fused_sdp_choice(
            q, k, v, attn_mask=attn_mask, is_causal=is_causal)).name
    except (AttributeError, RuntimeError, TypeError, ValueError) as e:
        return f"unknown ({type(e).__name__})"


def phase_device():
    import torch

    from tensorflowonspark_torch.gpu_info import nvidia_smi_name_power

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_name_power()
    if not smi:
        raise RuntimeError("nvidia-smi reported no card")
    log(smi[0])  # name and power limit, as nvidia-smi prints them
    log(f"[device] torch: {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi[0]


KERNEL_LIBS = ("flash_attn_fwd", "flash_attn_fwd_tf32", "flash_attn_bwd",
               "flash_attn_bwd_tf32")
# the wgmma instantiations: (library, D, dtype name); D "wideW" is the wide
# route's kernel with W columns of O per consumer warpgroup
WGMMA_INSTANCES = ([("flash_attn_fwd", d, dt)
                    for d in (32, 64, 96, 128, 192, 256, "wide192", "wide256")
                    for dt in ("bfloat16", "float16")]
                   + [("flash_attn_fwd_tf32", d, "float32")
                      for d in (32, 64, 96, 128, "wide128", "wide192", "wide256")])
# reported by ptxas only: the 3xTF32 kernel's K/V pre-pass (its tiles), the
# wide route's V transpose, and the wide routes' split-KV combine kernels
COMBINE_KINDS = {"0": ("flash_attn_fwd", "bfloat16"), "1": ("flash_attn_fwd", "float16"),
                 "2": ("flash_attn_fwd_tf32", "float32")}
OTHER_INSTANCES = (("flash_attn_fwd_tf32", "split_kv", "float32"),
                   ("flash_attn_fwd_tf32", "transpose_v", "float32"),
                   *((lib, "combine", dt) for lib, dt in COMBINE_KINDS.values()),
                   ("flash_attn_bwd_tf32", "center", "float32"))
# the backward's wgmma kernels: the Δ pass, dK/dV and dQ on each tile, x
# bf16/fp16
BWD_INSTANCES = tuple(("flash_attn_bwd", f"{kind}{d}", dt)
                      for dt in ("bfloat16", "float16")
                      for kind in ("delta", "dkdv", "dq") for d in (32, 64, 96, 128))
# the f32 backward's mma.sync kernels (3xTF32): the Δ pass, dK/dV and dQ on
# each tile; held to no spill and to tensor-core instructions (MMA_SASS)
BWD_TF32_INSTANCES = tuple(("flash_attn_bwd_tf32", f"{kind}{d}", "float32")
                           for kind in ("delta", "dkdv", "dq") for d in (32, 64, 96, 128))
MMA_SASS = ("HMMA",)  # mma.sync


def kernel_key(text: str):
    """``(library, D, dtype name)`` of the kernel instantiation a mangled
    name in ``text`` names, or None."""
    m = re.search(r"flash_fwd_(wide_)?kernelILi(\d+)ELb([01])E", text)
    if m:
        d = f"wide{m.group(2)}" if m.group(1) else int(m.group(2))
        return ("flash_attn_fwd", d, "bfloat16" if m.group(3) == "1" else "float16")
    m = re.search(r"flash_fwd_tf32_(wide_)?kernelILi(\d+)E", text)
    if m:
        d = f"wide{m.group(2)}" if m.group(1) else int(m.group(2))
        return ("flash_attn_fwd_tf32", d, "float32")
    if "split_kv_kernel" in text:
        return OTHER_INSTANCES[0]
    if "transpose_v_kernel" in text:
        return OTHER_INSTANCES[1]
    m = re.search(r"combine_splits_kernelILi(\d)E", text)
    if m:
        lib, dt = COMBINE_KINDS[m.group(1)]
        return (lib, "combine", dt)
    m = re.search(r"flash_bwd_(delta|dkdv|dq)_kernelILi(\d+)ELb([01])E", text)
    if m:
        return ("flash_attn_bwd", f"{m.group(1)}{m.group(2)}",
                "bfloat16" if m.group(3) == "1" else "float16")
    m = re.search(r"flash_bwd_tf32_(delta|dkdv|dq)_kernelILi(\d+)E", text)
    if m:
        return ("flash_attn_bwd_tf32", f"{m.group(1)}{m.group(2)}", "float32")
    if "flash_bwd_tf32_center_kernel" in text:
        return OTHER_INSTANCES[-1]
    return None


def ptxas_report(log_text: str) -> dict:
    """``{kernel_key: {"registers", "spill_stores", "spill_loads"}}`` for
    each kernel instantiation, from nvcc's ``-Xptxas -v``, and
    ``"wgmma_serialized"`` where ptxas says it serialised the kernel's
    wgmma (its C75xx "Potential Performance Loss" notes)."""
    report, cur = {}, None
    for line in log_text.splitlines():
        key = kernel_key(line)
        if key and "wgmma.mma_async instructions are serialized" in line:
            report.setdefault(key, {})["wgmma_serialized"] = True  # C7510-C7520
        elif "Compiling entry" in line or "Function properties" in line:
            # an entry of no instantiation this script knows reports nowhere
            cur = report.setdefault(key, {}) if key else None
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
    return report


def sass_counts(lib_path, instructions=DESIGN_SASS) -> dict:
    """``{kernel_key: {instruction: count}}`` for ``instructions`` in each
    instantiation's SASS, from ``cuobjdump -sass`` of the library."""
    import subprocess
    from pathlib import Path

    from tensorflowonspark_torch.ops.cuda_build import find_nvcc

    tool = Path(find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            key = kernel_key(line)
            cur = None if key is None else counts.setdefault(
                key, dict.fromkeys(instructions, 0))
        elif cur is not None:
            for ins in cur:
                cur[ins] += ins in line
    return counts


def phase_build() -> dict:
    """Build the four kernel libraries from the checkout (one nvcc each,
    in parallel); print and return what ptxas and the SASS say about each
    ``wgmma`` instantiation, the backward's included (failing on a spill, a
    missing HGMMA/UTMALDG or wgmma that ptxas serialises), about the f32
    backward's ``mma.sync`` instantiations (failing on a spill or a
    missing HMMA), and what ptxas says about the 3xTF32 kernel's pre-passes
    and the combine kernels."""
    from tensorflowonspark_torch.ops import cuda_build

    t0 = time.perf_counter()
    libs = dict(zip(KERNEL_LIBS, cuda_build.load_libraries(*KERNEL_LIBS)))
    log(f"[build] built {', '.join(KERNEL_LIBS)} in {time.perf_counter() - t0:.1f} s")
    ptxas, sass = {}, {}
    for name in KERNEL_LIBS:
        text = cuda_build.build_log(name)
        for line in text.splitlines():
            if "error" in line or "warning" in line:
                log(f"[build] nvcc {name}: {line.strip()}")
        ptxas.update(ptxas_report(text))
        sass.update(sass_counts(cuda_build.library_path(name),
                                MMA_SASS if name == "flash_attn_bwd_tf32" else DESIGN_SASS))
    info = {}
    for key in (WGMMA_INSTANCES + list(OTHER_INSTANCES) + list(BWD_INSTANCES)
                + list(BWD_TF32_INSTANCES)):
        lib_name, d, dt = key
        regs, ins = ptxas.get(key), sass.get(key, {})
        if not regs:
            raise AssertionError(f"no ptxas report for {key}")
        label = f"D={d}" if isinstance(d, int) else d
        wide = isinstance(d, str)
        if key in BWD_INSTANCES or key in BWD_TF32_INSTANCES:
            smem = getattr(libs[lib_name], f"tos_{lib_name}_smem_bytes")(
                int(re.sub(r"\D", "", d)))
        else:
            smem = 0 if key in OTHER_INSTANCES else getattr(
                libs[lib_name], f"tos_{lib_name}_smem_bytes")(
                    int(d[4:]) if wide else d, int(wide))
        tag = {"flash_attn_fwd": "", "flash_attn_fwd_tf32": "tf32_",
               "flash_attn_bwd": "bwd_", "flash_attn_bwd_tf32": "bwd_tf32_"}[lib_name]
        info[f"{tag}{label.replace('=', '')}_{dt}"] = {**regs, "smem_bytes": smem, **ins}
        log(f"[build] {lib_name} {label} {dt}: {regs.get('registers')} registers, "
            f"{regs.get('spill_stores')} B spill stores, "
            f"{regs.get('spill_loads')} B spill loads, {smem} B dynamic shared "
            f"memory" + ("; SASS " + ", ".join(f"{k} x{v}" for k, v in ins.items())
                         if ins else ""))
        if key in WGMMA_INSTANCES or key in BWD_INSTANCES:
            if not (ins and all(ins.values())):
                raise AssertionError(f"{key}: SASS lacks one of {DESIGN_SASS}")
            if regs.get("spill_stores") or regs.get("spill_loads"):
                raise AssertionError(f"{key}: ptxas reports spills")
            if regs.get("wgmma_serialized"):
                raise AssertionError(f"{key}: ptxas serialises its wgmma")
        if key in BWD_TF32_INSTANCES and not (ins and all(ins.values())):
            raise AssertionError(f"{key}: SASS lacks one of {MMA_SASS}")
        if lib_name == "flash_attn_bwd_tf32" and (regs.get("spill_stores")
                                                  or regs.get("spill_loads")):
            raise AssertionError(f"{key}: ptxas reports spills")
    return info


def kernel_inputs(b, sq, sk, h, d, dtype, packed, gen, low_bits=False):
    import torch

    if packed:
        qkv = torch.randn((b, sq, 3, h, d), generator=gen, device="cuda").to(dtype)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    xs = [torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
          for s in (sq, sk, sk)]
    if low_bits:  # every one of the 13 mantissa bits a .tf32 operand drops set
        xs = [(x.view(torch.int32) | 0x1FFF).view(torch.float32) for x in xs]
    return tuple(xs)


def kernel_device_ms(fn, reps: int = 10) -> dict:
    """Device ms per ``fn()`` call of each kernel it launches, by kernel
    name (``torch.profiler`` over ``reps`` calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out: dict = {}
    for _ in range(3):  # a session without its device records is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if str(e.device_type).endswith("CUDA"):
                us = getattr(e, "device_time", 0) or getattr(e, "cuda_time", 0)
                out[e.name] = out.get(e.name, 0.0) + us / 1e3 / reps
        if out:
            break
    return out


def sdpa_backends(q, k, v, smi: str) -> dict:
    """``F.scaled_dot_product_attention`` under each backend of
    ``torch.nn.attention.sdpa_kernel``: its ms, or why it refused."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    out = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                out[backend.name] = time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True), reps=10, windows=3)[0]
        except RuntimeError as e:
            out[backend.name] = "refused: " + str(e).strip().splitlines()[0][:120]
    log(f"[kernel] f32 F.scaled_dot_product_attention by backend: "
        + "; ".join(f"{k} {v:.4f} ms" if isinstance(v, float) else f"{k} {v}"
                    for k, v in out.items()) + f" ({smi})")
    return out


def call_census(q, k, v, causal, off, route, name) -> dict:
    """What one ``flash_attn_fwd_cuda`` call runs, under ``torch.profiler``:
    the kernels on the card by name and the aten ops on the host.  Fails
    unless there is one attention kernel, a combine kernel only on a wide
    route (at most one), on the f32 route its one pre-pass (the tiles' K/V
    split, the wide route's V transpose) and nothing else, no padding or
    copy of q, k or v where the head dim is whole 16-byte rows, and one
    count in ``LAUNCHES``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tensorflowonspark_torch.ops import attention as att

    # the profiler now and then hands back a session without some or all of
    # its device records (CUPTI's buffer not flushed; seen dropping an f32
    # call's first kernel, its pre-pass): a session that lacks the attention
    # kernel, or on the f32 route the pre-pass, is taken again.  The checks
    # below hold the last session whole; the call's output is held against
    # the plain version before the census
    for _ in range(3):
        before = dict(att.LAUNCHES)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            att.flash_attn_fwd_cuda(q, k, v, causal=causal, kv_offset=off)
            torch.cuda.synchronize()
        launched = {n: c - before[n] for n, c in att.LAUNCHES.items()}
        kernels = [e.name for e in prof.events() if str(e.device_type).endswith("CUDA")]
        if (any("flash_fwd" in n for n in kernels)
                and (route != "flash_attn_fwd_tf32"
                     or any("transpose_v" in n or "split_kv" in n for n in kernels))):
            break
    host_ops = sorted({e.name for e in prof.events() if e.name.startswith("aten::")})
    attention = sum("flash_fwd" in n for n in kernels)
    combine = sum("combine_splits" in n for n in kernels)
    prepass = sum("transpose_v" in n or "split_kv" in n for n in kernels)
    run_d = att._route(q.dtype, q.shape[-1])[1]
    padded = run_d != q.shape[-1]
    wide = run_d > att._HEAD_DIMS[route][-1]
    copies = [op for op in host_ops
              if op in ("aten::constant_pad_nd", "aten::pad", "aten::copy_", "aten::clone",
                        "aten::contiguous", "aten::slice")]
    if (attention != 1 or combine > int(wide)
            or prepass != int(route == "flash_attn_fwd_tf32")
            or len(kernels) != attention + combine + prepass
            or launched != {n: int(n == route) for n in att.LAUNCHES}
            or (copies and not padded)):
        raise AssertionError(f"{name}: one call ran kernels {kernels}, host ops "
                             f"{host_ops}, launches {launched}")
    log(f"[kernel] {name}: one call runs {kernels} (host copies: {copies or 'none'})")
    return {"call_kernels": kernels, "call_copies": copies}


def phase_kernel(seed: int, smi: str) -> list[dict]:
    """Every route against ``chunk_attention`` at every case; returns the
    ``kernels`` records of the wgmma kernel and the 3xTF32 kernel."""
    import torch
    import torch.nn.functional as F

    from tensorflowonspark_torch.ops import attention as att

    log(f"[kernel] tolerance O {O_TOL}, lse {LSE_TOL} for bf16/fp16 (P and O "
        f"rounded on the kernel side), {F32_TOL} for f32 (kernel vs plain "
        "chunk_attention on the same inputs)")
    log(f"[kernel] timing: {time_ms.__defaults__[0]} launches back to back "
        f"between two CUDA events behind a spin kernel, median of "
        f"{time_ms.__defaults__[1]} windows ({smi})")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    timed = {}
    for name, b, sq, sk, h, d, causal, off, dtype_name, packed in \
            KERNEL_CASES + GENERIC_CASES:
        dtype = getattr(torch, dtype_name)
        q, k, v = kernel_inputs(b, sq, sk, h, d, dtype, packed, gen,
                                low_bits="low_bits" in name)
        route, padded = att._route(dtype, d)
        if packed and padded == d and att._kernel_operand(q) is not q:
            raise AssertionError(f"{name}: packed views were copied, not read in place")
        before = dict(att.LAUNCHES)
        o, lse = att.flash_attn_fwd_cuda(q, k, v, causal=causal, kv_offset=off)
        po, plse = att.chunk_attention(q, k, v, causal=causal, kv_offset=off)
        torch.cuda.synchronize()
        launched = {n: c - before[n] for n, c in att.LAUNCHES.items()}
        if launched != {n: int(n == route) for n in att.LAUNCHES}:
            raise AssertionError(f"{name}: launches {launched}, expected one of {route}")
        o_tol, lse_tol = (F32_TOL, F32_TOL) if dtype == torch.float32 else (O_TOL, LSE_TOL)
        torch.testing.assert_close(o.float(), po.float(), **o_tol)
        torch.testing.assert_close(lse, plse, **lse_tol)
        if not torch.isfinite(o).all():
            raise AssertionError(f"{name}: non-finite output")
        masked = plse <= att.NEG_INF / 2
        if masked.any():  # fully masked rows: exactly O = 0, lse = NEG_INF
            if not (lse[masked] == att.NEG_INF).all() or not (o[masked] == 0).all():
                raise AssertionError(f"{name}: fully masked rows not 0 / NEG_INF")
        if name.endswith("consumer_half_masked") and not (masked[:, :64].all()
                                                          and not masked[:, 64:].any()):
            raise AssertionError(f"{name}: expected rows 0..63, and only those, masked")
        err = max((o.float() - po.float()).abs().max().item(),
                  (lse - plse).abs().max().item())
        ms, host_ms = time_ms(lambda: att.flash_attn_fwd_cuda(
            q, k, v, causal=causal, kv_offset=off))
        tf32 = route == "flash_attn_fwd_tf32"
        bound_ms, bound_by = attention_bound(b, sq, sk, h, d, causal, off,
                                             q.element_size(), PEAK_FLOPS[route])
        tflops = 4 * d * b * h * live_pairs(sq, sk, causal, off) / (ms * 1e-3) / 1e12
        log(f"[kernel] {name}: ok ({route}, D {d} -> {padded}), max_abs_err "
            f"{err:.3e}, masked rows {int(masked.sum())}, {ms:.4f} ms, "
            f"{tflops:.1f} TFLOP/s, host {host_ms:.4f} ms per call (bound "
            f"{bound_ms:.5f} ms, {bound_by}, the function's own; share "
            f"{bound_ms / ms:.3f})")
        if name in REFERENCE_TIMED:
            plain_ms = time_ms(lambda: att.chunk_attention(
                q, k, v, causal=causal, kv_offset=off), reps=10, windows=3)[0]
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            # the same function: SDPA's is_causal aligns the top-left
            # corner, so a causal mask with a kv_offset or Sq != Sk goes in
            # as an explicit mask
            sdpa = dict(is_causal=causal)
            if causal and (sq != sk or off):
                sdpa = dict(attn_mask=att._causal_keep(sq, sk, off, q.device))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, **sdpa))[0]
            backend = sdpa_choice(qt, kt, vt, **sdpa)
            design_ms, design_by, design_basis = design_bound(
                route, b, sq, sk, h, d, padded, causal, off, q.element_size())
            rec = {"shape": (f"B={b} S={sq} H={h} D={d} causal {dtype_name}"
                             if sq == sk and causal and not off else
                             f"B={b} Sq={sq} Sk={sk} H={h} D={d} "
                             f"{'causal kv_offset ' + str(off) if causal else 'non-causal'}"
                             f" {dtype_name}"),
                   "padded_head_dim": padded,
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_basis": FUNCTION_BASIS, "bound_share": bound_ms / ms,
                   "bound_design_ms": design_ms, "bound_design_by": design_by,
                   "bound_design_basis": design_basis,
                   "bound_design_share": design_ms / ms,
                   "library_ms": library_ms, "library_backend": backend,
                   "host_ms": host_ms, "tflops": tflops}
            log(f"[kernel] {name}: plain {plain_ms:.4f} ms, "
                f"F.scaled_dot_product_attention {library_ms:.4f} ms ({backend}), "
                f"kernel / library {ms / library_ms:.3f}; bounds {bound_ms:.5f} ms "
                f"the function's own (share {bound_ms / ms:.3f}), {design_ms:.5f} ms "
                f"on {design_basis} (share {design_ms / ms:.3f}) ({smi})")
            if d <= EXP_BOUND_MAX_D:
                # arithmetic from an SFU rate outside the guide's table of
                # peaks: logged beside the kernel's time, not in its record
                exps, exp_ms = exp_bound(b, sq, sk, h, causal, off)
                log(f"[kernel] {name}: {exps} exps, {exp_ms:.5f} ms at "
                    f"{SFU_EXPS_PER_CLOCK} a clock on every SM at "
                    f"{max_sm_clock_hz() / 1e6:.0f} MHz (share "
                    f"{exp_ms / ms:.3f}) ({smi})")
            wide = padded > att._HEAD_DIMS[route][-1]
            rec.update(call_census(q, k, v, causal, off, route, name))
            if wide:
                rec["splits"] = att._wide_splits(route, b, h, sq, sk, padded, causal, off,
                                                 sm_count=att._sm_count(q.device))
            if tf32 or wide:
                parts = kernel_device_ms(lambda: att.flash_attn_fwd_cuda(
                    q, k, v, causal=causal, kv_offset=off))
                rec["prepass_ms"] = sum(t for n, t in parts.items()
                                        if "split_kv" in n or "transpose_v" in n)
                rec["attention_kernel_ms"] = sum(
                    t for n, t in parts.items() if "flash_fwd" in n)
                rec["combine_ms"] = sum(t for n, t in parts.items() if "combine_splits" in n)
                log(f"[kernel] {name}: pre-pass {rec['prepass_ms']:.4f} ms + "
                    f"attention kernel {rec['attention_kernel_ms']:.4f} ms + combine "
                    f"{rec['combine_ms']:.4f} ms (torch.profiler, device time per "
                    f"call) ({smi})")
            if tf32:
                rec["sdpa_backends"] = sdpa_backends(qt, kt, vt, smi)
            timed[name] = rec
            del qt, kt, vt
        del q, k, v, o, lse, po, plse
    torch.cuda.empty_cache()

    def record(name: str, case: str, **extra) -> dict:
        return {"name": name, "ok": True, "route": "cuda",
                "source": f"tensorflowonspark_torch/csrc/{name}.cu",
                "replaces": "tensorflowonspark_tpu/ops/attention.py:173",
                "launches": None, **timed[case], **extra}

    return [record("flash_attn_fwd", "serving_shape",
                   head_dim_64=timed["head_dim_64"], d256=timed["bf16_d256"],
                   d256_train_shape=timed["bf16_d256_train_shape"],
                   d32=timed["bf16_d32"], d96=timed["bf16_d96"], d192=timed["bf16_d192"],
                   example_lm_d32=timed["example_lm_d32_bf16"], d512=timed["bf16_d512"],
                   d320=timed["bf16_d320_ragged_noncausal"],
                   d320_causal=timed["bf16_d320_causal"],
                   d512_decode=timed["bf16_d512_sq_1_causal_decode"]),
            record("flash_attn_fwd_tf32", "f32_serving_shape",
                   example_lm_d32=timed["example_lm_d32_f32"],
                   d256=timed["f32_d256"], d512=timed["f32_d512"],
                   d320=timed["f32_d320"],
                   d256_decode=timed["f32_d256_sq_1_causal_decode"])]


def make_lm_params(cfg: dict, seed: int) -> dict:
    """Random f32 weights in the JAX package's bundle layout (flax names),
    normal with std 1/sqrt(fan_in); norm scales 1.  With ``n_experts`` each
    block has ``moe`` (router ``[D, E]``, expert stacks ``[E, D, F]`` and
    ``[E, F, D]``, fan-in per expert matrix) in place of ``mlp``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    v, d, h = cfg["vocab_size"], cfg["d_model"], cfg["n_heads"]
    dh, f = d // h, 4 * d

    def w(shape, fan_in):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(fan_in ** -0.5)

    ones = lambda: np.ones((d,), np.float32)  # noqa: E731
    params = {"embed": {"embedding": w((v, d), d)},
              "final_norm": {"scale": ones()},
              "lm_head": {"kernel": w((d, v), d)}}
    for i in range(cfg["n_layers"]):
        params[f"block_{i}"] = {
            "attn_norm": {"scale": ones()},
            "mlp_norm": {"scale": ones()},
            "attn": {**{n: {"kernel": w((d, h, dh), d)}
                        for n in ("q_proj", "k_proj", "v_proj")},
                     "o_proj": {"kernel": w((h, dh, d), d)}},
        }
        e = cfg.get("n_experts", 0)
        if e:
            params[f"block_{i}"]["moe"] = {
                "router": {"kernel": w((d, e), d)},
                "experts_gate": w((e, d, f), d), "experts_up": w((e, d, f), d),
                "experts_down": w((e, f, d), f)}
        else:
            params[f"block_{i}"]["mlp"] = {
                "gate_proj": {"kernel": w((d, f), d)},
                "up_proj": {"kernel": w((d, f), d)},
                "down_proj": {"kernel": w((f, d), f)}}
    return params


def phase_slice(seed: int, smi: str, device: str = "cuda") -> int:
    """Drive the replica on ``device``; returns the kernel's launches in
    that run."""
    from tensorflowonspark_torch.checkpoint import export_bundle

    t0 = time.perf_counter()
    params = make_lm_params(LM_CONFIG, seed)
    n_params = sum(a.size for blk in params.values() for a in _leaves(blk))
    export = os.path.join(WORK_DIR, "lm_bundle")
    export_bundle(export, params, LM_CONFIG)
    del params
    log(f"[slice] exported {n_params / 1e6:.1f} M f32 params in "
        f"{time.perf_counter() - t0:.1f} s")
    launches, batches = serve_and_check(export, LM_CONFIG, seed, "slice", smi, device)
    if device == "cuda":
        log_breakdown(export, batches[0], device, smi)
    return launches


def serve_and_check(export: str, cfg: dict, seed: int, tag: str, smi: str,
                    device: str = "cuda", reference=None) -> tuple[int, list]:
    """Drive ``serving_loop`` over ``export`` with the request batches of
    ``BATCH_ROWS`` (the last one partial, padded by the loop as the gateway
    pads it), a ping and a reload; check ordered, exactly counted, finite
    results, n_layers kernel launches per batch, and the logits against the
    same bundle with plain attention on the padded batch (``reference(params,
    padded) -> logits``, by default ``build_apply`` with ``attn_impl:
    xla``), at ``LOGIT_REL_TOL`` for a bf16 model and ``F32_LOGIT_REL_TOL``
    for an f32 one.  Returns the launches of the kernel the model's type and
    head dim route to (every count set to 0 just before the loop, read just
    after) and the request batches."""
    import numpy as np
    import torch

    from tensorflowonspark_torch import telemetry
    from tensorflowonspark_torch.checkpoint import invalidate_bundle
    from tensorflowonspark_torch.feeding import DataFeed, FeedQueues
    from tensorflowonspark_torch.marker import EndOfFeed, EndPartition, ResultChunk
    from tensorflowonspark_torch.models.registry import build_apply
    from tensorflowonspark_torch.ops import attention as att
    from tensorflowonspark_torch.serving.batcher import CTL_KEY
    from tensorflowonspark_torch.serving.loop import serving_loop

    bf16 = cfg.get("bf16", True)  # the transformer's default
    kernel = att._route(torch.bfloat16 if bf16 else torch.float32,
                        cfg.get("d_head") or cfg["d_model"] // cfg["n_heads"])[0]
    tol = LOGIT_REL_TOL if bf16 else F32_LOGIT_REL_TOL
    rng = np.random.default_rng(seed + 1)
    batches = [[rng.integers(0, cfg["vocab_size"], SEQ_LEN, dtype=np.int32)
                for _ in range(n)] for n in BATCH_ROWS]
    queues = FeedQueues(capacity=1024)
    q = queues.get_queue("input")
    for rows in batches:
        for r in rows:
            q.put(r)
        q.put(EndPartition())
    for ctl in ({CTL_KEY: "ping", "nonce": seed}, {CTL_KEY: "reload"}):
        q.put(ctl)
        q.put(EndPartition())
    q.put(EndOfFeed())

    round_secs: list[float] = []

    class TimedFeed(DataFeed):
        """Host clock from a batch handed to the loop to its results (which
        follow the copy of the logits to the host)."""

        def next_batch(self, n):
            out = super().next_batch(n)
            self._t = time.perf_counter()
            return out

        def batch_results(self, results, chunk=False):
            round_secs.append(time.perf_counter() - self._t)
            super().batch_results(results, chunk)

    class Ctx:
        metrics = telemetry.get_registry()

        def get_data_feed(self, train_mode=True):
            return TimedFeed(queues, train_mode=train_mode, poll_interval=0.05)

    invalidate_bundle()
    reset_launches()
    t0 = time.perf_counter()
    serving_loop({"export_dir": export, "max_batch": MAX_BATCH, "device": device},
                 Ctx())
    wall = time.perf_counter() - t0
    launches = att.LAUNCHES[kernel]
    log(f"[{tag}] serving_loop finished in {wall:.1f} s; {kernel} "
        f"launches {launches}")

    out = []
    oq = queues.get_queue("output")
    while not oq.empty():
        got = oq.get()
        out.extend(got.items if isinstance(got, ResultChunk) else [got])
    n_rows = sum(BATCH_ROWS)
    if len(out) != n_rows + 2:
        raise AssertionError(f"expected {n_rows} results + 2 acks, got {len(out)}")
    served, acks = out[:n_rows], out[n_rows:]
    if acks[0] != {CTL_KEY: "pong", "nonce": seed} or acks[1].get(CTL_KEY) != "reloaded":
        raise AssertionError(f"bad control acks: {acks}")
    want = cfg["n_layers"] * len(BATCH_ROWS) if device == "cuda" else 0
    if launches != want:
        raise AssertionError(f"[{tag}] kernel launches {launches} != n_layers x "
                             f"scored batches = {want}")
    for r in served:
        if r.shape != (SEQ_LEN, cfg["vocab_size"]) or r.dtype != np.float32 \
                or not np.isfinite(r).all():
            raise AssertionError("served logits not finite f32 [S, V]")

    # the same bundle with plain (blockwise) attention on the card, per batch:
    # agreement row by row also proves the results came back in order
    from tensorflowonspark_torch.checkpoint import load_bundle

    ref_params, _ = load_bundle(export)
    if reference is None:
        reference = build_apply({**cfg, "attn_impl": "xla"}, device=device)
    start = 0
    worst = 0.0
    agree = []
    for rows in batches:
        padded = rows + [rows[-1]] * (MAX_BATCH - len(rows))
        before = att.LAUNCHES[kernel]
        ref = reference(ref_params, np.stack(padded))[:len(rows)]
        if att.LAUNCHES[kernel] != before:
            raise AssertionError("the plain-attention reference launched the kernel")
        got = torch.from_numpy(np.stack(served[start:start + len(rows)])).to(device)
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        worst = max(worst, err / scale)
        agree.append((got.argmax(-1) == ref.argmax(-1)).float().mean().item())
        if err > tol * scale:
            raise AssertionError(f"served logits differ from plain attention by "
                                 f"{err:.4g} > {tol} x {scale:.3f}")
        start += len(rows)
    log(f"[{tag}] logits vs plain attention: worst max_abs_err/max|logit| "
        f"{worst:.4g} (limit {tol}), argmax agreement "
        f"{', '.join(f'{a:.4f}' for a in agree)}")
    for i, (secs, rows) in enumerate(zip(round_secs, BATCH_ROWS)):
        log(f"[{tag}] batch {i}: {rows} rows x {SEQ_LEN} tokens, "
            f"{secs * 1e3:.1f} ms, {rows * SEQ_LEN / secs:.0f} tokens/s "
            f"({smi})")
    return launches, batches


def phase_cluster(seed: int, smi: str, device: str = "cuda") -> dict:
    """Serve the slice's bundle through the port's cluster: two replica node
    processes on the card behind ``cluster.serve``; requests through
    ``gateway.predict`` and the TCP ``GatewayClient``, then a hot reload.
    Returns the kernel launches the replicas report and the timings."""
    import numpy as np
    import torch

    from tensorflowonspark_torch import cluster as tcluster
    from tensorflowonspark_torch.checkpoint import export_bundle
    from tensorflowonspark_torch.models.registry import build_apply
    from tensorflowonspark_torch.serving import GatewayClient, serving_loop

    export = os.path.join(WORK_DIR, "lm_bundle")  # the slice phase's bundle
    cuda = device == "cuda"
    rng = np.random.default_rng(seed + 5)
    requests = [[rng.integers(0, LM_CONFIG["vocab_size"], SEQ_LEN, dtype=np.int32)
                 for _ in range(n)] for n in (*CLUSTER_ROWS, 1)]
    t0 = time.perf_counter()
    cluster = tcluster.run(
        serving_loop, {"export_dir": export, "max_batch": MAX_BATCH, "device": device},
        num_executors=CLUSTER_NODES, input_mode=tcluster.InputMode.STREAMING,
        log_dir=os.path.join(WORK_DIR, "cluster_logs"), heartbeat_interval=0.5,
        reservation_timeout=300)
    served, latency, reloaded = [], [], None
    try:
        up_s = time.perf_counter() - t0
        for meta in cluster.cluster_info:
            dev = meta["device"]
            want = ("gpu", torch.cuda.get_device_name(0)) if cuda else ("cpu", "cpu")
            if (dev["platform"], dev["device_kind"]) != want:
                raise AssertionError(f"node {meta['executor_id']} registered {dev}, "
                                     f"expected {want}")
        log(f"[cluster] {CLUSTER_NODES} replica node processes up in {up_s:.1f} s; "
            f"registered devices: "
            + "; ".join(f"{m['executor_id']}: {m['device']['platform']} "
                        f"{m['device']['device_kind']}" for m in cluster.cluster_info))
        gw = cluster.serve(export, max_batch=MAX_BATCH, max_delay_ms=2.0,
                           reload_poll_secs=0)
        for rows in requests[:-1]:
            t = time.perf_counter()
            served.append(gw.predict(rows, timeout=600.0))
            latency.append(time.perf_counter() - t)
        client = GatewayClient("127.0.0.1", gw.endpoint[1], cluster.authkey)
        try:
            t = time.perf_counter()
            served.append(client.predict(requests[-1], timeout=600.0))
            latency.append(time.perf_counter() - t)
        finally:
            client.close()
        # hot reload: other weights into the same export_dir
        other = make_lm_params(LM_CONFIG, seed + 7)
        export_bundle(export, other, LM_CONFIG)
        del other
        t = time.perf_counter()
        acks = gw.reload()
        reload_s = time.perf_counter() - t
        reloaded = gw.predict(requests[0][:1], timeout=600.0)[0]
    finally:
        cluster.shutdown(timeout=300.0)
    metrics = cluster.metrics()
    nodes = {k: v for k, v in metrics["nodes"].items() if k != "driver"}

    def node_sum(name):
        return sum((v.get("counters") or {}).get(name, 0) for v in nodes.values())

    batches, launches = node_sum("serve.node_batches"), node_sum("attn.flash_fwd_launches")
    per_batch = LM_CONFIG["n_layers"] if cuda else 0  # the CPU path has no kernel
    log(f"[cluster] replicas: {batches} served batches, {launches} kernel launches "
        f"(attn.flash_fwd_launches; expected {per_batch} per batch), reload acked "
        f"by {sorted(acks)} in {reload_s:.1f} s")
    if len(nodes) != CLUSTER_NODES or batches < len(requests):
        raise AssertionError(f"replica metrics from {sorted(nodes)}: {batches} batches")
    if launches != per_batch * batches:
        raise AssertionError(f"replica kernel launches {launches} != "
                             f"{per_batch} x {batches} served batches")

    # ordered, exactly-count results; one row of each request against the
    # in-process replica on the same bundle as the slice exported it
    if [len(r) for r in served] != [len(r) for r in requests]:
        raise AssertionError(f"result counts {[len(r) for r in served]} != "
                             f"request rows {[len(r) for r in requests]}")
    params = make_lm_params(LM_CONFIG, seed)  # what the slice phase exported
    apply = build_apply(LM_CONFIG, device=device)
    worst = 0.0
    for i, (rows, got) in enumerate(zip(requests, served)):
        j = len(rows) - 1  # the last row: order within the request
        ref = apply(params, np.stack([rows[j]] * MAX_BATCH))[0]
        row = torch.from_numpy(np.asarray(got[j])).to(device)
        if row.shape != (SEQ_LEN, LM_CONFIG["vocab_size"]) or not torch.isfinite(row).all():
            raise AssertionError(f"request {i}: served logits not finite [S, V]")
        scale = ref.abs().max().item()
        err = (row - ref).abs().max().item()
        worst = max(worst, err / scale)
        if err > LOGIT_REL_TOL * scale:
            raise AssertionError(f"request {i}: served logits differ from the "
                                 f"in-process replica by {err:.4f} > "
                                 f"{LOGIT_REL_TOL} x {scale:.3f}")
    first = np.asarray(served[0][0])
    changed = float(np.abs(np.asarray(reloaded) - first).max())
    if not changed > 0.0:
        raise AssertionError("predictions did not change after the hot reload")
    # the replicas' own digests (the driver's registry holds the slice's)
    digests = [(v.get("histograms") or {}).get("serve.node_batch_secs") or {}
               for v in nodes.values()]
    count = sum(d.get("count", 0) for d in digests)
    node_ms = [1e3 * min(d["min"] for d in digests if d.get("count")),
               1e3 * sum(d.get("sum", 0.0) for d in digests) / max(count, 1),
               1e3 * max(d["max"] for d in digests if d.get("count"))]
    log(f"[cluster] logits vs the in-process replica: worst max_abs_err/max|logit| "
        f"{worst:.4f} (limit {LOGIT_REL_TOL}); after the reload the first row "
        f"moved by up to {changed:.3f}")
    for n, secs in zip([len(r) for r in requests], latency):
        log(f"[cluster] request of {n} row(s) x {SEQ_LEN} tokens: {secs * 1e3:.1f} ms "
            f"host clock ({n * SEQ_LEN * LM_CONFIG['vocab_size'] * 4 / 1e9:.2f} GB "
            f"of f32 logits back) ({smi})")
    log(f"[cluster] replicas' serve.node_batch_secs (forward + logits to host, "
        f"{count} batches): min {node_ms[0]:.1f} / mean {node_ms[1]:.1f} / max "
        f"{node_ms[2]:.1f} ms ({smi})")
    return {"launches": launches, "batches": batches,
            "request_ms": [x * 1e3 for x in latency], "node_batch_ms": node_ms,
            "reload_s": reload_s, "logit_rel_err": worst}


def host_cpu() -> str:
    """The host's CPU as ``/proc/cpuinfo`` names it, with its core count:
    the model name, and where that says "unknown" (a virtual machine's CPU
    may) or is missing, the vendor, family and model numbers."""
    import platform

    fields: dict = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = fields.get("model name", "")
    if not name or name.lower() == "unknown":
        ids = [f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model", "CPU part")
               if k in fields]
        name = f"model name {name or 'absent'} ({', '.join(ids) or platform.machine()})"
    return f"{name}, {os.cpu_count()} cores"


def lm_param_bytes(cfg: dict) -> int:
    """The bytes of an f32 dense LM's params (``make_lm_params``' shapes)."""
    v, d, layers = cfg["vocab_size"], cfg["d_model"], cfg["n_layers"]
    width = cfg["n_heads"] * cfg.get("d_head", d // cfg["n_heads"])
    f = cfg.get("d_ff", 4 * d)
    per_layer = 2 * d + 4 * d * width + 3 * d * f
    return 4 * (2 * v * d + d + layers * per_layer)


def decode_rate(store) -> dict:
    """The zstd decoder's output MB/s over every chunk frame of ``store``
    (an ``OcdbtStore``): the frames decoded again and again into one
    buffer until ``ORBAX_RATE_BYTES`` have come out, ``ORBAX_RATE_WINDOWS``
    windows, host clock; the median and the spread."""
    import statistics

    import numpy as np

    from tensorflowonspark_torch.orbax_layout import zstd

    frames = [store.read(k) for k in store.list() if not k.endswith("/.zarray")]
    out = np.empty(max(len(zstd.decompress(f)) for f in frames), np.uint8)
    rates = []
    for _ in range(ORBAX_RATE_WINDOWS):
        done, t0 = 0, time.perf_counter()
        while done < ORBAX_RATE_BYTES:
            for f in frames:
                done += zstd.decompress_into(f, out)
        rates.append(done / (time.perf_counter() - t0) / 1e6)
    return {"frames": len(frames), "compressed_bytes": sum(len(f) for f in frames),
            "mb_s": statistics.median(rates), "mb_s_min": min(rates),
            "mb_s_max": max(rates)}


def phase_orbax_bundle(seed: int, smi: str, device: str = "cuda") -> dict:
    """The JAX package's orbax bundle (``ORBAX_FIXTURE``) read and served
    by the port with none of JAX, orbax, tensorstore or a zstd library
    loaded: (a) ``load_bundle`` (the decoder built from the checkout at
    first use) bit for bit against ``expected.json``; (b) ``serve_and_check``
    through the kernel the f32 model routes to; (c) ``build_apply`` against
    the JAX forward's logits.  Prints the load's cost and the decoder's
    rate beside the card and the host's CPU; returns the numbers and the
    serving loop's launches."""
    import hashlib
    import statistics

    import numpy as np
    import torch

    from tensorflowonspark_torch.checkpoint import load_bundle
    from tensorflowonspark_torch.models.registry import build_apply
    from tensorflowonspark_torch.ops import attention as att
    from tensorflowonspark_torch.orbax_layout import zstd
    from tensorflowonspark_torch.orbax_layout.ocdbt import OcdbtStore

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ORBAX_FORBIDDEN)
    if loaded:
        raise AssertionError(f"[orbax] modules the port must not need are loaded: {loaded}")
    cpu = host_cpu()
    with open(os.path.join(ORBAX_FIXTURE, "expected.json")) as f:
        expected = json.load(f)
    cfg = expected["config"]
    disk = sum(os.path.getsize(os.path.join(d, n))
               for d, _, names in os.walk(os.path.join(ORBAX_FIXTURE, "params")) for n in names)
    t0 = time.perf_counter()
    zstd._lib()  # g++ of zstd_decode.cc (or the cached library)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    params, config = load_bundle(ORBAX_FIXTURE)
    cold_s = time.perf_counter() - t0
    warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        load_bundle(ORBAX_FIXTURE)
        warm.append(time.perf_counter() - t0)
    if config != cfg:
        raise AssertionError(f"[orbax] bundle.json {config} != expected {cfg}")

    # (a) every leaf bit for bit
    got = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}" if path else k)
            return
        a = np.ascontiguousarray(node)
        got.append({"path": path, "dtype": str(a.dtype), "shape": list(a.shape),
                    "sha256": hashlib.sha256(a.tobytes()).hexdigest()})

    walk(params, "")
    if got != expected["leaves"]:
        bad = [w["path"] for g, w in zip(got, expected["leaves"]) if g != w]
        raise AssertionError(f"[orbax] leaves differ from expected.json: {bad or 'the lists'}")
    log(f"[orbax] load_bundle of the JAX package's orbax bundle ({len(got)} leaves, "
        f"{disk / 1e6:.3f} MB on disk): every leaf's dtype, shape and SHA-256 match "
        f"expected.json; decoder build {build_s:.2f} s, load cold {cold_s * 1e3:.1f} ms, "
        f"warm median {statistics.median(warm) * 1e3:.1f} ms (host clock; {smi}; {cpu})")

    # (b) served through the kernel its type routes to
    launches, _ = serve_and_check(ORBAX_FIXTURE, cfg, seed, "orbax", smi, device)
    kernel = att._route(torch.float32, cfg["d_head"])[0]

    # (c) the card's logits against the JAX package's
    ids = np.asarray(expected["ids"], np.int32)
    want = np.load(os.path.join(ORBAX_FIXTURE, expected["logits"]))
    apply = build_apply(cfg, device=device)
    reset_launches()
    out = apply(params, ids)
    forward_launches = att.LAUNCHES[kernel]
    if forward_launches != (cfg["n_layers"] if device == "cuda" else 0):
        raise AssertionError(f"[orbax] the forward launched {kernel} {forward_launches} "
                             f"times, expected n_layers")
    out = out.float().cpu().numpy()
    if out.shape != want.shape or not np.isfinite(out).all():
        raise AssertionError(f"[orbax] logits {out.shape} not finite of shape {want.shape}")
    scale = float(np.abs(want).max())
    err = float(np.abs(out - want).max())
    if err > ORBAX_LOGIT_TOL * scale:
        raise AssertionError(f"[orbax] logits differ from the JAX package's by {err:.3g} > "
                             f"{ORBAX_LOGIT_TOL} x {scale:.3f}")
    log(f"[orbax] build_apply on {device} vs the JAX forward's logits "
        f"{list(want.shape)}: max_abs_err {err:.3g}, {err / scale:.3g} of max|logit| "
        f"{scale:.3f} (limit {ORBAX_LOGIT_TOL}); {kernel} launches {forward_launches}")

    # the decoder's rate, and what it says of a bundle at the LM width
    rate = decode_rate(OcdbtStore(os.path.join(ORBAX_FIXTURE, "params")))
    full = lm_param_bytes(LM_CONFIG)
    estimate = full / 1e6 / rate["mb_s"]
    log(f"[orbax] zstd decoder: {rate['frames']} chunk frames "
        f"({rate['compressed_bytes'] / 1e6:.3f} MB), output {rate['mb_s']:.1f} MB/s "
        f"median of {ORBAX_RATE_WINDOWS} windows of >= {ORBAX_RATE_BYTES >> 20} MiB "
        f"(min {rate['mb_s_min']:.1f}, max {rate['mb_s_max']:.1f}; host clock, one "
        f"thread; {cpu}; {smi})")
    log(f"[orbax] estimate, not measured: a bundle at the LM width "
        f"(vocab {LM_CONFIG['vocab_size']}, d_model {LM_CONFIG['d_model']}, "
        f"{LM_CONFIG['n_layers']} layers) holds {full / 1e6:.1f} MB of f32 params; "
        f"{full / 1e6:.1f} MB / {rate['mb_s']:.1f} MB/s = {estimate:.2f} s of zstd "
        f"decoding to load it ({cpu})")
    return {"launches": launches, "forward_launches": forward_launches,
            "fixture_mb": disk / 1e6, "build_s": build_s, "load_cold_s": cold_s,
            "load_warm_s": statistics.median(warm), "decode_mb_s": rate["mb_s"],
            "logit_rel_err_vs_jax": err / scale, "host_cpu": cpu}


def log_breakdown(export: str, rows: list, device: str, smi: str) -> None:
    """Where a served batch's time goes: the forward on the card (CUDA
    events), the kernels that forward launches with their summed device
    time (``torch.profiler``), and the copy of its f32 logits to the host
    (host clock).  Runs after the launch count was read."""

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tensorflowonspark_torch.checkpoint import load_bundle_cached
    from tensorflowonspark_torch.inference import to_host
    from tensorflowonspark_torch.models.registry import build_apply

    variables, _, apply_fn = load_bundle_cached(
        export, functools.partial(build_apply, device=device))
    x = np.stack(rows)
    fwd_ms = time_ms(lambda: apply_fn(variables, x), reps=5, windows=3, warmup=1)[0]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        apply_fn(variables, x)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    kernel_ms = sum(getattr(e, "device_time", 0) or getattr(e, "cuda_time", 0)
                    for e in kernels) / 1e3
    log(f"[slice] census of one forward, {len(rows)} rows: {len(kernels)} "
        f"kernels, {kernel_ms:.3f} ms of kernel time (torch.profiler) ({smi})")
    out = apply_fn(variables, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    to_host(out)
    copy_ms = (time.perf_counter() - t0) * 1e3
    log(f"[slice] breakdown, {len(rows)} rows: forward {fwd_ms:.2f} ms on the "
        f"card, logits to host {copy_ms:.1f} ms "
        f"({out.numel() * out.element_size() / 1e9:.2f} GB) ({smi})")


# the backward kernels timed beside the training shape (name, B, S, H, D;
# causal bf16): the example LM's attention (EXAMPLE_LM_CONFIG at its batch
# and sequence) and head dim 64 at the training tokens
BWD_SHAPES = (("example_lm_d32", 8, 1024, 8, 32), ("d64", 4, 2048, 16, 64))
# the f32 backward's shapes (causal): the f32 LM step's (F32_TRAIN_BATCH x
# SEQ_LEN, 8 heads of 128) and the example LM's (EXAMPLE_BATCH x
# EXAMPLE_SEQ, 8 heads of 32)
BWD_F32_SHAPES = (("f32_train_shape", 2, 2048, 8, 128), ("example_lm_d32", 8, 1024, 8, 32))


def bwd_timing(q, k, v, lse, cot, smi: str, label: str, recompute: bool = False) -> dict:
    """The backward kernels of ``q``'s type (``_bwd_route``) on causal
    ``q, k, v`` with the forward's ``lse`` and the ``out`` cotangent
    ``cot``: held against the plain version (one launch, dq, dk, dv finite
    and within ``BWD_REL_TOL`` relative L2, f32 ``BWD_F32_REL_TOL``) and
    timed beside the function's bound (at its type's tensor-core rate),
    the design's (nine products, f32 each as three TF32 products), the
    plain version, the library's backward (SDPA under autograd, the
    backend named) and, from ``torch.profiler``, the Δ, dK/dV and dQ
    kernels apart (and the f32 kernels' centring pre-pass); host ms to
    queue a call; with ``recompute`` also the
    recompute VJP through ``blockwise_attention`` on the same inputs."""
    import torch
    import torch.nn.functional as F

    from tensorflowonspark_torch.ops import attention as att

    b, s, h, d = q.shape
    f32 = q.dtype == torch.float32
    route = att._bwd_route(q.dtype, d)[0]
    tol = BWD_F32_REL_TOL if f32 else BWD_REL_TOL
    args = (q, k, v, lse, cot, None, True, None, 0)
    reset_launches()
    got = torch.ops.tos.flash_attn_bwd(*args)
    torch.cuda.synchronize()
    launched = dict(att.LAUNCHES)
    if launched != {n: int(n == route) for n in att.LAUNCHES}:
        raise AssertionError(f"[attn-train] {label}: one backward call launched {launched}")
    want = att.flash_attn_bwd_reference(q, k, v, lse, cot, None, causal=True)
    rel = {n: rel_l2(x, y) for n, x, y in zip(("dq", "dk", "dv"), got, want)}
    err = max((x.float() - y.float()).abs().max().item() for x, y in zip(got, want))
    shape = f"B={b} S={s} H={h} D={d} causal {str(q.dtype).removeprefix('torch.')}"
    why = ("every product 3xTF32" if f32
           else "P and dS rounded to bf16 as product operands")
    log(f"[attn-train] backward kernels ({route}) vs flash_attn_bwd_reference, {label} "
        f"({shape}): rel L2 " + ", ".join(f"{n} {e:.3e}" for n, e in rel.items())
        + f" (limit {tol} each: {why}), max_abs_err {err:.3e}")
    if max(rel.values()) > tol or not all(torch.isfinite(x).all() for x in got):
        raise AssertionError(f"[attn-train] {label}: the backward kernels disagree with "
                             "the plain version")
    del got, want
    ms, host_ms = time_ms(lambda: torch.ops.tos.flash_attn_bwd(*args))
    plain_ms = time_ms(lambda: att.flash_attn_bwd_reference(
        q, k, v, lse, cot, None, causal=True), reps=3, windows=3, warmup=1)[0]
    # each kernel's mean device time over the launches the profiler recorded
    # (a session may drop some of a window's records)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            torch.ops.tos.flash_attn_bwd(*args)
        torch.cuda.synchronize()
    launches: dict = {}
    for e in prof.events():
        m = re.search(r"flash_bwd_(?:tf32_)?(center|delta|dkdv|dq)_kernel", e.name)
        if m and str(e.device_type).endswith("CUDA"):
            us = getattr(e, "device_time", 0) or getattr(e, "cuda_time", 0)
            launches.setdefault(f"{m.group(1)}_ms", []).append(us / 1e3)
    split = {n: statistics.mean(v) for n, v in launches.items()}
    # the function: S = QK^T again, dP = dO V^T, dV = P^T dO, dQ = dS K,
    # dK = dS^T Q, five products over the live pairs at the type's
    # tensor-core rate (f32 at TF32's); q, k, v, dO and lse read, dq, dk, dv
    # written.  The design: the Δ, dK/dV and dQ walks each compute S and
    # dP, nine products, f32 each as three TF32 products
    peak = PEAK_TF32_FLOPS if f32 else PEAK_BF16_FLOPS
    t_ops = 10 * d * b * h * live_pairs(s, s, True, 0) / peak
    t_bytes = (7 * b * s * h * d * q.element_size() + b * s * h * 4) / PEAK_BYTES
    bound, by = max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"
    products = 27 if f32 else 9
    design = max(t_ops * products / 5, t_bytes) * 1e3
    qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    cot_t = cot.transpose(1, 2).contiguous()
    library_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), cot_t, retain_graph=True), reps=5, windows=3)[0]
    library = sdpa_choice(qt, kt, vt)
    del qt, kt, vt, lib_out, cot_t
    nine = "nine, each three TF32 products," if f32 else "nine"
    log(f"[attn-train] backward kernels (tos::flash_attn_bwd -> {route}: Δ, dK/dV, dQ; "
        f"no atomics), {label}: {ms:.4f} ms, host {host_ms:.4f} ms per call (bound "
        f"{bound:.5f} ms, {by}, the function's five products, share {bound / ms:.4f}; the "
        f"design's {nine} {design:.5f} ms, share {design / ms:.4f}); kernels "
        + ", ".join(f"{n} {v:.4f}" for n, v in split.items())
        + f" ms; plain version {plain_ms:.4f} ms; library backward {library_ms:.4f} ms "
        f"({library}; the kernels take {ms / library_ms:.2f}x its time) ({smi})")
    out = {"shape": shape, "max_abs_err": err, "rel_l2": rel, "rel_l2_limit": tol,
           "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": by,
           "bound_basis": "the function's five products over the live pairs at "
                          + ("495 TFLOP/s (TF32)" if f32 else "989 TFLOP/s")
                          + ", or q, k, v, dO, lse, dq, dk, dv at 3.35 TB/s",
           "bound_share": bound / ms, "bound_design_ms": design,
           "bound_design_basis": "nine products (the Δ, dK/dV and dQ walks each "
                                 "compute S and dP)"
                                 + (", each as three TF32 products" if f32 else ""),
           "kernels_ms": split, "library_ms": library_ms, "library_backend": library}
    if recompute:
        # what the kernels replace on this route: the recompute VJP
        out["recompute_ms"] = time_ms(
            lambda: att._recompute_bwd(q, k, v, cot, None, True, None, 0),
            reps=3, windows=3, warmup=1)[0]
        log(f"[attn-train] {label}: the recompute VJP through blockwise_attention "
            f"(block_k {att.BWD_BLOCK_K}) the kernels replace {out['recompute_ms']:.4f} ms, "
            f"{out['recompute_ms'] / ms:.1f}x the kernels ({smi})")
    return out


def phase_attention_train_shape(seed: int, smi: str) -> tuple[dict, dict, dict]:
    """The kernel's forward and the backward kernels at the training shape,
    each held against its plain version and timed beside its bound, the
    plain version and the library call, and the backward kernels so at
    ``BWD_SHAPES`` too (``bwd_timing``); the recompute VJP the backward
    kernels replace timed once; then the f32 backward kernels so at
    ``BWD_F32_SHAPES``, each beside the recompute VJP they replace.
    Returns the forward's numbers and the two backwards' ``kernels``
    records."""
    import torch
    import torch.nn.functional as F

    from tensorflowonspark_torch.ops import attention as att

    b, s, h, d = TRAIN_BATCH, SEQ_LEN, LM_CONFIG["n_heads"], \
        LM_CONFIG["d_model"] // LM_CONFIG["n_heads"]
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    q, k, v = kernel_inputs(b, s, s, h, d, torch.bfloat16, False, gen)
    cot = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    o, lse = att.flash_attn_fwd_cuda(q, k, v, causal=True)
    po, plse = att.chunk_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), po.float(), **O_TOL)
    torch.testing.assert_close(lse, plse, **LSE_TOL)
    err = max((o.float() - po.float()).abs().max().item(),
              (lse - plse).abs().max().item())
    del po, plse
    fwd_ms = time_ms(lambda: att.flash_attn_fwd_cuda(q, k, v, causal=True))[0]
    fwd_bound, fwd_by = attention_bound(b, s, s, h, d, True, 0, 2)
    plain_ms = time_ms(lambda: att.chunk_attention(q, k, v, causal=True),
                       reps=5, windows=3)[0]
    shape = f"B={b} S={s} H={h} D={d} causal bfloat16"
    qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    fwd_library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt.detach(), kt.detach(), vt.detach(), is_causal=True))[0]
    del qt, kt, vt
    log(f"[attn-train] {shape}: kernel vs plain ok, max_abs_err {err:.3e} "
        f"(tolerance O {O_TOL}, lse {LSE_TOL}); kernel forward {fwd_ms:.4f} ms (bound "
        f"{fwd_bound:.5f} ms, {fwd_by}, share {fwd_bound / fwd_ms:.3f}); plain "
        f"{plain_ms:.4f} ms; F.scaled_dot_product_attention {fwd_library_ms:.4f} ms "
        f"({smi})")

    bwd = bwd_timing(q, k, v, lse, cot, smi, "training shape")
    # what the kernels replace on this route: the recompute VJP through
    # blockwise_attention (f32 and heads above 128 still take it), once
    recompute_ms = time_ms(lambda: att._recompute_bwd(q, k, v, cot, None, True, None, 0),
                           reps=3, windows=3, warmup=1)[0]
    # and FlashAttention's whole backward under autograd, the kernels' caller
    qkv = [x.detach().requires_grad_() for x in (q, k, v)]
    out = att.flash_attention(*qkv, causal=True)
    autograd_ms = time_ms(lambda: torch.autograd.grad(out, qkv, cot, retain_graph=True),
                          reps=10, windows=3)[0]
    log(f"[attn-train] backward under autograd {autograd_ms:.4f} ms; the recompute VJP "
        f"through blockwise_attention (block_k {att.BWD_BLOCK_K}) the kernels replace "
        f"{recompute_ms:.4f} ms ({smi})")
    del out, qkv
    fwd = {"shape": shape, "max_abs_err": err, "ms": fwd_ms,
           "bound_ms": fwd_bound, "bound_by": fwd_by,
           "plain_ms": plain_ms, "library_ms": fwd_library_ms}
    bwd = {"name": "flash_attn_bwd", "ok": True, "route": "cuda",
           "source": "tensorflowonspark_torch/csrc/flash_attn_bwd.cu",
           "replaces": "tensorflowonspark_tpu/ops/attention.py:299",
           "launches": None, **bwd, "autograd_ms": autograd_ms, "recompute_ms": recompute_ms}
    # the other head dims of the main paths: the example LM's (4 launches a
    # bf16 step) and 64
    for name, b, s, h, d in BWD_SHAPES:
        del q, k, v, cot, lse
        torch.cuda.empty_cache()
        q, k, v = kernel_inputs(b, s, s, h, d, torch.bfloat16, False, gen)
        cot = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
        _, lse = att.flash_attn_fwd_cuda(q, k, v, causal=True)
        bwd[name] = bwd_timing(q, k, v, lse, cot, smi, name)
    # the f32 backward (3xTF32): the f32 LM step's shape first, the record's
    # own numbers, then the example LM's
    bwd_tf32 = {"name": "flash_attn_bwd_tf32", "ok": True, "route": "cuda",
                "source": "tensorflowonspark_torch/csrc/flash_attn_bwd_tf32.cu",
                "replaces": "tensorflowonspark_tpu/ops/attention.py:299", "launches": None}
    for name, b, s, h, d in BWD_F32_SHAPES:
        del q, k, v, cot, lse
        torch.cuda.empty_cache()
        q, k, v = kernel_inputs(b, s, s, h, d, torch.float32, False, gen)
        cot = torch.randn(q.shape, generator=gen, device="cuda")
        _, lse = att.flash_attn_fwd_cuda(q, k, v, causal=True)
        timing = bwd_timing(q, k, v, lse, cot, smi, name, recompute=True)
        if name == BWD_F32_SHAPES[0][0]:
            bwd_tf32.update(timing)
        else:
            bwd_tf32[name] = timing
    return fwd, bwd, bwd_tf32


def phase_attention_bwd(seed: int, smi: str) -> list:
    """``BWD_CASES`` through ``tos::flash_attn_bwd`` on the card, each held
    against ``flash_attn_bwd_reference`` on the same q, k, v, the kernel
    forward's lse, and the cotangents: one launch of the route's backward
    kernels and none of the others', dq, dk, dv finite and within
    ``BWD_REL_TOL`` relative L2 (f32: ``BWD_F32_REL_TOL``), a second call
    bit-equal to the first, a fully masked row's dq exactly 0, packed views
    read in place; then keys sharing a large common component against the
    f32 gradient of the same inputs, in bf16 and in f32.  Untimed."""
    import torch

    from tensorflowonspark_torch.ops import attention as att

    gen = torch.Generator(device="cuda").manual_seed(seed + 31)
    results = []
    for name, b, sq, sk, h, d, causal, off, dtype_name, packed, cot in BWD_CASES:
        dtype = getattr(torch, dtype_name)
        q, k, v = kernel_inputs(b, sq, sk, h, d, dtype, packed, gen)
        if packed and att._kernel_operand(q) is not q:
            raise AssertionError(f"{name}: packed views were copied, not read in place")
        _, lse = att.flash_attn_fwd_cuda(q, k, v, causal=causal, kv_offset=off)
        g_out = (torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
                 if "out" in cot else None)
        g_lse = (torch.randn(lse.shape, generator=gen, device="cuda")
                 if "lse" in cot else None)
        route = att._bwd_route(dtype, d)[0]
        tol = BWD_F32_REL_TOL if dtype == torch.float32 else BWD_REL_TOL
        reset_launches()
        got = torch.ops.tos.flash_attn_bwd(q, k, v, lse, g_out, g_lse, causal, None, off)
        torch.cuda.synchronize()
        launched = dict(att.LAUNCHES)
        if launched != {n: int(n == route) for n in att.LAUNCHES}:
            raise AssertionError(f"{name}: launches {launched}")
        again = torch.ops.tos.flash_attn_bwd(q, k, v, lse, g_out, g_lse, causal, None, off)
        bit_equal = all(torch.equal(x, y) for x, y in zip(got, again))
        want = att.flash_attn_bwd_reference(q, k, v, lse, g_out, g_lse, causal=causal,
                                            kv_offset=off)
        rel = {n: rel_l2(x, y) for n, x, y in zip(("dq", "dk", "dv"), got, want)}
        masked = lse <= att.NEG_INF / 2
        ok = (max(rel.values()) <= tol and bit_equal
              and all(torch.isfinite(x).all() and x.shape == y.shape
                      and x.dtype == dtype for x, y in zip(got, (q, k, v)))
              and (got[0][masked] == 0).all())
        mask = f"causal kv_offset {off}" if causal else "non-causal"
        log(f"[attn-bwd] {name} ({route}, B={b} Sq={sq} Sk={sk} H={h} D={d} -> "
            f"{att._bwd_route(dtype, d)[1]}, {mask}, {dtype_name}, cotangent on {cot}): rel L2 "
            + ", ".join(f"{n} {e:.3e}" for n, e in rel.items())
            + f" (limit {tol}), two runs bit-equal {bit_equal}, masked rows "
            f"{int(masked.sum())}: " + ("ok" if ok else "FAILED"))
        if not ok:
            raise AssertionError(f"{name}: the backward kernels disagree with the plain "
                                 "version")
        results.append({"case": name, "rel_l2": rel, "masked_rows": int(masked.sum()),
                        "bit_equal": bit_equal})
    # keys and values sharing a large common component (as a trained LM's
    # do): dq must not see it; against the f32 gradient of the same inputs,
    # bf16 and f32 inputs
    b, s, h, d = 2, 512, 8, 128
    for dtype, tol in ((torch.bfloat16, BWD_REL_TOL), (torch.float32, BWD_F32_REL_TOL)):
        common = 4 * torch.randn((1, 1, h, d), generator=gen, device="cuda")
        q, k, v, g_out = (
            (torch.randn((b, s, h, d), generator=gen, device="cuda") + c).to(dtype)
            for c in (0, common, common, 0))
        _, lse = att.flash_attn_fwd_cuda(q, k, v, causal=True)
        got = torch.ops.tos.flash_attn_bwd(q, k, v, lse, g_out, None, True, None, 0)
        leaves = [x.float().requires_grad_() for x in (q, k, v)]
        att.blockwise_attention(*leaves, causal=True).backward(g_out.float())
        rel = {n: rel_l2(x, y.grad) for n, x, y in zip(("dq", "dk", "dv"), got, leaves)}
        type_name = str(dtype).removeprefix("torch.")
        log(f"[attn-bwd] keys sharing a large component (B={b} S={s} H={h} D={d} causal "
            f"{type_name}): against the f32 gradient of the same inputs rel L2 "
            + ", ".join(f"{n} {e:.3e}" for n, e in rel.items()) + f" (limit {tol})")
        if max(rel.values()) > tol:
            raise AssertionError(f"the {type_name} backward kernels' dq sees a common key "
                                 "component")
        results.append({"case": "common_key_component_vs_f32"
                        + ("" if dtype == torch.bfloat16 else f"_{type_name}"), "rel_l2": rel})
    log(f"[attn-bwd] {len(results)} cases ok ({smi})")
    return results


def make_train_model(cfg: dict, seed: int, device: str):
    """The LM with f32 master weights, flax's initialisers drawn from a
    generator seeded with ``seed``."""
    import torch

    from tensorflowonspark_torch.models.transformer import build_transformer

    with torch.device(device):
        model = build_transformer(cfg)
    return model.init_weights(torch.Generator(device=device).manual_seed(seed))


def loss_and_grads(model, loss_fn, batch) -> tuple[float, dict]:
    """One step's loss and gradients, no update."""
    for p in model.parameters():
        p.grad = None
    loss, _ = loss_fn(model, batch)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return loss.item(), grads


def grad_disagreement(got: dict, want: dict) -> tuple[float, str]:
    """The largest per-parameter ``|got - want| / |want|`` (L2 norms)."""
    errs = {n: ((got[n].float() - want[n].float()).norm()
                / want[n].float().norm().clamp_min(1e-30)).item() for n in want}
    name = max(errs, key=errs.get)
    return errs[name], name


@contextlib.contextmanager
def count_recompute():
    """Counts, while the block runs, the calls of the recompute VJP
    (``ops.attention._recompute_bwd``: the backward heads above 128 take on
    the card); yields a one-item list holding the count."""
    from tensorflowonspark_torch.ops import attention as att

    calls, inner = [0], att._recompute_bwd

    def counted(*args, **kwargs):
        calls[0] += 1
        return inner(*args, **kwargs)

    att._recompute_bwd = counted
    try:
        yield calls
    finally:
        att._recompute_bwd = inner


def bwd_route(cfg: dict) -> str:
    """The backward ``_bwd_route`` gives ``cfg``'s type and head dim: a
    backward kernel's name, or "recompute"."""
    import torch

    from tensorflowonspark_torch.ops import attention as att

    dtype = torch.bfloat16 if cfg["bf16"] else torch.float32
    return att._bwd_route(dtype, cfg["d_model"] // cfg["n_heads"])[0]


def step_launches(cfg: dict, route: str, cuda: bool, forwards: int = 1) -> dict:
    """The launches one training pass of ``cfg`` makes, by kernel: per layer
    ``forwards`` of ``route`` (2 where the block's forward runs again in
    the backward) and one of the backward kernels where ``_bwd_route``
    sends its type and head dim (up to 128: bf16/fp16 to
    ``flash_attn_bwd``, f32 to ``flash_attn_bwd_tf32``); none on the CPU,
    which has no kernel."""
    from tensorflowonspark_torch.ops import attention as att

    want = dict.fromkeys(att.LAUNCHES, 0)
    if cuda:
        want[route] = forwards * cfg["n_layers"]
        if bwd_route(cfg) != "recompute":
            want[bwd_route(cfg)] = cfg["n_layers"]
    return want


def step_recomputes(cfg: dict, cuda: bool) -> int:
    """The recompute VJPs one training pass of ``cfg`` runs: one a layer on
    the card where ``_bwd_route`` gives no kernel, else none (the CPU runs
    the operator's plain version)."""
    return cfg["n_layers"] if cuda and bwd_route(cfg) == "recompute" else 0


def phase_train(seed: int, smi: str, device: str = "cuda"):
    """Train the LM through the streamed feed; returns ``(model, record)``."""
    import numpy as np
    import torch

    from examples_torch.llm.train_lm import synthetic_ids
    from tensorflowonspark_torch.feeding import DataFeed, FeedQueues
    from tensorflowonspark_torch.marker import EndOfFeed, EndPartition
    from tensorflowonspark_torch.models import transformer as tfm
    from tensorflowonspark_torch.ops import attention as att
    from tensorflowonspark_torch.parallel import dp

    cuda = device == "cuda"
    n_layers = LM_CONFIG["n_layers"]
    per_step = n_layers if cuda else 0  # the CPU path has no kernel
    model = make_train_model(LM_CONFIG, seed, device)
    optimizer = dp.adamw(model.parameters(), TRAIN_LR)
    loss_fn = tfm.make_loss_fn(model)
    step = dp.make_train_step(loss_fn, optimizer)
    state = dp.TrainState.create(model, optimizer)
    ids = synthetic_ids(TRAIN_BATCH, SEQ_LEN, LM_CONFIG["vocab_size"], seed)
    n_steps = TRAIN_WARMUP + TRAIN_TIMED
    queues = FeedQueues(capacity=n_steps * (TRAIN_BATCH + 1) + 1)
    q = queues.get_queue("input")
    for _ in range(n_steps):  # one partition per step, the same batch each time
        for row in ids:
            q.put(row)
        q.put(EndPartition())
    q.put(EndOfFeed())
    feed = DataFeed(queues, train_mode=True, poll_interval=0.05)

    def to_arrays(rows):
        return {"input_ids": torch.from_numpy(np.stack(rows)).to(device)}

    log(f"[train] {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M f32 "
        f"master params, bf16 compute, B={TRAIN_BATCH} S={SEQ_LEN}, AdamW "
        f"lr {TRAIN_LR} (fused={optimizer.defaults.get('fused')}), "
        f"{TRAIN_WARMUP} warm-up + {TRAIN_TIMED} timed steps over a DataFeed")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
    losses, launches = [], []
    want = step_launches(LM_CONFIG, "flash_attn_fwd", cuda)
    reset_launches()
    with count_recompute() as recomputes:
        for i, (batch, n) in enumerate(dp.make_batch_iterator(feed, TRAIN_BATCH,
                                                              to_arrays)):
            if n != TRAIN_BATCH:
                raise AssertionError(f"step {i}: {n} real rows, expected {TRAIN_BATCH}")
            if i == TRAIN_WARMUP and cuda:
                start.record()
                t_host = time.perf_counter()
            before = dict(att.LAUNCHES)
            state, metrics = step(state, batch)
            launches.append({n: c - before[n] for n, c in att.LAUNCHES.items()})
            losses.append(metrics["loss"])
        if cuda:
            end.record()
            end.synchronize()
            host_ms = (time.perf_counter() - t_host) * 1e3 / TRAIN_TIMED
    train_launches = att.LAUNCHES["flash_attn_fwd"]
    bwd_launches = att.LAUNCHES["flash_attn_bwd"]
    losses = [x.item() for x in losses]
    log("[train] losses: " + ", ".join(f"{x:.4f}" for x in losses))
    if len(losses) != n_steps or state.step != n_steps:
        raise AssertionError(f"{len(losses)} steps taken, expected {n_steps}")
    if not all(np.isfinite(losses)):
        raise AssertionError("a training loss is not finite")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall on a repeated batch: "
                             f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    if any(x != want for x in launches) or recomputes[0]:
        raise AssertionError(f"kernel launches per step {launches}, expected {want} "
                             f"(the forward's and the backward's once per layer); "
                             f"{recomputes[0]} recompute VJPs, expected none")
    log(f"[train] kernel launches: {per_step} of the forward and {per_step} of the "
        f"backward per step, {train_launches} and {bwd_launches} over {n_steps} steps; "
        f"no recompute VJP")
    record = {"launches": train_launches, "bwd_launches": bwd_launches, "losses": losses}

    batch = {"input_ids": torch.from_numpy(ids).to(device)}
    if cuda:
        step_ms = start.elapsed_time(end) / TRAIN_TIMED
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        tokens = TRAIN_BATCH * SEQ_LEN
        split = train_split(model, optimizer, loss_fn, batch)
        flops, formula = model_flops(model)
        mfu = flops / (step_ms * 1e-3) / PEAK_BF16_FLOPS
        log(f"[train] step {step_ms:.2f} ms on the card (CUDA events over "
            f"{TRAIN_TIMED} steps; host {host_ms:.2f} ms per step), "
            f"{tokens / step_ms * 1e3:.0f} tokens/s; split forward "
            f"{split['fwd_ms']:.2f} / backward {split['bwd_ms']:.2f} / optimizer "
            f"{split['opt_ms']:.2f} ms (median of {SPLIT_STEPS}); peak memory "
            f"{peak_gb:.2f} GB ({smi})")
        log(f"[train] model FLOPs per step {flops / 1e12:.3f} TFLOP = {formula}; "
            f"share of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s: {mfu:.4f} ({smi})")
        record.update(step_ms=step_ms, host_ms=host_ms, tokens_per_s=tokens / step_ms * 1e3,
                      peak_gb=peak_gb, model_tflop=flops / 1e12, mfu=mfu, **split)
    record.update(train_agreement(model, loss_fn, batch, per_step, device))
    return model, record


def train_split(model, optimizer, loss_fn, batch) -> dict:
    """Forward, backward and optimizer time of a step (CUDA events), median
    of ``SPLIT_STEPS`` steps; these steps update the model too."""
    import torch

    times = {"fwd_ms": [], "bwd_ms": [], "opt_ms": []}
    for _ in range(SPLIT_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        for p in model.parameters():
            p.grad = None
        ev[0].record()
        loss, _ = loss_fn(model, batch)
        ev[1].record()
        loss.backward()
        ev[2].record()
        optimizer.step()
        ev[3].record()
        ev[3].synchronize()
        for key, (a, b) in zip(times, zip(ev, ev[1:])):
            times[key].append(a.elapsed_time(b))
    return {k: statistics.median(v) for k, v in times.items()}


def model_flops(model) -> tuple[float, str]:
    """Model FLOPs of one train step and the formula that gives them."""
    b, s, n_layers = TRAIN_BATCH, SEQ_LEN, LM_CONFIG["n_layers"]
    h, dh = model.n_heads, model.d_head
    params = sum(p.numel() for n, p in model.named_parameters()
                 if not n.startswith("embed."))
    pairs = live_pairs(s, s, True, 0)
    attn = 3 * 4 * b * h * dh * pairs * n_layers
    formula = (f"6 x {params} (non-embedding params + lm_head) x {b * s} tokens "
               f"+ 3 x 4 x B {b} x H {h} x Dh {dh} x {pairs} causal pairs x "
               f"{n_layers} layers (attention forward + 2x backward)")
    return 6 * params * b * s + attn, formula


def f32_attention(q, k, v, causal=True):
    """``blockwise_attention`` on f32 copies of q, k, v, cast back."""
    from tensorflowonspark_torch.ops import attention as att

    return att.blockwise_attention(q.float(), k.float(), v.float(),
                                   causal=causal).to(q.dtype)


def train_agreement(model, loss_fn, batch, per_step: int, device: str) -> dict:
    """One step's loss and gradients at the same weights and batch: the
    kernel path against plain attention (``attn_impl="xla"``, in bf16 and
    with its attention in f32), against ``vocab_chunk`` and against
    ``remat``; counts a remat step's launches."""
    import torch

    from tensorflowonspark_torch.models import transformer as tfm
    from tensorflowonspark_torch.ops import attention as att

    loss, grads = loss_and_grads(model, loss_fn, batch)
    with torch.device(device):
        plain = tfm.build_transformer({**LM_CONFIG, "attn_impl": "xla"})
    plain.load_state_dict(model.state_dict())
    before = dict(att.LAUNCHES)
    others = {"xla": loss_and_grads(plain, tfm.make_loss_fn(plain), batch)}
    # the same bf16 model with its attention in f32: the exact attention
    # gradient of the bf16 inputs, which neither path's rounding shares
    for block in plain.blocks:
        block.attn.attend = f32_attention
    others["xla_f32_attention"] = loss_and_grads(plain, tfm.make_loss_fn(plain), batch)
    del plain
    if att.LAUNCHES != before:
        raise AssertionError("the plain-attention step launched a kernel")
    others["vocab_chunk"] = loss_and_grads(
        model, tfm.make_loss_fn(model, vocab_chunk=VOCAB_CHUNK), batch)
    model.remat = True
    before = dict(att.LAUNCHES)
    others["remat"] = loss_and_grads(model, loss_fn, batch)
    remat_launches = att.LAUNCHES["flash_attn_fwd"] - before["flash_attn_fwd"]
    remat_bwd = att.LAUNCHES["flash_attn_bwd"] - before["flash_attn_bwd"]
    model.remat = False
    if (remat_launches, remat_bwd) != (2 * per_step, per_step):
        raise AssertionError(f"a remat step launched the forward {remat_launches} and the "
                             f"backward {remat_bwd} times, expected {2 * per_step} and "
                             f"{per_step}")
    out = {"remat_launches": remat_launches, "remat_bwd_launches": remat_bwd}
    for name, (other_loss, other_grads) in others.items():
        loss_err = abs(other_loss - loss) / abs(loss)
        grad_err, worst = grad_disagreement(other_grads, grads)
        log(f"[train] one step, {name} vs the kernel's dense step: loss "
            f"{other_loss:.5f} vs {loss:.5f} (rel {loss_err:.2e}, limit "
            f"{LOSS_REL_TOL}); worst gradient rel L2 error {grad_err:.3e} at "
            f"{worst} (limit {GRAD_REL_TOL})")
        if loss_err > LOSS_REL_TOL or grad_err > GRAD_REL_TOL:
            raise AssertionError(f"{name} step disagrees with the kernel's step")
        out[f"{name}_grad_rel_err"] = grad_err
        del other_grads
    log(f"[train] remat step: {remat_launches} forward launches (2 x n_layers), "
        f"{remat_bwd} of the backward (n_layers)")
    return out


def phase_train_serve(model, smi: str, device: str = "cuda"):
    """Export the trained weights, serve them through ``build_apply`` and
    hold the logits against the training model's eval forward; returns the
    served apply function."""
    import numpy as np
    import torch

    from examples_torch.llm.train_lm import synthetic_ids
    from tensorflowonspark_torch.checkpoint import export_bundle, load_bundle
    from tensorflowonspark_torch.convert import torch_to_flax
    from tensorflowonspark_torch.models.registry import build_apply

    export = os.path.join(WORK_DIR, "trained_bundle")
    t0 = time.perf_counter()
    export_bundle(export, torch_to_flax(model.state_dict(), LM_CONFIG["n_heads"]),
                  LM_CONFIG)
    params, config = load_bundle(export)
    apply = build_apply(config, device=device)
    x = synthetic_ids(2, SEQ_LEN, LM_CONFIG["vocab_size"], seed=99)
    served = apply(params, x)
    with torch.inference_mode():
        trained = model.eval()(torch.from_numpy(x).to(device))
    model.train()
    scale = trained.abs().max().item()
    err = (served - trained).abs().max().item()
    log(f"[train->serve] bundle round trip in {time.perf_counter() - t0:.1f} s; "
        f"served vs trained-model logits: max_abs_err {err:.3e} (limit "
        f"{SERVE_LOGIT_REL_TOL:.4f} x {scale:.3f}), argmax agreement "
        f"{(served.argmax(-1) == trained.argmax(-1)).float().mean().item():.4f}")
    if not (err <= SERVE_LOGIT_REL_TOL * scale and np.isfinite(scale)):
        raise AssertionError("served logits differ from the trained model's")
    return apply, params


def phase_decode(apply, params, smi: str, device: str = "cuda") -> dict:
    """Greedy decoding through the KV cache on the served model."""
    import numpy as np
    import torch

    from examples_torch.llm.train_lm import synthetic_ids
    from tensorflowonspark_torch.models.transformer import KVCache, greedy_generate

    model = apply.model
    prompt = synthetic_ids(DECODE_BATCH, DECODE_PROMPT, LM_CONFIG["vocab_size"], seed=7)
    total = DECODE_PROMPT + DECODE_NEW

    def timed(**kw):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = greedy_generate(model, prompt, **kw)
        if device == "cuda":
            torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    greedy_generate(model, prompt, max_new_tokens=2)  # warm up
    _, prefill_ms = timed(max_new_tokens=0)
    out, gen_ms = timed(max_new_tokens=DECODE_NEW)
    if out.shape != (DECODE_BATCH, total) or not (out[:, :DECODE_PROMPT] == prompt).all():
        raise AssertionError(f"generated {out.shape}, expected the prompt + {DECODE_NEW}")
    per_token = (gen_ms - prefill_ms) / DECODE_NEW
    log(f"[decode] B={DECODE_BATCH}, prompt {DECODE_PROMPT}, {DECODE_NEW} new tokens: "
        f"{gen_ms:.1f} ms, prefill {prefill_ms:.1f} ms, {per_token:.2f} ms per "
        f"generated token (host clock, each step reads its tokens) ({smi})")

    # cached logits (prefill, then one-token steps over the generated
    # tokens) against one full forward over the same sequence
    cache = KVCache.empty(model, DECODE_BATCH, total)
    seq = torch.from_numpy(out).to(device)
    with torch.inference_mode():
        logits, cache = model(seq[:, :DECODE_PROMPT], cache)
        steps = [logits]
        for t in range(DECODE_PROMPT, total - 1):
            logits, cache = model(seq[:, t:t + 1], cache)
            steps.append(logits)
    cached = torch.cat(steps, dim=1)
    full = apply(params, out[:, :total - 1])
    scale = full.abs().max().item()
    err = (cached - full).abs().max().item()
    agree = (cached.argmax(-1) == full.argmax(-1)).float().mean().item()
    log(f"[decode] cached vs full-forward logits at {total - 1} positions: "
        f"max_abs_err {err:.4f} (limit {LOGIT_REL_TOL} x {scale:.3f}), argmax "
        f"agreement {agree:.4f}")
    if err > LOGIT_REL_TOL * scale:
        raise AssertionError("cached decode logits disagree with the full forward")
    if not (cached[:, DECODE_PROMPT - 1:].argmax(-1).cpu().numpy()
            == out[:, DECODE_PROMPT:]).all():
        raise AssertionError("greedy tokens are not the argmax of their logits")

    eos = int(out[0, DECODE_PROMPT])  # row 0 finishes at its first new token
    stopped = greedy_generate(model, prompt, max_new_tokens=DECODE_NEW, eos_id=eos,
                              pad_id=0)
    for r in range(DECODE_BATCH):
        gen = stopped[r, DECODE_PROMPT:]
        hits = np.where(gen == eos)[0]
        end = hits[0] + 1 if len(hits) else len(gen)
        if not ((gen[:end] == out[r, DECODE_PROMPT:DECODE_PROMPT + end]).all()
                and (gen[end:] == 0).all()):
            raise AssertionError(f"EOS stop: row {r} not the greedy chain then pads")
    if not (stopped[0, DECODE_PROMPT] == eos and (stopped[0, DECODE_PROMPT + 1:] == 0).all()):
        raise AssertionError("EOS stop: row 0 did not stop at its EOS")
    log(f"[decode] EOS stop: ok ({stopped.shape[1] - DECODE_PROMPT} steps run)")
    return {"decode_ms_per_token": per_token, "prefill_ms": prefill_ms,
            "decode_logit_max_abs_err": err}


def step_against_plain(cfg: dict, seed: int, rows: int, route: str, tag: str,
                       smi: str, device: str) -> dict:
    """One AdamW step of ``cfg`` at S=SEQ_LEN: the loss and gradients with
    the kernels against plain attention (``attn_impl: xla``), every
    wrapper's count set to 0 just before the kernel step and read just
    after; on the card exactly n_layers launches of ``route`` and of the
    backward kernels ``_bwd_route`` gives (``step_launches``) and none of
    the others, and a recompute VJP only where it gives none
    (``step_recomputes``)."""
    import torch

    from examples_torch.llm.train_lm import synthetic_ids
    from tensorflowonspark_torch.models import transformer as tfm
    from tensorflowonspark_torch.ops import attention as att
    from tensorflowonspark_torch.parallel import dp

    model = make_train_model(cfg, seed, device)
    optimizer = dp.adamw(model.parameters(), TRAIN_LR)
    loss_fn = tfm.make_loss_fn(model)
    ids = synthetic_ids(rows, SEQ_LEN, cfg["vocab_size"], seed)
    batch = {"input_ids": torch.from_numpy(ids).to(device)}
    cuda = device == "cuda"
    with torch.device(device):
        plain = tfm.build_transformer({**cfg, "attn_impl": "xla"})
    plain.load_state_dict(model.state_dict())
    plain_loss, plain_grads = loss_and_grads(plain, tfm.make_loss_fn(plain), batch)
    del plain
    reset_launches()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with count_recompute() as recomputes:
        loss, grads = loss_and_grads(model, loss_fn, batch)
    step_s = time.perf_counter() - t0
    launched = dict(att.LAUNCHES)
    want = step_launches(cfg, route, cuda)
    backward = bwd_route(cfg)
    if launched != want or recomputes[0] != step_recomputes(cfg, cuda):
        raise AssertionError(f"{tag} step: launches {launched}, expected {want}; "
                             f"{recomputes[0]} recompute VJPs, expected "
                             f"{step_recomputes(cfg, cuda)}")
    if not math.isfinite(loss):
        raise AssertionError(f"{tag} step: loss {loss}")
    loss_err = abs(plain_loss - loss) / abs(loss)
    grad_err, worst = grad_disagreement(grads, plain_grads)
    for name, p in model.named_parameters():
        p.grad = grads[name]
    optimizer.step()
    del grads, plain_grads
    compute = "bf16" if cfg["bf16"] else "f32"
    log(f"[{tag}] one AdamW step, {compute} compute, {cfg['n_layers']} layers of "
        f"{cfg['n_heads']} heads of {cfg['d_model'] // cfg['n_heads']}, B={rows} "
        f"S={SEQ_LEN}: loss {loss:.5f} (plain attention {plain_loss:.5f}, rel "
        f"{loss_err:.2e}, limit {LOSS_REL_TOL}); worst gradient rel L2 error "
        f"{grad_err:.3e} at {worst} (limit {GRAD_REL_TOL}); "
        f"{launched[route]} launches of {route}, {launched.get(backward, 0)} of "
        f"{backward}, {recomputes[0]} recompute VJPs; forward + backward "
        f"{step_s * 1e3:.1f} ms host clock ({smi})")
    if loss_err > LOSS_REL_TOL or grad_err > GRAD_REL_TOL:
        raise AssertionError(f"the {tag} step disagrees with plain attention")
    return {"launches": launched[route], "bwd_launches": launched.get(backward, 0),
            "recomputes": recomputes[0], "loss": loss, "grad_rel_err": grad_err,
            "fwd_bwd_ms": step_s * 1e3}


def phase_train_f32(seed: int, smi: str, device: str = "cuda") -> dict:
    """One AdamW step of the f32 model configuration (``bf16: false``) at
    the LM width through the 3xTF32 kernels: a finite loss, n_layers
    launches of the forward and of the f32 backward kernels, none of the
    others and no recompute VJP, and the step's gradients against plain
    attention.  Its step time against another checkout's is measured by
    ``examples_torch/attention_ab.py``, not here."""
    return step_against_plain({**LM_CONFIG, "bf16": False}, seed + 11,
                              F32_TRAIN_BATCH, "flash_attn_fwd_tf32", "train-f32",
                              smi, device)


def phase_train_heads(heads: int, layers: int, seed: int, smi: str,
                      device: str = "cuda") -> dict:
    """The LM at its width with ``heads`` heads (depth cut to ``layers``):
    one bf16 step through the wgmma kernel and one f32 step through the
    3xTF32 kernel, each against plain attention; returns each step's
    numbers by route."""
    cfg = {**LM_CONFIG, "n_heads": heads, "n_layers": layers}
    tag = f"train-d{LM_CONFIG['d_model'] // heads}"
    return {route: step_against_plain({**cfg, "bf16": bf16}, seed,
                                      F32_TRAIN_BATCH, route, f"{tag}-{kind}", smi,
                                      device)
            for route, bf16, kind in (("flash_attn_fwd", True, "bf16"),
                                      ("flash_attn_fwd_tf32", False, "f32"))}


def phase_train_d256(seed: int, smi: str, device: str = "cuda") -> dict:
    """The head-dim-256 steps (``D256_HEADS`` heads, ``D256_LAYERS``
    layers): bf16 on the wgmma kernel's D=256 configuration, f32 on the
    3xTF32 kernel's wide route."""
    return phase_train_heads(D256_HEADS, D256_LAYERS, seed + 13, smi, device)


def phase_train_d512(seed: int, smi: str, device: str = "cuda") -> dict:
    """The head-dim-512 steps (``D512_HEADS`` heads, ``D512_LAYERS``
    layers): both on the kernels' wide routes."""
    return phase_train_heads(D512_HEADS, D512_LAYERS, seed + 17, smi, device)


def forward_census(fn, route: str, layers: int, tag: str) -> dict:
    """One ``fn()`` forward under ``torch.profiler``: the attention kernels
    and pre-passes it ran on the card, and the aten ops inside each
    ``tos::flash_attn_fwd`` call on the host.  Fails unless there are
    ``layers`` attention kernels (and, on the f32 route, ``layers`` K/V
    pre-passes), and no pad, copy, clone, contiguous or slice inside the
    operator's calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):  # a session without its device records is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events() if str(e.device_type).endswith("CUDA")]
        if kernels:
            break
    attention = [n for n in kernels if "flash_fwd" in n]
    prepass = [n for n in kernels if "split_kv" in n or "transpose_v" in n]
    calls = [e for e in prof.events() if e.name == "tos::flash_attn_fwd"]
    inside, stack = set(), [c for e in calls for c in e.cpu_children]
    while stack:
        e = stack.pop()
        inside.add(e.name)
        stack.extend(e.cpu_children)
    copies = sorted(inside & {"aten::constant_pad_nd", "aten::pad", "aten::copy_",
                              "aten::clone", "aten::contiguous", "aten::slice"})
    tf32 = route == "flash_attn_fwd_tf32"
    if (len(attention) != layers or len(prepass) != (layers if tf32 else 0)
            or len(calls) != layers or copies):
        raise AssertionError(f"{tag}: one forward ran {len(attention)} attention kernels "
                             f"{sorted(set(attention))}, {len(prepass)} pre-passes, "
                             f"{len(calls)} operator calls with {copies or 'no'} copies "
                             f"inside; expected {layers} each and none")
    log(f"[{tag}] census of one forward: {len(attention)} x {sorted(set(attention))}, "
        f"{len(prepass)} pre-passes, {len(calls)} tos::flash_attn_fwd calls, no pad, "
        f"copy or slice inside them")
    return {"attention_kernels": len(attention), "prepasses": len(prepass),
            "kernel_names": sorted(set(attention))}


def example_lm_run(cfg: dict, seed: int, route: str, tag: str, smi: str,
                   device: str = "cuda") -> dict:
    """The example LM (``cfg``, ``EXAMPLE_BATCH`` x ``EXAMPLE_SEQ``) on
    ``route``: the first step's loss and gradients against plain attention
    on the same weights, ``EXAMPLE_STEPS`` AdamW steps (every count set to
    0 just before them and read just after: n_layers launches of ``route``
    a step and none of the others), then one batch served through the
    bundle: logits against plain attention's, n_layers launches, and the
    forward's census."""
    import numpy as np
    import torch

    from examples_torch.llm.train_lm import synthetic_ids
    from tensorflowonspark_torch.checkpoint import export_bundle, load_bundle
    from tensorflowonspark_torch.convert import torch_to_flax
    from tensorflowonspark_torch.models import transformer as tfm
    from tensorflowonspark_torch.models.registry import build_apply
    from tensorflowonspark_torch.ops import attention as att
    from tensorflowonspark_torch.parallel import dp

    cuda = device == "cuda"
    layers = cfg["n_layers"]
    per_step = layers if cuda else 0  # the CPU path has no kernel
    model = make_train_model(cfg, seed, device)
    loss_fn = tfm.make_loss_fn(model)
    ids = synthetic_ids(EXAMPLE_BATCH, EXAMPLE_SEQ, cfg["vocab_size"], seed)
    batch = {"input_ids": torch.from_numpy(ids).to(device)}
    with torch.device(device):
        plain = tfm.build_transformer({**cfg, "attn_impl": "xla"})
    plain.load_state_dict(model.state_dict())
    plain_loss, plain_grads = loss_and_grads(plain, tfm.make_loss_fn(plain), batch)
    del plain
    loss, grads = loss_and_grads(model, loss_fn, batch)
    loss_err = abs(plain_loss - loss) / abs(loss)
    grad_err, worst = grad_disagreement(grads, plain_grads)
    del grads, plain_grads
    compute = "bf16" if cfg["bf16"] else "f32"
    log(f"[{tag}] {sum(p.numel() for p in model.parameters()) / 1e6:.2f} M params, "
        f"{compute} compute, {layers} layers of {cfg['n_heads']} heads of "
        f"{cfg['d_model'] // cfg['n_heads']}, B={EXAMPLE_BATCH} S={EXAMPLE_SEQ}: first "
        f"step's loss {loss:.5f} (plain attention {plain_loss:.5f}, rel {loss_err:.2e}, "
        f"limit {LOSS_REL_TOL}); worst gradient rel L2 error {grad_err:.3e} at {worst} "
        f"(limit {GRAD_REL_TOL})")
    if not math.isfinite(loss) or loss_err > LOSS_REL_TOL or grad_err > GRAD_REL_TOL:
        raise AssertionError(f"{tag}: the first step disagrees with plain attention")

    optimizer = dp.adamw(model.parameters(), TRAIN_LR)
    step = dp.make_train_step(loss_fn, optimizer)
    state = dp.TrainState.create(model, optimizer)
    if cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
    losses, per = [], []
    reset_launches()
    with count_recompute() as recomputes:
        for i in range(EXAMPLE_STEPS):
            if i == 1 and cuda:  # the steps after the first, timed
                start.record()
            before = dict(att.LAUNCHES)
            state, metrics = step(state, batch)
            per.append({n: c - before[n] for n, c in att.LAUNCHES.items()})
            losses.append(metrics["loss"])
    if cuda:
        end.record()
        end.synchronize()
    launched = dict(att.LAUNCHES)
    losses = [x.item() for x in losses]
    log(f"[{tag}] losses: " + ", ".join(f"{x:.4f}" for x in losses))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: losses {losses} not finite or not falling")
    want = step_launches(cfg, route, cuda)
    backward = bwd_route(cfg)
    if (any(p != want for p in per)
            or recomputes[0] != EXAMPLE_STEPS * step_recomputes(cfg, cuda)):
        raise AssertionError(f"{tag}: launches per step {per}, expected {want}; "
                             f"{recomputes[0]} recompute VJPs")
    out = {"launches": launched[route], "bwd_launches": launched.get(backward, 0),
           "recomputes": recomputes[0], "loss": loss, "plain_loss": plain_loss,
           "grad_rel_err": grad_err, "losses": losses}
    if cuda:
        step_ms = start.elapsed_time(end) / (EXAMPLE_STEPS - 1)
        out.update(step_ms=step_ms, tokens_per_s=EXAMPLE_BATCH * EXAMPLE_SEQ / step_ms * 1e3)
        log(f"[{tag}] {EXAMPLE_STEPS} AdamW steps, {launched[route]} launches of {route} "
            f"({per_step} a step) and {out['bwd_launches']} of the backward kernels "
            f"{backward} ({want.get(backward, 0)} a step), {recomputes[0]} recompute "
            f"VJPs; {step_ms:.2f} ms a step over the "
            f"last {EXAMPLE_STEPS - 1} (CUDA events), {out['tokens_per_s']:.0f} tokens/s "
            f"({smi})")

    export = os.path.join(WORK_DIR, tag)
    export_bundle(export, torch_to_flax(model.state_dict(), cfg["n_heads"]), cfg)
    del model, optimizer, state
    params, config = load_bundle(export)
    apply = build_apply(config, device=device)
    x = synthetic_ids(EXAMPLE_BATCH, EXAMPLE_SEQ, cfg["vocab_size"], seed=seed + 1)
    reset_launches()
    served = apply(params, x)
    served_launches = dict(att.LAUNCHES)
    want = {n: per_step if n == route else 0 for n in att.LAUNCHES}
    if served_launches != want:
        raise AssertionError(f"{tag}: the served batch launched {served_launches}, "
                             f"expected {want}")
    reference = build_apply({**config, "attn_impl": "xla"}, device=device)(params, x)
    scale = reference.float().abs().max().item()
    err = (served.float() - reference.float()).abs().max().item()
    tol = LOGIT_REL_TOL if cfg["bf16"] else F32_LOGIT_REL_TOL
    log(f"[{tag}] served batch {tuple(served.shape)}: logits vs plain attention's "
        f"max_abs_err {err:.3e} (limit {tol} x {scale:.3f}), {served_launches[route]} "
        f"launches of {route}")
    if not (torch.isfinite(served).all() and err <= tol * scale):
        raise AssertionError(f"{tag}: served logits disagree with plain attention")
    out.update(served_launches=served_launches[route], served_logit_max_abs_err=err,
               served_logit_scale=scale)
    if cuda:
        out["census"] = forward_census(lambda: apply(params, x), route, layers, tag)
    return out


def phase_example_lm(seed: int, smi: str, device: str = "cuda") -> dict:
    """The LM examples' default configuration (``EXAMPLE_LM_CONFIG``, head
    dim 32) in f32 (the examples' default, the 3xTF32 kernel) and in bf16
    (``--bf16``, the wgmma kernel); returns each run's numbers by route."""
    return {route: example_lm_run({**EXAMPLE_LM_CONFIG, "bf16": bf16}, seed + 19, route,
                                  f"example-lm-{kind}", smi, device)
            for route, bf16, kind in (("flash_attn_fwd_tf32", False, "f32"),
                                      ("flash_attn_fwd", True, "bf16"))}


# -- the image families (BASELINE configs 1, 2, 3 and 5) ----------------------


def moe_census(fn) -> dict:
    """Device time of one ``fn()`` (``torch.profiler``): the attention
    kernel's (its launches have no aten op, so its kernels are counted by
    name), each MoE stage's (the self device time of the aten ops inside
    the ``moe.*`` labels, with each stage's three costliest ops) and the
    rest (every other aten op's self device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    # the labels' host-side ranges (the trace repeats each on the card's
    # timeline, where the ops' host start times do not fall)
    labels = [(e.time_range.start, e.time_range.end, e.name) for e in events
              if e.name in MOE_STAGES and e.device_type == DeviceType.CPU]
    ms = dict.fromkeys(MOE_STAGES + ("rest",), 0.0)
    ops: dict = {name: {} for name in MOE_STAGES}
    attention = 0.0
    for e in events:
        if e.device_type != DeviceType.CPU:
            if "flash_fwd" in e.name:
                attention += e.time_range.elapsed_us() / 1e3
            continue
        us = e.self_device_time_total
        if e.name in MOE_STAGES or us <= 0:
            continue
        stage = next((n for a, b, n in labels if a <= e.time_range.start < b), "rest")
        ms[stage] += us / 1e3
        if stage != "rest":
            ops[stage][e.name] = ops[stage].get(e.name, 0.0) + us / 1e3
    top = {k: dict(sorted(v.items(), key=lambda kv: -kv[1])[:3]) for k, v in ops.items()}
    return {"device_ms": attention + sum(ms.values()), "attention_kernel_ms": attention,
            "dispatch_combine_ms": ms["moe.route"] + ms["moe.dispatch"] + ms["moe.combine"],
            "expert_matmuls_ms": ms["moe.experts"], "rest_ms": ms["rest"],
            "stages_ms": {k: ms[k] for k in MOE_STAGES}, "top_ops_ms": top}


def phase_moe_slice(seed: int, smi: str, device: str = "cuda") -> dict:
    """The MoE LM at full width (``MOE_CONFIG``, random weights from the seed
    in the JAX package's bundle layout) through ``export_bundle`` →
    ``serving_loop``: batches of 4, 4 and 3 rows (the last padded: the pad
    rows take expert capacity, as the JAX package's do), a ping and a
    reload; ordered, exactly counted, finite results, n_layers launches a
    batch, the logits against plain attention on the padded batch at the
    kernel path's routing; with the routing free, the share of tokens a
    layer the two paths route otherwise within ``MOE_BF16_REROUTE_MAX``
    (the control fault's share and both paths' capacity drops reported);
    in f32 the same (``moe_f32_agreement``).  On the card: one forward's
    time, its census and the peak memory."""
    import numpy as np
    import torch

    from tensorflowonspark_torch.checkpoint import export_bundle, load_bundle
    from tensorflowonspark_torch.models.registry import build_apply
    from tensorflowonspark_torch.ops import attention as att
    from tensorflowonspark_torch.parallel.ep import capacity_of

    cuda = device == "cuda"
    t0 = time.perf_counter()
    params = make_lm_params(MOE_CONFIG, seed)
    n_params = sum(a.size for blk in params.values() for a in _leaves(blk))
    export = os.path.join(WORK_DIR, "moe_bundle")
    export_bundle(export, params, MOE_CONFIG)
    del params
    log(f"[moe-slice] exported {n_params / 1e6:.1f} M f32 params "
        f"({MOE_CONFIG['n_experts']} experts, top-{MOE_CONFIG['moe_top_k']}) in "
        f"{time.perf_counter() - t0:.1f} s")
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    kernel = build_apply(MOE_CONFIG, device=device)
    plain = build_apply({**MOE_CONFIG, "attn_impl": "xla"}, device=device)
    k_routes, p_routes = RoutingRecorder(kernel.model), RoutingRecorder(plain.model)
    seen: dict = {"flips": [], "drops": [], "free_drops": [], "control": None}

    def replayed(variables, x):
        """Plain attention at the kernel path's routing: the kernel path on
        the padded batch (as served) gives each layer's ``top_idx``; the
        plain path runs free once (and, on the first batch, with the
        control fault), then replays it."""
        before = att.LAUNCHES["flash_attn_fwd"]
        kernel(variables, x)
        att.LAUNCHES["flash_attn_fwd"] = before  # a reference run, not the path's
        routing = list(k_routes.last)
        plain(variables, x)
        seen["flips"].append(routing_flips(routing, p_routes.last))
        seen["drops"].append(drops_of(routing, MOE_CONFIG))
        seen["free_drops"].append(drops_of(p_routes.last, MOE_CONFIG))
        if seen["control"] is None:
            with causal_leak(plain.model):
                plain(variables, x)
            seen["control"] = routing_flips(routing, p_routes.last)
        set_replay(plain.model, routing)
        out = plain(variables, x)
        set_replay(plain.model, None)
        return out

    launches, batches = serve_and_check(export, MOE_CONFIG, seed, "moe-slice", smi,
                                        device, reference=replayed)
    k_routes.remove()
    p_routes.remove()
    tokens = MAX_BATCH * SEQ_LEN
    capacity = capacity_of(tokens, 1.25, MOE_CONFIG["moe_top_k"], MOE_CONFIG["n_experts"])
    worst = max(max(f) for f in seen["flips"]) / tokens
    log(f"[moe-slice] capacity {capacity} slots per expert at n = {tokens}; routing "
        f"free in bf16: tokens with another top-2 set per batch and layer "
        f"{seen['flips']} (worst share {worst:.4f}, limit {MOE_BF16_REROUTE_MAX}); "
        f"control (plain attention seeing the next token), batch 0: {seen['control']}; "
        f"dropped pairs, kernel path {seen['drops']}, plain attention "
        f"{seen['free_drops']}")
    if worst > MOE_BF16_REROUTE_MAX:
        raise AssertionError(f"the kernel path routes {worst:.4f} of a layer's tokens "
                             f"otherwise than plain attention in bf16")
    variables, _ = load_bundle(export)
    record = {"launches": launches, "capacity": capacity, "drops": seen["drops"],
              "bf16_route_flips": seen["flips"], "bf16_control_flips": seen["control"]}
    if cuda:
        x = np.stack(batches[0])
        fwd_ms = time_ms(lambda: kernel(variables, x), reps=5, windows=3, warmup=1)[0]
        census = moe_census(lambda: kernel(variables, x))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        log(f"[moe-slice] one forward, {MAX_BATCH} x {SEQ_LEN}: {fwd_ms:.2f} ms on "
            f"the card (CUDA events); census {json.dumps(census)}; peak memory "
            f"{peak_gb:.2f} GB ({smi})")
        record.update(fwd_ms=fwd_ms, census=census, peak_gb=peak_gb)
    del kernel, plain
    if cuda:
        torch.cuda.empty_cache()
    record["f32"] = moe_f32_agreement(variables, batches[-1], device)
    return record


class RoutingRecorder:
    """Each MoE block's ``top_idx`` of the last forward (``last``), from a
    forward hook on its router, which sees the f32 logits of the routed
    tokens; ``remove`` takes the hooks off (before a timed run)."""

    def __init__(self, model):
        import torch

        from tensorflowonspark_torch.parallel.ep import top_k

        self.last: list = [None] * len(model.blocks)

        def hook(i, k):
            def record(module, args, logits):
                self.last[i] = top_k(torch.softmax(logits, dim=-1), k)[1]
            return record

        self.handles = [blk.moe.router.register_forward_hook(hook(i, blk.moe.top_k))
                        for i, blk in enumerate(model.blocks)]

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


def drops_of(routing: list, config: dict) -> list:
    """Each layer's dropped pairs (``keep`` false) under ``routing``, at the
    capacity of its token count."""
    import torch

    from tensorflowonspark_torch.parallel.ep import _sorted_dispatch, capacity_of

    out = []
    for top_idx in routing:
        n, k = top_idx.shape
        cap = capacity_of(n, 1.25, k, config["n_experts"])
        keep = _sorted_dispatch(top_idx, torch.ones(top_idx.shape, device=top_idx.device),
                                cap, config["n_experts"])[3]
        out.append(int((~keep).sum()))
    return out


def set_replay(model, routing) -> None:
    for i, blk in enumerate(model.blocks):
        blk.moe.replay = None if routing is None else routing[i]


@contextlib.contextmanager
def causal_leak(model):
    """The control fault: every block's attention replaced by plain
    attention whose causal mask is off by one (each query also sees the
    next token)."""
    from tensorflowonspark_torch.ops.attention import blockwise_attention

    saved = [blk.attn.attend for blk in model.blocks]
    for blk in model.blocks:
        blk.attn.attend = functools.partial(blockwise_attention, kv_offset=-1)
    try:
        yield
    finally:
        for blk, attend in zip(model.blocks, saved):
            blk.attn.attend = attend


def routing_flips(a: list, b: list) -> list:
    """Per layer, the tokens whose top-k expert sets differ."""
    return [int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
            for x, y in zip(a, b)]


def moe_f32_agreement(variables, rows: list, device: str) -> dict:
    """The same bundle in f32 (``bf16: false``: the 3xTF32 kernel on the
    card against plain f32 attention) on one padded batch: with the routing
    free, the share of tokens a layer routed otherwise within
    ``MOE_F32_REROUTE_MAX`` (the control fault's reported), and the logits
    at the kernel path's routing within ``MOE_F32_LOGIT_REL_TOL`` of the
    largest."""
    import numpy as np

    from tensorflowonspark_torch.models.registry import build_apply

    x = np.stack(rows + [rows[-1]] * (MAX_BATCH - len(rows)))
    kernel = build_apply({**MOE_CONFIG, "bf16": False}, device=device)
    k_routes = RoutingRecorder(kernel.model)
    lk = kernel(variables, x)
    routing = list(k_routes.last)
    del kernel, k_routes
    plain = build_apply({**MOE_CONFIG, "bf16": False, "attn_impl": "xla"}, device=device)
    p_routes = RoutingRecorder(plain.model)
    plain(variables, x)
    flips = routing_flips(routing, p_routes.last)
    drops, free_drops = drops_of(routing, MOE_CONFIG), drops_of(p_routes.last, MOE_CONFIG)
    with causal_leak(plain.model):
        plain(variables, x)
    control = routing_flips(routing, p_routes.last)
    set_replay(plain.model, routing)
    lp = plain(variables, x)
    del plain, p_routes
    scale = lp.abs().max().item()
    err = (lk - lp).abs().max().item()
    worst = max(flips) / x.size
    log(f"[moe-slice] f32 (3xTF32 kernel vs plain attention): routing free, tokens "
        f"with another top-2 set per layer {flips} (worst share {worst:.5f}, limit "
        f"{MOE_F32_REROUTE_MAX}), control {control}, drops {drops} vs {free_drops}; "
        f"at the kernel's routing max logit err {err:.2e} of {scale:.3f} (limit "
        f"{MOE_F32_LOGIT_REL_TOL} x)")
    if worst > MOE_F32_REROUTE_MAX:
        raise AssertionError(f"the f32 kernel path routes {worst:.5f} of a layer's "
                             f"tokens otherwise than plain attention")
    if err > MOE_F32_LOGIT_REL_TOL * scale:
        raise AssertionError("the f32 MoE paths part at one routing")
    return {"free_route_flips": flips, "control_flips": control, "drops": drops,
            "free_drops": free_drops, "logit_rel_err": err / scale}


def moe_flops(model, batch: int) -> tuple[float, str]:
    """Model FLOPs of one train step of the MoE LM at ``batch`` x
    ``SEQ_LEN``: 6 x the parameters a token is routed through (all but the
    embedding, with ``top_k / n_experts`` of the expert stacks; the lm_head
    counted) x tokens, plus the attention's as in ``model_flops``."""
    s, n_layers = SEQ_LEN, len(model.blocks)
    h, dh = model.n_heads, model.d_head
    moe = model.blocks[0].moe
    share = moe.top_k / moe.n_experts
    active = 0.0
    for n, p in model.named_parameters():
        if n.startswith("embed."):
            continue
        active += p.numel() * (share if ".moe.experts_" in n else 1.0)
    pairs = live_pairs(s, s, True, 0)
    attn = 3 * 4 * batch * h * dh * pairs * n_layers
    formula = (f"6 x {active:.0f} active params (non-embedding, experts at "
               f"top-{moe.top_k}/{moe.n_experts}, lm_head) x {batch * s} tokens + "
               f"3 x 4 x B {batch} x H {h} x Dh {dh} x {pairs} causal pairs x "
               f"{n_layers} layers")
    return 6 * active * batch * s + attn, formula


def phase_moe_train(seed: int, smi: str, device: str = "cuda") -> dict:
    """``make_train_step`` with AdamW on the MoE LM at full width, B =
    ``MOE_TRAIN_BATCH``, one batch resident: ``MOE_WARMUP`` + ``MOE_TIMED``
    steps; finite losses, aux and router-z losses, a falling loss, n_layers
    launches a step; step ms, tokens/s, the FLOPs share (active
    parameters), peak memory; one step's loss and gradients against plain
    attention."""
    import numpy as np
    import torch

    from examples_torch.llm.train_lm import synthetic_ids
    from tensorflowonspark_torch.models import transformer as tfm
    from tensorflowonspark_torch.ops import attention as att
    from tensorflowonspark_torch.parallel import dp

    cuda = device == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model = make_train_model(MOE_CONFIG, seed + 21, device)
    optimizer = dp.adamw(model.parameters(), TRAIN_LR)
    loss_fn = tfm.make_loss_fn(model)
    step = dp.make_train_step(loss_fn, optimizer)
    state = dp.TrainState.create(model, optimizer)
    ids = synthetic_ids(MOE_TRAIN_BATCH, SEQ_LEN, MOE_CONFIG["vocab_size"], seed)
    batch = {"input_ids": torch.from_numpy(ids).to(device)}
    n_steps = MOE_WARMUP + MOE_TIMED
    log(f"[moe-train] {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M f32 "
        f"master params, bf16 compute, B={MOE_TRAIN_BATCH} S={SEQ_LEN}, AdamW lr "
        f"{TRAIN_LR}, {MOE_WARMUP} warm-up + {MOE_TIMED} timed steps")
    metrics = []
    reset_launches()
    for i in range(n_steps):
        if i == MOE_WARMUP and cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t_host = time.perf_counter()
        state, m = step(state, batch)
        metrics.append(m)
    if cuda:
        end.record()
        end.synchronize()
        host_ms = (time.perf_counter() - t_host) * 1e3 / MOE_TIMED
    launches = att.LAUNCHES["flash_attn_fwd"]
    bwd_launches = att.LAUNCHES["flash_attn_bwd"]
    want = MOE_CONFIG["n_layers"] * n_steps if cuda else 0
    series = {k: [m[k].item() for m in metrics] for k in ("loss", "aux_loss", "router_z_loss")}
    log("[moe-train] losses: " + ", ".join(f"{x:.4f}" for x in series["loss"]))
    log(f"[moe-train] aux_loss {series['aux_loss'][0]:.4f} -> {series['aux_loss'][-1]:.4f}, "
        f"router_z_loss {series['router_z_loss'][0]:.4f} -> {series['router_z_loss'][-1]:.4f}")
    if not all(np.isfinite(v).all() for v in series.values()):
        raise AssertionError("a MoE loss, aux loss or router-z loss is not finite")
    if not series["loss"][-1] < series["loss"][0]:
        raise AssertionError(f"MoE loss did not fall: {series['loss'][0]:.4f} -> "
                             f"{series['loss'][-1]:.4f}")
    if (launches, bwd_launches) != (want, want):
        raise AssertionError(f"[moe-train] launches {launches} of the forward and "
                             f"{bwd_launches} of the backward, expected {want} of each")
    record = {"launches": launches, "bwd_launches": bwd_launches, "batch": MOE_TRAIN_BATCH,
              **series}
    if cuda:
        step_ms = start.elapsed_time(end) / MOE_TIMED
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        tokens = MOE_TRAIN_BATCH * SEQ_LEN
        flops, formula = moe_flops(model, MOE_TRAIN_BATCH)
        mfu = flops / (step_ms * 1e-3) / PEAK_BF16_FLOPS
        log(f"[moe-train] step {step_ms:.2f} ms on the card (CUDA events over "
            f"{MOE_TIMED} steps; host {host_ms:.2f} ms per step), "
            f"{tokens / step_ms * 1e3:.0f} tokens/s; peak memory {peak_gb:.2f} GB; "
            f"model FLOPs {flops / 1e12:.3f} TFLOP = {formula}; share of "
            f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s: {mfu:.4f} ({smi})")
        split = train_split(model, optimizer, loss_fn, batch)
        backward = backward_top_ops(model, loss_fn, batch)
        log(f"[moe-train] split forward {split['fwd_ms']:.2f} / backward "
            f"{split['bwd_ms']:.2f} / optimizer {split['opt_ms']:.2f} ms (median of "
            f"{SPLIT_STEPS}); the backward's costliest ops by self device time "
            f"(torch.profiler) {json.dumps(backward)} ({smi})")
        split["backward_top_ops_ms"] = backward
        record.update(step_ms=step_ms, host_ms=host_ms, tokens_per_s=tokens / step_ms * 1e3,
                      peak_gb=peak_gb, model_tflop=flops / 1e12, mfu=mfu, **split)
    del optimizer, state, step
    k_routes = RoutingRecorder(model)
    loss, grads = loss_and_grads(model, loss_fn, batch)
    routing = list(k_routes.last)
    with torch.device(device):
        plain = tfm.build_transformer({**MOE_CONFIG, "attn_impl": "xla"})
    plain.load_state_dict(model.state_dict())
    del model, k_routes
    plain_fn = tfm.make_loss_fn(plain)
    p_routes = RoutingRecorder(plain)
    free_loss, free_grads = loss_and_grads(plain, plain_fn, batch)
    flips = routing_flips(routing, p_routes.last)
    p_routes.remove()
    worst_share = max(flips) / ids.size
    free_err = grad_disagreement(free_grads, grads)[0]
    del free_grads
    set_replay(plain, routing)  # plain attention at the kernel step's routing
    plain_loss, plain_grads = loss_and_grads(plain, plain_fn, batch)
    del plain
    loss_err = abs(plain_loss - loss) / abs(loss)
    grad_err, worst = grad_disagreement(grads, plain_grads)
    log(f"[moe-train] one step, plain attention at the kernel step's routing vs "
        f"the kernel's: loss {plain_loss:.5f} vs {loss:.5f} (rel {loss_err:.2e}, limit "
        f"{LOSS_REL_TOL}); worst gradient rel L2 error {grad_err:.3e} at {worst} "
        f"(limit {GRAD_REL_TOL}); routing free: tokens with another top-2 set per "
        f"layer {flips} (worst share {worst_share:.4f}, limit {MOE_BF16_REROUTE_MAX}), "
        f"loss {free_loss:.5f}, worst gradient rel L2 error {free_err:.3e}")
    if loss_err > LOSS_REL_TOL or grad_err > GRAD_REL_TOL:
        raise AssertionError("the MoE step with the kernel disagrees with plain attention")
    if worst_share > MOE_BF16_REROUTE_MAX:
        raise AssertionError(f"the kernel step routes {worst_share:.4f} of a layer's "
                             f"tokens otherwise than plain attention")
    record.update(grad_rel_err=grad_err, free_route_flips=flips, free_grad_rel_err=free_err)
    return record


def backward_top_ops(model, loss_fn, batch, n: int = 8) -> dict:
    """The ``n`` aten ops of one backward with the most self device time
    (ms, ``torch.profiler``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for p in model.parameters():
        p.grad = None
    loss, _ = loss_fn(model, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loss.backward()
        torch.cuda.synchronize()
    ops = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.self_device_time_total > 0}
    for p in model.parameters():
        p.grad = None
    return dict(sorted(ops.items(), key=lambda kv: -kv[1])[:n])


def phase_ring_hops(seed: int, smi: str, device: str = "cuda") -> dict:
    """Ring attention's hop loop (``parallel.sp.ring_hops``, the loop
    ``ring_attention`` runs over a ``torch.distributed`` ring) at the
    serving shape cut into ``RING_SHARDS`` sequence shards held in one
    process: every hop is one kernel launch at the ring's global
    ``kv_offset`` (zero, negative, and fully masked future chunks), merged
    in f32.  O and lse against one causal kernel call over the whole
    sequence; the gradients of q, k and v through O and lse against the
    plain version's (``chunk_attention`` over the whole sequence)."""
    import torch

    from tensorflowonspark_torch.ops import attention as att
    from tensorflowonspark_torch.parallel.sp import ring_hops

    cuda = device == "cuda"
    b, s, h, d = RING_SHAPE
    n = RING_SHARDS
    gen = torch.Generator(device=device).manual_seed(seed + 17)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=device).to(torch.bfloat16)
               for _ in range(3))

    def run(q, k, v):
        qs, ks, vs = (x.chunk(n, dim=1) for x in (q, k, v))
        outs, lses = [], []
        for i in range(n):
            o, lse = ring_hops(qs[i], lambda hop, i=i: (ks[(i - hop) % n], vs[(i - hop) % n]),
                               i, n, causal=True)
            outs.append(o)
            lses.append(lse)
        return torch.cat(outs, 1), torch.cat(lses, 1)

    reset_launches()
    with torch.no_grad():
        out, lse = run(q, k, v)
    if cuda:
        torch.cuda.synchronize()
    launches = att.LAUNCHES["flash_attn_fwd"]
    want = n * n if cuda else 0
    if launches != want or att.LAUNCHES["flash_attn_fwd_tf32"]:
        raise AssertionError(f"[ring] launches {att.LAUNCHES}, expected {want} of "
                             "flash_attn_fwd")
    with torch.no_grad():
        ref_o, ref_lse = att.flash_attention_fwd(q, k, v, causal=True)
    o_err = (out.float() - ref_o.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    torch.testing.assert_close(out.float(), ref_o.float(), **O_TOL)
    torch.testing.assert_close(lse, ref_lse, **LSE_TOL)

    g_o = torch.randn((b, s, h, d), generator=gen, device=device).to(torch.bfloat16)
    g_l = torch.randn((b, s, h), generator=gen, device=device)
    grads = {}
    for name in ("ring", "plain"):
        xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        before = att.LAUNCHES["flash_attn_bwd"]
        if name == "ring":
            fwd_before = att.LAUNCHES["flash_attn_fwd"]
            o2, l2 = run(*xs)
            grad_launches = att.LAUNCHES["flash_attn_fwd"] - fwd_before
        else:
            o2, l2 = att.chunk_attention(*xs, causal=True)
        ((o2.float() * g_o.float()).sum() + (l2 * g_l).sum()).backward()
        if name == "ring":
            bwd_launches = att.LAUNCHES["flash_attn_bwd"] - before
        grads[name] = {c: x.grad for c, x in zip("qkv", xs)}
    grad_err, worst = grad_disagreement(grads["ring"], grads["plain"])
    if bwd_launches != want:
        raise AssertionError(f"[ring] {bwd_launches} backward launches, expected {want} "
                             "(one a hop, through O and lse)")
    log(f"[ring] {n} shards of {s // n} (B={b} H={h} D={d} causal bf16): {launches} "
        f"launches ({grad_launches} more under autograd, and {bwd_launches} of the "
        f"backward kernels through O and lse); O max err {o_err:.4f}, lse "
        f"{lse_err:.4f} against one causal kernel call; gradients through O and lse "
        f"against the plain version: worst rel L2 {grad_err:.3e} at {worst} (limit "
        f"{GRAD_REL_TOL})")
    if grad_err > GRAD_REL_TOL:
        raise AssertionError("ring gradients disagree with the plain version's")
    record = {"launches": launches, "bwd_launches": bwd_launches, "o_max_err": o_err,
              "lse_max_err": lse_err, "grad_rel_err": grad_err}
    if cuda:
        with torch.no_grad():
            ring_ms = time_ms(lambda: run(q, k, v), reps=5, windows=3, warmup=1)[0]
            full_ms = time_ms(lambda: att.flash_attention_fwd(q, k, v, causal=True),
                              reps=10, windows=3, warmup=1)[0]
        log(f"[ring] the {n * n} hops with their merges {ring_ms:.3f} ms against "
            f"one call over the whole sequence {full_ms:.3f} ms (CUDA events; {smi})")
        record.update(ring_ms=ring_ms, full_ms=full_ms)
    return record


def pp_named_grads(grads: dict, per_stage: int) -> dict:
    """``PipelinedLM.loss_and_grads``'s gradients under the whole model's
    parameter names."""
    out = {**grads["head"], "embed.weight": grads["embed"]}
    for name, g in grads["stages"].items():
        _, j, rest = name.split(".", 2)
        for i in range(g.shape[0]):
            out[f"blocks.{i * per_stage + int(j)}.{rest}"] = g[i]
    return out


def group_rel_l2(got: dict, want: dict) -> dict:
    """The relative L2 error of each group of gradients (the stages'
    blocks, the head, the embedding) over all its parameters at once."""
    groups = {"stages": lambda n: n.startswith("blocks."),
              "head": lambda n: n in ("final_norm.scale", "lm_head.weight"),
              "embed": lambda n: n == "embed.weight"}
    out = {}
    for group, member in groups.items():
        names = [n for n in want if member(n)]
        num = sum(((got[n].float() - want[n].float()).norm() ** 2).item() for n in names)
        den = sum((want[n].float().norm() ** 2).item() for n in names)
        out[group] = math.sqrt(num / max(den, 1e-60))
    return out


def pp_against_sequential(cfg: dict, seed: int, rows: int, stages: int, micro: int,
                          route: str, device: str) -> dict:
    """One 1F1B pass of ``cfg`` (``PipelinedLM`` on a one-rank mesh: every
    stage in this process) against the sequential loss and gradients of the
    same weights; every count set to 0 just before the pipelined pass and
    read just after (2·n_layers·micro launches of ``route`` on the card).
    Returns the numbers and ``(lm, ids)`` for timing."""
    import torch

    from examples_torch.llm.train_lm import PipelinedLM, synthetic_ids
    from tensorflowonspark_torch.models import transformer as tfm
    from tensorflowonspark_torch.ops import attention as att
    from tensorflowonspark_torch.parallel.mesh import make_mesh

    model = make_train_model(cfg, seed, device)
    ids = torch.from_numpy(synthetic_ids(rows, SEQ_LEN, cfg["vocab_size"], seed)).to(device)
    seq_loss, seq_grads = loss_and_grads(model, tfm.make_loss_fn(model), {"input_ids": ids})
    lm = PipelinedLM(model, make_mesh(device), stages, micro, lr=TRAIN_LR)
    reset_launches()
    t0 = time.perf_counter()
    with count_recompute() as recomputes:
        loss, grads = lm.loss_and_grads(ids)
    if device == "cuda":
        torch.cuda.synchronize()
    pass_s = time.perf_counter() - t0
    launched = dict(att.LAUNCHES)
    want = {n: c * micro for n, c in
            step_launches(cfg, route, device == "cuda", forwards=2).items()}
    if launched != want or recomputes[0] != micro * step_recomputes(cfg, device == "cuda"):
        raise AssertionError(f"pp pass: launches {launched}, expected {want} (a forward "
                             "and a recompute of the forward per block per microbatch, "
                             "and a backward where the backward kernels take the head); "
                             f"{recomputes[0]} recompute VJPs")
    loss = loss.item()
    if not math.isfinite(loss):
        raise AssertionError(f"pp pass: loss {loss}")
    named = pp_named_grads(grads, cfg["n_layers"] // stages)
    if set(named) != set(seq_grads):
        raise AssertionError(f"pp gradients name {sorted(set(named) ^ set(seq_grads))}")
    out = {"launches": launched[route], "bwd_launches": launched.get(bwd_route(cfg), 0),
           "loss": loss, "seq_loss": seq_loss,
           "loss_rel_err": abs(loss - seq_loss) / abs(seq_loss),
           "grad_rel_err": group_rel_l2(named, seq_grads),
           "worst_param": grad_disagreement(named, seq_grads), "pass_ms": pass_s * 1e3}
    del seq_grads, grads, named
    return {**out, "model": model, "lm": lm, "ids": ids}


def phase_pp(seed: int, smi: str, device: str = "cuda") -> dict:
    """Pipeline parallelism at the LM's full width (module docstring, 24)."""
    import torch

    from examples_torch.llm.train_lm import PipelinedLM
    from tensorflowonspark_torch.models import transformer as tfm
    from tensorflowonspark_torch.ops import attention as att
    from tensorflowonspark_torch.parallel.mesh import make_mesh

    cuda = device == "cuda"
    cfg = LM_CONFIG
    s, m = PP_STAGES, PP_MICRO
    run = pp_against_sequential(cfg, seed + 23, PP_BATCH, s, m, "flash_attn_fwd", device)
    model, lm, ids = run.pop("model"), run.pop("lm"), run.pop("ids")
    errs = run["grad_rel_err"]
    bubble = (s - 1) / (m + s - 1)
    log(f"[pp] 1F1B, {s} stages of {cfg['n_layers'] // s} blocks in one process, B={PP_BATCH} "
        f"S={SEQ_LEN} in {m} microbatches (bubble {bubble:.4f}): {run['launches']} launches "
        f"of flash_attn_fwd (2 x {cfg['n_layers']} layers x {m}) and {run['bwd_launches']} "
        f"of flash_attn_bwd ({cfg['n_layers']} x {m}); loss {run['loss']:.5f} "
        f"against the sequential step's {run['seq_loss']:.5f} (rel {run['loss_rel_err']:.2e}, "
        f"limit {LOSS_REL_TOL}); gradients rel L2 stages {errs['stages']:.3e}, head "
        f"{errs['head']:.3e}, embedding {errs['embed']:.3e} (limit {GRAD_REL_TOL}; worst "
        f"parameter {run['worst_param'][0]:.3e} at {run['worst_param'][1]}); one pass "
        f"{run['pass_ms']:.1f} ms host clock ({smi})")
    if run["loss_rel_err"] > LOSS_REL_TOL or max(errs.values()) > GRAD_REL_TOL:
        raise AssertionError("the pipelined step disagrees with the sequential one")

    # the same pipeline with plain attention: no launch, the same numbers
    with torch.device(device):
        plain = tfm.build_transformer({**cfg, "attn_impl": "xla"})
    plain.load_state_dict(model.state_dict())
    plain_lm = PipelinedLM(plain, make_mesh(device), s, m, lr=TRAIN_LR)
    del plain
    reset_launches()
    p_loss, p_grads = plain_lm.loss_and_grads(ids)
    if any(att.LAUNCHES.values()):
        raise AssertionError(f"the plain pipeline launched a kernel: {att.LAUNCHES}")
    _, k_grads = lm.loss_and_grads(ids)
    per = cfg["n_layers"] // s
    p_errs = group_rel_l2(pp_named_grads(k_grads, per), pp_named_grads(p_grads, per))
    p_loss = p_loss.item()
    p_loss_err = abs(run["loss"] - p_loss) / abs(p_loss)
    del plain_lm, p_grads, k_grads
    log(f"[pp] against plain attention (attn_impl xla) through the same pipeline: loss "
        f"{p_loss:.5f} (rel {p_loss_err:.2e}), gradients rel L2 stages "
        f"{p_errs['stages']:.3e}, head {p_errs['head']:.3e}, embedding {p_errs['embed']:.3e}")
    if p_loss_err > LOSS_REL_TOL or max(p_errs.values()) > GRAD_REL_TOL:
        raise AssertionError("the pipelined step disagrees with plain attention")
    record = {**run, "bubble": bubble, "stages": s, "microbatches": m, "batch": PP_BATCH,
              "plain_loss_rel_err": p_loss_err, "plain_grad_rel_err": p_errs}
    del model
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(PP_WARMUP):
            lm.step(ids)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        reset_launches()
        losses = []
        start.record()
        t_host = time.perf_counter()
        for _ in range(PP_TIMED):
            losses.append(lm.step(ids))
        end.record()
        end.synchronize()
        host_ms = (time.perf_counter() - t_host) * 1e3 / PP_TIMED
        per_step = att.LAUNCHES["flash_attn_fwd"] / PP_TIMED
        bwd_per_step = att.LAUNCHES["flash_attn_bwd"] / PP_TIMED
        step_ms = start.elapsed_time(end) / PP_TIMED
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        tokens = PP_BATCH * SEQ_LEN
        losses = [x.item() for x in losses]
        log(f"[pp] AdamW steps: {step_ms:.2f} ms a step (CUDA events over {PP_TIMED} "
            f"steps; host {host_ms:.2f} ms), {tokens / step_ms * 1e3:.0f} tokens/s, bubble "
            f"{bubble:.4f}, peak memory {peak_gb:.2f} GB, {per_step:g} launches a step; "
            "losses " + ", ".join(f"{x:.4f}" for x in losses) + f" ({smi})")
        if (per_step != run["launches"] or bwd_per_step != run["bwd_launches"]
                or not all(math.isfinite(x) for x in losses)):
            raise AssertionError(f"pp steps: {per_step} forward and {bwd_per_step} "
                                 f"backward launches a step, losses {losses}")
        # the card's busy time in one step (torch.profiler), against the step
        census = profile_census(lambda: lm.step(ids))
        idle = max(0.0, 1.0 - census["device_ms"] / step_ms)
        log(f"[pp] one step's kernels: {census['device_ms']:.2f} ms of device time, idle "
            f"share {idle:.4f} of the step; costliest ops (ms) "
            + json.dumps({k: round(v, 2) for k, v in census["top_other_ms"].items()}))
        record.update(step_ms=step_ms, host_ms=host_ms, tokens_per_s=tokens / step_ms * 1e3,
                      peak_gb=peak_gb, launches_per_step=per_step, step_losses=losses,
                      device_busy_ms=census["device_ms"], idle_share=idle,
                      top_ops_ms=census["top_other_ms"])
    del lm
    if cuda:
        torch.cuda.empty_cache()

    # f32 at PP_F32_LAYERS layers of the same width, through the 3xTF32 kernel
    f32_cfg = {**cfg, "n_layers": PP_F32_LAYERS, "bf16": False}
    f32 = pp_against_sequential(f32_cfg, seed + 29, PP_F32_BATCH, PP_F32_LAYERS,
                                PP_F32_MICRO, "flash_attn_fwd_tf32", device)
    for key in ("model", "lm", "ids"):
        f32.pop(key)
    log(f"[pp-f32] {PP_F32_LAYERS} stages of 1 block, B={PP_F32_BATCH} in {PP_F32_MICRO} "
        f"microbatches: {f32['launches']} launches of flash_attn_fwd_tf32 and "
        f"{f32['bwd_launches']} of flash_attn_bwd_tf32 ({PP_F32_LAYERS} x {PP_F32_MICRO}), "
        f"no recompute VJP; loss rel "
        f"{f32['loss_rel_err']:.2e}, gradients rel L2 "
        + ", ".join(f"{k} {v:.3e}" for k, v in f32["grad_rel_err"].items())
        + f" (limit {PP_F32_TOL}) ({smi})")
    if f32["loss_rel_err"] > PP_F32_TOL or max(f32["grad_rel_err"].values()) > PP_F32_TOL:
        raise AssertionError("the f32 pipelined step disagrees with the sequential one")
    record["f32"] = f32
    return record


def phase_sharded_scoring(seed: int, smi: str, device: str = "cuda") -> dict:
    """``TorchModel.transform`` with ``scoring="sharded"`` against
    ``scoring="task"`` (module docstring, 25), on the bundle the slice
    phase left (the cluster phase's reloaded weights)."""
    import numpy as np

    from examples_torch.llm.train_lm import synthetic_ids
    from tensorflowonspark_torch.data import PartitionedDataset
    from tensorflowonspark_torch.pipeline import TorchModel

    export = os.path.join(WORK_DIR, "lm_bundle")
    ids = synthetic_ids(SCORE_ROWS, SEQ_LEN, LM_CONFIG["vocab_size"], seed + 31)
    rows = [{"input_ids": ids[i]} for i in range(SCORE_ROWS)]
    per_batch = LM_CONFIG["n_layers"] if device == "cuda" else 0  # no kernel on the CPU
    batches = SCORE_ROWS // SCORE_BATCH
    out, record = {}, {}
    for scoring in ("sharded", "task"):
        model = TorchModel(tf_args={"device": device, "postprocess": "argmax"})
        model.set("export_dir", export).set("torch_distributed", scoring == "sharded")
        model.set("input_mapping", {"input_ids": "input_ids"})
        model.setNumExecutors(1).setBatchSize(SCORE_BATCH).setScoring(scoring)
        model.set("reservation_timeout", 300.0)
        t0 = time.perf_counter()
        scored = list(model.transform(PartitionedDataset.from_iterable(rows, SCORE_PARTS)))
        secs = time.perf_counter() - t0
        nodes = {k: v for k, v in model.last_cluster_metrics["nodes"].items() if k != "driver"}
        launches = sum((v.get("counters") or {}).get("attn.flash_fwd_launches", 0)
                       for v in nodes.values())
        preds = np.stack([np.asarray(r["prediction"]) for r in scored])
        log(f"[sharded-scoring] scoring={scoring}: {len(scored)} rows of {SEQ_LEN} ids in "
            f"{SCORE_PARTS} partitions, batches of {SCORE_BATCH}, argmax: {secs:.2f} s "
            f"host clock; {launches} kernel launches on the node ({per_batch} a batch) "
            f"({smi})")
        if len(scored) != SCORE_ROWS or preds.shape != (SCORE_ROWS, SEQ_LEN):
            raise AssertionError(f"scoring={scoring}: {len(scored)} rows, ids {preds.shape}")
        if not all(np.array_equal(r["input_ids"], ids[i]) for i, r in enumerate(scored)):
            raise AssertionError(f"scoring={scoring}: rows out of order")
        if preds.min() < 0 or preds.max() >= LM_CONFIG["vocab_size"]:
            raise AssertionError(f"scoring={scoring}: ids outside the vocab")
        if launches != per_batch * batches:
            raise AssertionError(f"scoring={scoring}: {launches} launches, expected "
                                 f"{per_batch} x {batches} batches")
        out[scoring] = preds
        record[scoring] = {"seconds": secs, "launches": launches}
    if not np.array_equal(out["sharded"], out["task"]):
        raise AssertionError("sharded scoring's ids differ from task scoring's")
    log("[sharded-scoring] every row's ids equal between sharded and task scoring")
    record["launches"] = record["sharded"]["launches"]
    return record


def conv_dense_flops(model, image) -> tuple[float, int]:
    """Forward FLOPs of ``model`` on ``image`` (a one-image NHWC batch),
    counted from the shapes of every ``Conv`` and ``Dense`` it runs (2 per
    multiply-add; batch norm, pooling and activations are not counted), and
    the number of layers counted."""
    import torch

    from tensorflowonspark_torch.models import layers

    counted = []

    def hook(module, inputs, out):
        if isinstance(module, layers.Conv):
            counted.append(2 * out.numel() * module.weight[0].numel())
        else:
            counted.append(2 * out.numel() * module.weight.shape[1])

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (layers.Conv, layers.Dense))]
    training = model.training
    try:
        with torch.inference_mode():
            model.eval()(image)
    finally:
        model.train(training)
        for h in handles:
            h.remove()
    return float(sum(counted)), len(counted)


CENSUS_ELEMENTWISE = ("add", "add_", "mul", "mul_", "div", "div_", "sub", "neg",
                      "relu", "relu_", "clamp_min", "threshold_backward", "copy_",
                      "_to_copy", "clone", "fill_", "zero_", "square", "pow", "where",
                      "constant_pad_nd")  # relu runs as clamp_min on the card


def census_category(op: str) -> str:
    name = op.removeprefix("aten::")
    if "conv" in name:
        return "convolution"
    if "batch_norm" in name:
        return "batch_norm"
    if name.startswith("_foreach") or "sgd" in name.lower():
        return "optimizer"
    if name in CENSUS_ELEMENTWISE:
        return "elementwise"
    return "other"


def profile_census(fn) -> dict:
    """Device time of one ``fn()`` by category of the op that launched each
    kernel (``torch.profiler`` self device time): convolutions, batch norm,
    elementwise ops, the optimizer, the rest (with its largest ops)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    totals: dict = {}
    others: dict = {}
    for e in prof.key_averages():
        # the kernels' own entries repeat the device time of the op that
        # launched them: count each kernel once, under its op
        if e.device_type != DeviceType.CPU:
            continue
        us = e.self_device_time_total
        if us <= 0:
            continue
        cat = census_category(e.key)
        totals[cat] = totals.get(cat, 0.0) + us / 1e3
        if cat == "other":
            others[e.key] = others.get(e.key, 0.0) + us / 1e3
    top = dict(sorted(others.items(), key=lambda kv: -kv[1])[:6])
    return {"ms": totals, "device_ms": sum(totals.values()), "top_other_ms": top}


def phase_resnet50(seed: int, smi: str) -> dict:
    """ResNet-50 training at full width on the card, the JAX bench's setup
    (``bench.py:49-110``): 224 px, 1000 classes, bf16 compute over f32
    master weights, bf16 BN outputs, SGD with Nesterov momentum 0.9 at lr
    0.1, L2 1e-4, batch 256, one synthetic batch resident on the card;
    ``RESNET_WARMUP`` warm-up and ``RESNET_TIMED`` timed steps (CUDA
    events).  Gate: every loss finite and the last below the first."""
    import torch

    from tensorflowonspark_torch.models import resnet
    from tensorflowonspark_torch.parallel import dp

    with torch.device("cuda"):
        model = resnet.build_resnet50(RESNET_CONFIG)
    model.init_weights(torch.Generator(device="cuda").manual_seed(seed))
    optimizer = torch.optim.SGD(model.parameters(), lr=RESNET_LR, momentum=0.9,
                                nesterov=True)
    loss_fn = resnet.make_loss_fn(model, weight_decay=RESNET_WD)
    step = dp.make_bn_train_step(loss_fn, optimizer)
    state = dp.BNTrainState.create(model, optimizer)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    batch = {"image": torch.rand(RESNET_BATCH, RESNET_SIZE, RESNET_SIZE, 3,
                                 generator=gen, device="cuda"),
             "label": torch.arange(RESNET_BATCH, device="cuda", dtype=torch.int32)
             % RESNET_CONFIG["num_classes"]}
    fwd_flops, n_layers = conv_dense_flops(model, batch["image"][:1])
    step_flops = 3 * fwd_flops * RESNET_BATCH
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[resnet50] {n_params / 1e6:.2f} M f32 master params, bf16 compute and BN "
        f"output, channels_last, B={RESNET_BATCH} at {RESNET_SIZE} px, SGD nesterov "
        f"lr {RESNET_LR}, L2 {RESNET_WD}; forward {fwd_flops / 1e9:.3f} GFLOP per image "
        f"over {n_layers} conv/dense layers")
    losses = []
    for _ in range(RESNET_WARMUP):
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t_host = time.perf_counter()
    start.record()
    for _ in range(RESNET_TIMED):
        state, m = step(state, batch)
        losses.append(m["loss"])
    end.record()
    host_ms = (time.perf_counter() - t_host) * 1e3 / RESNET_TIMED  # queueing only
    end.synchronize()
    step_ms = start.elapsed_time(end) / RESNET_TIMED
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [x.item() for x in losses]
    log("[resnet50] losses: " + ", ".join(f"{x:.4f}" for x in losses))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("a ResNet-50 loss is not finite")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the ResNet-50 loss did not fall on a repeated batch: "
                             f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    images_s = RESNET_BATCH / step_ms * 1e3
    mfu = step_flops / (step_ms * 1e-3) / PEAK_BF16_FLOPS
    split = train_split(model, optimizer, loss_fn, batch)
    census = profile_census(lambda: step(state, batch))
    busy = census["device_ms"] / step_ms
    log(f"[resnet50] step {step_ms:.2f} ms on the card (CUDA events over "
        f"{RESNET_TIMED} steps; host queues a step in {host_ms:.2f} ms) ({smi})")
    log(f"[resnet50] {images_s:.1f} images/s on the card ({smi})")
    log(f"[resnet50] model FLOPs share: 3 x {fwd_flops / 1e9:.3f} GFLOP x {RESNET_BATCH} "
        f"= {step_flops / 1e12:.3f} TFLOP per step over {PEAK_BF16_FLOPS / 1e12:.0f} "
        f"TFLOP/s: {mfu:.4f} ({smi})")
    log(f"[resnet50] peak memory {peak_gb:.2f} GB ({smi})")
    log(f"[resnet50] split forward {split['fwd_ms']:.2f} / backward {split['bwd_ms']:.2f} / "
        f"optimizer {split['opt_ms']:.2f} ms (median of {SPLIT_STEPS}) ({smi})")
    log(f"[resnet50] census of one step (torch.profiler, device ms by the op that "
        f"launched the kernel): "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(census["ms"].items()))
        + f"; total {census['device_ms']:.2f} ms = {busy:.3f} of the step; largest "
        f"'other': " + ", ".join(f"{k} {v:.2f}" for k, v in census["top_other_ms"].items())
        + f" ({smi})")
    del model, optimizer, state, batch
    return {"step_ms": step_ms, "host_ms": host_ms, "images_per_s": images_s,
            "forward_gflop_per_image": fwd_flops / 1e9, "model_tflop_per_step":
            step_flops / 1e12, "mfu": mfu, "peak_gb": peak_gb, **split,
            "census_ms": census["ms"], "device_busy_share": busy,
            "first_loss": losses[0], "last_loss": losses[-1]}


def rel_l2(got, want) -> float:
    return ((got.float().cpu() - want.float().cpu()).norm()
            / want.float().cpu().norm().clamp_min(1e-30)).item()


def bn_step_numbers(batch: dict, weights: dict, device: str) -> dict:
    """One ``make_bn_train_step`` step of ``BN_CHECK_CONFIG`` from
    ``weights`` on ``device``: its loss, gradients and updated state."""
    import torch

    from tensorflowonspark_torch.models import resnet
    from tensorflowonspark_torch.parallel import dp

    with torch.device(device):
        model = resnet.build_resnet_cifar(BN_CHECK_CONFIG)
    model.load_state_dict(weights)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9, nesterov=True)
    grads = {}
    update = opt.step

    def capture_then_update():
        # copies: the foreach SGD on the card adds the Nesterov term to the
        # gradients in place
        grads.update({n: p.grad.detach().cpu().clone()
                      for n, p in model.named_parameters()})
        return update()

    opt.step = capture_then_update
    step = dp.make_bn_train_step(resnet.make_loss_fn(model, weight_decay=1e-4), opt)
    _, m = step(dp.BNTrainState.create(model, opt), batch)
    return {"loss": m["loss"].item(), "grads": grads,
            "state": {k: v.cpu() for k, v in model.state_dict().items()}}


def rel_l2_all(got: dict, want: dict) -> float:
    """The relative L2 error of a dict of tensors taken as one vector."""
    num = sum(((got[k].float() - w.float()) ** 2).sum().item() for k, w in want.items())
    den = sum((w.float() ** 2).sum().item() for w in want.values())
    return math.sqrt(num / max(den, 1e-300))


def phase_bn_card_vs_cpu(seed: int, smi: str) -> dict:
    """One ``make_bn_train_step`` step of a small f32 ``resnet_cifar`` from
    the same weights on the card and on the CPU: loss, gradients, updated
    running statistics and parameters; twice on the card.

    With cuDNN's TF32 off, the card computes the CPU's function in f32: each
    gradient per parameter, the loss and the updated state are held to the
    f32 tolerances.  With TF32 on, PyTorch's default and what the port's
    f32 configurations run on the card (as the JAX package's default
    precision gives f32 convolutions on a GPU), each product is rounded to
    2^-11: the loss, the running statistics, and the gradients and the
    updated parameters taken as whole vectors are held to the TF32
    tolerances; a gradient per parameter is reported, not held: one that
    mostly cancels (a bias feeding a train-mode BN, which removes the mean
    of what it is fed) keeps TF32's 2^-11 of its terms, far more than
    2^-11 of itself."""
    import numpy as np
    import torch

    from tensorflowonspark_torch.models import resnet

    rng = np.random.RandomState(seed + 3)
    batch = {"image": rng.rand(BN_CHECK_BATCH, 32, 32, 3).astype(np.float32),
             "label": (np.arange(BN_CHECK_BATCH) % 10).astype(np.int32)}
    weights = resnet.build_resnet_cifar(BN_CHECK_CONFIG).init_weights(
        torch.Generator().manual_seed(seed)).state_dict()
    cpu = bn_step_numbers(batch, weights, "cpu")
    stats = [k for k in cpu["state"] if k.endswith(("running_mean", "running_var"))]
    params = [k for k in cpu["state"] if k not in stats]
    previous = torch.backends.cudnn.allow_tf32
    out = {}
    try:
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            card = bn_step_numbers(batch, weights, "cuda")
            errs = {"loss": abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
                    "stats": max(rel_l2(card["state"][k], cpu["state"][k]) for k in stats),
                    "grads_all": rel_l2_all(card["grads"], cpu["grads"]),
                    "params_all": rel_l2_all({k: card["state"][k] for k in params},
                                             {k: cpu["state"][k] for k in params})}
            per = {n: rel_l2(card["grads"][n], g) for n, g in cpu["grads"].items()}
            worst = max(per, key=per.get)
            errs["grad_worst"] = per[worst]
            mode = "tf32" if tf32 else "f32"
            tol = BN_TF32_TOL if tf32 else BN_F32_TOL
            log(f"[bn-card-vs-cpu] one BN step of resnet_cifar f32 (depth_blocks "
                f"{BN_CHECK_CONFIG['depth_blocks']}, width {BN_CHECK_CONFIG['width']}, B="
                f"{BN_CHECK_BATCH}), cuDNN convs in {mode.upper()}: loss {card['loss']:.6f} vs "
                f"CPU {cpu['loss']:.6f}; errors "
                + ", ".join(f"{k} {v:.2e} (limit {tol[k]})" for k, v in errs.items()
                            if k in tol)
                + f"; worst gradient per parameter {per[worst]:.2e} at {worst}"
                + (" (not held)" if "grad_worst" not in tol else "") + f" ({smi})")
            bad = {k: v for k, v in errs.items() if k in tol and not v <= tol[k]}
            if bad:
                raise AssertionError(f"the BN step on the card in {mode} disagrees with "
                                     f"the CPU's: {bad}")
            out[mode] = errs
    finally:
        torch.backends.cudnn.allow_tf32 = previous
    return out


def inception_bundle(seed: int, path: str, device: str = "cuda") -> None:
    """Export a random-init Inception-v3 bundle (``INCEPTION_CONFIG``, the
    JAX package's layout) whose BN running statistics are a batch's own:
    one train-mode forward over 32 synthetic images with momentum 0.  With
    the init's statistics (mean 0, var 1) every image gets the same class;
    with these the class depends on the image, so the order of served
    results can be checked."""
    import numpy as np
    import torch

    from tensorflowonspark_torch.checkpoint import export_bundle
    from tensorflowonspark_torch.convert import torch_to_flax
    from tensorflowonspark_torch.models import inception, layers

    model = inception.build_inception_v3(INCEPTION_CONFIG).init_weights(
        torch.Generator().manual_seed(seed)).to(device)
    norms = [m for m in model.modules() if isinstance(m, layers.BatchNorm)]
    for m in norms:
        m.momentum = 0.0
    x = np.stack(inception.synthetic_images(32, INCEPTION_SIZE, seed=seed + 6))
    with torch.no_grad():
        model.train()(torch.from_numpy(x).to(device))
    for m in norms:
        m.momentum = 0.9997
    export_bundle(path, torch_to_flax(model.state_dict(), config=INCEPTION_CONFIG),
                  INCEPTION_CONFIG)


def phase_inception(seed: int, smi: str) -> dict:
    """The Inception-v3 serving forward on the card, bf16 at 299 px, batch
    32, through ``build_apply`` over ``inception_bundle``'s: ms per batch and
    images/s (CUDA events); two images' logits against the f32 model on the
    CPU, from the card in f32 and in bf16 (``INCEPTION_F32_TOL`` says
    how each is held)."""
    import numpy as np
    import torch

    from tensorflowonspark_torch.checkpoint import load_bundle
    from tensorflowonspark_torch.models.registry import build_apply

    path = os.path.join(WORK_DIR, "inception_bundle")
    inception_bundle(seed, path)
    variables, config = load_bundle(path)
    apply = build_apply(config)
    x = torch.from_numpy(np.random.RandomState(seed + 4).rand(
        INCEPTION_BATCH, INCEPTION_SIZE, INCEPTION_SIZE, 3).astype(np.float32)).cuda()
    logits = apply(variables, x)
    if logits.shape != (INCEPTION_BATCH, INCEPTION_CONFIG["num_classes"]) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"Inception-v3 logits {tuple(logits.shape)} not finite")
    x2 = x[:2].cpu()
    f32 = build_apply({**config, "bf16": False}, device="cpu")(variables, x2)

    def off(t):  # share of the largest f32 logit
        return (t.float().cpu() - f32).abs().max().item() / f32.abs().max().item()

    err_f32 = off(build_apply({**config, "bf16": False})(variables, x2))  # TF32 off here
    err = off(logits[:2])
    err_cpu = off(build_apply(config, device="cpu")(variables, x2))
    ms, host_ms = time_ms(lambda: apply(variables, x), reps=10, windows=3)
    images_s = INCEPTION_BATCH / ms * 1e3
    fwd_flops, _ = conv_dense_flops(apply.model, x[:1])
    log(f"[inception] forward bf16 B={INCEPTION_BATCH} at {INCEPTION_SIZE} px: {ms:.2f} ms "
        f"per batch, {images_s:.1f} images/s on the card (CUDA events; host {host_ms:.2f} "
        f"ms per call); {fwd_flops / 1e9:.3f} GFLOP per image, share of "
        f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s {fwd_flops * INCEPTION_BATCH / (ms * 1e-3) / PEAK_BF16_FLOPS:.4f}; "
        f"logits against the f32 model on the CPU, as shares of its largest: the card "
        f"in f32 {err_f32:.2e} (limit {INCEPTION_F32_TOL}), the card in bf16 {err:.2e}, "
        f"the CPU in bf16 {err_cpu:.2e} (the card's bf16 limit: twice the CPU's) ({smi})")
    if err_f32 > INCEPTION_F32_TOL or err > 2 * err_cpu:
        raise AssertionError("Inception-v3 on the card disagrees with the CPU's")
    return {"ms": ms, "images_per_s": images_s, "f32_logit_rel_err": err_f32,
            "bf16_logit_rel_err": err, "cpu_bf16_logit_rel_err": err_cpu,
            "forward_gflop_per_image": fwd_flops / 1e9}


def phase_image_clusters(seed: int, smi: str, device: str = "cuda") -> dict:
    """The BASELINE image examples through the port's cluster, node
    processes on the card, host-clock times: ``mnist_dist`` STREAMING train
    at the published widths on 2 executors, its export, and
    ``inference_fun`` (ordered, exactly counted, accuracy > 0.5, as
    ``tests/test_mnist_e2e.py``); ``mnist_tfr`` and ``cifar10_train``
    DIRECT, each exporting a bundle; ``inception_infer`` over 64 images
    (exactly 64 results, in order: each the argmax that ``build_apply``
    gives that image in a batch of 32 on the card).  ``device="cpu"``
    rehearses it on the CPU."""
    import numpy as np

    import tensorflowonspark_torch as tos
    from examples_torch.cifar10 import cifar10_train
    from examples_torch.imagenet import inception_infer
    from examples_torch.mnist import mnist_dist, mnist_tfr
    from tensorflowonspark_torch.checkpoint import latest_step_dir, load_bundle
    from tensorflowonspark_torch.models.inception import synthetic_images
    from tensorflowonspark_torch.models.mnist import synthetic_mnist
    from tensorflowonspark_torch.models.registry import build_apply

    out = {}
    logs = os.path.join(WORK_DIR, "image_logs")

    def timed(name, fn):
        t0 = time.perf_counter()
        result = fn()
        out[f"{name}_s"] = time.perf_counter() - t0
        return result

    args = {"batch_size": 64, "lr": 0.05, "model_dir": os.path.join(WORK_DIR, "mnist_model"),
            "export_dir": os.path.join(WORK_DIR, "mnist_export"), "checkpoint_every": 10,
            "device": device}

    def mnist_train():
        cluster = tos.run(mnist_dist.main_fun, args, num_executors=2,
                          input_mode=tos.InputMode.STREAMING, log_dir=logs,
                          reservation_timeout=300)
        try:
            cluster.train(tos.PartitionedDataset.from_iterable(
                synthetic_mnist(MNIST_SAMPLES), 8), num_epochs=2)
        finally:
            cluster.shutdown(timeout=300)

    timed("mnist_dist_train", mnist_train)
    step = int(latest_step_dir(args["model_dir"]).rsplit("_", 1)[1])
    samples = synthetic_mnist(64, seed=9)

    def mnist_infer():
        cluster = tos.run(mnist_dist.inference_fun, args, num_executors=2,
                          input_mode=tos.InputMode.STREAMING, log_dir=logs,
                          reservation_timeout=300)
        try:
            return cluster.inference([list(p) for p in (samples[:20], samples[20:45],
                                                        samples[45:])])
        finally:
            cluster.shutdown(timeout=300)

    preds = timed("mnist_dist_inference", mnist_infer)
    labels = [label for _, label in samples]
    acc = sum(p == label for p, label in zip(preds, labels)) / len(labels)
    variables, config = load_bundle(args["export_dir"])
    images = np.stack([img for img, _ in samples])
    want = build_apply(config, device)(variables, images).argmax(-1).cpu().tolist()
    # the nodes run f32 convs in TF32 (PyTorch's default), this process in
    # full f32 (phase_device), so a near tie may flip: 95% must agree
    agree = sum(p == w for p, w in zip(preds, want)) / len(want)
    log(f"[mnist_dist] STREAMING train, 2 executors on the card, features (32, 64), "
        f"dense 256, {MNIST_SAMPLES} samples x 2 epochs: {out['mnist_dist_train_s']:.1f} s "
        f"(the chief's step {step}); inference_fun over 64 images: "
        f"{out['mnist_dist_inference_s']:.1f} s, {len(preds)} results, accuracy {acc:.3f}, "
        f"{agree:.3f} equal in order to build_apply's (host clock; {smi})")
    if len(preds) != 64 or acc <= 0.5 or agree < 0.95:
        raise AssertionError(f"mnist_dist inference: {len(preds)} results, accuracy "
                             f"{acc}, {agree} in order")
    out.update(mnist_accuracy=acc, mnist_steps=step)

    tfr = os.path.join(WORK_DIR, "mnist_tfr")
    mnist_tfr.prepare_data(tfr, samples=MNIST_SAMPLES, partitions=4)
    tfr_export = os.path.join(WORK_DIR, "mnist_tfr_export")

    def direct(main_fun, fn_args, executors):
        cluster = tos.run(main_fun, fn_args, num_executors=executors,
                          input_mode=tos.InputMode.DIRECT, log_dir=logs,
                          reservation_timeout=300)
        cluster.shutdown(timeout=600)

    timed("mnist_tfr", lambda: direct(mnist_tfr.main_fun, {
        "data_dir": tfr, "export_dir": tfr_export, "epochs": 1, "batch_size": 64,
        "device": device}, 2))
    variables, config = load_bundle(tfr_export)
    logits = build_apply(config, device)(variables, images)
    tfr_acc = (logits.argmax(-1).cpu().numpy() == np.asarray(labels)).mean()
    log(f"[mnist_tfr] DIRECT train from {MNIST_SAMPLES} TFRecord rows, 2 executors: "
        f"{out['mnist_tfr_s']:.1f} s; its bundle scores {tfr_acc:.3f} on the 64 images "
        f"(host clock; {smi})")
    if not np.isfinite(logits.cpu().numpy()).all():
        raise AssertionError("mnist_tfr's bundle gives non-finite logits")

    cifar = os.path.join(WORK_DIR, "cifar_tfr")
    cifar10_train.prepare_data(cifar, samples=CIFAR_SAMPLES, partitions=2)
    cifar_export = os.path.join(WORK_DIR, "cifar_export")
    timed("cifar10_train", lambda: direct(cifar10_train.main_fun, {
        "data_dir": cifar, "export_dir": cifar_export, "epochs": 1, "batch_size": 64,
        "device": device}, 2))
    variables, config = load_bundle(cifar_export)
    moved = not np.allclose(variables["batch_stats"]["bn_init"]["var"], 1.0)
    log(f"[cifar10_train] DIRECT train of resnet_cifar (ResNet-29, bf16) from "
        f"{CIFAR_SAMPLES} TFRecord rows, 2 executors: {out['cifar10_train_s']:.1f} s; "
        f"bundle holds {sorted(variables)}, running variance moved: {moved} "
        f"(host clock; {smi})")
    if set(variables) != {"params", "batch_stats"} or not moved:
        raise AssertionError("cifar10_train exported no trained BN bundle")

    inc = os.path.join(WORK_DIR, "inception_bundle")  # phase_inception's
    preds = timed("inception_infer", lambda: inception_infer.main(
        ["--images", "64", "--export-dir", inc, "--log-dir", logs, "--device", device]))
    variables, config = load_bundle(inc)
    apply = build_apply(config, device)
    imgs = synthetic_images(64, 299)
    want = [p for i in range(0, 64, 32)
            for p in apply(variables, np.stack(imgs[i:i + 32])).argmax(-1).cpu().tolist()]
    log(f"[inception_infer] 64 images at 299 px, 1 executor, batch 32: "
        f"{out['inception_infer_s']:.1f} s, {len(preds)} results, equal in order to "
        f"build_apply's: {preds == want} (host clock; {smi})")
    if preds != want:
        raise AssertionError("inception_infer's results are not the images' own, in order")
    return out


def wide_deep_table_bytes(config: dict) -> int:
    """Bytes of the two f32 tables (``embeddings`` [26V, D] and
    ``wide_weights`` [26V, 1]), from the config's shapes."""
    from tensorflowonspark_torch.models.wide_deep import table_total_rows

    return table_total_rows(config) * (config["embed_dim"] + 1) * 4


WD_CENSUS = ("optimizer", "embedding_backward", "gather", "matmul", "rest")


def wide_deep_category(names: list) -> str:
    """The census category of a kernel from the ops that launched it,
    innermost first: the optimizer's step, the embedding backward, the
    gather, the matmuls, the rest."""
    chain = " ".join(names)
    if "Optimizer.step" in chain:
        return "optimizer"
    if "embedding_dense_backward" in chain or "EmbeddingBackward" in chain:
        return "embedding_backward"
    if "aten::embedding" in chain:
        return "gather"
    if any(n.removeprefix("aten::") in ("mm", "addmm", "bmm", "linear", "matmul")
           for n in names[:1]):
        return "matmul"
    return "rest"


def wide_deep_census(fn) -> dict:
    """Device time of one ``fn()`` by ``WD_CENSUS`` category
    (``torch.profiler``; each kernel counted once, under the chain of ops
    that launched it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    totals = dict.fromkeys(WD_CENSUS, 0.0)
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        us = getattr(e, "self_device_time_total", 0.0)
        if us <= 0:
            continue
        names, node = [], e
        while node is not None:
            names.append(node.name)
            node = node.cpu_parent
        totals[wide_deep_category(names)] += us / 1e3
    return {"ms": totals, "device_ms": sum(totals.values())}


def wide_deep_host_split(model, optimizer, loss_fn, batch) -> dict:
    """Host-clock ms of a step's parts, median of ``SPLIT_STEPS`` steps: the
    time the host takes to queue the forward, the backward and the
    optimizer's update (a part that waits for the card inside, such as a
    device-to-host read, counts that wait too), then the wait for the card
    to finish.  These steps update the model too."""
    import torch

    times = {"forward": [], "backward": [], "optimizer": [], "wait": []}
    for _ in range(SPLIT_STEPS):
        for p in model.parameters():
            p.grad = None
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        loss, _ = loss_fn(model, batch)
        t.append(time.perf_counter())
        loss.backward()
        t.append(time.perf_counter())
        optimizer.step()
        t.append(time.perf_counter())
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        for key, (a, b) in zip(times, zip(t, t[1:])):
            times[key].append((b - a) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def phase_wide_deep(seed: int, smi: str) -> dict:
    """Monolithic wide-and-deep training at full width on the card
    (``WD_CONFIG``, batch ``WD_BATCH``, optax's Adagrad at ``WD_LR``, one
    synthetic Criteo batch resident on the card), in f32 (what the example
    trains) and in bf16 (the registry default): ``WD_WARMUP`` warm-up and
    ``WD_TIMED`` timed steps (CUDA events); step ms, rows/s, forward-only
    scoring rows/s, peak memory, a census of one step, and the step's bytes
    bound: the dense table gradient written once and the Adagrad update
    reading parameter, gradient and accumulator and writing two of them,
    six passes over the tables at ``PEAK_BYTES``.  Gate: every loss finite
    and the last below the first."""
    import torch

    from tensorflowonspark_torch.models import wide_deep
    from tensorflowonspark_torch.optim import Adagrad
    from tensorflowonspark_torch.parallel import dp

    table = wide_deep_table_bytes(WD_CONFIG)
    bound_ms = 6 * table / PEAK_BYTES * 1e3
    batch = wide_deep.batch_to_arrays(wide_deep.synthetic_criteo(WD_BATCH, seed=seed))
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    out = {}
    for name, bf16 in (("f32", False), ("bf16", True)):
        config = {**WD_CONFIG, "bf16": bf16}
        torch.cuda.reset_peak_memory_stats()
        with torch.device("cuda"):
            model = wide_deep.build_wide_deep(config)
        wide_deep.init_params(model, torch.Generator("cuda").manual_seed(seed))
        optimizer = Adagrad(model.parameters(), WD_LR)
        state = dp.TrainState.create(model, optimizer)
        step = dp.make_train_step(wide_deep.make_loss_fn(model), optimizer)
        losses = []
        for _ in range(WD_WARMUP):
            state, m = step(state, batch)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t_host = time.perf_counter()
        start.record()
        for _ in range(WD_TIMED):
            state, m = step(state, batch)
            losses.append(m["loss"])
        end.record()
        host_ms = (time.perf_counter() - t_host) * 1e3 / WD_TIMED  # queueing only
        end.synchronize()
        step_ms = start.elapsed_time(end) / WD_TIMED
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = [x.item() for x in losses]
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            raise AssertionError(f"wide-and-deep {name}: losses not finite or not "
                                 f"falling on a repeated batch: {losses}")
        census = wide_deep_census(lambda: step(state, batch))
        host = wide_deep_host_split(model, optimizer, wide_deep.make_loss_fn(model), batch)
        model.eval()
        fwd_ms, fwd_host_ms = time_ms(
            lambda: dp.make_eval_step(model)(batch["features"]), reps=20)
        model.train()
        rec = {"step_ms": step_ms, "host_ms": host_ms,
               "rows_per_s": WD_BATCH / step_ms * 1e3,
               "score_ms": fwd_ms, "score_host_ms": fwd_host_ms,
               "score_rows_per_s": WD_BATCH / fwd_ms * 1e3, "peak_gb": peak_gb,
               "bound_ms": bound_ms, "bound_share": bound_ms / step_ms,
               "census_ms": census["ms"], "census_device_ms": census["device_ms"],
               "host_split_ms": host, "first_loss": losses[0], "last_loss": losses[-1]}
        out[name] = rec
        log(f"[wide_deep-{name}] vocab {WD_CONFIG['vocab_size']} x 26, embed "
            f"{WD_CONFIG['embed_dim']}, hidden {WD_CONFIG['hidden']}, batch {WD_BATCH}, "
            f"Adagrad lr {WD_LR}: losses {losses[0]:.4f} -> {losses[-1]:.4f}")
        log(f"[wide_deep-{name}] step {step_ms:.4f} ms on the card (CUDA events over "
            f"{WD_TIMED} steps; the host queues a step in {host_ms:.4f} ms), "
            f"{rec['rows_per_s']:.0f} rows/s; forward-only scoring {fwd_ms:.4f} ms, "
            f"{rec['score_rows_per_s']:.0f} rows/s (host {fwd_host_ms:.4f} ms); peak "
            f"memory {peak_gb:.3f} GB ({smi})")
        log(f"[wide_deep-{name}] bytes bound: 6 passes over the {table / 1e6:.1f} MB "
            f"of f32 tables (gradient write; Adagrad reads parameter, gradient, "
            f"accumulator, writes two) = {6 * table / 1e9:.3f} GB at "
            f"{PEAK_BYTES / 1e12:.2f} TB/s: {bound_ms:.4f} ms, {rec['bound_share']:.3f} "
            f"of the step ({smi})")
        log(f"[wide_deep-{name}] census of one step (torch.profiler, device ms by "
            f"the ops that launched each kernel): "
            + ", ".join(f"{k} {v:.4f}" for k, v in census["ms"].items())
            + f"; total {census['device_ms']:.4f} ms ({smi})")
        log(f"[wide_deep-{name}] host split of a step (host clock, median of "
            f"{SPLIT_STEPS}; each part's queueing, then the wait for the card): "
            + ", ".join(f"{k} {v:.4f}" for k, v in host.items()) + f" ms ({smi})")
        del model, optimizer, state, step
        torch.cuda.empty_cache()
    return out


def phase_wide_deep_card_vs_cpu(seed: int, smi: str) -> dict:
    """One Adagrad step of ``WD_CHECK_CONFIG`` from the same weights on the
    card and on the CPU: loss, gradients and updated parameters, each to
    ``WD_CHECK_TOL`` relative L2, with TF32 off for matmuls
    (``phase_device``)."""
    import torch

    from tensorflowonspark_torch.models import wide_deep
    from tensorflowonspark_torch.optim import Adagrad
    from tensorflowonspark_torch.parallel import dp

    weights = wide_deep.build_wide_deep(WD_CHECK_CONFIG).init_weights(
        torch.Generator().manual_seed(seed)).state_dict()
    batch = wide_deep.batch_to_arrays(wide_deep.synthetic_criteo(64, seed=seed + 1))

    def one_step(device):
        with torch.device(device):
            model = wide_deep.build_wide_deep(WD_CHECK_CONFIG)
        model.load_state_dict(weights)
        opt = Adagrad(model.parameters(), WD_LR)
        grads = {}

        def keep(g):
            grads.update({n: t.detach().cpu().clone() for n, t in g.items()})
            return g

        step = dp.make_train_step(wide_deep.make_loss_fn(model), opt,
                                  cross_host_grad_fn=keep)
        _, m = step(dp.TrainState.create(model, opt), batch)
        return m["loss"].item(), grads, {k: v.cpu() for k, v in model.state_dict().items()}

    cpu, card = one_step("cpu"), one_step("cuda")
    loss_err = abs(card[0] - cpu[0]) / abs(cpu[0])
    grad_err = {n: rel_l2(card[1][n], g) for n, g in cpu[1].items()}
    param_err = {n: rel_l2(card[2][n], p) for n, p in cpu[2].items()}
    worst = max(loss_err, *grad_err.values(), *param_err.values())
    log(f"[wide_deep card-vs-cpu] one Adagrad step of vocab 1009, embed 4, hidden "
        f"(8, 4), f32, TF32 for matmuls {torch.backends.cuda.matmul.allow_tf32}: loss "
        f"{loss_err:.2e}, worst gradient {max(grad_err.values()):.2e}, worst updated "
        f"parameter {max(param_err.values()):.2e} (relative L2; tolerance "
        f"{WD_CHECK_TOL}) ({smi})")
    if worst > WD_CHECK_TOL:
        raise AssertionError(f"wide-and-deep on the card disagrees with the CPU: "
                             f"{loss_err}, {grad_err}, {param_err}")
    return {"loss_rel_err": loss_err, "grad_rel_err": max(grad_err.values()),
            "param_rel_err": max(param_err.values())}


def import_test_mapfuns():
    """``tests/torch_mapfuns.py``, the map_funs of the collective and
    sharded phases, imported by its file's directory: node processes take
    this process's ``sys.path``, and a package named ``tests`` elsewhere on
    the path must not shadow it."""
    tests_dir = os.path.join(ROOT, "tests")
    if tests_dir not in sys.path:
        sys.path.insert(0, tests_dir)
    import torch_mapfuns

    return torch_mapfuns


def log_node_tails(log_dir: str, tag: str, lines: int = 40) -> None:
    """Print the last ``lines`` lines of each node log in ``log_dir``."""
    for path in sorted(glob.glob(os.path.join(log_dir, "node_*.log"))):
        with open(path, errors="replace") as f:
            tail = f.read().splitlines()[-lines:]
        log(f"{tag}: {os.path.basename(path)}, last {len(tail)} lines:\n" + "\n".join(tail))


def ingest_window(result: dict, first: int, last: int, batch: int) -> dict:
    """Step ms, images/s and the host wait per step over steps
    ``first..last-1`` of an ingest-fed run (``ingest_resnet_trainer``'s
    record): the span between the ends of steps ``first - 1`` and
    ``last - 1`` on the device's clock, waits on the host's."""
    ends = result["end_ms"]
    ms = (ends[last - 1] - ends[first - 1]) / (last - first)
    return {"steps": last - first, "step_ms": ms, "images_per_s": batch / ms * 1e3,
            "host_wait_ms": statistics.mean(result["wait_ms"][first:last])}


def ingest_replay(result: dict, seed: int, device: str, torch_mapfuns) -> list:
    """The run's first ``INGEST_REPLAY`` batches, regenerated from their
    ids, through the port's resident BN step from the same init seed;
    returns each step's loss there."""
    import numpy as np
    import torch

    from tensorflowonspark_torch.models import resnet
    from tensorflowonspark_torch.parallel import dp

    model = torch_mapfuns.build_image_model(RESNET_CONFIG, seed, device)
    optimizer = torch.optim.SGD(model.parameters(), lr=RESNET_LR, momentum=0.9,
                                nesterov=True)
    step = dp.make_bn_train_step(resnet.make_loss_fn(model, weight_decay=RESNET_WD),
                                 optimizer)
    state = dp.BNTrainState.create(model, optimizer)
    losses = []
    for ids in result["ids"][:INGEST_REPLAY]:
        pixels = np.stack([torch_mapfuns.synthetic_image(seed, i, RESNET_SIZE) for i in ids])
        images = torch_mapfuns.normalize_images(torch.from_numpy(pixels).to(device))
        labels = torch.as_tensor(ids, device=device) % RESNET_CONFIG["num_classes"]
        state, m = step(state, {"image": images, "label": labels})
        losses.append(m["loss"].item())
    del model, optimizer, state
    return losses


def phase_ingest_resnet50(seed: int, smi: str, resident_images_s: float | None,
                          device: str = "cuda") -> dict:
    """BASELINE config 3 at ``phase_resnet50``'s width (ResNet-50, 224 px,
    batch 256, bf16 over f32 masters, SGD Nesterov, ``make_bn_train_step``)
    fed from TFRecord shards through the port's DIRECT ingest tier instead
    of one resident batch (``tests/torch_mapfuns.py:ingest_resnet_trainer``
    on one node process): ``INGEST_IMAGES`` synthetic Examples (``image``
    uint8 bytes, ``label``, ``id``; each image a function of ``(seed, id)``)
    written under ``WORK_DIR``; run A reads them with node-local readers
    (``train(shard_dir, num_epochs=1)``, its timed steps inside
    ``profiling.trace``; once more without the trace), run B through one
    data-service worker (``ingest_workers=1``, two epochs, the second from
    ``ChunkCache``).

    Gates, each raised: every id exactly once per epoch; the first
    ``INGEST_REPLAY`` steps of each run replayed here through the resident
    BN step from the same init, each loss within ``LOSS_REL_TOL``; no
    attention launch; the ingest worker never initialised CUDA (its
    ``update_meta``: no card visible, torch's CUDA state untouched); epoch
    2 served from the worker's cache.
    ``device="cpu"`` rehearses it with shrunken constants."""
    import tensorflowonspark_torch as tos
    from tensorflowonspark_torch.feeding import FeedQueues
    from tensorflowonspark_torch.ingest import IngestFeed
    from tensorflowonspark_torch.marker import EndOfFeed, EndPartition
    from tensorflowonspark_torch.ops import attention as att

    torch_mapfuns = import_test_mapfuns()
    cuda = device == "cuda"
    per_epoch = INGEST_IMAGES // RESNET_BATCH
    if per_epoch * RESNET_BATCH != INGEST_IMAGES or per_epoch <= INGEST_WARMUP:
        raise ValueError("INGEST_IMAGES must be whole batches, more than the warm-up")
    shard_dir = os.path.join(WORK_DIR, "ingest_shards")
    t0 = time.perf_counter()
    shards = torch_mapfuns.write_image_shards(
        shard_dir, INGEST_IMAGES, INGEST_PER_SHARD, RESNET_SIZE, seed,
        RESNET_CONFIG["num_classes"])
    pixel_mb = INGEST_IMAGES * RESNET_SIZE * RESNET_SIZE * 3 / 1e6
    disk_mb = sum(os.path.getsize(p) for p in shards) / 1e6
    log(f"[ingest] {INGEST_IMAGES} Examples ({RESNET_SIZE} px uint8 image, label, id) in "
        f"{len(shards)} shards, {disk_mb:.1f} MB on disk ({pixel_mb:.1f} MB of pixels), "
        f"written in {time.perf_counter() - t0:.1f} s")

    # what node-side decode alone delivers on this host: the columnar
    # readers and the batch assembly over the shards twice, no training
    # behind them; the pool fixed at its autotune ceiling
    # (TOS_INGEST_READERS), timed from the first batch (the feed's start-up
    # and the autotuner's ramp are not decode)
    queues = FeedQueues(("input",))
    for i, path in enumerate(shards * 2):
        queues.get_queue("input").put(path)
        queues.get_queue("input").put(EndPartition(key=(0, i)))
    queues.get_queue("input").put(EndOfFeed())
    feed = IngestFeed(queues, schema=torch_mapfuns.image_schema(),
                      binary_features={"image"}, autotune=False)
    sizes, t0 = [], time.perf_counter()
    for batch in torch_mapfuns.image_batches(feed, RESNET_BATCH, RESNET_SIZE):
        if not sizes:
            t0 = time.perf_counter()
        sizes.append(len(batch["id"]))
    decode_s = time.perf_counter() - t0
    if sum(sizes) != 2 * INGEST_IMAGES:
        raise AssertionError(f"the decode pass delivered {sum(sizes)} images")
    images_s = sum(sizes[1:]) / decode_s
    decode = {"images_per_s": images_s,
              "mb_per_s": images_s * RESNET_SIZE * RESNET_SIZE * 3 / 1e6,
              "readers": feed.pipeline._max_readers}
    log(f"[ingest] node-side decode alone ({decode['readers']} readers, autotune off, "
        f"+ batch assembly; host clock from the first batch, 2 passes): "
        f"{decode['images_per_s']:.1f} images/s, {decode['mb_per_s']:.1f} MB/s of "
        f"pixels ({smi})")

    args = {"device": device, "config": RESNET_CONFIG, "seed": seed, "size": RESNET_SIZE,
            "batch_size": RESNET_BATCH, "lr": RESNET_LR, "weight_decay": RESNET_WD,
            "warmup": INGEST_WARMUP}
    driver_launches = sum(att.LAUNCHES.values())
    runs = {}
    # run A twice: under the trace (the idle share), and without it
    for tag, epochs, workers, traced in (("A", 1, 0, True), ("A untraced", 1, 0, False),
                                         ("B", 2, 1, False)):
        out_dir = os.path.join(WORK_DIR, f"ingest_{tag.replace(' ', '_')}")
        os.makedirs(out_dir, exist_ok=True)
        run_args = {**args, "out_dir": out_dir}
        if traced and cuda:
            run_args["trace_dir"] = os.path.join(out_dir, "trace")
        extra = {}
        if workers:
            extra = {"ingest_workers": workers, "ingest_opts": {
                "schema": torch_mapfuns.image_schema(), "binary_features": {"image"},
                "cache_bytes": INGEST_CACHE_BYTES}}
        t0 = time.perf_counter()
        cluster = tos.run(torch_mapfuns.ingest_resnet_trainer, run_args,
                          num_executors=1, input_mode=tos.InputMode.DIRECT,
                          log_dir=os.path.join(out_dir, "logs"),
                          reservation_timeout=300, **extra)
        try:
            try:
                cluster.train(shard_dir, num_epochs=epochs)
            finally:
                cluster.shutdown(timeout=300)
        except Exception:
            # the nodes' own account of a failed run (WORK_DIR goes at exit)
            log_node_tails(os.path.join(out_dir, "logs"), f"[ingest] run {tag}")
            raise
        wall_s = time.perf_counter() - t0
        result = json.load(open(os.path.join(out_dir, "ingest_result_0.json")))
        seen = collections.Counter(i for b in result["ids"] for i in b)
        if seen != collections.Counter({i: epochs for i in range(INGEST_IMAGES)}):
            raise AssertionError(f"run {tag}: ids not each seen exactly once per epoch "
                                 f"({sum(seen.values())} seen, {len(seen)} distinct)")
        if len(result["ids"]) != epochs * per_epoch:
            raise AssertionError(f"run {tag}: {len(result['ids'])} steps")
        rec = {"wall_s": wall_s, "losses": result["losses"],
               "epoch1": ingest_window(result, INGEST_WARMUP, per_epoch, RESNET_BATCH)}
        if epochs > 1:
            rec["epoch2"] = ingest_window(result, per_epoch + INGEST_WARMUP,
                                          2 * per_epoch, RESNET_BATCH)
        if "trace" in result:
            rec["trace"] = result["trace"]
        # the node processes' own counters (the driver's hold every phase's)
        counters = collections.Counter()
        for name, node in cluster.metrics()["nodes"].items():
            if name != "driver":
                counters.update(node.get("counters") or {})
        if counters["attn.flash_fwd_launches"]:
            raise AssertionError(f"run {tag} launched an attention kernel: {counters}")
        if workers:
            worker = [m for m in cluster.coordinator.cluster_info()
                      if m["job_name"] == "ingest"]
            if not worker or worker[0].get("cuda_initialized") is not False:
                raise AssertionError(f"the ingest worker reported {worker}")
            rec["cache_hits"] = counters["ingest.cache_hits"]
            rec["worker_device"] = worker[0].get("device")
            rec["worker_cuda_visible_devices"] = worker[0].get("cuda_visible_devices")
            if rec["cache_hits"] < 1:
                raise AssertionError(f"epoch 2 was not served from the cache: {counters}")
        replay = ingest_replay(result, seed, device, torch_mapfuns)
        rec["replay_losses"] = replay
        for i, (got, want) in enumerate(zip(result["losses"], replay)):
            if abs(got - want) > LOSS_REL_TOL * abs(want):
                raise AssertionError(f"run {tag} step {i}: loss {got:.5f} fed from the "
                                     f"shards, {want:.5f} replayed resident")
        runs[tag] = rec
        windows = [(f"run {tag}" + (f" epoch {e}" if epochs > 1 else ""), rec[f"epoch{e}"])
                   for e in range(1, epochs + 1)]
        for name, w in windows:
            log(f"[ingest] {name}: {w['images_per_s']:.1f} images/s, step "
                f"{w['step_ms']:.2f} ms over {w['steps']} timed steps ("
                f"{'CUDA events' if cuda else 'host clock'} at each step's end), host waited {w['host_wait_ms']:.2f} ms a step for "
                f"next_batch + device_prefetch ({smi})")
        log(f"[ingest] run {tag}: losses " + ", ".join(f"{x:.4f}" for x in result["losses"])
            + "; replayed resident " + ", ".join(f"{x:.4f}" for x in replay)
            + f"; wall {wall_s:.1f} s with the cluster's start")
    trace = runs["A"].get("trace")
    if trace:
        log(f"[ingest] run A's timed steps under profiling.trace: the card busy "
            f"{trace['busy_ms']:.2f} of {trace['window_ms']:.2f} ms ({trace['kernels']} "
            f"kernels), idle share {trace['idle_share']:.4f} ({smi})")
    b = runs["B"]
    log(f"[ingest] run B's worker: cuda_initialized False, CUDA_VISIBLE_DEVICES="
        f"{b['worker_cuda_visible_devices']!r}, device {b['worker_device']}; epoch 2 "
        f"cache hits {b['cache_hits']}")
    if resident_images_s is not None:
        log(f"[ingest] beside phase_resnet50's resident batch, {resident_images_s:.1f} "
            f"images/s ({resident_images_s * RESNET_SIZE ** 2 * 3 / 1e6:.1f} "
            f"MB/s of pixels): run A {runs['A']['epoch1']['images_per_s']:.1f} (untraced "
            f"{runs['A untraced']['epoch1']['images_per_s']:.1f}), run B "
            f"{b['epoch1']['images_per_s']:.1f} / {b['epoch2']['images_per_s']:.1f} "
            f"(epoch 1 / 2), decode alone {decode['images_per_s']:.1f} ({smi})")
    if sum(att.LAUNCHES.values()) != driver_launches:
        raise AssertionError(f"the ingest replay launched an attention kernel: {att.LAUNCHES}")
    shutil.rmtree(shard_dir, ignore_errors=True)
    return {"decode": decode, "runs": runs, "resident_images_per_s": resident_images_s}


EXPORT_CONSUMER = """
import json, sys
import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
work = sys.argv[1]
program = torch.export.load(work + "/model.pt2").module()
out = {}
with torch.no_grad():
    for b in json.loads(sys.argv[2]):
        x = torch.from_numpy(np.load(f"{work}/x{b}.npy")).to(sys.argv[3])
        out[f"y{b}"] = program(x).float().cpu().numpy()
np.savez(work + "/consumer.npz", **out)
ours = sorted(m for m in sys.modules if m.startswith("tensorflowonspark"))
print(json.dumps({"loaded": ours}))
"""


# the LM programs' consumer: imports torch, numpy and each program's
# op_module only; per program the graph's op nodes, each forward's
# launches (op_module's LAUNCHES), and the logits saved as f32
EXPORT_LM_CONSUMER = """
import importlib, json, sys, time
import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
work, report = sys.argv[1], {}
for tag, batches in json.loads(sys.argv[2]):
    t0 = time.perf_counter()
    path = f"{work}/{tag}"
    with open(path + "/program.json") as f:
        meta = json.load(f)
    att = importlib.import_module(meta["op_module"])
    exported = torch.export.load(path + "/model.pt2")
    nodes = sum(n.target is torch.ops.tos.flash_attn_fwd.default
                for n in exported.graph.nodes)
    program = exported.module()
    load_s = time.perf_counter() - t0
    launches = []
    for b in batches:
        ids = torch.from_numpy(np.load(f"{path}/ids{b}.npy")).to(meta["device"])
        before = dict(att.LAUNCHES)
        with torch.no_grad():
            y = program(ids)
        if meta["device"] == "cuda":
            torch.cuda.synchronize()
        launches.append({n: c - before[n] for n, c in att.LAUNCHES.items()})
        np.save(f"{path}/y{b}.npy", y.float().cpu().numpy())
    report[tag] = {"nodes": nodes, "launches": launches, "load_s": load_s}
    del program, exported
report["loaded"] = sorted(m for m in sys.modules
                         if m.startswith(("tensorflowonspark", "jax")))
print(json.dumps(report))
"""


def export_lm_programs() -> list:
    """``(tag, config, batch_polymorphic, batches)`` of the LM programs, from
    the current ``LM_CONFIG`` and ``MOE_CONFIG`` (a CPU rehearsal shrinks
    them)."""
    return [("lm_bf16", LM_CONFIG, True, EXPORT_LM_BATCHES),
            ("lm_f32", {**LM_CONFIG, "bf16": False, "n_layers": EXPORT_F32_LAYERS},
             True, (1,)),
            ("moe_bf16", {**MOE_CONFIG, "n_layers": EXPORT_MOE_LAYERS}, False,
             (EXPORT_MOE_BATCH,))]


def op_host_cost(seed: int) -> dict:
    """The op's host cost per call at the serving shape (``MAX_BATCH`` x
    ``SEQ_LEN``, the LM's heads, bf16, causal): the median µs of queueing
    one call through ``torch.ops.tos.flash_attn_fwd`` and one through
    ``flash_attn_fwd_cuda`` (the undispatched implementation), in turns
    (the order swapped each call), every launch queued behind a spin
    kernel so the host never waits for the card (host clock)."""
    import torch

    from tensorflowonspark_torch.ops import attention as att

    h = LM_CONFIG["n_heads"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((MAX_BATCH, SEQ_LEN, h, LM_CONFIG["d_model"] // h),
                           generator=g, device="cuda").bfloat16() for _ in range(3))
    calls = {"op": lambda: torch.ops.tos.flash_attn_fwd(q, k, v, True, None, 0),
             "direct": lambda: att.flash_attn_fwd_cuda(q, k, v, causal=True)}
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calls["direct"]()
    spin = int(4e3 * (time.perf_counter() - t0) * OP_HOST_CALLS * _spin_cycles_per_ms())
    times: dict = {name: [] for name in calls}
    torch.cuda._sleep(spin + 1_000_000)
    for i in range(OP_HOST_CALLS):
        for name in sorted(calls, reverse=bool(i % 2)):
            t0 = time.perf_counter()
            calls[name]()
            times[name].append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return {f"{name}_us": 1e6 * statistics.median(t) for name, t in times.items()}


def export_lm_sub_step(seed: int, smi: str, device: str = "cuda") -> dict:
    """The LM programs (``export_lm_programs``) through
    ``checkpoint.export_program`` on ``device``: each ``program.json``
    names ``tos::flash_attn_fwd`` with the route ``_route`` gives at its
    type and head dim; one fresh process (``EXPORT_LM_CONSUMER``) loads
    and scores all three; gates: n_layers op nodes a graph, n_layers
    launches a forward on that route (0 on the CPU), logits against
    ``build_apply``'s here (f32 ``EXPORT_LOGIT_TOL``, bf16
    ``EXPORT_BF16_LOGIT_TOL``, the MoE's rows out of that within
    ``MOE_BF16_REROUTE_MAX``).  On the card also the op's host cost per
    call (``op_host_cost``)."""
    import subprocess

    import numpy as np
    import torch

    from tensorflowonspark_torch.checkpoint import export_program
    from tensorflowonspark_torch.models.registry import build_apply
    from tensorflowonspark_torch.ops import attention as att

    work = os.path.join(WORK_DIR, "lm_programs")
    rng = np.random.RandomState(seed)
    programs, want, out = export_lm_programs(), {}, {}
    for tag, config, dynamic, batches in programs:
        path = os.path.join(work, tag)
        params = make_lm_params(config, seed)
        shape = (SEQ_LEN,) if dynamic else (batches[0], SEQ_LEN)
        t0 = time.perf_counter()
        export_program(path, params, config, shape, input_dtype=np.int32, device=device,
                       batch_polymorphic=dynamic)
        export_s = time.perf_counter() - t0
        with open(os.path.join(path, "program.json")) as f:
            meta = json.load(f)
        h = config["n_heads"]
        kernel, padded = att._route(torch.bfloat16 if config["bf16"] else torch.float32,
                                    config["d_model"] // h)
        routes = [{"kernel": kernel, "padded_head_dim": padded,
                   "nodes": config["n_layers"]}]
        if (meta["ops"], meta["op_routes"]) != (["tos::flash_attn_fwd"],
                                                {"tos::flash_attn_fwd": routes}):
            raise AssertionError(f"{tag}'s program.json: {meta}")
        apply = build_apply(config, device)
        want[tag] = {}
        for b in batches:
            ids = rng.randint(0, config["vocab_size"], (b, SEQ_LEN)).astype(np.int32)
            np.save(os.path.join(path, f"ids{b}.npy"), ids)
            want[tag][b] = apply(params, ids).float().cpu()
        del apply, params
        out[tag] = {"export_s": export_s, "kernel": kernel, "layers": config["n_layers"],
                    "batch_polymorphic": dynamic,
                    "program_mb": os.path.getsize(os.path.join(path, "model.pt2")) / 1e6}
        if device == "cuda":
            torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", EXPORT_LM_CONSUMER, work,
         json.dumps([(tag, batches) for tag, _, _, batches in programs])],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    consumer_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the LM programs' consumer failed:\n{proc.stderr[-3000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    loaded = report.pop("loaded")
    for tag, config, _, batches in programs:
        rec, got = out[tag], report[tag]
        layers = config["n_layers"]
        per_forward = {n: layers * (n == rec["kernel"]) * (device == "cuda")
                       for n in att.LAUNCHES}
        if got["nodes"] != layers or any(x != per_forward for x in got["launches"]):
            raise AssertionError(f"{tag}: {got['nodes']} op nodes, launches "
                                 f"{got['launches']} (want {layers} and {per_forward})")
        errs, rerouted = [], []
        for b in batches:
            y = torch.from_numpy(np.load(os.path.join(work, tag, f"y{b}.npy")))
            ref = want[tag][b]
            rows = (y - ref).abs().amax(-1) / ref.abs().max()
            errs.append(float(rows.max()))
            rerouted.append(float((rows > EXPORT_BF16_LOGIT_TOL).float().mean()))
        rec.update(nodes=got["nodes"], launches=got["launches"], load_s=got["load_s"],
                   max_rel_err=max(errs), rerouted_share=max(rerouted))
        batch = "dynamic batch" if rec["batch_polymorphic"] else f"batch fixed at {batches[0]}"
        log(f"[export] {tag} ({layers} layers, {batch}, {SEQ_LEN} tokens) on {device}: "
            f"export_program {rec['export_s']:.2f} s, "
            f"model.pt2 {rec['program_mb']:.1f} MB, {got['nodes']} tos.flash_attn_fwd "
            f"nodes, route {rec['kernel']}; the consumer loaded it in {got['load_s']:.2f} s "
            f"and launched {got['launches']} at batches {list(batches)}; max error "
            + ", ".join(f"{e:.3g}" for e in errs) + " of the largest logit, rows out of "
            f"{EXPORT_BF16_LOGIT_TOL}: share " + ", ".join(f"{r:.4f}" for r in rerouted)
            + f" (host clock; {smi})")
        if tag.startswith("moe"):
            if max(rerouted) > MOE_BF16_REROUTE_MAX:
                raise AssertionError(f"{tag}: {max(rerouted)} of its rows re-routed")
        elif max(errs) > (EXPORT_BF16_LOGIT_TOL if config["bf16"] else EXPORT_LOGIT_TOL):
            raise AssertionError(f"{tag}: the program disagrees with build_apply: {errs}")
    log(f"[export] the LM programs' consumer (torch, numpy and the op's module; "
        f"{len(loaded)} package modules loaded) took {consumer_s:.2f} s (host clock; {smi})")
    bad = [m for m in loaded if not m.startswith("tensorflowonspark_torch")]
    if bad:
        raise AssertionError(f"the LM programs' consumer loaded {bad}")
    summary = {"programs": out, "consumer_s": consumer_s, "modules_loaded": len(loaded)}
    if device == "cuda":
        summary["op_host"] = op_host_cost(seed)
        log(f"[export] the op's host cost per call at {MAX_BATCH} x {SEQ_LEN} bf16: "
            f"{summary['op_host']['op_us']:.1f} µs through torch.ops.tos.flash_attn_fwd, "
            f"{summary['op_host']['direct_us']:.1f} µs through flash_attn_fwd_cuda "
            f"(median of {OP_HOST_CALLS} calls each, queued behind a spin; host clock; "
            f"{smi})")
    shutil.rmtree(work, ignore_errors=True)
    return summary


def pod_chip_plan(cluster, timeout: float = 120.0):
    """``cluster.chip_plan()`` once every node has reported its device facts
    (a distributed node reports after its process group forms, which may
    come after ``train()`` has handed over the last partition)."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            return cluster.chip_plan()
        except RuntimeError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)


def phase_pod(seed: int, smi: str, device: str = "cuda") -> dict:
    """``examples_torch/mnist/mnist_pod.py`` as a 1-rank pod:
    ``GPUPodLauncher(hosts=["localhost"], transport="local",
    gpu_slices=[[0]])`` drives ``mnist_pod.main_fun`` at the example's
    widths (features (32, 64), dense 256, 64 rows a step) over
    ``POD_SAMPLES`` synthetic samples in ``POD_PARTITIONS`` STREAMING
    partitions, one epoch.  Gates: the node saw ``CUDA_VISIBLE_DEVICES``
    "0", its process group is NCCL of world size 1, its registered device
    facts are the card's (``gpu``, 1 device, the ``nvidia-smi`` name),
    ``chip_plan()`` is one ``HostAssignment`` with cards ``(0,)``, every
    sample was fed once, the last loss is below the first, the rank's own
    attention-kernel counts stay 0, and the
    collective checkpoint restores to the final weights' logits on a fixed
    batch (``POD_RESTORE_RTOL``).  Prints the job's seconds and steps/s.
    Then the export sub-step (``export_sub_step``).  ``device="cpu"``
    rehearses it on the CPU (a gloo rank, no card)."""
    import numpy as np
    import torch

    import tensorflowonspark_torch as tos
    from examples_torch.mnist import mnist_pod
    from tensorflowonspark_torch.checkpoint import latest_step_dir, load_bundle, restore_checkpoint
    from tensorflowonspark_torch.launcher import GPUPodLauncher
    from tensorflowonspark_torch.models import mnist
    from tensorflowonspark_torch.models.registry import build_apply

    cpu = device == "cpu"
    args = {"batch_size": 64, "seed": seed, "device": device,
            "model_dir": os.path.join(WORK_DIR, "pod_model"),
            "export_dir": os.path.join(WORK_DIR, "pod_export")}
    pod = GPUPodLauncher(hosts=["localhost"], transport="local",
                         gpu_slices=None if cpu else [[0]],
                         platform="cpu" if cpu else "gpu")
    t0 = time.perf_counter()
    cluster = tos.run(mnist_pod.main_fun, args, num_executors=1,
                      input_mode=tos.InputMode.STREAMING, launcher=pod,
                      log_dir=os.path.join(WORK_DIR, "pod_logs"), reservation_timeout=300)
    try:
        t_train = time.perf_counter()
        cluster.train(tos.PartitionedDataset.from_iterable(
            mnist.synthetic_mnist(POD_SAMPLES), POD_PARTITIONS), num_epochs=1)
        feed_s = time.perf_counter() - t_train
        plan = pod_chip_plan(cluster)
    finally:
        cluster.shutdown(timeout=300)
    job_s = time.perf_counter() - t0
    (meta,) = cluster.coordinator.cluster_info()
    report, facts = meta["mnist_pod"], meta["device"]
    steps_s = report["steps"] / report["train_s"]
    log(f"[pod] mnist_pod, 1 rank ({report['backend']}, world {report['world']}, "
        f"CUDA_VISIBLE_DEVICES={report['cuda_visible_devices']!r}, {report['device']}): "
        f"{report['rows']} rows in {report['steps']} steps; losses "
        + ", ".join(f"{x:.4f}" for x in report["losses"][::10] + report["losses"][-1:])
        + f"; chip_plan {plan}; registered device {facts['platform']} x"
        f"{facts['num_devices']} {facts['device_kind']!r}")
    log(f"[pod] job {job_s:.2f} s from launch to shutdown (train() handed over the "
        f"partitions in {feed_s:.2f} s); the rank's step loop {report['train_s']:.2f} s, "
        f"{steps_s:.2f} steps/s, first step included (host clock; {smi})")
    want_facts = (("cpu", 0, "cpu", []) if cpu else
                  ("gpu", 1, torch.cuda.get_device_name(0), [smi]))
    if report["cuda_visible_devices"] != ("" if cpu else "0"):
        raise AssertionError(f"the pod's rank saw CUDA_VISIBLE_DEVICES="
                             f"{report['cuda_visible_devices']!r}")
    if (report["backend"], report["world"]) != ("gloo" if cpu else "nccl", 1):
        raise AssertionError(f"the pod formed {report['backend']} of world {report['world']}")
    if (facts["platform"], facts["num_devices"], facts["device_kind"],
            facts["nvidia_smi"]) != want_facts:
        raise AssertionError(f"the pod's registered device facts: {facts}")
    if [(a.executor_id, a.chip_ids) for a in plan] != [(0, () if cpu else (0,))]:
        raise AssertionError(f"chip_plan: {plan}")
    if report["rows"] != POD_SAMPLES:
        raise AssertionError(f"the pod trained on {report['rows']} of {POD_SAMPLES} samples")
    if not report["losses"][-1] < report["losses"][0]:
        raise AssertionError(f"the pod's loss did not fall: {report['losses']}")
    if any(report["attention_launches"].values()):
        raise AssertionError(f"the pod's rank launched an attention kernel: "
                             f"{report['attention_launches']}")

    path = latest_step_dir(args["model_dir"])
    if not path.endswith(f"step_{report['steps']}"):
        raise AssertionError(f"the newest checkpoint is {path}, not step {report['steps']}")
    variables, config = load_bundle(args["export_dir"])
    final = build_apply(config, device)
    restored = build_apply(config, device)
    restored.model.load_state_dict(restore_checkpoint(path)["model"])
    probe = mnist.batch_to_arrays(mnist.synthetic_mnist(POD_PROBE, seed=seed + 7))["image"]
    want = final(variables, probe).cpu().numpy()
    with torch.inference_mode():
        got = restored.model(torch.as_tensor(probe, device=device)).cpu().numpy()
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    log(f"[pod] the collective checkpoint's logits on {POD_PROBE} fixed images against "
        f"the final weights': max error {rel:.3g} of the largest (gate {POD_RESTORE_RTOL})")
    if not rel <= POD_RESTORE_RTOL:
        raise AssertionError(f"the restored checkpoint's logits differ by {rel}")
    out = {"job_s": job_s, "loop_s": report["train_s"], "steps": report["steps"],
           "steps_per_s": steps_s, "first_loss": report["losses"][0],
           "last_loss": report["losses"][-1], "restore_rel_err": rel}
    out["export"] = export_sub_step(seed, smi, device)
    return out


def export_sub_step(seed: int, smi: str, device: str = "cuda") -> dict:
    """ResNet-50 (``RESNET_CONFIG`` in f32, eval mode) through
    ``checkpoint.export_program`` with a dynamic batch on ``device``,
    loaded in a fresh process that imports only torch and numpy (it reports
    the ``tensorflowonspark*`` modules it holds: none); its logits at
    ``EXPORT_BATCHES`` against ``build_apply``'s forward here, within
    ``EXPORT_LOGIT_TOL`` of the largest logit, and no attention launch.
    Then the LM programs (``export_lm_sub_step``)."""
    import subprocess

    import numpy as np
    import torch

    from tensorflowonspark_torch.checkpoint import export_program
    from tensorflowonspark_torch.convert import torch_to_flax
    from tensorflowonspark_torch.models import resnet
    from tensorflowonspark_torch.models.registry import build_apply
    from tensorflowonspark_torch.ops import attention as att

    config = {**RESNET_CONFIG, "bf16": False}
    model = resnet.build_resnet50(config)
    model.init_weights(torch.Generator().manual_seed(seed))
    params = torch_to_flax(model.state_dict(), config=config)
    del model
    work = os.path.join(WORK_DIR, "program")
    t0 = time.perf_counter()
    export_program(work, params, config, (RESNET_SIZE, RESNET_SIZE, 3), device=device)
    export_s = time.perf_counter() - t0
    apply = build_apply(config, device)
    rng = np.random.RandomState(seed)
    want = {}
    for b in EXPORT_BATCHES:
        x = rng.rand(b, RESNET_SIZE, RESNET_SIZE, 3).astype(np.float32)
        np.save(os.path.join(work, f"x{b}.npy"), x)
        want[b] = apply(params, x).cpu().numpy()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", EXPORT_CONSUMER, work, json.dumps(list(EXPORT_BATCHES)), device],
        capture_output=True, text=True, timeout=300, cwd=work)
    consumer_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the program's consumer failed:\n{proc.stderr[-3000:]}")
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])["loaded"]
    got = np.load(os.path.join(work, "consumer.npz"))
    errs = {b: float(np.abs(got[f"y{b}"] - want[b]).max() / np.abs(want[b]).max())
            for b in EXPORT_BATCHES}
    size_mb = os.path.getsize(os.path.join(work, "model.pt2")) / 1e6
    log(f"[export] ResNet-50 f32 eval, {RESNET_SIZE} px, dynamic batch on {device}: "
        f"export_program {export_s:.2f} s, model.pt2 {size_mb:.1f} MB; a fresh process "
        f"(torch and numpy only; package modules loaded: {loaded}) took {consumer_s:.2f} s; "
        + ", ".join(f"batch {b} max error {e:.3g} of the largest logit" for b, e in errs.items())
        + f" (gate {EXPORT_LOGIT_TOL}) (host clock; {smi})")
    if loaded:
        raise AssertionError(f"the program's consumer loaded {loaded}")
    if not all(e <= EXPORT_LOGIT_TOL for e in errs.values()):
        raise AssertionError(f"the exported program disagrees with build_apply: {errs}")
    if any(att.LAUNCHES.values()):
        raise AssertionError(f"the pod phase or the ResNet program launched an "
                             f"attention kernel: {att.LAUNCHES}")
    out = {"export_s": export_s, "consumer_s": consumer_s, "program_mb": size_mb,
           "max_rel_err": max(errs.values())}
    shutil.rmtree(work, ignore_errors=True)
    out["lm"] = export_lm_sub_step(seed, smi, device)
    return out


def phase_wide_deep_sync(seed: int, smi: str, device: str = "cuda") -> dict:
    """``train(mode="sync")`` of the full-width wide-and-deep on 2 node
    processes sharing the card: ``ctx.collective_group().grad_fn()`` is the
    step's ``cross_host_grad_fn`` and the gradients live on the card
    (``tests/torch_mapfuns.py:train_wide_deep_sync``).  Gate: the two
    nodes' final parameter digests are equal; prints ms per
    ``all_reduce_tree`` and the bytes it carried a step (host clock)."""
    import tensorflowonspark_torch as tos
    from tensorflowonspark_torch.models import wide_deep

    torch_mapfuns = import_test_mapfuns()
    config = {**WD_CONFIG, "bf16": False}
    rows = wide_deep.synthetic_criteo(2 * SYNC_STEPS * WD_BATCH, seed=seed)
    t0 = time.perf_counter()
    cluster = tos.run(torch_mapfuns.train_wide_deep_sync,
                      {"model_config": config, "batch_size": WD_BATCH, "lr": WD_LR,
                       "device": device},
                      num_executors=2, input_mode=tos.InputMode.STREAMING,
                      log_dir=os.path.join(WORK_DIR, "sync_logs"),
                      reservation_timeout=300)
    try:
        cluster.train(tos.PartitionedDataset.from_iterable(rows, 4), mode="sync")
    finally:
        cluster.shutdown(timeout=300)
    wall_s = time.perf_counter() - t0
    metas = [m.get("sync_wide_deep") for m in cluster.coordinator.cluster_info()]
    if any(m is None for m in metas):
        raise AssertionError(f"a sync node published nothing: {metas}")
    ms = sorted(1e3 * x for m in metas for x in m["reduce_secs"])
    rec = {"steps": metas[0]["steps"], "reduce_ms_median": statistics.median(ms),
           "reduce_ms_min": ms[0], "reduce_bytes": metas[0]["reduce_bytes"][0],
           "wall_s": wall_s, "grad_device": metas[0]["grad_device"],
           "digests_equal": metas[0]["digest"] == metas[1]["digest"]}
    log(f"[wide_deep-sync] 2 nodes on one {device}, {rec['steps']} lockstep steps of "
        f"{WD_BATCH} rows each, gradients on {rec['grad_device']}: all_reduce_tree "
        f"{rec['reduce_ms_median']:.1f} ms a step (median, min {ms[0]:.1f}; host clock, "
        f"the backward finished first), {rec['reduce_bytes'] / 1e6:.1f} MB of gradients "
        f"a step; final parameter digests equal: {rec['digests_equal']}; "
        f"{wall_s:.1f} s with start-up ({smi})")
    if not rec["digests_equal"] or rec["steps"] != SYNC_STEPS:
        raise AssertionError(f"sync wide-and-deep: {metas}")
    if not all(m["finite"] for m in metas) or not rec["grad_device"].startswith(device):
        raise AssertionError(f"sync wide-and-deep: losses or gradient device {metas}")
    return rec


def phase_criteo_pipeline(seed: int, smi: str, device: str = "cuda") -> dict:
    """Config 4 as ``examples_torch/criteo/criteo_wide_deep.py`` runs it:
    ``TorchEstimator.fit`` over ``CRITEO_ROWS`` synthetic rows, 2 executors,
    STREAMING, ``CRITEO_EPOCHS`` epochs, batch 512, full width, then
    ``TorchModel.transform`` over ``CRITEO_SCORED`` rows.  Gate: exactly
    that many results, in input order, each with a prediction."""
    import numpy as np

    from examples_torch.criteo import criteo_wide_deep
    from tensorflowonspark_torch.models import wide_deep

    ran = criteo_wide_deep.main([
        "--num-executors", "2", "--epochs", str(CRITEO_EPOCHS),
        "--batch-size", str(WD_BATCH), "--rows", str(CRITEO_ROWS),
        "--vocab-size", str(WD_CONFIG["vocab_size"]), "--device", device,
        "--export-dir", os.path.join(WORK_DIR, "criteo_export"),
        "--log-dir", os.path.join(WORK_DIR, "criteo_logs")])
    rows = wide_deep.synthetic_criteo(CRITEO_ROWS, seed=0)[:CRITEO_SCORED]
    out = ran["scored"]
    in_order = len(out) == len(rows) and all(
        np.array_equal(np.asarray(r["features"]), q["features"]) for r, q in zip(out, rows))
    finite = all("prediction" in r and np.isfinite(float(r["prediction"])) for r in out)
    log(f"[criteo-pipeline] TorchEstimator.fit: {CRITEO_ROWS} rows x {CRITEO_EPOCHS} "
        f"epochs on 2 executors ({device}), batch {WD_BATCH}, full width: "
        f"{ran['fit_s']:.1f} s; TorchModel.transform of {CRITEO_SCORED} rows: "
        f"{ran['transform_s']:.1f} s, {len(out)} results, in input order {in_order}, "
        f"finite predictions {finite} (host clock, cluster start-up included; {smi})")
    if not (in_order and finite):
        raise AssertionError("config 4's transform is not exactly counted, ordered "
                             "and finite")
    return {"fit_s": ran["fit_s"], "transform_s": ran["transform_s"],
            "scored": len(out)}


def phase_criteo_sharded(seed: int, smi: str, device: str = "cuda") -> dict:
    """Config 4 sharded, the path of ``tests/test_embedding.py:418`` at full
    width: ``TorchEstimator`` in ``train_mode="sync"`` with the fused table
    (26 x 100_003 rows of [embed 16 | wide weight]) range-sharded over 2
    nodes (host numpy, as in the JAX package), ``SHARDED_STEPS`` steps of
    batch 512, the sharded export, then a fresh 2-replica serve cluster on
    the card answering through the gateway's lookup fan-out.  Gate:
    predictions equal the dense apply over the reassembled table
    (``SHARDED_TOL``) and both nodes sent ids over the sparse wire."""
    import numpy as np

    import tensorflowonspark_torch as tos
    from tensorflowonspark_torch.checkpoint import load_bundle, restore_embedding_shard
    from tensorflowonspark_torch.embedding import ShardPlan
    from tensorflowonspark_torch.embedding.serve import build_sharded_apply
    from tensorflowonspark_torch.models import wide_deep

    torch_mapfuns = import_test_mapfuns()
    config = {**WD_CONFIG, "model": "wide_deep_dense", "bf16": False}
    dim = config["embed_dim"] + 1
    plan = ShardPlan.even("wide_deep", wide_deep.table_total_rows(config), dim, 2)
    export = os.path.join(WORK_DIR, "sharded_export")
    logs = os.path.join(WORK_DIR, "sharded_logs")
    rows = wide_deep.synthetic_criteo(2 * SHARDED_STEPS * WD_BATCH, seed=seed + 3)
    est = tos.TorchEstimator(torch_mapfuns.estimator_wide_deep_sharded,
                             {"model_config": config, "lr": SHARDED_LR,
                              "device": device})
    est.setNumExecutors(2).setEpochs(1).setBatchSize(WD_BATCH).setSteps(SHARDED_STEPS)
    est.set("export_dir", export).set("log_dir", logs).set("train_mode", "sync")
    est.set("embedding_plan", plan.to_manifest()).set("reservation_timeout", 300)
    t0 = time.perf_counter()
    est.fit(tos.PartitionedDataset.from_iterable(rows, 4))
    fit_s = time.perf_counter() - t0
    metas = [m.get("sharded_train") for m in est.last_cluster_info]
    if any(m is None for m in metas):
        raise AssertionError(f"a sharded node published nothing: {metas}")
    step_ms = statistics.median(1e3 * s for m in metas for s in m["step_secs"][1:])
    # wire bytes a step, both nodes, from the tables' counters: an id is 8 B,
    # a row 4 * dim B; a lookup sends ids and gets ids and rows back, a
    # gradient push sends ids and rows
    steps = metas[0]["steps"]
    wire = sum(st["ids_sent"] * (8 + 8 + 4 * dim) + st["grad_rows_sent"] * (8 + 4 * dim)
               for st in (m["stats"] for m in metas)) / steps
    log(f"[criteo-sharded] TorchEstimator sync, table {plan.total_rows} x {dim} f32 "
        f"sharded over 2 nodes (host numpy), dense half on {device}: {steps} steps of "
        f"{WD_BATCH} rows, {step_ms:.1f} ms a step (median host clock, first step "
        f"excluded), sparse wire {wire / 1e6:.3f} MB a step (both nodes, from the "
        f"table counters), ids sent {[m['stats']['ids_sent'] for m in metas]}; fit "
        f"{fit_s:.1f} s with start-up ({smi})")
    if steps != SHARDED_STEPS or not all(m["stats"]["ids_sent"] > 0 for m in metas):
        raise AssertionError(f"sharded train: {metas}")

    with open(os.path.join(export, "bundle.json")) as f:
        block = json.load(f)["sharded_embedding"]
    full = restore_embedding_shard(export, "wide_deep", block["step"], 0,
                                   plan.total_rows, dim)
    params, _cfg = load_bundle(export)
    queries = [np.asarray(r["features"], np.float32) for r in
               wide_deep.synthetic_criteo(SHARDED_REQUESTS * SHARDED_REQUEST_ROWS,
                                          seed=seed + 99)]
    serve = tos.run(tos.serving_loop, {"export_dir": export, "max_batch": SHARDED_REQUEST_ROWS,
                                       "device": device},
                    num_executors=2, input_mode=tos.InputMode.STREAMING,
                    queues=("input", "output", "error", "embed", "embed_out"),
                    log_dir=logs, reservation_timeout=300)
    try:
        gw = serve.serve(export, max_batch=SHARDED_REQUEST_ROWS, max_delay_ms=2.0,
                         reload_poll_secs=0)
        got, req_ms = [], []
        for i in range(SHARDED_REQUESTS):
            t0 = time.perf_counter()
            got += gw.predict(queries[i * SHARDED_REQUEST_ROWS:(i + 1) * SHARDED_REQUEST_ROWS],
                              timeout=300)
            req_ms.append((time.perf_counter() - t0) * 1e3)
        counters = serve.metrics().get("counters") or {}
    finally:
        serve.shutdown(timeout=300)
    feats = np.stack(queries)
    emb = full[wide_deep.flat_categorical_ids(feats, config["vocab_size"])]
    want = build_sharded_apply(config, device="cpu")(params, feats, emb).numpy()
    got = np.asarray([float(o) for o in got], np.float32)
    err = float(np.abs(got - want).max())
    ok = len(got) == len(want) and np.allclose(got, want, **SHARDED_TOL)
    log(f"[criteo-sharded] 2 serve replicas on {device}, {SHARDED_REQUESTS} requests of "
        f"{SHARDED_REQUEST_ROWS} rows through the gateway's lookup fan-out: "
        f"{statistics.median(req_ms[1:]):.1f} ms a request (median host clock, first "
        f"excluded; first {req_ms[0]:.1f}), {len(got)} results, largest difference from "
        f"the dense apply over the reassembled table {err:.2e} ({SHARDED_TOL}), "
        f"gateway fan-outs {counters.get('serve.embed_fanouts', 0)} ({smi})")
    if not ok or counters.get("serve.embed_fanouts", 0) < SHARDED_REQUESTS:
        raise AssertionError(f"sharded serving disagrees: {err}, {counters}")
    return {"step_ms": step_ms, "wire_mb_per_step": wire / 1e6, "fit_s": fit_s,
            "request_ms": statistics.median(req_ms[1:]), "max_abs_err": err}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import tensorflowonspark_torch  # noqa: F401 - fails outside a checkout

    try:
        smi = phase_device()
        build = phase_build()
        t_kernel = time.perf_counter()
        record, tf32 = phase_kernel(args.seed, smi)
        log(f"[kernel] the kernel phase took {time.perf_counter() - t_kernel:.1f} s "
            f"(host clock; {smi})")
        t_lm = time.perf_counter()
        record["build"] = build
        record["launches"] = phase_slice(args.seed, smi)
        cluster = phase_cluster(args.seed, smi)
        record["cluster_launches"] = cluster.pop("launches")
        record["cluster"] = cluster
        orbax = phase_orbax_bundle(args.seed, smi)
        tf32["orbax_bundle_launches"] = orbax.pop("launches")
        tf32["orbax_bundle"] = orbax
        torch.cuda.empty_cache()
        record["train_shape"], bwd, bwd_tf32 = phase_attention_train_shape(args.seed, smi)
        bwd["cases"] = phase_attention_bwd(args.seed, smi)
        torch.cuda.empty_cache()
        model, train = phase_train(args.seed, smi)
        record["train_launches"] = train.pop("launches")
        # the backward kernels' main path: the LM training step
        bwd["launches"] = train.pop("bwd_launches")
        apply, params = phase_train_serve(model, smi)
        del model
        torch.cuda.empty_cache()
        train.update(phase_decode(apply, params, smi))
        record["train"] = train
        del apply, params
        torch.cuda.empty_cache()
        train_f32 = phase_train_f32(args.seed, smi)
        tf32["launches"] = train_f32.pop("launches")
        # the f32 backward kernels' main path: the f32 LM training step
        bwd_tf32["launches"] = train_f32.pop("bwd_launches")
        tf32["train_f32"] = train_f32
        for dim, phase in ((256, phase_train_d256), (512, phase_train_d512)):
            steps = phase(args.seed, smi)
            record[f"d{dim}_launches"] = steps["flash_attn_fwd"].pop("launches")
            record[f"train_d{dim}"] = steps["flash_attn_fwd"]
            tf32[f"d{dim}_launches"] = steps["flash_attn_fwd_tf32"].pop("launches")
            tf32[f"train_d{dim}_f32"] = steps["flash_attn_fwd_tf32"]
        # the LM examples' defaults: head dim 32 on both kernels' 32-column tiles
        torch.cuda.empty_cache()
        example = phase_example_lm(args.seed, smi)
        record["example_lm_launches"] = example["flash_attn_fwd"].pop("launches")
        record["example_lm_bf16"] = example["flash_attn_fwd"]
        bwd["example_lm_launches"] = example["flash_attn_fwd"].pop("bwd_launches")
        tf32["example_lm_launches"] = example["flash_attn_fwd_tf32"].pop("launches")
        bwd_tf32["example_lm_launches"] = example["flash_attn_fwd_tf32"].pop("bwd_launches")
        tf32["example_lm_f32"] = example["flash_attn_fwd_tf32"]
        log(f"[lm] the slice, cluster, orbax and LM phases took "
            f"{time.perf_counter() - t_lm:.1f} s (host clock; {smi})")
        # the MoE LM served and trained, and ring attention's hops
        torch.cuda.empty_cache()
        t_moe = time.perf_counter()
        moe = phase_moe_slice(args.seed, smi)
        record["moe_launches"] = moe.pop("launches")
        record["moe"] = moe
        torch.cuda.empty_cache()
        moe_train = phase_moe_train(args.seed, smi)
        record["moe_train_launches"] = moe_train.pop("launches")
        record["moe_train"] = moe_train
        torch.cuda.empty_cache()
        ring = phase_ring_hops(args.seed, smi)
        record["ring_launches"] = ring.pop("launches")
        record["ring"] = ring
        log(f"[moe] the MoE and ring phases took {time.perf_counter() - t_moe:.1f} s "
            f"(host clock; {smi})")
        # pipeline parallelism and sharded scoring
        torch.cuda.empty_cache()
        t_pp = time.perf_counter()
        pp = phase_pp(args.seed, smi)
        f32_pp = pp.pop("f32")
        record["pp_launches"] = pp.pop("launches")
        record["pp"] = pp
        tf32["pp_f32_launches"] = f32_pp.pop("launches")
        bwd_tf32["pp_f32_launches"] = f32_pp.pop("bwd_launches")
        tf32["pp_f32"] = f32_pp
        torch.cuda.empty_cache()
        scoring = phase_sharded_scoring(args.seed, smi)
        record["sharded_scoring_launches"] = scoring.pop("launches")
        record["sharded_scoring"] = scoring
        log(f"[pp] the pp and sharded-scoring phases took {time.perf_counter() - t_pp:.1f} s "
            f"(host clock; {smi})")
        # the image families: no image model reaches either kernel
        torch.cuda.empty_cache()
        t_images = time.perf_counter()
        reset_launches()
        images = {"resnet50": phase_resnet50(args.seed, smi)}
        torch.cuda.empty_cache()
        images["bn_card_vs_cpu"] = phase_bn_card_vs_cpu(args.seed, smi)
        images["inception"] = phase_inception(args.seed, smi)
        torch.cuda.empty_cache()
        images["clusters"] = phase_image_clusters(args.seed, smi)
        torch.cuda.empty_cache()
        images["ingest"] = phase_ingest_resnet50(
            args.seed, smi, images["resnet50"]["images_per_s"])
        from tensorflowonspark_torch.ops import attention as att

        if any(att.LAUNCHES.values()):
            raise AssertionError(f"an image phase launched an attention kernel: "
                                 f"{att.LAUNCHES}")
        log(f"[images] the image phases took {time.perf_counter() - t_images:.1f} s "
            f"(host clock; {smi}); summary {json.dumps(images)}")
        # BASELINE config 4: no wide-and-deep path reaches either kernel
        torch.cuda.empty_cache()
        t_criteo = time.perf_counter()
        reset_launches()
        criteo = {"wide_deep": phase_wide_deep(args.seed, smi)}
        criteo["card_vs_cpu"] = phase_wide_deep_card_vs_cpu(args.seed, smi)
        criteo["sync"] = phase_wide_deep_sync(args.seed, smi)
        criteo["pipeline"] = phase_criteo_pipeline(args.seed, smi)
        criteo["sharded"] = phase_criteo_sharded(args.seed, smi)
        if any(att.LAUNCHES.values()):
            raise AssertionError(f"a config-4 phase launched an attention kernel: "
                                 f"{att.LAUNCHES}")
        log(f"[criteo] the config-4 phases took {time.perf_counter() - t_criteo:.1f} s "
            f"(host clock; {smi}); summary {json.dumps(criteo)}")
        # a 1-rank pod through GPUPodLauncher, and torch.export programs:
        # no MNIST or ResNet path reaches either kernel; the LM programs do
        torch.cuda.empty_cache()
        t_pod = time.perf_counter()
        reset_launches()
        # it reads the rank's counts too, and its own before the LM programs
        pod = phase_pod(args.seed, smi)
        log(f"[pod] the pod phase took {time.perf_counter() - t_pod:.1f} s "
            f"(host clock; {smi}); summary {json.dumps(pod)}")
    finally:
        shutil.rmtree(WORK_DIR, ignore_errors=True)
    print(json.dumps({"kernels": [record, tf32, bwd, bwd_tf32]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
