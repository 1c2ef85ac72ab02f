#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases (any failure propagates and the script exits non-zero):

1. device — the card's name and power limit (``nvidia-smi``) and
   ``torch.cuda.get_device_name``;
2. build — builds ``tensorflowonspark_torch/csrc/flash_attn_fwd.cu``,
   ``flash_attn_fwd_tf32.cu`` and ``flash_attn_fwd_generic.cu`` from the
   checkout (one ``nvcc`` each, in parallel) and prints, per instantiation
   of the two ``wgmma`` kernels (D 64/128/256 x bf16/fp16; f32 as 3xTF32 at
   D 64/128), the registers and spills ptxas reports, the dynamic shared
   memory, and the counts of ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load)
   instructions in the SASS (``cuobjdump -sass``), failing if either is
   missing or a spill shows; and the registers and spills of the 3xTF32
   kernel's K/V pre-pass and of the CUDA-core kernel;
3. kernel — holds every route (``ops.attention._route``) against the plain
   PyTorch version (``chunk_attention``) on the card, O and lse, at the
   serving shape and at edge shapes (ragged tails, one query row,
   key-block-crossing offsets, strided q/k/v views of one packed tensor, a
   tile half fully masked), for bf16/fp16 at D 64/128 and at D=256 (and
   129-255 padded to it), for f32 through the 3xTF32 kernel (and with every
   low mantissa bit set) and through the CUDA-core kernel (D=256, at the
   head-dim-256 f32 step's shape and one decode row), and the zero-padded
   paths; each case launches its route's kernel once and no other
   (``ops.attention.LAUNCHES``).  Times each as 50 launches back to back
   between two CUDA events, and the cases of ``REFERENCE_TIMED`` also
   against the plain version and ``F.scaled_dot_product_attention`` (the
   yardstick only: the port never calls it); each bound names what it
   bounds (``BOUND_BASIS``); at the f32 serving shape also the pre-pass and
   the attention kernel apart (``torch.profiler``), the function's own
   bound at the TF32 rate beside the 3xTF32 design's, and which SDPA
   backends take f32;
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
5. attention at the training shape (B=8, S=2048, H=8, D=128, causal bf16):
   the kernel's forward held against ``chunk_attention`` (O and lse) and
   timed, and the backward of ``FlashAttention`` (the plain
   recompute VJP through ``blockwise_attention``) against its bound and the
   library's backward;
6. train — the LM at the same width, B=8, S=2048, bf16 compute with f32
   master weights, AdamW as ``optax.adamw(3e-4)``, random weights from the
   seed: 3 warm-up and 10 timed steps through ``make_batch_iterator`` over a
   ``DataFeed`` that repeats one Zipf batch; checks every loss is finite,
   the last below the first, and the kernel's launches per step (n_layers;
   2 x n_layers with remat); one step's loss and gradients with the kernel
   against plain attention, with ``vocab_chunk`` and with ``remat``; prints
   step ms, tokens/s, the forward / backward / optimizer split, the peak
   memory and the model-FLOPs share of the step;
7. train→serve — the trained weights exported as a bundle and loaded with
   ``build_apply``: logits against the training model's eval forward;
8. decode — ``greedy_generate`` on the served model (B=4, a 128-token
   prompt, 64 new tokens): cached logits against a full forward at the same
   positions, the EOS stop, ms per generated token;
9. f32 train step — one AdamW step of the f32 model configuration at the
   same width (B=2, S=2048) through the 3xTF32 kernel: a finite loss,
   n_layers launches of it and none of the other kernels, and the
   gradients against plain attention;
10. head dim 256 — the same step for the LM with 4 heads of 256 (depth cut
   to ``D256_LAYERS``), in bf16 (the ``wgmma`` kernel at D=256) and in f32
   (the CUDA-core kernel): n_layers launches of the route's kernel, and
   loss and gradients against plain attention.

The line before the last is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
with 1 and prints no result.
"""

from __future__ import annotations

import argparse
import functools
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
PEAK_F32_FLOPS = 66.9e12  # H100 SXM f32 FMA rate outside the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bandwidth
# O: P is rounded to bf16/fp16 for the P·V product on the tensor cores and O
# is stored in bf16/fp16, while the plain version runs softmax and P·V in f32.
O_TOL = dict(atol=2e-2, rtol=2e-2)
# lse: the plain version's logits are a bf16/fp16 einsum (rounded before
# the f32 softmax), the kernel's are accumulated in f32.
LSE_TOL = dict(atol=1e-2, rtol=1e-2)
# f32 inputs: the 3xTF32 kernel's products are good to about 2^-20 relative
# (x = hi + lo split, the lo.lo term dropped) and the CUDA-core kernel is f32
# FMA, against the plain version's f32 einsums (no TF32), summed in other
# orders
F32_TOL = dict(atol=1e-4, rtol=1e-4)
# slice logits, served (kernel attention) vs plain attention: bf16 compute
# rounds at different places over 8 layers; held to 5% of the largest logit
LOGIT_REL_TOL = 0.05

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
# the 3xTF32 kernel (padded to 64 or 128), bf16/fp16 at D=256 on the wgmma
# kernel (129-255 padded to 256) and below 128 padded to 64 or 128, f32
# above 128 on the CUDA-core kernel; a name with "low_bits" sets every low
# mantissa bit of the f32 inputs
GENERIC_CASES = [
    ("f32_serving_shape", 4, 2048, 2048, 8, 128, True, 0, "float32", False),
    ("f32_d64_ragged_kv_offset", 2, 200, 330, 8, 64, True, 37, "float32", False),
    ("f32_ragged_200_330_noncausal", 2, 200, 330, 8, 128, False, 0, "float32", False),
    ("f32_kv_offset_masked_rows", 1, 100, 70, 8, 128, True, 37, "float32", False),
    ("f32_kv_offset_negative", 1, 64, 192, 4, 128, True, -64, "float32", False),
    ("f32_sq_1_causal_decode", 2, 1, 517, 8, 128, True, -516, "float32", False),
    ("f32_packed_qkv_view", 2, 512, 512, 8, 128, True, 0, "float32", True),
    ("f32_consumer_half_masked", 1, 128, 128, 8, 128, True, 64, "float32", False),
    ("f32_d33_padded", 2, 70, 45, 8, 33, False, 0, "float32", False),
    ("f32_d80_padded_packed", 2, 130, 130, 8, 80, True, 0, "float32", True),
    ("f32_low_bits", 2, 512, 512, 8, 128, True, 0, "float32", False),
    ("bf16_d32_padded", 4, 512, 512, 8, 32, True, 0, "bfloat16", False),
    ("bf16_d96_padded", 2, 300, 300, 8, 96, True, 0, "bfloat16", False),
    ("bf16_d256", 4, 2048, 2048, 4, 256, True, 0, "bfloat16", False),
    ("bf16_d256_train_shape", 8, 2048, 2048, 4, 256, True, 0, "bfloat16", False),
    ("bf16_d256_ragged_noncausal", 2, 200, 330, 4, 256, False, 0, "bfloat16", False),
    ("bf16_d256_kv_offset_masked_rows", 1, 100, 70, 4, 256, True, 37, "bfloat16", False),
    ("bf16_d256_kv_offset_negative", 1, 64, 192, 4, 256, True, -64, "bfloat16", False),
    ("fp16_d256_sq_1_causal_decode", 2, 1, 517, 4, 256, True, -516, "float16", False),
    ("bf16_d256_packed_qkv_view", 2, 512, 512, 4, 256, True, 0, "bfloat16", True),
    ("bf16_d256_consumer_half_masked", 1, 128, 128, 4, 256, True, 64, "bfloat16", False),
    ("bf16_d160_padded", 2, 300, 300, 4, 160, True, 0, "bfloat16", False),
    ("fp16_d192_padded", 2, 200, 330, 4, 192, True, 5, "float16", False),
    # the head-dim-256 f32 train step's own shape, and its decode edge
    ("f32_d256", 2, 2048, 2048, 4, 256, True, 0, "float32", False),
    ("f32_d256_sq_1_causal_decode", 2, 1, 517, 4, 256, True, -516, "float32", False),
]
# cases timed against the plain version and the library call as well
REFERENCE_TIMED = ("serving_shape", "head_dim_64", "f32_serving_shape", "bf16_d256",
                   "bf16_d256_train_shape", "f32_d256", "bf16_d32_padded",
                   "bf16_d96_padded")

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
F32_TRAIN_BATCH = 2  # the f32 step: f32 products and an f32 recompute backward
D256_HEADS, D256_LAYERS = 4, 2  # head dim 256 at the LM's width, depth cut
CLUSTER_ROWS = (4, 4, 3)  # gateway.predict requests; then one row over TCP
CLUSTER_NODES = 2
# SASS instructions that show the design: wgmma and TMA loads
DESIGN_SASS = ("HGMMA", "UTMALDG")


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


# what each route's bound_ms bounds: (peak FLOP/s, products done per
# product of the function, the basis as the kernels record states it)
BOUND_BASIS = {
    "flash_attn_fwd": (PEAK_BF16_FLOPS, 1, "the function at the bf16/fp16 "
                       "tensor-core rate (989 TFLOP/s)"),
    "flash_attn_fwd_tf32": (PEAK_TF32_FLOPS, 3, "the 3xTF32 design: three TF32 "
                            "products per f32 product at 495 TFLOP/s"),
    "flash_attn_fwd_generic": (PEAK_F32_FLOPS, 1, "the CUDA-core design: f32 "
                               "FMA at 66.9 TFLOP/s"),
}


def attention_bound(b, sq, sk, h, d, causal, kv_offset, itemsize,
                    peak=PEAK_BF16_FLOPS, products=1):
    """(bound_ms, bound_by): the larger of the time of ``products`` times
    the two products over the live pairs at ``peak`` FLOP/s and the time to
    move q, k, v, O and lse."""
    flops = products * 4 * d * b * h * live_pairs(sq, sk, causal, kv_offset)
    nbytes = (2 * b * sq * h * d + 2 * b * sk * h * d) * itemsize + b * sq * h * 4
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


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


KERNEL_LIBS = ("flash_attn_fwd", "flash_attn_fwd_tf32", "flash_attn_fwd_generic")
# the wgmma instantiations: (library, D, dtype name)
WGMMA_INSTANCES = ([("flash_attn_fwd", d, dt) for d in (64, 128, 256)
                    for dt in ("bfloat16", "float16")]
                   + [("flash_attn_fwd_tf32", d, "float32") for d in (64, 128)])
# the 3xTF32 kernel's K/V pre-pass and the CUDA-core kernel (one
# instantiation for every D <= 256, keyed 256), reported by ptxas only
OTHER_INSTANCES = (("flash_attn_fwd_tf32", "split_kv", "float32"),
                   ("flash_attn_fwd_generic", 256, "float32"))


def kernel_key(text: str):
    """``(library, D, dtype name)`` of the kernel instantiation a mangled
    name in ``text`` names, or None."""
    m = re.search(r"flash_fwd_kernelILi(\d+)ELb([01])E", text)
    if m:
        return ("flash_attn_fwd", int(m.group(1)),
                "bfloat16" if m.group(2) == "1" else "float16")
    m = re.search(r"flash_fwd_tf32_kernelILi(\d+)E", text)
    if m:
        return ("flash_attn_fwd_tf32", int(m.group(1)), "float32")
    if "split_kv_kernel" in text:
        return OTHER_INSTANCES[0]
    if "flash_fwd_generic_kernel" in text:
        return OTHER_INSTANCES[1]
    return None


def ptxas_report(log_text: str) -> dict:
    """``{kernel_key: {"registers", "spill_stores", "spill_loads"}}`` for
    each kernel instantiation, from nvcc's ``-Xptxas -v``."""
    report, cur = {}, None
    for line in log_text.splitlines():
        key = kernel_key(line)
        if key and ("Compiling entry" in line or "Function properties" in line):
            cur = report.setdefault(key, {})
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
    return report


def sass_counts(lib_path) -> dict:
    """``{kernel_key: {instruction: count}}`` for ``DESIGN_SASS`` in each
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
                key, dict.fromkeys(DESIGN_SASS, 0))
        elif cur is not None:
            for ins in DESIGN_SASS:
                cur[ins] += ins in line
    return counts


def phase_build() -> dict:
    """Build the three kernels from the checkout (one nvcc each, in
    parallel); print and return what ptxas and the SASS say about each
    ``wgmma`` instantiation (failing on a spill or a missing HGMMA/UTMALDG)
    and what ptxas says about the pre-pass and the CUDA-core kernel."""
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
        if name != "flash_attn_fwd_generic":
            sass.update(sass_counts(cuda_build.library_path(name)))
    info = {}
    for key in WGMMA_INSTANCES + list(OTHER_INSTANCES):
        lib_name, d, dt = key
        regs, ins = ptxas.get(key), sass.get(key, {})
        if not regs:
            raise AssertionError(f"no ptxas report for {key}")
        label = f"D={d}" if isinstance(d, int) else d
        smem = 0 if d == "split_kv" else getattr(
            libs[lib_name], f"tos_{lib_name}_smem_bytes")(d)
        tag = {"flash_attn_fwd": "", "flash_attn_fwd_tf32": "tf32_",
               "flash_attn_fwd_generic": "generic_"}[lib_name]
        info[f"{tag}{label.replace('=', '')}_{dt}"] = {**regs, "smem_bytes": smem, **ins}
        log(f"[build] {lib_name} {label} {dt}: {regs.get('registers')} registers, "
            f"{regs.get('spill_stores')} B spill stores, "
            f"{regs.get('spill_loads')} B spill loads, {smem} B dynamic shared "
            f"memory" + ("; SASS " + ", ".join(f"{k} x{v}" for k, v in ins.items())
                         if ins else ""))
        if key in WGMMA_INSTANCES:
            if not (ins and all(ins.values())):
                raise AssertionError(f"{key}: SASS lacks one of {DESIGN_SASS}")
            if regs.get("spill_stores") or regs.get("spill_loads"):
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "device_time", 0) or getattr(e, "cuda_time", 0)
            out[e.name] = out.get(e.name, 0.0) + us / 1e3 / reps
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


def phase_kernel(seed: int, smi: str) -> list[dict]:
    """Every route against ``chunk_attention`` at every case; returns the
    ``kernels`` records of the wgmma kernel, the 3xTF32 kernel and the
    CUDA-core kernel."""
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
        if packed and d in att.KERNEL_HEAD_DIMS and att._kernel_operand(q) is not q:
            raise AssertionError(f"{name}: packed views were copied, not read in place")
        route, padded = att._route(dtype, d)
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
        peak, products, basis = BOUND_BASIS[route]
        bound_ms, bound_by = attention_bound(b, sq, sk, h, d, causal, off,
                                             q.element_size(), peak, products)
        tflops = 4 * d * b * h * live_pairs(sq, sk, causal, off) / (ms * 1e-3) / 1e12
        log(f"[kernel] {name}: ok ({route}, D {d} -> {padded}), max_abs_err "
            f"{err:.3e}, masked rows {int(masked.sum())}, {ms:.4f} ms, "
            f"{tflops:.1f} TFLOP/s, host {host_ms:.4f} ms per call (bound "
            f"{bound_ms:.5f} ms, {bound_by}, on {basis}; share "
            f"{bound_ms / ms:.3f})")
        if name in REFERENCE_TIMED:
            plain_ms = time_ms(lambda: att.chunk_attention(q, k, v, causal=causal),
                               reps=10, windows=3)[0]
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True))[0]
            rec = {"shape": f"B={b} S={sq} H={h} D={d} causal {dtype_name}",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by, "bound_basis": basis,
                   "library_ms": library_ms, "host_ms": host_ms, "tflops": tflops,
                   "bound_share": bound_ms / ms}
            log(f"[kernel] {name}: plain {plain_ms:.4f} ms, "
                f"F.scaled_dot_product_attention {library_ms:.4f} ms, kernel / "
                f"library {ms / library_ms:.3f} ({smi})")
            if tf32:
                parts = kernel_device_ms(lambda: att.flash_attn_fwd_cuda(
                    q, k, v, causal=causal, kv_offset=off))
                rec["prepass_ms"] = sum(t for n, t in parts.items() if "split_kv" in n)
                rec["attention_kernel_ms"] = sum(
                    t for n, t in parts.items() if "flash_fwd_tf32" in n)
                # the function's own FLOPs at the TF32 rate: what the card
                # needs for this work on its fastest f32-input pipes
                rec["bound_function_tf32_ms"] = attention_bound(
                    b, sq, sk, h, d, causal, off, 4, PEAK_TF32_FLOPS)[0]
                # the CUDA-core design's bound, which this kernel runs under:
                # not a bound on the card, kept to compare the two designs
                rec["cuda_core_design_bound_ms"] = attention_bound(
                    b, sq, sk, h, d, causal, off, 4, PEAK_F32_FLOPS)[0]
                rec["sdpa_backends"] = sdpa_backends(qt, kt, vt, smi)
                log(f"[kernel] {name}: pre-pass {rec['prepass_ms']:.4f} ms + "
                    f"attention kernel {rec['attention_kernel_ms']:.4f} ms "
                    f"(torch.profiler, device time per call); bounds: "
                    f"{bound_ms:.5f} ms on the 3xTF32 design (bound_ms, share "
                    f"{bound_ms / ms:.3f}), {rec['bound_function_tf32_ms']:.5f} "
                    f"ms for the function's own FLOPs at "
                    f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s (share "
                    f"{rec['bound_function_tf32_ms'] / ms:.3f}); the CUDA-core "
                    f"design's f32-FMA bound, {rec['cuda_core_design_bound_ms']:.5f}"
                    f" ms, bounds that design only ({smi})")
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
                   d32_padded=timed["bf16_d32_padded"],
                   d96_padded=timed["bf16_d96_padded"]),
            record("flash_attn_fwd_tf32", "f32_serving_shape"),
            record("flash_attn_fwd_generic", "f32_d256")]


def make_lm_params(cfg: dict, seed: int) -> dict:
    """Random f32 weights in the JAX package's bundle layout (flax names),
    normal with std 1/sqrt(fan_in); norm scales 1."""
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
            "mlp": {"gate_proj": {"kernel": w((d, f), d)},
                    "up_proj": {"kernel": w((d, f), d)},
                    "down_proj": {"kernel": w((f, d), f)}},
        }
    return params


def phase_slice(seed: int, smi: str, device: str = "cuda") -> int:
    """Drive the replica on ``device``; returns the kernel's launches in
    that run."""
    import numpy as np
    import torch

    from tensorflowonspark_torch import telemetry
    from tensorflowonspark_torch.checkpoint import export_bundle, invalidate_bundle
    from tensorflowonspark_torch.feeding import DataFeed, FeedQueues
    from tensorflowonspark_torch.marker import EndOfFeed, EndPartition, ResultChunk
    from tensorflowonspark_torch.models.registry import build_apply
    from tensorflowonspark_torch.ops import attention as att
    from tensorflowonspark_torch.serving.batcher import CTL_KEY
    from tensorflowonspark_torch.serving.loop import serving_loop

    t0 = time.perf_counter()
    params = make_lm_params(LM_CONFIG, seed)
    n_params = sum(a.size for blk in params.values() for a in _leaves(blk))
    export = os.path.join(WORK_DIR, "lm_bundle")
    export_bundle(export, params, LM_CONFIG)
    del params
    log(f"[slice] exported {n_params / 1e6:.1f} M f32 params in "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(seed + 1)
    batches = [[rng.integers(0, LM_CONFIG["vocab_size"], SEQ_LEN, dtype=np.int32)
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
    launches = att.LAUNCHES["flash_attn_fwd"]
    log(f"[slice] serving_loop finished in {wall:.1f} s; flash_attn_fwd "
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
    want = LM_CONFIG["n_layers"] * len(BATCH_ROWS)
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != n_layers x scored "
                             f"batches = {want}")
    for r in served:
        if r.shape != (SEQ_LEN, LM_CONFIG["vocab_size"]) or r.dtype != np.float32 \
                or not np.isfinite(r).all():
            raise AssertionError("served logits not finite f32 [S, V]")

    # the same bundle with plain (blockwise) attention on the card, per batch:
    # agreement row by row also proves the results came back in order
    from tensorflowonspark_torch.checkpoint import load_bundle

    ref_params, _ = load_bundle(export)
    ref_apply = build_apply({**LM_CONFIG, "attn_impl": "xla"}, device=device)
    start = 0
    worst = 0.0
    agree = []
    for rows in batches:
        padded = rows + [rows[-1]] * (MAX_BATCH - len(rows))
        ref = ref_apply(ref_params, np.stack(padded))[:len(rows)]
        got = torch.from_numpy(np.stack(served[start:start + len(rows)])).to(device)
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        worst = max(worst, err / scale)
        agree.append((got.argmax(-1) == ref.argmax(-1)).float().mean().item())
        if err > LOGIT_REL_TOL * scale:
            raise AssertionError(f"served logits differ from plain attention by "
                                 f"{err:.4f} > {LOGIT_REL_TOL} x {scale:.3f}")
        start += len(rows)
    if att.LAUNCHES["flash_attn_fwd"] != launches:
        raise AssertionError("the plain-attention reference launched the kernel")
    log(f"[slice] logits vs plain attention: worst max_abs_err/max|logit| "
        f"{worst:.4f} (limit {LOGIT_REL_TOL}), argmax agreement "
        f"{', '.join(f'{a:.4f}' for a in agree)}")
    for i, (secs, rows) in enumerate(zip(round_secs, BATCH_ROWS)):
        log(f"[slice] batch {i}: {rows} rows x {SEQ_LEN} tokens, "
            f"{secs * 1e3:.1f} ms, {rows * SEQ_LEN / secs:.0f} tokens/s "
            f"({smi})")
    if device == "cuda":
        log_breakdown(export, batches[0], device, smi)
    return launches


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


def phase_attention_train_shape(seed: int, smi: str) -> dict:
    """The kernel's forward and ``FlashAttention``'s backward (the plain
    recompute VJP) at the training shape, each beside its bound, the plain
    version and the library call."""
    import torch
    import torch.nn.functional as F

    from tensorflowonspark_torch.ops import attention as att

    b, s, h, d = TRAIN_BATCH, SEQ_LEN, LM_CONFIG["n_heads"], \
        LM_CONFIG["d_model"] // LM_CONFIG["n_heads"]
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    q, k, v = kernel_inputs(b, s, s, h, d, torch.bfloat16, False, gen)
    cot = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    pairs = live_pairs(s, s, True, 0)
    o, lse = att.flash_attn_fwd_cuda(q, k, v, causal=True)
    po, plse = att.chunk_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), po.float(), **O_TOL)
    torch.testing.assert_close(lse, plse, **LSE_TOL)
    err = max((o.float() - po.float()).abs().max().item(),
              (lse - plse).abs().max().item())
    del o, lse, po, plse
    fwd_ms = time_ms(lambda: att.flash_attn_fwd_cuda(q, k, v, causal=True))[0]
    fwd_bound, fwd_by = attention_bound(b, s, s, h, d, True, 0, 2)
    plain_ms = time_ms(lambda: att.chunk_attention(q, k, v, causal=True),
                       reps=5, windows=3)[0]
    qkv = [x.detach().requires_grad_() for x in (q, k, v)]
    out = att.flash_attention(*qkv, causal=True)
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, qkv, cot, retain_graph=True),
                     reps=5, windows=3, warmup=1)[0]
    # backward: S = QK^T again, dP = dO V^T, dV = P^T dO, dQ = dS K,
    # dK = dS^T Q: five products over the live pairs; q, k, v, dO read,
    # dq, dk, dv written
    bwd_flops = 10 * d * b * h * pairs
    t_ops, t_bytes = bwd_flops / PEAK_BF16_FLOPS, 7 * b * s * h * d * 2 / PEAK_BYTES
    bwd_bound, bwd_by = max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"
    qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    cot_t = cot.transpose(1, 2).contiguous()
    bwd_library_ms = time_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), cot_t, retain_graph=True), reps=5, windows=3)[0]
    fwd_library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt.detach(), kt.detach(), vt.detach(), is_causal=True))[0]
    shape = f"B={b} S={s} H={h} D={d} causal bfloat16"
    log(f"[attn-train] {shape}: kernel vs plain ok, max_abs_err {err:.3e} "
        f"(tolerance O {O_TOL}, lse {LSE_TOL}); kernel forward {fwd_ms:.4f} ms (bound "
        f"{fwd_bound:.5f} ms, {fwd_by}, share {fwd_bound / fwd_ms:.3f}); plain "
        f"{plain_ms:.4f} ms; F.scaled_dot_product_attention {fwd_library_ms:.4f} ms "
        f"({smi})")
    log(f"[attn-train] backward (recompute VJP through blockwise_attention, "
        f"block_k {att.BWD_BLOCK_K}): {bwd_ms:.4f} ms per layer (bound "
        f"{bwd_bound:.5f} ms, {bwd_by}, share {bwd_bound / bwd_ms:.4f}); "
        f"library backward {bwd_library_ms:.4f} ms ({smi})")
    return {"shape": shape, "max_abs_err": err, "ms": fwd_ms,
            "bound_ms": fwd_bound, "bound_by": fwd_by,
            "plain_ms": plain_ms, "library_ms": fwd_library_ms, "bwd_ms": bwd_ms,
            "bwd_bound_ms": bwd_bound, "bwd_bound_by": bwd_by,
            "bwd_library_ms": bwd_library_ms}


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
    reset_launches()
    for i, (batch, n) in enumerate(dp.make_batch_iterator(feed, TRAIN_BATCH, to_arrays)):
        if n != TRAIN_BATCH:
            raise AssertionError(f"step {i}: {n} real rows, expected {TRAIN_BATCH}")
        if i == TRAIN_WARMUP and cuda:
            start.record()
            t_host = time.perf_counter()
        before = att.LAUNCHES["flash_attn_fwd"]
        state, metrics = step(state, batch)
        launches.append(att.LAUNCHES["flash_attn_fwd"] - before)
        losses.append(metrics["loss"])
    if cuda:
        end.record()
        end.synchronize()
        host_ms = (time.perf_counter() - t_host) * 1e3 / TRAIN_TIMED
    train_launches = att.LAUNCHES["flash_attn_fwd"]
    losses = [x.item() for x in losses]
    log("[train] losses: " + ", ".join(f"{x:.4f}" for x in losses))
    if len(losses) != n_steps or state.step != n_steps:
        raise AssertionError(f"{len(losses)} steps taken, expected {n_steps}")
    if not all(np.isfinite(losses)):
        raise AssertionError("a training loss is not finite")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall on a repeated batch: "
                             f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    if set(launches) != {per_step}:
        raise AssertionError(f"kernel launches per step {launches}, expected "
                             f"{per_step} (one per layer)")
    log(f"[train] kernel launches: {per_step} per step, {train_launches} over "
        f"{n_steps} steps")
    record = {"launches": train_launches, "losses": losses}

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


def train_agreement(model, loss_fn, batch, per_step: int, device: str) -> dict:
    """One step's loss and gradients at the same weights and batch: the
    kernel path against plain attention (``attn_impl="xla"``), against
    ``vocab_chunk`` and against ``remat``; counts a remat step's launches."""
    import torch

    from tensorflowonspark_torch.models import transformer as tfm
    from tensorflowonspark_torch.ops import attention as att

    loss, grads = loss_and_grads(model, loss_fn, batch)
    with torch.device(device):
        plain = tfm.build_transformer({**LM_CONFIG, "attn_impl": "xla"})
    plain.load_state_dict(model.state_dict())
    before = att.LAUNCHES["flash_attn_fwd"]
    others = {"xla": loss_and_grads(plain, tfm.make_loss_fn(plain), batch)}
    del plain
    if att.LAUNCHES["flash_attn_fwd"] != before:
        raise AssertionError("the plain-attention step launched the kernel")
    others["vocab_chunk"] = loss_and_grads(
        model, tfm.make_loss_fn(model, vocab_chunk=VOCAB_CHUNK), batch)
    model.remat = True
    before = att.LAUNCHES["flash_attn_fwd"]
    others["remat"] = loss_and_grads(model, loss_fn, batch)
    remat_launches = att.LAUNCHES["flash_attn_fwd"] - before
    model.remat = False
    if remat_launches != 2 * per_step:
        raise AssertionError(f"a remat step launched the kernel {remat_launches} "
                             f"times, expected {2 * per_step}")
    out = {"remat_launches": remat_launches}
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
    log(f"[train] remat step: {remat_launches} kernel launches (2 x n_layers)")
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
    after; on the card exactly n_layers launches of ``route`` and none of
    the other kernels."""
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
    loss, grads = loss_and_grads(model, loss_fn, batch)
    step_s = time.perf_counter() - t0
    launched = dict(att.LAUNCHES)
    want = cfg["n_layers"] if cuda else 0  # the CPU path has no kernel
    if launched != {n: want if n == route else 0 for n in att.LAUNCHES}:
        raise AssertionError(f"{tag} step: launches {launched}, expected {want} "
                             f"of {route} and none of the others")
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
        f"{launched[route]} launches of {route}; forward + backward "
        f"{step_s * 1e3:.1f} ms host clock ({smi})")
    if loss_err > LOSS_REL_TOL or grad_err > GRAD_REL_TOL:
        raise AssertionError(f"the {tag} step disagrees with plain attention")
    return {"launches": launched[route], "loss": loss, "grad_rel_err": grad_err,
            "fwd_bwd_ms": step_s * 1e3}


def phase_train_f32(seed: int, smi: str, device: str = "cuda") -> dict:
    """One AdamW step of the f32 model configuration (``bf16: false``) at
    the LM width through the 3xTF32 kernel: a finite loss, n_layers
    launches of it and none of the others, and the step's gradients
    against plain attention.  Its step time against another checkout's is
    measured by ``examples_torch/attention_ab.py``, not here."""
    return step_against_plain({**LM_CONFIG, "bf16": False}, seed + 11,
                              F32_TRAIN_BATCH, "flash_attn_fwd_tf32", "train-f32",
                              smi, device)


def phase_train_d256(seed: int, smi: str, device: str = "cuda") -> dict:
    """The LM at its width with ``D256_HEADS`` heads of 256 (depth cut to
    ``D256_LAYERS``): one bf16 step through the wgmma kernel at D=256 and
    one f32 step through the CUDA-core kernel, each against plain
    attention; returns each step's numbers by route."""
    cfg = {**LM_CONFIG, "n_heads": D256_HEADS, "n_layers": D256_LAYERS}
    return {route: step_against_plain({**cfg, "bf16": bf16}, seed + 13,
                                      F32_TRAIN_BATCH, route, tag, smi, device)
            for route, bf16, tag in (("flash_attn_fwd", True, "train-d256-bf16"),
                                     ("flash_attn_fwd_generic", False,
                                      "train-d256-f32"))}


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
        record, tf32, generic = phase_kernel(args.seed, smi)
        record["build"] = build
        record["launches"] = phase_slice(args.seed, smi)
        cluster = phase_cluster(args.seed, smi)
        record["cluster_launches"] = cluster.pop("launches")
        record["cluster"] = cluster
        torch.cuda.empty_cache()
        record["train_shape"] = phase_attention_train_shape(args.seed, smi)
        torch.cuda.empty_cache()
        model, train = phase_train(args.seed, smi)
        record["train_launches"] = train.pop("launches")
        apply, params = phase_train_serve(model, smi)
        del model
        torch.cuda.empty_cache()
        train.update(phase_decode(apply, params, smi))
        record["train"] = train
        del apply, params
        torch.cuda.empty_cache()
        train_f32 = phase_train_f32(args.seed, smi)
        tf32["launches"] = train_f32.pop("launches")
        tf32["train_f32"] = train_f32
        d256 = phase_train_d256(args.seed, smi)
        record["d256_launches"] = d256["flash_attn_fwd"].pop("launches")
        record["train_d256"] = d256["flash_attn_fwd"]
        generic["launches"] = d256["flash_attn_fwd_generic"].pop("launches")
        generic["train_d256_f32"] = d256["flash_attn_fwd_generic"]
    finally:
        shutil.rmtree(WORK_DIR, ignore_errors=True)
    print(json.dumps({"kernels": [record, tf32, generic]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
