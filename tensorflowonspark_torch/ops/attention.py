"""Attention ops: a hand-written Hopper flash-attention forward, and the
plain PyTorch versions it is held against.

Counterpart of ``tensorflowonspark_tpu/ops/attention.py``, same layout
(``[batch, seq, heads, head_dim]``) and the same constants:

- ``mha_reference`` — dense O(S²) attention, the spec;
- ``chunk_attention`` / ``merge_attention`` — the ``(out, lse)`` chunk
  compute and its online-softmax merge, the primitives ring attention
  composes; ``chunk_attention`` is also the plain version of the kernel;
- ``blockwise_attention`` — online softmax as a loop over checkpointed key
  blocks;
- ``flash_attention`` / ``flash_attention_fwd`` — the public entry.  It
  reaches attention only through the operator ``tos::flash_attn_fwd``
  (``torch.ops.tos.flash_attn_fwd``, a ``torch.library.custom_op`` with a
  fake implementation, so ``torch.export`` keeps its call in a program): a
  CUDA tensor goes to the kernels (``flash_attn_fwd_cuda``), a CPU tensor
  to the plain version.  ``_route`` picks the kernel for every head
  dim: bf16/fp16 runs the ``wgmma`` kernel (``csrc/flash_attn_fwd.cu``)
  up to 256 on the tile of 32, 64, 96, 128, 192 or 256 columns that holds
  the head, and above 256 its wide route; f32 runs the 3xTF32 ``wgmma``
  kernel (``csrc/flash_attn_fwd_tf32.cu``) up to 128 on the tile of 32,
  64, 96 or 128 columns, and above 128 its wide route.  Every route runs
  at the real head dim: the tensor maps are encoded at it and TMA
  zero-fills a tile's columns past it, so nothing is padded in device
  memory but a head dim whose rows a tensor map cannot describe (not a
  multiple of ``TMA_ROW_BYTES``), and O is written at the real head dim.
  A wide route's two consumer warpgroups split the head dim, so Q Kᵀ is
  computed once per query tile, and a grid that would leave the card idle
  (a small one, or the long tail of a causal wave) splits its tiles' keys
  into ranges merged by a combine kernel (``_wide_splits``).
  Only a type the kernels do not take raises.
  ``LAUNCHES`` counts each kernel's launches.  A CUDA tensor whose kernel
  fails to build or launch raises: nothing falls back.
  When autograd records the call, it goes through ``FlashAttention``, the
  counterpart of the JAX package's ``custom_vjp`` ``_flash_attention_tpu``:
  the same forward, and a backward through ``out`` and ``lse`` both.  The
  backward is the operator ``tos::flash_attn_bwd`` (the FA2 gradient from
  the saved ``q, k, v`` and ``lse``, with Δ summed from P and dP in f32):
  on a CUDA tensor the hand-written kernels ``_bwd_route`` picks up to
  D=128 (bf16/fp16 ``csrc/flash_attn_bwd.cu``, f32 as 3xTF32
  ``csrc/flash_attn_bwd_tf32.cu``), on a CPU tensor their plain version
  (``flash_attn_bwd_reference``).  Heads above 128 take the JAX package's
  own backward on the card: the VJP of ``blockwise_attention``,
  recomputed from ``q, k, v``.

All softmax accumulation is float32 whatever the input type.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

from tensorflowonspark_torch import telemetry

NEG_INF = -1e30  # finite stand-in for -inf: keeps exp() exactly 0 without nan


def _causal_keep(sq: int, sk: int, kv_offset: int, device) -> torch.Tensor:
    """``[sq, sk]`` bool: key ``j`` (global position ``kv_offset + j``) is
    visible from query ``i``."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = kv_offset + torch.arange(sk, device=device)[None, :]
    return kpos <= qpos


def _logits(q, k, scale):
    return torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------

def mha_reference(q, k, v, *, causal: bool = True, sm_scale: float | None = None,
                  kv_offset: int = 0):
    """Dense O(S²) attention.  ``kv_offset`` is the global position of
    ``k[:, 0]`` relative to ``q[:, 0]``."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = _logits(q, k, scale)
    if causal:
        keep = _causal_keep(q.shape[1], k.shape[1], kv_offset, q.device)
        logits = torch.where(keep, logits, NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v.float()).to(q.dtype)


def chunk_attention(q, k, v, *, causal: bool = True,
                    sm_scale: float | None = None, kv_offset: int = 0):
    """Attend q over one KV chunk; return ``(out, lse)``.

    ``out`` is the softmax-normalised output for this chunk alone and
    ``lse`` its log-sum-exp (``[B, Sq, H]``, float32).  A row with every
    position masked gives ``out = 0`` and ``lse = NEG_INF``.
    """
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = _logits(q, k, scale)
    if causal:
        keep = _causal_keep(q.shape[1], k.shape[1], kv_offset, q.device)
        logits = torch.where(keep, logits, NEG_INF)
    m = logits.amax(dim=-1)                                        # [B,H,Sq]
    # guard the max so exp(NEG_INF - NEG_INF) of a fully masked row isn't 1
    m_safe = torch.clamp(m, min=NEG_INF / 2)
    p = torch.exp(logits - m_safe[..., None])
    p = torch.where(logits <= NEG_INF / 2, 0.0, p)
    l = p.sum(dim=-1)                                              # [B,H,Sq]
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    l_safe = torch.clamp(l, min=1e-30)
    lse = torch.where(l > 0.0, m_safe + torch.log(l_safe), NEG_INF)
    o = o / l_safe.transpose(1, 2)[..., None]
    return o.to(q.dtype), lse.transpose(1, 2).contiguous()         # [B,Sq,H]


def merge_attention(o1, lse1, o2, lse2):
    """Merge two chunk results (online-softmax combine); fully masked chunks
    (``lse == NEG_INF``) drop out exactly."""
    lse = torch.clamp(torch.logaddexp(lse1, lse2), min=NEG_INF)
    w1 = torch.exp(lse1 - lse)[..., None]
    w2 = torch.exp(lse2 - lse)[..., None]
    o = o1.float() * w1 + o2.float() * w2
    return o.to(o1.dtype), lse


def _online_block(o, m, l, q, kc, vc, start, *, causal, scale, kv_offset):
    """One key block of the online softmax: the carry ``(o, m, l)`` updated
    by keys ``start .. start + len(kc)``."""
    logits = _logits(q, kc, scale)
    if causal:
        qpos = torch.arange(q.shape[1], device=q.device)[:, None]
        kpos = kv_offset + start + torch.arange(kc.shape[1], device=q.device)
        logits = torch.where(kpos[None, :] <= qpos, logits, NEG_INF)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    m_safe = torch.clamp(m_new, min=NEG_INF / 2)
    p = torch.exp(logits - m_safe[..., None])
    p = torch.where(logits <= NEG_INF / 2, 0.0, p)
    alpha = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_safe))
    l = l * alpha + p.sum(dim=-1)
    o = (o * alpha.transpose(1, 2)[..., None]
         + torch.einsum("bhqk,bkhd->bqhd", p, vc.float()))
    return o, m_new, l


def blockwise_attention(q, k, v, *, causal: bool = True,
                        sm_scale: float | None = None, block_k: int = 512,
                        kv_offset: int = 0, return_lse: bool = False):
    """Online-softmax attention as a loop over key blocks: memory stays
    O(Sq·block_k) instead of O(Sq·Sk).  ``return_lse`` returns ``(out,
    lse)`` with ``lse`` as ``chunk_attention`` gives it (``[B, Sq, H]``
    f32, ``NEG_INF`` on a fully masked row), differentiable too.

    Each block step runs under ``torch.utils.checkpoint`` (the JAX scan's
    ``jax.checkpoint``): when autograd records the loop, only the carries
    are kept, and the backward recomputes each block's f32 logits and P, so
    backward memory stays O(Sq·block_k) too."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    o = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for start in range(0, sk, block_k):
        o, m, l = checkpoint(
            _online_block, o, m, l, q, k[:, start:start + block_k],
            v[:, start:start + block_k], start, use_reentrant=False,
            causal=causal, scale=scale, kv_offset=kv_offset)
    l_safe = torch.clamp(l, min=1e-30)
    o = (o / l_safe.transpose(1, 2)[..., None]).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(l > 0.0, m + torch.log(l_safe), NEG_INF)
    return o, lse.transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# The kernels: csrc/flash_attn_fwd.cu and csrc/flash_attn_fwd_tf32.cu, bound
# through ctypes.
# ---------------------------------------------------------------------------

# the kernels' tiles: a head dim runs on the narrowest tile that holds it,
# TMA filling the tile's columns past it with zeros (bf16/fp16 on the wgmma
# kernel, f32 on the 3xTF32 wgmma kernel); above the widest, the kernels'
# wide routes
KERNEL_HEAD_DIMS = (32, 64, 96, 128, 192, 256)
TF32_HEAD_DIMS = (32, 64, 96, 128)
_HEAD_DIMS = {"flash_attn_fwd": KERNEL_HEAD_DIMS,
              "flash_attn_fwd_tf32": TF32_HEAD_DIMS}
# a tensor map's rows (every stride but the head dim's) are multiples of 16
# bytes: only a head dim whose rows are not (bf16/fp16 D not a multiple of
# 8, f32 D not a multiple of 4) is padded, to the next one that is
TMA_ROW_BYTES = 16
_DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1}  # the wgmma kernel's
_LIBS: dict = {}
# C signatures: tos_<name>(q, k, v, o, lse, scratch, B, Sq, Sk, H, D,
# strides, causal, kv_offset, sm_scale, wide, splits, [dtype,] stream): the
# wgmma kernel takes a dtype code
_SHAPE_ARGS = ([ctypes.c_int] * 5
               + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                  ctypes.c_int, ctypes.c_int])
# tos_flash_attn_bwd(q, k, v, dout, lse, g_lse, dq, dk, dv, scratch, B, Sq,
# Sk, H, D, strides, causal, kv_offset, sm_scale, [dtype,] stream): the
# bf16/fp16 backward takes a dtype code, the f32 one none
_BWD_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float])
_ARGTYPES = {
    "flash_attn_fwd": ([ctypes.c_void_p] * 6 + _SHAPE_ARGS
                       + [ctypes.c_int, ctypes.c_void_p]),
    "flash_attn_fwd_tf32": [ctypes.c_void_p] * 6 + _SHAPE_ARGS + [ctypes.c_void_p],
    "flash_attn_bwd": _BWD_ARGS + [ctypes.c_int, ctypes.c_void_p],
    "flash_attn_bwd_tf32": _BWD_ARGS + [ctypes.c_void_p],
}
# the backward kernels, by their name in _bwd_route
BWD_KERNELS = ("flash_attn_bwd", "flash_attn_bwd_tf32")
# each kernel's launches, by its name in _route / _bwd_route; bumped only
# where _run has launched it (once a call: the wide routes' combine step and
# the backward's kernels included)
LAUNCHES = dict.fromkeys(_ARGTYPES, 0)

# The wide routes' split-KV rule (both kernels take the count as an
# argument and cut each query tile's own key blocks by it).  A grid of
# B*H*ceil(Sq/WIDE_ROWS)*ceil(D/WIDE_CTA_COLS) CTAs that fills less than
# half of the card's SMs gets its key blocks split into ranges, as many as fill
# the card, at most one a key block and at most MAX_SPLITS, then as few as
# cover the blocks at that many blocks a range.  A causal grid of at most
# one wave gets 2: its longest tiles (all the keys) would otherwise run
# alone while the short ones idle, so each tile's keys are cut in ranges of
# half the longest tile's, and a tile that needs one range (the shorter
# half) writes O directly.  The blocks are those the longest tile may see
# (`_reach_blocks`).  The kernels' own constants: kWideRows, kWideCtaCols,
# kWideBlockK, and kMaxSplits (hopper_pipeline.cuh).  The SM count is the
# card's own (_sm_count: 132 on an H100 SXM, 114 on an H100 PCIe).
WIDE_ROWS = 64                     # query rows per CTA on the wide routes
WIDE_CTA_COLS = 512                # most columns of O one CTA covers
WIDE_BLOCK_K = {"flash_attn_fwd": 64, "flash_attn_fwd_tf32": 32}
MAX_SPLITS = 16


def _reach_blocks(name: str, sq: int, sk: int, causal: bool, kv_offset: int,
                  q_end: int | None = None) -> int:
    """Key blocks the query rows before ``q_end`` (default ``sq``) may see:
    all of ``sk`` or, causal, the keys up to the last row's position."""
    keys = sk
    if causal:
        keys = min(sk, max(0, min(sq, sq if q_end is None else q_end) - kv_offset))
    return -(-keys // WIDE_BLOCK_K[name])


@functools.cache
def _sm_count(device: torch.device) -> int:
    """The SMs of the card ``device`` names, read once per device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _wide_splits(name: str, b: int, h: int, sq: int, sk: int, d: int,
                 causal: bool = False, kv_offset: int = 0, *, sm_count: int) -> int:
    """Key ranges of a wide-route call of kernel ``name`` on a card of
    ``sm_count`` SMs: a function of the shape, the mask and the card only
    (the rule above)."""
    ctas = b * h * -(-sq // WIDE_ROWS) * -(-d // WIDE_CTA_COLS)
    blocks = _reach_blocks(name, sq, sk, causal, kv_offset)
    if blocks < 2:
        return 1
    if 2 * ctas >= sm_count:
        return 2 if causal and ctas <= sm_count else 1
    splits = min(-(-sm_count // ctas), blocks, MAX_SPLITS)
    per = -(-blocks // splits)
    return -(-blocks // per)


def _tile_ranges(name: str, splits: int, q0: int, sq: int, sk: int, causal: bool,
                 kv_offset: int) -> list[tuple[int, int]]:
    """The key-block ranges ``[first, last)`` of the query tile from row
    ``q0`` over ``splits`` ranges, as both kernels cut them: ranges of
    ceil(longest tile's blocks / splits) blocks over the tile's own blocks
    (one empty range where it sees none)."""
    per = max(1, -(-_reach_blocks(name, sq, sk, causal, kv_offset) // splits))
    mine = _reach_blocks(name, sq, sk, causal, kv_offset, q_end=q0 + WIDE_ROWS)
    return [(k, min(k + per, mine)) for k in range(0, mine, per)] or [(0, 0)]


def _route(dtype: torch.dtype, d: int) -> tuple[str, int]:
    """``(kernel, head_dim it runs at)`` for inputs of ``dtype`` with
    head_dim ``d``: bf16/fp16 to the wgmma kernel, f32 to the 3xTF32
    kernel (each on its tile up to ``_HEAD_DIMS``' widest, above it on its
    wide route), at ``d`` itself rounded up only to whole
    ``TMA_ROW_BYTES`` rows.  Raises on a type the kernels do not take (or a
    head_dim below 1)."""
    if dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"the kernels take bf16, fp16 or f32, got {dtype}")
    if d < 1:
        raise ValueError(f"head_dim must be at least 1, got {d}")
    name = "flash_attn_fwd_tf32" if dtype == torch.float32 else "flash_attn_fwd"
    row = TMA_ROW_BYTES // dtype.itemsize
    return name, -(-d // row) * row


def _kernel_lib(name: str):
    """Build (first use) and bind ``csrc/<name>.cu`` (``_ARGTYPES``)."""
    if name not in _LIBS:
        from tensorflowonspark_torch.ops.cuda_build import load_library

        lib = load_library(name)
        fn = getattr(lib, f"tos_{name}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        if name in _HEAD_DIMS:  # the forward kernels size their own scratch
            scratch = getattr(lib, f"tos_{name}_scratch_bytes")
            scratch.argtypes = [ctypes.c_int] * 7
            scratch.restype = ctypes.c_int64
        _LIBS[name] = lib
    return _LIBS[name]


def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when the kernel's tensor maps can read it in place (unit
    head_dim stride, 16-byte rows, no broadcast dimension, 16-byte aligned
    base), else a contiguous copy."""
    if (x.stride(-1) == 1
            and all(s * x.element_size() % TMA_ROW_BYTES == 0 and (s > 0 or n == 1)
                    for s, n in zip(x.stride()[:-1], x.shape[:-1]))
            and x.data_ptr() % 16 == 0):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _check_inputs(q, k, v):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("the attention kernels need CUDA tensors; the plain "
                         "version (chunk_attention) is the CPU path")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"the kernels take q/k/v of one type, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,Sq,H,D] and k, v [B,Sk,H,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")


def _launch(name, q, k, v, causal, scale, kv_offset, wide=None):
    """Run ``csrc/<name>.cu`` on checked inputs its kernel can read in
    place, at their head_dim; returns ``(out, lse)``.  ``wide`` picks the
    wide route; by default it takes a head_dim wider than the kernel's
    widest tile.  The wide route runs over ``_wide_splits`` key ranges."""
    b, sq, h, d = q.shape
    if wide is None:
        wide = d > _HEAD_DIMS[name][-1]
    sk = k.shape[1]
    splits = (_wide_splits(name, b, h, sq, sk, d, causal, kv_offset,
                           sm_count=_sm_count(q.device)) if wide else 1)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 12)(
        *(s for x in (q, k, v, out) for s in x.stride()[:3]))
    lib = _kernel_lib(name)
    shape = (b, sq, sk, h, d, ctypes.cast(strides, ctypes.c_void_p),
             int(bool(causal)), int(kv_offset), float(scale), int(wide), splits)
    dtype_code = (_DTYPE_CODES[q.dtype],) if name == "flash_attn_fwd" else ()
    nbytes = getattr(lib, f"tos_{name}_scratch_bytes")(b, sq, sk, h, d, int(wide), splits)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=q.device) if nbytes else None
    _run(name, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
         lse.data_ptr(), scratch.data_ptr() if nbytes else None, *shape, *dtype_code)
    return out, lse


def _run(name, device, *args):
    """Launch ``tos_<name>(*args, stream)`` on ``device``'s current
    stream, raise if the C function returns a CUDA error, and count the
    launch (``LAUNCHES`` and the kernel's telemetry counter): the one place
    every kernel is launched and counted.  Scratch the caller allocated is
    freed once the launch is queued: the caching allocator hands the block
    out again only to work queued later on this stream."""
    lib = _kernel_lib(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"tos_{name}")(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    # every kernel's launches, as node processes report them to
    # cluster.metrics(): the forward's kernels on one counter, the
    # backward's on another
    telemetry.counter("attn.flash_bwd_launches" if name in BWD_KERNELS
                      else "attn.flash_fwd_launches").inc()


def flash_attn_fwd_cuda(q, k, v, *, causal: bool = True,
                        sm_scale: float | None = None, kv_offset: int = 0):
    """Run attention on the card's kernels; returns ``(out, lse)``.  Inputs
    are CUDA tensors of one type (bf16, fp16 or f32), any head_dim; another
    type, or tensors off the card, raise.

    ``_route`` picks the kernel and the head_dim it runs at: the head_dim
    itself where its rows are whole ``TMA_ROW_BYTES`` (bf16/fp16 a
    multiple of 8, f32 of 4), and then nothing is padded or copied, the
    operands are read in place where the kernel can, and O comes back
    contiguous as the kernel wrote it.  Another head_dim is zero-padded
    along D to the next whole row (zero columns change neither Q Kᵀ nor
    the first head_dim columns of P V; ``sm_scale`` defaults to ``1/sqrt``
    of the unpadded head_dim) and O sliced back.  One call is one launch of
    the kernel (``LAUNCHES[kernel]`` counts it); what the kernel refuses
    raises."""
    _check_inputs(q, k, v)
    d = q.shape[-1]
    name, padded = _route(q.dtype, d)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    if padded != d:
        q, k, v = (torch.nn.functional.pad(x, (0, padded - d)) for x in (q, k, v))
    q, k, v = _kernel_operand(q), _kernel_operand(k), _kernel_operand(v)
    out, lse = _launch(name, q, k, v, causal, scale, kv_offset)
    return (out[..., :d] if padded != d else out), lse


# ---------------------------------------------------------------------------
# The operator: tos::flash_attn_fwd, the kernels on a CUDA tensor and the
# plain version on a CPU tensor, with a fake implementation, so that
# torch.export traces the kernel's call into the graph.
# ---------------------------------------------------------------------------

OP_NAME = "tos::flash_attn_fwd"


@torch.library.custom_op(
    OP_NAME, mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, bool causal, float? sm_scale, "
           "int kv_offset) -> (Tensor, Tensor)")
def flash_attn_fwd_op(q, k, v, causal, sm_scale, kv_offset):
    """``(out, lse)`` of attention as one operator.  On a CPU tensor it is
    the plain version (``chunk_attention``); on a CUDA tensor it launches
    the kernel ``_route`` picks (``flash_attn_fwd_cuda``) or raises.  Its
    fake implementation gives the shapes without running anything, so a
    traced or exported graph holds the call itself.  Registering it builds
    nothing: the kernels build at their first launch.  Both
    implementations return a contiguous ``out``, as the fake one does
    (``opcheck`` compares strides)."""
    out, lse = chunk_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                               kv_offset=kv_offset)
    return out.contiguous(), lse


@flash_attn_fwd_op.register_kernel("cuda")
def _flash_attn_fwd_op_cuda(q, k, v, causal, sm_scale, kv_offset):
    # O at a head dim of whole 16-byte rows is contiguous as the kernel
    # wrote it and is returned as it is (.contiguous() copies nothing); only
    # a head dim padded to whole rows comes back as a slice of the padded O
    # and is copied out, because the fake implementation's strides are
    # contiguous
    out, lse = flash_attn_fwd_cuda(q, k, v, causal=causal, sm_scale=sm_scale,
                                   kv_offset=kv_offset)
    return out.contiguous(), lse


@flash_attn_fwd_op.register_fake
def _flash_attn_fwd_op_fake(q, k, v, causal, sm_scale, kv_offset):
    b, sq, h, _ = q.shape
    return (q.new_empty((b, sq, h, v.shape[-1])),
            q.new_empty((b, sq, h), dtype=torch.float32))


# ---------------------------------------------------------------------------
# The backward: tos::flash_attn_bwd, the FA2 gradient from the saved lse —
# on a CUDA tensor up to D=128 csrc/flash_attn_bwd.cu (bf16/fp16) or
# csrc/flash_attn_bwd_tf32.cu (f32, 3xTF32), flash_attn_bwd_reference on a
# CPU tensor.
# ---------------------------------------------------------------------------

BWD_BLOCK_K = 512  # key block of the plain backward and of the recompute VJP (the JAX default)
# the backward kernels' tiles (both kernels'): a head dim runs on the
# narrowest that holds it, its columns past D zero (launch_bwd_tile)
BWD_HEAD_DIMS = (32, 64, 96, 128)
# the rows a CTA of the backward kernels holds (their kBwdCtaRows), two
# consumer warpgroups of BWD_WG_ROWS (kBwdWgRows) each: the dK/dV kernel's
# 128 key rows walk the query rows in tiles of bwd_inner_rows; the Δ and dQ
# kernels' 128 query rows walk the keys in tiles of as many rows
BWD_CTA_ROWS = 128
BWD_WG_ROWS = 64


def bwd_inner_rows(tile: int) -> int:
    """Rows of the loop tile of the backward kernels at tile width ``tile``
    (``BwdTile<DT>::kInner``: the dK/dV kernel's query tile, the Δ and dQ
    kernels' key tile): 64 on every tile."""
    return 64


# the f32 kernels (csrc/flash_attn_bwd_tf32.cu, 3xTF32 wgmma): a CTA of
# BWD_TF32_CTA_ROWS rows (kCtaRows), each of its two consumer warpgroups
# running its share of a tile's products over all of them
# (BWD_TF32_WG_ROWS, kWgRows)
BWD_TF32_CTA_ROWS = 64
BWD_TF32_WG_ROWS = 64


def bwd_tiling(name: str, tile: int) -> tuple[int, int, int]:
    """``(CTA rows, rows a consumer owns, loop tile rows)`` of backward
    kernel ``name`` on its tile of ``tile`` columns: the bf16/fp16 kernels'
    two warpgroups of 64 rows and 64-row loop tiles; the f32 kernels' CTA
    of 64 rows that both consumers span, and loop tiles of 64 rows up to 64
    columns, 32 above (``Tf32BwdTile<DT>::kInner``)."""
    if name == "flash_attn_bwd":
        return BWD_CTA_ROWS, BWD_WG_ROWS, bwd_inner_rows(tile)
    return BWD_TF32_CTA_ROWS, BWD_TF32_WG_ROWS, 64 if tile <= 64 else 32


def bwd_tf32_scratch_floats(b: int, sq: int, sk: int, h: int, d: int) -> int:
    """Floats of scratch the f32 kernels need at head dim ``d`` (a multiple
    of 4; the layout ``tos_flash_attn_bwd_tf32`` reads): Δ and lse·log2(e)
    (``bwd_scratch_rows(sq)`` rows each), each head's mean key and value,
    and the pre-pass's planes: K − m_k, V − m_v and their lo parts
    (``sk`` rows each), the lo parts of q and the ``out`` cotangent
    (``sq`` rows each)."""
    bh = b * h
    return 2 * bh * bwd_scratch_rows(sq) + 2 * bh * d + bh * d * (4 * sk + 2 * sq)


def bwd_scratch_rows(sq: int) -> int:
    """Rows of the backward's Δ and lse·log2(e) scratch per batch*head
    (``scratch_rows`` in ``csrc/flash_attn_bwd.cu`` and
    ``csrc/flash_attn_bwd_tf32.cu``): ``sq`` rounded up to whole CTAs of the
    bf16/fp16 Δ kernel, which writes every row the dK/dV kernel's query
    tiles read."""
    return -(-max(sq, 1) // BWD_CTA_ROWS) * BWD_CTA_ROWS


def _bwd_route(dtype: torch.dtype, d: int) -> tuple[str, int]:
    """``(backward, head_dim it runs at)`` for inputs of ``dtype`` with
    head_dim ``d``, by type and head dim alone: a head dim that, rounded up
    to whole ``TMA_ROW_BYTES`` rows as ``_route`` rounds it, is at most
    ``BWD_HEAD_DIMS``' widest goes to the kernels, bf16/fp16 to
    ``"flash_attn_bwd"``, f32 to ``"flash_attn_bwd_tf32"``; wider heads to
    the recompute VJP through ``blockwise_attention`` (``"recompute"``, at
    ``d`` itself), the JAX package's own backward."""
    if dtype in (torch.bfloat16, torch.float16, torch.float32) and d >= 1:
        row = TMA_ROW_BYTES // dtype.itemsize
        padded = -(-d // row) * row
        if padded <= BWD_HEAD_DIMS[-1]:
            return ("flash_attn_bwd_tf32" if dtype == torch.float32
                    else "flash_attn_bwd"), padded
    return "recompute", d


def flash_attn_bwd_reference(q, k, v, lse, g_out, g_lse, *, causal: bool = True,
                             sm_scale: float | None = None, kv_offset: int = 0):
    """``(dq, dk, dv)`` of attention from the forward's saved ``lse`` and
    the cotangents of ``out`` and ``lse``: the FA2 backward in plain
    PyTorch, in f32 over key blocks of ``BWD_BLOCK_K`` (memory
    O(Sq·block)), cast to the inputs' types — the plain version of
    ``csrc/flash_attn_bwd.cu`` and ``csrc/flash_attn_bwd_tf32.cu``.

    Per block ``P = exp(S·scale − lse)``, 0 where the mask drops a key or
    the row is fully masked (``lse ≤ NEG_INF/2``, so such a row gets zero
    gradients), and ``dP = dO Vᵀ``; ``Δ = rowsum(P ∘ dP) − g_lse``
    (``∂lse/∂s = P``: the ``lse`` cotangent folds in here) over a first
    pass of the blocks; then ``dV = Pᵀ dO``, ``dS = P ∘ (dP − Δ)``,
    ``dQ = scale · dS K``, ``dK = scale · dSᵀ Q``.  A ``None`` cotangent
    counts as zero.  ``rowsum(P ∘ dP)`` is ``rowsum(dO ∘ O)`` (FA2's Δ)
    for the exact O; FA2's form over the forward's stored O is not used,
    because that O is rounded to its type (bf16: 2^-9 of ``|dO||O|``) and
    the error breaks ``Σ_j dS_ij = 0``, which dQ needs where the keys share
    a large common component (a trained LM's do)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    qf, kf, vf = q.float(), k.float(), v.float()
    gof = None if g_out is None else g_out.float()
    lse_t = lse.float().transpose(1, 2)[..., None]                   # [B,H,Sq,1]
    live = lse_t > NEG_INF / 2
    qpos = torch.arange(sq, device=q.device)[:, None]

    def block(start):
        """P and dP (None without an ``out`` cotangent) of the keys from
        ``start``."""
        kc = kf[:, start:start + BWD_BLOCK_K]
        keep = live
        if causal:
            kpos = kv_offset + start + torch.arange(kc.shape[1], device=q.device)
            keep = keep & (kpos[None, :] <= qpos)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kc) * scale
        p = torch.where(keep, torch.exp(torch.where(keep, s - lse_t, 0.0)), 0.0)
        dp = (None if gof is None else
              torch.einsum("bqhd,bkhd->bhqk", gof, vf[:, start:start + BWD_BLOCK_K]))
        return kc, p, dp

    delta = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    if gof is not None:
        for start in range(0, sk, BWD_BLOCK_K):
            _, p, dp = block(start)
            delta += (p * dp).sum(-1, keepdim=True)
    if g_lse is not None:
        delta -= g_lse.float().transpose(1, 2)[..., None]
    dq = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, sk, h, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros((b, sk, h, d), dtype=torch.float32, device=q.device)
    for start in range(0, sk, BWD_BLOCK_K):
        kc, p, dp = block(start)
        if gof is not None:
            dv[:, start:start + BWD_BLOCK_K] = torch.einsum("bhqk,bqhd->bkhd", p, gof)
            ds = p * (dp - delta)
        else:
            ds = p * -delta
        dq += torch.einsum("bhqk,bkhd->bqhd", ds, kc)
        dk[:, start:start + BWD_BLOCK_K] = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    return (dq.mul_(scale).to(q.dtype), dk.mul_(scale).to(k.dtype), dv.to(v.dtype))


def flash_attn_bwd_cuda(q, k, v, lse, g_out, g_lse, *, causal: bool = True,
                        sm_scale: float | None = None, kv_offset: int = 0):
    """``(dq, dk, dv)`` on the card's backward kernels: CUDA tensors with a
    head dim ``_bwd_route`` sends to them (up to 128), bf16/fp16 on
    ``csrc/flash_attn_bwd.cu``, f32 on ``csrc/flash_attn_bwd_tf32.cu``
    (3xTF32); anything else raises.

    One call is one launch (``LAUNCHES`` of the route's kernel) of the C
    entry, which queues its kernels: the Δ pass, dK/dV and dQ (f32: after
    pre-passes of each head's mean key and value, and of the centred keys
    and values and the operands' lo parts, into the scratch).  q, k, v and
    the ``out`` cotangent are read in place through their strides where the
    kernels can (``_kernel_operand``); a head dim not of whole 16-byte rows
    is zero-padded to them (zero columns change no product) and the
    gradients sliced back.  A ``None`` ``out`` cotangent is read as zeros,
    a ``None`` ``lse`` cotangent is skipped.  The gradients come
    back contiguous in the inputs' type."""
    _check_inputs(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    name, padded = _bwd_route(q.dtype, d)
    if name not in BWD_KERNELS:
        raise ValueError(f"the backward kernels take bf16/fp16/f32 with a head dim up "
                         f"to {BWD_HEAD_DIMS[-1]}, got {q.dtype} D={d}")
    wants = ((lse, (b, sq, h)), (g_out, q.shape), (g_lse, (b, sq, h)))
    if any(x is not None and (x.shape != shape or x.device != q.device)
           for x, shape in wants):
        raise ValueError("lse and the cotangents of out and lse must match q "
                         f"{tuple(q.shape)} on {q.device}, got "
                         + ", ".join(str(None if x is None else (tuple(x.shape), x.device))
                                     for x, _ in wants))
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    g_out = torch.zeros_like(q) if g_out is None else g_out.to(q.dtype)
    xs = (q, k, v, g_out)
    if padded != d:
        xs = tuple(torch.nn.functional.pad(x, (0, padded - d)) for x in xs)
    q_, k_, v_, do_ = (_kernel_operand(x) for x in xs)
    lse = lse.float().contiguous()
    g_lse = None if g_lse is None else g_lse.float().contiguous()
    dq = torch.empty((b, sq, h, padded), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, h, padded), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, sk, h, padded), dtype=q.dtype, device=q.device)
    # Δ and lse·log2(e), f32 [B*H, bwd_scratch_rows(Sq)] each; the f32
    # kernels' heads' mean keys and values and the pre-pass's planes after
    # them (bwd_tf32_scratch_floats)
    floats = (bwd_tf32_scratch_floats(b, sq, sk, h, padded) if name == "flash_attn_bwd_tf32"
              else 2 * b * h * bwd_scratch_rows(sq))
    scratch = torch.empty(floats, dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 21)(
        *(s for x in (q_, k_, v_, do_, dq, dk, dv) for s in x.stride()[:3]))
    dtype_code = (_DTYPE_CODES[q.dtype],) if name == "flash_attn_bwd" else ()
    _run(name, q.device, q_.data_ptr(), k_.data_ptr(), v_.data_ptr(),
         do_.data_ptr(), lse.data_ptr(), None if g_lse is None else g_lse.data_ptr(),
         dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
         b, sq, sk, h, padded, ctypes.cast(strides, ctypes.c_void_p),
         int(bool(causal)), int(kv_offset), float(scale), *dtype_code)
    if padded != d:
        return tuple(x[..., :d].contiguous() for x in (dq, dk, dv))
    return dq, dk, dv


BWD_OP_NAME = "tos::flash_attn_bwd"


@torch.library.custom_op(
    BWD_OP_NAME, mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, Tensor lse, Tensor? g_out, Tensor? g_lse, "
           "bool causal, float? sm_scale, int kv_offset) -> (Tensor, Tensor, Tensor)")
def flash_attn_bwd_op(q, k, v, lse, g_out, g_lse, causal, sm_scale, kv_offset):
    """``(dq, dk, dv)`` of attention as one operator, from the forward's
    ``lse`` and the cotangents of ``out`` and ``lse`` (either may be
    None).  On a
    CPU tensor it is the plain version (``flash_attn_bwd_reference``); on
    a CUDA tensor it launches the backward kernels
    (``flash_attn_bwd_cuda``) or raises.  Its fake implementation gives
    the shapes without running anything.  Every implementation returns
    contiguous gradients in the inputs' types."""
    return flash_attn_bwd_reference(q, k, v, lse, g_out, g_lse, causal=causal,
                                    sm_scale=sm_scale, kv_offset=kv_offset)


@flash_attn_bwd_op.register_kernel("cuda")
def _flash_attn_bwd_op_cuda(q, k, v, lse, g_out, g_lse, causal, sm_scale, kv_offset):
    return flash_attn_bwd_cuda(q, k, v, lse, g_out, g_lse, causal=causal,
                               sm_scale=sm_scale, kv_offset=kv_offset)


@flash_attn_bwd_op.register_fake
def _flash_attn_bwd_op_fake(q, k, v, lse, g_out, g_lse, causal, sm_scale, kv_offset):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


# ---------------------------------------------------------------------------
# Public entry.
# ---------------------------------------------------------------------------


def _forward(q, k, v, causal, sm_scale, kv_offset, impl):
    if impl == "kernel":
        _check_inputs(q, k, v)
    return torch.ops.tos.flash_attn_fwd(q, k, v, causal, sm_scale, kv_offset)


class FlashAttention(torch.autograd.Function):
    """``(out, lse)`` of the forward, with its backward — the counterpart
    of ``_flash_attention_tpu`` and its rules
    (``tensorflowonspark_tpu/ops/attention.py:283-312``).

    Forward: ``tos::flash_attn_fwd``, the kernel for a CUDA tensor,
    ``chunk_attention`` for a CPU tensor; it saves ``q, k, v`` and ``lse``.
    Backward, through ``out`` and through ``lse`` (ring attention merges
    chunks by their ``lse``, and ``d lse / d logits`` is the row's
    softmax): ``tos::flash_attn_bwd`` where ``_bwd_route`` gives the
    kernels (bf16/fp16 and f32 up to D=128) or the tensors lie on the CPU
    (its plain version); otherwise, on the card, the JAX package's own
    backward, the VJP of ``blockwise_attention`` (``block_k=BWD_BLOCK_K``,
    the same ``causal``, ``sm_scale`` and ``kv_offset``, each block
    checkpointed, so its memory is O(Sq·block_k)).  With no cotangent at
    all it returns no gradients and launches nothing."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, kv_offset, impl):
        out, lse = _forward(q, k, v, causal, sm_scale, kv_offset, impl)
        ctx.save_for_backward(q, k, v, lse)
        ctx.args = (causal, sm_scale, kv_offset)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        if g_out is None and g_lse is None:
            return None, None, None, None, None, None, None
        causal, sm_scale, kv_offset = ctx.args
        q, k, v, lse = ctx.saved_tensors
        if q.is_cuda and _bwd_route(q.dtype, q.shape[-1])[0] == "recompute":
            dq, dk, dv = _recompute_bwd(q, k, v, g_out, g_lse, causal, sm_scale,
                                        kv_offset)
        else:
            dq, dk, dv = torch.ops.tos.flash_attn_bwd(q, k, v, lse, g_out, g_lse,
                                                      causal, sm_scale, kv_offset)
        return dq, dk, dv, None, None, None, None


def _recompute_bwd(q, k, v, g_out, g_lse, causal, sm_scale, kv_offset):
    """The VJP of ``blockwise_attention`` through ``out`` and ``lse`` (the
    JAX package's ``_flash_bwd_rule``): heads above the backward kernels'
    widest, on the card."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    with torch.enable_grad():
        out, lse = blockwise_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                                       block_k=BWD_BLOCK_K, kv_offset=kv_offset,
                                       return_lse=True)
        pairs = [(t, g) for t, g in ((out, g_out), (lse, g_lse)) if g is not None]
        # v is unused when only lse has a cotangent
        return torch.autograd.grad([t for t, _ in pairs], (q, k, v),
                                   [g for _, g in pairs], allow_unused=True)


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        sm_scale: float | None = None, kv_offset: int = 0,
                        impl: str | None = None):
    """Attention forward returning ``(out, lse)``.

    ``impl=None`` picks by device: the kernel for a CUDA tensor, the plain
    version (``chunk_attention``) for a CPU tensor.  ``impl="kernel"``
    forces the kernel, which raises on a CPU tensor.  When autograd records
    the call (grad enabled and an input that requires grad), it goes
    through ``FlashAttention``; otherwise (inference) the forward runs
    alone.
    """
    if impl not in (None, "kernel"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, sm_scale, kv_offset, impl)
    return _forward(q, k, v, causal, sm_scale, kv_offset, impl)


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: float | None = None, kv_offset: int = 0,
                    impl: str | None = None):
    """Multi-head attention, ``[B, S, H, D]`` in and out (see
    ``flash_attention_fwd`` for ``impl``)."""
    return flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                               kv_offset=kv_offset, impl=impl)[0]
