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
- ``flash_attention`` / ``flash_attention_fwd`` — the public entry.  A CUDA
  tensor goes to the kernels (through ``flash_attn_fwd_cuda``), a CPU
  tensor to the plain version.  ``_route`` picks the kernel for every head
  dim, zero-padding D as the TPU kernel pads to 128 lanes: bf16/fp16 runs
  the ``wgmma`` kernel (``csrc/flash_attn_fwd.cu``) at 64, 128 or 256, and
  above 256 its wide route; f32 runs the 3xTF32 ``wgmma`` kernel
  (``csrc/flash_attn_fwd_tf32.cu``) at 64 or 128, and above 128 its wide
  route.  A wide route puts O's columns in slices of 256 across CTAs, each
  recomputing Q Kᵀ, with D padded to a multiple of 128 (as the TPU kernel
  pads it).  Only a type the kernels do not take raises.
  ``LAUNCHES`` counts each kernel's launches.  A CUDA tensor whose kernel
  fails to build or launch raises: nothing falls back.
  When autograd records the call, it goes through ``FlashAttention``, the
  counterpart of the JAX package's ``custom_vjp`` ``_flash_attention_tpu``:
  the same forward, and a backward that recomputes through
  ``blockwise_attention`` from the saved ``q, k, v`` (there is no backward
  kernel, in the reference either).

All softmax accumulation is float32 whatever the input type.
"""

from __future__ import annotations

import ctypes
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
                        kv_offset: int = 0):
    """Online-softmax attention as a loop over key blocks: memory stays
    O(Sq·block_k) instead of O(Sq·Sk).

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
    o = o / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return o.to(q.dtype)


# ---------------------------------------------------------------------------
# The kernels: csrc/flash_attn_fwd.cu and csrc/flash_attn_fwd_tf32.cu, bound
# through ctypes.
# ---------------------------------------------------------------------------

KERNEL_HEAD_DIMS = (64, 128, 256)  # the wgmma kernel's head dims (bf16/fp16)
TF32_HEAD_DIMS = (64, 128)         # the 3xTF32 wgmma kernel's head dims (f32)
# above these the kernels' wide routes: O's columns in slices across CTAs,
# Q Kᵀ streamed in chunks of the head dim, D padded to a multiple of
# WIDE_PAD_TO
_HEAD_DIMS = {"flash_attn_fwd": KERNEL_HEAD_DIMS,
              "flash_attn_fwd_tf32": TF32_HEAD_DIMS}
WIDE_PAD_TO = 128
_DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1}  # the wgmma kernel's
_LIBS: dict = {}
# C signatures: tos_<name>(q, k, v, o, lse, [scratch,] B, Sq, Sk, H, D,
# strides, causal, kv_offset, sm_scale, wide, [dtype,] stream): the 3xTF32
# kernel takes a scratch pointer, the wgmma kernel a dtype code
_SHAPE_ARGS = ([ctypes.c_int] * 5
               + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                  ctypes.c_int])
_ARGTYPES = {
    "flash_attn_fwd": ([ctypes.c_void_p] * 5 + _SHAPE_ARGS
                       + [ctypes.c_int, ctypes.c_void_p]),
    "flash_attn_fwd_tf32": [ctypes.c_void_p] * 6 + _SHAPE_ARGS + [ctypes.c_void_p],
}
# each kernel's launches, by its name in _route; bumped only where _launch
# has launched it
LAUNCHES = dict.fromkeys(_ARGTYPES, 0)


def _route(dtype: torch.dtype, d: int) -> tuple[str, int]:
    """``(kernel, padded head_dim)`` for inputs of ``dtype`` with head_dim
    ``d``: bf16/fp16 to the wgmma kernel at 64, 128 or 256, f32 to the
    3xTF32 kernel at 64 or 128, and a wider head to the same kernel's wide
    route at ``d`` rounded up to ``WIDE_PAD_TO``.  Raises on a type the
    kernels do not take (or a head_dim below 1)."""
    if dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"the kernels take bf16, fp16 or f32, got {dtype}")
    if d < 1:
        raise ValueError(f"head_dim must be at least 1, got {d}")
    name = "flash_attn_fwd_tf32" if dtype == torch.float32 else "flash_attn_fwd"
    dims = _HEAD_DIMS[name]
    if d <= dims[-1]:
        return name, next(p for p in dims if d <= p)
    return name, -(-d // WIDE_PAD_TO) * WIDE_PAD_TO


def _kernel_lib(name: str):
    """Build (first use) and bind ``csrc/<name>.cu`` (``_ARGTYPES``)."""
    if name not in _LIBS:
        from tensorflowonspark_torch.ops.cuda_build import load_library

        lib = load_library(name)
        fn = getattr(lib, f"tos_{name}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        if name == "flash_attn_fwd_tf32":
            lib.tos_flash_attn_fwd_tf32_scratch_bytes.argtypes = [ctypes.c_int] * 6
            lib.tos_flash_attn_fwd_tf32_scratch_bytes.restype = ctypes.c_int64
        _LIBS[name] = lib
    return _LIBS[name]


def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when the kernel's tensor maps can read it in place (unit
    head_dim stride, 16-byte rows, no broadcast dimension, 16-byte aligned
    base), else a contiguous copy."""
    if (x.stride(-1) == 1
            and all(s % 8 == 0 and (s > 0 or n == 1)
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
    place; returns ``(out, lse)``.  ``wide`` picks the wide route; by
    default it takes a head_dim the kernel has no configuration for."""
    b, sq, h, d = q.shape
    if wide is None:
        wide = d not in _HEAD_DIMS[name]
    sk = k.shape[1]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 12)(
        *(s for x in (q, k, v, out) for s in x.stride()[:3]))
    lib = _kernel_lib(name)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr()]
    shape = (b, sq, sk, h, d, ctypes.cast(strides, ctypes.c_void_p),
             int(bool(causal)), int(kv_offset), float(scale), int(wide))
    dtype_code = (_DTYPE_CODES[q.dtype],) if name == "flash_attn_fwd" else ()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if name == "flash_attn_fwd_tf32":
            # freed once the launch is queued: the caching allocator hands
            # the block out again only to work queued later on this stream
            scratch = torch.empty(
                lib.tos_flash_attn_fwd_tf32_scratch_bytes(b, sq, sk, h, d,
                                                          int(wide)),
                dtype=torch.uint8, device=q.device)
            ptrs.append(scratch.data_ptr())
        err = getattr(lib, f"tos_{name}")(*ptrs, *shape, *dtype_code, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    # every kernel's launches, as node processes report them to
    # cluster.metrics()
    telemetry.counter("attn.flash_fwd_launches").inc()
    return out, lse


def flash_attn_fwd_cuda(q, k, v, *, causal: bool = True,
                        sm_scale: float | None = None, kv_offset: int = 0):
    """Run attention on the card's kernels; returns ``(out, lse)``.  Inputs
    are CUDA tensors of one type (bf16, fp16 or f32), any head_dim; another
    type, or tensors off the card, raise.

    ``_route`` picks the kernel and the head_dim it runs at: q, k and v are
    zero-padded along D to it (zero columns change neither Q Kᵀ nor the
    first head_dim columns of P V; ``sm_scale`` defaults to ``1/sqrt`` of
    the unpadded head_dim), read in place where the kernel can, launched
    (``LAUNCHES[kernel]`` counts it), and O is sliced back."""
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
# Public entry.
# ---------------------------------------------------------------------------

BWD_BLOCK_K = 512  # key block of the recompute backward (the JAX default)


def _forward(q, k, v, causal, sm_scale, kv_offset, impl):
    if impl == "kernel" or q.is_cuda:
        return flash_attn_fwd_cuda(q, k, v, causal=causal, sm_scale=sm_scale,
                                   kv_offset=kv_offset)
    return chunk_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                           kv_offset=kv_offset)


class FlashAttention(torch.autograd.Function):
    """``(out, lse)`` of the forward, with a recompute backward — the
    counterpart of ``_flash_attention_tpu`` and its rules
    (``tensorflowonspark_tpu/ops/attention.py:283-312``).

    Forward: the kernel for a CUDA tensor, ``chunk_attention`` for a CPU
    tensor; it saves only ``q, k, v``.  Backward: the VJP of
    ``blockwise_attention`` with ``block_k=BWD_BLOCK_K`` and the same
    ``causal``, ``sm_scale`` and ``kv_offset``, each block checkpointed, so
    its memory is O(Sq·block_k).  ``lse`` carries no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, kv_offset, impl):
        out, lse = _forward(q, k, v, causal, sm_scale, kv_offset, impl)
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, sm_scale, kv_offset)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, _g_lse):
        causal, sm_scale, kv_offset = ctx.args
        q, k, v = (x.detach().requires_grad_() for x in ctx.saved_tensors)
        with torch.enable_grad():
            out = blockwise_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                                      block_k=BWD_BLOCK_K, kv_offset=kv_offset)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), g_out)
        return dq, dk, dv, None, None, None, None


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
