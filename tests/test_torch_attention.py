"""Port attention (``tensorflowonspark_torch.ops.attention``) against the JAX
package's: plain versions against ``mha_reference`` and the Pallas kernel in
interpret mode (CPU, f32, atol/rtol 1e-5), at the head dims the kernels
take; the kernel routing table; and the kernels' arithmetic emulated in
torch — the f32 kernel's 3xTF32, and both kernels' wide routes (Q Kᵀ
summed over the kernels' chunks of the head dim, O in slices of 256) —
against the same
references.  The kernels are held
against their plain version on the card in ``tests/test_torch_cuda.py``."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_torch.ops import attention as ta
from tensorflowonspark_tpu.ops import attention as ja

TOL = dict(atol=1e-5, rtol=1e-5)


def make_qkv(b=2, s=64, h=4, d=16, sk=None, seed=0):
    rng = np.random.RandomState(seed)
    sk = s if sk is None else sk
    return (rng.randn(b, s, h, d).astype(np.float32),
            rng.randn(b, sk, h, d).astype(np.float32),
            rng.randn(b, sk, h, d).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


# (b, sq, h, d, sk, causal, kv_offset): the cases of tests/test_ops_attention.py
CASES = {
    "causal": (1, 48, 2, 16, None, True, 0),
    "noncausal": (1, 48, 2, 16, None, False, 0),
    "cross_20_52": (1, 20, 2, 8, 52, False, 0),
    "cross_20_52_causal": (1, 20, 2, 8, 52, True, 0),
    "kv_offset": (1, 16, 2, 8, 8, True, 4),
    "all_future": (1, 8, 1, 4, None, True, 1000),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_kernel_version_matches_pallas_interpret(case):
    b, s, h, d, sk, causal, off = CASES[case]
    q, k, v = make_qkv(b=b, s=s, h=h, d=d, sk=sk)
    jo, jl = ja._flash_fwd_pallas(*_j(q, k, v), causal=causal, sm_scale=None,
                                  kv_offset=off, block_q=16, block_k=16,
                                  interpret=True)
    to, tl = ta.flash_attention_fwd(*_t(q, k, v), causal=causal, kv_offset=off)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    # the public entry goes through the same dispatcher
    jp = ja.flash_attention(*_j(q, k, v), causal=causal, kv_offset=off,
                            block_q=16, block_k=16, impl="pallas_interpret")
    tp = ta.flash_attention(*_t(q, k, v), causal=causal, kv_offset=off)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)


# (b, sq, h, d, sk, causal, kv_offset): the head dims the card's kernels
# take besides 64 and 128 — 32 and 96 zero-padded (to 64 / 128), 256 on
# the wgmma kernel's D=256 configuration (bf16/fp16) and the 3xTF32 kernel's
# wide route (f32) — at ragged lengths and a nonzero kv_offset
HEAD_DIM_CASES = {
    "d32_ragged_causal_offset": (2, 20, 2, 32, 37, True, 5),
    "d96_noncausal": (1, 24, 2, 96, 40, False, 0),
    "d96_causal": (1, 33, 2, 96, None, True, 0),
    "d256_causal_offset": (1, 17, 1, 256, 30, True, 9),
}


@pytest.mark.parametrize("case", sorted(HEAD_DIM_CASES))
def test_plain_version_at_the_kernels_head_dims_matches_jax(case):
    b, s, h, d, sk, causal, off = HEAD_DIM_CASES[case]
    q, k, v = make_qkv(b=b, s=s, h=h, d=d, sk=sk, seed=2)
    jo, jl = ja._flash_fwd_pallas(*_j(q, k, v), causal=causal, sm_scale=None,
                                  kv_offset=off, block_q=8, block_k=8,
                                  interpret=True)
    to, tl = ta.flash_attention_fwd(*_t(q, k, v), causal=causal, kv_offset=off)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    ref = np.asarray(ja.mha_reference(*_j(q, k, v), causal=causal, kv_offset=off))
    seen = tl.numpy() > ta.NEG_INF / 2  # rows that see a key (see above)
    assert seen.any()
    np.testing.assert_allclose(to.numpy()[seen], ref[seen], **TOL)


@pytest.mark.parametrize("d, padded", [(32, 64), (96, 128), (80, 128),
                                       (160, 256), (192, 256), (33, 64),
                                       (257, 384), (448, 512)])
def test_zero_padding_the_head_dim_changes_nothing(d, padded):
    """What ``flash_attn_fwd_cuda`` does for a head_dim the tensor-core
    kernels lack (to 64, 128 or 256, and on the wide routes to a multiple
    of 128, ``_route``): zero
    columns change neither Q Kᵀ nor the first d columns of P V, so
    attention over inputs padded along D, at the unpadded ``1/sqrt(d)``
    scale and sliced back, is attention over the inputs."""
    q, k, v = _t(*make_qkv(b=2, s=24, h=2, d=d, sk=31, seed=3))
    pad = [torch.nn.functional.pad(x, (0, padded - d)) for x in (q, k, v)]
    po, pl = ta.chunk_attention(*pad, causal=True, kv_offset=3,
                                sm_scale=1.0 / d ** 0.5)
    o, lse = ta.chunk_attention(q, k, v, causal=True, kv_offset=3)
    assert not po[..., d:].any()
    np.testing.assert_allclose(po[..., :d].numpy(), o.numpy(), **TOL)
    np.testing.assert_allclose(pl.numpy(), lse.numpy(), **TOL)


# _route(dtype, head_dim) -> (kernel, padded head_dim): bf16/fp16 on the
# wgmma kernel at 64, 128 or 256 and above 256 on its wide route; f32 on the
# 3xTF32 kernel at 64 or 128 and above 128 on its wide route.  A wide route
# runs at a multiple of 128, as the TPU kernel pads its head dim.
ROUTES = {
    1: (("flash_attn_fwd", 64), ("flash_attn_fwd_tf32", 64)),
    33: (("flash_attn_fwd", 64), ("flash_attn_fwd_tf32", 64)),
    64: (("flash_attn_fwd", 64), ("flash_attn_fwd_tf32", 64)),
    80: (("flash_attn_fwd", 128), ("flash_attn_fwd_tf32", 128)),
    128: (("flash_attn_fwd", 128), ("flash_attn_fwd_tf32", 128)),
    129: (("flash_attn_fwd", 256), ("flash_attn_fwd_tf32", 256)),
    160: (("flash_attn_fwd", 256), ("flash_attn_fwd_tf32", 256)),
    256: (("flash_attn_fwd", 256), ("flash_attn_fwd_tf32", 256)),
    257: (("flash_attn_fwd", 384), ("flash_attn_fwd_tf32", 384)),
    320: (("flash_attn_fwd", 384), ("flash_attn_fwd_tf32", 384)),
    448: (("flash_attn_fwd", 512), ("flash_attn_fwd_tf32", 512)),
    512: (("flash_attn_fwd", 512), ("flash_attn_fwd_tf32", 512)),
    1000: (("flash_attn_fwd", 1024), ("flash_attn_fwd_tf32", 1024)),
}


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("d", sorted(ROUTES))
def test_route_table(d, dtype):
    half, f32 = ROUTES[d]
    assert ta._route(getattr(torch, dtype), d) == (f32 if dtype == "float32" else half)


@pytest.mark.parametrize("dtype", ["float64", "int32"])
def test_route_refuses_only_types_the_kernels_do_not_take(dtype):
    with pytest.raises(ValueError, match="bf16, fp16 or f32"):
        ta._route(getattr(torch, dtype), 64)


def _tf32_hi(x):
    """x with its low 13 mantissa bits cleared: what a .tf32 operand of the
    tensor cores reads."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _tf32_round(x):
    """x rounded to TF32 (10 mantissa bits), to nearest, ties away."""
    return ((x.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def _tf32_matmul(a, b, split: bool):
    """a @ b as the tensor cores compute it from TF32 operands: one product
    of the truncated operands, or (``split``) the kernel's 3xTF32,
    a_lo.b_hi + a_hi.b_lo + a_hi.b_hi with x = hi + lo, lo = tf32(x - hi)."""
    ah, bh = _tf32_hi(a), _tf32_hi(b)
    if not split:
        return ah @ bh
    al, bl = _tf32_round(a - ah), _tf32_round(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _emulated_attention(q, k, v, *, causal, kv_offset, sm_scale, qk, pv,
                        block_k, chunk=None, slice_cols=None):
    """A kernel's arithmetic in torch: key blocks of ``block_k``, S = Q Kᵀ
    through ``qk`` (summed over ``chunk``-column pieces of the head dim in
    order, as the wide routes stream it), the kernels' online softmax (exp2
    with the scale folded in, the NEG_INF guards) and O += ``pv(P, V)``;
    with ``slice_cols``, O in slices of that many columns, each slice
    running the whole loop again as a CTA of the wide route does, and lse
    from slice 0.  Returns ``(out, lse)`` like ``chunk_attention``, in f32."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    c = math.log2(math.e) * sm_scale
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # [B, H, S, D]
    neg = ta.NEG_INF
    qpos = torch.arange(sq)[:, None]
    chunks = [slice(0, d)] if chunk is None else [
        slice(c0, c0 + chunk) for c0 in range(0, d, chunk)]
    outs, lses = [], []
    for c0 in range(0, d, slice_cols or d):
        cols = slice(c0, c0 + (slice_cols or d))
        m = torch.full((b, h, sq), neg)
        l = torch.zeros((b, h, sq))
        acc = torch.zeros((b, h, sq, vt[..., cols].shape[-1]))
        for k0 in range(0, sk, block_k):
            kc, vc = kt[:, :, k0:k0 + block_k], vt[:, :, k0:k0 + block_k, cols]
            s = 0.0
            for part in chunks:
                s = s + qk(qt[..., part], kc[..., part].transpose(-1, -2))
            if causal:
                kpos = kv_offset + k0 + torch.arange(kc.shape[2])[None, :]
                s = torch.where(kpos <= qpos, s, neg)
            mx = torch.maximum(m, s.amax(-1))
            msafe = torch.clamp(mx, min=neg / 2)
            alpha = torch.where(m <= neg / 2, 0.0, torch.exp2((m - msafe) * c))
            p = torch.exp2(s * c - (msafe * c)[..., None])
            l = l * alpha + p.sum(-1)
            m = mx
            acc = acc * alpha[..., None] + pv(p, vc)
        lsafe = torch.clamp(l, min=1e-30)
        outs.append(acc / lsafe[..., None])
        lses.append(torch.where(l > 0, torch.clamp(m, min=neg / 2) * c * math.log(2)
                                + torch.log(lsafe), neg))
    return torch.cat(outs, -1).transpose(1, 2), lses[0].transpose(1, 2)


def _emulated_tf32_attention(q, k, v, *, causal, kv_offset, sm_scale,
                             split=True, block_k=32, **wide):
    """The arithmetic of ``csrc/flash_attn_fwd_tf32.cu``: key blocks of 32
    (64 on the wide route), each product through ``_tf32_matmul``
    (``wide``: the wide route's chunks and slices)."""
    def mm(a, b):
        return _tf32_matmul(a, b, split)

    return _emulated_attention(q, k, v, causal=causal, kv_offset=kv_offset,
                               sm_scale=sm_scale, qk=mm, pv=mm, block_k=block_k,
                               **wide)


def _emulated_wgmma_attention(q, k, v, *, causal, kv_offset, sm_scale, dtype):
    """The arithmetic of the wide route of ``csrc/flash_attn_fwd.cu`` on
    inputs of ``dtype`` (bf16/fp16): key blocks of 64, exact products of the
    16-bit operands summed in f32 over 64-column chunks, P rounded to
    ``dtype`` for P V, O in slices of 256, stored in ``dtype``."""
    out, lse = _emulated_attention(
        *(x.to(dtype).float() for x in (q, k, v)), causal=causal,
        kv_offset=kv_offset, sm_scale=sm_scale, qk=torch.matmul,
        pv=lambda p, vc: p.to(dtype).float() @ vc, block_k=64, chunk=64,
        slice_cols=SLICE_COLS)
    return out.to(dtype), lse


# (b, sq, h, d, sk, causal, kv_offset): the TF32 kernel's head dims, 64 and
# 128, and 33 zero-padded to 64 as the wrapper pads it; ragged key tails
# and offsets that cut key blocks
TF32_CASES = {
    "d128_causal": (1, 70, 2, 128, None, True, 0),
    "d128_cross_noncausal": (2, 20, 2, 128, 75, False, 0),
    "d64_kv_offset": (1, 40, 2, 64, 52, True, 9),
    "d64_kv_offset_negative": (1, 17, 2, 64, 60, True, -30),
    "d33_padded": (1, 36, 2, 33, 45, True, 0),
}
# 3xTF32 against the f32 references: each product is good to about 2^-20
# relative (the dropped lo.lo term), so O and lse stay within the f32
# tests' atol/rtol 1e-5 where one TF32 product (2^-11) would not
TF32_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", sorted(TF32_CASES))
def test_emulated_3xtf32_attention_matches_jax_f32(case):
    """The 3xTF32 algorithm of the f32 kernel meets the f32 gate against
    the JAX package's f32 reference (``mha_reference``, and the Pallas
    kernel in interpret mode), while a single TF32 product does not."""
    b, s, h, d, sk, causal, off = TF32_CASES[case]
    q, k, v = make_qkv(b=b, s=s, h=h, d=d, sk=sk, seed=7)
    jo, jl = ja._flash_fwd_pallas(*_j(q, k, v), causal=causal, sm_scale=None,
                                  kv_offset=off, block_q=8, block_k=8,
                                  interpret=True)
    jo, jl = np.asarray(jo), np.asarray(jl)
    tq, tk, tv = _t(q, k, v)
    padded = 64 if d < 64 else d
    if padded != d:  # as the wrapper pads: zeros, at the unpadded scale
        tq, tk, tv = (torch.nn.functional.pad(x, (0, padded - d)) for x in (tq, tk, tv))
    o, lse = _emulated_tf32_attention(tq, tk, tv, causal=causal, kv_offset=off,
                                      sm_scale=d ** -0.5)
    o = o[..., :d]
    np.testing.assert_allclose(o.numpy(), jo, **TF32_TOL)
    np.testing.assert_allclose(lse.numpy(), jl, **TF32_TOL)
    ref = np.asarray(ja.mha_reference(*_j(q, k, v), causal=causal, kv_offset=off))
    seen = lse.numpy() > ta.NEG_INF / 2
    assert seen.any()
    np.testing.assert_allclose(o.numpy()[seen], ref[seen], **TF32_TOL)
    # the split is what buys the precision: one TF32 product misses the gate
    o1, _ = _emulated_tf32_attention(tq, tk, tv, causal=causal, kv_offset=off,
                                     sm_scale=d ** -0.5, split=False)
    assert np.abs(o1[..., :d].numpy() - jo).max() > 10 * TF32_TOL["atol"]


# (b, sq, h, sk, kv_offset) per head dim of the wide routes' test: ragged key
# tails, offsets that cut key blocks (a negative one too); 160 runs padded to
# 256, 320 padded to 384 as slices of 256 + 128, 512 as two slices of 256
WIDE_CASES = {160: (1, 24, 2, 45, 5), 256: (1, 20, 2, 70, 9),
              320: (1, 17, 2, 60, -30), 512: (1, 40, 1, 52, 4)}
# the bf16 tolerance of this file (test_bf16_plain_version_close_to_f32)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)
# the wide routes' slices of O's columns (kSliceCols in both kernels'
# sources; the last slice is 128 where the padded head dim is an odd
# multiple of 128)
SLICE_COLS = 256


def _wide_case(d, causal, dtype=None):
    """Inputs of a wide-route case (rounded to ``dtype`` and back to f32,
    so that the f32 references see what the kernel sees), the JAX Pallas
    kernel's ``(out, lse)`` in interpret mode and ``mha_reference``."""
    b, s, h, sk, off = WIDE_CASES[d]
    q, k, v = make_qkv(b=b, s=s, h=h, d=d, sk=sk, seed=8)
    if dtype is not None:
        q, k, v = (torch.from_numpy(x).to(dtype).float().numpy() for x in (q, k, v))
    jo, jl = ja._flash_fwd_pallas(*_j(q, k, v), causal=causal, sm_scale=None,
                                  kv_offset=off, block_q=8, block_k=8,
                                  interpret=True)
    ref = np.asarray(ja.mha_reference(*_j(q, k, v), causal=causal, kv_offset=off))
    return (q, k, v), off, np.asarray(jo), np.asarray(jl), ref


def _pad_as_routed(dtype, d, *xs):
    """``xs`` zero-padded along D to the head dim ``_route`` runs ``d`` at."""
    padded = ta._route(dtype, d)[1]
    return [torch.nn.functional.pad(x, (0, padded - d)) for x in xs]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", sorted(WIDE_CASES))
def test_emulated_wide_3xtf32_route_matches_jax_f32(d, causal):
    """The f32 wide route — 3xTF32 with Q Kᵀ summed over 32-column chunks in
    the kernel's order and O in slices of 256, each slice recomputing S —
    meets the f32 gate against the JAX package's f32 references."""
    (q, k, v), off, jo, jl, ref = _wide_case(d, causal)
    tq, tk, tv = _pad_as_routed(torch.float32, d, *_t(q, k, v))
    o, lse = _emulated_tf32_attention(tq, tk, tv, causal=causal, kv_offset=off,
                                      sm_scale=d ** -0.5, block_k=64, chunk=32,
                                      slice_cols=SLICE_COLS)
    o = o[..., :d].numpy()
    np.testing.assert_allclose(o, jo, **TF32_TOL)
    np.testing.assert_allclose(lse.numpy(), jl, **TF32_TOL)
    seen = lse.numpy() > ta.NEG_INF / 2
    assert seen.any()
    np.testing.assert_allclose(o[seen], ref[seen], **TF32_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", sorted(WIDE_CASES))
def test_emulated_wide_wgmma_route_matches_jax(d, causal):
    """The bf16 wide route — 16-bit products summed in f32 over 64-column
    chunks, P rounded to bf16, O in slices of 256 stored in bf16 — within
    the bf16 tolerance of the JAX package's f32 references on the same
    (bf16-rounded) inputs; fp16 likewise."""
    for dtype in (torch.bfloat16, torch.float16):
        (q, k, v), off, jo, jl, ref = _wide_case(d, causal, dtype)
        tq, tk, tv = _pad_as_routed(dtype, d, *_t(q, k, v))
        o, lse = _emulated_wgmma_attention(tq, tk, tv, causal=causal, kv_offset=off,
                                           sm_scale=d ** -0.5, dtype=dtype)
        assert o.dtype == dtype
        o = o[..., :d].float().numpy()
        np.testing.assert_allclose(o, jo, **BF16_TOL)
        np.testing.assert_allclose(lse.numpy(), jl, **BF16_TOL)
        seen = lse.numpy() > ta.NEG_INF / 2
        np.testing.assert_allclose(o[seen], ref[seen], **BF16_TOL)


# (b, s, h, d, causal, kv_offset): q, k, v as strided views of one packed
# [B, S, 3, H, D] tensor, the layout the kernel reads in place
PACKED_CASES = {
    "causal": (2, 40, 2, 16, True, 0),
    "noncausal": (1, 33, 3, 8, False, 0),
    "kv_offset": (1, 24, 2, 8, True, 5),
    "kv_offset_negative": (2, 17, 1, 16, True, -7),
}


@pytest.mark.parametrize("case", sorted(PACKED_CASES))
def test_plain_version_on_packed_views_matches_jax(case):
    b, s, h, d, causal, off = PACKED_CASES[case]
    qkv = np.random.RandomState(1).randn(b, s, 3, h, d).astype(np.float32)
    q, k, v = (qkv[:, :, i] for i in range(3))  # numpy copies for JAX
    tqkv = torch.from_numpy(qkv)
    tq, tk, tv = tqkv[:, :, 0], tqkv[:, :, 1], tqkv[:, :, 2]
    assert not tq.is_contiguous() and ta._kernel_operand(tq) is tq
    to, tl = ta.chunk_attention(tq, tk, tv, causal=causal, kv_offset=off)
    jo, jl = ja._flash_fwd_pallas(*_j(q, k, v), causal=causal, sm_scale=None,
                                  kv_offset=off, block_q=8, block_k=8,
                                  interpret=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    # mha_reference spreads a fully masked row uniformly (the chunk contract
    # gives 0 there), so it is the spec only for rows that see a key
    ref = np.asarray(ja.mha_reference(*_j(q, k, v), causal=causal, kv_offset=off))
    seen = tl.numpy() > ta.NEG_INF / 2
    assert seen.any()
    np.testing.assert_allclose(to.numpy()[seen], ref[seen], **TOL)


def test_kernel_operand_copies_only_what_tensor_maps_cannot_read():
    x = torch.zeros((2, 16, 3, 4, 64))
    view = x[:, :, 1]  # 16-element-aligned strides: read in place
    assert ta._kernel_operand(view) is view
    bcast = torch.zeros((1, 16, 4, 64)).expand(3, 16, 4, 64)  # batch stride 0
    assert ta._kernel_operand(bcast).stride(0) == 16 * 4 * 64
    odd = torch.zeros((2, 16, 4, 68))[..., :64]  # rows of 68: not 16-byte strides
    assert ta._kernel_operand(odd).is_contiguous()
    one = torch.zeros((1, 16, 4, 64)).expand(1, 16, 4, 64)  # size-1 dim, any stride
    assert ta._kernel_operand(one) is one


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block_k", [16, 24, 64])
def test_blockwise_and_reference_match_jax(causal, block_k):
    q, k, v = make_qkv()
    ref = np.asarray(ja.mha_reference(*_j(q, k, v), causal=causal))
    np.testing.assert_allclose(
        ta.mha_reference(*_t(q, k, v), causal=causal).numpy(), ref, **TOL)
    np.testing.assert_allclose(
        ta.blockwise_attention(*_t(q, k, v), causal=causal, block_k=block_k).numpy(),
        ref, **TOL)


def test_chunk_merge_equals_full_attention_and_jax():
    q, k, v = make_qkv(b=2, s=64, h=2, d=16)
    cs = 16
    tq, tk, tv = _t(q, k, v)
    o, lse = ta.chunk_attention(tq, tk[:, :cs], tv[:, :cs], causal=True)
    jo, jl = ja.chunk_attention(*_j(q, k[:, :cs], v[:, :cs]), causal=True)
    for i in range(1, 4):
        sl = slice(i * cs, (i + 1) * cs)
        oc, lc = ta.chunk_attention(tq, tk[:, sl], tv[:, sl], causal=True,
                                    kv_offset=i * cs)
        o, lse = ta.merge_attention(o, lse, oc, lc)
        joc, jlc = ja.chunk_attention(*_j(q, k[:, sl], v[:, sl]), causal=True,
                                      kv_offset=i * cs)
        jo, jl = ja.merge_attention(jo, jl, joc, jlc)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(
        o.numpy(), ta.mha_reference(tq, tk, tv, causal=True).numpy(), **TOL)


def test_fully_masked_rows_give_zero_and_neg_inf():
    q, k, v = make_qkv(b=1, s=16, h=2, d=8, sk=8)
    off = 4  # query rows < 4 see no key
    o, lse = ta.flash_attention_fwd(*_t(q, k, v), causal=True, kv_offset=off)
    assert torch.all(lse[:, :off] == ta.NEG_INF)
    assert torch.all(o[:, :off] == 0)
    assert torch.isfinite(o).all()
    o1, l1 = ta.chunk_attention(*_t(q, k, v), causal=True)
    o2, l2 = ta.chunk_attention(*_t(q, k, v), causal=True, kv_offset=1000)
    om, lm = ta.merge_attention(o1, l1, o2, l2)
    np.testing.assert_allclose(om.numpy(), o1.numpy(), atol=1e-6)
    np.testing.assert_allclose(lm.numpy(), l1.numpy(), atol=1e-6)


def test_dispatch_kernel_on_cpu_tensor_raises():
    q, k, v = _t(*make_qkv(b=1, s=8, h=1, d=64))
    with pytest.raises(ValueError, match="CUDA"):
        ta.flash_attention(q, k, v, impl="kernel")
    with pytest.raises(ValueError, match="unknown"):
        ta.flash_attention(q, k, v, impl="bogus")


def test_bf16_plain_version_close_to_f32():
    q, k, v = make_qkv()
    ref = ta.mha_reference(*_t(q, k, v), causal=True)
    out = ta.flash_attention(*[x.bfloat16() for x in _t(q, k, v)], causal=True)
    assert out.dtype == torch.bfloat16
    # bf16 inputs and output: ~3 significant digits
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=3e-2, rtol=3e-2)


# (b, sq, h, d, sk, causal, kv_offset): the recompute backward against
# jax.grad through the Pallas kernel's custom_vjp (interpret mode,
# block_k=16); 40 and 52 keys are not multiples of 16
GRAD_CASES = {
    "causal": (2, 40, 2, 16, None, True, 0),
    "noncausal": (1, 40, 2, 16, None, False, 0),
    "kv_offset": (1, 24, 2, 8, 20, True, 5),
    "kv_offset_negative": (1, 20, 2, 8, 52, True, -7),
    "cross_20_52_noncausal": (2, 20, 2, 8, 52, False, 0),
}
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)  # f32; the two sides sum in other orders


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_attention_grads_match_jax_pallas_interpret(case):
    import jax

    b, s, h, d, sk, causal, off = GRAD_CASES[case]
    q, k, v = make_qkv(b=b, s=s, h=h, d=d, sk=sk, seed=4)
    g = np.random.RandomState(5).randn(*q.shape).astype(np.float32)

    def jloss(q, k, v):
        out = ja.flash_attention(q, k, v, causal=causal, kv_offset=off,
                                 block_q=16, block_k=16, impl="pallas_interpret")
        return (out * g).sum()

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*_j(q, k, v))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out = ta.flash_attention(tq, tk, tv, causal=causal, kv_offset=off)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    (out * torch.from_numpy(g)).sum().backward()
    for tgrad, jgrad in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), **GRAD_TOL)


def test_attention_function_forward_saves_only_qkv_and_inference_skips_it():
    q, k, v = (x.requires_grad_() for x in _t(*make_qkv(b=1, s=24, h=2, d=8)))
    out, lse = ta.flash_attention_fwd(q, k, v, causal=True)
    assert len(out.grad_fn.saved_tensors) == 3
    assert not lse.requires_grad  # lse carries no gradient
    with torch.no_grad():
        o2, l2 = ta.flash_attention_fwd(q, k, v, causal=True)
    assert o2.grad_fn is None
    np.testing.assert_array_equal(o2.numpy(), out.detach().numpy())
    np.testing.assert_array_equal(l2.numpy(), lse.numpy())


@pytest.mark.parametrize("causal", [True, False])
def test_checkpointed_blockwise_grads_match_jax_blockwise(causal):
    """The port's blockwise loop under autograd (each block checkpointed)
    has the JAX scan's gradients, ragged last block included."""
    import jax

    q, k, v = make_qkv(b=1, s=36, h=2, d=8, seed=6)
    jgrads = jax.grad(lambda *a: ja.blockwise_attention(
        *a, causal=causal, block_k=16).sum(), argnums=(0, 1, 2))(*_j(q, k, v))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    ta.blockwise_attention(tq, tk, tv, causal=causal, block_k=16).sum().backward()
    for tgrad, jgrad in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), **GRAD_TOL)
