"""Port attention (``tensorflowonspark_torch.ops.attention``) against the JAX
package's: plain versions against ``mha_reference`` and the Pallas kernel in
interpret mode (CPU, f32, atol/rtol 1e-5), at the head dims the kernels
take; the kernel routing table; and the kernels' arithmetic emulated in
torch — the f32 kernel's 3xTF32, both kernels' tiles at the real head dim
(TMA's zero fill past D, Q Kᵀ over the k-steps that hold real columns, P V
at the tile's width), and both kernels' wide routes (at the
real head dim, Q Kᵀ summed over the kernels' chunks of the head dim in the
two consumer warpgroups' halves and the halves added, split-KV ranges
merged as the combine step merges them) — against the same references.
The kernels are held
against their plain version on the card in ``tests/test_torch_cuda.py``."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_torch.ops import attention as ta
from tensorflowonspark_tpu.ops import attention as ja
from torch_lock_gate import torch_lock_witness_gate  # noqa: F401 - the port's lock-witness gate

TOL = dict(atol=1e-5, rtol=1e-5)
# the SMs of an H100 SXM: the card the wide routes' split rule is pinned on
# here (on a card the rule reads the card's own count, ops.attention._sm_count)
H100_SMS = 132


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
# take besides 64 and 128 — 32, 96 and 192 on tiles of their own, 48, 80
# and 160 on the next tile at the real head dim (TMA's zero fill past D),
# 256 on the wgmma kernel's widest tile (bf16/fp16) and the 3xTF32 kernel's
# wide route (f32) — at ragged lengths and a nonzero kv_offset
HEAD_DIM_CASES = {
    "d32_ragged_causal_offset": (2, 20, 2, 32, 37, True, 5),
    "d48_ragged_noncausal": (1, 19, 2, 48, 41, False, 0),
    "d80_causal_offset": (1, 26, 2, 80, 33, True, 4),
    "d96_noncausal": (1, 24, 2, 96, 40, False, 0),
    "d96_causal": (1, 33, 2, 96, None, True, 0),
    "d160_causal_offset_negative": (1, 15, 1, 160, 29, True, -6),
    "d192_causal_offset": (1, 18, 1, 192, 27, True, 3),
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
                                       (257, 384), (448, 512), (257, 264),
                                       (131, 132)])
def test_zero_padding_the_head_dim_changes_nothing(d, padded):
    """What TMA's zero fill does past D in the kernels' shared memory (a
    head dim on the next tile of 32, 64, 96, 128, 192 or 256 columns, a
    wide route's last box), and what ``flash_attn_fwd_cuda`` does for a
    head dim whose rows are not whole 16-byte rows (padded only to the next
    that is, ``_route``): zero
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


# _route(dtype, head_dim) -> (kernel, head_dim it runs at): bf16/fp16 on
# the wgmma kernel (its tiles up to 256, its wide route above), f32 on the
# 3xTF32 kernel (its tiles up to 128, its wide route above).  Every route
# runs at the real head dim, rounded up only to whole 16-byte rows
# (bf16/fp16 to a multiple of 8, f32 to a multiple of 4).
ROUTES = {
    1: (("flash_attn_fwd", 8), ("flash_attn_fwd_tf32", 4)),
    33: (("flash_attn_fwd", 40), ("flash_attn_fwd_tf32", 36)),
    64: (("flash_attn_fwd", 64), ("flash_attn_fwd_tf32", 64)),
    80: (("flash_attn_fwd", 80), ("flash_attn_fwd_tf32", 80)),
    128: (("flash_attn_fwd", 128), ("flash_attn_fwd_tf32", 128)),
    129: (("flash_attn_fwd", 136), ("flash_attn_fwd_tf32", 132)),
    160: (("flash_attn_fwd", 160), ("flash_attn_fwd_tf32", 160)),
    256: (("flash_attn_fwd", 256), ("flash_attn_fwd_tf32", 256)),
    257: (("flash_attn_fwd", 264), ("flash_attn_fwd_tf32", 260)),
    320: (("flash_attn_fwd", 320), ("flash_attn_fwd_tf32", 320)),
    448: (("flash_attn_fwd", 448), ("flash_attn_fwd_tf32", 448)),
    512: (("flash_attn_fwd", 512), ("flash_attn_fwd_tf32", 512)),
    1000: (("flash_attn_fwd", 1000), ("flash_attn_fwd_tf32", 1000)),
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
                        block_k, parts=None, route=None, splits=1):
    """A kernel's arithmetic in torch: key blocks of ``block_k``, S = Q Kᵀ
    through ``qk`` — with ``parts`` (lists of column slices of the head
    dim), each part summed over its slices in order and the parts' sums
    added in order, as the wide routes' consumer warpgroups each sum their
    half of the head dim and then exchange their partial S — the kernels'
    online softmax (exp2 with the scale folded in, the NEG_INF guards) and
    O += ``pv(P, V)``.  With ``splits`` (on wide route ``route``), each
    query tile's key blocks in the ranges ``ops.attention._tile_ranges``
    gives, each range its own online softmax giving O normalised over its
    keys and its lse, merged where a tile has more than one as the combine
    kernel merges them (lse = log sum exp(lse_s), O = sum exp(lse_s - lse)
    O_s; every range NEG_INF gives O = 0, lse = NEG_INF).  Returns ``(out,
    lse)`` like ``chunk_attention``, in f32."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    c = math.log2(math.e) * sm_scale
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # [B, H, S, D]
    neg = ta.NEG_INF
    parts = [[slice(0, d)]] if parts is None else parts

    def key_range(rows, first, last):
        """(out, lse) of query rows ``rows`` over key blocks [first, last)."""
        qpos = torch.arange(sq)[rows][:, None]
        n = qpos.shape[0]
        m = torch.full((b, h, n), neg)
        l = torch.zeros((b, h, n))
        acc = torch.zeros((b, h, n, d))
        for k0 in range(first * block_k, min(last * block_k, sk), block_k):
            kc, vc = kt[:, :, k0:k0 + block_k], vt[:, :, k0:k0 + block_k]
            s = 0.0
            for part in parts:
                ps = 0.0
                for cols in part:
                    ps = ps + qk(qt[:, :, rows][..., cols], kc[..., cols].transpose(-1, -2))
                s = s + ps
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
        return acc / lsafe[..., None], torch.where(
            l > 0, torch.clamp(m, min=neg / 2) * c * math.log(2) + torch.log(lsafe), neg)

    if splits == 1:
        out, lse = key_range(slice(0, sq), 0, -(-sk // block_k))
        return out.transpose(1, 2), lse.transpose(1, 2)
    outs, lses = [], []
    for q0 in range(0, sq, ta.WIDE_ROWS):
        rows = slice(q0, min(q0 + ta.WIDE_ROWS, sq))
        got = [key_range(rows, *r) for r in ta._tile_ranges(route, splits, q0, sq, sk,
                                                            causal, kv_offset)]
        if len(got) == 1:
            outs.append(got[0][0])
            lses.append(got[0][1])
            continue
        lse_s = torch.stack([g[1] for g in got])
        mx = lse_s.amax(0)
        seen = mx > neg / 2
        total = mx + torch.log(torch.exp(lse_s - mx).sum(0))
        w = torch.where(seen, torch.exp(lse_s - total), 0.0)
        outs.append((w[..., None] * torch.stack([g[0] for g in got])).sum(0))
        lses.append(torch.where(seen, total, neg))
    return torch.cat(outs, 2).transpose(1, 2), torch.cat(lses, 2).transpose(1, 2)


def _wide_parts(d, box, pass_boxes=None):
    """The wide routes' contraction order at head dim ``d``: boxes of
    ``box`` columns (the last one part past D, where TMA fills zeros), split
    between the two consumer warpgroups, the first taking the larger half;
    the bf16 route in passes of ``pass_boxes`` boxes (one pass up to
    D=512), each pass's boxes halved so."""
    nbox = -(-d // box)
    pass_boxes = pass_boxes or nbox
    halves = [[], []]
    for x0 in range(0, nbox, pass_boxes):
        pb = min(pass_boxes, nbox - x0)
        hb = -(-pb // 2)
        for x in range(x0, x0 + pb):
            halves[int(x >= x0 + hb)].append(slice(x * box, min(d, (x + 1) * box)))
    return halves


def _emulated_tf32_attention(q, k, v, *, causal, kv_offset, sm_scale,
                             split=True, block_k=32, **wide):
    """The arithmetic of ``csrc/flash_attn_fwd_tf32.cu``: key blocks of 32,
    each product through ``_tf32_matmul`` (``wide``: the wide route's
    ``parts`` and ``splits``)."""
    def mm(a, b):
        return _tf32_matmul(a, b, split)

    return _emulated_attention(q, k, v, causal=causal, kv_offset=kv_offset,
                               sm_scale=sm_scale, qk=mm, pv=mm, block_k=block_k,
                               **wide)


def _emulated_wide_tf32_attention(q, k, v, *, causal, kv_offset, sm_scale):
    """The f32 wide route: 3xTF32 in key blocks of 32, Q Kᵀ over 32-column
    chunks halved between the consumers, the route's split-KV ranges."""
    b, sq, h, d = q.shape
    return _emulated_tf32_attention(
        q, k, v, causal=causal, kv_offset=kv_offset, sm_scale=sm_scale,
        block_k=ta.WIDE_BLOCK_K["flash_attn_fwd_tf32"], parts=_wide_parts(d, 32),
        route="flash_attn_fwd_tf32",
        splits=ta._wide_splits("flash_attn_fwd_tf32", b, h, sq, k.shape[1], d, causal,
                               kv_offset, sm_count=H100_SMS))


def _emulated_wgmma_attention(q, k, v, *, causal, kv_offset, sm_scale, dtype):
    """The arithmetic of the wide route of ``csrc/flash_attn_fwd.cu`` on
    inputs of ``dtype`` (bf16/fp16): key blocks of 64, exact products of the
    16-bit operands summed in f32 over 64-column boxes halved between the
    consumers (passes of 8 boxes), P rounded to ``dtype`` for P V, the
    route's split-KV ranges merged in f32, O stored in ``dtype``."""
    b, sq, h, d = q.shape
    out, lse = _emulated_attention(
        *(x.to(dtype).float() for x in (q, k, v)), causal=causal,
        kv_offset=kv_offset, sm_scale=sm_scale, qk=torch.matmul,
        pv=lambda p, vc: p.to(dtype).float() @ vc,
        block_k=ta.WIDE_BLOCK_K["flash_attn_fwd"], parts=_wide_parts(d, 64, 8),
        route="flash_attn_fwd",
        splits=ta._wide_splits("flash_attn_fwd", b, h, sq, k.shape[1], d, causal,
                               kv_offset, sm_count=H100_SMS))
    return out.to(dtype), lse


# (b, sq, h, d, sk, causal, kv_offset): the TF32 kernel's head dims, 64 and
# 128, and 33 zero-padded to 36 (whole 16-byte rows) as the wrapper pads
# it; ragged key tails and offsets that cut key blocks
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
    padded = ta._route(torch.float32, d)[1]
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


def _emulated_tile_attention(q, k, v, *, causal, kv_offset, dtype):
    """A head dim at or below the widest tile, as ``csrc/flash_attn_fwd.cu``
    (bf16/fp16) and ``csrc/flash_attn_fwd_tf32.cu`` (f32, 3xTF32) run it at
    the real head dim d: q, k and v on the narrowest tile of ``_HEAD_DIMS``
    that holds d, its columns past d zero (TMA's fill), Q Kᵀ summed over
    all the tile's k-steps (of 16 columns in bf16/fp16, of 8 in 3xTF32),
    the zero columns' too, key blocks of the kernel's, P V at the tile's
    width, and O's d columns kept.  Checks on the way that the columns past
    d hold only zeros and that O's columns past d come out zero."""
    d = q.shape[-1]
    f32 = dtype == torch.float32
    name = "flash_attn_fwd_tf32" if f32 else "flash_attn_fwd"
    tile = next(t for t in ta._HEAD_DIMS[name] if d <= t)
    step = 8 if f32 else 16
    if not f32:  # the kernel reads the 16-bit operands
        q, k, v = (x.to(dtype).float() for x in (q, k, v))
    q, k, v = (torch.nn.functional.pad(x, (0, tile - d)) for x in (q, k, v))
    assert not q[..., d:].any() and not k[..., d:].any()
    parts = [[slice(s * step, (s + 1) * step) for s in range(tile // step)]]
    if f32:
        o, lse = _emulated_tf32_attention(q, k, v, causal=causal, kv_offset=kv_offset,
                                          sm_scale=d ** -0.5, parts=parts)
    else:
        o, lse = _emulated_attention(q, k, v, causal=causal, kv_offset=kv_offset,
                                     sm_scale=d ** -0.5, qk=torch.matmul,
                                     pv=lambda p, vc: p.to(dtype).float() @ vc,
                                     block_k=64 if tile >= 192 else 128, parts=parts)
        o = o.to(dtype).float()
    assert not o[..., d:].any()  # P V at the tile's width: zero columns past d
    return o[..., :d], lse


# (b, sq, h, sk, kv_offset): ragged keys over several of both kernels' key
# blocks (32 keys in TF32; 128, and 64 on the 192 tile, in bf16/fp16)
TILE_CASE = (1, 30, 2, 150, 7)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 40, 96, 192])
def test_emulated_tile_routes_at_the_real_head_dim_match_jax(d, causal):
    """The D <= 256 (bf16/fp16) and D <= 128 (f32) routes at the real head
    dim — the tile that holds d (32 and 96 their own, 40 on the 64 tile,
    192 its own in bf16/fp16 and on the f32 wide route), Q Kᵀ and P V at
    the tile's width — against the JAX package's f32 references: f32 (3xTF32) at ``TF32_TOL``, bf16 and fp16 at
    ``BF16_TOL`` on the same rounded inputs."""
    b, s, h, sk, off = TILE_CASE
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        name = "flash_attn_fwd_tf32" if dtype == torch.float32 else "flash_attn_fwd"
        if d > ta._HEAD_DIMS[name][-1]:
            continue  # above the widest f32 tile: the wide route's tests
        assert ta._route(dtype, d) == (name, d)  # no padding
        (q, k, v), off, jo, jl, ref = _wide_case(
            d, causal, None if dtype == torch.float32 else dtype, case=(b, s, h, sk, off))
        o, lse = _emulated_tile_attention(*_t(q, k, v), causal=causal, kv_offset=off,
                                          dtype=dtype)
        tol = TF32_TOL if dtype == torch.float32 else BF16_TOL
        np.testing.assert_allclose(o.numpy(), jo, **tol)
        np.testing.assert_allclose(lse.numpy(), jl, **tol)
        seen = lse.numpy() > ta.NEG_INF / 2
        assert seen.any()
        np.testing.assert_allclose(o.numpy()[seen], ref[seen], **tol)
        np.testing.assert_array_equal(o.numpy()[~seen], 0.0)


# (b, sq, h, sk, kv_offset) per head dim of the wide routes' test: ragged key
# tails, offsets that cut key blocks (a negative one too); every head dim at
# its real value: 132, 160, 264 and 320 end in a part box, 512 is two halves
# of four boxes; the small grids split their keys
WIDE_CASES = {160: (1, 24, 2, 45, 5), 256: (1, 20, 2, 70, 9),
              320: (1, 17, 2, 60, -30), 512: (1, 40, 1, 52, 4),
              132: (2, 30, 2, 75, 3), 264: (1, 21, 2, 130, -7)}
# the bf16 tolerance of this file (test_bf16_plain_version_close_to_f32)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)


def _wide_case(d, causal, dtype=None, case=None):
    """Inputs of a wide-route case (rounded to ``dtype`` and back to f32,
    so that the f32 references see what the kernel sees), the JAX Pallas
    kernel's ``(out, lse)`` in interpret mode and ``mha_reference``."""
    b, s, h, sk, off = case or WIDE_CASES[d]
    q, k, v = make_qkv(b=b, s=s, h=h, d=d, sk=sk, seed=8)
    if dtype is not None:
        q, k, v = (torch.from_numpy(x).to(dtype).float().numpy() for x in (q, k, v))
    jo, jl = ja._flash_fwd_pallas(*_j(q, k, v), causal=causal, sm_scale=None,
                                  kv_offset=off, block_q=8, block_k=8,
                                  interpret=True)
    ref = np.asarray(ja.mha_reference(*_j(q, k, v), causal=causal, kv_offset=off))
    return (q, k, v), off, np.asarray(jo), np.asarray(jl), ref


def _check_wide_tf32(d, causal, case=None):
    (q, k, v), off, jo, jl, ref = _wide_case(d, causal, case=case)
    assert ta._route(torch.float32, d) == ("flash_attn_fwd_tf32", d)  # no padding
    o, lse = _emulated_wide_tf32_attention(*_t(q, k, v), causal=causal, kv_offset=off,
                                           sm_scale=d ** -0.5)
    o = o.numpy()
    np.testing.assert_allclose(o, jo, **TF32_TOL)
    np.testing.assert_allclose(lse.numpy(), jl, **TF32_TOL)
    seen = lse.numpy() > ta.NEG_INF / 2
    assert seen.any()
    np.testing.assert_allclose(o[seen], ref[seen], **TF32_TOL)
    np.testing.assert_array_equal(o[~seen], 0.0)  # fully masked rows: exactly 0


def _check_wide_wgmma(d, causal, case=None):
    for dtype in (torch.bfloat16, torch.float16):
        (q, k, v), off, jo, jl, ref = _wide_case(d, causal, dtype, case=case)
        o, lse = _emulated_wgmma_attention(*_t(q, k, v), causal=causal, kv_offset=off,
                                           sm_scale=d ** -0.5, dtype=dtype)
        assert o.dtype == dtype
        o = o.float().numpy()
        np.testing.assert_allclose(o, jo, **BF16_TOL)
        np.testing.assert_allclose(lse.numpy(), jl, **BF16_TOL)
        seen = lse.numpy() > ta.NEG_INF / 2
        np.testing.assert_allclose(o[seen], ref[seen], **BF16_TOL)
        np.testing.assert_array_equal(o[~seen], 0.0)
        np.testing.assert_array_equal(lse.numpy()[~seen], np.float32(ta.NEG_INF))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", sorted(WIDE_CASES))
def test_emulated_wide_3xtf32_route_matches_jax_f32(d, causal):
    """The f32 wide route — 3xTF32 at the real head dim, Q Kᵀ summed over
    32-column chunks in the two consumers' halves and the halves added, the
    split-KV ranges merged — meets the f32 gate against the JAX package's
    f32 references."""
    _check_wide_tf32(d, causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", sorted(WIDE_CASES))
def test_emulated_wide_wgmma_route_matches_jax(d, causal):
    """The bf16 wide route — 16-bit products summed in f32 over 64-column
    boxes in the two consumers' halves, P rounded to bf16, the split-KV
    ranges merged in f32, O stored in bf16 — within the bf16 tolerance of
    the JAX package's f32 references on the same (bf16-rounded) inputs;
    fp16 likewise."""
    _check_wide_wgmma(d, causal)


# (d, (b, sq, h, sk, kv_offset), causal) at the split-KV boundaries: a
# decode row whose keys past its position are masked (the ranges stop at
# its reach), a tile whose later range its first rows see nothing of (those
# rows' lse NEG_INF there, dropping out of the merge) beside a tile of one
# range written directly, Sk shorter than one key block (one range), the
# ranges of the longest tiles cut inside the causal reach, and a head above
# 512 (bf16: two contraction passes; both: two column groups of O)
SPLIT_CASES = {
    "decode_ranges_stop_at_the_reach_d320": (320, (2, 1, 2, 517, -300), True),
    "rows_masked_in_a_range_d264": (264, (1, 128, 2, 128, 10), True),
    "sk_under_one_block_d320": (320, (1, 5, 2, 20, 0), False),
    "sk_under_one_block_causal_d132": (132, (1, 9, 2, 20, -5), True),
    "ranges_cut_the_reach_d512": (512, (1, 70, 1, 300, -100), True),
    "wide_head_d1000": (1000, (1, 10, 1, 150, 0), False),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_emulated_wide_routes_at_split_kv_boundaries(case):
    """Both wide routes at the edges of the split-KV rule (``_wide_splits``,
    ``_tile_ranges``) against the JAX package's Pallas kernel in interpret
    mode and ``mha_reference``: f32 at ``TF32_TOL``, bf16/fp16 at
    ``BF16_TOL``."""
    d, shape, causal = SPLIT_CASES[case]
    b, sq, h, sk, off = shape
    for n, bk in ta.WIDE_BLOCK_K.items():
        splits = ta._wide_splits(n, b, h, sq, sk, d, causal, off, sm_count=H100_SMS)
        ranges = [ta._tile_ranges(n, splits, q0, sq, sk, causal, off)
                  for q0 in range(0, sq, ta.WIDE_ROWS)]
        if case.startswith("decode"):  # the last range ends at the row's reach
            assert splits > 1 and ranges[0][-1][1] == -(-(sq - off) // bk) < -(-sk // bk)
        if case.startswith("rows_masked"):  # rows 64-73 see no key of a range
            assert len(ranges[1]) > 1
            assert any(first * bk > 73 - off for first, _ in ranges[1])
            assert len(ranges[0]) == (1 if n == "flash_attn_fwd" else 2)
        if case.startswith("sk_under"):
            assert splits == 1
    _check_wide_tf32(d, causal, case=shape)
    _check_wide_wgmma(d, causal, case=shape)


def test_emulated_wide_routes_balance_a_causal_wave():
    """A causal grid of one wave (33 heads x 2 tiles of 64 rows = 66 CTAs):
    the rule gives 2 ranges, so the longer tile's keys are split and merged
    while the shorter tile writes directly; both routes against the JAX
    package's ``mha_reference`` (O) and ``chunk_attention`` (lse) at their
    tolerances."""
    b, sq, h, sk, d, off = 1, 128, 33, 128, 264, 0
    q, k, v = make_qkv(b=b, s=sq, h=h, d=d, sk=sk, seed=11)
    for n in ta.WIDE_BLOCK_K:
        splits = ta._wide_splits(n, b, h, sq, sk, d, True, off, sm_count=H100_SMS)
        assert splits == 2 and ta._wide_splits(n, b, h, sq, sk, d, sm_count=H100_SMS) == 1
        assert len(ta._tile_ranges(n, splits, 64, sq, sk, True, off)) == 2
        assert len(ta._tile_ranges(n, splits, 0, sq, sk, True, off)) == 1
    jo, jl = ja.chunk_attention(*_j(q, k, v), causal=True, kv_offset=off)
    ref = np.asarray(ja.mha_reference(*_j(q, k, v), causal=True, kv_offset=off))
    o, lse = _emulated_wide_tf32_attention(*_t(q, k, v), causal=True, kv_offset=off,
                                           sm_scale=d ** -0.5)
    np.testing.assert_allclose(o.numpy(), ref, **TF32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), **TF32_TOL)
    for dtype in (torch.bfloat16, torch.float16):
        qd, kd, vd = (torch.from_numpy(x).to(dtype).float() for x in (q, k, v))
        o, lse = _emulated_wgmma_attention(qd, kd, vd, causal=True, kv_offset=off,
                                           sm_scale=d ** -0.5, dtype=dtype)
        rd = np.asarray(ja.mha_reference(*_j(*(x.numpy() for x in (qd, kd, vd))),
                                         causal=True, kv_offset=off))
        np.testing.assert_allclose(o.float().numpy(), rd, **BF16_TOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jl), **BF16_TOL)


def test_wide_splits_rule():
    """``_wide_splits`` at the shapes ``chip_smoke.py`` times, on a card of
    132 SMs (an H100 SXM, passed in): 2 ranges for a causal grid of one wave, none for one that fills two, enough ranges to
    fill the card on small grids, never more than the blocks the longest
    tile may see nor ``MAX_SPLITS``, and (``_tile_ranges``) never an empty
    range, no more than ``splits`` a tile, and every tile's blocks covered
    once."""
    f, t = "flash_attn_fwd", "flash_attn_fwd_tf32"
    sms = dict(sm_count=H100_SMS)
    assert ta._wide_splits(f, 2, 2, 2048, 2048, 512, True, **sms) == 2   # 128 CTAs
    assert ta._wide_splits(t, 2, 2, 2048, 2048, 512, True, **sms) == 2
    assert ta._wide_splits(f, 2, 2, 2048, 2048, 512, **sms) == 1         # not causal
    assert ta._wide_splits(t, 2, 4, 2048, 2048, 256, True, **sms) == 1   # 256 CTAs
    assert ta._wide_splits(f, 2, 2, 200, 330, 320, **sms) == 6           # 16 CTAs, 6 blocks
    assert ta._wide_splits(t, 2, 2, 200, 330, 320, True, 5, **sms) == 7  # 195 keys reached
    assert ta._wide_splits(f, 2, 2, 1, 517, 512, True, -516, **sms) == 9  # decode
    assert ta._wide_splits(t, 2, 4, 1, 517, 256, True, -516, **sms) == 9
    assert ta._wide_splits(f, 1, 1, 1, 10 ** 6, 512, **sms) == ta.MAX_SPLITS
    # the longest causal tile (32 blocks) in two ranges of 16; a tile of 16
    # blocks or fewer in one
    assert ta._tile_ranges(f, 2, 1984, 2048, 2048, True, 0) == [(0, 16), (16, 32)]
    assert ta._tile_ranges(f, 2, 960, 2048, 2048, True, 0) == [(0, 16)]
    for n in (f, t):
        for b, h, sq, sk, d, causal, off in [
                (1, 1, 1, 1000, 300, False, 0), (2, 3, 100, 777, 600, True, 3),
                (1, 2, 64, 64, 512, True, 0), (4, 4, 1, 5000, 264, True, -4999),
                (2, 2, 2048, 2048, 320, True, 0), (1, 1, 300, 40, 264, True, 100)]:
            s = ta._wide_splits(n, b, h, sq, sk, d, causal, off, **sms)
            blocks = ta._reach_blocks(n, sq, sk, causal, off)
            assert 1 <= s <= max(1, min(blocks, ta.MAX_SPLITS))
            for q0 in range(0, sq, ta.WIDE_ROWS):
                ranges = ta._tile_ranges(n, s, q0, sq, sk, causal, off)
                mine = ta._reach_blocks(n, sq, sk, causal, off, q_end=q0 + ta.WIDE_ROWS)
                assert 1 <= len(ranges) <= s
                assert ranges[0][0] == 0 and ranges[-1][1] == mine
                assert all(a < b_ for a, b_ in ranges) or mine == 0
                assert all(r[1] == nxt[0] for r, nxt in zip(ranges, ranges[1:]))


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
    odd = torch.zeros((2, 16, 4, 66))[..., :64]  # rows of 66 f32: not 16-byte strides
    assert ta._kernel_operand(odd).is_contiguous()
    # 16-byte rows whatever the element: 36 f32 (144 bytes) read in place
    f32_rows = torch.zeros((2, 16, 4, 36))
    assert ta._kernel_operand(f32_rows) is f32_rows
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
    # lse carries its gradient too (ring attention merges chunks by it),
    # through the same node of the graph
    assert lse.requires_grad and lse.grad_fn is out.grad_fn
    with torch.no_grad():
        o2, l2 = ta.flash_attention_fwd(q, k, v, causal=True)
    assert o2.grad_fn is None
    np.testing.assert_array_equal(o2.numpy(), out.detach().numpy())
    np.testing.assert_array_equal(l2.numpy(), lse.detach().numpy())


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


LSE_GRAD_CASES = {**GRAD_CASES, "all_future": (1, 8, 2, 8, 8, True, 8)}


@pytest.mark.parametrize("case", sorted(LSE_GRAD_CASES))
def test_attention_grads_through_out_and_lse_match_jax_chunk(case):
    """``FlashAttention``'s backward takes the ``lse`` cotangent: gradients
    of a loss on both outputs equal those of the JAX package's plain,
    differentiable ``chunk_attention`` (what its ring attention merges),
    fully masked chunks included (their ``lse`` is NEG_INF, and a finite
    cotangent on it moves nothing)."""
    import jax

    b, s, h, d, sk, causal, off = LSE_GRAD_CASES[case]
    q, k, v = make_qkv(b=b, s=s, h=h, d=d, sk=sk, seed=8)
    rng = np.random.RandomState(9)
    g_o = rng.randn(*q.shape).astype(np.float32)
    g_l = rng.randn(b, s, h).astype(np.float32)

    def jloss(q, k, v):
        o, lse = ja.chunk_attention(q, k, v, causal=causal, kv_offset=off)
        return (o * g_o).sum() + (jnp.maximum(lse, -1e4) * g_l).sum()

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*_j(q, k, v))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    o, lse = ta.flash_attention_fwd(tq, tk, tv, causal=causal, kv_offset=off)
    assert "FlashAttention" in type(lse.grad_fn).__name__
    ((o * torch.from_numpy(g_o)).sum()
     + (lse.clamp(min=-1e4) * torch.from_numpy(g_l)).sum()).backward()
    for tgrad, jgrad in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), **GRAD_TOL)


def test_lse_only_cotangent_is_the_softmax_weighted_keys():
    """A loss on ``lse`` alone (no ``out`` cotangent): d lse / d q is the
    row's softmax over ``scale · k``, held against autograd of the dense
    logsumexp."""
    q, k, v = _t(*make_qkv(b=1, s=12, h=2, d=8, seed=10))
    q.requires_grad_()
    _, lse = ta.flash_attention_fwd(q, k, v, causal=True)
    lse.sum().backward()
    q2 = q.detach().clone().requires_grad_()
    logits = torch.einsum("bqhd,bkhd->bhqk", q2, k) / math.sqrt(8)
    keep = torch.arange(12)[None, :] <= torch.arange(12)[:, None]
    torch.logsumexp(torch.where(keep, logits, -torch.inf), dim=-1).sum().backward()
    np.testing.assert_allclose(q.grad.numpy(), q2.grad.numpy(), **GRAD_TOL)


# -- the operator: tos::flash_attn_fwd ----------------------------------------

@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("kv_offset", [0, 5])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_op_passes_opcheck_on_cpu(dtype, causal, kv_offset, d):
    """``torch.library.opcheck`` on ``tos::flash_attn_fwd`` with CPU
    tensors: its schema (no input mutated, no output aliasing an input),
    its autograd registration (none: ``FlashAttention`` holds the one
    backward), the fake implementation against the real one (shape, type
    and strides of ``out`` and ``lse``), and the op under aot_autograd
    with dynamic sizes, the batch among them."""
    q, k, v = (x.to(getattr(torch, dtype))
               for x in _t(*make_qkv(b=2, s=7, h=3, d=d, sk=9, seed=d)))
    result = torch.library.opcheck(torch.ops.tos.flash_attn_fwd.default,
                                   (q, k, v, causal, None, kv_offset))
    assert set(result.values()) == {"SUCCESS"}, result


def test_attention_reaches_the_plain_version_only_through_the_op():
    """``flash_attention_fwd`` goes through ``tos::flash_attn_fwd`` in
    inference and under autograd (inside ``FlashAttention``'s forward)
    alike; on a CPU tensor the op is ``chunk_attention`` bit for bit, with
    a contiguous ``out``, and launches nothing.  An explicit ``sm_scale``
    passes through."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Calls(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    q, k, v = _t(*make_qkv(b=2, s=12, h=2, d=8, sk=20, seed=3))
    launches = dict(ta.LAUNCHES)
    for grad in (False, True):
        leaves = [x.clone().requires_grad_(grad) for x in (q, k, v)]
        with Calls() as calls:
            out, lse = ta.flash_attention_fwd(*leaves, causal=True, sm_scale=0.3,
                                              kv_offset=4)
        assert calls.ops.count(torch.ops.tos.flash_attn_fwd.default) == 1
        assert (out.grad_fn is not None) == grad
        want_o, want_lse = ta.chunk_attention(q, k, v, causal=True, sm_scale=0.3,
                                              kv_offset=4)
        assert out.is_contiguous()
        np.testing.assert_array_equal(out.detach().numpy(), want_o.numpy())
        np.testing.assert_array_equal(lse.detach().numpy(), want_lse.numpy())
    assert ta.LAUNCHES == launches


def test_flash_op_fake_gives_symbolic_shapes_and_f32_lse():
    """The fake implementation under ``torch.export`` with a dynamic batch:
    the graph holds the op's call, ``out`` keeps q's shape and type with
    the batch symbolic, and ``lse`` is ``[B, Sq, H]`` float32."""

    class Attend(torch.nn.Module):
        def forward(self, q, k, v):
            return torch.ops.tos.flash_attn_fwd(q, k, v, True, None, 0)

    q, k, v = (x.bfloat16() for x in _t(*make_qkv(b=2, s=6, h=2, d=16, seed=1)))
    batch = torch.export.Dim("batch")
    program = torch.export.export(Attend(), (q, k, v),
                                  dynamic_shapes=({0: batch}, {0: batch}, {0: batch}))
    (call,) = [n for n in program.graph.nodes
               if n.target is torch.ops.tos.flash_attn_fwd.default]
    out, lse = (n.meta["val"] for n in call.users)
    assert isinstance(out.shape[0], torch.SymInt) and out.shape[1:] == (6, 2, 16)
    assert out.dtype == torch.bfloat16
    assert lse.shape[1:] == (6, 2) and lse.dtype == torch.float32
    q3, k3, v3 = (x.bfloat16() for x in _t(*make_qkv(b=3, s=6, h=2, d=16, seed=2)))
    got = program.module()(q3, k3, v3)
    want = ta.chunk_attention(q3, k3, v3, causal=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_chip_smoke_example_lm_phase_runs_on_cpu(monkeypatch, tmp_path):
    """``chip_smoke.py``'s example-LM phase at a narrow width on the CPU (no
    kernel: 0 launches expected), in f32 and bf16: the first step against
    plain attention, ``EXAMPLE_STEPS`` AdamW steps with falling losses, and
    the served batch's logits against plain attention's."""
    import chip_smoke as cs

    monkeypatch.setattr(cs, "WORK_DIR", str(tmp_path))
    monkeypatch.setattr(cs, "EXAMPLE_LM_CONFIG", {**cs.EXAMPLE_LM_CONFIG, "vocab_size": 64,
                                                  "d_model": 32, "n_layers": 2, "n_heads": 4})
    monkeypatch.setattr(cs, "EXAMPLE_SEQ", 16)
    monkeypatch.setattr(cs, "EXAMPLE_BATCH", 2)
    runs = cs.phase_example_lm(0, "cpu", device="cpu")
    assert set(runs) == {"flash_attn_fwd", "flash_attn_fwd_tf32"}
    for run in runs.values():
        assert run["launches"] == 0 and run["served_launches"] == 0
        assert len(run["losses"]) == cs.EXAMPLE_STEPS
        assert run["losses"][-1] < run["losses"][0]
