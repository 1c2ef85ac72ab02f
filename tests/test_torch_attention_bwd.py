"""The port's attention backward (``tos::flash_attn_bwd``: the FA2 gradient
from the forward's saved ``lse``) against the JAX package's
gradients, on the CPU at small sizes: its plain version
(``flash_attn_bwd_reference``, what ``FlashAttention.backward`` runs on a
CPU tensor) against ``jax.vjp`` of the Pallas ``custom_vjp`` in interpret
mode and of ``chunk_attention`` (f32, 1e-4), fully masked rows, bf16
inputs, the operator's ``opcheck`` and fake shapes, the route table
(``_bwd_route``), and the backward kernels' tile schedules and rounding
(bf16/fp16 operands; f32 as 3xTF32) emulated in torch.  The kernels
themselves are held against the plain version on the card in
``tests/test_torch_cuda.py``."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowonspark_torch.ops import attention as ta
from tensorflowonspark_tpu.ops import attention as ja
from test_torch_attention import (GRAD_CASES, GRAD_TOL, LSE_GRAD_CASES, _j, _t, _tf32_hi,
                                  _tf32_round, make_qkv)
from torch_lock_gate import torch_lock_witness_gate  # noqa: F401 - the port's lock-witness gate


def _forward(q, k, v, causal, off, sm_scale=None):
    with torch.no_grad():
        return ta.flash_attention_fwd(q, k, v, causal=causal, kv_offset=off,
                                      sm_scale=sm_scale)


def _cotangents(q, seed, out=True, lse=True):
    rng = np.random.RandomState(seed)
    b, s, h, d = q.shape
    return (rng.randn(b, s, h, d).astype(np.float32) if out else None,
            rng.randn(b, s, h).astype(np.float32) if lse else None)


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_plain_bwd_matches_jax_vjp_of_pallas_interpret(case):
    """The operator on CPU tensors (the plain FA2 backward from the saved
    ``lse``) against ``jax.vjp`` of the JAX package's Pallas
    ``custom_vjp`` in interpret mode, f32."""
    b, s, h, d, sk, causal, off = GRAD_CASES[case]
    q, k, v = make_qkv(b=b, s=s, h=h, d=d, sk=sk, seed=11)
    g, _ = _cotangents(q, 12, lse=False)
    _, vjp = jax.vjp(lambda *a: ja.flash_attention(
        *a, causal=causal, kv_offset=off, block_q=16, block_k=16,
        impl="pallas_interpret"), *_j(q, k, v))
    jgrads = vjp(jnp.asarray(g))
    tq, tk, tv = _t(q, k, v)
    _, lse = _forward(tq, tk, tv, causal, off)
    got = torch.ops.tos.flash_attn_bwd(tq, tk, tv, lse, torch.from_numpy(g), None, causal,
                                       None, off)
    for tgrad, jgrad in zip(got, jgrads):
        np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), **GRAD_TOL)


@pytest.mark.parametrize("case", sorted(LSE_GRAD_CASES))
def test_plain_bwd_out_and_lse_cotangents_match_jax_vjp_of_chunk(case):
    """Cotangents on ``out`` and ``lse`` together (ring attention's use)
    against ``jax.vjp`` of the JAX package's ``chunk_attention``, each
    alone too; a fully masked row's finite ``lse`` cotangent moves
    nothing."""
    b, s, h, d, sk, causal, off = LSE_GRAD_CASES[case]
    q, k, v = make_qkv(b=b, s=s, h=h, d=d, sk=sk, seed=13)
    g_o, g_l = _cotangents(q, 14)
    _, vjp = jax.vjp(lambda *a: ja.chunk_attention(*a, causal=causal, kv_offset=off),
                     *_j(q, k, v))
    tq, tk, tv = _t(q, k, v)
    _, lse = _forward(tq, tk, tv, causal, off)
    for go, gl in ((g_o, g_l), (g_o, None), (None, g_l)):
        jgrads = vjp((jnp.asarray(go if go is not None else np.zeros_like(g_o)),
                      jnp.asarray(gl if gl is not None else np.zeros_like(g_l))))
        got = torch.ops.tos.flash_attn_bwd(
            tq, tk, tv, lse, None if go is None else torch.from_numpy(go),
            None if gl is None else torch.from_numpy(gl), causal, None, off)
        for tgrad, jgrad in zip(got, jgrads):
            np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), **GRAD_TOL)


@pytest.mark.parametrize("off", [8, 1000])
def test_plain_bwd_fully_masked_rows_give_zero_gradients(off):
    """A chunk whose every row is masked (``kv_offset`` 1000) gives zero
    gradients and no NaN through ``FlashAttention`` with cotangents on
    ``out`` and ``lse``; with ``kv_offset`` 8 the first 8 rows see no key:
    their dq is exactly 0, and the rest matches ``jax.vjp`` of
    ``chunk_attention``."""
    q, k, v = make_qkv(b=2, s=16, h=2, d=8, seed=15)
    g_o, g_l = _cotangents(q, 16)
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    o, lse = ta.flash_attention_fwd(tq, tk, tv, causal=True, kv_offset=off)
    ((o * torch.from_numpy(g_o)).sum() + (lse * torch.from_numpy(g_l)).sum()).backward()
    for x in (tq, tk, tv):
        assert torch.isfinite(x.grad).all()
    if off >= 16:
        for x in (tq, tk, tv):
            assert torch.count_nonzero(x.grad) == 0
        return
    assert torch.count_nonzero(tq.grad[:, :off]) == 0
    _, vjp = jax.vjp(lambda *a: ja.chunk_attention(*a, causal=True, kv_offset=off),
                     *_j(q, k, v))
    for tgrad, jgrad in zip((tq.grad, tk.grad, tv.grad),
                            vjp((jnp.asarray(g_o), jnp.asarray(g_l)))):
        np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), **GRAD_TOL)


def test_plain_bwd_dq_exact_when_keys_share_a_large_component():
    """Keys (and values) sharing a large common component, as a trained
    LM's do: a common key component moves every logit of a row alike, so
    dq must not see it (``Σ_j dS_ij = 0``).  With ``out`` stored in bf16,
    FA2's ``Δ = rowsum(dO ∘ O)`` breaks that sum and dq is off by about 13%
    here; ``Δ = rowsum(P ∘ dP)`` keeps it.  The operator and the kernels'
    bf16 rounding (emulated) against the f32 gradient of the same bf16
    inputs, ``BWD_REL_TOL`` relative L2 each."""
    rng = np.random.RandomState(26)
    common = 4 * rng.randn(1, 1, 2, 64).astype(np.float32)
    q, k, v, g = (torch.from_numpy(x).bfloat16() for x in (
        rng.randn(1, 128, 2, 64).astype(np.float32),
        rng.randn(1, 128, 2, 64).astype(np.float32) + common,
        rng.randn(1, 128, 2, 64).astype(np.float32) + common,
        rng.randn(1, 128, 2, 64).astype(np.float32)))
    leaves = [x.float().requires_grad_() for x in (q, k, v)]
    ta.mha_reference(*leaves, causal=True).backward(g.float())
    # the card's forward's lse: from f32 logits
    _, lse = ta.chunk_attention(*(x.float() for x in (q, k, v)), causal=True)
    got = torch.ops.tos.flash_attn_bwd(q, k, v, lse, g, None, True, None, 0)
    emulated = _emulated_bwd(q, k, v, lse, g, None, causal=True, kv_offset=0,
                             round_to=torch.bfloat16)[:3]
    for grads in (got, emulated):
        for x, want in zip(grads, leaves):
            assert ((x.float() - want.grad).norm() / want.grad.norm()).item() <= BWD_REL_TOL


# bf16 inputs (the same values on both sides): the plain backward takes them
# in f32, but the plain forward's logits (which lse comes from) and the
# gradients are rounded to bf16, 2^-9 relative; held as the bf16 forward is
# (3e-2)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("case", ["causal", "kv_offset", "cross_20_52_noncausal"])
def test_plain_bwd_bf16_close_to_jax_f32(case):
    b, s, h, d, sk, causal, off = GRAD_CASES[case]
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in make_qkv(b=b, s=s, h=h, d=d, sk=sk, seed=17))
    g, _ = _cotangents(q, 18, lse=False)
    _, vjp = jax.vjp(lambda *a: ja.flash_attention(
        *a, causal=causal, kv_offset=off, block_q=16, block_k=16,
        impl="pallas_interpret"), *_j(*(x.float().numpy() for x in (q, k, v))))
    jgrads = vjp(jnp.asarray(g))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ta.flash_attention(*leaves, causal=causal, kv_offset=off)
    out.backward(torch.from_numpy(g).bfloat16())
    for x, jgrad in zip(leaves, jgrads):
        assert x.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(x.grad.float().numpy(), np.asarray(jgrad), **BF16_TOL)


def test_flash_attention_backward_calls_the_bwd_op_once_on_cpu():
    """On CPU tensors ``FlashAttention.backward`` is one call of
    ``tos::flash_attn_bwd`` (its plain version, f32 here), with ``None``
    for the unused ``lse`` cotangent, and it runs no forward again and
    launches nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Calls(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.calls.append((func, args))
            return func(*args, **(kwargs or {}))

    q, k, v = (x.requires_grad_() for x in _t(*make_qkv(b=1, s=20, h=2, d=8, seed=19)))
    out = ta.flash_attention(q, k, v, causal=True, sm_scale=0.3, kv_offset=2)
    launches = dict(ta.LAUNCHES)
    with Calls() as calls:
        out.sum().backward()
    ops = [f for f, _ in calls.calls]
    assert ops.count(torch.ops.tos.flash_attn_bwd.default) == 1
    assert torch.ops.tos.flash_attn_fwd.default not in ops
    (args,) = [a for f, a in calls.calls if f is torch.ops.tos.flash_attn_bwd.default]
    assert args[5] is None and args[6:] == (True, 0.3, 2)
    assert ta.LAUNCHES == launches


@pytest.mark.parametrize("cot", ["out+lse", "out", "lse"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_op_passes_opcheck_on_cpu(dtype, causal, cot):
    """``torch.library.opcheck`` on ``tos::flash_attn_bwd`` with CPU
    tensors: schema (nothing mutated, no output aliasing an input), no
    autograd registration needed, the fake implementation against the real
    one (shapes, types, strides of dq, dk, dv), and aot_autograd with
    dynamic sizes."""
    dt = getattr(torch, dtype)
    q, k, v = (x.to(dt) for x in _t(*make_qkv(b=2, s=7, h=3, d=16, sk=9, seed=20)))
    _, lse = _forward(q, k, v, causal, 3)
    g_o, g_l = _cotangents(q, 21)
    args = (q, k, v, lse,
            torch.from_numpy(g_o).to(dt) if "out" in cot else None,
            torch.from_numpy(g_l) if "lse" in cot else None, causal, None, 3)
    result = torch.library.opcheck(torch.ops.tos.flash_attn_bwd.default, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_flash_bwd_op_fake_gives_the_inputs_shapes():
    """The fake implementation under ``FakeTensorMode``: dq, dk, dv have
    q's, k's and v's shapes and type, contiguous, for packed views too."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        qkv = torch.empty((2, 6, 3, 2, 16), dtype=torch.bfloat16)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out = torch.empty((2, 6, 2, 16), dtype=torch.bfloat16)
        lse = torch.empty((2, 6, 2))
        grads = torch.ops.tos.flash_attn_bwd(q, k, v, lse, out, None, True, None, 0)
    for g, x in zip(grads, (q, k, v)):
        assert g.shape == x.shape and g.dtype == torch.bfloat16 and g.is_contiguous()


# the backward's route by (type, head dim): up to 128, rounded to whole
# 16-byte rows as the forward rounds them, to the kernels, bf16/fp16 (a
# multiple of 8) first, f32 (a multiple of 4, 3xTF32) second; wider heads
# to the recompute VJP at the head dim itself
BWD_ROUTES = {
    8: (("flash_attn_bwd", 8), ("flash_attn_bwd_tf32", 8)),
    32: (("flash_attn_bwd", 32), ("flash_attn_bwd_tf32", 32)),
    33: (("flash_attn_bwd", 40), ("flash_attn_bwd_tf32", 36)),
    36: (("flash_attn_bwd", 40), ("flash_attn_bwd_tf32", 36)),
    80: (("flash_attn_bwd", 80), ("flash_attn_bwd_tf32", 80)),
    96: (("flash_attn_bwd", 96), ("flash_attn_bwd_tf32", 96)),
    121: (("flash_attn_bwd", 128), ("flash_attn_bwd_tf32", 124)),
    128: (("flash_attn_bwd", 128), ("flash_attn_bwd_tf32", 128)),
    129: (("recompute", 129),) * 2, 160: (("recompute", 160),) * 2,
    256: (("recompute", 256),) * 2, 512: (("recompute", 512),) * 2,
}


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("d", sorted(BWD_ROUTES))
def test_bwd_route_table(d, dtype):
    dt = getattr(torch, dtype)
    want = BWD_ROUTES[d][dt == torch.float32]
    assert ta._bwd_route(dt, d) == want
    if want[0] != "recompute":  # the forward pads to the same rows
        assert ta._route(dt, d)[1] == want[1]
        tile = next(t for t in ta.BWD_HEAD_DIMS if t >= want[1])
        assert ta.bwd_tiling(want[0], tile)[2] in (32, 64)


def test_bwd_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = _t(*make_qkv(b=1, s=8, h=1, d=16))
    _, lse = _forward(q, k, v, True, 0)
    with pytest.raises(ValueError, match="CUDA"):
        ta.flash_attn_bwd_cuda(q.bfloat16(), k.bfloat16(), v.bfloat16(), lse, None, None)


# -- the kernels' schedule and rounding, emulated ------------------------------

def _query_ctas(sq, sk, causal, kv_offset, rows, wg, inner):
    """The Δ and dQ kernels' CTAs in launch order (the last rows first), each
    ``[(query row, key row) tile origins of its first consumer, ... of its
    last]``: a CTA of ``rows`` query rows walks the key tiles of ``inner``
    rows up to the last key its last row may see, and a consumer (a
    warpgroup or warp) of ``wg`` rows computes on a tile only below the keys
    its own last row may see."""
    ctas = []
    for i0 in reversed(range(0, sq, rows)):
        keys = sk if not causal else max(0, min(sk, min(i0 + rows, sq) - kv_offset))
        consumers = []
        for qw0 in range(i0, i0 + rows, wg):
            mine = sk if qw0 < sq else 0
            if causal:
                mine = max(0, min(mine, min(qw0 + wg, sq) - kv_offset))
            consumers.append([(qw0, j0) for j0 in range(0, keys, inner) if j0 < mine])
        ctas.append(consumers)
    return ctas


def _kv_ctas(sq, sk, causal, kv_offset, rows, wg, inner):
    """The dK/dV kernel's CTAs in launch order (the first keys first), each
    ``[(key row, query row) tile origins of its first consumer, ... of its
    last]``: a CTA of ``rows`` keys walks the query tiles of ``inner`` rows
    from the tile of the first query the mask lets see its first key to
    ``sq``, and a consumer of ``wg`` keys computes on a tile only where the
    tile's last row sees its first key."""
    ctas = []
    for j0 in range(0, sk, rows):
        first = max(0, kv_offset + j0) if causal else 0
        tiles = range(first // inner * inner, sq if first < sq else 0, inner)
        ctas.append([[(jw0, i0) for i0 in tiles
                      if jw0 < sk and (not causal or kv_offset + jw0 <= min(i0 + inner, sq) - 1)]
                     for jw0 in range(j0, j0 + rows, wg)])
    return ctas


def _tf32_split(x):
    """x = hi + lo as the f32 kernels split an operand: hi with its low 13
    mantissa bits cleared, lo = tf32(x - hi) rounded to nearest."""
    hi = _tf32_hi(x)
    return hi, _tf32_round(x - hi)


def _einsum_3xtf32(eq, a, b):
    """``torch.einsum(eq, a, b)`` as the f32 kernels compute each product:
    a_lo·b_hi + a_hi·b_lo + a_hi·b_hi (small terms first)."""
    (ah, al), (bh, bl) = _tf32_split(a), _tf32_split(b)
    return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, ah, bh)


def _einsum_1xtf32(eq, a, b):
    """One TF32 pass: the product of the truncated operands, what a kernel
    that hands the tensor cores raw f32 computes."""
    return torch.einsum(eq, _tf32_hi(a), _tf32_hi(b))


def _emulated_bwd(q, k, v, lse, g_out, g_lse, *, causal, kv_offset, round_to=None,
                  kernel="flash_attn_bwd", einsum=torch.einsum, center=None):
    """``(dq, dk, dv, kv_visits, q_visits, kv_ctas, q_ctas)`` as backward
    kernel ``kernel`` computes them (``csrc/flash_attn_bwd.cu``, or
    ``csrc/flash_attn_bwd_tf32.cu``), on its tile schedule
    (``ops.attention.bwd_tiling``) of ``_query_ctas`` (the Δ kernel summing
    P ∘ dP in f32 into Δ, less ``g_lse``; the dQ kernel) and ``_kv_ctas``
    (the dK/dV kernel); rows past S are zeros, P comes from ``lse`` and is
    0 where masked or on a fully masked row.  With ``round_to`` the inputs
    are taken in that type and P and dS are rounded to it as product
    operands, the gradients stored in it.  Every product (S, dP, dV, dK,
    dQ) is ``einsum`` (``_einsum_3xtf32``: the f32 kernels' 3xTF32).  The
    f32 kernels centre K and V on the head's mean key and value (S and dP
    less row constants: lse less ``scale q·m_k``, Δ from the same dP, and
    dQ plus ``scale m_k Σ_j dS_ij``); ``center`` (default: for the f32
    kernels) says whether to.  The
    visits are the consumers' ``(key row, query row)`` tile origins (a
    consumer's keys by ``inner`` queries on the dK/dV side, ``inner`` keys
    by a consumer's queries on the query side); the CTAs are the schedules
    themselves."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    name, padded = ta._bwd_route(torch.float32 if kernel == "flash_attn_bwd_tf32"
                                 else torch.bfloat16, d)
    assert name == kernel
    tile = next(t for t in ta.BWD_HEAD_DIMS if t >= padded)
    rows, wg, inner = ta.bwd_tiling(kernel, tile)
    scale = 1.0 / math.sqrt(d)
    rd = (lambda x: x.to(round_to).float()) if round_to else (lambda x: x)
    qf, kf, vf = (rd(x.float()) for x in (q, k, v))
    dof = rd(g_out.float()) if g_out is not None else torch.zeros_like(qf)
    live = lse > ta.NEG_INF / 2
    # the f32 kernels' centring (a zero shift for the bf16/fp16 kernels)
    mk = torch.zeros((b, 1, h, d))
    mv = torch.zeros((b, 1, h, d))
    if center or (center is None and kernel == "flash_attn_bwd_tf32"):
        mk, mv = kf.mean(1, keepdim=True), vf.mean(1, keepdim=True)
    kc, vc = kf - mk, vf - mv
    lse = torch.where(live, lse - scale * (qf * mk).sum(-1), lse)
    q_ctas = _query_ctas(sq, sk, causal, kv_offset, rows, wg, inner)
    kv_ctas = _kv_ctas(sq, sk, causal, kv_offset, rows, wg, inner)
    q_visits = [(j0, qw0) for cta in q_ctas for c in cta for qw0, j0 in c]
    kv_visits = [v_ for cta in kv_ctas for c in cta for v_ in c]

    def tile_p(i0, i1, j0, j1):
        s = einsum("bqhd,bkhd->bhqk", qf[:, i0:i1], kc[:, j0:j1]) * scale
        i = torch.arange(i0, i1)[:, None]
        j = torch.arange(j0, j1)[None, :]
        keep = live[:, i0:i1].transpose(1, 2)[..., None]
        if causal:
            keep = keep & (kv_offset + j <= i)
        lse_t = lse[:, i0:i1].transpose(1, 2)[..., None]
        p = torch.where(keep, torch.exp(torch.where(keep, s - lse_t, 0.0)), 0.0)
        return p, einsum("bqhd,bkhd->bhqk", dof[:, i0:i1], vc[:, j0:j1])

    delta = torch.zeros((b, sq, h))
    for j0, i0 in q_visits:
        p, dp = tile_p(i0, min(i0 + wg, sq), j0, min(j0 + inner, sk))
        delta[:, i0:i0 + wg] += (p * dp).sum(-1).transpose(1, 2)
    if g_lse is not None:
        delta -= g_lse

    def tile_ps(i0, i1, j0, j1):
        p, dp = tile_p(i0, i1, j0, j1)
        return p, p * (dp - delta[:, i0:i1].transpose(1, 2)[..., None])

    dq = torch.zeros((b, sq, h, d))
    dk = torch.zeros((b, sk, h, d))
    dv = torch.zeros((b, sk, h, d))
    for j0, i0 in kv_visits:
        j1, i1 = min(j0 + wg, sk), min(i0 + inner, sq)
        p, ds = tile_ps(i0, i1, j0, j1)
        dv[:, j0:j1] += einsum("bhqk,bqhd->bkhd", rd(p), dof[:, i0:i1])
        dk[:, j0:j1] += einsum("bhqk,bqhd->bkhd", rd(ds), qf[:, i0:i1])
    ds_sum = torch.zeros((b, sq, h, 1))
    for j0, i0 in q_visits:
        i1, j1 = min(i0 + wg, sq), min(j0 + inner, sk)
        _, ds = tile_ps(i0, i1, j0, j1)
        dq[:, i0:i1] += einsum("bhqk,bkhd->bqhd", rd(ds), kc[:, j0:j1])
        ds_sum[:, i0:i1] += ds.sum(-1).transpose(1, 2)[..., None]
    dq += ds_sum * mk
    out_type = round_to or torch.float32
    return (rd((dq * scale).to(out_type)), rd((dk * scale).to(out_type)),
            rd(dv.to(out_type)), kv_visits, q_visits, kv_ctas, q_ctas)


# (b, sq, sk, h, d, causal, kv_offset): the bf16/fp16 kernels' CTAs of 128
# rows in consumers of 64 and loop tiles of 64 (D 32 and 96 on the narrow
# boxes); the f32 kernels' (cases named f32_<case>, the same shapes) CTAs
# of 64 rows in warps of 16 and loop tiles of 64 or 32; ragged ends, a
# causal offset that masks the first rows, negative ones, one past every
# query (nothing visited), non-causal; three CTAs on each side with the
# second consumer's first diagonal tile skipped, a key block that straddles
# the diagonal at a negative offset, a last CTA whose second consumer has
# no rows, a key block whose second consumer has no keys
SCHEDULE_CASES = {
    "causal_d32": (1, 200, 200, 2, 32, True, 0),
    "causal_d96_ragged": (1, 150, 170, 2, 96, True, 0),
    "kv_offset_37_d128": (1, 100, 70, 2, 128, True, 37),
    "kv_offset_negative_d64": (1, 64, 192, 2, 64, True, -64),
    "kv_offset_past_every_query_d32": (1, 40, 100, 2, 32, True, 60),
    "noncausal_d96_20_52": (2, 20, 52, 2, 96, False, 0),
    "causal_d36_cross": (1, 130, 90, 2, 36, True, 5),
    "causal_d128_three_ctas": (1, 300, 300, 2, 128, True, 0),
    "key_block_straddles_diagonal_negative_offset_d64": (1, 100, 260, 2, 64, True, -100),
    "last_cta_second_consumer_no_rows_d32": (1, 130, 130, 2, 32, True, 0),
    "second_consumer_few_keys_d96": (1, 90, 70, 2, 96, True, 20),
}


@pytest.mark.parametrize("case", sorted(SCHEDULE_CASES)
                         + [f"f32_{c}" for c in sorted(SCHEDULE_CASES)])
def test_emulated_bwd_schedule_visits_every_live_pair_once(case):
    """The kernels' tile schedules (the bf16/fp16 kernels', and for the
    ``f32_`` cases the f32 kernels'), emulated in f32: each live (query,
    key) pair lies in exactly one tile the dK/dV kernel visits and one the
    dQ kernel visits, no visited tile is without a live pair, and the
    gradients equal the plain version's (1e-5) and ``jax.vjp`` of
    ``chunk_attention`` (``GRAD_TOL``)."""
    kernel = "flash_attn_bwd_tf32" if case.startswith("f32_") else "flash_attn_bwd"
    b, sq, sk, h, d, causal, off = SCHEDULE_CASES[case.removeprefix("f32_")]
    q, k, v = make_qkv(b=b, s=sq, h=h, d=d, sk=sk, seed=22)
    g_o, g_l = _cotangents(q, 23)
    tq, tk, tv = _t(q, k, v)
    _, lse = _forward(tq, tk, tv, causal, off)
    dq, dk, dv, kv_visits, q_visits, kv_ctas, q_ctas = _emulated_bwd(
        tq, tk, tv, lse, torch.from_numpy(g_o), torch.from_numpy(g_l), causal=causal,
        kv_offset=off, kernel=kernel)
    route = ta._bwd_route(torch.float32 if kernel == "flash_attn_bwd_tf32"
                          else torch.bfloat16, d)
    tile = next(t for t in ta.BWD_HEAD_DIMS if t >= route[1])
    rows, wg, inner = ta.bwd_tiling(kernel, tile)
    i = torch.arange(sq)[:, None]
    j = torch.arange(sk)[None, :]
    live = (off + j <= i) if causal else torch.ones((sq, sk), dtype=torch.bool)
    for visits, (key_rows, query_rows) in ((kv_visits, (wg, inner)),
                                           (q_visits, (inner, wg))):
        cover = torch.zeros((sq, sk), dtype=torch.int32)
        for j0, i0 in visits:
            cover[i0:i0 + query_rows, j0:j0 + key_rows] += 1
            assert live[i0:i0 + query_rows, j0:j0 + key_rows].any(), (j0, i0)
        assert (cover[live] == 1).all()
    if not live.any():
        assert kv_visits == [] and q_visits == []
    # the longest walks first: each side's CTAs in launch order walk no
    # more tiles than the one before
    for ctas in (kv_ctas, q_ctas):
        walks = [max(map(len, cta)) for cta in ctas]
        assert walks == sorted(walks, reverse=True), walks
        assert all(len(cta) == rows // wg for cta in ctas)
    want = ta.flash_attn_bwd_reference(tq, tk, tv, lse, torch.from_numpy(g_o),
                                       torch.from_numpy(g_l), causal=causal, kv_offset=off)
    _, vjp = jax.vjp(lambda *a: ja.chunk_attention(*a, causal=causal, kv_offset=off),
                     *_j(q, k, v))
    jgrads = vjp((jnp.asarray(g_o), jnp.asarray(g_l)))
    for got, ref, jgrad in zip((dq, dk, dv), want, jgrads):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(jgrad), **GRAD_TOL)


# the kernels' bf16 rounding (inputs, P and dS as product operands, the
# gradients stored) against the f32 gradients of the same bf16 inputs:
# relative L2 per gradient, the limit chip_smoke.py holds the kernels to
# against the plain version on the card
BWD_REL_TOL = 2e-2


@pytest.mark.parametrize("d", [32, 96, 128])
def test_emulated_bwd_bf16_rounding_matches_jax_f32(d):
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in make_qkv(b=1, s=130, h=2, d=d, sk=150, seed=24))
    g_o, g_l = _cotangents(q, 25)
    _, lse = _forward(q, k, v, True, 3)
    dq, dk, dv, *_ = _emulated_bwd(q, k, v, lse, torch.from_numpy(g_o).bfloat16(),
                                     torch.from_numpy(g_l), causal=True, kv_offset=3,
                                     round_to=torch.bfloat16)
    _, vjp = jax.vjp(lambda *a: ja.chunk_attention(*a, causal=True, kv_offset=3),
                     *_j(*(x.float().numpy() for x in (q, k, v))))
    jgrads = vjp((jnp.asarray(torch.from_numpy(g_o).bfloat16().float().numpy()),
                  jnp.asarray(g_l)))
    for got, jgrad in zip((dq, dk, dv), jgrads):
        want = torch.from_numpy(np.asarray(jgrad))
        assert ((got - want).norm() / want.norm()).item() <= BWD_REL_TOL


def test_bwd_tile_constants_match_the_kernels():
    """The Python mirrors of the backward kernels' tiling, read from
    ``csrc/flash_attn_bwd.cu`` itself: the rows a CTA holds
    (``kBwdCtaRows``) and a consumer owns (``kBwdWgRows``), the loop tile
    (``BwdTile<DT>::kInner``, ``bwd_inner_rows``), the tiles the launch
    picks from (``BWD_HEAD_DIMS``), and the scratch's rows (Sq rounded up
    to whole CTAs, ``bwd_scratch_rows``), which the wrapper sizes and the
    kernels index."""
    import re
    from pathlib import Path

    src = (Path(ta.__file__).resolve().parent.parent / "csrc" / "flash_attn_bwd.cu").read_text()

    def const(name):
        (value,) = re.findall(rf"constexpr int {name} = (\d+);", src)
        return int(value)

    assert const("kBwdCtaRows") == ta.BWD_CTA_ROWS
    assert const("kBwdWgRows") == ta.BWD_WG_ROWS
    assert ta.BWD_CTA_ROWS == 2 * ta.BWD_WG_ROWS  # two consumer warpgroups
    assert all(ta.bwd_inner_rows(t) == const("kInner") for t in ta.BWD_HEAD_DIMS)
    tiles = [int(x) for x in re.findall(r"return launch_bwd<(\d+), kBf16>", src)]
    assert tuple(tiles) == ta.BWD_HEAD_DIMS
    assert "return (s + kBwdCtaRows - 1) / kBwdCtaRows * kBwdCtaRows;" in src
    for sq, rows in ((0, 128), (1, 128), (128, 128), (129, 256), (2048, 2048), (2049, 2176)):
        assert ta.bwd_scratch_rows(sq) == rows


# the f32 kernels' 3xTF32 products (x = hi + lo, the lo·lo term dropped:
# about 2^-20 relative a product) against the f32 gradient, relative L2 per
# gradient: the limit chip_smoke.py holds them to against the plain version
# on the card (BWD_F32_REL_TOL); one TF32 pass (about 2^-11 a product)
# misses it
BWD_F32_REL_TOL = 1e-4


def _f32_emulation_and_jax(d, einsum):
    q, k, v = make_qkv(b=1, s=130, h=2, d=d, sk=150, seed=27)
    g_o, g_l = _cotangents(q, 28)
    tq, tk, tv = _t(q, k, v)
    _, lse = _forward(tq, tk, tv, True, 3)
    got = _emulated_bwd(tq, tk, tv, lse, torch.from_numpy(g_o), torch.from_numpy(g_l),
                        causal=True, kv_offset=3, kernel="flash_attn_bwd_tf32",
                        einsum=einsum)[:3]
    _, vjp = jax.vjp(lambda *a: ja.chunk_attention(*a, causal=True, kv_offset=3),
                     *_j(q, k, v))
    want = [torch.from_numpy(np.asarray(x)) for x in vjp((jnp.asarray(g_o),
                                                           jnp.asarray(g_l)))]
    return {n: ((x - y).norm() / y.norm()).item() for n, x, y in zip(("dq", "dk", "dv"),
                                                                      got, want)}


@pytest.mark.parametrize("d", [32, 96, 128])
def test_emulated_bwd_3xtf32_matches_jax_f32(d):
    """The f32 kernels' arithmetic (every product as 3xTF32, on their tile
    schedule) within ``BWD_F32_REL_TOL`` of ``jax.vjp`` of the JAX
    package's ``chunk_attention`` in f32, cotangents on out and lse,
    ``kv_offset`` 3."""
    rel = _f32_emulation_and_jax(d, _einsum_3xtf32)
    assert max(rel.values()) <= BWD_F32_REL_TOL, rel


@pytest.mark.parametrize("d", [32, 96, 128])
def test_emulated_bwd_one_tf32_pass_misses_the_f32_gate(d):
    """The same emulation with one TF32 pass a product (the truncated
    operands) is further than ``BWD_F32_REL_TOL`` from the f32 gradient:
    the gate tells a 1xTF32 kernel from a 3xTF32 one."""
    rel = _f32_emulation_and_jax(d, _einsum_1xtf32)
    assert min(rel.values()) > BWD_F32_REL_TOL, rel


def _common_component_case(seed):
    """f32 q, k, v and the out cotangent, keys and values sharing a common
    component 4x the rest, and the f32 gradient of them (``mha_reference``
    under autograd)."""
    rng = np.random.RandomState(seed)
    common = 4 * rng.randn(1, 1, 2, 64).astype(np.float32)
    q, k, v, g = (torch.from_numpy(x) for x in (
        rng.randn(1, 128, 2, 64).astype(np.float32),
        rng.randn(1, 128, 2, 64).astype(np.float32) + common,
        rng.randn(1, 128, 2, 64).astype(np.float32) + common,
        rng.randn(1, 128, 2, 64).astype(np.float32)))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ta.mha_reference(*leaves, causal=True).backward(g)
    _, lse = ta.chunk_attention(q, k, v, causal=True)
    return (q, k, v, lse, g), [x.grad for x in leaves]


def test_emulated_bwd_3xtf32_dq_exact_when_keys_share_a_large_component():
    """Keys and values sharing a large common component (as a trained LM's
    do), f32: the f32 kernels' 3xTF32 products and exact Δ keep dq (and dk,
    dv) within ``BWD_F32_REL_TOL`` of the f32 gradient of the same
    inputs."""
    (q, k, v, lse, g), want = _common_component_case(29)
    got = _emulated_bwd(q, k, v, lse, g, None, causal=True, kv_offset=0,
                        kernel="flash_attn_bwd_tf32", einsum=_einsum_3xtf32)[:3]
    for x, w in zip(got, want):
        assert ((x - w).norm() / w.norm()).item() <= BWD_F32_REL_TOL


def test_emulated_bwd_3xtf32_centring_keeps_dq_an_order_inside_the_gate():
    """Why the f32 kernels centre K and V on the head's mean key and value:
    3xTF32's error is relative to |k| and |v|, a shared component included,
    while the gradient lives in what is left once it cancels.  On the case
    above, 3xTF32 on the raw K and V puts dq about 6e-5 off the f32
    gradient, within a factor 2 of ``BWD_F32_REL_TOL``; centred, an order
    of magnitude inside it."""
    (q, k, v, lse, g), want = _common_component_case(29)
    rel = {}
    for center in (True, False):
        dq = _emulated_bwd(q, k, v, lse, g, None, causal=True, kv_offset=0,
                           kernel="flash_attn_bwd_tf32", einsum=_einsum_3xtf32,
                           center=center)[0]
        rel[center] = ((dq - want[0]).norm() / want[0].norm()).item()
    assert rel[True] <= BWD_F32_REL_TOL / 10 < rel[False], rel


def test_bwd_tf32_tile_constants_match_the_kernel():
    """The Python mirrors of the f32 backward kernels' tiling, read from
    ``csrc/flash_attn_bwd_tf32.cu`` itself: the rows a CTA holds
    (``kCtaRows``) and a warp owns (``kWarpRows``), the loop tile
    (``Tf32BwdTile<DT>::kInner``, ``bwd_tiling``), the tiles the launch
    picks from (``BWD_HEAD_DIMS``), and the scratch's rows, the same as the
    bf16/fp16 kernels' (``bwd_scratch_rows``), which one wrapper sizes."""
    import re
    from pathlib import Path

    src = (Path(ta.__file__).resolve().parent.parent / "csrc"
           / "flash_attn_bwd_tf32.cu").read_text()

    def const(name):
        (value,) = re.findall(rf"constexpr int {name} = (\d+);", src)
        return int(value)

    assert const("kCtaRows") == ta.BWD_TF32_CTA_ROWS
    assert const("kWarpRows") == ta.BWD_TF32_WARP_ROWS
    assert ta.BWD_TF32_CTA_ROWS == 4 * ta.BWD_TF32_WARP_ROWS  # four warps
    assert const("kThreads") == 32 * ta.BWD_TF32_CTA_ROWS // ta.BWD_TF32_WARP_ROWS
    assert "static constexpr int kInner = DT <= 64 ? 64 : 32;" in src
    assert [ta.bwd_tiling("flash_attn_bwd_tf32", t) for t in ta.BWD_HEAD_DIMS] == [
        (64, 16, 64), (64, 16, 64), (64, 16, 32), (64, 16, 32)]
    tiles = [int(x) for x in re.findall(r"return launch_bwd<(\d+)>\(p, BH, s\)", src)]
    assert tuple(tiles) == ta.BWD_HEAD_DIMS
    assert const("kScratchAlign") == ta.BWD_CTA_ROWS
    assert "return (s + kScratchAlign - 1) / kScratchAlign * kScratchAlign;" in src
