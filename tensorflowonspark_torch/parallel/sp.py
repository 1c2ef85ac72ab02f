"""Sequence parallelism over the ``sp`` axis: ring attention and Ulysses —
counterpart of ``tensorflowonspark_tpu/parallel/sp.py``.

- **Ring attention**: Q stays put, K/V shards rotate around the ``sp``
  group by ``isend``/``irecv``; each hop's chunk is ``flash_attention_fwd``
  (the Hopper kernel on a CUDA tensor) at the chunk's global ``kv_offset``,
  and the ``(O, lse)`` pairs merge in f32 (``merge_attention``).  The hop
  loop (``ring_hops``) is separate from the exchange: it asks a callable
  for the K/V chunk it holds at each hop, so the same loop runs over a
  ``torch.distributed`` ring (``ring_attention``) or over every shard in
  one process.  Gradients run back through the merges, through each
  chunk's ``lse`` (``FlashAttention`` takes its cotangent) and back round
  the ring (the exchange's backward sends each chunk's K/V gradient to the
  rank it came from).
- **Ulysses**: two ``all_to_all_single``s swap the sharded axis from the
  sequence to the heads and back, so each rank runs full-sequence
  attention (``flash_attention``) for ``H / sp`` heads.

Both take local shards ``[B, S_local, H, D]`` with the global sequence laid
out contiguously over the group (rank i holds positions
``[i·S_local, (i+1)·S_local)``).
"""

from __future__ import annotations

from typing import Callable, Literal

import torch
import torch.distributed as dist

from tensorflowonspark_torch.ops.attention import (
    NEG_INF,
    flash_attention,
    flash_attention_fwd,
    merge_attention,
)


def ring_hops(q, kv_at: Callable[[int], tuple], idx: int, n: int, *,
              causal: bool = True, sm_scale: float | None = None):
    """The ring's hop loop for shard ``idx`` of ``n``: at hop ``h`` it
    attends ``q`` to the K/V chunk ``kv_at(h)`` returns — the chunk of
    shard ``(idx - h) mod n``, at ``kv_offset = (src - idx) · S_local`` —
    and merges the result into an f32 ``(O, lse)`` accumulator (a bf16
    carry would round after every hop).  Returns ``(O in q's type, lse)``."""
    b, s, h, d = q.shape
    o = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, s, h), NEG_INF, dtype=torch.float32, device=q.device)
    for hop in range(n):
        k_cur, v_cur = kv_at(hop)
        src = (idx - hop) % n
        o_c, lse_c = flash_attention_fwd(q, k_cur, v_cur, causal=causal,
                                         sm_scale=sm_scale,
                                         kv_offset=(src - idx) * s)
        o, lse = merge_attention(o, lse, o_c, lse_c)
    return o.to(q.dtype), lse


def _exchange(tensors, send_to: int, recv_from: int, grp):
    tensors = [t.contiguous() for t in tensors]
    out = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t, send_to, grp) for t in tensors]
           + [dist.P2POp(dist.irecv, o, recv_from, grp) for o in out])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """``(k, v)`` to the next rank of the ring, the previous rank's in;
    the gradients go the other way."""

    @staticmethod
    def forward(ctx, k, v, grp):
        ctx.grp = grp
        n, me = dist.get_world_size(grp), dist.get_rank(grp)
        nxt = dist.get_global_rank(grp, (me + 1) % n)
        prev = dist.get_global_rank(grp, (me - 1) % n)
        ctx.peers = (nxt, prev)
        return tuple(_exchange((k, v), nxt, prev, grp))

    @staticmethod
    def backward(ctx, gk, gv):
        nxt, prev = ctx.peers
        gk = torch.zeros_like(gk) if gk is None else gk
        gv = torch.zeros_like(gv) if gv is None else gv
        gk, gv = _exchange((gk, gv), prev, nxt, ctx.grp)
        return gk, gv, None


def ring_attention(q, k, v, grp, *, causal: bool = True,
                   sm_scale: float | None = None, return_lse: bool = False):
    """Ring attention over the process group ``grp`` (the ``sp`` ranks in
    ring order): ``ring_hops`` with K/V rotated one rank on between hops;
    the last held chunk is attended without a further send."""
    n = dist.get_world_size(grp) if grp is not None else 1
    idx = dist.get_rank(grp) if grp is not None else 0
    held = [(k, v)]

    def kv_at(hop):
        if hop:
            held[0] = _RingShift.apply(*held[0], grp)
        return held[0]

    o, lse = ring_hops(q, kv_at, idx, n, causal=causal, sm_scale=sm_scale)
    return (o, lse) if return_lse else o


class _AllToAll(torch.autograd.Function):
    """``x`` split into ``n`` along ``split``, part i to rank i, the
    received parts concatenated along ``concat``; the gradient goes back
    the same way."""

    @staticmethod
    def forward(ctx, x, split, concat, grp):
        ctx.args = (split, concat, grp)
        return _all_to_all(x, split, concat, grp)

    @staticmethod
    def backward(ctx, g):
        split, concat, grp = ctx.args
        return _all_to_all(g, concat, split, grp), None, None, None


def _all_to_all(x, split, concat, grp):
    n = dist.get_world_size(grp)
    parts = torch.stack(x.chunk(n, dim=split))                    # [n, ...]
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts.contiguous(), group=grp)
    return torch.cat(out.unbind(0), dim=concat)


def ulysses_attention(q, k, v, grp, *, causal: bool = True,
                      sm_scale: float | None = None):
    """Ulysses attention over ``grp``: ``[B, S_local, H, D]`` →
    all-to-all → ``[B, S, H/n, D]`` → full-sequence ``flash_attention`` →
    all-to-all back.  Needs ``H`` divisible by the group's size."""
    if grp is None:
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    n = dist.get_world_size(grp)
    h = q.shape[2]
    if h % n:
        raise ValueError(f"ulysses needs heads ({h}) divisible by sp axis ({n})")
    q, k, v = (_AllToAll.apply(x, 2, 1, grp) for x in (q, k, v))
    out = flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    return _AllToAll.apply(out, 1, 2, grp)


SpImpl = Literal["ring", "ulysses"]


def sequence_parallel_attention(mesh, q, k, v, *, causal: bool = True,
                                sm_scale: float | None = None,
                                impl: SpImpl = "ring"):
    """Self-attention with the sequence sharded over the mesh's ``sp``
    axis: ``q``/``k``/``v`` are this rank's blocks ``[B_local, S/sp,
    H_local, D]`` (batch over ``dp``/``fsdp``, heads over ``tp``), and the
    result has the same layout."""
    from tensorflowonspark_torch.parallel.mesh import group

    grp = group(mesh, "sp")
    if impl == "ring":
        return ring_attention(q, k, v, grp, causal=causal, sm_scale=sm_scale)
    if impl == "ulysses":
        return ulysses_attention(q, k, v, grp, causal=causal, sm_scale=sm_scale)
    raise ValueError(f"unknown sequence-parallel impl {impl!r}")
