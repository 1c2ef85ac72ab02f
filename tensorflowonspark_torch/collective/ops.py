"""Collective algorithms on numpy arrays over a :class:`PeerTransport`.

The cross-host tensor-plane primitives of the sync-training path: chunked
ring all-reduce / reduce-scatter / all-gather (the bandwidth-optimal
algorithms of the MPI collective papers — each node moves ``2(W-1)/W x N``
bytes regardless of world size), a pipelined ring broadcast, and the naive
gather-broadcast all-reduce kept as the bench control (root moves
``2(W-1) x N`` serially — the shape ``bench_collective.py`` measures the
ring against).

Transfers are CHUNKED at ``bucket_bytes``: a ring segment larger than one
bucket goes out as a pipeline of sub-chunks, so a node's accumulate of
chunk *k* overlaps the wire time of chunk *k+1* (and no single frame ever
buffers a whole gradient).  Every message is stamped with the group's
``(generation, seq, tag)`` — see ``transport.py`` for the fencing contract.

Determinism: the reduction order of each result segment is fixed by the
ring schedule (same every run), and for ``world == 2`` both algorithms
compute the same two-operand sums — the property the sync-training
equivalence test pins against a single-process run.

Chaos seam: ``faultinject.collective_round()`` is called once per
all-reduce, *mid-algorithm* (after the first data exchange), so a ``kill``
armed on it dies with partial chunks genuinely in flight on the wire —
the worst case the generation-barrier rejoin must survive.
"""

from __future__ import annotations

import time

import numpy as np

from tensorflowonspark_torch import faultinject
from tensorflowonspark_torch.collective.transport import (
    CollectiveAborted,
    PeerTransport,
    pack_csr,
    unpack_csr,
)


def _op_deadline(tp: PeerTransport) -> float:
    """Per-OP receive deadline: every recv of one collective shares a
    single ``tp.timeout`` budget, so a round's total blocked time is
    bounded by one collective timeout — not one timeout per hop per chunk
    (the multiplicative wedge a gray peer used to be able to inflict)."""
    return time.monotonic() + tp.timeout


def _left(deadline: float) -> float:
    """Remaining recv budget (floored so a recv at the wire always gets a
    beat to drain an already-delivered frame)."""
    return max(0.05, deadline - time.monotonic())


def _segment_bounds(n: int, world: int) -> list[int]:
    """World+1 monotone bounds splitting ``n`` elements into ``world``
    near-equal contiguous segments (empty segments are fine: tiny arrays
    on big worlds still reduce correctly)."""
    return [(n * i) // world for i in range(world + 1)]


def _chunk_spans(lo: int, hi: int, chunk_elems: int) -> list[tuple[int, int]]:
    """Sub-chunk spans of ``[lo, hi)`` at most ``chunk_elems`` long; always
    at least one span so sender and receiver agree on the message count
    even for an empty segment."""
    if hi <= lo:
        return [(lo, lo)]
    spans = []
    while lo < hi:
        spans.append((lo, min(hi, lo + chunk_elems)))
        lo += chunk_elems
    return spans


def _chunk_elems(itemsize: int, bucket_bytes: int) -> int:
    return max(1, int(bucket_bytes) // max(1, itemsize))


def _as_flat_copy(arr: np.ndarray) -> np.ndarray:
    """Contiguous 1-D float-preserving accumulation copy of ``arr`` (the
    algorithms reduce in place; the caller's array is never mutated)."""
    return np.array(arr, copy=True).reshape(-1)


def ring_all_reduce(tp: PeerTransport, arr: np.ndarray, *, seq: int,
                    bucket_bytes: int, average: bool = False) -> np.ndarray:
    """Chunked ring all-reduce (reduce-scatter phase + all-gather phase).

    Returns a NEW array of ``arr``'s shape holding the element-wise sum
    (mean when ``average``) across all ranks.  Safe against send/recv
    deadlock by construction: each peer's inbound wire is drained by its
    dataserver connection thread independent of its compute thread, so a
    blocking send can always make progress.
    """
    world, rank = tp.world, tp.rank
    src = np.asarray(arr)
    out = _as_flat_copy(src)
    if world <= 1:
        faultinject.collective_round()
        return out.reshape(src.shape)
    bounds = _segment_bounds(out.size, world)
    chunk = _chunk_elems(out.itemsize, bucket_bytes)
    deadline = _op_deadline(tp)
    right, left = (rank + 1) % world, (rank - 1) % world
    # reduce-scatter: after step s, segment (rank - s - 1) holds the partial
    # sum of s+2 ranks; after world-1 steps rank owns segment (rank+1)%world
    for step in range(world - 1):
        si = (rank - step) % world
        ri = (rank - step - 1) % world
        send_spans = _chunk_spans(bounds[si], bounds[si + 1], chunk)
        recv_spans = _chunk_spans(bounds[ri], bounds[ri + 1], chunk)
        for k in range(max(len(send_spans), len(recv_spans))):
            if k < len(send_spans):
                lo, hi = send_spans[k]
                tp.send(right, seq, ("rs", step, k), out[lo:hi])
            if k < len(recv_spans):
                lo, hi = recv_spans[k]
                piece = tp.recv(left, seq, ("rs", step, k),
                                timeout=_left(deadline))
                if hi > lo:
                    out[lo:hi] += np.asarray(piece).reshape(-1)
    # mid-all-reduce chaos seam: partial sums are committed, the all-gather
    # exchange is still ahead — a SIGKILL (or gray stall) here leaves
    # chunks in flight
    faultinject.collective_round()
    # all-gather: circulate the finished segments
    for step in range(world - 1):
        si = (rank + 1 - step) % world
        ri = (rank - step) % world
        send_spans = _chunk_spans(bounds[si], bounds[si + 1], chunk)
        recv_spans = _chunk_spans(bounds[ri], bounds[ri + 1], chunk)
        for k in range(max(len(send_spans), len(recv_spans))):
            if k < len(send_spans):
                lo, hi = send_spans[k]
                tp.send(right, seq, ("ag", step, k), out[lo:hi])
            if k < len(recv_spans):
                lo, hi = recv_spans[k]
                piece = tp.recv(left, seq, ("ag", step, k),
                                timeout=_left(deadline))
                if hi > lo:
                    out[lo:hi] = np.asarray(piece).reshape(-1)
    if average:
        out = _averaged(out, world)
    return out.reshape(src.shape)


def _averaged(out: np.ndarray, world: int) -> np.ndarray:
    """Mean step of an averaging reduce: in place for float buffers,
    out-of-place (promoting to float) for integer ones — true division
    cannot land back in an int buffer."""
    if np.issubdtype(out.dtype, np.inexact):
        out /= world
        return out
    return out / world


def naive_all_reduce(tp: PeerTransport, arr: np.ndarray, *, seq: int,
                     average: bool = False) -> np.ndarray:
    """Gather-broadcast all-reduce through rank 0 — the control algorithm
    (``TOS_COLLECTIVE_ALGO=naive``): every rank ships its whole array to
    the root, the root reduces in rank order and ships the result back.
    Root wire traffic grows linearly with world size; kept for the bench
    comparison and as the graceful fallback for tiny payloads."""
    world, rank = tp.world, tp.rank
    src = np.asarray(arr)
    out = _as_flat_copy(src)
    if world <= 1:
        faultinject.collective_round()
        return out.reshape(src.shape)
    deadline = _op_deadline(tp)
    if rank == 0:
        for peer in range(1, world):
            piece = tp.recv(peer, seq, ("gb", "up"),
                            timeout=_left(deadline))
            out += np.asarray(piece).reshape(-1)
        faultinject.collective_round()
        if average:
            out = _averaged(out, world)
        for peer in range(1, world):
            tp.send(peer, seq, ("gb", "down"), out)
        return out.reshape(src.shape)
    tp.send(0, seq, ("gb", "up"), out)
    faultinject.collective_round()
    reduced = np.asarray(tp.recv(0, seq, ("gb", "down"),
                                 timeout=_left(deadline)))
    return np.array(reduced, copy=True).reshape(src.shape)


def reduce_scatter(tp: PeerTransport, arr: np.ndarray, *, seq: int,
                   bucket_bytes: int,
                   average: bool = False) -> tuple[int, np.ndarray]:
    """Ring reduce-scatter: returns ``(segment_index, reduced_segment)`` —
    this rank ends up owning the fully-reduced segment
    ``(rank + 1) % world`` of the flattened array."""
    world, rank = tp.world, tp.rank
    src = np.asarray(arr)
    out = _as_flat_copy(src)
    if world <= 1:
        return 0, out.reshape(src.shape)
    bounds = _segment_bounds(out.size, world)
    chunk = _chunk_elems(out.itemsize, bucket_bytes)
    deadline = _op_deadline(tp)
    right, left = (rank + 1) % world, (rank - 1) % world
    for step in range(world - 1):
        si = (rank - step) % world
        ri = (rank - step - 1) % world
        send_spans = _chunk_spans(bounds[si], bounds[si + 1], chunk)
        recv_spans = _chunk_spans(bounds[ri], bounds[ri + 1], chunk)
        for k in range(max(len(send_spans), len(recv_spans))):
            if k < len(send_spans):
                lo, hi = send_spans[k]
                tp.send(right, seq, ("rs", step, k), out[lo:hi])
            if k < len(recv_spans):
                lo, hi = recv_spans[k]
                piece = tp.recv(left, seq, ("rs", step, k),
                                timeout=_left(deadline))
                if hi > lo:
                    out[lo:hi] += np.asarray(piece).reshape(-1)
    own = (rank + 1) % world
    seg = out[bounds[own]:bounds[own + 1]]
    if average:
        seg = seg / world
    return own, np.array(seg, copy=True)


def all_gather(tp: PeerTransport, arr: np.ndarray, *,
               seq: int) -> list[np.ndarray]:
    """Ring all-gather of per-rank arrays (shapes may differ across ranks —
    frames are self-describing); returns the list indexed by rank."""
    world, rank = tp.world, tp.rank
    own = np.ascontiguousarray(np.asarray(arr))
    if world <= 1:
        return [np.array(own, copy=True)]
    out: list = [None] * world
    out[rank] = np.array(own, copy=True)
    deadline = _op_deadline(tp)
    right, left = (rank + 1) % world, (rank - 1) % world
    cur = own
    for step in range(world - 1):
        tp.send(right, seq, ("ag", step), cur)
        cur = np.asarray(tp.recv(left, seq, ("ag", step),
                                 timeout=_left(deadline)))
        out[(rank - step - 1) % world] = np.array(cur, copy=True)
    return out


def broadcast(tp: PeerTransport, arr: np.ndarray | None, *, seq: int,
              root: int, bucket_bytes: int) -> np.ndarray:
    """Pipelined ring broadcast from ``root``: the value flows
    root -> root+1 -> ... around the ring, chunked at ``bucket_bytes`` so a
    middle rank forwards chunk *k* while chunk *k+1* is still inbound.
    Non-root ranks pass ``arr=None`` and get the root's array back (shape
    and dtype ride a header frame)."""
    world, rank = tp.world, tp.rank
    if world <= 1:
        if arr is None:
            raise ValueError("broadcast root must supply the array")
        return np.array(np.asarray(arr), copy=True)
    right = (rank + 1) % world
    last = (root - 1) % world  # the ring's tail: never forwards
    if rank == root:
        if arr is None:
            raise ValueError("broadcast root must supply the array")
        flat = np.ascontiguousarray(np.asarray(arr)).reshape(-1)
        chunk = _chunk_elems(flat.itemsize, bucket_bytes)
        spans = _chunk_spans(0, flat.size, chunk)
        header = {"chunks": len(spans), "shape": tuple(np.asarray(arr).shape),
                  "dtype": str(flat.dtype)}
        tp.send(right, seq, ("bc", "hdr"), header)
        for k, (lo, hi) in enumerate(spans):
            tp.send(right, seq, ("bc", k), flat[lo:hi])
        return np.array(np.asarray(arr), copy=True)
    deadline = _op_deadline(tp)
    left = (rank - 1) % world
    header = tp.recv(left, seq, ("bc", "hdr"), timeout=_left(deadline))
    if rank != last:
        tp.send(right, seq, ("bc", "hdr"), header)
    pieces = []
    for k in range(int(header["chunks"])):
        piece = np.asarray(tp.recv(left, seq, ("bc", k),
                                   timeout=_left(deadline)))
        if rank != last:
            tp.send(right, seq, ("bc", k), piece)
        pieces.append(piece.reshape(-1))
    flat = (np.concatenate(pieces) if len(pieces) != 1
            else np.array(pieces[0], copy=True))
    return flat.astype(np.dtype(header["dtype"]), copy=False).reshape(
        header["shape"])


def all_reduce(tp: PeerTransport, arr: np.ndarray, *, seq: int,
               bucket_bytes: int, algo: str = "ring",
               average: bool = False) -> np.ndarray:
    """Algorithm dispatch (``TOS_COLLECTIVE_ALGO``)."""
    if algo == "ring":
        return ring_all_reduce(tp, arr, seq=seq, bucket_bytes=bucket_bytes,
                               average=average)
    if algo == "naive":
        return naive_all_reduce(tp, arr, seq=seq, average=average)
    raise CollectiveAborted(f"unknown collective algorithm {algo!r} "
                            "(expected 'ring' or 'naive')")


# -- sparse collectives (embedding tier) ---------------------------------------
#
# Model-parallel embedding tables exchange {row id -> row} SETS, not dense
# segments: each step touches a batch-sized sliver of a table far too large
# to all-reduce.  Both ops below are personalized exchanges over the same
# generation-fenced wire as the dense ring — the large-message MPI
# characterization regime (arxiv 1810.11112) where message COUNT is fixed
# (W-1 pairwise frames) and bytes scale with touched rows, not table size.


def sparse_all_to_all(tp: PeerTransport, parts: list, *,
                      seq: int) -> list:
    """Personalized all-to-all of per-destination (ids, values) CSR pairs.

    ``parts`` is a world-length list: ``parts[d]`` is the ``(ids, values)``
    pair bound for rank ``d`` (``values`` may be ``None`` for id-only lookup
    requests; ids may be empty — the empty-partition edge ships a zero-row
    frame so sender and receiver always agree on the message count).
    Returns a world-length list indexed by SOURCE rank of ``(ids, values)``
    received; the local part comes back as-is (no self-send).

    Schedule: round ``off`` pairs rank with ``rank+off`` (send) and
    ``rank-off`` (recv) — a fixed permutation schedule, so duplicate-free
    progress needs no global coordination and determinism is inherited by
    everything built on top.
    """
    world, rank = tp.world, tp.rank
    if len(parts) != world:
        raise CollectiveAborted(
            f"sparse_all_to_all needs one part per rank: got {len(parts)} "
            f"parts at world {world}")
    out: list = [None] * world
    ids0, vals0 = parts[rank] if isinstance(parts[rank], tuple) else (parts[rank], None)
    out[rank] = unpack_csr(pack_csr(ids0, vals0))
    if world <= 1:
        faultinject.collective_round()
        return out
    deadline = _op_deadline(tp)
    for off in range(1, world):
        dst = (rank + off) % world
        src = (rank - off) % world
        ids, vals = parts[dst] if isinstance(parts[dst], tuple) else (parts[dst], None)
        tp.send(dst, seq, ("sa", off), pack_csr(ids, vals))
        if off == 1:
            # mid-exchange chaos seam: the first pairwise frames are on the
            # wire, the rest of the permutation schedule is still ahead
            faultinject.collective_round()
        out[src] = unpack_csr(tp.recv(src, seq, ("sa", off),
                                      timeout=_left(deadline)))
    return out


def combine_csr(ids_list: list, rows_list: list,
                dim: int) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic exact-sum combine of CSR contributions: concatenate in
    LIST ORDER, then unbuffered scatter-add (``np.add.at``) into the sorted
    unique-id index space.

    This is the ONE summation kernel of the sparse path — the distributed
    reduce-scatter sums each owner's contributions through it in rank order,
    and the single-process reference replays the same per-node contribution
    lists through it, so the two trajectories are bit-for-bit equal (float
    addition is order-sensitive; sharing the kernel pins the order).
    """
    kept_i = [np.asarray(i, dtype=np.int64).reshape(-1) for i in ids_list]
    n = sum(i.size for i in kept_i)
    if n == 0:
        return (np.empty((0,), np.int64), np.empty((0, dim), np.float32))
    kept_r = [np.asarray(r, np.float32).reshape(-1, dim)
              for r in rows_list if r is not None and np.asarray(r).size]
    ids_all = np.concatenate(kept_i) if len(kept_i) != 1 else kept_i[0]
    rows_all = (np.concatenate(kept_r, axis=0) if len(kept_r) != 1
                else kept_r[0])
    if rows_all.shape[0] != ids_all.shape[0]:
        raise CollectiveAborted(
            f"CSR combine mismatch: {ids_all.shape[0]} ids vs "
            f"{rows_all.shape[0]} rows")
    uniq, inv = np.unique(ids_all, return_inverse=True)
    acc = np.zeros((uniq.size, dim), np.float32)
    np.add.at(acc, inv, rows_all)
    return uniq, acc


def sparse_reduce_scatter(tp: PeerTransport, ids: np.ndarray,
                          rows: np.ndarray, bounds, *,
                          seq: int) -> tuple[np.ndarray, np.ndarray]:
    """Sparse reduce-scatter: every rank contributes (ids, rows); each row
    gradient scatters back to the rank whose shard range (``bounds``, the
    embedding plan's world+1 monotone id bounds) owns its id, where
    duplicates — within one contributor and across contributors — are
    EXACT-summed in rank order via :func:`combine_csr`.

    Returns ``(uniq_ids, summed_rows)`` for this rank's own id range.
    A rank with zero ids for some owner still ships the empty CSR frame
    (message-count agreement, like the dense ring's empty segments).
    """
    world, rank = tp.world, tp.rank
    ids = np.asarray(ids, dtype=np.int64).reshape(-1)
    rows = np.asarray(rows, np.float32)
    if rows.ndim != 2:
        raise CollectiveAborted(
            f"sparse_reduce_scatter rows must be [n, dim], got shape "
            f"{rows.shape} (pass np.empty((0, dim)) for an empty "
            "contribution — dim must survive the empty edge)")
    if rows.shape[0] != ids.size:
        raise CollectiveAborted(
            f"sparse_reduce_scatter got {ids.size} ids for "
            f"{rows.shape[0]} rows")
    dim = int(rows.shape[1])
    bounds = np.asarray(bounds, dtype=np.int64)
    if bounds.size != world + 1:
        raise CollectiveAborted(
            f"sparse_reduce_scatter bounds must have world+1={world + 1} "
            f"entries, got {bounds.size}")
    if ids.size and (ids.min() < bounds[0] or ids.max() >= bounds[-1]):
        raise CollectiveAborted(
            f"sparse ids outside the shard plan [{bounds[0]}, {bounds[-1]})")
    # partition by owner: searchsorted over the interior bounds maps each id
    # to the rank whose [bounds[r], bounds[r+1]) range holds it
    owner = np.searchsorted(bounds[1:-1], ids, side="right")
    parts = []
    for dst in range(world):
        take = np.flatnonzero(owner == dst)
        parts.append((ids[take], rows[take]))
    got = sparse_all_to_all(tp, parts, seq=seq)
    # rank-order combine: got[] is already indexed by source rank
    return combine_csr([g[0] for g in got], [g[1] for g in got], dim)
