"""Reactor TCP frontend for the serving gateway.

One thread, every connection.  The previous frontend spent an OS thread per
client (``_serve_conn``) and a full blocking round-trip per request — at
production fan-in the thread wakeups and the one-request-per-RTT discipline,
not the model, were the ceiling (BENCH_r07: 1,122 req/s in-process vs 316
through TCP).  This module replaces it with the event-driven design of the
TensorFlow-Serving lineage:

- a single ``selectors``-based reactor thread owns the listener and every
  client socket (all non-blocking): non-blocking accept, incremental HMAC
  handshake, incremental v1/v2 frame decode with bounded buffers;
- **request pipelining** — each request may carry a client-assigned id,
  many requests stay outstanding per socket, and responses are written back
  *out of order by id* the moment their micro-batches complete.  A legacy
  peer that sends id-less requests (the pre-reactor ``GatewayClient``)
  keeps working: depth 1, id-less replies, same wire bytes;
- **zero-copy responses** — replies are protocol-5 v2 frames
  (``dataserver.frame_parts``) whose result arrays travel as out-of-band
  buffers; writes go through one non-blocking ``sendmsg`` attempt
  (``utils.net.sendmsg_some``) and partial writes park on a per-connection
  write queue re-armed by ``EVENT_WRITE`` — the reactor never blocks;
- **backpressure end to end** — per-connection outstanding-request cap
  (``TOS_SERVE_CONN_OUTSTANDING``) and the batcher's bounded admission
  queue (``TOS_SERVE_QUEUE``) both answer fast-fail ``unavailable`` (503)
  replies synchronously on the reactor, no thread handoff; a connection
  whose write queue backs up past a high-water mark stops being read until
  it drains.

Threading contract: every ``_on_*`` / ``_run`` / sweep method runs ONLY on
the reactor thread and must never block (enforced statically by the
``reactor-discipline`` toslint rule).  Completions arrive from batcher /
router threads via ``MicroBatcher.add_done_callback`` → ``_request_done``,
which appends the resolved request to a thread-safe queue and wakes the
reactor through a self-pipe; the reactor serializes at drain time, where
one scatter's replies to one connection coalesce into a single
multi-reply frame.  ``stop()`` runs on the caller's thread and is the one
place allowed to join.

Connection lifecycle: accept → server nonce sent → client blob verified
(stalls reaped after ``TOS_SERVE_HANDSHAKE_TIMEOUT``) → open (frames flow)
→ close (peer EOF, ``close`` op, protocol error, or shutdown).  A client
that disconnects with requests in flight has them cancelled so batcher
admission slots free immediately; results already computing are discarded
at scatter time.
"""

from __future__ import annotations

import collections
import contextlib
import heapq
import logging
import os
import pickle
import selectors
import socket
import struct
import sys
import threading
from time import monotonic as _monotonic

from tensorflowonspark_torch import telemetry
from tensorflowonspark_torch.telemetry import trace as ttrace
from tensorflowonspark_torch.dataserver import (  # shared framing constants
    _LEN,
    _MAX_SECTIONS,
    _VEC_BIT,
    frame_parts,
)
from tensorflowonspark_torch.serving.batcher import (
    MicroBatcher,
    ServeClosed,
    ServeQueueFull,
    ServeThrottled,
    ServeTimeout,
)
from tensorflowonspark_torch.utils.envtune import env_float, env_int
from tensorflowonspark_torch.utils.net import (
    HANDSHAKE_BLOB_BYTES,
    byte_views,
    hmac_server_challenge,
    hmac_server_verify,
    sendmsg_some,
    set_nodelay,
)

logger = logging.getLogger(__name__)

#: Hard per-frame bound: a request frame declaring more than this is a
#: protocol error and the connection is dropped before any allocation —
#: the read-side buffer bound of the reactor.
MAX_REQUEST_FRAME = 256 << 20
#: Per-read chunk; also the parse granularity of the incremental decoder.
_READ_CHUNK = 1 << 16
# Write-queue flow control: a connection whose un-flushed replies exceed
# the high-water mark stops being read (its requests stop being admitted)
# until the kernel drains it below the low-water mark.
_WRITE_HIGH_WATER = 8 << 20
_WRITE_LOW_WATER = 1 << 20

#: Decoder sentinel: the buffer does not hold a complete frame yet.  (A
#: dedicated object, NOT ``None`` — ``None`` is a pickleable frame value.)
_INCOMPLETE = object()


class ProtocolError(ConnectionError):
    """Malformed/hostile frame: the connection is dropped, the reactor and
    every other connection keep running."""


class FrameDecoder:
    """Incremental parser of the data plane's v1/v2 wire frames.

    Feed raw bytes; ``next_frame()`` returns one decoded object per call or
    ``_INCOMPLETE``.  Both formats are self-describing on the wire (the top
    bit of the length word), so legacy v1 peers and v2 pipelined clients
    share one decoder.  Complete frames are carved out as independent
    bytes objects before unpickling, so out-of-band buffer views never pin
    the (reused) read buffer.
    """

    __slots__ = ("buf",)

    def __init__(self) -> None:
        self.buf = bytearray()

    def feed(self, data: bytes) -> None:
        self.buf += data

    def next_frame(self):
        buf = self.buf
        if len(buf) < 8:
            return _INCOMPLETE
        (word,) = _LEN.unpack_from(buf, 0)
        if word & _VEC_BIT:
            nsec = word & (_VEC_BIT - 1)
            if not 1 <= nsec <= _MAX_SECTIONS:
                raise ProtocolError(f"corrupt vectorized frame ({nsec} sections)")
            hdr = 8 + 8 * nsec
            if len(buf) < hdr:
                return _INCOMPLETE
            lens = struct.unpack_from(f">{nsec}Q", buf, 8)
            total = sum(lens)
            if total > MAX_REQUEST_FRAME:
                raise ProtocolError(f"oversized frame ({total} bytes)")
            if len(buf) < hdr + total:
                return _INCOMPLETE
            view = memoryview(buf)
            body = bytes(view[hdr:hdr + lens[0]])
            blob = bytes(view[hdr + lens[0]:hdr + total])
            view.release()
            del buf[:hdr + total]
            bview = memoryview(blob)
            bufs, off = [], 0
            for ln in lens[1:]:
                bufs.append(bview[off:off + ln])
                off += ln
            return self._loads(body, bufs)
        if word > MAX_REQUEST_FRAME:
            raise ProtocolError(f"oversized frame ({word} bytes)")
        if len(buf) < 8 + word:
            return _INCOMPLETE
        body = bytes(memoryview(buf)[8:8 + word])
        del buf[:8 + word]
        return self._loads(body, None)

    @staticmethod
    def _loads(body: bytes, bufs):
        # hostile pickle bytes can raise nearly anything (UnpicklingError,
        # EOFError, AttributeError, ...): every decode failure is a protocol
        # error on THIS connection, never a reactor death
        try:
            return (pickle.loads(body, buffers=bufs) if bufs is not None
                    else pickle.loads(body))
        except Exception as e:  # noqa: BLE001 - see comment above
            raise ProtocolError(
                f"undecodable frame: {type(e).__name__}: {e}") from e


class _Conn:
    """Reactor-thread-owned per-connection state."""

    __slots__ = ("sock", "fd", "peer", "decoder", "authed", "hs_nonce",
                 "hs_deadline", "wviews", "wbytes", "outstanding", "closing",
                 "events", "paused_read")

    def __init__(self, sock: socket.socket, peer, hs_deadline: float):
        self.sock = sock
        self.fd = sock.fileno()
        self.peer = peer
        self.decoder = FrameDecoder()
        self.authed = False
        self.hs_nonce = hmac_server_challenge()
        self.hs_deadline = hs_deadline
        self.wviews: list = []       # pending write views (flat, in order)
        self.wbytes = 0              # pending write bytes (flow control)
        self.outstanding: dict = {}  # _Request -> client id (None = legacy)
        self.closing = False         # close after the write queue flushes
        self.events = 0              # currently registered selector mask
        self.paused_read = False     # write-queue high-water reached


class ReactorFrontend:
    """The gateway's TCP endpoint: one reactor thread, pipelined clients.

    ``listener`` must already be bound+listening; the frontend owns it from
    here (including close at ``stop()``).  ``batcher`` is the gateway's
    :class:`MicroBatcher`; admission errors it raises become fast-fail
    replies without leaving the reactor thread.
    """

    def __init__(self, listener: socket.socket, authkey: bytes,
                 batcher: MicroBatcher, *, default_timeout: float,
                 handshake_timeout: float | None = None,
                 max_conn_outstanding: int | None = None):
        self._listener = listener
        listener.setblocking(False)
        self._authkey = authkey
        self._batcher = batcher
        self._default_timeout = float(default_timeout)
        self._handshake_timeout = (
            float(handshake_timeout) if handshake_timeout is not None
            else env_float("TOS_SERVE_HANDSHAKE_TIMEOUT", 5.0))
        self._max_outstanding = (
            int(max_conn_outstanding) if max_conn_outstanding is not None
            else env_int("TOS_SERVE_CONN_OUTSTANDING", 128))
        if self._handshake_timeout <= 0 or self._max_outstanding < 1:
            raise ValueError("handshake_timeout must be > 0 and "
                             "max_conn_outstanding >= 1")
        self._sel = selectors.DefaultSelector()
        # self-pipe: completion threads wake the reactor out of select()
        self._wake_r, self._wake_w = os.pipe()
        os.set_blocking(self._wake_r, False)
        os.set_blocking(self._wake_w, False)
        #: (conn, resolved request, client id) from completion threads;
        #: deque append/popleft are atomic — no lock needed.
        self._completions: collections.deque = collections.deque()
        self._wake_pending = False
        self._conns: dict[int, _Conn] = {}   # reactor-thread only
        # mid-handshake connections only (reactor-thread only): the
        # per-pass deadline scans walk THIS set, not every established
        # connection — at production fan-in the steady-state conns must
        # cost the hot loop nothing
        self._handshaking: set[_Conn] = set()
        # deadline tracking (reactor-thread only): heap of mutable
        # [deadline, seq, req, conn] entries + req -> entry index.  When a
        # request resolves its entry is BLANKED (req/conn set to None), not
        # searched out of the heap — otherwise every resolved request (its
        # rows, results, and connection) would stay pinned until its
        # deadline passed, which at qps x timeout scale is real memory.
        self._deadline_heap: list = []
        self._deadline_entries: dict = {}
        self._deadline_seq = 0
        self._n_outstanding = 0
        self._stopping = False
        self._stopped = False
        self._conn_gauge = telemetry.gauge("serve.frontend.connections")
        self._outstanding_gauge = telemetry.gauge(
            "serve.frontend.outstanding")
        self._frames_in = telemetry.counter("serve.frontend.frames_in")
        self._frames_out = telemetry.counter("serve.frontend.frames_out")
        self._loop_lag = telemetry.histogram("serve.frontend.loop_lag_secs")
        self._conn_gauge.set(0)
        self._outstanding_gauge.set(0)
        # A serving driver is a latency process: the interpreter's default
        # 5ms GIL switch interval convoys every reactor<->batcher<->router
        # handoff into a multi-millisecond stall (measured: ~40% of the
        # instant-model wire ceiling on the 2-core bench box).  1ms trades
        # a little switch overhead for bounded handoff latency; restored
        # at stop().  TOS_SERVE_SWITCH_INTERVAL tunes it (5 = CPython's
        # default, effectively opting out).
        self._prev_switch_interval = sys.getswitchinterval()
        sys.setswitchinterval(
            env_float("TOS_SERVE_SWITCH_INTERVAL", 1.0) / 1e3)
        self._sel.register(listener, selectors.EVENT_READ, "accept")
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wakeup")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-reactor")
        self._thread.start()

    # -- reactor loop (reactor thread only) ----------------------------------

    def _run(self) -> None:
        while not self._stopping:
            events = self._sel.select(self._next_timeout())
            t0 = _monotonic()
            if self._stopping:
                break
            for key, mask in events:
                try:
                    if key.data == "accept":
                        self._on_accept()
                    elif key.data == "wakeup":
                        self._on_wakeup()
                    else:
                        conn = key.data
                        if mask & selectors.EVENT_WRITE:
                            self._on_writable(conn)
                        if (mask & selectors.EVENT_READ
                                and self._conns.get(conn.fd) is conn):
                            self._on_readable(conn)
                except Exception:  # noqa: BLE001 - one bad connection must never kill the reactor
                    logger.exception("reactor event handler failed")
                    if isinstance(key.data, _Conn):
                        self._close_conn(key.data, "handler error")
            self._drain_completions()
            self._sweep_deadlines()
            self._reap_handshakes()
            if events:
                # reactor-loop lag: how long this pass kept new events
                # waiting (the single-thread design's latency tax — watch
                # its p99 before blaming the model)
                self._loop_lag.observe(_monotonic() - t0)
        self._teardown()

    def _next_timeout(self) -> float:
        now = _monotonic()
        nxt = now + 0.5
        for conn in self._handshaking:
            if conn.hs_deadline < nxt:
                nxt = conn.hs_deadline
        if self._deadline_heap and self._deadline_heap[0][0] < nxt:
            nxt = self._deadline_heap[0][0]
        return max(0.0, min(nxt - now, 0.5))

    def _on_accept(self) -> None:
        while True:
            try:
                sock, peer = self._listener.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return  # listener closed under us (shutdown)
            sock.setblocking(False)
            set_nodelay(sock)
            conn = _Conn(sock, peer,
                         _monotonic() + self._handshake_timeout)
            self._conns[conn.fd] = conn
            self._handshaking.add(conn)
            self._sel.register(sock, selectors.EVENT_READ, conn)
            conn.events = selectors.EVENT_READ
            self._conn_gauge.set(len(self._conns))
            telemetry.counter("serve.frontend.accepts").inc()
            # server speaks first: its handshake nonce
            self._queue_write(conn, [conn.hs_nonce])

    def _on_wakeup(self) -> None:
        with contextlib.suppress(BlockingIOError, InterruptedError):
            while os.read(self._wake_r, 4096):
                pass

    def _on_readable(self, conn: _Conn) -> None:
        try:
            while not conn.paused_read:
                try:
                    data = conn.sock.recv(_READ_CHUNK)
                except (BlockingIOError, InterruptedError):
                    break
                if not data:
                    self._close_conn(conn, "peer closed")
                    return
                conn.decoder.feed(data)
                if not self._process_buffer(conn):
                    return  # connection closed while processing
                if len(data) < _READ_CHUNK:
                    break
        except ProtocolError as e:
            telemetry.counter("serve.frontend.protocol_errors").inc()
            logger.warning("gateway connection %s: %s; disconnecting",
                           conn.peer, e)
            self._close_conn(conn, "protocol error")
        except OSError as e:
            self._close_conn(conn, f"read failed: {e}")

    def _process_buffer(self, conn: _Conn) -> bool:
        """Drain every complete frame (and the handshake blob) from the
        connection's decode buffer; False when the connection was closed."""
        if not conn.authed:
            if len(conn.decoder.buf) < HANDSHAKE_BLOB_BYTES:
                return True
            blob = bytes(conn.decoder.buf[:HANDSHAKE_BLOB_BYTES])
            del conn.decoder.buf[:HANDSHAKE_BLOB_BYTES]
            ok, proof = hmac_server_verify(self._authkey, conn.hs_nonce, blob)
            if not ok:
                telemetry.counter("serve.frontend.auth_failures").inc()
                logger.warning("rejected gateway connection from %s: bad "
                               "authkey", conn.peer)
                # closing BEFORE the queue: the flush that drains the proof
                # frame closes the connection (possibly inline right here)
                conn.closing = True
                self._set_events(conn, conn.events & ~selectors.EVENT_READ)
                self._queue_write(conn, [proof])
                return self._conns.get(conn.fd) is conn
            self._queue_write(conn, [proof])
            conn.authed = True
            conn.hs_deadline = 0.0
            self._handshaking.discard(conn)
        admissions: list = []  # (rows, deadline, done_cb) per predict frame
        rids: list = []
        while self._conns.get(conn.fd) is conn and not conn.closing:
            obj = conn.decoder.next_frame()
            if obj is _INCOMPLETE:
                break
            self._frames_in.inc()
            self._handle_frame(conn, obj, admissions, rids)
        if admissions and self._conns.get(conn.fd) is conn:
            self._admit(conn, admissions, rids)
        return self._conns.get(conn.fd) is conn

    def _admit(self, conn: _Conn, admissions: list, rids: list) -> None:
        """Bulk-admit one read pass's predict frames: ONE batcher critical
        section for the whole pipelined burst."""
        out = self._batcher.submit_many(admissions)
        for (_rows, deadline, _cb, _tenant), rid, res in zip(
                admissions, rids, out):
            if isinstance(res, ServeThrottled):
                # per-tenant rejection (429): THIS tenant is over budget;
                # the queue may be nowhere near full for everyone else
                self._queue_reply(conn, self._err_reply(
                    "throttled", str(res), rid))
            elif isinstance(res, ServeQueueFull):
                self._queue_reply(conn, self._err_reply(
                    "unavailable", str(res), rid))
            elif isinstance(res, ServeClosed):
                self._queue_reply(conn, self._err_reply("closed", str(res), rid))
            else:
                conn.outstanding[res] = rid
                self._n_outstanding += 1
                self._deadline_seq += 1
                entry = [deadline, self._deadline_seq, res, conn]
                heapq.heappush(self._deadline_heap, entry)
                self._deadline_entries[res] = entry
        self._outstanding_gauge.set(self._n_outstanding)

    def _handle_frame(self, conn: _Conn, msg, admissions: list,
                      rids: list) -> None:
        if not isinstance(msg, tuple) or not msg:
            raise ProtocolError(f"malformed request frame: {type(msg).__name__}")
        op = msg[0]
        if op == "predict":
            if len(msg) < 2:
                raise ProtocolError("predict frame without rows")
            rid = msg[3] if len(msg) > 3 else None  # None = legacy depth-1
            try:
                timeout = (float(msg[2])
                           if len(msg) > 2 and msg[2] is not None
                           else self._default_timeout)
                rows = list(msg[1])
                # optional tenant key (v3 field; legacy 3/4-tuple frames —
                # and v2 peers that omit it — land on the anonymous tenant)
                tenant = (str(msg[4]) if len(msg) > 4 and msg[4] is not None
                          else "")
            except (TypeError, ValueError) as e:
                raise ProtocolError(f"bad predict frame: {e}") from e
            if timeout != timeout or timeout == float("inf"):
                # a NaN deadline would poison the shared deadline heap
                # (NaN comparisons are always False — heap order breaks
                # frontend-wide); inf would opt out of expiry entirely
                raise ProtocolError(f"non-finite predict timeout: {timeout!r}")
            if not rows:
                self._queue_reply(conn, self._err_reply(
                    "internal", "predict needs at least one row", rid))
                return
            if (len(conn.outstanding) + len(admissions)
                    >= self._max_outstanding):
                # per-connection pipelining cap: fast-fail 503, no handoff
                telemetry.counter("serve.frontend.throttled_total").inc()
                self._queue_reply(conn, self._err_reply(
                    "unavailable", f"connection pipelining cap "
                    f"({self._max_outstanding} outstanding); widen "
                    f"TOS_SERVE_CONN_OUTSTANDING or add connections", rid))
                return
            deadline = _monotonic() + timeout
            admissions.append((rows, deadline,
                               lambda r, c=conn, i=rid:
                               self._request_done(c, r, i),
                               tenant))
            rids.append(rid)
        elif op == "ping":
            rid = msg[1] if len(msg) > 1 else None
            self._queue_reply(conn, ("ok", "pong") if rid is None
                              else ("ok", "pong", rid))
        elif op == "close":
            # closing BEFORE the queue: the flush that drains the ack frame
            # closes the connection (possibly inline)
            conn.closing = True
            self._set_events(conn, conn.events & ~selectors.EVENT_READ)
            self._queue_reply(conn, ("ok",))
        else:
            self._queue_reply(conn, self._err_reply(
                "internal", f"unknown op {op!r}",
                msg[-1] if len(msg) > 1 and isinstance(msg[-1], int) else None))

    @staticmethod
    def _err_reply(kind: str, text: str, rid) -> tuple:
        return (("err", kind, text) if rid is None
                else ("err", kind, text, rid))

    # -- completion path (batcher/router threads) ----------------------------

    def _request_done(self, conn: _Conn, req, rid) -> None:
        """Done callback (router/batcher threads): hand the resolved
        request to the reactor via the completion queue + self-pipe.
        Serialization happens at drain time, where same-connection replies
        from one scatter coalesce into a single multi-reply frame — one
        pickle and one sendmsg for a whole batch instead of one each."""
        self._completions.append((conn, req, rid))
        self._wakeup()

    @staticmethod
    def _reply_entry(req, rid) -> tuple:
        """(rid, "ok", results) / (rid, "err", kind, text) — the per-request
        payload of a multi-reply ``okm`` frame; ``entry[1:]`` is exactly the
        legacy single-reply tuple shape."""
        err = req.error
        if err is None:
            return (rid, "ok", req.results)
        kind = ("throttled" if isinstance(err, ServeThrottled)
                else "unavailable" if isinstance(err, ServeQueueFull)
                else "deadline" if isinstance(err, ServeTimeout)
                else "closed" if isinstance(err, ServeClosed)
                else "internal")
        return (rid, "err", kind, str(err) or type(err).__name__)

    def _wakeup(self) -> None:
        # dedup: one pending byte is enough, and the reactor resets the
        # flag BEFORE draining, so a completion enqueued after the reset
        # always writes its own wakeup — no lost signal
        if self._wake_pending:
            return
        self._wake_pending = True
        try:
            os.write(self._wake_w, b"\x00")
        except (BlockingIOError, OSError):  # toslint: allow-silent(pipe full means a wakeup is already pending; closed pipe means the reactor is gone)
            pass

    def _drain_completions(self) -> None:
        self._wake_pending = False
        # conn -> multi-reply entries; order within a conn is preserved
        grouped: dict[_Conn, list] = {}
        drained = False
        while True:
            try:
                conn, req, rid = self._completions.popleft()
            except IndexError:
                break
            drained = True
            if req in conn.outstanding:
                del conn.outstanding[req]
                self._n_outstanding -= 1
            entry = self._deadline_entries.pop(req, None)
            if entry is not None:
                entry[2] = entry[3] = None  # unpin; heap drops it on expiry
            if self._conns.get(conn.fd) is not conn:
                continue  # client gone; reply dropped
            if req.trace is not None and req.resolved_at is not None:
                # stage span: reply (request resolved -> its frame queued on
                # the reactor); the kernel write that follows is the one
                # part of the path no span can cover from this side
                ttrace.record_child("serve.reply", req.trace,
                                    req.resolved_at,
                                    _monotonic() - req.resolved_at)
            grouped.setdefault(conn, []).append(self._reply_entry(req, rid))
        if drained:
            self._outstanding_gauge.set(self._n_outstanding)
        # ONE frame and ONE flush per connection per pass: a whole
        # scatter's replies to one pipelined peer cost one pickle and one
        # sendmsg instead of one each.  Legacy (id-less) peers get their
        # classic per-request frames — they predate the okm op.
        for conn, entries in grouped.items():
            if self._conns.get(conn.fd) is not conn:
                continue
            views: list = []
            pipelined = [e for e in entries if e[0] is not None]
            for e in entries:
                if e[0] is None:
                    self._frames_out.inc()
                    views.extend(byte_views(frame_parts(e[1:], wire=2)))
            if pipelined:
                self._frames_out.inc()
                views.extend(byte_views(
                    frame_parts(("okm", pipelined), wire=2)))
            conn.wbytes += sum(len(v) for v in views)
            conn.wviews.extend(views)
            self._flush_writes(conn)

    # -- write path (reactor thread only) ------------------------------------

    def _queue_reply(self, conn: _Conn, reply: tuple) -> None:
        self._frames_out.inc()
        self._queue_write(conn, frame_parts(reply, wire=2))

    def _queue_write(self, conn: _Conn, buffers) -> None:
        if self._conns.get(conn.fd) is not conn:
            return  # closed earlier in this pass; drop the reply
        views = byte_views(buffers)
        conn.wbytes += sum(len(v) for v in views)
        conn.wviews.extend(views)
        self._flush_writes(conn)

    def _on_writable(self, conn: _Conn) -> None:
        self._flush_writes(conn)

    def _flush_writes(self, conn: _Conn) -> None:
        try:
            while conn.wviews:
                sent = sendmsg_some(conn.sock, conn.wviews)
                if sent == 0:
                    break
                conn.wbytes -= sent
        except OSError as e:
            self._close_conn(conn, f"send failed: {e}")
            return
        if conn.wviews:
            self._set_events(conn, conn.events | selectors.EVENT_WRITE)
            if conn.wbytes > _WRITE_HIGH_WATER and not conn.paused_read:
                # reply backlog: stop reading (and admitting) this client
                # until the kernel drains it — per-connection backpressure
                conn.paused_read = True
                self._set_events(conn, conn.events & ~selectors.EVENT_READ)
            elif (conn.paused_read and conn.wbytes <= _WRITE_LOW_WATER
                    and not conn.closing):
                # hysteresis: resume reads at the LOW water mark, not only
                # once the backlog fully drains
                conn.paused_read = False
                self._set_events(conn, conn.events | selectors.EVENT_READ)
        else:
            if conn.closing:
                self._close_conn(conn, "closed")
                return
            self._set_events(conn, conn.events & ~selectors.EVENT_WRITE)
            if conn.paused_read:
                conn.paused_read = False
                self._set_events(conn, conn.events | selectors.EVENT_READ)

    def _set_events(self, conn: _Conn, mask: int) -> None:
        if mask == conn.events or self._conns.get(conn.fd) is not conn:
            return
        if not mask:
            self._sel.unregister(conn.sock)
        elif conn.events:
            self._sel.modify(conn.sock, mask, conn)
        else:
            # a mask-0 connection (e.g. a closing one whose final reply hit
            # a full send buffer) is fully unregistered: re-register, don't
            # modify — modify() on an unregistered fd raises
            self._sel.register(conn.sock, mask, conn)
        conn.events = mask

    # -- sweeps (reactor thread only) ----------------------------------------

    def _sweep_deadlines(self) -> None:
        now = _monotonic()
        while self._deadline_heap and self._deadline_heap[0][0] <= now:
            _, _, req, _conn = heapq.heappop(self._deadline_heap)
            if req is None:
                continue  # resolved earlier; entry was blanked
            self._deadline_entries.pop(req, None)
            if not req.event.is_set():
                # resolves with ServeTimeout; the done callback routes the
                # "deadline" reply back through the completion queue
                self._batcher.expire(req)

    def _reap_handshakes(self) -> None:
        if not self._handshaking:
            return
        now = _monotonic()
        stalled = [c for c in self._handshaking if c.hs_deadline <= now]
        for conn in stalled:
            telemetry.counter("serve.frontend.handshake_timeouts").inc()
            logger.warning("reaping gateway connection from %s: handshake "
                           "stalled past %.1fs", conn.peer,
                           self._handshake_timeout)
            self._close_conn(conn, "handshake timeout")

    def _close_conn(self, conn: _Conn, reason: str) -> None:
        if self._conns.get(conn.fd) is not conn:
            return  # already closed this pass
        del self._conns[conn.fd]
        self._handshaking.discard(conn)
        if conn.events:
            with contextlib.suppress(KeyError, OSError, ValueError):
                self._sel.unregister(conn.sock)
        with contextlib.suppress(OSError):
            conn.sock.close()
        self._conn_gauge.set(len(self._conns))
        telemetry.counter("serve.frontend.disconnects").inc()
        if conn.outstanding:
            # free the batcher admission slots NOW; in-flight slices finish
            # on their replica and are discarded at scatter time.  cancel()
            # fires the done callbacks inline (this thread) — their replies
            # enqueue and are dropped above because the conn is deregistered.
            reqs = list(conn.outstanding)
            self._n_outstanding -= len(conn.outstanding)
            conn.outstanding.clear()
            self._outstanding_gauge.set(self._n_outstanding)
            for req in reqs:
                self._batcher.cancel(req, ServeClosed(
                    f"client disconnected ({reason}) with the request "
                    "outstanding"))
        logger.debug("gateway connection %s closed: %s", conn.peer, reason)

    def _teardown(self) -> None:
        # one last drain + non-blocking flush: the gateway closes router
        # and batcher BEFORE stop(), so the final error replies they
        # resolved are sitting in the completion queue right now — deliver
        # them (best-effort: a full send buffer still drops) instead of
        # slamming every pipelined client with a raw dead socket
        self._drain_completions()
        for conn in list(self._conns.values()):
            self._close_conn(conn, "frontend stopped")
        with contextlib.suppress(Exception):
            self._sel.close()
        with contextlib.suppress(OSError):
            self._listener.close()

    # -- lifecycle (caller threads) ------------------------------------------

    def stop(self, timeout: float = 10.0) -> None:
        """Stop accepting, cancel outstanding wire requests, close every
        connection, join the reactor.  Idempotent.

        Call with no completion producers left (the gateway closes router
        and batcher FIRST, which resolves every request): the wake-pipe
        fds are closed only here, after the join — closing them anywhere a
        racing ``_wakeup`` could still write would hand the stray byte to
        whatever unrelated file just reused the fd number."""
        if self._stopped:
            return
        self._stopped = True
        self._stopping = True
        self._wakeup()  # pop the reactor out of select(); it sees _stopping
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():  # pragma: no cover - defensive
            logger.warning("serving reactor did not stop within %.1fs",
                           timeout)
        else:
            for fd in (self._wake_r, self._wake_w):
                with contextlib.suppress(OSError):
                    os.close(fd)
        sys.setswitchinterval(self._prev_switch_interval)
