"""Peer-to-peer collective transport over the existing zero-copy data wire.

The tensor plane of the cross-host collectives rides the SAME wire the partition feed
already uses: a peer dials its neighbor's :class:`~tensorflowonspark_torch.
dataserver.DataServer` port, passes the cluster HMAC handshake, and sends a
``collective_attach`` op that turns the connection into a one-way stream of
v2 (protocol-5, out-of-band-buffer) chunk frames — numpy gradient chunks
scatter-gather straight from their own memory (``utils.net.sendmsg_all``)
and land in preallocated receive buffers (``recv_into`` via the dataserver
framing layer).  No second listener, no second auth scheme: a node's
collective endpoint IS its registered ``data_port``.

Confinement contract (enforced by the ``dial-discipline`` checker): every
raw peer socket of the collective layer — the outbound dials here, the
attach-side receive loops the dataserver hands over — lives in THIS module.
``group.py``/``ops.py`` speak in ranks and tags only.

Generation fencing: every frame is stamped with the group *generation*
assigned by the coordinator rendezvous.  After an elastic restart re-forms
the group (a new generation), frames from a poisoned round — a fenced
zombie, a late buffer flush from a dead peer's socket — carry a stale
generation and are dropped by the inbox instead of corrupting a live
reduce; frames racing slightly AHEAD of a member's own reconfigure are
buffered until it catches up (the coordinator reply reaches members at
slightly different times).

Failure semantics: a broken inbound connection poisons every pending and
future receive from that peer *up to the generation the connection served*
(:class:`CollectiveAborted`), so survivors abort a poisoned round within
milliseconds of the death instead of riding out the full collective
timeout.  Higher generations are untouched — the peer's replacement
attaches with a fresh connection and a fresh generation.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import socket
import threading
from tensorflowonspark_torch.utils.locks import tos_named_condition, tos_named_lock
import time

from tensorflowonspark_torch import telemetry

logger = logging.getLogger(__name__)


class CollectiveAborted(RuntimeError):
    """A collective round was poisoned (peer death, timeout, stale
    generation): the caller must abandon the round, re-form the group at a
    new generation barrier, and resync state before continuing."""


class CollectiveTimeout(CollectiveAborted):
    """The specific abort where a receive TIMED OUT waiting on one peer —
    distinguished so the straggler-detection recv loop can keep slicing
    (and reporting suspicion) without mistaking a peer-failure poison or a
    group close for mere slowness."""


# -- sparse (CSR) payloads -----------------------------------------------------
#
# The sparse collectives (embedding tier) ship {row id -> value row} sets
# instead of dense segments.  The wire layout is CSR-style: one int64 id
# vector plus one contiguous values matrix (ids[i] owns values[i]), framed as
# a single chunk payload whose two arrays BOTH ride as protocol-5 out-of-band
# buffers — same zero-copy path as the dense ring, same generation fencing.


def pack_csr(ids, values) -> tuple:
    """(ids, values) -> one sparse chunk payload.

    ``ids`` is any int array-like ([n] global row ids), ``values`` the
    matching ``[n, dim]`` rows (``None`` for id-only frames — the lookup
    REQUEST direction of the embedding exchange, which asks for rows it
    does not yet have)."""
    import numpy as np

    ids = np.ascontiguousarray(np.asarray(ids, dtype=np.int64).reshape(-1))
    if values is None:
        return ("csr", ids, None)
    values = np.ascontiguousarray(np.asarray(values))
    if values.ndim != 2 or values.shape[0] != ids.shape[0]:
        raise ValueError(
            f"CSR payload shape mismatch: {ids.shape[0]} ids vs values "
            f"{values.shape}")
    return ("csr", ids, values)


def unpack_csr(payload) -> tuple:
    """One sparse chunk payload -> (ids, values) (``values`` may be None)."""
    if not (isinstance(payload, tuple) and len(payload) == 3
            and payload[0] == "csr"):
        raise CollectiveAborted(
            f"expected a CSR sparse chunk, got {type(payload).__name__}")
    return payload[1], payload[2]


def payload_nbytes(payload) -> int:
    """Wire-metering size of a chunk payload: dense arrays meter their own
    ``nbytes``; CSR tuples meter ids + values (the bytes the sparse-vs-dense
    bench headline compares).  Headers and other picklable odds and ends
    meter 0 — metering exists for the tensor plane, not control chatter."""
    n = getattr(payload, "nbytes", None)
    if n is not None:
        return int(n)
    if isinstance(payload, tuple):
        return sum(int(getattr(p, "nbytes", 0) or 0) for p in payload)
    return 0


# -- inbox registry (the dataserver's attach handler looks groups up here) ----

_registry_lock = tos_named_lock("transport._registry_lock")
_inboxes: dict[str, "CollectiveInbox"] = {}


def register_inbox(name: str, inbox: "CollectiveInbox") -> None:
    with _registry_lock:
        if name in _inboxes:
            raise RuntimeError(f"collective group {name!r} already registered "
                               "in this process")
        _inboxes[name] = inbox


def unregister_inbox(name: str) -> None:
    with _registry_lock:
        _inboxes.pop(name, None)


def lookup_inbox(name: str) -> "CollectiveInbox | None":
    with _registry_lock:
        return _inboxes.get(name)


class CollectiveInbox:
    """Per-group landing zone for inbound chunk frames.

    Delivery threads are the dataserver's per-connection handlers (one per
    attached peer); consumers are the group's collective ops.  Frames are
    keyed ``(generation, src_rank, seq, tag)`` — ``seq`` is the group's
    SPMD-consistent op counter (reset at each formation), ``tag`` the op's
    internal message id — so out-of-order arrival across peers can never
    mis-match a chunk.  Ahead-of-generation frames are buffered (a peer may
    finish the formation rendezvous microseconds earlier); behind-generation
    frames are dropped (fencing)."""

    def __init__(self, name: str):
        self.name = name
        self._cond = tos_named_condition("transport.inbox._cond")
        self._frames: dict[tuple, collections.deque] = {}
        # src rank -> highest generation a broken connection was serving:
        # receives at or below it abort fast, above it are a NEW connection
        self._failed: dict[int, int] = {}
        self._generation = 0
        # Membership fence (gray-failure eviction): the eids of the CURRENT
        # formation and its world size.  A frame at the current generation
        # from a rank outside the live world is an evicted (or otherwise
        # fenced) peer still moving bytes — dropped, and its attach
        # connection severed.  None until the first formation.
        self._member_eids: set[int] | None = None
        self._world = 0
        # eid -> attach connections feeding this inbox (the dataserver hands
        # them over); tracked so eviction can HARD-SEVER a non-member's wire
        # instead of letting a zombie stream into the void forever.
        self._attach_conns: dict[int, list] = {}
        self._closed = False

    def advance_generation(self, generation: int,
                           member_eids: list[int] | None = None) -> None:
        """A new formation completed: drop every stale-generation frame and
        failure record (fencing — a poisoned round's leftovers must never
        feed a live one), adopt the live membership, and sever any attach
        connection from a peer that is no longer a member (the documented
        zombie window: a fenced-but-alive peer keeps its socket open and
        keeps moving bytes — close OUR end so it stops here)."""
        stale: list = []
        with self._cond:
            self._generation = generation
            self._frames = {k: v for k, v in self._frames.items()
                            if k[0] >= generation}
            self._failed = {s: g for s, g in self._failed.items()
                            if g >= generation}
            if member_eids is not None:
                self._member_eids = {int(e) for e in member_eids}
                self._world = len(self._member_eids)
                for eid in list(self._attach_conns):
                    if eid >= 0 and eid not in self._member_eids:
                        stale.extend(self._attach_conns.pop(eid))
            self._cond.notify_all()
        for conn in stale:
            with contextlib.suppress(OSError):
                conn.close()
        if stale:
            telemetry.counter("collective.severed_conns").inc(len(stale))

    def admits(self, src_eid: int, generation: int) -> bool:
        """Attach-time membership gate: a peer that is NOT in the current
        formation may only attach for a LATER generation (a readmitted
        member racing slightly ahead of our own reconfigure); at or below
        the current generation it is fenced out."""
        with self._cond:
            if self._member_eids is None or src_eid < 0:
                return True
            if src_eid in self._member_eids:
                return True
            return generation > self._generation

    def note_attach(self, src_eid: int, conn) -> None:
        with self._cond:
            self._attach_conns.setdefault(src_eid, []).append(conn)

    def forget_attach(self, src_eid: int, conn) -> None:
        with self._cond:
            conns = self._attach_conns.get(src_eid)
            if conns and conn in conns:
                conns.remove(conn)
                if not conns:
                    del self._attach_conns[src_eid]

    def deliver(self, generation: int, src: int, seq: int, tag, payload) -> None:
        with self._cond:
            if self._closed or generation < self._generation:
                return  # fenced: a stale round's frame
            if generation == self._generation and self._world \
                    and not 0 <= src < self._world:
                return  # fenced: a non-member rank's frame (evicted zombie)
            self._frames.setdefault((generation, src, seq, tag),
                                    collections.deque()).append(payload)
            self._cond.notify_all()

    def fail_peer(self, src: int, generation: int) -> None:
        """An inbound connection from ``src`` (serving up to ``generation``)
        broke: poison matching receives so waiters abort immediately."""
        with self._cond:
            if generation >= self._failed.get(src, -1):
                self._failed[src] = generation
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._frames.clear()
            self._cond.notify_all()

    def recv(self, generation: int, src: int, seq: int, tag,
             timeout: float):
        """Block for one frame; raises :class:`CollectiveAborted` on peer
        failure, group close, or timeout (a silent peer must poison the
        round, not wedge the trainer)."""
        key = (generation, src, seq, tag)
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                q = self._frames.get(key)
                if q:
                    payload = q.popleft()
                    if not q:
                        del self._frames[key]
                    return payload
                if self._closed:
                    raise CollectiveAborted(
                        f"collective group {self.name!r} closed mid-receive")
                if self._failed.get(src, -1) >= generation:
                    raise CollectiveAborted(
                        f"peer rank {src} lost its connection (generation "
                        f"{generation}); round poisoned")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise CollectiveTimeout(
                        f"timed out after {timeout:.0f}s waiting for chunk "
                        f"{tag!r} from rank {src} (generation {generation})")
                self._cond.wait(min(0.5, remaining))


# -- attach-side receive loop (runs on a dataserver connection thread) --------


def attach_error(name: str, src_eid: int = -1,
                 generation: int = 0) -> str | None:
    """Validation half of the dataserver's ``collective_attach`` op: None
    when the named group's inbox is live in this process AND the peer is
    admitted by the membership fence (an evicted member re-dialing at its
    stale generation gets a clean refusal, never a silent stream into a
    fence)."""
    inbox = lookup_inbox(name)
    if inbox is None:
        return (f"no collective group {name!r} registered in this process "
                "(peer attached before/after the group's lifetime)")
    if not inbox.admits(src_eid, generation):
        return (f"executor {src_eid} is not a member of collective group "
                f"{name!r} at generation {generation} (evicted or fenced); "
                "attach refused")
    return None


def serve_attached(conn: socket.socket, name: str, src_rank: int,
                   generation: int, src_eid: int = -1) -> None:
    """Receive loop for one attached peer connection: route chunk frames
    into the group's inbox until the peer closes (or the group goes away).
    Runs on the dataserver's per-connection thread — the reason sends from
    a compute thread can never deadlock against a peer that is also mid-
    send: every node's inbound wire is drained unconditionally.  The
    connection is registered against the sender's eid so a membership
    change (eviction) can hard-sever it from our side."""
    from tensorflowonspark_torch.dataserver import _recv_frame

    inbox = lookup_inbox(name)
    if inbox is None:
        return
    inbox.note_attach(src_eid, conn)
    rx_bytes = telemetry.counter("collective.rx_bytes")
    rx_frames = telemetry.counter("collective.rx_frames")
    last_gen = generation
    try:
        while True:
            msg, _ = _recv_frame(conn)
            if not (isinstance(msg, tuple) and msg and msg[0] == "cchunk"):
                logger.warning("collective stream from rank %d carried a "
                               "non-chunk frame %r; closing", src_rank,
                               msg[0] if isinstance(msg, tuple) else msg)
                return
            _, gen, src, seq, tag, payload = msg
            last_gen = max(last_gen, int(gen))
            rx_bytes.inc(payload_nbytes(payload))
            rx_frames.inc()
            inbox.deliver(int(gen), int(src), int(seq), tag, payload)
    except (ConnectionError, OSError, EOFError):
        return
    finally:
        # the inbox this loop was feeding may have been replaced by a later
        # group with the same name (close() then a fresh CollectiveGroup);
        # poison only OURS, never the successor's
        current = lookup_inbox(name)
        if current is inbox:
            inbox.forget_attach(src_eid, conn)
            inbox.fail_peer(src_rank, last_gen)


# -- outbound peer channels ---------------------------------------------------


class PeerTransport:
    """One node's collective endpoint set: the registered inbox (inbound)
    plus lazily-dialed outbound channels to peers, re-pointed at every
    formation (``configure``).  Sends run on the group's single comm thread;
    ``configure``/``close`` run on the map_fun thread — the small lock only
    guards the shared maps, never any blocking I/O."""

    def __init__(self, name: str, authkey: bytes, timeout: float,
                 detect: bool = True):
        from tensorflowonspark_torch.utils.envtune import env_float

        self.name = name
        self.authkey = authkey
        self.timeout = timeout
        self._lock = tos_named_lock("transport.peer._lock")
        self._conns: dict[int, socket.socket] = {}
        self._members: list[dict] = []
        self._generation = 0
        self._rank = -1
        self._eid = -1
        # Straggler detection (gray-failure tolerance): rolling EMA of
        # COMPLETED recv waits is the "typical contribution time" baseline;
        # a wait running TOS_COLLECTIVE_SUSPECT_FACTOR past it is a
        # persistent outlier worth reporting.  Relative by construction:
        # uniform slowness (a degraded network hitting everyone) raises the
        # baseline with the waits and never flags anyone.
        self.detect = bool(detect)
        self._suspect_factor = max(1.5, env_float(
            "TOS_COLLECTIVE_SUSPECT_FACTOR", 8.0))
        self._suspect_cb = None
        self._wait_ema: float | None = None
        self._reported: dict[tuple[int, int], float] = {}
        self.inbox = CollectiveInbox(name)
        register_inbox(name, self.inbox)

    @property
    def rank(self) -> int:
        with self._lock:
            return self._rank

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    @property
    def world(self) -> int:
        with self._lock:
            return len(self._members)

    def set_suspect_callback(self, cb) -> None:
        """Install the group's suspicion reporter: ``cb(src_rank,
        wait_secs) -> bool`` files a vote with the coordinator and returns
        True when a member of the CURRENT formation was evicted at quorum —
        the cue for a blocked recv to abort now instead of riding out the
        full collective timeout."""
        self._suspect_cb = cb

    def member_eids(self) -> list[int]:
        """Executor ids of the current formation, rank-ordered."""
        with self._lock:
            return [int(m["eid"]) for m in self._members]

    def configure(self, generation: int, rank: int, members: list[dict]) -> None:
        """Adopt a completed formation: new generation, rank, and peer
        endpoints.  Every cached outbound channel is dropped — a surviving
        socket may point at a dead predecessor's port, and the new
        generation must start from fresh dials.  The inbox adopts the live
        membership too, severing any attach connection from an evicted
        (non-member) peer — the hard half of the peer-plane fence."""
        with self._lock:
            self._generation = int(generation)
            self._rank = int(rank)
            self._members = [dict(m) for m in members]
            if 0 <= rank < len(members):
                self._eid = int(members[rank]["eid"])
            self._reported.clear()
        self.drop_connections()
        self.inbox.advance_generation(
            int(generation), [int(m["eid"]) for m in members])

    def drop_connections(self) -> None:
        """Close every outbound channel (abort path + reconfigure): closing
        our ends makes each peer's attach loop see EOF and poison its round
        — the cascade that turns one death into a whole-ring abort within
        milliseconds instead of a timeout per hop."""
        with self._lock:
            conns, self._conns = self._conns, {}
        for sock in conns.values():
            with contextlib.suppress(OSError):
                sock.close()

    def poison_generation(self) -> None:
        """Abort the CURRENT generation locally and outward: every pending
        (and future) receive of this generation fails immediately — so a
        straggler op still running on the comm thread unblocks NOW, before
        any reform can reconfigure ranks/seq under it — and the closed
        outbound channels cascade the abort to every peer."""
        with self._lock:
            gen, world = self._generation, len(self._members)
        for src in range(world):
            self.inbox.fail_peer(src, gen)
        self.drop_connections()

    def _endpoint(self, dst: int) -> tuple[str, int]:
        with self._lock:
            if not 0 <= dst < len(self._members):
                raise CollectiveAborted(
                    f"rank {dst} is not a member of generation "
                    f"{self._generation}")
            m = self._members[dst]
            return str(m["host"]), int(m["port"])

    def _dial(self, dst: int) -> socket.socket:
        from tensorflowonspark_torch.dataserver import _recv, _send
        from tensorflowonspark_torch.utils.net import (
            connect_with_backoff,
            hmac_handshake_client,
        )

        host, port = self._endpoint(dst)
        with self._lock:
            gen, rank, eid = self._generation, self._rank, self._eid
        sock = connect_with_backoff((host, port), timeout=self.timeout,
                                    attempts=3)
        try:
            # bounded everything: a dead peer mid-handshake (or one whose
            # kernel buffer backs up mid-reduce) must poison the round, not
            # pin the comm thread forever
            sock.settimeout(self.timeout)
            if not hmac_handshake_client(sock, self.authkey):
                raise CollectiveAborted(
                    f"peer rank {dst} rejected the cluster authkey")
            # the attach carries our eid so the receiver can key the
            # connection for membership severing (gray-failure fencing)
            _send(sock, ("collective_attach", self.name, rank, gen, eid),
                  wire=2)
            reply = _recv(sock)
            if not (isinstance(reply, tuple) and reply and reply[0] == "ok"):
                raise CollectiveAborted(
                    f"peer rank {dst} refused collective attach: "
                    f"{reply[1] if len(reply) > 1 else reply!r}")
        except (OSError, ConnectionError, EOFError) as e:
            with contextlib.suppress(OSError):
                sock.close()
            raise CollectiveAborted(
                f"could not attach to peer rank {dst} at {host}:{port}: {e}"
            ) from e
        except CollectiveAborted:
            with contextlib.suppress(OSError):
                sock.close()
            raise
        telemetry.counter("collective.attaches_total").inc()
        return sock

    def send(self, dst: int, seq: int, tag, payload) -> None:
        """Ship one chunk frame to ``dst`` (dialing lazily).  ``payload`` is
        usually a numpy array — it travels as a protocol-5 out-of-band
        buffer, scatter-gathered straight from its own memory — but any
        picklable object works (broadcast headers)."""
        from tensorflowonspark_torch import faultinject
        from tensorflowonspark_torch.dataserver import frame_parts
        from tensorflowonspark_torch.utils.net import sendmsg_all

        # chaos seam: `slow_peer:ms=M` injects degraded-NIC latency on
        # every peer-plane send in the armed process
        faultinject.peer_send_delay()
        with self._lock:
            sock = self._conns.get(dst)
            gen, rank = self._generation, self._rank
        if sock is None:
            sock = self._dial(dst)
            with self._lock:
                self._conns[dst] = sock
        parts = frame_parts(("cchunk", gen, rank, seq, tag, payload), wire=2)
        try:
            sendmsg_all(sock, parts)
        except (OSError, ConnectionError) as e:
            with self._lock:
                if self._conns.get(dst) is sock:
                    del self._conns[dst]
            with contextlib.suppress(OSError):
                sock.close()
            raise CollectiveAborted(
                f"send to peer rank {dst} failed mid-round: {e}") from e
        telemetry.counter("collective.tx_bytes").inc(payload_nbytes(payload))
        telemetry.counter("collective.tx_frames").inc()

    def _note_wait(self, wait: float) -> None:
        """Fold one COMPLETED recv wait into the rolling baseline."""
        with self._lock:
            if self._wait_ema is None:
                self._wait_ema = wait
            else:
                self._wait_ema += 0.2 * (wait - self._wait_ema)

    def suspect_threshold(self, budget: float) -> float:
        """Wait (seconds) past which a peer is a persistent outlier worth
        reporting: SUSPECT_FACTOR x the rolling typical wait, floored at
        0.5s (below that is scheduler noise, not a gray failure) and capped
        at a quarter of the recv budget (detection must always beat the
        round timeout, or eviction never improves on thrashing).  With NO
        baseline yet (the group's first round: dials, attaches, cold TCP
        windows) the floor doubles — connection setup must not read as a
        stall."""
        with self._lock:
            ema = self._wait_ema
        floor = 0.5 if ema is not None else 1.0
        base = max(ema if ema is not None else 0.0, 1e-3)
        return min(max(self._suspect_factor * base, floor),
                   max(floor, budget / 4.0))

    def _maybe_report(self, generation: int, src: int, waited: float) -> bool:
        """Rate-limited suspicion report (at most one per second per
        (generation, src)); True when the callback says the current round
        is doomed (a member was evicted at quorum)."""
        cb = self._suspect_cb
        if cb is None:
            return False
        now = time.monotonic()
        with self._lock:
            if now - self._reported.get((generation, src), 0.0) < 1.0:
                return False
            self._reported[(generation, src)] = now
        try:
            return bool(cb(src, waited))
        except Exception:  # noqa: BLE001 - reporting must never poison a healthy round
            logger.debug("suspicion report for rank %d failed", src,
                         exc_info=True)
            return False

    def recv(self, src: int, seq: int, tag, timeout: float | None = None):
        """Blocking receive with straggler detection: the wait is sliced so
        that once it runs ``suspect_threshold`` past the rolling typical
        wait, a suspicion vote is filed with the coordinator (abort
        attribution: the vote names the peer we are waiting ON) — and if
        quorum evicts a member of this formation, the round aborts NOW
        instead of riding out the remaining collective timeout."""
        with self._lock:
            gen = self._generation
        budget = self.timeout if timeout is None else timeout
        if not self.detect or self._suspect_cb is None:
            wait_t0 = time.monotonic()
            payload = self.inbox.recv(gen, src, seq, tag, budget)
            if self.detect:
                self._note_wait(time.monotonic() - wait_t0)
            return payload
        deadline = time.monotonic() + budget
        threshold = self.suspect_threshold(budget)
        t0 = time.monotonic()
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                # final abort attribution: the timeout itself is the
                # strongest suspicion signal — file it before poisoning
                self._maybe_report(gen, src, time.monotonic() - t0)
                raise CollectiveTimeout(
                    f"timed out after {budget:.0f}s waiting for chunk "
                    f"{tag!r} from rank {src} (generation {gen})")
            slice_ = min(remaining, max(0.05, threshold / 2.0))
            try:
                payload = self.inbox.recv(gen, src, seq, tag, slice_)
            except CollectiveTimeout:
                waited = time.monotonic() - t0
                if waited >= threshold and self._maybe_report(gen, src,
                                                              waited):
                    raise CollectiveAborted(
                        f"peer rank {src} evicted at quorum after waiting "
                        f"{waited:.1f}s (generation {gen}); round "
                        "poisoned") from None
                continue
            self._note_wait(time.monotonic() - t0)
            return payload

    def close(self) -> None:
        # unregister FIRST so a racing attach can't hand a connection to a
        # closed inbox; late attach attempts get a clean refusal instead
        current = lookup_inbox(self.name)
        if current is self.inbox:
            unregister_inbox(self.name)
        self.inbox.close()
        self.drop_connections()
