"""Python face of the native shared-memory ring (``native/shm_ring.cc``).

Same-host data-plane fast path: where the reference moved every sample
through a ``multiprocessing`` manager proxy (TFManager queues, SURVEY.md
§3.2), feeder and node here share a lock-free SPSC byte ring in POSIX shm —
no sockets, no proxy, one memcpy each way.  ``DataClient`` uses it
automatically when it detects the node is on its own host (dataserver.py);
everything falls back to TCP when the native lib can't build.

Security note: items are pickled.  The ring is 0600 in /dev/shm under a
random name, same-user-same-host only — the same trust domain as the TCP
path *after* its HMAC handshake, so no authentication layer is needed here.

SPSC contract: one pusher process/thread, one popper.  The request/reply
pattern uses a pair of rings (c2s, s2c).
"""

from __future__ import annotations

import ctypes
import os
import pickle
import secrets
from typing import Any

_LIB = None


class RingUnavailable(RuntimeError):
    pass


class RingClosed(EOFError):
    pass


class RingTimeout(TimeoutError):
    pass


def _lib():
    global _LIB
    if _LIB is None:
        from tensorflowonspark_torch.native.build import build_native_lib

        src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "native", "shm_ring.cc")
        try:
            lib = ctypes.CDLL(build_native_lib(src, "libshm_ring.so",
                                               ("-lrt",)))
        except Exception as e:  # noqa: BLE001 - no compiler / no shm
            raise RingUnavailable(str(e)) from e
        lib.tos_ring_open.restype = ctypes.c_void_p
        lib.tos_ring_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                      ctypes.c_int]
        lib.tos_ring_push.restype = ctypes.c_int
        lib.tos_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_uint64, ctypes.c_int]
        lib.tos_ring_push2.restype = ctypes.c_int
        # payload arg is c_void_p (not c_char_p) so writable buffers
        # (bytearray/memoryview) pass without a bytes() conversion copy
        lib.tos_ring_push2.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_uint64, ctypes.c_void_p,
                                       ctypes.c_uint64, ctypes.c_int]
        lib.tos_ring_next_size.restype = ctypes.c_int64
        lib.tos_ring_next_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tos_ring_pop.restype = ctypes.c_int64
        lib.tos_ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_uint64, ctypes.c_int]
        for fn in ("tos_ring_close_write", "tos_ring_detach"):
            getattr(lib, fn).restype = None
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.tos_ring_is_closed.restype = ctypes.c_int
        lib.tos_ring_is_closed.argtypes = [ctypes.c_void_p]
        lib.tos_ring_size.restype = ctypes.c_uint64
        lib.tos_ring_size.argtypes = [ctypes.c_void_p]
        lib.tos_ring_capacity.restype = ctypes.c_uint64
        lib.tos_ring_capacity.argtypes = [ctypes.c_void_p]
        lib.tos_ring_unlink.restype = ctypes.c_int
        lib.tos_ring_unlink.argtypes = [ctypes.c_char_p]
        _LIB = lib
    return _LIB


def available() -> bool:
    try:
        _lib()
        return True
    except RingUnavailable:
        return False


def make_ring_name(prefix: str = "tosring") -> str:
    return f"/{prefix}_{os.getpid()}_{secrets.token_hex(8)}"


class ShmRing:
    """One directional ring.  ``create()`` on the owning side, ``attach()``
    on the peer; the creator should ``unlink()`` at teardown."""

    def __init__(self, name: str, handle: int, owner: bool):
        self.name = name
        self._h = handle
        self._owner = owner

    @classmethod
    def create(cls, name: str | None = None,
               capacity: int = 64 * 1024 * 1024) -> "ShmRing":
        name = name or make_ring_name()
        lib = _lib()
        lib.tos_ring_unlink(name.encode())  # clear any stale segment
        h = lib.tos_ring_open(name.encode(), capacity, 1)
        if not h:
            raise RingUnavailable(f"cannot create ring {name}")
        return cls(name, h, owner=True)

    @classmethod
    def attach(cls, name: str) -> "ShmRing":
        h = _lib().tos_ring_open(name.encode(), 0, 0)
        if not h:
            raise RingUnavailable(f"cannot attach ring {name}")
        return cls(name, h, owner=False)

    # -- raw bytes -----------------------------------------------------------
    #
    # Wire format: every ring record is 1 flag byte + payload.  Messages
    # larger than the ring are transparently segmented (WHOLE | MORE… LAST);
    # SPSC ordering guarantees segments arrive contiguously.  NB: a timeout
    # raised mid-segmented-put leaves a partial message in flight — callers
    # must treat RingTimeout as fatal for the ring (downgrade transport).

    _WHOLE, _MORE, _LAST = b"\x00", b"\x01", b"\x02"

    @property
    def capacity(self) -> int:
        return _lib().tos_ring_capacity(self._h)

    def _push_record(self, flag: bytes, payload, timeout: float | None) -> None:
        """Push [flag byte | payload] as one ring record.  ``payload`` is any
        1-D byte buffer (bytes/bytearray/memoryview, read-only or not); the
        native push2 assembles the record inside the ring, so there is no
        flag-prepend join copy and no staging copy of the payload."""
        if not self._h:
            raise RingClosed("ring detached")
        import numpy as _np

        # np.frombuffer wraps ANY contiguous buffer (including read-only
        # memoryviews, which ctypes.from_buffer rejects) without copying and
        # exposes its address; the array reference keeps the memory alive
        # across the native call.
        arr = _np.frombuffer(payload, dtype=_np.uint8)
        rc = _lib().tos_ring_push2(
            self._h, flag, 1, ctypes.c_void_p(arr.ctypes.data), arr.size,
            -1 if timeout is None else int(timeout * 1000))
        if rc == 1:
            return
        if rc == 0:
            raise RingTimeout(f"push timed out after {timeout}s")
        if rc == -1:
            raise RingClosed("ring closed")
        raise ValueError(f"record of {arr.size + 1} bytes exceeds ring capacity")

    def put_bytes(self, data, timeout: float | None = 600.0) -> None:
        max_payload = self.capacity // 2  # headroom so a segment always fits
        view = memoryview(data)
        if len(view) <= max_payload:
            self._push_record(self._WHOLE, view, timeout)
            return
        for start in range(0, len(view), max_payload):
            seg = view[start:start + max_payload]
            last = start + max_payload >= len(view)
            self._push_record(self._LAST if last else self._MORE, seg, timeout)

    def put_buffers(self, buffers, timeout: float | None = 600.0) -> None:
        """Batched push: several buffers become ONE logical record stream,
        each copied straight from its own memory into the ring (no join).

        This is the ring's zero-copy framing path: a whole feed chunk —
        frame header + K row buffers — goes in as one segmented record
        instead of one pickled blob, so the only per-byte work is the
        memcpy into shared memory.  Same mid-stream-timeout caveat as
        ``put_bytes``: a RingTimeout leaves partial segments in flight and
        the ring must be abandoned.
        """
        views: list = []
        for b in buffers:
            v = memoryview(b)
            if v.ndim != 1 or v.itemsize != 1:
                v = v.cast("B")
            if len(v):
                views.append(v)
        if not views:
            self._push_record(self._WHOLE, b"", timeout)
            return
        max_payload = self.capacity // 2
        segs: list = []
        for v in views:
            for start in range(0, len(v), max_payload):
                segs.append(v[start:start + max_payload])
        for i, seg in enumerate(segs):
            last = i == len(segs) - 1
            flag = (self._WHOLE if last and i == 0
                    else self._LAST if last else self._MORE)
            self._push_record(flag, seg, timeout)

    def _pop_record(self, timeout: float | None) -> bytearray:
        if not self._h:
            raise RingClosed("ring detached")
        lib = _lib()
        tmo = -1 if timeout is None else int(timeout * 1000)
        size = lib.tos_ring_next_size(self._h, tmo)
        if size == -1:
            raise RingClosed("ring closed and drained")
        if size == -3:
            raise RingTimeout(f"pop timed out after {timeout}s")
        # Pop straight into a WRITABLE bytearray (no staging string buffer +
        # raw[:n] copy): downstream zero-copy unpickling hands views of this
        # blob to numpy, and arrays received over the ring must be writable
        # exactly like their TCP-delivered twins.
        buf = bytearray(int(size))
        carr = (ctypes.c_char * len(buf)).from_buffer(buf) if buf \
            else ctypes.create_string_buffer(0)
        # next_size succeeded ⇒ the record is already available to this (the
        # only) consumer; pop non-blockingly so the two calls can't stack up
        # to 2x the requested timeout per record.
        n = lib.tos_ring_pop(self._h, carr, int(size), 0)
        del carr  # release the exported buffer so `buf` is resizable again
        if n == -1:
            raise RingClosed("ring closed and drained")
        if n == -3:
            raise RingTimeout(f"pop timed out after {timeout}s")
        assert n == size, (n, size)
        return buf

    def get_bytes(self, timeout: float | None = 600.0) -> bytearray:
        """One logical record as a WRITABLE bytearray (segments joined)."""
        rec = self._pop_record(timeout)
        flag, payload = bytes(rec[:1]), rec[1:]
        if flag == self._WHOLE:
            return payload
        parts = [payload]
        while flag == self._MORE:
            rec = self._pop_record(timeout)
            flag, payload = bytes(rec[:1]), rec[1:]
            parts.append(payload)
        if flag != self._LAST:
            raise ValueError(f"corrupt ring stream: unexpected flag {flag!r}")
        return bytearray(b"").join(parts)

    # -- pickled objects -----------------------------------------------------

    def put(self, obj: Any, timeout: float | None = 600.0) -> None:
        self.put_bytes(pickle.dumps(obj, pickle.HIGHEST_PROTOCOL), timeout)

    def get(self, timeout: float | None = 600.0) -> Any:
        return pickle.loads(self.get_bytes(timeout))

    # -- lifecycle -----------------------------------------------------------

    def close_write(self) -> None:
        """Producer hangs up; consumers drain then see RingClosed."""
        _lib().tos_ring_close_write(self._h)

    @property
    def pending_bytes(self) -> int:
        return _lib().tos_ring_size(self._h)

    def detach(self) -> None:
        if self._h:
            _lib().tos_ring_detach(self._h)
            self._h = 0

    def unlink(self) -> None:
        _lib().tos_ring_unlink(self.name.encode())

    def __del__(self):  # best-effort; explicit detach preferred
        try:
            self.detach()
        except Exception:  # toslint: allow-silent(__del__ at interpreter teardown: the lib handle may be gone and logging is unsafe here)
            pass
