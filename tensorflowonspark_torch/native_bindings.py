"""ctypes bindings for the native C++ codec (``native/tfrecord_codec.cc``).

Built on demand with g++ (pybind11 is not available in this environment;
the C ABI + ctypes keeps the toolchain to the baked-in compiler).  Importing
this module raises if the library cannot be built/loaded — callers
(``tfrecord._use_native``) treat that as "fall back to pure Python".
"""

from __future__ import annotations

import ctypes
import os

from tensorflowonspark_torch.native.build import build_native_lib

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native", "tfrecord_codec.cc")

_lib = ctypes.CDLL(build_native_lib(_SRC, "libtfrecord_codec.so"))

_lib.tos_crc32c.restype = ctypes.c_uint32
_lib.tos_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32]
_lib.tos_scan_records.restype = ctypes.c_int64
_lib.tos_scan_records.argtypes = [
    ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
    ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
    ctypes.c_int64, ctypes.POINTER(ctypes.c_uint64),
]
_lib.tos_frame_record.restype = ctypes.c_uint64
_lib.tos_frame_record.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p]


def crc32c(data: bytes, crc: int = 0) -> int:
    return _lib.tos_crc32c(data, len(data), crc)


_SCAN_CHUNK = 65536


def scan_records(buf, verify: bool = True):
    """Return ([(offset, length), ...], consumed_bytes); raises on corruption.

    ``buf`` is ``bytes`` or any read-only buffer-protocol object (an mmap
    or a memoryview of one — the zero-copy shard path): non-bytes buffers
    are passed by ADDRESS so the scan walks the mapped pages directly,
    with no copy into a bytes object."""
    offs = (ctypes.c_uint64 * _SCAN_CHUNK)()
    lens = (ctypes.c_uint64 * _SCAN_CHUNK)()
    consumed = ctypes.c_uint64()
    spans: list[tuple[int, int]] = []
    base = 0
    total = len(buf)
    addr = None
    if not isinstance(buf, bytes):
        import numpy as np

        anchor = np.frombuffer(buf, np.uint8)  # keeps the buffer pinned
        addr = anchor.ctypes.data
    while True:
        if addr is not None:
            view = ctypes.cast(addr + base, ctypes.c_char_p)
        else:
            view = buf if base == 0 else buf[base:]
        n = _lib.tos_scan_records(view, total - base, int(verify), offs, lens,
                                  _SCAN_CHUNK, ctypes.byref(consumed))
        if n < 0:
            raise ValueError(f"corrupt record at offset {base + consumed.value}")
        spans.extend((base + offs[i], lens[i]) for i in range(n))
        base += consumed.value
        if n < _SCAN_CHUNK:
            return spans, base


def frame_record(data: bytes) -> bytes:
    out = ctypes.create_string_buffer(16 + len(data))
    n = _lib.tos_frame_record(data, len(data), out)
    return out.raw[:n]
