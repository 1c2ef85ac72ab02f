"""Zstandard decompression through the package's own decoder
(``zstd_decode.cc``, RFC 8878), built with ``g++`` at first use into
``_native_build/`` by ``native.build.build_native_lib`` and bound with
ctypes.  There is no other decoder: if the build fails, the caller's load
raises.

``decompress(data)`` decodes one or more concatenated frames (skippable
frames are skipped) into new bytes; ``decompress_into(data, out)`` into a
caller's writable buffer.  Corrupt or truncated input raises ``ValueError``
naming the byte offset where the decoder found it.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "zstd_decode.cc")
_OK, _CORRUPT, _TOO_SMALL = 0, 1, 2
_MSG_BYTES = 256


@functools.cache
def _lib() -> ctypes.CDLL:
    from tensorflowonspark_torch.native.build import build_native_lib

    lib = ctypes.CDLL(build_native_lib(_SRC, "libtos_zstd.so"))
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.tos_zstd_decompress.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
                                        ctypes.c_uint64, u64p, u64p, ctypes.c_char_p,
                                        ctypes.c_uint64]
    lib.tos_zstd_decompress.restype = ctypes.c_int
    lib.tos_zstd_content_size.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.tos_zstd_content_size.restype = ctypes.c_int64
    return lib


def _bytes_view(buf, writable: bool = False) -> np.ndarray:
    """A uint8 view of ``buf`` (no copy)."""
    a = np.frombuffer(buf, np.uint8)
    if writable and not a.flags.writeable:
        raise ValueError("decompress_into needs a writable buffer")
    return a


def _run(src: np.ndarray, out: np.ndarray) -> tuple[int, int]:
    """(return code, decoded length) of one decoder call into ``out``."""
    out_len, err_off = ctypes.c_uint64(0), ctypes.c_uint64(0)
    msg = ctypes.create_string_buffer(_MSG_BYTES)
    rc = _lib().tos_zstd_decompress(src.ctypes.data, src.size, out.ctypes.data, out.size,
                                    ctypes.byref(out_len), ctypes.byref(err_off), msg,
                                    _MSG_BYTES)
    if rc == _CORRUPT:
        raise ValueError(f"zstd: {msg.value.decode(errors='replace')} "
                         f"(at byte {err_off.value} of {src.size})")
    return rc, out_len.value


def content_size(data) -> int | None:
    """The decoded size the frames declare, or None if any frame does not."""
    src = _bytes_view(data)
    n = _lib().tos_zstd_content_size(src.ctypes.data, src.size)
    return None if n < 0 else n


def decompress_into(data, out) -> int:
    """Decode the frames of ``data`` into the writable buffer ``out``;
    returns the bytes written.  Raises ``ValueError`` if they do not fit."""
    src = _bytes_view(data)
    dst = _bytes_view(out, writable=True)
    rc, n = _run(src, dst)
    if rc == _TOO_SMALL:
        raise ValueError(f"zstd: the frames decode to {n} bytes, the buffer holds {dst.size}")
    return n


def decompress(data, max_size: int | None = None) -> bytes:
    """Decode the frames of ``data`` (bytes or any buffer).  Where the
    frames do not declare their size, a first guess too small costs a
    second pass (the first one counts the size).  Frames that decode to
    more than ``max_size`` bytes raise ``ValueError`` before that much is
    allocated."""
    src = _bytes_view(data)
    declared = content_size(src)
    if declared is not None and max_size is not None and declared > max_size:
        raise ValueError(f"zstd: the frames declare {declared} bytes, above {max_size}")
    cap = declared
    if cap is None:
        cap = max(4 * src.size, 1 << 16)
        cap = cap if max_size is None else min(cap, max_size)
    out = np.empty(cap, np.uint8)
    rc, n = _run(src, out)
    if rc == _TOO_SMALL:  # the decoder counted the size it needs
        if max_size is not None and n > max_size:
            raise ValueError(f"zstd: the frames decode to {n} bytes, above {max_size}")
        out = np.empty(n, np.uint8)
        rc, n = _run(src, out)
        if rc != _OK:
            raise ValueError(f"zstd: the frames decoded to two sizes ({out.size}, {n})")
    return out[:n].tobytes()
