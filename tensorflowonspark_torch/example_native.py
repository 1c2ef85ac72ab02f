"""ctypes bindings for the native Example parser (``native/example_parser.cc``).

The data-loader hot path: per-record ``tf.train.Example`` decoding done in
C++ over a whole shard at once — Python makes TWO ctypes calls per
(shard, column) instead of walking proto bytes per record (the reference's
equivalent work lived in the native tensorflow-hadoop/TF runtime).

Importing this module raises if the library cannot be built/loaded; callers
(``dfutil.read_shard_columns``) treat that as "fall back to pure Python".
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from tensorflowonspark_torch.native.build import build_native_lib

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                    "example_parser.cc")

_lib = ctypes.CDLL(build_native_lib(_SRC, "libexample_parser.so"))

_U64P = ctypes.POINTER(ctypes.c_uint64)
_lib.tos_count_feature.restype = ctypes.c_int64
_lib.tos_count_feature.argtypes = [
    ctypes.c_char_p, _U64P, _U64P, ctypes.c_int64,
    ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
    ctypes.POINTER(ctypes.c_int), _U64P,
]
_lib.tos_fill_feature.restype = ctypes.c_int64
_lib.tos_fill_feature.argtypes = [
    ctypes.c_char_p, _U64P, _U64P, ctypes.c_int64,
    ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
    ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
    _U64P, _U64P,
]

KINDS = {"bytes": 1, "float": 2, "int64": 3}


def _u64(a: np.ndarray):
    return a.ctypes.data_as(_U64P)


def span_arrays(spans: list[tuple[int, int]]) -> tuple[np.ndarray, np.ndarray]:
    """(offsets, lengths) uint64 arrays for a span list — build ONCE per
    shard and reuse across every extract_column call (the conversion is an
    O(n_records) Python walk that must not repeat per column)."""
    n = len(spans)
    offs = np.fromiter((o for o, _ in spans), np.uint64, count=n)
    lens = np.fromiter((l for _, l in spans), np.uint64, count=n)
    return offs, lens


def extract_column(buf: bytes, spans, name: str, dtype: str):
    """Extract one feature column across all records of a shard buffer.

    ``spans`` is either the (offset, length) list from ``tfrecord`` scanning
    or a prebuilt ``span_arrays`` result.  Returns ``(values, counts)``:
    ``counts`` is the per-record value count (uint64, 0 where the feature is
    absent) and ``values`` is a ``float32``/``int64`` ndarray of all values
    concatenated, or for ``dtype='bytes'`` a list of ``bytes`` (sliced from
    ``buf``).
    """
    kind = KINDS[dtype]
    if isinstance(spans, tuple) and len(spans) == 2 \
            and isinstance(spans[0], np.ndarray):
        offs, lens = spans
    else:
        offs, lens = span_arrays(spans)
    n = len(offs)
    counts = np.zeros(n, np.uint64)
    found = ctypes.c_int(0)
    bname = name.encode("utf-8")
    total = _lib.tos_count_feature(buf, _u64(offs), _u64(lens), n, bname,
                                   len(bname), kind, ctypes.byref(found),
                                   _u64(counts))
    if total == -2:
        raise TypeError(f"feature {name!r} is not of dtype {dtype!r}")
    if total < 0:
        raise ValueError(f"corrupt Example record while reading {name!r}")

    f32 = np.empty(total if kind == 2 else 0, np.float32)
    i64 = np.empty(total if kind == 3 else 0, np.int64)
    boffs = np.empty(total if kind == 1 else 0, np.uint64)
    blens = np.empty(total if kind == 1 else 0, np.uint64)
    wrote = _lib.tos_fill_feature(
        buf, _u64(offs), _u64(lens), n, bname, len(bname), kind,
        f32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        i64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _u64(boffs), _u64(blens))
    if wrote != total:
        raise ValueError(f"corrupt Example record while reading {name!r}")
    if kind == 1:
        values = [bytes(buf[int(o):int(o) + int(l)])
                  for o, l in zip(boffs, blens)]
    elif kind == 2:
        values = f32
    else:
        values = i64
    return values, counts
