"""Minimal ``tf.train.Example`` protobuf codec — hand-rolled, no TF, no
generated protos.

The reference converts Spark DataFrame rows to/from ``tf.train.Example``
records through the TensorFlow runtime (``dfutil.toTFExample``/
``fromTFExample``, ``tensorflowonspark/dfutil.py:~100-230``).  The Example
schema is tiny and frozen, so this module implements exactly that subset of
proto wire format:

    Example    { Features features = 1; }
    Features   { map<string, Feature> feature = 1; }
    Feature    { oneof kind { BytesList bytes_list = 1;
                              FloatList float_list = 2;
                              Int64List int64_list = 3; } }
    BytesList  { repeated bytes value = 1; }
    FloatList  { repeated float value = 1 [packed]; }
    Int64List  { repeated int64 value = 1 [packed]; }

Encode always writes packed primitives (canonical proto3 behaviour, and what
TF emits); decode accepts both packed and unpacked.
"""

from __future__ import annotations

import struct
from typing import Iterator

_F32 = struct.Struct("<f")


# -- varint primitives -------------------------------------------------------

def _write_varint(out: bytearray, value: int) -> None:
    if value < 0:
        value += 1 << 64  # proto int64 negative values use 10-byte varints
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _signed64(value: int) -> int:
    return value - (1 << 64) if value >= 1 << 63 else value


def _tag(field: int, wire: int) -> int:
    return (field << 3) | wire


def _write_len_delimited(out: bytearray, field: int, payload: bytes) -> None:
    _write_varint(out, _tag(field, 2))
    _write_varint(out, len(payload))
    out += payload


def _iter_fields(buf: bytes) -> Iterator[tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) for each field in ``buf``."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            value, pos = _read_varint(buf, pos)
        elif wire == 2:  # length-delimited
            n, pos = _read_varint(buf, pos)
            value = buf[pos : pos + n]
            if len(value) < n:
                raise ValueError("truncated length-delimited field")
            pos += n
        elif wire == 5:  # 32-bit
            value = buf[pos : pos + 4]
            pos += 4
        elif wire == 1:  # 64-bit
            value = buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


# -- feature encode ----------------------------------------------------------

def _encode_bytes_list(values: list[bytes]) -> bytes:
    out = bytearray()
    for v in values:
        _write_len_delimited(out, 1, v if isinstance(v, bytes) else str(v).encode())
    return bytes(out)


def _encode_float_list(values: list[float]) -> bytes:
    payload = b"".join(_F32.pack(float(v)) for v in values)
    out = bytearray()
    _write_len_delimited(out, 1, payload)  # packed
    return bytes(out)


def _encode_int64_list(values: list[int]) -> bytes:
    payload = bytearray()
    for v in values:
        _write_varint(payload, int(v))
    out = bytearray()
    _write_len_delimited(out, 1, bytes(payload))  # packed
    return bytes(out)


def encode_feature(values) -> bytes:
    """Encode one Feature from a homogeneous list (bytes/str, float, or int)."""
    if not isinstance(values, (list, tuple)):
        values = [values]
    import numpy as np

    # np.float32 etc. are not isinstance of Python float; normalize first so
    # type dispatch below can't silently truncate a float into the int branch.
    values = [v.item() if isinstance(v, np.generic) else v for v in values]
    out = bytearray()
    if values and isinstance(values[0], (bytes, bytearray, str)):
        _write_len_delimited(out, 1, _encode_bytes_list(list(values)))
    elif values and isinstance(values[0], float):
        _write_len_delimited(out, 2, _encode_float_list(list(values)))
    else:  # ints (and empty lists default to int64, matching TF)
        _write_len_delimited(out, 3, _encode_int64_list(list(values)))
    return bytes(out)


def encode_example(features: dict) -> bytes:
    """Encode {name: value(s)} into a serialized ``tf.train.Example``.

    Value types map the way the reference's ``toTFExample`` did
    (``dfutil.py:~100-160``): bytes/str → bytes_list, float → float_list,
    int/bool → int64_list; lists must be homogeneous.
    """
    fmap = bytearray()
    for name in sorted(features):  # deterministic output
        entry = bytearray()
        _write_len_delimited(entry, 1, name.encode("utf-8"))
        _write_len_delimited(entry, 2, encode_feature(features[name]))
        _write_len_delimited(fmap, 1, bytes(entry))
    out = bytearray()
    _write_len_delimited(out, 1, bytes(fmap))
    return bytes(out)


# -- feature decode ----------------------------------------------------------

def _decode_packed_or_repeated(body: bytes, wire_expect: int, parse) -> list:
    values = []
    for field, wire, value in _iter_fields(body):
        if field != 1:
            continue
        if wire == 2 and wire_expect != 2:  # packed encoding
            values.extend(parse_packed(value, wire_expect, parse))
        else:
            values.append(parse(value))
    return values


def parse_packed(payload: bytes, wire: int, parse) -> list:
    values = []
    pos = 0
    if wire == 0:
        while pos < len(payload):
            v, pos = _read_varint(payload, pos)
            values.append(parse(v))
    elif wire == 5:
        while pos < len(payload):
            values.append(parse(payload[pos : pos + 4]))
            pos += 4
    return values


def decode_feature(buf: bytes):
    """Decode one Feature into a Python list (bytes, float, or int)."""
    for field, _wire, value in _iter_fields(buf):
        if field == 1:  # bytes_list
            return [bytes(v) for f, w, v in _iter_fields(value) if f == 1]
        if field == 2:  # float_list
            return _decode_packed_or_repeated(value, 5, lambda b: _F32.unpack(b)[0])
        if field == 3:  # int64_list
            return _decode_packed_or_repeated(value, 0, lambda v: _signed64(v))
    return []


def decode_example(buf: bytes) -> dict:
    """Decode a serialized ``tf.train.Example`` into {name: list-of-values}."""
    features: dict = {}
    for field, _wire, value in _iter_fields(buf):
        if field != 1:
            continue
        for f, _w, entry in _iter_fields(value):
            if f != 1:
                continue
            name, feat = None, b""
            for ef, _ew, ev in _iter_fields(entry):
                if ef == 1:
                    name = ev.decode("utf-8")
                elif ef == 2:
                    feat = ev
            if name is not None:
                features[name] = decode_feature(feat)
    return features
