"""TFRecord file codec with crc32c framing — no TensorFlow, no JVM.

Replaces the reference's dependency on the external ``tensorflow-hadoop`` jar
(``org.tensorflow.hadoop.io.TFRecord{File}InputFormat/OutputFormat``) used by
``tensorflowonspark/dfutil.py:~30-90`` for splittable TFRecord I/O, and the
TF runtime's own record reader (SURVEY.md §2.2).  The wire format is the
standard TFRecord framing:

    uint64 length (little-endian)
    uint32 masked_crc32c(length_bytes)
    byte   data[length]
    uint32 masked_crc32c(data)

crc32c is Castagnoli CRC-32 (poly 0x1EDC6F41, reflected 0x82F63B78).  A
table-driven pure-Python implementation is the fallback; the C++ extension in
``native/`` (slice-by-8) is used when built.
"""

from __future__ import annotations

import os
import struct
from typing import Iterable, Iterator

_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")
_MASK_DELTA = 0xA282EAD8


def _make_table() -> list[int]:
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


_TABLE = _make_table()


def _crc32c_py(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# Swapped for the native implementation when available.
crc32c = _crc32c_py
_native = None


def _use_native() -> bool:
    """Try to switch hot paths to the C++ implementation; True on success."""
    global crc32c, _native
    try:
        from tensorflowonspark_torch import native_bindings
    except Exception:
        return False
    crc32c = native_bindings.crc32c
    _native = native_bindings
    return True


NATIVE = _use_native()


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF)


def frame_record(data: bytes) -> bytes:
    """Encode one record with TFRecord framing."""
    if _native is not None:
        return _native.frame_record(data)
    length = _U64.pack(len(data))
    return length + _U32.pack(masked_crc32c(length)) + data + _U32.pack(masked_crc32c(data))


class RecordError(ValueError):
    pass


def scan_record_spans(buf: bytes, verify: bool = True,
                      name: str = "<buffer>") -> list[tuple[int, int]]:
    """(offset, length) payload spans of an in-memory PLAIN shard buffer
    (native whole-buffer scan when built, Python fallback otherwise).
    ``name`` labels errors.  The buffer-level half of ``read_record_spans``,
    exposed so callers that already hold the bytes (the ingest readers, one
    open per shard) never re-open the file."""
    if _native is not None:
        try:
            spans, consumed = _native.scan_records(buf, verify)
        except ValueError as e:
            raise RecordError(f"{name}: {e}") from None
        if consumed != len(buf):
            raise RecordError(f"{name}: truncated record at offset {consumed}")
        return [(int(o), int(n)) for o, n in spans]
    if not isinstance(buf, (bytes, bytearray)):
        # pure-Python fallback slices header/payload windows for the CRC
        # helper, which wants real bytes; one copy beats a copy per record
        buf = bytes(buf)
    spans = []
    pos = 0
    while pos < len(buf):
        if pos + 12 > len(buf):
            raise RecordError(f"{name}: truncated header at offset {pos}")
        (length,) = _U64.unpack_from(buf, pos)
        if verify and masked_crc32c(buf[pos:pos + 8]) != _U32.unpack_from(buf, pos + 8)[0]:
            raise RecordError(f"{name}: corrupt length crc at offset {pos}")
        start = pos + 12
        if start + length + 4 > len(buf):
            raise RecordError(f"{name}: truncated record at offset {pos}")
        if verify and masked_crc32c(buf[start:start + length]) != \
                _U32.unpack_from(buf, start + length)[0]:
            raise RecordError(f"{name}: corrupt data crc at offset {pos}")
        spans.append((start, length))
        pos = start + length + 4
    return spans


def record_views(buf, spans: list[tuple[int, int]]) -> list[memoryview]:
    """Zero-copy ``memoryview`` slices of ``buf`` over payload ``spans``.

    The view-producing half of the ingest fast path: one root view, one
    slice per record, no payload copies.  LIFETIME CONTRACT — each view
    pins the WHOLE shard buffer; holders must drop (or copy) their views
    when the chunk that delivered them is released, or a few retained
    records keep multi-MB buffers alive.  ``ingest`` enforces this in
    debug mode (``TOS_INGEST_ZEROCOPY=debug``) by releasing delivered
    views, making late access raise ``ValueError``.  Raw buffer slicing
    of shard files is confined here and in ``dfutil`` by the
    ``shard-io-discipline`` checker, so every view producer carries this
    contract.
    """
    root = memoryview(buf)
    return [root[off:off + length] for off, length in spans]


def walk_record_bounds(path: str, span_bytes: int) -> list[tuple[int, int]]:
    """Record-aligned ``(start, end)`` byte ranges of a PLAIN shard, each
    covering ~``span_bytes`` of file (the last may be smaller).

    The driver-side half of sub-shard work items: only record HEADERS are
    read (12 bytes per record, seek past payloads), so splitting a
    multi-GB shard costs header IO, not a full read — and no CRC work;
    verification happens node-side when the range is actually read.
    Raises :class:`RecordError` on a truncated header/record so a corrupt
    shard fails at enumeration, not mid-train.  Must not be called on
    gzip shards (no byte-addressable record boundaries exist there — see
    ``is_gzipped_shard``).
    """
    if span_bytes <= 0:
        raise ValueError(f"span_bytes must be positive, got {span_bytes}")
    size = os.path.getsize(path)
    bounds: list[tuple[int, int]] = []
    start = pos = 0
    with open(path, "rb") as f:
        while pos < size:
            if pos + 12 > size:
                raise RecordError(f"{path}: truncated header at offset {pos}")
            f.seek(pos)
            hdr = f.read(8)
            if len(hdr) < 8:
                raise RecordError(f"{path}: truncated header at offset {pos}")
            (length,) = _U64.unpack(hdr)
            nxt = pos + 12 + length + 4
            if nxt > size:
                raise RecordError(f"{path}: truncated record at offset {pos}")
            pos = nxt
            if pos - start >= span_bytes:
                bounds.append((start, pos))
                start = pos
    if pos > start:
        bounds.append((start, pos))
    return bounds


def map_span_range(path: str, start: int = 0, end: int | None = None,
                   verify: bool = True):
    """mmap-backed ``(buffer, spans)`` for a record-aligned byte range of a
    PLAIN shard (whole shard when ``end`` is None).

    The zero-copy twin of :func:`read_span_range`: the buffer is a
    ``memoryview`` over mapped pages, so the CRC scan and every record
    view read the page cache DIRECTLY — no copy of the range into process
    memory at all (``read()`` pays a full extra DRAM pass, which is what
    caps multi-node ingest of one shard on bandwidth-tight hosts).  The
    mapping lives exactly as long as the buffer/its views (refcounted);
    the ingest lifetime contract (views valid until chunk release) is
    unchanged.  Must not be used on gzip shards (caller probes first).
    """
    import mmap

    size = os.path.getsize(path)
    if end is None:
        end = size
    if not 0 <= start <= end <= size:
        raise ValueError(f"invalid span range [{start}, {end}) for {path} "
                         f"of size {size}")
    if start == end:
        return memoryview(b""), []
    aligned = (start // mmap.ALLOCATIONGRANULARITY) * mmap.ALLOCATIONGRANULARITY
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), end - aligned, prot=mmap.PROT_READ,
                       offset=aligned)
    if hasattr(mm, "madvise"):
        mm.madvise(mmap.MADV_SEQUENTIAL)
    buf = memoryview(mm)[start - aligned:]
    return buf, scan_record_spans(buf, verify,
                                  name=f"{path}[{start}:{end}]")


def map_record_spans(path: str, verify: bool = True):
    """Whole-shard :func:`map_span_range` with the gzip probe folded into
    the SAME open: the magic bytes are read off the mapped head, so the
    default zero-copy read path costs one ``open()`` per shard (on remote
    filesystems every extra open is a metadata round-trip).  Returns
    ``(buf, spans)`` for plain shards, ``(None, None)`` for gzip shards
    (no byte-addressable spans exist — the caller stream-decompresses).
    """
    import mmap

    size = os.path.getsize(path)
    if size == 0:
        return memoryview(b""), []
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ)
    if _is_gzip_shard(mm[:12]):
        mm.close()
        return None, None
    if hasattr(mm, "madvise"):
        mm.madvise(mmap.MADV_SEQUENTIAL)
    buf = memoryview(mm)
    return buf, scan_record_spans(buf, verify, name=path)


def read_span_range(path: str, start: int, end: int, verify: bool = True
                    ) -> tuple[bytes, list[tuple[int, int]]]:
    """Buffer + payload spans for ONE record-aligned byte range of a plain
    shard (a ``walk_record_bounds`` item): seek, one bounded read, one CRC
    scan.  The node-side half of sub-shard work items — N nodes each read
    their own range of the same multi-GB shard.  ``start``/``end`` MUST be
    record boundaries (the scan raises :class:`RecordError` otherwise, so
    a stale/corrupt range fails loudly rather than mis-framing)."""
    if not 0 <= start < end:
        raise ValueError(f"invalid span range [{start}, {end})")
    with open(path, "rb") as f:
        f.seek(start)
        buf = f.read(end - start)
    if len(buf) < end - start:
        raise RecordError(f"{path}: span range [{start}, {end}) past EOF")
    return buf, scan_record_spans(buf, verify,
                                  name=f"{path}[{start}:{end}]")


def read_record_spans(path: str, verify: bool = True) -> tuple[bytes, list[tuple[int, int]]]:
    """Whole-shard buffer + (offset, length) payload spans.

    The zero-copy companion of ``read_records`` for columnar consumers
    (``dfutil.read_shard_columns`` / the native Example parser): one buffer,
    one scan, no per-record slicing.  Handles gzip, but INFLATES the whole
    shard into memory to do it (the one-buffer contract requires it) — for
    gzip shards of unbounded size prefer ``read_records``, which streams.
    """
    import gzip

    with open(path, "rb") as f:
        buf = f.read()
    if _is_gzip_shard(buf[:12]):
        buf = gzip.decompress(buf)
    return buf, scan_record_spans(buf, verify, name=path)


def _is_gzip_shard(head: bytes) -> bool:
    """GZIP-vs-plain detection on a 12-byte header prefix.

    Must not misread a PLAIN shard whose first record length happens to
    collide with the gzip magic (the header starts with a little-endian
    uint64 length, so 0x1f 0x8b is reachable): beyond the 3-byte gzip
    signature, prefer the plain interpretation whenever the header's own
    masked length-CRC validates — a ~2^-32 discriminator.
    """
    if len(head) < 3 or head[:3] != b"\x1f\x8b\x08":
        return False
    return not (len(head) >= 12
                and masked_crc32c(head[:8]) == _U32.unpack_from(head, 8)[0])


def is_gzipped_shard(path: str) -> bool:
    """Whether the shard file is whole-stream gzipped (by header probe).

    The ingest reader pipeline keys its read strategy on this: plain shards
    go through ``read_record_spans`` (one IO read, one native CRC scan, span
    slices); gzip shards stream-decompress so a multi-GB shard never
    inflates into one buffer inside a reader thread.
    """
    with open(path, "rb") as probe:
        return _is_gzip_shard(probe.read(12))


def _stream_records(f, path: str, verify: bool) -> Iterator[bytes]:
    """Streaming framing parser over an open (possibly gzip) file object:
    constant memory regardless of shard size.  crc32c is the native slice-
    by-8 implementation when built (module-level swap), so streaming does
    not give up the fast checksum — only the whole-buffer C++ scan."""
    offset = 0
    while True:
        hdr = f.read(12)
        if not hdr:
            return
        if len(hdr) < 12:
            raise RecordError(f"{path}: truncated header at offset {offset}")
        (length,) = _U64.unpack_from(hdr, 0)
        (length_crc,) = _U32.unpack_from(hdr, 8)
        if verify and masked_crc32c(hdr[:8]) != length_crc:
            raise RecordError(f"{path}: corrupt length crc at offset {offset}")
        data = f.read(length)
        footer = f.read(4)
        if len(data) < length or len(footer) < 4:
            raise RecordError(f"{path}: truncated record at offset {offset}")
        if verify and masked_crc32c(data) != _U32.unpack(footer)[0]:
            raise RecordError(f"{path}: corrupt data crc at offset {offset}")
        yield data
        offset += 12 + length + 4


def read_records(path: str, verify: bool = True,
                 gzipped: bool | None = None) -> Iterator[bytes]:
    """Yield raw record payloads from a TFRecord file.

    Plain shards with the native codec are scanned whole in C++ (one CRC
    pass, no per-record Python framing work); otherwise a streaming Python
    parser.

    GZIP-compressed shards (TF's ``TFRecordOptions('GZIP')`` format — the
    whole stream gzipped; the reference's Hadoop TFRecord input supported
    the same) are detected by magic bytes and decompressed transparently
    (see ``_is_gzip_shard``) — and ALWAYS via streaming decompression
    (``gzip.open``), never a whole-file ``gzip.decompress``: a multi-GB
    gzip shard must not inflate into one buffer before the first record
    can be yielded (it would OOM an ingest reader thread).

    ``gzipped`` skips the header probe when the caller already knows (the
    ingest readers probe once per shard — on remote filesystems every
    extra open is a metadata round-trip).
    """
    import gzip

    if gzipped if gzipped is not None else is_gzipped_shard(path):
        with gzip.open(path, "rb") as f:
            yield from _stream_records(f, path, verify)
        return
    if _native is not None:
        buf, spans = read_record_spans(path, verify)
        for off, length in spans:
            yield buf[off : off + length]
        return
    with open(path, "rb") as f:
        yield from _stream_records(f, path, verify)


class RecordWriter:
    """Streaming TFRecord writer.

    ``compression='gzip'`` (or a ``.gz`` path suffix) writes the
    TF-compatible whole-stream-gzipped form; ``read_records`` auto-detects
    it on the way back.
    """

    def __init__(self, path: str, compression: str | None = None):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if compression is None and path.endswith(".gz"):
            compression = "gzip"
        normalized = (compression or "none").lower()
        if normalized in ("", "none"):
            self._f = open(path, "wb")
        elif normalized == "gzip":
            import gzip

            self._f = gzip.open(path, "wb")
        else:
            raise ValueError(f"unsupported compression {compression!r}; "
                             "use None or 'gzip'")

    def write(self, data: bytes) -> None:
        self._f.write(frame_record(data))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "RecordWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_records(path: str, records: Iterable[bytes],
                  compression: str | None = None) -> int:
    """Write all records to one file; returns the record count."""
    n = 0
    with RecordWriter(path, compression=compression) as w:
        for rec in records:
            w.write(rec)
            n += 1
    return n
