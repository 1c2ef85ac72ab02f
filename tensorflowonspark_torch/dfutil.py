"""Row-data ⇄ TFRecord bridge with schema inference.

The TPU-native replacement for ``tensorflowonspark/dfutil.py`` (~230 LoC):
``saveAsTFRecords``/``loadTFRecords``/``toTFExample``/``fromTFExample``/
``infer_schema`` operated on Spark DataFrames via the tensorflow-hadoop jar;
here the same capabilities operate on ``PartitionedDataset`` rows (dicts)
through the in-repo TFRecord + Example codecs — no Spark, no JVM, no TF.

A "row" is a ``dict[str, value-or-list]``.  Scalars round-trip as length-1
lists unless the schema marks them scalar.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob as _glob
import json
import os
from typing import Iterator

from tensorflowonspark_torch import example as ex
from tensorflowonspark_torch import tfrecord
from tensorflowonspark_torch.data import PartitionedDataset
from tensorflowonspark_torch.utils.paths import resolve_uri

_TYPES = ("bytes", "float", "int64")


@dataclasses.dataclass
class ColumnSpec:
    name: str
    dtype: str  # bytes | float | int64
    scalar: bool = True
    # Fixed per-record value count for non-scalar columns, when known
    # (``infer_schema`` records the representative row's width); None
    # declares the column RAGGED.  Columnar consumers key their batch
    # representation on THIS — never on any one chunk's data — so the
    # shape a map_fun sees is stable across chunks and shards.
    width: int | None = None


@dataclasses.dataclass
class Schema:
    """Column layout of a record dataset (reference ``infer_schema``)."""

    columns: list[ColumnSpec]

    def to_json(self) -> str:
        # ``width: null`` is omitted (None is the default anyway): schema
        # files written without any declared width stay readable by older
        # releases whose ColumnSpec predates the field
        return json.dumps([
            {k: v for k, v in dataclasses.asdict(c).items()
             if not (k == "width" and v is None)}
            for c in self.columns])

    @classmethod
    def from_json(cls, s: str) -> "Schema":
        # tolerate unknown keys both ways: old JSON lacking ``width``
        # defaults it, and JSON from a NEWER release (extra fields) must
        # not break this one — schema files outlive installs
        known = {f.name for f in dataclasses.fields(ColumnSpec)}
        return cls([ColumnSpec(**{k: v for k, v in c.items() if k in known})
                    for c in json.loads(s)])

    def __getitem__(self, name: str) -> ColumnSpec:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(name)


def _dtype_of(value) -> str:
    v = value[0] if isinstance(value, (list, tuple)) and value else value
    if isinstance(v, (bytes, bytearray, str)):
        return "bytes"
    if isinstance(v, bool):
        return "int64"
    if isinstance(v, float):
        return "float"
    if isinstance(v, int):
        return "int64"
    # numpy scalars / arrays
    import numpy as np

    if isinstance(v, np.floating):
        return "float"
    if isinstance(v, (np.integer, np.bool_)):
        return "int64"
    raise TypeError(f"unsupported value type {type(v).__name__}")


def infer_schema(row: dict) -> Schema:
    """Infer a Schema from one representative row (reference ``infer_schema``,
    ``dfutil.py:~200-230``)."""
    cols = []
    for name in sorted(row):
        value = row[name]
        scalar = not isinstance(value, (list, tuple))
        import numpy as np

        if isinstance(value, np.ndarray):
            scalar = value.ndim == 0
            value = value.tolist()
        width = None if scalar else len(value)
        cols.append(ColumnSpec(name, _dtype_of(value), scalar, width))
    return Schema(cols)


def to_example(row: dict, schema: Schema | None = None) -> bytes:
    """Serialize one row to a ``tf.train.Example`` (reference ``toTFExample``)."""
    import numpy as np

    feats = {}
    for name, value in row.items():
        if isinstance(value, np.ndarray):
            value = value.tolist()
        if not isinstance(value, (list, tuple)):
            value = [value]
        if schema is not None:
            dtype = schema[name].dtype
            cast = {"bytes": lambda v: v if isinstance(v, (bytes, bytearray)) else str(v).encode(),
                    "float": float, "int64": int}[dtype]
            value = [cast(v) for v in value]
        else:
            # untyped path: floats stay floats, ints stay ints, str → bytes
            value = [v.encode() if isinstance(v, str) else v for v in value]
        feats[name] = list(value)
    return ex.encode_example(feats)


def from_example(buf: bytes, schema: Schema | None = None, binary_features: set | None = None) -> dict:
    """Deserialize an Example into a row (reference ``fromTFExample``).

    ``binary_features`` mirrors the reference's option: bytes columns listed
    there stay ``bytes``; other bytes columns decode to ``str``.
    """
    raw = ex.decode_example(buf)
    row = {}
    for name, values in raw.items():
        if values and isinstance(values[0], bytes) and (binary_features is None or name not in binary_features):
            values = [v.decode("utf-8", errors="replace") for v in values]
        if schema is not None and schema[name].scalar and len(values) == 1:
            row[name] = values[0]
        else:
            row[name] = values
    return row


def save_as_tfrecords(data: PartitionedDataset, output_dir: str, schema: Schema | None = None,
                      compression: str | None = None) -> Schema:
    """Write one TFRecord shard per partition (reference ``saveAsTFRecords``,
    ``dfutil.py:~30-60``); stores the schema alongside as ``_schema.json``.
    ``compression='gzip'`` writes TF-compatible gzipped shards (``.gz``
    suffix; readers auto-detect)."""
    output_dir = resolve_uri(output_dir)
    os.makedirs(output_dir, exist_ok=True)
    # Crash-safe clobber semantics: a re-save replaces the directory's shard
    # set (with compression the shard NAMES change — .gz suffix — so stale
    # shards must go or shard_files() would load both generations), but the
    # previous generation must survive any mid-save failure (schema
    # inference error, disk full, interrupt).  So: write the new generation
    # under temp names invisible to shard_files()'s ``part-*`` glob, and
    # only after every partition is fully written delete the old shards and
    # rename the new ones into place.
    for orphan in _glob.glob(os.path.join(output_dir, ".tmp-part-*")):
        os.remove(orphan)  # uncommitted leftovers of an earlier crashed save
    suffix = ".gz" if compression and compression.lower() == "gzip" else ""
    tmp_final: list[tuple[str, str]] = []
    # Widths auto-inferred from ONE representative row are only a guess;
    # ragged data must RELAX them to None while writing, or the stored
    # schema would promise a fixed-width columnar layout the shards break
    # mid-train.  A caller-provided schema's declarations are its own.
    inferred = schema is None
    try:
        for p in range(data.num_partitions):
            name = f"part-r-{p:05d}{suffix}"
            tmp = os.path.join(output_dir, f".tmp-{name}")
            with tfrecord.RecordWriter(tmp, compression=compression) as w:
                for row in data.iter_partition(p):
                    if schema is None:
                        schema = infer_schema(row)
                    elif inferred:
                        _relax_widths(schema, row)
                    w.write(to_example(row, schema))
            tmp_final.append((tmp, os.path.join(output_dir, name)))
        if schema is None:
            raise ValueError("dataset is empty; cannot infer a schema")
    except BaseException:
        # includes the half-written shard whose writer raised (it is not in
        # tmp_final yet); all .tmp-part-* here are ours and uncommitted
        for tmp in _glob.glob(os.path.join(output_dir, ".tmp-part-*")):
            with contextlib.suppress(OSError):
                os.remove(tmp)
        raise
    for stale in _glob.glob(os.path.join(output_dir, "part-*")):
        os.remove(stale)
    for tmp, final in tmp_final:
        os.replace(tmp, final)
    with open(os.path.join(output_dir, "_schema.json"), "w") as f:
        f.write(schema.to_json())
    return schema


def _relax_widths(schema: Schema, row: dict) -> None:
    """Demote an auto-inferred fixed column width to ragged (None) the
    moment any row disagrees with it — the stored schema must describe
    the data that was actually written."""
    for c in schema.columns:
        if c.width is None:
            continue
        value = row.get(c.name)
        if isinstance(value, (list, tuple)):
            n = len(value)
        elif hasattr(value, "ndim"):  # ndarray
            n = 1 if value.ndim == 0 else len(value)
        else:
            n = 0 if value is None else 1
        if n != c.width:
            c.width = None


def shard_files(input_dir: str) -> list[str]:
    """List the TFRecord shard files of a dataset directory, sorted."""
    local = resolve_uri(input_dir)
    files = sorted(f for f in _glob.glob(os.path.join(local, "part-*")) if not f.endswith(".json"))
    if not files:
        raise FileNotFoundError(f"no TFRecord shards under {local}")
    return files


def read_schema(input_dir: str) -> Schema | None:
    """Load the ``_schema.json`` stored next to the shards, if present."""
    path = os.path.join(resolve_uri(input_dir), "_schema.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return Schema.from_json(f.read())


def read_shard(path: str, schema: Schema | None = None,
               binary_features: set | None = None) -> Iterator[dict]:
    """Iterate one shard file as rows."""
    for rec in tfrecord.read_records(path):
        yield from_example(rec, schema, binary_features)


def read_shard_columns(path: str, schema: Schema,
                       binary_features: set | None = None
                       ) -> tuple[dict, dict]:
    """Columnar shard decode — the data-loader fast path.

    Returns ``(columns, counts)``: ``columns[name]`` is every value of that
    feature across the shard, concatenated (``np.float32``/``np.int64``
    ndarray, or a list of ``bytes``/``str``); ``counts[name]`` is the
    per-record value count (``uint64``; 0 where a record lacks the feature),
    so fixed-width columns reshape to ``[n_records, k]`` and ragged ones
    split by ``np.cumsum``.

    With the native parser (``native/example_parser.cc``) the whole shard is
    decoded in C++ — two ctypes calls per column instead of a Python proto
    walk per record (~25x on tabular/float-heavy shards; image-bytes shards
    are IO-bound either way — see PERF_NOTES).  The pure-Python fallback
    produces identical output, including dtype-mismatch errors.

    The buffer-level half is :func:`decode_span_columns` — the ingest
    reader pipeline calls it per decoded chunk so a shard (or sub-shard
    span range) materializes as K contiguous column buffers without this
    wrapper's whole-shard materialization.
    """
    buf, spans = tfrecord.read_record_spans(path)
    return decode_span_columns(buf, spans, schema, binary_features)


def decode_span_columns(buf, spans, schema: Schema,
                        binary_features: set | None = None
                        ) -> tuple[dict, dict]:
    """Columnar Example decode of record payload ``spans`` within ``buf``
    (a ``tfrecord.read_record_spans``/``read_span_range`` result, or any
    record-aligned subset of its spans).  Same ``(columns, counts)``
    contract as :func:`read_shard_columns`; the native parser decodes the
    whole span set in C++ when built."""

    try:
        from tensorflowonspark_torch import example_native
    except Exception:  # noqa: BLE001 - no compiler: pure-Python fallback
        example_native = None

    decode_bytes = _bytes_decoder(binary_features)
    if example_native is not None:
        spans = example_native.span_arrays(spans)  # one O(n) walk, not per column
        columns, counts = {}, {}
        for c in schema.columns:
            values, cnt = example_native.extract_column(buf, spans, c.name, c.dtype)
            if c.dtype == "bytes":
                values = decode_bytes(c.name, values)
            columns[c.name] = values
            counts[c.name] = cnt
        return columns, counts

    payloads = (buf[off:off + length] for off, length in spans)
    return _accumulate_columns(payloads, schema, decode_bytes)


def records_to_columns(payloads, schema: Schema,
                       binary_features: set | None = None
                       ) -> tuple[dict, dict]:
    """Columnar accumulation over an iterable of raw Example payloads —
    the streaming twin of :func:`decode_span_columns` for shards with no
    byte-addressable spans (gzip: records stream in, columns come out)."""
    return _accumulate_columns(payloads, schema,
                               _bytes_decoder(binary_features))


def _bytes_decoder(binary_features: set | None):
    def _decode_bytes(name, values):
        if binary_features is None or name not in binary_features:
            return [v.decode("utf-8", errors="replace") for v in values]
        return values

    return _decode_bytes


def _accumulate_columns(payloads, schema: Schema, decode_bytes
                        ) -> tuple[dict, dict]:
    import numpy as np

    expect = {"bytes": bytes, "float": float, "int64": int}
    acc: dict[str, list] = {c.name: [] for c in schema.columns}
    cnt: dict[str, list] = {c.name: [] for c in schema.columns}
    for rec in payloads:
        raw = ex.decode_example(bytes(rec) if isinstance(rec, memoryview)
                                else rec)
        for c in schema.columns:
            values = raw.get(c.name, [])
            # mirror the native path's kind check: a float column read under
            # an int64 schema must raise, not silently truncate
            if values and not isinstance(values[0], expect[c.dtype]):
                raise TypeError(f"feature {c.name!r} is not of dtype {c.dtype!r}")
            acc[c.name].extend(values)
            cnt[c.name].append(len(values))
    columns, counts = {}, {}
    for c in schema.columns:
        if c.dtype == "float":
            columns[c.name] = np.asarray(acc[c.name], np.float32)
        elif c.dtype == "int64":
            columns[c.name] = np.asarray(acc[c.name], np.int64)
        else:
            columns[c.name] = decode_bytes(c.name, acc[c.name])
        counts[c.name] = np.asarray(cnt[c.name], np.uint64)
    return columns, counts


class ColumnChunk:
    """A decoded chunk of Example records as K contiguous column buffers.

    What the ingest reader pipeline pushes in columnar (``schema=``) mode
    instead of a per-record row list: ``columns[name]`` holds the chunk's
    concatenated values (ndarray for float/int64, list for bytes/str) and
    ``counts[name]`` the per-record value counts — the
    :func:`decode_span_columns` layout, chunk-sized.  ``slice(a, b)``
    serves batch windows as zero-copy views whose REPRESENTATION is fixed
    by the SCHEMA, never by any one chunk's data (a chunk that happens to
    be uniform must not change the shape a map_fun sees mid-feed):
    scalar columns come back ``[n]``, declared-width columns ``[n, k]``,
    and ``width=None`` (ragged) columns as a ``(values, counts)`` pair.
    A record violating its column's declared scalar/width raises a loud
    ``ValueError`` naming the column (declare ``width=None`` in the
    schema for genuinely ragged data).  ``rows()`` expands to row-dicts
    (the wire-side inverse — ``data.pack_chunk`` ships a ColumnChunk as
    one out-of-band buffer per numeric column).
    """

    __slots__ = ("columns", "counts", "n", "scalars", "widths", "_offsets",
                 "_validated")

    def __init__(self, columns: dict, counts: dict, n: int,
                 scalars: frozenset = frozenset(),
                 widths: dict | None = None):
        self.columns = columns
        self.counts = counts
        self.n = n
        self.scalars = scalars
        # name -> declared fixed width (1 for scalar), or None = ragged;
        # missing names (legacy schemas) default to ragged — stable, if
        # less convenient, for data whose width nobody declared
        self.widths = widths if widths is not None else {}
        self._offsets: dict = {}
        self._validated: set = set()

    @classmethod
    def from_schema(cls, columns: dict, counts: dict, schema: Schema
                    ) -> "ColumnChunk":
        n = len(next(iter(counts.values()))) if counts else 0
        widths = {c.name: 1 if c.scalar else getattr(c, "width", None)
                  for c in schema.columns}
        return cls(columns, counts, n,
                   frozenset(c.name for c in schema.columns if c.scalar),
                   widths)

    def __reduce__(self):
        # plain tuple state: ndarray columns ride pickle protocol 5's
        # native out-of-band buffer support (one buffer per column)
        return (_rebuild_column_chunk,
                (self.columns, self.counts, self.n, tuple(self.scalars),
                 self.widths))

    def __len__(self) -> int:
        return self.n

    def _col_width(self, name: str):
        """The column's schema-declared width (None = ragged), VALIDATED
        against this chunk's counts once (own marker set — the offsets
        cache must not stand in for it, or a rows() call would bypass the
        check): fixed-width representation with non-conforming data
        mis-frames silently, so it fails loudly."""
        import numpy as np

        w = self.widths.get(name)
        if w is not None and name not in self._validated:
            counts = np.asarray(self.counts[name], np.int64)
            if counts.size and (counts.min() != w or counts.max() != w):
                bad = int(counts[(counts != w).argmax()]) \
                    if hasattr(counts, "argmax") else "?"
                raise ValueError(
                    f"column {name!r} declares width {w} but a record has "
                    f"{bad} values; declare width=None in the schema for "
                    "ragged columns")
            self._validated.add(name)
        return w

    def _col_offsets(self, name: str):
        import numpy as np

        off = self._offsets.get(name)
        if off is None:
            counts = np.asarray(self.counts[name], np.int64)
            off = np.concatenate(([0], np.cumsum(counts)))
            self._offsets[name] = off
        return off

    def slice(self, a: int, b: int) -> dict:
        """Columns of records ``[a, b)`` as zero-copy views: scalar
        columns ``[n]`` (flat lists for bytes), declared-width columns
        ``[n, k]`` ndarray views (list-of-lists for bytes), ragged
        (``width=None``) columns ``(values, counts)`` pairs."""
        out = {}
        for name, values in self.columns.items():
            k = self._col_width(name)
            if k is not None:
                vals = values[a * k:b * k]
                if k == 1:
                    out[name] = vals
                elif hasattr(vals, "reshape"):
                    out[name] = vals.reshape(b - a, k)
                else:  # bytes column, k values per record
                    out[name] = [vals[i * k:(i + 1) * k] for i in range(b - a)]
            else:
                off = self._col_offsets(name)
                lo, hi = int(off[a]), int(off[b])
                out[name] = (values[lo:hi], self.counts[name][a:b])
        return out

    def rows(self) -> list[dict]:
        """Expand back to per-record row dicts (``from_example`` shape:
        scalar-schema columns unwrap single values, others stay lists)."""
        out: list[dict] = [{} for _ in range(self.n)]
        for name, values in self.columns.items():
            off = self._col_offsets(name)
            scalar = name in self.scalars
            for i in range(self.n):
                lo, hi = int(off[i]), int(off[i + 1])
                vals = values[lo:hi]
                if not isinstance(vals, list):
                    vals = vals.tolist()
                out[i][name] = vals[0] if scalar and len(vals) == 1 else vals
        return out


def _rebuild_column_chunk(columns, counts, n, scalars,
                          widths=None) -> ColumnChunk:
    return ColumnChunk(columns, counts, n, frozenset(scalars), widths)


def rows_to_columns(rows: list) -> tuple[tuple, list] | None:
    """Reshape a chunk of row-dicts into ``(keys, per-key value lists)``.

    The columnar half of the zero-copy wire format (``data.pack_chunk``):
    a chunk of homogeneous row-dicts — the shape every ``dfutil`` reader
    and the pipeline layer produce — serializes as one header + per-column
    contiguous buffers instead of K dict pickles.  Returns None when the
    rows do not share one key set (heterogeneous chunks stay row-major).
    """
    if not rows or not isinstance(rows[0], dict):
        return None
    keys = tuple(rows[0])
    keyset = set(keys)
    for r in rows:
        if type(r) is not dict or len(r) != len(keys) or set(r) != keyset:
            return None
    return keys, [[r[k] for r in rows] for k in keys]


def columns_to_rows(keys: tuple, value_lists: list) -> list[dict]:
    """Inverse of ``rows_to_columns`` (kept here so the two can never
    drift; ``data.PackedChunk.rows`` is the wire-side consumer)."""
    return [dict(zip(keys, vals)) for vals in zip(*value_lists)]


def load_tfrecords(input_dir: str, binary_features: set | None = None) -> tuple[PartitionedDataset, Schema | None]:
    """Load a TFRecord directory as a PartitionedDataset of rows (reference
    ``loadTFRecords``, ``dfutil.py:~60-100``); one partition per shard file."""
    schema = read_schema(input_dir)
    files = shard_files(input_dir)
    return (
        PartitionedDataset([(lambda f=f: read_shard(f, schema, binary_features)) for f in files]),
        schema,
    )
