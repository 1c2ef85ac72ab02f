"""Partitioned dataset abstraction — the RDD stand-in.

The reference's data plane is a Spark RDD/DataFrame (partitions delivered by
Spark tasks, SURVEY.md §3.2).  This environment ships no Spark, and the
framework is standalone by design (SURVEY.md §7): ``PartitionedDataset`` is
the minimal partitioned collection the cluster API streams from.  Anything
that can yield partitions (list of lists, list of generators, glob of files)
adapts into it.
"""

from __future__ import annotations

import glob as _glob
from typing import Any, Callable, Iterable, Iterator, Sequence


class PartitionedDataset:
    """An ordered list of lazily-evaluated partitions."""

    def __init__(self, partition_fns: Sequence[Callable[[], Iterator[Any]]]):
        self._partition_fns = list(partition_fns)

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_partitions(cls, partitions: Sequence[Iterable[Any]]) -> "PartitionedDataset":
        """From concrete per-partition iterables (each re-iterable)."""
        return cls([(lambda p=p: iter(p)) for p in partitions])

    @classmethod
    def from_iterable(cls, items: Iterable[Any], num_partitions: int) -> "PartitionedDataset":
        """Split a flat sequence into ``num_partitions`` contiguous partitions."""
        items = list(items)
        n = len(items)
        base, extra = divmod(n, num_partitions)
        parts, start = [], 0
        for i in range(num_partitions):
            size = base + (1 if i < extra else 0)
            parts.append(items[start : start + size])
            start += size
        return cls.from_partitions(parts)

    @classmethod
    def from_files(cls, pattern: str, reader: Callable[[str], Iterator[Any]]) -> "PartitionedDataset":
        """One partition per file matching ``pattern`` (sorted), read lazily."""
        files = sorted(_glob.glob(pattern))
        if not files:
            raise FileNotFoundError(f"no files match {pattern!r}")
        return cls([(lambda f=f: reader(f)) for f in files])

    @classmethod
    def from_file_references(cls, pattern: str,
                             num_partitions: int | None = None) -> "PartitionedDataset":
        """Partitions of file PATHS, not bytes: the driver streams only the
        references and each node reads its shards itself.

        The Spark data-locality analogue for ``InputMode.SPARK``
        (reference: executors read their HDFS blocks locally,
        ``TFSparkNode.py:~430-510``) and the way past the driver's fan-out
        ceiling (~190 MB/s pickled bytes per driver core, PERF_NOTES): a
        path is tens of bytes on the wire regardless of shard size, so the
        aggregate read bandwidth scales with the NODE count.  Node-side,
        pair with ``dfutil.read_shard``/``read_shard_columns``.  Paths are
        distributed round-robin so shard sizes even out.
        """
        files = sorted(_glob.glob(pattern))
        if not files:
            raise FileNotFoundError(f"no files match {pattern!r}")
        n = len(files) if num_partitions is None else num_partitions
        if not 0 < n <= len(files):
            # an empty partition would idle its node — and deadlock lockstep
            # SPMD consumption (a host with zero data cannot join a global
            # step); fail at construction, not mid-job
            raise ValueError(f"num_partitions={n} must be in 1..{len(files)} "
                             f"(number of matched files)")
        return cls.from_partitions([files[i::n] for i in range(n)])

    # -- accessors -----------------------------------------------------------

    @property
    def num_partitions(self) -> int:
        return len(self._partition_fns)

    def iter_partition(self, index: int) -> Iterator[Any]:
        return self._partition_fns[index]()

    def __iter__(self) -> Iterator[Any]:
        for i in range(self.num_partitions):
            yield from self.iter_partition(i)

    # -- transforms ----------------------------------------------------------

    def map(self, fn: Callable[[Any], Any]) -> "PartitionedDataset":
        return PartitionedDataset(
            [(lambda pf=pf: (fn(x) for x in pf())) for pf in self._partition_fns]
        )

    def repartition(self, num_partitions: int) -> "PartitionedDataset":
        return PartitionedDataset.from_iterable(list(self), num_partitions)

    def shuffle_partitions(self, seed: int) -> "PartitionedDataset":
        """Deterministically reorder partitions (lazy; contents untouched).

        The between-epochs shuffle the reference got from Spark/tf.data file
        shuffling: pass a per-epoch seed so every epoch streams partitions
        in a different order without materializing anything.
        """
        import random

        order = list(range(self.num_partitions))
        random.Random(seed).shuffle(order)
        return PartitionedDataset([self._partition_fns[i] for i in order])


def shuffle_buffer(items: Iterable[Any], buffer_size: int,
                   seed: int) -> Iterator[Any]:
    """Streaming buffered shuffle — the ``tf.data.Dataset.shuffle`` analogue.

    Fills a ``buffer_size`` reservoir, then yields a uniformly random buffer
    slot per incoming item (replacing it), draining the rest at the end.
    O(buffer_size) memory, deterministic under ``seed``, emits every input
    exactly once.  Perfect shuffling needs ``buffer_size >= len(items)``;
    smaller buffers trade randomness for memory exactly like tf.data.
    """
    import random

    if buffer_size < 1:
        raise ValueError("buffer_size must be >= 1")
    rng = random.Random(seed)
    buf: list[Any] = []
    for item in items:
        if len(buf) < buffer_size:
            buf.append(item)
            continue
        idx = rng.randrange(buffer_size)
        yield buf[idx]
        buf[idx] = item
    rng.shuffle(buf)
    yield from buf


def interleave(factories: Sequence[Callable[[], Iterator[Any]]],
               num_readers: int = 2, buffer_size: int = 256) -> Iterator[Any]:
    """Read several sources with background reader threads — the
    ``tf.data.Dataset.interleave(..., num_parallel_calls=N)`` analogue and
    the consumer of the pipeline layer's ``readers`` Param (reference:
    per-node reader threads in DIRECT/TENSORFLOW input mode).

    ``factories`` are zero-arg callables returning fresh iterators (e.g.
    per-TFRecord-shard readers).  ``num_readers`` threads each pull whole
    sources off a shared work queue and push items into one bounded buffer;
    IO/decode of shard N+1 overlaps the consumer's compute on shard N.
    Cross-source item order is nondeterministic (like tf.data's parallel
    interleave); within one source, order is preserved.  Reader exceptions
    re-raise at the consumer.  With ``num_readers <= 1`` reads happen inline
    (deterministic order, zero threads).
    """
    import queue as _queue
    import threading

    if num_readers <= 1:
        for f in factories:
            yield from f()
        return

    work: _queue.Queue = _queue.Queue()
    for f in factories:
        work.put(f)
    out: _queue.Queue = _queue.Queue(maxsize=buffer_size)
    stop = threading.Event()
    DONE = object()
    failure: list[BaseException] = []

    def _reader() -> None:
        try:
            while not stop.is_set():
                try:
                    factory = work.get_nowait()
                except _queue.Empty:
                    return
                for item in factory():
                    while not stop.is_set():
                        try:
                            out.put(item, timeout=0.1)
                            break
                        except _queue.Full:
                            continue
                    if stop.is_set():
                        return
        except BaseException as e:  # noqa: BLE001 - re-raised consumer-side
            failure.append(e)
        finally:
            # bounded put: if the consumer abandoned the generator nobody
            # drains the buffer, and a blocking put would strand this thread
            while True:
                try:
                    out.put(DONE, timeout=0.1)
                    break
                except _queue.Full:
                    if stop.is_set():
                        break

    n = min(num_readers, len(factories)) or 1
    threads = [threading.Thread(target=_reader, name=f"interleave-{i}",
                                daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    done = 0
    try:
        while done < n:
            if failure:  # surface a reader crash NOW, not after the other
                raise failure[0]  # readers drain their (possibly huge) shards
            item = out.get()
            if item is DONE:
                done += 1
                continue
            yield item
        if failure:
            raise failure[0]
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10.0)


# -- columnar chunk packing (zero-copy wire format, dataserver.py) ------------
#
# A STREAMING feed chunk is usually HOMOGENEOUS: K bytes rows (image shards),
# K same-shape ndarrays, or K tuples/dicts of those.  Pickling such a chunk
# row-by-row pays per-row pickle machinery AND copies every payload byte into
# the pickle stream.  The classes below restructure a chunk so that pickle
# protocol 5 with ``buffer_callback`` serializes it as ONE small header plus
# K contiguous out-of-band buffers — which the data plane then scatter-gathers
# straight to the socket (``utils.net.sendmsg_all``) and receives into
# preallocated buffers (``recv_into``), with no per-row pickle work and no
# payload staging copies on the send side.


class _BytesColumn:
    """A column of ``bytes`` (or ``memoryview``) rows; each row travels as
    its own buffer.  Memoryview rows — the ingest zero-copy record views —
    scatter-gather straight from the shard buffer they slice; the receiver
    rebuilds real ``bytes`` either way."""

    __slots__ = ("rows",)

    def __init__(self, rows: list):
        self.rows = rows

    def __reduce_ex__(self, protocol):
        import pickle

        if protocol >= 5:
            return (_rebuild_bytes_column,
                    tuple(pickle.PickleBuffer(r) for r in self.rows))
        # protocol < 5 cannot pickle memoryview at all: materialize
        return (_rebuild_bytes_column,
                tuple(bytes(r) if type(r) is memoryview else r
                      for r in self.rows))


def _rebuild_bytes_column(*bufs) -> "_BytesColumn":
    # out-of-band buffers resolve to whatever the receiver handed pickle
    # (memoryview slices of the recv blob); normalize to real bytes rows
    return _BytesColumn([b if isinstance(b, bytes) else bytes(b) for b in bufs])


class _ArrayColumn:
    """A column of same-dtype/same-shape ndarrays: ONE header (dtype, shape)
    instead of K numpy pickle headers; each row is its own buffer."""

    __slots__ = ("rows",)

    def __init__(self, rows: list):
        self.rows = rows

    def __reduce_ex__(self, protocol):
        import pickle

        import numpy as np

        first = self.rows[0]
        if protocol >= 5:
            bufs = tuple(pickle.PickleBuffer(np.ascontiguousarray(r))
                         for r in self.rows)
            return (_rebuild_array_column,
                    (first.dtype.str, first.shape) + bufs)
        return (_rebuild_array_column,
                (first.dtype.str, first.shape)
                + tuple(np.ascontiguousarray(r).tobytes() for r in self.rows))


def _rebuild_array_column(dtype_str, shape, *bufs) -> "_ArrayColumn":
    import numpy as np

    rows = []
    for b in bufs:
        arr = np.frombuffer(b, dtype=np.dtype(dtype_str)).reshape(shape)
        if not arr.flags.writeable:
            # read-only receive buffers (bytes-backed ring records, in-band
            # fallback) must not leak into user code: pickled ndarrays were
            # always writable, and whether a map_fun may normalize in place
            # must not depend on which transport delivered the batch
            arr = arr.copy()
        rows.append(arr)
    return _ArrayColumn(rows)


# Rows below this size serialize IN-band: an out-of-band buffer costs a
# PickleBuffer + iovec slot + receiver-side view/rebuild per row (~µs each),
# which only pays for itself once the saved per-byte copies outweigh it.
# Measured crossover on the dataplane bench is low-single-digit KB; tabular
# ~1 KB rows must never regress (they were the fast case already).
_MIN_OOB_ROW_BYTES = 4096


def _pack_column(values: list):
    """Pack one homogeneous column, or None when it does not qualify."""
    import numpy as np

    first = values[0]
    if type(first) is bytes or type(first) is memoryview:
        # memoryview rows are the ingest zero-copy record views; mixing
        # with bytes rows is fine (every row is its own buffer either way)
        if len(first) >= _MIN_OOB_ROW_BYTES and all(
                type(v) in (bytes, memoryview) for v in values):
            return _BytesColumn(values)
        return None
    if isinstance(first, np.ndarray) and not first.dtype.hasobject:
        if first.dtype.kind == "V":
            # structured/void dtypes don't survive the dtype.str round-trip
            # (field names collapse to raw '|V8'); numpy's own reduce
            # serializes them correctly, so leave such rows unpacked
            return None
        if first.nbytes >= _MIN_OOB_ROW_BYTES and all(
                isinstance(v, np.ndarray) and v.dtype == first.dtype
                and v.shape == first.shape for v in values):
            return _ArrayColumn(values)
        return None
    return None


class PackedChunk:
    """A feed chunk restructured into columns for protocol-5 framing.

    ``layout`` is ``"flat"`` (rows ARE the single column's values),
    ``"tuple"`` (row i = tuple of column i-th values), or ``"dict"``
    (``meta`` holds the shared key order).  Columns are ``_BytesColumn`` /
    ``_ArrayColumn`` (out-of-band) or plain lists (in-band, e.g. labels).
    """

    __slots__ = ("layout", "columns", "meta")

    def __init__(self, layout: str, columns: tuple, meta: Any = None):
        self.layout = layout
        self.columns = columns
        self.meta = meta

    def __reduce__(self):
        return (PackedChunk, (self.layout, self.columns, self.meta))

    def __len__(self) -> int:
        if self.layout == "columns":
            return len(self.columns[0])  # the ColumnChunk itself
        col = self.columns[0]
        return len(col.rows if hasattr(col, "rows") else col)

    def rows(self) -> list:
        if self.layout == "columns":
            # a dfutil.ColumnChunk travelled whole (one contiguous buffer
            # per numeric column); it owns the columns->rows expansion
            return self.columns[0].rows()
        cols = [c.rows if hasattr(c, "rows") else c for c in self.columns]
        if self.layout == "flat":
            return cols[0]
        if self.layout == "tuple":
            return [tuple(vals) for vals in zip(*cols)]
        if self.layout == "dict":
            from tensorflowonspark_torch import dfutil

            return dfutil.columns_to_rows(self.meta, cols)
        raise ValueError(f"corrupt PackedChunk layout {self.layout!r}")


class DecodedChunk:
    """One pre-decoded ingest chunk in flight from a data-service worker to
    a trainer (the ``chunk_fwd`` wire op).

    ``payload`` is exactly what a trainer-local reader pipeline would have
    pushed: a list of record payloads (owned ``bytes`` — never zero-copy
    views, which cannot travel a wire), or a ``dfutil.ColumnChunk`` whose
    contiguous column buffers ride the v2/v3 wire out-of-band.  The
    trainer-side ``IngestFeed`` recognizes the wrapper on its input queue
    and injects the payload straight into its pipeline's decoded-chunk
    queue — the feed becomes a pure consumer, with the partition watermark
    accounting unchanged (each forwarded chunk is one "shard" of its
    ledger partition).  ``source`` is an opaque provenance tag (the
    worker's work-item key) for telemetry and debugging only.
    """

    __slots__ = ("payload", "nrows", "source", "_nbytes")

    def __init__(self, payload, source=None):
        self.payload = payload
        self.nrows = len(payload)
        self.source = source
        self._nbytes: int | None = None

    @property
    def nbytes(self) -> int:
        """Payload bytes, computed once per wrapper (the forwarder's
        byte counters must not re-walk every record per delivery)."""
        if self._nbytes is None:
            self._nbytes = chunk_nbytes(self.payload)
        return self._nbytes

    def __reduce__(self):
        return (DecodedChunk, (self.payload, self.source))

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<DecodedChunk rows={self.nrows} source={self.source!r}>"


def chunk_nbytes(payload) -> int:
    """Approximate payload bytes of one decoded chunk (record list or
    ``dfutil.ColumnChunk``) — the accounting unit of the ingest tier's
    cross-epoch chunk cache (``TOS_INGEST_CACHE_BYTES``) and its forwarded-
    bytes counters.  Cheap and slightly conservative: python object
    overhead is not charged, only payload bytes."""
    import numpy as np

    if hasattr(payload, "columns") and hasattr(payload, "counts"):
        total = 0
        for col in payload.columns.values():
            if isinstance(col, np.ndarray):
                total += col.nbytes
            else:  # bytes/str column: a plain list of per-record values
                total += sum(len(v) for v in col)
        for counts in payload.counts.values():
            total += (counts.nbytes if isinstance(counts, np.ndarray)
                      else 8 * len(counts))
        return total
    total = 0
    for r in payload:
        if isinstance(r, (bytes, bytearray, memoryview)):
            total += len(r)
        elif isinstance(r, np.ndarray):
            total += r.nbytes
        elif isinstance(r, tuple):
            total += sum(len(v) if isinstance(v, (bytes, memoryview))
                         else getattr(v, "nbytes", 8) for v in r)
        else:
            total += getattr(r, "nbytes", 64)
    return total


def pack_chunk(items: list) -> PackedChunk | None:
    """Columnar-pack a homogeneous chunk, or None when it does not qualify
    (the caller then sends the plain list — semantics are identical either
    way; packing only changes how the bytes travel).

    A ``dfutil.ColumnChunk`` (the ingest pipeline's columnar decode
    product) packs directly: its K contiguous column buffers ARE the
    out-of-band frame (protocol 5 ships each ndarray column as one
    buffer), and the receiver's ``unpack_items`` expands rows — no per-row
    repack on either side."""
    packed = _pack_chunk_inner(items)
    # pack-vs-fallback counts: a feed that silently stopped qualifying for
    # the zero-copy path (heterogeneous rows, sub-threshold sizes) shows up
    # here instead of as an unexplained throughput regression
    from tensorflowonspark_torch import telemetry

    telemetry.counter("dataplane.chunks_packed" if packed is not None
                      else "dataplane.chunks_unpacked").inc()
    return packed


def _pack_chunk_inner(items: list) -> PackedChunk | None:
    from tensorflowonspark_torch import dfutil

    if isinstance(items, dfutil.ColumnChunk):
        return PackedChunk("columns", (items,)) if len(items) else None
    if not items:
        return None
    first = items[0]
    if type(first) in (bytes, memoryview) or _is_ndarray(first):
        col = _pack_column(items)
        return PackedChunk("flat", (col,)) if col is not None else None
    if type(first) is tuple:
        n = len(first)
        if n == 0 or not all(type(r) is tuple and len(r) == n for r in items):
            return None
        packed_any = False
        columns = []
        for pos in range(n):
            values = [r[pos] for r in items]
            col = _pack_column(values)
            packed_any = packed_any or col is not None
            columns.append(col if col is not None else values)
        return PackedChunk("tuple", tuple(columns)) if packed_any else None
    if type(first) is dict:
        # row-dict chunks (the dfutil row model) pack per key; dfutil owns
        # the rows<->columns reshaping so schema'd readers share one path
        from tensorflowonspark_torch import dfutil

        reshaped = dfutil.rows_to_columns(items)
        if reshaped is None:
            return None
        keys, value_lists = reshaped
        packed_any = False
        columns = []
        for values in value_lists:
            col = _pack_column(values)
            packed_any = packed_any or col is not None
            columns.append(col if col is not None else values)
        if not packed_any:
            return None
        return PackedChunk("dict", tuple(columns), meta=keys)
    return None


def _is_ndarray(x: Any) -> bool:
    import numpy as np

    return isinstance(x, np.ndarray)


def materialize_views(items: list) -> list:
    """bytes-ify memoryview rows (and views inside tuple/dict rows) that
    did NOT qualify for out-of-band packing — plain pickle cannot
    serialize memoryview at all, so a sub-threshold zero-copy record
    reaching the wire unpacked must materialize here rather than crash
    deep in the transport.  Returns ``items`` unchanged when nothing
    needs fixing (the overwhelmingly common case)."""

    def _dirty(v) -> bool:
        if type(v) is memoryview:
            return True
        if type(v) in (tuple, list):
            return any(type(x) is memoryview for x in v)
        if type(v) is dict:
            return any(type(x) is memoryview for x in v.values())
        return False

    def _fix(v):
        if type(v) is memoryview:
            return bytes(v)
        if type(v) in (tuple, list) and _dirty(v):
            fixed = [bytes(x) if type(x) is memoryview else x for x in v]
            return tuple(fixed) if type(v) is tuple else fixed
        if type(v) is dict and _dirty(v):
            return {k: bytes(x) if type(x) is memoryview else x
                    for k, x in v.items()}
        return v

    if not isinstance(items, list):
        return items
    if any(_dirty(v) for v in items):
        return [_fix(x) for x in items]
    return items


def unpack_items(items: Any) -> list:
    """Server-side inverse of ``pack_chunk``: a PackedChunk (or a bare
    ``dfutil.ColumnChunk`` fed as one pre-packed item) becomes its row
    list; anything else passes through unchanged (old peers send lists)."""
    if isinstance(items, PackedChunk):
        return items.rows()
    if hasattr(items, "rows") and hasattr(items, "counts"):  # ColumnChunk
        return items.rows()
    return items


def as_partitioned(data: Any, default_partitions: int = 1) -> PartitionedDataset:
    """Coerce user input into a PartitionedDataset.

    Accepts a PartitionedDataset, a sequence of *lists* (interpreted as
    partitions), or a flat iterable of samples (split into
    ``default_partitions``).  Samples that are themselves sequences should be
    tuples, not lists, to avoid ambiguity with the partition form.
    """
    if isinstance(data, PartitionedDataset):
        return data
    data = list(data)
    if data and all(isinstance(p, list) for p in data):
        return PartitionedDataset.from_partitions(data)
    return PartitionedDataset.from_iterable(data, default_partitions)
