"""Node-side shard reader pipeline: parallel interleave + decode + prefetch.

The DIRECT-input-mode data plane (the reference's ``InputMode.TENSORFLOW``,
per the tf.data paper's parallel-interleave/prefetch design, PAPERS.md):
instead of the driver pumping every row over one socket, each node claims
TFRecord *shard paths* and reads the bytes itself —

    work queue (paths) -> N reader threads -> bounded chunk queue -> consumer
                          read + CRC-verify     (the prefetch buffer)
                          + decode

- **Readers** pull work items — whole shard paths, or ``ShardSpan``
  sub-shard byte ranges of a large plain shard — off the shared work queue
  (tf.data's ``interleave(cycle_length=N)``): plain shards/ranges via one
  IO read + native CRC scan, then ZERO-COPY ``memoryview`` record slices
  (``TOS_INGEST_ZEROCOPY``; no per-record copy between disk and consumer),
  gzip shards via streaming decompression (never a whole-file inflate,
  always ``bytes``).  An optional ``decode`` callable runs per record
  inside the reader thread, so decode parallelism rides reader
  parallelism; a ``schema`` routes records through COLUMNAR Example decode
  instead (``dfutil.decode_span_columns`` — chunks materialize as K
  contiguous column buffers, no per-record parse).
- **The chunk queue is the prefetch buffer** (``TOS_INGEST_PREFETCH``
  chunks deep): readers run ahead of the consumer by up to that many
  decoded chunks, and block (backpressure) beyond it.
- **Autotuned parallelism** (``TOS_INGEST_AUTOTUNE``, tf.data-paper style):
  rather than a fixed thread knob, the consumer's pops sample the queue's
  occupancy — a starving consumer (queue near empty, work pending) grows
  the reader pool toward ``TOS_INGEST_READERS``; a saturated queue shrinks
  it (readers retire at shard boundaries).  Occupancy, pool size, and every
  spawn/retire are exported through ``telemetry``.

``IngestFeed`` (``ingest/feed.py``) drives this pipeline from the node's
feed queue; ``bench_ingest.py`` drives it raw for the scaling numbers.
"""

from __future__ import annotations

import logging
import queue
import threading
from tensorflowonspark_torch.utils.locks import tos_named_lock
import time

from tensorflowonspark_torch import telemetry
from tensorflowonspark_torch import tfrecord
from tensorflowonspark_torch.ingest.shards import ShardSpan
from tensorflowonspark_torch.utils.envtune import env_bool as _env_bool
from tensorflowonspark_torch.utils.envtune import env_int as _env_int
from tensorflowonspark_torch.utils.envtune import env_str as _env_str
from tensorflowonspark_torch.utils.paths import resolve_uri

logger = logging.getLogger(__name__)

# Autotune thresholds on the occupancy EMA (fraction of queue capacity):
# below LOW with work pending the consumer is starving (grow the pool);
# above HIGH the readers outrun the consumer (shrink it — the threads
# would only block on the full queue anyway).
_TUNE_LOW = 0.25
_TUNE_HIGH = 0.85
_TUNE_INTERVAL_SECS = 0.2
_EMA_ALPHA = 0.3


class ShardReadError(RuntimeError):
    """A reader thread failed on a shard (corrupt CRC, IO error, decode
    bug); re-raised at the consumer with the shard path attached."""


def zerocopy_mode(zerocopy=None) -> str:
    """Resolve a zero-copy setting to ``'on'`` / ``'off'`` / ``'debug'``.

    ``None`` reads ``TOS_INGEST_ZEROCOPY`` (default on); booleans and the
    knob's string values both normalize.  ``debug`` is zero-copy PLUS
    release tracking: the feed releases delivered views when their batch
    retires, so code that retains a view past the documented lifetime gets
    a loud ``ValueError`` instead of silently pinning shard buffers.
    """
    if zerocopy is None:
        zerocopy = _env_str("TOS_INGEST_ZEROCOPY", "1")
    if isinstance(zerocopy, bool):
        return "on" if zerocopy else "off"
    mode = str(zerocopy).strip().lower()
    if mode in ("0", "off", "false", "no"):
        return "off"
    if mode == "debug":
        return "debug"
    return "on"


def _materialize_chunk(chunk):
    """An OWNED copy of one decoded chunk, safe to outlive its shard read:
    ``memoryview`` records become ``bytes``; a ``dfutil.ColumnChunk`` whose
    column arrays view the shard mmap is rebuilt over owning arrays.
    Already-owned chunks (bytes records, owning arrays) copy the list
    head only."""
    import numpy as np

    if hasattr(chunk, "columns") and hasattr(chunk, "counts"):
        cols = {name: (np.array(col, copy=True)
                       if isinstance(col, np.ndarray)
                       and not col.flags.owndata else col)
                for name, col in chunk.columns.items()}
        if all(cols[n] is chunk.columns[n] for n in cols):
            return chunk  # every column already owns its buffer
        clone = type(chunk)(cols, chunk.counts, chunk.n, chunk.scalars,
                            chunk.widths)
        return clone
    return [bytes(r) if type(r) is memoryview else r for r in chunk]


class ShardDone:
    """Control token: every record of one claimed shard has been pushed
    (FIFO) before this token — popping it proves the shard fully drained
    out of the chunk queue.  ``tag`` is the submitter's opaque bookkeeping
    handle (the ingest feed's partition job)."""

    __slots__ = ("path", "tag")

    def __init__(self, path: str, tag=None):
        self.path = path
        self.tag = tag


class _Failure:
    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error


_DRAINED = object()


class ReaderPipeline:
    """Parallel shard readers feeding one bounded decoded-chunk queue.

    Thread roles: ``submit``/``close`` are producer-side (one thread — the
    ingest feed's claimer, or a bench loop); ``get`` is consumer-side (one
    thread — the map_fun via ``IngestFeed``); reader threads are internal.
    """

    def __init__(self, *, readers: int | None = None,
                 autotune: bool | None = None, prefetch: int | None = None,
                 chunk_records: int = 256, decode=None, verify: bool = True,
                 stop_event: threading.Event | None = None,
                 zerocopy=None, schema=None, binary_features=None,
                 cache=None):
        self._max_readers = max(0, readers if readers is not None
                                else _env_int("TOS_INGEST_READERS", 4, minimum=0))
        # Zero-copy decode contract (TOS_INGEST_ZEROCOPY, default ON): plain
        # shards deliver records as MEMORYVIEW slices of the shard buffer —
        # no per-record copy between the disk read and the consumer.  Each
        # view pins the whole buffer, so holders must drop/copy views once
        # their chunk is released (the feed layer defines release as batch
        # retirement); 'off' restores bytes copies, 'debug' releases
        # delivered views so late access fails loudly.  Gzip shards always
        # deliver bytes (stream-decompressed; no stable buffer to view).
        self.zerocopy = zerocopy_mode(zerocopy)
        # Columnar Example decode (schema=...): chunks materialize as
        # dfutil.ColumnChunk — K contiguous column buffers straight from
        # the span scan (native parser when built) instead of per-record
        # parse + per-row repack.  Mutually exclusive with decode= (the
        # schema IS the decoder).
        if schema is not None and decode is not None:
            raise ValueError("schema= and decode= are mutually exclusive: "
                             "columnar decode is driven by the schema")
        self.schema = schema
        self.binary_features = binary_features
        # readers=0: SYNCHRONOUS mode — no reader threads at all, get()
        # reads the next shard inline in the consumer thread (the tf.data
        # ``num_parallel_calls=None`` analogue).  Trades away read/compute
        # overlap for zero cross-thread traffic — the right shape when a
        # node has one core to its name (bench_ingest measures node
        # scale-out in exactly this configuration).
        self._sync = self._max_readers == 0
        self._autotune = (not self._sync) and (
            autotune if autotune is not None
            else _env_bool("TOS_INGEST_AUTOTUNE", True))
        depth = max(1, prefetch if prefetch is not None
                    else _env_int("TOS_INGEST_PREFETCH", 8))
        self.chunk_records = max(1, chunk_records)
        self.decode = decode
        self.verify = verify
        # Cross-epoch chunk cache (ingest/service.py ChunkCache, or any
        # object with get/put/key_for): repeated reads of the same work
        # item + schema serve MATERIALIZED decoded chunks from memory
        # instead of re-running the CRC scan + decode.  Inactive with a
        # per-record ``decode`` callable — its identity cannot be part of
        # the cache key, and serving another decoder's output would be
        # silent corruption.
        self._cache = cache if (cache is not None
                                and getattr(cache, "enabled", True)
                                and decode is None) else None
        # sync mode buffers one whole shard's chunks at a time (get() is
        # both reader and consumer, so a bounded put would self-deadlock)
        self._out: queue.Queue = queue.Queue(maxsize=0 if self._sync else depth)
        self._work: queue.Queue = queue.Queue()  # paths: tiny, unbounded
        self._stop = stop_event if stop_event is not None else threading.Event()
        self._lock = tos_named_lock("readers._lock")
        self._active = 0
        self._target = 1 if self._autotune else self._max_readers
        self._closed = False
        self._drained_pushed = False
        # consumer-side autotune state (touched only from get(); the lock
        # covers the reader-pool fields both sides mutate)
        self._occupancy_ema = 0.0
        self._last_tune = time.monotonic()
        for _ in range(self._target):
            self._spawn_reader_locked()  # pre-publication: no lock needed yet

    # -- producer side -------------------------------------------------------

    def submit(self, path, tag=None) -> None:
        """Queue one work item — a shard path, or a :class:`ShardSpan`
        sub-shard range — for a reader to claim; ``tag`` rides the item's
        ``ShardDone`` token back to the consumer."""
        self._work.put((path, tag))

    def inject(self, payload, tag=None, source=None) -> bool:
        """Producer-side: hand an ALREADY-DECODED chunk (a record list or a
        ``dfutil.ColumnChunk``) straight to the consumer, bypassing the
        readers — how the trainer-side feed consumes chunks a data-service
        worker decoded remotely (``data.DecodedChunk``).  FIFO with the
        work-item bookkeeping: the chunk's ``ShardDone`` follows it
        immediately, so the partition watermark machinery sees each
        forwarded chunk as one fully-drained "shard".  Returns False when
        the pipeline was stopped with the consumer gone."""
        if not self._put(payload):
            return False
        ok = self._put(ShardDone(source if source is not None
                                 else "<forwarded>", tag))
        if ok:
            telemetry.counter("ingest.chunks_injected").inc()
            telemetry.counter("ingest.records_injected").inc(len(payload))
        return ok

    def close(self) -> None:
        """No more shards will be submitted; readers exit as the work queue
        drains, and the consumer sees end-of-pipeline after the last chunk."""
        with self._lock:
            self._closed = True
            # sync mode signals drain via (closed AND work empty) inside
            # _sync_get — pushing the sentinel here would let it overtake
            # still-queued work items
            push = (not self._sync and self._active == 0
                    and not self._drained_pushed)
            if push:
                self._drained_pushed = True
        if push:
            # outside the lock: the put may block on a full prefetch queue,
            # and the consumer needs the lock to drain it (autotune path)
            self._put(_DRAINED)

    def stop(self) -> None:
        """Abandon everything in flight (terminate/stop-signal path)."""
        self._stop.set()

    # -- consumer side -------------------------------------------------------

    def depth(self) -> int:
        """Decoded chunks queued ahead of the consumer (0 in sync mode)."""
        return self._out.qsize()

    def get(self, timeout: float = 0.25):
        """Pop the next item: a list of records (one decoded chunk), a
        :class:`ShardDone` token, or ``None`` once the pipeline has fully
        drained.  Raises ``queue.Empty`` on timeout and
        :class:`ShardReadError` when a reader failed."""
        if self._sync:
            return self._sync_get(timeout)
        self._maybe_tune()
        item = self._out.get(timeout=timeout)
        if item is _DRAINED:
            return None
        if isinstance(item, _Failure):
            raise item.error
        return item

    def _sync_get(self, timeout: float):
        """readers=0: serve buffered chunks, else read the next shard
        INLINE in the calling (consumer) thread."""
        try:
            item = self._out.get_nowait()
        except queue.Empty:  # toslint: allow-silent(no buffered chunk yet: fall through to claim the next shard)
            pass
        else:
            if item is _DRAINED:
                return None
            return item
        if self._stop.is_set():
            return None
        with self._lock:
            closed = self._closed
        if closed:
            # close() precedes no further submits: an empty work queue IS
            # the drain — answer now instead of blocking a full timeout
            # only to discover it (the stall used to add one poll_interval
            # to EVERY sync-mode feed's tail)
            try:
                path, tag = self._work.get_nowait()
            except queue.Empty:
                # observing closed proves every inject() already landed
                # (the claimer injects before calling close, and both
                # sides synchronize on self._lock) — so ONE out-queue
                # re-check closes the race where a chunk was injected
                # between the get_nowait at the top and the closed read
                # above; without it that chunk would be stranded and the
                # feed would report drained with records undelivered
                try:
                    item = self._out.get_nowait()
                except queue.Empty:
                    return None
                return None if item is _DRAINED else item
        else:
            try:
                path, tag = self._work.get(timeout=timeout)
            except queue.Empty:
                with self._lock:
                    closed = self._closed
                if closed:
                    # closed while we were blocked on the (empty) work
                    # queue — but chunks may have been inject()ed into the
                    # out queue during that wait (the pure-consumer feed's
                    # claimer): re-enter from the top, which drains them
                    # before the work-empty check can answer drained
                    return self._sync_get(timeout)
                raise
        try:
            with telemetry.timed("ingest.shard_read_secs"):
                self._read_one(path, tag)
        except Exception as e:  # noqa: BLE001 - same contract as the pool
            wrapped = ShardReadError(f"reading shard {path!r} failed: {e}")
            wrapped.__cause__ = e
            telemetry.counter("ingest.reader_errors").inc()
            raise wrapped from e
        return self._sync_get(timeout)

    def _maybe_tune(self) -> None:
        """Occupancy-EMA autotune, driven by consumer pops (no timer
        thread): grow while the consumer starves, shrink while readers
        saturate the queue.  Sampling at pop time biases toward the moments
        that matter — when the consumer actually wants data."""
        occupancy = self._out.qsize()
        telemetry.gauge("ingest.prefetch_depth").set(occupancy)
        if not self._autotune:
            return
        self._occupancy_ema += _EMA_ALPHA * (occupancy / self._out.maxsize
                                             - self._occupancy_ema)
        now = time.monotonic()
        if now - self._last_tune < _TUNE_INTERVAL_SECS:
            return
        self._last_tune = now
        telemetry.gauge("ingest.queue_occupancy").set(
            round(self._occupancy_ema, 4))
        if (self._occupancy_ema < _TUNE_LOW and not self._work.empty()):
            # closed does NOT gate growth: it only means no more submits,
            # and the work queue may still be deep
            with self._lock:
                if self._target < self._max_readers and self._active > 0:
                    self._target += 1
                    self._spawn_reader_locked()
                    telemetry.counter("ingest.reader_spawns").inc()
        elif self._occupancy_ema > _TUNE_HIGH:
            with self._lock:
                if self._target > 1:
                    self._target -= 1  # a reader retires at its next boundary

    # -- reader pool ---------------------------------------------------------

    def _spawn_reader_locked(self) -> None:
        """Start one reader; caller holds ``self._lock`` (or is __init__,
        pre-publication)."""
        self._active += 1
        telemetry.gauge("ingest.readers_active").set(self._active)
        threading.Thread(target=self._reader_loop, daemon=True,
                         name=f"ingest-reader-{self._active}").start()

    def _reader_loop(self) -> None:
        retired = False
        try:
            while not self._stop.is_set():
                with self._lock:
                    if self._active > self._target:
                        # autotune shrink: exactly one reader retires per
                        # decrement, accounted here so the exit path below
                        # never double-counts (target >= 1, so a retiree is
                        # never the last reader)
                        self._active -= 1
                        retired = True
                        telemetry.counter("ingest.reader_retires").inc()
                        telemetry.gauge("ingest.readers_active").set(self._active)
                        return
                try:
                    path, tag = self._work.get(timeout=0.1)
                except queue.Empty:
                    with self._lock:
                        if self._closed:
                            return
                    continue
                try:
                    with telemetry.timed("ingest.shard_read_secs"):
                        self._read_one(path, tag)
                except Exception as e:  # noqa: BLE001 - re-raised consumer-side
                    wrapped = ShardReadError(f"reading shard {path!r} failed: {e}")
                    wrapped.__cause__ = e
                    telemetry.counter("ingest.reader_errors").inc()
                    self._put(_Failure(wrapped))
                    return
        finally:
            if not retired:
                push = False
                with self._lock:
                    self._active -= 1
                    telemetry.gauge("ingest.readers_active").set(self._active)
                    if (self._active == 0
                            and (self._closed or self._stop.is_set())
                            and not self._drained_pushed):
                        self._drained_pushed = True
                        push = True
                if push:
                    # outside the lock (the put can block on a full queue
                    # whose consumer needs the lock); _put gives up only
                    # when stop is set AND the consumer stopped draining,
                    # at which point nobody would read the sentinel anyway
                    self._put(_DRAINED)

    def _read_one(self, item, tag) -> None:
        """Read + verify one work item (whole shard, or a ``ShardSpan``
        sub-shard range), pushing decoded chunks then the item's
        ``ShardDone``.  Plain shards take the span path — ONE open, one
        native CRC scan, then zero-copy ``memoryview`` record slices (or
        bytes copies with ``TOS_INGEST_ZEROCOPY=0``); with ``schema`` set,
        chunks of spans decode columnar (``dfutil.decode_span_columns``)
        into contiguous column buffers instead.  Gzip shards stream (probe
        open + gzip.open) and always deliver bytes."""
        # Cross-epoch chunk cache: a repeated read of the same work item
        # (same bytes, same schema) serves the MATERIALIZED chunks straight
        # from memory — no IO, no CRC scan, no decode.  Misses tee their
        # decoded chunks into the cache on the way out (materialized copies:
        # a cached record must own its buffer, never view a shard mmap that
        # retires with this read).
        tee: dict | None = None
        cache_key = None
        if self._cache is not None:
            cache_key = self._cache.key_for(item, self.schema,
                                            self.binary_features)
            hit = self._cache.get(cache_key)
            if hit is not None:
                nrecs = 0
                for chunk in hit:
                    nrecs += len(chunk)
                    if not self._put(chunk):
                        return  # stopped with the consumer gone
                self._put(ShardDone(item, tag))
                telemetry.counter("ingest.shards_read").inc()
                telemetry.counter("ingest.records_read").inc(nrecs)
                return
            # Tee this read into the cache — UNLESS the item is knowably
            # inadmissible up front (a span bigger than the whole budget):
            # materializing copies that put() would only throw away doubles
            # peak reader memory for zero benefit.  Whole-shard items of
            # unknown decoded size start a tee and abandon it the moment
            # the running byte count crosses the budget (_emit).
            budget = self._cache.max_bytes
            known = (item.end - item.start if isinstance(item, ShardSpan)
                     else None)
            if known is None or known <= budget:
                tee = {"chunks": [], "bytes": 0, "budget": budget}
        # Zero-copy record mode maps the shard instead of read()ing it:
        # the CRC scan and the record views walk page-cache pages
        # directly, saving a full DRAM copy pass per shard — the pass
        # that caps aggregate multi-node ingest of one large shard.
        # Columnar and bytes-copy modes keep the bytes read (their
        # decoders materialize/copy anyway).
        use_map = self.schema is None and self.zerocopy != "off"
        if isinstance(item, ShardSpan):
            local = resolve_uri(item.path)
            gz = False
            if use_map:
                buf, spans = tfrecord.map_span_range(local, item.start,
                                                     item.end, self.verify)
            else:
                buf, spans = tfrecord.read_span_range(local, item.start,
                                                      item.end, self.verify)
        else:
            local = resolve_uri(item)
            buf = None  # stays None for gzip shards (they stream)
            if use_map:
                # ONE open: gzip probe off the mapped head + CRC scan
                buf, spans = tfrecord.map_record_spans(local, self.verify)
                gz = buf is None
            else:
                with open(local, "rb") as f:
                    gz = tfrecord._is_gzip_shard(f.read(12))
                    if not gz:
                        f.seek(0)
                        buf = f.read()  # one read, no probe+rest concat copy
                if not gz:
                    spans = tfrecord.scan_record_spans(buf, self.verify,
                                                       name=local)
        if self.schema is not None:
            nrecs, nbytes = self._read_columnar(local, buf,
                                                None if gz else spans, gz,
                                                tee)
            if nrecs is None:
                return  # stopped with the consumer gone
        elif not gz:
            # span fast path: with no decode callable, chunks are plain
            # list windows — no per-record append/accounting loop on the
            # hot path.  Views materialize eagerly (pure slice objects,
            # ~100 ns each, no payload bytes); the BYTES-copy mode slices
            # per window INSIDE the push loop so the bounded prefetch
            # queue keeps pacing the memcpy cost — an eager full-shard
            # copy list would double peak memory per reader.
            zc = self.zerocopy != "off"
            decode = self.decode
            nrecs = len(spans)
            nbytes = sum(length for _, length in spans)
            cr = self.chunk_records
            if decode is None:
                records = tfrecord.record_views(buf, spans) if zc else None
                for i in range(0, nrecs, cr):
                    chunk = (records[i:i + cr] if zc else
                             [buf[off:off + length]
                              for off, length in spans[i:i + cr]])
                    if not self._emit(chunk, tee):
                        return  # stopped with the consumer gone
            else:
                # decode INTERLEAVED with chunk pushes: per-record decode
                # cost paces the queue, so the autotuner's pop-time
                # occupancy sampling sees the decode rate, not one
                # end-of-shard burst.  Decode callables keep their
                # PRE-EXISTING bytes contract (bytes() of a bytes slice is
                # the same object; of an mmap view, the one per-record
                # copy — noise next to per-record Python decode): handing
                # views to decoders written against bytes would crash
                # every one of them for no measurable win.
                chunk: list = []
                for off, length in spans:
                    chunk.append(decode(bytes(buf[off:off + length])))
                    if len(chunk) >= cr:
                        if not self._put(chunk):
                            return
                        chunk = []
                if chunk and not self._put(chunk):
                    return
        else:
            payloads = tfrecord.read_records(local, verify=self.verify,
                                             gzipped=True)
            decode = self.decode
            nbytes = 0
            nrecs = 0
            chunk: list = []
            for payload in payloads:
                nbytes += len(payload)
                nrecs += 1
                chunk.append(decode(payload) if decode is not None else payload)
                if len(chunk) >= self.chunk_records:
                    if not self._emit(chunk, tee):
                        return  # stopped with the consumer gone
                    chunk = []
            if chunk and not self._emit(chunk, tee):
                return
        self._put(ShardDone(item, tag))
        telemetry.counter("ingest.shards_read").inc()
        telemetry.counter("ingest.records_read").inc(nrecs)
        telemetry.counter("ingest.bytes_read").inc(nbytes)
        if tee is not None and tee["chunks"] is not None:
            # the whole item decoded cleanly AND stayed under budget: its
            # materialized chunks are now a cache entry (put re-enforces
            # the byte bound + LRU eviction)
            self._cache.put(cache_key, tee["chunks"], nbytes=tee["bytes"])

    def _emit(self, chunk, tee: dict | None) -> bool:
        """Push one decoded chunk; with the cache teeing this read, append
        a MATERIALIZED copy (owned buffers — zero-copy views die with the
        shard buffer, a cache entry must not).  A tee whose running byte
        count crosses the cache budget is abandoned mid-item — the copies
        are freed immediately instead of riding to an inevitable oversize
        rejection at put()."""
        if tee is not None and tee["chunks"] is not None:
            from tensorflowonspark_torch.data import chunk_nbytes

            tee["bytes"] += chunk_nbytes(chunk)
            if tee["bytes"] > tee["budget"]:
                tee["chunks"] = None  # inadmissible: stop copying, free now
                telemetry.counter("ingest.cache_oversize_skips").inc()
            else:
                tee["chunks"].append(_materialize_chunk(chunk))
        return self._put(chunk)

    def _read_columnar(self, local: str, buf, spans, gz: bool,
                       tee: list | None = None):
        """Columnar (schema) decode of one work item: every
        ``chunk_records`` spans become ONE ``dfutil.ColumnChunk`` — the
        native parser turns a span window into K contiguous column buffers
        without a per-record Python hop; gzip shards accumulate streamed
        records into the same chunk shape.  Returns ``(nrecs, nbytes)``,
        or ``(None, None)`` when the pipeline stopped mid-item."""
        from tensorflowonspark_torch import dfutil

        cr = self.chunk_records
        nrecs = 0
        nbytes = 0
        if not gz:
            for i in range(0, len(spans), cr):
                window = spans[i:i + cr]
                cols, counts = dfutil.decode_span_columns(
                    buf, window, self.schema, self.binary_features)
                if not self._emit(dfutil.ColumnChunk.from_schema(
                        cols, counts, self.schema), tee):
                    return None, None
                nrecs += len(window)
                nbytes += sum(length for _, length in window)
            return nrecs, nbytes
        batch: list = []
        for payload in tfrecord.read_records(local, verify=self.verify,
                                             gzipped=True):
            batch.append(payload)
            nbytes += len(payload)
            if len(batch) >= cr:
                cols, counts = dfutil.records_to_columns(
                    batch, self.schema, self.binary_features)
                if not self._emit(dfutil.ColumnChunk.from_schema(
                        cols, counts, self.schema), tee):
                    return None, None
                nrecs += len(batch)
                batch = []
        if batch:
            cols, counts = dfutil.records_to_columns(
                batch, self.schema, self.binary_features)
            if not self._emit(dfutil.ColumnChunk.from_schema(
                    cols, counts, self.schema), tee):
                return None, None
            nrecs += len(batch)
        return nrecs, nbytes

    def _put(self, item) -> bool:
        """Bounded put that stays responsive to stop(): blocking on the full
        prefetch queue IS the backpressure, but an abandoned pipeline (stop
        set, consumer gone) must not strand the reader thread forever."""
        while True:
            try:
                self._out.put(item, timeout=0.1)
                return True
            except queue.Full:
                if self._stop.is_set():
                    return False


def prefetch_iterator(iterable, depth: int = 2):
    """Host-side prefetch: a background thread runs the source iterator up
    to ``depth`` items ahead of the consumer (the tf.data ``prefetch``
    stage).  Source exceptions re-raise at the consumer, at the position
    they would have surfaced unprefetched."""
    if depth <= 0:
        yield from iterable
        return
    buf: queue.Queue = queue.Queue(maxsize=depth)
    DONE = object()
    stopped = threading.Event()
    failure: list[BaseException] = []

    def _bounded_put(item) -> bool:
        while not stopped.is_set():
            try:
                buf.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce() -> None:
        try:
            for item in iterable:
                if not _bounded_put(item):
                    return  # consumer abandoned the generator
        except BaseException as e:  # noqa: BLE001 - re-raised consumer-side
            failure.append(e)
        finally:
            _bounded_put(DONE)

    thread = threading.Thread(target=_produce, name="ingest-prefetch",
                              daemon=True)
    thread.start()
    try:
        while True:
            item = buf.get()
            if item is DONE:
                if failure:
                    raise failure[0]
                return
            yield item
    finally:
        stopped.set()  # an abandoning consumer must not strand the producer


def device_prefetch(batches, depth: int = 2, device=None, stream=None):
    """Prefetch-to-device double buffering: copy batch N+1 to the device
    while the consumer computes on batch N (the host->device half of the
    tf.data-paper pipeline; ``parallel.dp.make_batch_iterator`` applies the
    same idea to streaming feeds).

    A batch is an ndarray or a dict / tuple / list of them (a columnar
    batch's ``(values, counts)`` pairs included); it comes out as the same
    structure of torch tensors on ``device`` (default ``cuda``; without a
    card this raises unless the caller passes ``device="cpu"``).

    Each batch is copied out of its source before the next one is pulled:
    an ``IngestFeed`` batch's record views are valid only until the next
    ``next_batch``, and a prefetcher ``depth`` batches ahead advances the
    feed while earlier batches are still in use.  On the card the copy is
    synchronous into a ring of ``depth + 1`` pinned host buffers; the H2D
    copy from a pinned buffer is ``non_blocking`` on a side stream
    (``stream``, default a new one), a CUDA event recorded after it guards
    the buffer's reuse, and the consumer's current stream waits on that
    event before it is handed the tensors."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device_prefetch: no CUDA device is available; pass device='cpu' "
            "to prefetch into host tensors")
    if dev.type != "cuda":
        def _copied():
            for batch in batches:
                out = _map_leaves(batch, lambda k, a: torch.tensor(
                    _host_array(k, a), device=dev))
                del batch  # drop the source's views before pulling the next
                yield out

        yield from prefetch_iterator(_copied(), depth)
        return

    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    side = stream if stream is not None else torch.cuda.Stream(device=dev)
    ring = [_PinnedSlot() for _ in range(max(1, depth) + 1)]

    def _placed():
        with torch.cuda.device(dev):
            for n, batch in enumerate(batches):
                slot = ring[n % len(ring)]
                slot.reuse()
                host = _map_leaves(batch, slot.copy_in)
                del batch  # drop the source's views before pulling the next
                with torch.cuda.stream(side):
                    placed = _map_leaves(
                        host, lambda _, t: t.to(dev, non_blocking=True))
                    slot.event = torch.cuda.Event()
                    slot.event.record(side)
                yield placed, slot.event

    for placed, event in prefetch_iterator(_placed(), depth):
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(event)
        _map_leaves(placed, lambda _, t: t.record_stream(consumer))
        yield placed


class _PinnedSlot:
    """One pinned host buffer per leaf of a batch, reused across batches,
    and the event that marks the last H2D copy out of them as done."""

    def __init__(self):
        self.buffers: dict = {}
        self.event = None

    def reuse(self) -> None:
        if self.event is not None:
            self.event.synchronize()  # the copy out of these buffers is done
            self.event = None

    def copy_in(self, key, leaf):
        import numpy as np
        import torch

        arr = _host_array(key, leaf)
        nbytes = arr.nbytes
        buf = self.buffers.get(key)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                              pin_memory=True)
            self.buffers[key] = buf
        dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
        host = buf[:nbytes].view(dtype).view(arr.shape)
        np.copyto(host.numpy(), arr)
        return host


def _map_leaves(tree, fn, key=()):
    """``fn(path, leaf)`` over a batch's leaves, keeping its dict / tuple /
    list structure."""
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, key + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(v, fn, key + (i,))
                          for i, v in enumerate(tree))
    return fn(key, tree)


def _host_array(key, leaf):
    """A batch leaf as an ndarray of numbers or booleans (a CPU tensor is
    read through ``numpy()``)."""
    import numpy as np

    arr = np.asarray(leaf)
    if arr.dtype.kind not in "biufc":
        raise TypeError(
            f"device_prefetch: leaf {'/'.join(map(str, key)) or '<batch>'} "
            f"has dtype {arr.dtype}; only numeric and boolean arrays go to "
            "a device (convert bytes columns to an ndarray first)")
    return arr
