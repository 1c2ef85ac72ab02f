"""``IngestFeed`` — the DIRECT-mode twin of ``feeding.DataFeed``.

In ``InputMode.DIRECT`` the driver's partition ledger streams shard *paths*
(tens of bytes each) instead of rows; this feed sits between the node's
``FeedQueues`` and the user ``map_fun``, turning those paths into decoded
record batches through the :class:`~tensorflowonspark_torch.ingest.readers.
ReaderPipeline` (parallel interleave + decode + prefetch):

    input queue          claimer thread        reader pipeline     map_fun
    paths + markers  ->  claims shards,    ->  N readers, CRC, ->  next_batch
    (from the ledger)    tracks partitions     decode, prefetch

Same consumption contract as ``DataFeed`` — and that contract is what makes
the whole elastic machinery carry over to direct reads unchanged:

- the node's **consumption watermark** (``FeedQueues.note_partition_consumed``)
  advances only after every record of a ledger partition has been *returned
  to the map_fun* — never merely read — so a death re-delivers any
  partition whose records might not have been processed (duplicates
  allowed, loss never);
- keyed ``EndPartition`` markers dedupe an at-least-once re-feed of the
  same partition (its shards are re-READ — duplicates at record level are
  the at-least-once contract — but the watermark counts it once);
- ``EndOfFeed`` / the node stop signal end the feed; ``terminate()``
  fast-drains pending paths so driver feed calls unblock.

The watermark bookkeeping rides the pipeline's ``ShardDone`` tokens: the
chunk queue is FIFO, so popping a shard's token proves all its records left
the queue; a partition reports consumed once every one of its shards' tokens
has popped AND the batch carrying its last records has been handed back.
"""

from __future__ import annotations

import queue
import threading
from tensorflowonspark_torch.utils.locks import tos_named_lock
from typing import Any, Iterable

from time import monotonic as _monotonic
from time import sleep as _sleep

from tensorflowonspark_torch import faultinject, telemetry
from tensorflowonspark_torch.data import DecodedChunk
from tensorflowonspark_torch.feeding import FeedQueues, batch_to_columns
from tensorflowonspark_torch.ingest.readers import ReaderPipeline, ShardDone
from tensorflowonspark_torch.ingest.shards import ShardSpan
from tensorflowonspark_torch.marker import EndOfFeed, EndPartition, Marker, ResultChunk
from tensorflowonspark_torch.telemetry import trace as ttrace


class _PartitionJob:
    """Watermark bookkeeping for one ledger partition of shard paths."""

    __slots__ = ("key", "n_shards", "n_done", "closed", "trace", "t0")

    def __init__(self):
        self.key = None
        self.n_shards = 0
        self.n_done = 0
        self.closed = False
        # sampled driver partition's trace ctx (rides the EndPartition) +
        # first-claim time: the ingest partition-consume span's anchors
        self.trace = None
        self.t0 = _monotonic()


class IngestFeed:
    """User-facing DIRECT-mode feed: ``next_batch``/``should_stop``/
    ``batch_results``/``terminate``, drop-in for ``DataFeed`` inside a
    map_fun.

    Deltas from ``DataFeed`` (all deliberate): batches are record payloads
    (zero-copy ``memoryview`` slices of the shard buffer by default — see
    the decode contract below — or whatever ``decode`` returns), and SHARD
    seams inside a ledger partition never truncate batches — shards
    interleave freely.  A completed *ledger partition* does close the
    running batch (partial, like DataFeed's EndPartition): the records
    must reach the map_fun before the partition may be reported consumed,
    and holding them while blocking for more data would freeze the
    watermark the driver's elastic tail drain polls.

    **Zero-copy decode contract** (``TOS_INGEST_ZEROCOPY``, default on):
    records from plain shards are ``memoryview`` slices — no copy between
    the disk read and the map_fun.  A view is *valid until its batch is
    released*: a batch retires when the map_fun comes back for the next
    one, so the batch in hand is always safe — finish with it before
    calling ``next_batch`` again.  Retaining views longer pins whole
    shard buffers in memory — copy (``bytes(view)``) anything you keep.
    ``TOS_INGEST_ZEROCOPY=0`` restores plain ``bytes`` records;
    ``=debug`` keeps zero-copy but *releases* each batch's views on
    retirement, so a retained view raises ``ValueError`` at first touch
    instead of silently leaking.  Gzip shards always deliver ``bytes``.

    **Columnar mode** (``schema=``, a ``dfutil.Schema``): batches are
    ``{column: values}`` dicts sliced zero-copy out of the readers'
    ``dfutil.ColumnChunk``s — fixed-width numeric columns as ``[n]`` /
    ``[n, k]`` ndarray views, ragged columns as ``(values, counts)``
    pairs.  Batches never span chunks (a batch may come back short at a
    chunk boundary — same "up to batch_size" contract as everywhere
    else); ``input_mapping`` renames columns instead of reshaping rows.
    """

    def __init__(
        self,
        queues: FeedQueues,
        train_mode: bool = True,
        qname_in: str = "input",
        qname_out: str = "output",
        input_mapping: dict[str, str] | None = None,
        stop_event: threading.Event | None = None,
        poll_interval: float = 0.25,
        readers: int | None = None,
        decode=None,
        chunk_records: int = 256,
        verify: bool = True,
        prefetch: int | None = None,
        autotune: bool | None = None,
        zerocopy=None,
        schema=None,
        binary_features=None,
        cache=None,
    ):
        self.queues = queues
        self.train_mode = train_mode
        self.qname_in = qname_in
        self.qname_out = qname_out
        self.input_mapping = input_mapping
        self.stop_event = stop_event
        self.poll_interval = poll_interval
        self.done_feeding = False
        self._drained = False
        self._leftover: list = []
        self._claim_error: BaseException | None = None
        self._terminated = threading.Event()
        # the pipeline's own stop flag: terminate()/stop abandon in-flight
        # reads without touching the node-wide stop_event
        self._abandon = threading.Event()
        self.pipeline = ReaderPipeline(
            readers=readers, autotune=autotune, prefetch=prefetch,
            chunk_records=chunk_records, decode=decode, verify=verify,
            stop_event=self._abandon, zerocopy=zerocopy, schema=schema,
            binary_features=binary_features, cache=cache)
        # debug zero-copy: views handed out in the LAST returned batch;
        # released (-> late access raises ValueError) when that batch
        # retires at the next next_batch call
        self._debug_release = self.pipeline.zerocopy == "debug"
        self._prev_views: list = []
        # columnar mode: the partially-served ColumnChunk + its row offset
        self._colchunk = None
        self._coloff = 0
        # rolling feed-queue occupancy (the autoscaling signal
        # cluster.stats() serves per node, same gauge as DataFeed): in
        # DIRECT mode the reader pipeline's prefetch queue IS the feed queue
        self._occupancy = telemetry.gauge("feed.queue_depth")
        # partitions fully read AND fully handed to the map_fun, awaiting
        # the safe moment to report (see _report_ready_keys)
        self._jobs_lock = tos_named_lock("feed._jobs_lock")
        self._ready_keys: list = []
        self._claimer = threading.Thread(target=self._claim_loop, daemon=True,
                                         name="ingest-claimer")
        self._claimer.start()

    # -- claimer thread: input queue -> reader work items --------------------

    def _claim_loop(self) -> None:
        q = self.queues.get_queue(self.qname_in)
        open_job: _PartitionJob | None = None
        try:
            while not self._terminated.is_set():
                if self.stop_event is not None and self.stop_event.is_set():
                    # node-wide stop: abandon in-flight reads too — the
                    # readers must not keep churning through queued shards
                    # for a consumer that is winding down
                    self._abandon.set()
                    return
                try:
                    item = q.get(timeout=self.poll_interval)
                except queue.Empty:
                    continue
                if isinstance(item, EndPartition):
                    job = open_job if open_job is not None else _PartitionJob()
                    open_job = None
                    with self._jobs_lock:
                        job.key = getattr(item, "key", None)
                        job.trace = getattr(item, "trace", None)
                        job.closed = True
                        if job.n_done >= job.n_shards:
                            # every shard already drained through the
                            # consumer (or the partition was empty): ready —
                            # the consumer reports it at its next safe point
                            self._ready_keys.append(job)
                    continue
                if isinstance(item, EndOfFeed):
                    return
                if isinstance(item, Marker):
                    continue
                if isinstance(item, DecodedChunk):
                    # Disaggregated ingest tier: a data-service worker
                    # already decoded this chunk — inject it straight into
                    # the pipeline's decoded-chunk queue (this feed is a
                    # pure consumer).  Each forwarded chunk counts as one
                    # "shard" of its ledger partition, so the watermark
                    # machinery below is byte-for-byte the node-local one.
                    if open_job is None:
                        open_job = _PartitionJob()
                    with self._jobs_lock:
                        open_job.n_shards += 1
                    self.pipeline.inject(item.payload, open_job,
                                         source=item.source)
                    continue
                if not isinstance(item, (str, ShardSpan)):
                    raise TypeError(
                        f"DIRECT-mode feed expects shard PATHS (or ShardSpan "
                        f"sub-shard items) on queue "
                        f"{self.qname_in!r}, got {type(item).__name__}: "
                        "feed this cluster with cluster.train(<path_or_glob>) "
                        "(InputMode.STREAMING is the mode that streams rows)")
                if open_job is None:
                    open_job = _PartitionJob()
                with self._jobs_lock:
                    open_job.n_shards += 1
                self.pipeline.submit(item, open_job)
        except BaseException as e:  # noqa: BLE001 - re-raised in next_batch
            self._claim_error = e
        finally:
            self.pipeline.close()

    # -- consumer side (the map_fun) -----------------------------------------

    def _has_ready_keys(self) -> bool:
        with self._jobs_lock:
            return bool(self._ready_keys)

    def _report_ready_keys(self) -> None:
        """Report partitions whose records have all been handed back.  Only
        called when the consumer holds NO undelivered records (top of
        next_batch, or mid-poll with an empty batch in hand) — the watermark
        must lag the map_fun, never lead it."""
        with self._jobs_lock:
            if not self._ready_keys:
                return
            jobs, self._ready_keys = self._ready_keys, []
        for job in jobs:
            self._report_job(job)

    def _report_job(self, job: _PartitionJob) -> None:
        self.queues.note_partition_consumed(self.qname_in, job.key)
        if job.trace is not None:
            # ingest partition-consume span: first shard claimed -> every
            # record handed to the map_fun (under the driver's sampled
            # train.partition span — the DIRECT-mode end of the trace)
            now = _monotonic()
            ttrace.record_child("feed.partition_consume", job.trace,
                                job.t0, now - job.t0,
                                {"shards": job.n_shards})

    def _on_shard_done(self, token: ShardDone, batch_empty: bool) -> None:
        job = token.tag
        if job is None:
            return
        report = False
        with self._jobs_lock:
            job.n_done += 1
            if job.closed and job.n_done >= job.n_shards:
                if batch_empty:
                    # FIFO: every record of this partition was popped before
                    # its last ShardDone, and with nothing in hand they were
                    # all in batches ALREADY returned — safe to report now
                    # (must not wait for a next_batch call that may never
                    # come: the elastic tail drain polls this watermark)
                    report = True
                else:
                    self._ready_keys.append(job)
        if report:
            self._report_job(job)

    def next_batch(self, batch_size: int) -> list | dict:
        """Pop up to ``batch_size`` decoded records; the batch goes partial
        at end-of-feed / stop / a completed ledger partition (shard seams
        inside a partition never truncate it) / a columnar chunk boundary.
        Calling this RELEASES the previous batch (see the zero-copy decode
        contract in the class docstring)."""
        # Self-fence: parked = coordinator unreachable past
        # TOS_COORDINATOR_GRACE_SECS — stop taking new ledger work until
        # the heartbeat loop re-admits us or gives up (same contract as
        # the streaming DataFeed; checked once per batch).
        while self.queues.get("state") == "parked":
            if self.stop_event is not None and self.stop_event.is_set():
                break
            _sleep(self.poll_interval)
        if self._prev_views:
            # debug zero-copy: the previous batch retires NOW — releasing
            # its views makes any retained one fail loudly at first touch
            for v in self._prev_views:
                v.release()
            self._prev_views = []
        self._report_ready_keys()  # the previous batch has been handed over
        batch: list = []
        while len(batch) < batch_size:
            if self._colchunk is not None:
                return self._columnar_batch(batch_size)
            if self._leftover:
                take = batch_size - len(batch)
                if not batch and take >= len(self._leftover):
                    # whole chunk fits an empty batch: adopt the list
                    # instead of copying it element-wise (the hot shape —
                    # batch_size >= chunk_records)
                    batch = self._leftover
                    self._leftover = []
                    continue
                batch.extend(self._leftover[:take])
                del self._leftover[:take]
                continue
            if self._claim_error is not None:
                # checked BEFORE the drained branch: a dying claimer closes
                # the pipeline, so the drain sentinel races this error into
                # the same poll window — ending the feed "cleanly" here
                # would swallow the failure and strand the driver's feed
                raise RuntimeError(
                    f"ingest claim loop failed: {self._claim_error}"
                ) from self._claim_error
            if self._drained:
                if batch:
                    # hand the final records back WITHOUT flagging done: the
                    # map_fun's next call (the proof this batch was
                    # processed) flushes the last partition's consumption
                    # report, then sees done — mirroring DataFeed, where
                    # EndOfFeed always pops on a later call than the batch
                    # that closed the final partition
                    break
                self.done_feeding = True
                break
            if not batch:
                # nothing undelivered in hand: partitions the claimer closed
                # while we were blocked here are safe to report immediately
                self._report_ready_keys()
            elif self._has_ready_keys():
                # a LEDGER partition finished behind the records in hand:
                # close the batch now (DataFeed's partition-end partial
                # batch, at ledger granularity) — blocking here to top the
                # batch up could hold these records indefinitely between
                # feeds, freezing the consumption watermark the driver's
                # elastic tail drain waits on
                break
            if self.stop_event is not None and self.stop_event.is_set():
                self.pipeline.stop()
                self.done_feeding = True
                break
            try:
                item = self.pipeline.get(timeout=self.poll_interval)
            except queue.Empty:
                # same starvation counter as the streaming DataFeed: an
                # empty poll with the consumer hungry (decode behind)
                telemetry.counter("feed.starved_polls").inc()
                continue
            if item is None:  # pipeline fully drained (EndOfFeed reached)
                self._drained = True
                continue
            if isinstance(item, ShardDone):
                self._on_shard_done(item, batch_empty=not batch)
                continue
            if hasattr(item, "slice") and hasattr(item, "counts"):
                # a dfutil.ColumnChunk (schema mode): served by slicing at
                # the loop top — record chunks never mix with these (the
                # schema drives EVERY shard through the columnar decoder)
                self._colchunk, self._coloff = item, 0
                continue
            self._leftover = item  # one decoded chunk (a list)
        if batch:
            self._occupancy.set(self.pipeline.depth())
            telemetry.counter("feed.batches").inc()
            telemetry.counter("feed.rows_consumed").inc(len(batch))
            # same chaos clock as DataFeed: `kill:after_batches=N` fires on
            # consumed batches, so kill-mid-shard tests run in DIRECT mode
            faultinject.batch_consumed()
            if self._debug_release:
                self._prev_views = [r for r in batch
                                    if type(r) is memoryview]
        if self.input_mapping:
            return batch_to_columns(batch, self.input_mapping)
        return batch

    def _columnar_batch(self, batch_size: int) -> dict:
        """Serve up to ``batch_size`` records off the current ColumnChunk
        as zero-copy column views; batches never span chunks (numpy views
        cannot cross two buffers without a copy — a short batch at a chunk
        boundary is the documented trade)."""
        chunk, off = self._colchunk, self._coloff
        take = min(batch_size, len(chunk) - off)
        out = chunk.slice(off, off + take)
        off += take
        if off >= len(chunk):
            self._colchunk, self._coloff = None, 0
        else:
            self._coloff = off
        self._occupancy.set(self.pipeline.depth())
        telemetry.counter("feed.batches").inc()
        telemetry.counter("feed.rows_consumed").inc(take)
        faultinject.batch_consumed()
        if self.input_mapping:
            # same {column -> tensor name} contract as batch_to_columns,
            # minus the per-row reshaping the columns never needed
            return {tname: out[cname]
                    for cname, tname in self.input_mapping.items()}
        return out

    def next_chunk(self):
        """Pop the next WHOLE decoded chunk (a record list, or a
        ``dfutil.ColumnChunk`` in schema mode), or ``None`` at end of feed.

        The data-service worker's consumption surface (``ingest/service.py``):
        a forwarder wants pipeline-sized units to ship, not re-batched
        records.  Same watermark contract as ``next_batch`` — calling again
        is the proof the previous chunk was fully handed over (for the
        service: forwarded AND acked by a trainer), so the partition-
        consumed report the driver's ledger drains on only ever lags the
        actual delivery.  Mixing ``next_chunk`` and ``next_batch`` on one
        feed is not supported (the batch carry-over state is not shared)."""
        while self.queues.get("state") == "parked":
            if self.stop_event is not None and self.stop_event.is_set():
                break
            _sleep(self.poll_interval)
        self._report_ready_keys()  # the previous chunk has been handed over
        while True:
            if self._claim_error is not None:
                raise RuntimeError(
                    f"ingest claim loop failed: {self._claim_error}"
                ) from self._claim_error
            if self._drained:
                self.done_feeding = True
                return None
            if self.stop_event is not None and self.stop_event.is_set():
                self.pipeline.stop()
                self.done_feeding = True
                return None
            self._report_ready_keys()
            try:
                item = self.pipeline.get(timeout=self.poll_interval)
            except queue.Empty:
                telemetry.counter("feed.starved_polls").inc()
                continue
            if item is None:
                self._drained = True
                continue
            if isinstance(item, ShardDone):
                # nothing undelivered in hand by construction (whole chunks
                # only): a closed partition is safe to report immediately
                self._on_shard_done(item, batch_empty=True)
                continue
            self._occupancy.set(self.pipeline.depth())
            # service-side counters, DISTINCT from the trainer feed's
            # feed.rows_consumed: the worker claims these rows and the
            # trainer consumes the very same ones — double-counting one
            # name would double the run report's cluster aggregate
            telemetry.counter("ingest.chunks_claimed").inc()
            telemetry.counter("ingest.rows_claimed").inc(len(item))
            faultinject.batch_consumed()
            return item

    # -- producing results ---------------------------------------------------

    def batch_results(self, results: Iterable[Any], chunk: bool = False) -> None:
        """Emit results to the output queue (parity with ``DataFeed``).

        Zero-copy record views are materialized to ``bytes`` here: a
        result outlives its batch by definition (the decode contract says
        copy what you keep), and views queued raw would pin shard buffers
        AND be unpicklable on the collect wire."""
        from tensorflowonspark_torch.data import materialize_views

        results = materialize_views(list(results))
        q = self.queues.get_queue(self.qname_out)
        if chunk:
            q.put(ResultChunk(results))
            return
        for r in results:
            q.put(r)

    # -- lifecycle -----------------------------------------------------------

    def should_stop(self) -> bool:
        return self.done_feeding

    def terminate(self) -> None:
        """Stop consuming: abandon in-flight reads, mark terminating, and
        fast-drain pending paths so upstream feed calls unblock."""
        self.done_feeding = True
        self._terminated.set()
        self._abandon.set()
        self.queues.set("state", "terminating")
        q = self.queues.get_queue(self.qname_in)
        while True:
            try:
                q.get(block=True, timeout=0.05)
            except queue.Empty:
                return
