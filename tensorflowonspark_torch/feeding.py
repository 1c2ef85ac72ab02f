"""In-node streaming data plane: queues + the user-facing ``DataFeed``.

Replaces the reference's ``TFManager`` (``tensorflowonspark/TFManager.py:~1-90``,
multiprocessing manager queues) and ``TFNode.DataFeed``
(``tensorflowonspark/TFNode.py:~250-430``).  Design delta (SURVEY.md §3.2):
the reference forked the user ``map_fun`` into a background process because
Spark needed its task slot back, paying a JVM→Python pickle plus a
manager-proxy hop per sample.  Here the node process is ours, so ``map_fun``
runs in the node's main thread and the feed is a plain in-process bounded
queue filled by the ``DataServer`` socket thread — no cross-process hop on
the hot path.

Semantics preserved from the reference (these are load-bearing, see
SURVEY.md §4 "queue/timeout edge cases"):

- ``next_batch(n)`` returns *up to* ``n`` items; an ``EndPartition`` marker
  ends the batch early (partial batch) so per-partition result counts line up
  for inference (``TFNode.py:~280-340``).
- An ``EndOfFeed`` sentinel sets ``done_feeding``; subsequent ``should_stop()``
  is True.  Delta from the reference, which pushed a bare ``None`` from
  ``TFSparkNode.shutdown``: here ``None`` is ordinary user data (samples with
  optional fields must survive the feed) and only the explicit marker ends it.
- ``terminate()`` sets state ``'terminating'`` and drains remaining input so
  pending upstream feed calls unblock fast (``TFNode.py:~400-430``).
- ``batch_results`` pushes to the output queue consumed by the inference
  collector (``TFNode.py:~350-380``).
"""

from __future__ import annotations

import queue
import threading
from tensorflowonspark_torch.utils.locks import tos_named_lock
from typing import Any, Iterable, Sequence

from tensorflowonspark_torch import faultinject, telemetry
from tensorflowonspark_torch.marker import EndOfFeed, EndPartition, Marker, ResultChunk
from tensorflowonspark_torch.telemetry import trace as ttrace
from time import monotonic as _monotonic
from time import sleep as _sleep


class FeedQueues:
    """Named bounded queues + shared state dict for one node process.

    Parity with ``TFManager.start(authkey, queues, mode)``; 'local' vs
    'remote' modes are gone because there is no second Python process.
    """

    def __init__(self, qnames: Sequence[str] = ("input", "output", "error"), capacity: int = 1024):
        self._queues: dict[str, queue.Queue] = {name: queue.Queue(maxsize=capacity) for name in qnames}
        self._state: dict[str, Any] = {"state": "running"}
        # Cumulative partitions fully CONSUMED (EndPartition popped by the
        # map_fun) per queue — the consumption watermark the data server
        # reports back to the driver, so the partition ledger knows which
        # buffered-but-unconsumed partitions die with this process.  Keyed
        # markers dedupe: an at-least-once re-feed can place two
        # EndPartitions for ONE logical partition in this queue (reply lost
        # after the server queued the first marker), and double-counting
        # would over-advance the driver's watermark past still-buffered work.
        self._consumed: dict[str, int] = {name: 0 for name in qnames}
        self._consumed_keys: dict[str, set] = {name: set() for name in qnames}
        self._lock = tos_named_lock("feeding._lock")

    def get_queue(self, qname: str) -> queue.Queue:
        try:
            return self._queues[qname]
        except KeyError:
            raise KeyError(f"unknown queue {qname!r}; have {sorted(self._queues)}") from None

    def note_partition_consumed(self, qname: str, key=None) -> None:
        with self._lock:
            if key is not None:
                seen = self._consumed_keys.setdefault(qname, set())
                if key in seen:
                    return  # re-fed duplicate of a partition already counted
                seen.add(key)
            self._consumed[qname] = self._consumed.get(qname, 0) + 1
        telemetry.counter("feed.partitions_consumed").inc()

    def partitions_consumed(self, qname: str) -> int:
        with self._lock:
            return self._consumed.get(qname, 0)

    def set(self, key: str, value: Any) -> None:
        with self._lock:
            self._state[key] = value

    def compare_and_set(self, key: str, expected: Any, value: Any) -> bool:
        """Atomic state transition: set only when the current value matches
        ``expected``.  The park/unpark ladder uses this so a self-fence can
        never clobber the 'terminating' fast-drain state (stop beats park),
        and an unpark never resurrects a feed that terminated meanwhile."""
        with self._lock:
            if self._state.get(key) != expected:
                return False
            self._state[key] = value
            return True

    def get(self, key: str) -> Any:
        with self._lock:
            return self._state.get(key)


def batch_to_columns(batch: list, input_mapping: dict) -> dict:
    """Reshape a row batch into the ``{name: [values...]}`` columnar dict
    the reference's tensor-name ``input_mapping`` produced — shared by the
    driver-streamed ``DataFeed`` and the DIRECT-mode ``ingest.IngestFeed``
    so the two feed sources present identical batches to map_funs."""
    names = list(input_mapping.values())
    cols: dict[str, list] = {name: [] for name in names}
    for item in batch:
        values = item if isinstance(item, (list, tuple)) else (item,)
        for name, v in zip(names, values):
            cols[name].append(v)
    return cols


class IteratorFeed:
    """Adapt a plain Python iterator to the DataFeed consumption protocol
    (``next_batch``/``should_stop``), so direct-input-mode code (framework
    reads files itself) can reuse the same batch/consensus machinery as the
    streaming mode (``parallel.dp.make_batch_iterator``)."""

    def __init__(self, iterable):
        self._it = iter(iterable)
        self.done_feeding = False

    def next_batch(self, batch_size: int) -> list:
        batch: list = []
        while len(batch) < batch_size:
            try:
                batch.append(next(self._it))
            except StopIteration:
                self.done_feeding = True
                break
        return batch

    def should_stop(self) -> bool:
        return self.done_feeding


class DataFeed:
    """User-facing feed API inside ``map_fun`` (reference ``TFNode.DataFeed``).

    ``input_mapping``: optional ordered mapping {column → name}.  When given,
    ``next_batch`` returns ``{name: [values...]}`` columnar dicts (matching
    the reference's tensor-name mapping behaviour); otherwise a flat list of
    items.
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
    ):
        self.queues = queues
        self.train_mode = train_mode
        self.qname_in = qname_in
        self.qname_out = qname_out
        self.input_mapping = input_mapping
        self.done_feeding = False
        # Liveness: a bare q.get() would wedge map_fun forever if the driver
        # dies between partitions (zombie-free design goal, SURVEY.md §7.3-5).
        # next_batch polls at poll_interval and treats a set stop_event as
        # end-of-feed.
        self.stop_event = stop_event
        self.poll_interval = poll_interval
        # Markers of partitions whose CLOSING batch has been built but not
        # yet returned to (and processed by) the map_fun.  Counting them
        # consumed at EndPartition-pop time would let the watermark race
        # ahead of the map_fun: a death between the pop and the map_fun's
        # processing of that final batch would advance the driver's ledger
        # past a partition whose tail items were never seen — silent loss,
        # where the contract is duplicates-allowed-loss-never.  Reported on
        # the NEXT next_batch call instead (the map_fun coming back for more
        # is the proof the previous batch was handed over); the watermark
        # only ever lags, which can over-requeue but never drop.
        self._closed_unreported: list = []
        # rolling feed-queue occupancy (the autoscaling signal
        # cluster.stats() serves per node); set at batch boundaries
        self._occupancy = telemetry.gauge("feed.queue_depth")
        # partition-consume tracing: the first data item after the previous
        # EndPartition anchors the span; the marker's trace ctx (stamped by
        # a sampled driver partition / serving round) parents it.  The last
        # popped marker's ctx is exposed as ``last_trace`` so the consumer
        # (serving_loop) can hang its compute span on the same trace.
        self._part_t0: float | None = None
        self.last_trace = None
        # full-batch marker lookahead (see next_batch): a non-marker item
        # popped by the lookahead is consumed FIRST on the next call
        self._pending = None

    # -- consuming -----------------------------------------------------------

    def next_batch(self, batch_size: int) -> list | dict:
        """Pop up to ``batch_size`` items; partial on EndPartition/end-of-feed.

        Reference hot loop ``TFNode.py:~280-340``.
        """
        # Self-fence: "parked" means this node lost its
        # coordinator past TOS_COORDINATOR_GRACE_SECS — a replacement may
        # already own the slot, so taking NEW work risks split-brain.  Hold
        # here (checked once per batch, off the per-item hot path) until
        # the heartbeat loop re-admits us or gives up (stop_event).
        while self.queues.get("state") == "parked":
            if self.stop_event is not None and self.stop_event.is_set():
                break
            _sleep(self.poll_interval)
        for key in self._closed_unreported:
            self.queues.note_partition_consumed(self.qname_in, key)
        self._closed_unreported = []
        q = self.queues.get_queue(self.qname_in)
        batch: list = []
        while len(batch) < batch_size:
            if self._pending is not None:
                item, self._pending = self._pending, None
            else:
                try:
                    # fast path: drain already-buffered items without the
                    # timed get's condition-wait machinery — at zero-copy
                    # feed rates the queue is rarely empty and the per-item
                    # overhead shows
                    item = q.get_nowait()
                except queue.Empty:
                    if self.stop_event is not None and self.stop_event.is_set():
                        self.done_feeding = True
                        break
                    try:
                        item = q.get(timeout=self.poll_interval)
                    except queue.Empty:
                        # starvation signal: the consumer wanted data and
                        # the feed had none for a whole poll interval —
                        # the rate of this counter (vs feed.batches) is
                        # the "trainers starve while decode lags" evidence
                        # the ingest-tier autoscaling reads
                        telemetry.counter("feed.starved_polls").inc()
                        continue
            if isinstance(item, EndPartition):
                # the marker is FIFO-last for its partition: popping it means
                # every item of that partition left the queue
                self._note_partition_trace(item)
                if batch:
                    # the batch closing this partition still has to reach the
                    # map_fun — defer the consumption report (see __init__)
                    self._closed_unreported.append(getattr(item, "key", None))
                    break  # partial batch closes out the partition
                # empty close: every item of this partition was in batches
                # returned on earlier calls, all fully processed by now
                self.queues.note_partition_consumed(self.qname_in,
                                                    getattr(item, "key", None))
                continue  # keep waiting for real data
            if isinstance(item, EndOfFeed):
                self.done_feeding = True
                break
            if isinstance(item, Marker):
                continue
            if self._part_t0 is None:
                self._part_t0 = _monotonic()
            batch.append(item)
        if len(batch) >= batch_size:
            # marker lookahead: an exactly-full batch whose EndPartition is
            # already queued closes its partition NOW (same deferred-report
            # semantics as the partial-batch path) — without this, the
            # marker (and its trace ctx) would only pop on the NEXT call,
            # attributing a serving round's consume span to the wrong round
            nxt = None
            try:
                nxt = q.get_nowait()
            except queue.Empty:  # toslint: allow-silent(no marker buffered yet; handled below)
                if ttrace.enabled():
                    # the producer may be mid-enqueue (items drained faster
                    # than it could append the marker): a bounded wait
                    # usually catches it; if not, drop the stale ctx so the
                    # consumer's compute span goes unattributed instead of
                    # onto the PREVIOUS round's trace
                    try:
                        nxt = q.get(timeout=0.002)
                    except queue.Empty:  # toslint: allow-silent(marker genuinely late; next call pops it)
                        self.last_trace = None
            if isinstance(nxt, EndPartition):
                self._note_partition_trace(nxt)
                self._closed_unreported.append(getattr(nxt, "key", None))
            elif nxt is not None:
                self._pending = nxt
        if batch:
            self._occupancy.set(q.qsize())
            telemetry.counter("feed.batches").inc()
            telemetry.counter("feed.rows_consumed").inc(len(batch))
            # Chaos hook (no-op unless TOS_FAULTINJECT armed a `kill`): a
            # consumed batch is the deterministic clock for "die after N
            # batches" — the most brutal mid-epoch death available.
            faultinject.batch_consumed()
        if self.input_mapping:
            return self._to_columns(batch)
        return batch

    def _to_columns(self, batch: list) -> dict:
        return batch_to_columns(batch, self.input_mapping)

    def _note_partition_trace(self, item: EndPartition) -> None:
        """Close out a popped EndPartition's trace: records the node-side
        partition-consume span (first queued item seen -> marker popped)
        under the driver's partition/round span and publishes the ctx as
        ``last_trace`` for the consumer's own compute span."""
        ctx = getattr(item, "trace", None)
        self.last_trace = ctx
        t0, self._part_t0 = self._part_t0, None
        if ctx is not None:
            now = _monotonic()
            ttrace.record_child("feed.partition_consume", ctx,
                                t0 if t0 is not None else now,
                                now - t0 if t0 is not None else 0.0)

    # -- producing results (inference path) ----------------------------------

    def batch_results(self, results: Iterable[Any], chunk: bool = False) -> None:
        """Emit one result per input item.  ``chunk=True`` ships the whole
        batch as a single :class:`ResultChunk` queue item — one put and one
        ``collect`` round-trip instead of per-item queue traffic; the data
        server flattens it transparently, so collectors see identical
        per-item results either way (serving hot path)."""
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
        """Stop consuming: mark terminating and fast-drain remaining input."""
        self.done_feeding = True
        self.queues.set("state", "terminating")
        q = self.queues.get_queue(self.qname_in)
        while True:
            try:
                q.get(block=True, timeout=0.05)
            except queue.Empty:
                return
