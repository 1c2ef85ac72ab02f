"""Sentinel markers for the streaming data plane.

Parity with ``tensorflowonspark/marker.py:~1-25`` (reference): ``Marker`` base
and ``EndPartition`` (end of one streamed partition).  We add an explicit
``EndOfFeed`` sentinel where the reference used a bare ``None`` pushed by
``TFSparkNode.shutdown`` (``TFSparkNode.py:~590-660``) — an explicit type is
safer when ``None`` may be legitimate user data.
"""


class Marker:
    """Base class for control markers placed in data queues."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - trivial
        return f"<{type(self).__name__}>"


class EndPartition(Marker):
    """End of a single streamed partition (reference ``marker.EndPartition``).

    ``key`` (optional) identifies WHICH logical partition this closes — the
    driver's ledger task, e.g. ``(epoch, partition)``.  The at-least-once
    re-feed path can legitimately place two EndPartitions for one logical
    partition in the same queue (end_partition reply lost after the server
    already queued the marker, then the same partition re-fed); the
    consumption watermark must count such a pair once, or it over-advances
    past still-buffered work that a later death would then fail to
    re-deliver.  ``None`` (legacy/no-ledger feeds) counts every pop.

    ``trace`` (optional) is the sampled request/partition's trace context
    ``(trace_id, span_id)``: the consumer's partition-consume span parents
    onto it, closing the cross-process loop (``telemetry.trace``).
    """

    __slots__ = ("key", "trace")

    def __init__(self, key=None, trace=None):
        self.key = key
        self.trace = trace


class EndOfFeed(Marker):
    """No more data will ever arrive; consumers should finish up."""

    __slots__ = ()


class ResultChunk(Marker):
    """A whole batch of inference results as ONE output-queue item.

    ``DataFeed.batch_results(..., chunk=True)`` wraps the batch in this and
    the data server's ``collect`` op flattens it back out, so a 64-row
    serving batch costs one queue put + one collect round-trip instead of
    64 puts and several partial-drain round-trips (the serving gateway's
    latency path).  Order within the chunk is result order, exactly-count
    is preserved by construction (the chunk holds one result per input
    row of its batch).
    """

    __slots__ = ("items",)

    def __init__(self, items):
        self.items = list(items)
