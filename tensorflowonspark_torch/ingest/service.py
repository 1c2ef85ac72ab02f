"""Standalone data-service ingest workers — the disaggregated ingest tier.

BENCH_r12 measured the node-local data plane entitlement-capped by per-box
decode CPU: readers live inside each training node, so columnar decode
competes with the training step and reader parallelism can never exceed the
trainer count.  Following the tf.data service design (PAPERS.md) this module
promotes the readers to an independently scaled worker pool:

    driver ledger          ingest workers (role="ingest")         trainers
    shard paths/spans  ->  claim + CRC + columnar decode     ->   IngestFeed,
    (at-least-once,        (ReaderPipeline on OWN cores,          pure consumer
    incarnation-fenced)    cross-epoch ChunkCache)  --chunk_fwd-->

- **Workers are ordinary cluster nodes** whose assigned role is ``ingest``
  (``cluster.run(ingest_workers=N)``): the driver's partition ledger feeds
  them shard paths exactly as it would feed a DIRECT-mode trainer, so
  at-least-once re-feed, the consumption watermark, incarnation fencing,
  and supervised elastic restarts carry over to worker deaths UNCHANGED —
  a SIGKILLed worker's unacked partitions re-feed to its peers or its
  supervised replacement, and no trainer restarts.
- **Decoded chunks stream to trainers** over the existing zero-copy v2/v3
  wire (``dataserver`` op ``chunk_fwd``; ``data.DecodedChunk``): a
  ``ColumnChunk``'s contiguous column buffers travel out-of-band, and the
  trainer's ``IngestFeed`` injects payloads straight into its prefetch
  queue — decode parallelism becomes a fleet knob (``TOS_INGEST_WORKERS``,
  ``cluster.resize_ingest``) instead of a per-trainer constant.
- **Cross-epoch chunk cache** (:class:`ChunkCache`,
  ``TOS_INGEST_CACHE_BYTES``): repeated-epoch reads of the same work item
  + schema serve materialized chunks from memory instead of re-running the
  CRC scan + decode; bounded LRU by payload bytes, ``0`` disables, and the
  schema fingerprint in the key means eviction can never serve a stale
  schema.
- **Global shuffle** (``TOS_INGEST_SHUFFLE``, default on): each worker
  deals its decoded chunks round-robin across ALL trainers (offset by its
  own task index), so a trainer's stream interleaves every shard the pool
  claims — combined with the ledger's seeded between-epoch partition
  shuffle this is the tf.data-service "global shuffle" property.  ``0``
  pins each worker to one trainer (locality mode).

The worker's consumption watermark advances only after a trainer ACKED the
partition's last chunk (``IngestFeed.next_chunk`` hands the next chunk out
only after the previous one was forwarded), so the driver's elastic tail
drain — and therefore ``train()`` returning — proves every record is
buffered trainer-side or better.  Duplicates are allowed (at-least-once),
loss never.
"""

from __future__ import annotations

import collections
import logging
import threading
from tensorflowonspark_torch.utils.locks import tos_named_lock
import time

from tensorflowonspark_torch import telemetry
from tensorflowonspark_torch.data import DecodedChunk, chunk_nbytes
from tensorflowonspark_torch.ingest.feed import IngestFeed
from tensorflowonspark_torch.ingest.shards import work_item_key
from tensorflowonspark_torch.utils.envtune import env_bool as _env_bool
from tensorflowonspark_torch.utils.envtune import env_int as _env_int

logger = logging.getLogger(__name__)


def cache_bytes_default() -> int:
    """Effective ``TOS_INGEST_CACHE_BYTES`` (0 = cache disabled)."""
    return _env_int("TOS_INGEST_CACHE_BYTES", 0, minimum=0)


def shuffle_default() -> bool:
    """Effective ``TOS_INGEST_SHUFFLE`` (default on: global shuffle)."""
    return _env_bool("TOS_INGEST_SHUFFLE", True)


def schema_fingerprint(schema) -> str | None:
    """Stable identity of a decode schema for cache keying.  ``to_json``
    is the schema's own durable serialization, so two schemas that decode
    identically fingerprint identically across processes and epochs —
    and ANY schema change (column added, width redeclared) changes the
    key, which is what makes a stale-schema cache hit impossible."""
    if schema is None:
        return None
    return schema.to_json()


class ChunkCache:
    """Bounded LRU cache of decoded chunks, keyed by (work item, schema).

    The cross-epoch half of the ingest tier: epoch 2+ reads of a span the
    pool already decoded are served from memory (no IO, no CRC, no parse).
    Values are MATERIALIZED chunk lists (owned buffers — the reader tees
    copies in, see ``ReaderPipeline._emit``), shared read-only between the
    cache and every consumer; the accounting unit is payload bytes
    (``data.chunk_nbytes``), bounded by ``max_bytes`` with LRU eviction.
    ``max_bytes=0`` disables the cache entirely (every get misses, puts
    are dropped) — the ``TOS_INGEST_CACHE_BYTES=0`` contract.

    Thread-safe: one worker's reader pool runs N threads through it.
    """

    def __init__(self, max_bytes: int | None = None):
        self.max_bytes = max(0, int(max_bytes if max_bytes is not None
                                    else cache_bytes_default()))
        self._lock = tos_named_lock("service.cache._lock")
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._bytes = 0

    @property
    def enabled(self) -> bool:
        return self.max_bytes > 0

    def key_for(self, item, schema=None, binary_features=None) -> tuple:
        # binary_features is part of the decode contract (bytes-vs-str
        # column values), so it must be part of the key: a hit across a
        # different setting would hand one pipeline the other's types
        bf = tuple(sorted(binary_features)) if binary_features else None
        return (work_item_key(item), schema_fingerprint(schema), bf)

    def get(self, key) -> list | None:
        if not self.enabled:
            return None
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
        if entry is None:
            telemetry.counter("ingest.cache_misses").inc()
            return None
        telemetry.counter("ingest.cache_hits").inc()
        return entry[0]

    def put(self, key, chunks: list, nbytes: int | None = None) -> bool:
        """Insert one work item's materialized chunks; returns whether the
        entry was admitted (an item bigger than the whole budget is not —
        caching it would just evict everything for a single-use entry).
        ``nbytes`` skips the size walk when the producer already counted
        (the reader tee tracks a running total)."""
        if not self.enabled:
            return False
        if nbytes is None:
            nbytes = sum(chunk_nbytes(c) for c in chunks)
        if nbytes > self.max_bytes:
            telemetry.counter("ingest.cache_oversize_skips").inc()
            return False
        evictions = 0
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            while self._bytes + nbytes > self.max_bytes and self._entries:
                _, (_, ev_bytes) = self._entries.popitem(last=False)
                self._bytes -= ev_bytes
                evictions += 1
            self._entries[key] = (chunks, nbytes)
            self._bytes += nbytes
            total = self._bytes
        telemetry.counter("ingest.cache_inserts").inc()
        if evictions:
            telemetry.counter("ingest.cache_evictions").inc(evictions)
        telemetry.gauge("ingest.cache_bytes").set(total)
        return True

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "max_bytes": self.max_bytes}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0
        telemetry.gauge("ingest.cache_bytes").set(0)


class TrainerForwarder:
    """Deals decoded chunks from one ingest worker across the trainer fleet.

    ``endpoints`` is ``[(executor_id, host, data_port), ...]`` of every
    trainer (the worker reads them off ``ctx.cluster_info``).  Transport is
    the ordinary :class:`~tensorflowonspark_torch.dataserver.DataClient`
    (authkey handshake, v2/v3 wire, ring upgrade where same-host) — the
    dial-discipline transport home; this class never opens a raw socket.

    Target selection: ``shuffle`` on (``TOS_INGEST_SHUFFLE``, the default)
    rotates round-robin per chunk starting at ``rr_offset`` (the worker's
    task index, so a fleet of workers decorrelates), giving every trainer
    an interleave of every shard the pool claims; off pins this worker to
    ``trainers[rr_offset % T]`` (locality mode).

    Failure handling is at-least-once shaped: a failed send (severed
    socket, trainer mid-restart) drops the client, redials, and retries —
    first the same trainer, then the rest of the rotation — under a
    ``stall_timeout`` budget; only a fleet-wide stall raises.  A trainer
    answering ``terminating`` is retired from the rotation; when every
    trainer has terminated, :meth:`forward` returns False (the consumer
    side of the feed is over).
    """

    def __init__(self, endpoints, authkey: bytes, *, qname: str = "input",
                 shuffle: bool | None = None, rr_offset: int = 0,
                 stop_event: threading.Event | None = None,
                 stall_timeout: float = 60.0, connect_timeout: float = 10.0):
        if not endpoints:
            raise ValueError("ingest forwarder needs at least one trainer")
        self.endpoints = {int(eid): (host, int(port))
                          for eid, host, port in endpoints}
        self.authkey = authkey
        self.qname = qname
        self.shuffle = shuffle if shuffle is not None else shuffle_default()
        self.stall_timeout = stall_timeout
        self.connect_timeout = connect_timeout
        self.stop_event = stop_event
        self._order = sorted(self.endpoints)
        self._pos = rr_offset % len(self._order)
        self._clients: dict[int, object] = {}
        self._terminated: set[int] = set()

    def _client(self, eid: int):
        client = self._clients.get(eid)
        if client is None:
            from tensorflowonspark_torch.dataserver import DataClient

            host, port = self.endpoints[eid]
            client = DataClient(host, port, self.authkey,
                                connect_timeout=self.connect_timeout,
                                connect_attempts=1)
            self._clients[eid] = client
        return client

    def _drop(self, eid: int) -> None:
        stale = self._clients.pop(eid, None)
        if stale is not None:
            try:
                stale.close()
            except Exception:  # noqa: BLE001  # toslint: allow-silent(the socket already failed; a fresh dial follows)
                pass

    def _rotation(self) -> list[int]:
        live = [e for e in self._order if e not in self._terminated]
        if not live:
            return []
        start = self._pos % len(live)
        if self.shuffle:
            self._pos += 1  # next chunk starts one trainer later
        return live[start:] + live[:start]

    def forward(self, chunk: DecodedChunk) -> bool:
        """Deliver one chunk to some live trainer (retrying/re-routing under
        the stall budget).  True = delivered and acked; False = every
        trainer is terminating, stop producing.  Raises ``RuntimeError``
        when no trainer accepted within ``stall_timeout`` — the worker's
        map_fun error path then owns it (supervised restart / job error),
        with the partition's re-feed covering the undelivered records."""
        deadline = time.monotonic() + self.stall_timeout
        while True:
            rotation = self._rotation()
            if not rotation:
                return False  # every trainer terminated: feed is over
            for eid in rotation:
                if self.stop_event is not None and self.stop_event.is_set():
                    return False
                try:
                    state = self._client(eid).forward_chunks([chunk],
                                                             self.qname)
                except Exception:  # noqa: BLE001 - rerouted below
                    # severed stream / trainer mid-restart: poison this
                    # client and move on; the rotation (and the outer retry
                    # loop) owns delivery
                    telemetry.counter("ingest.forward_errors").inc()
                    logger.warning("chunk forward to trainer %d failed; "
                                   "re-routing", eid, exc_info=True)
                    self._drop(eid)
                    continue
                if state == "terminating":
                    self._terminated.add(eid)
                    self._drop(eid)
                    continue
                telemetry.counter("ingest.chunks_forwarded").inc()
                telemetry.counter("ingest.rows_forwarded").inc(chunk.nrows)
                telemetry.counter("ingest.bytes_forwarded").inc(chunk.nbytes)
                return True
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"no trainer accepted a decoded chunk within "
                    f"{self.stall_timeout}s ({len(self._order)} endpoint(s), "
                    f"{len(self._terminated)} terminated)")
            time.sleep(0.2)

    def close(self) -> None:
        for eid in list(self._clients):
            self._drop(eid)


class IngestService:
    """One data-service worker: claim -> decode (cached) -> forward.

    Wraps an :class:`~tensorflowonspark_torch.ingest.feed.IngestFeed` over
    the worker's own ``FeedQueues`` (the driver's ledger feeds shard
    paths/spans into them through the worker's ``DataServer``, so every
    elastic/at-least-once property of a DIRECT-mode trainer applies to the
    worker verbatim) and a :class:`TrainerForwarder` for the fan-out.

    ``next_chunk`` -> ``forward`` -> ``next_chunk`` is the watermark
    contract: coming back for the next chunk is the proof the previous one
    was ACKED into a trainer's queue, so the consumption report the
    driver's tail drain polls only ever lags real delivery.
    """

    def __init__(self, queues, trainers, authkey: bytes, *,
                 stop_event: threading.Event | None = None,
                 schema=None, binary_features=None, chunk_records: int = 256,
                 readers: int | None = None, prefetch: int | None = None,
                 autotune: bool | None = None, verify: bool = True,
                 cache_bytes: int | None = None, shuffle: bool | None = None,
                 qname_in: str = "input", forward_qname: str = "input",
                 rr_offset: int = 0, forward_timeout: float = 60.0):
        self.cache = ChunkCache(cache_bytes)
        # raw-record mode forces bytes payloads (zerocopy off): a forwarded
        # record must own its buffer — memoryviews of a local shard mmap
        # cannot travel the wire, and the cache stores owned copies anyway.
        # Columnar (schema) mode is unaffected: ColumnChunk buffers ship
        # out-of-band on the v2/v3 wire.
        self.feed = IngestFeed(
            queues, qname_in=qname_in, stop_event=stop_event,
            schema=schema, binary_features=binary_features,
            chunk_records=chunk_records, readers=readers, prefetch=prefetch,
            autotune=autotune, verify=verify,
            zerocopy=("0" if schema is None else None),
            cache=self.cache)
        self.forwarder = TrainerForwarder(
            trainers, authkey, qname=forward_qname, shuffle=shuffle,
            rr_offset=rr_offset, stop_event=stop_event,
            stall_timeout=forward_timeout)

    def run(self) -> dict:
        """Serve until the ledger feed ends (EndOfFeed / stop signal) or
        every trainer terminates; returns delivery totals."""
        chunks = rows = 0
        t0 = time.monotonic()
        try:
            while True:
                chunk = self.feed.next_chunk()
                if chunk is None:
                    break
                if not self.forwarder.forward(DecodedChunk(chunk)):
                    # consumer side is gone (all trainers terminating):
                    # fast-drain the remaining ledger feed so driver feed
                    # calls unblock — mirroring a terminating DataFeed
                    self.feed.terminate()
                    break
                chunks += 1
                rows += len(chunk)
        finally:
            self.forwarder.close()
        secs = time.monotonic() - t0
        telemetry.gauge("ingest.service_rows_per_s").set(
            round(rows / secs, 1) if secs > 0 else 0.0)
        return {"chunks": chunks, "rows": rows,
                "secs": round(secs, 3), "cache": self.cache.stats()}


def ingest_worker_main(args, ctx) -> dict:
    """The ``role="ingest"`` node body (``node_main`` dispatches here
    instead of the user map_fun when the coordinator assigns the ingest
    role).  Decode options come from ``cluster.run(ingest_opts=...)``
    (``NodeConfig.ingest_opts``); trainer endpoints from the registered
    cluster info; the cache/shuffle knobs from the environment."""
    config = ctx._config
    opts = dict(getattr(config, "ingest_opts", None) or {})
    # node-owned keywords: the stop event is ALWAYS the node's (a
    # user-supplied one could not observe the heartbeat stop ladder), and
    # rr_offset defaults to the worker's task index (fleet decorrelation)
    # unless the opts deliberately pin it — neither may collide with the
    # explicit kwargs below (a collision would TypeError every worker)
    opts.pop("stop_event", None)
    rr_offset = opts.pop("rr_offset", ctx.task_index)
    trainers = [(m["executor_id"], m["host"], m["data_port"])
                for m in ctx.cluster_info
                if m["job_name"] not in ("evaluator", "ingest")
                and m.get("data_port")]
    if not trainers:
        raise RuntimeError("ingest worker found no trainer endpoints in the "
                           "cluster info (nothing to forward decoded chunks "
                           "to)")
    service = IngestService(ctx.queues, trainers, config.authkey,
                            stop_event=ctx.stop_requested,
                            rr_offset=rr_offset, **opts)
    stats = service.run()
    logger.info("ingest worker %d done: %d chunk(s) / %d row(s) forwarded "
                "in %.2fs (cache: %s)", ctx.executor_id, stats["chunks"],
                stats["rows"], stats["secs"], stats["cache"])
    return stats
