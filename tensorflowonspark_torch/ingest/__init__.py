"""tensorflowonspark_torch.ingest — node-side direct ingestion (InputMode.DIRECT).

The ``InputMode.TENSORFLOW`` half of the reference, rebuilt per the tf.data
paper's input-pipeline design (PAPERS.md): the driver's partition ledger
assigns TFRecord *shard paths* as work items — keeping at-least-once
re-feed, elastic restart recovery, and incarnation fencing exactly as in
streaming mode — and every node reads, CRC-verifies, decodes, and
prefetches its shards itself, so aggregate feed bandwidth scales with the
node count instead of capping at one driver core.

Pieces:

- :mod:`~tensorflowonspark_torch.ingest.shards` — driver-side shard
  enumeration (dir / glob / URI -> ledger partitions of paths);
- :mod:`~tensorflowonspark_torch.ingest.readers` — the
  :class:`ReaderPipeline`: parallel-interleaved shard readers with bounded
  decode queues, occupancy-autotuned parallelism, and prefetch helpers
  (:func:`prefetch_iterator`, :func:`device_prefetch`);
- :mod:`~tensorflowonspark_torch.ingest.feed` — :class:`IngestFeed`, the
  DIRECT-mode ``DataFeed`` twin a map_fun gets from ``ctx.get_data_feed()``.

- :mod:`~tensorflowonspark_torch.ingest.service` — the DISAGGREGATED tier:
  standalone data-service workers (``role="ingest"``,
  ``cluster.run(ingest_workers=N)``) that claim the ledger's shard items,
  decode on their own cores with a cross-epoch :class:`ChunkCache`, and
  stream packed chunks to trainers over the zero-copy wire — the trainers'
  :class:`IngestFeed` then acts as a pure consumer.

Knobs: ``TOS_INGEST_READERS`` (reader-pool ceiling), ``TOS_INGEST_PREFETCH``
(decoded-chunk prefetch depth), ``TOS_INGEST_AUTOTUNE`` (occupancy-driven
pool sizing), ``TOS_INGEST_ZEROCOPY`` (memoryview record views — 0 restores
bytes copies, ``debug`` makes retained views fail loudly),
``TOS_INGEST_SPAN_BYTES`` (sub-shard split granularity; 0 keeps shards
whole), ``TOS_INGEST_WORKERS`` (data-service tier size),
``TOS_INGEST_CACHE_BYTES`` (cross-epoch chunk-cache budget; 0 disables),
``TOS_INGEST_SHUFFLE`` (global shuffle across the pool; 0 pins workers to
trainers).
"""

from tensorflowonspark_torch.ingest.feed import IngestFeed  # noqa: F401
from tensorflowonspark_torch.ingest.readers import (  # noqa: F401
    ReaderPipeline,
    ShardDone,
    ShardReadError,
    device_prefetch,
    prefetch_iterator,
)
from tensorflowonspark_torch.ingest.service import (  # noqa: F401
    ChunkCache,
    IngestService,
    TrainerForwarder,
    ingest_worker_main,
)
from tensorflowonspark_torch.ingest.shards import (  # noqa: F401
    ShardSpan,
    enumerate_shards,
    shards_as_partitioned,
    split_shards,
    work_item_key,
)
