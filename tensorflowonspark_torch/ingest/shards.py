"""Driver-side shard enumeration for ``InputMode.DIRECT``.

``cluster.train(path_or_glob)`` in DIRECT mode must turn one user string
into the ledger's work items — a ``PartitionedDataset`` whose partitions
carry shard *paths* (one shard per partition by default, the finest
reassignment granularity a node death can trigger).  The enumeration runs
on the driver but the *fed* paths keep the user's URI scheme: a node
resolves each path against its OWN mounts (``utils.paths.resolve_uri``),
so a cluster whose hosts mount ``hopsfs://`` at different roots still
reads the right files — the reference got the same property from the
Hadoop FS client resolving paths executor-side.
"""

from __future__ import annotations

import glob as _glob
import logging
import os

from tensorflowonspark_torch import tfrecord
from tensorflowonspark_torch.data import PartitionedDataset
from tensorflowonspark_torch.utils.envtune import env_int as _env_int
from tensorflowonspark_torch.utils.paths import resolve_uri

logger = logging.getLogger(__name__)

_GLOB_CHARS = frozenset("*?[")

# Default sub-shard granularity (TOS_INGEST_SPAN_BYTES): plain shards above
# this split into record-aligned byte-range work items so N nodes can
# parallelize INSIDE one multi-GB shard.  256 MiB keeps ordinary shard
# layouts (64-256 MB files) whole while carving anything pathological.
_DEFAULT_SPAN_BYTES = 256 << 20


class ShardSpan:
    """One sub-shard work item: a record-aligned byte range of a PLAIN
    (non-gzip) shard.  Travels the partition ledger exactly like a shard
    path — tens of bytes on the wire — and a node reads just its range
    (``tfrecord.read_span_range``): seek, one bounded read, one CRC scan.
    At-least-once re-feed re-reads exactly this range; gzip shards can
    never be span items (no byte-addressable record boundaries), the
    splitter keeps them whole."""

    __slots__ = ("path", "start", "end")

    def __init__(self, path: str, start: int, end: int):
        self.path = path
        self.start = start
        self.end = end

    def __repr__(self) -> str:
        return f"ShardSpan({self.path!r}, [{self.start}:{self.end}))"

    def __eq__(self, other) -> bool:
        return (isinstance(other, ShardSpan) and self.path == other.path
                and self.start == other.start and self.end == other.end)

    def __hash__(self) -> int:
        return hash((self.path, self.start, self.end))


def work_item_key(item) -> tuple:
    """Canonical identity of one ledger work item — a whole-shard path or a
    :class:`ShardSpan` byte range — used as the span half of the ingest
    tier's cross-epoch chunk-cache key (``ingest/service.py``) and as the
    provenance tag on forwarded chunks.  Two items compare equal exactly
    when they name the same bytes of the same file."""
    if isinstance(item, ShardSpan):
        return (item.path, item.start, item.end)
    return (os.fspath(item), None, None)


def span_bytes_default() -> int:
    """The effective ``TOS_INGEST_SPAN_BYTES`` (0 disables splitting)."""
    return _env_int("TOS_INGEST_SPAN_BYTES", _DEFAULT_SPAN_BYTES, minimum=0)


def split_shards(files: list[str], span_bytes: int | None = None) -> list:
    """Expand shard paths into ledger work items, splitting large plain
    shards into :class:`ShardSpan` record-aligned ranges.

    Per file: gzip shards (``tfrecord.is_gzipped_shard``) and files at or
    under ``span_bytes`` stay whole path items (a gzip stream cannot be
    span-split or view-sliced from a seekable buffer — the whole-shard
    streaming read is its only safe shape); larger plain shards become one
    ``ShardSpan`` per ~``span_bytes`` of record data, walked by header
    only (``tfrecord.walk_record_bounds`` — no payload read, no CRC work
    driver-side).  ``span_bytes=0`` disables splitting.
    """
    if span_bytes is None:
        span_bytes = span_bytes_default()
    if span_bytes <= 0:
        return list(files)
    items: list = []
    for path in files:
        if isinstance(path, ShardSpan):
            items.append(path)  # pre-split by an earlier pass
            continue
        local = resolve_uri(path)
        try:
            size = os.path.getsize(local)
        except OSError:
            items.append(path)  # node-side resolution may still find it
            continue
        if size <= span_bytes or tfrecord.is_gzipped_shard(local):
            items.append(path)
            continue
        try:
            bounds = tfrecord.walk_record_bounds(local, span_bytes)
        except tfrecord.RecordError as e:
            # not (valid) TFRecord framing: keep the file a whole item —
            # node-side reads surface the real error with full context if
            # anything actually consumes it (self-service map_funs may
            # legitimately route non-shard files here and never will)
            logger.warning("not span-splitting %s: %s", path, e)
            items.append(path)
            continue
        if len(bounds) <= 1:
            items.append(path)  # one giant record: nothing to split
            continue
        logger.info("splitting %s (%d bytes) into %d record-span items",
                    path, size, len(bounds))
        items.extend(ShardSpan(path, s, e) for s, e in bounds)
    return items


def enumerate_shards(spec) -> list[str]:
    """Expand a DIRECT-mode input spec into a sorted list of shard paths.

    Accepts:

    - a **directory** (local path or registered URI): its ``part-*`` shard
      files (the ``dfutil.save_as_tfrecords`` layout);
    - a **glob** (contains ``*``/``?``/``[``): every match;
    - a **single file**;
    - a **list/tuple of paths**: used verbatim (already enumerated).

    URIs resolve through ``utils.paths`` for the *enumeration* only; the
    returned paths keep the original scheme so each node re-resolves them
    against its own mounts.
    """
    if isinstance(spec, (list, tuple)):
        paths = [p if isinstance(p, ShardSpan) else os.fspath(p)
                 for p in spec]
        if not paths:
            raise FileNotFoundError("empty shard list for DIRECT-mode train")
        return paths
    spec = os.fspath(spec)
    local = resolve_uri(spec)
    prefix_len = len(local)  # to graft matches back under the original URI

    def _restore(match: str) -> str:
        # '/mnt/hopsfs/data/part-0' back to 'hopsfs://nn/data/part-0'
        if match.startswith(local) and local != spec:
            return spec + match[prefix_len:]
        return match

    if any(c in local for c in _GLOB_CHARS):
        matches = sorted(_glob.glob(local))
        if not matches:
            raise FileNotFoundError(f"no shard files match {spec!r}")
        return [_restore(m) for m in matches]
    if os.path.isdir(local):
        matches = sorted(
            f for f in _glob.glob(os.path.join(local, "part-*"))
            if not f.endswith(".json"))
        if not matches:
            raise FileNotFoundError(f"no 'part-*' shard files under {spec!r}")
        sep = "" if spec.endswith("/") else "/"
        return [spec + sep + os.path.basename(m) if local != spec else m
                for m in matches]
    if os.path.exists(local):
        return [spec]
    raise FileNotFoundError(f"DIRECT-mode input {spec!r} does not exist "
                            "(expected a shard directory, glob, or file)")


def shards_as_partitioned(spec, num_partitions: int | None = None,
                          span_bytes: int | None = None
                          ) -> PartitionedDataset:
    """Ledger work items for a DIRECT-mode train: partitions of shard
    paths and (for large plain shards) :class:`ShardSpan` ranges.

    Default is ONE work item per partition — each ledger task is a single
    file or sub-shard range, so a node death mid-epoch re-assigns exactly
    the unread items, ``shuffle_seed`` reorders individual items between
    epochs, and a single multi-GB shard parallelizes across every node
    instead of pinning to one.  Pass ``num_partitions`` to group items
    (round-robin, sizes even out) when a dataset has so many tiny files
    that per-item ledger acks would dominate; ``span_bytes`` overrides
    ``TOS_INGEST_SPAN_BYTES`` (0 disables sub-shard splitting).
    """
    if isinstance(spec, PartitionedDataset):
        return spec
    items = split_shards(enumerate_shards(spec), span_bytes)
    n = len(items) if num_partitions is None else num_partitions
    if not 0 < n <= len(items):
        raise ValueError(f"num_partitions={n} must be in 1..{len(items)} "
                         "(number of shard work items)")
    return PartitionedDataset.from_partitions([items[i::n] for i in range(n)])
