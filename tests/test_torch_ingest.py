"""``tests/test_ingest.py`` restated over the port
(``tensorflowonspark_torch.ingest``, a copy of the JAX package's but for
``device_prefetch``), plus the parity tests against the JAX package.
Node-side direct ingestion (InputMode.DIRECT).

Units for the reader pipeline (parallel interleave, sync mode, gzip
streaming, decode, autotune, prefetch), the IngestFeed consumption-watermark
contract, shard enumeration — plus cluster end-to-end DIRECT training with
exact record accounting and the kill-mid-shard chaos scenario (the ledger
re-assigns a dead node's unread shards; coverage stays exact).
"""

from __future__ import annotations

import gzip
import os
import queue
import time

import pytest

from tensorflowonspark_torch import cluster as tcluster
from tensorflowonspark_torch import dfutil
from tensorflowonspark_torch import telemetry
from tensorflowonspark_torch import tfrecord
from tensorflowonspark_torch.data import PartitionedDataset
from tensorflowonspark_torch.feeding import FeedQueues
from tensorflowonspark_torch.ingest import (
    IngestFeed,
    ReaderPipeline,
    ShardReadError,
    ShardSpan,
    enumerate_shards,
    prefetch_iterator,
    shards_as_partitioned,
    split_shards,
)
from tensorflowonspark_torch.marker import EndOfFeed, EndPartition
from torch_lock_gate import torch_lock_witness_gate  # noqa: F401 - the port's lock-witness gate

from tests import torch_mapfuns


def _write_shards(root, num_shards: int, recs_per_shard: int,
                  gzip_last: bool = False) -> tuple[list[str], set[str]]:
    """Shards of utf-8 ``s<shard>-r<rec>`` payloads; returns (paths, ids)."""
    paths, ids = [], set()
    for s in range(num_shards):
        gz = gzip_last and s == num_shards - 1
        path = os.path.join(str(root), f"part-{s:05d}" + (".gz" if gz else ""))
        records = [f"s{s}-r{i}".encode() for i in range(recs_per_shard)]
        tfrecord.write_records(path, records,
                               compression="gzip" if gz else None)
        paths.append(path)
        ids.update(r.decode() for r in records)
    return paths, ids


def _drain(pipe: ReaderPipeline) -> list[bytes]:
    out: list[bytes] = []
    while True:
        try:
            item = pipe.get(timeout=1.0)
        except queue.Empty:
            continue
        if item is None:
            return out
        if isinstance(item, list):
            out.extend(item)


# -- reader pipeline units ----------------------------------------------------


@pytest.mark.parametrize("readers", [0, 1, 3])
def test_pipeline_exact_records_across_modes(tmp_path, readers):
    """Sync (0), single-, and multi-reader pipelines all deliver exactly
    the shard set's records — including a gzip shard in the mix."""
    paths, ids = _write_shards(tmp_path, 4, 50, gzip_last=True)
    pipe = ReaderPipeline(readers=readers, autotune=False, chunk_records=16)
    for p in paths:
        pipe.submit(p)
    pipe.close()
    got = _drain(pipe)
    # zero-copy default: plain-shard records are memoryviews, gzip bytes
    assert sorted(str(r, "utf-8") for r in got) == sorted(ids)


def test_pipeline_decode_runs_in_readers(tmp_path):
    paths, _ = _write_shards(tmp_path, 2, 30)
    # decode callables keep their bytes contract even under zero-copy
    # (views would crash every decoder written against bytes)
    pipe = ReaderPipeline(readers=2, autotune=False,
                          decode=lambda rec: rec.decode().split("-r")[1])
    for p in paths:
        pipe.submit(p)
    pipe.close()
    got = _drain(pipe)
    assert sorted(got) == sorted([str(i) for i in range(30)] * 2)


def test_pipeline_corrupt_shard_raises_with_path(tmp_path):
    paths, _ = _write_shards(tmp_path, 1, 20)
    blob = bytearray(open(paths[0], "rb").read())  # noqa: SIM115
    blob[40] ^= 0xFF  # flip a payload byte: data crc must catch it
    bad = os.path.join(str(tmp_path), "part-corrupt")
    with open(bad, "wb") as f:
        f.write(blob)
    pipe = ReaderPipeline(readers=1, autotune=False)
    pipe.submit(bad)
    pipe.close()
    with pytest.raises(ShardReadError, match="part-corrupt"):
        _drain(pipe)


def test_sync_pipeline_corrupt_shard_raises(tmp_path):
    pipe = ReaderPipeline(readers=0)
    pipe.submit(os.path.join(str(tmp_path), "nonexistent-shard"))
    pipe.close()
    with pytest.raises(ShardReadError, match="nonexistent-shard"):
        _drain(pipe)


def test_read_records_gzip_streams_never_whole_file(tmp_path, monkeypatch):
    """The gzip path must stream-decompress: a whole-file gzip.decompress
    would inflate multi-GB shards into one buffer inside a reader thread."""
    paths, ids = _write_shards(tmp_path, 1, 40)
    gz = os.path.join(str(tmp_path), "part-z.gz")
    tfrecord.write_records(gz, [f"z-{i}".encode() for i in range(40)],
                           compression="gzip")

    def _boom(*a, **k):
        raise AssertionError("whole-file gzip.decompress on the read path")

    monkeypatch.setattr(gzip, "decompress", _boom)
    got = list(tfrecord.read_records(gz))
    assert got == [f"z-{i}".encode() for i in range(40)]


def test_autotune_grows_pool_when_consumer_starves(tmp_path):
    """A starving consumer (slow readers via a sleepy decode, queue near
    empty, work pending) must grow the reader pool beyond its start of 1."""
    paths, _ = _write_shards(tmp_path, 12, 40)

    def sleepy(rec):
        time.sleep(0.0005)
        return rec

    pipe = ReaderPipeline(readers=4, autotune=True, chunk_records=8,
                          decode=sleepy, prefetch=4)
    for p in paths:
        pipe.submit(p)
    pipe.close()
    max_active = 1
    got = 0
    while True:
        try:
            item = pipe.get(timeout=1.0)
        except queue.Empty:
            continue
        with pipe._lock:
            max_active = max(max_active, pipe._active)
        if item is None:
            break
        if isinstance(item, list):
            got += len(item)
    assert got == 12 * 40
    assert max_active >= 2, "autotune never grew the reader pool"


def test_prefetch_iterator_order_and_error():
    assert list(prefetch_iterator(iter(range(100)), depth=4)) == list(range(100))

    def explodes():
        yield 1
        yield 2
        raise ValueError("source broke")

    it = prefetch_iterator(explodes(), depth=2)
    assert next(it) == 1
    assert next(it) == 2
    with pytest.raises(ValueError, match="source broke"):
        next(it)


# -- zero-copy record views (TOS_INGEST_ZEROCOPY) -----------------------------


def test_zerocopy_views_default_bytes_optout(tmp_path):
    """Default: plain-shard records are memoryview slices (no copy), gzip
    records bytes (streamed); zerocopy=False restores bytes everywhere."""
    paths, ids = _write_shards(tmp_path, 2, 20, gzip_last=True)
    pipe = ReaderPipeline(readers=1, autotune=False)
    for p in paths:
        pipe.submit(p)
    pipe.close()
    got = _drain(pipe)
    assert sorted(str(r, "utf-8") for r in got) == sorted(ids)
    kinds = {str(r, "utf-8").split("-")[0]: type(r) for r in got}
    assert kinds["s0"] is memoryview  # plain shard: zero-copy view
    assert kinds["s1"] is bytes       # gzip shard: streamed bytes

    pipe = ReaderPipeline(readers=1, autotune=False, zerocopy=False)
    for p in paths:
        pipe.submit(p)
    pipe.close()
    assert all(type(r) is bytes for r in _drain(pipe))


def test_zerocopy_debug_release_fails_loudly(tmp_path):
    """The decode contract, enforced: in debug mode a view retained past
    its batch's retirement (the next next_batch call) raises ValueError at
    first touch, while the batch in hand stays valid."""
    paths, _ = _write_shards(tmp_path, 1, 30)
    queues = FeedQueues(("input",))
    _feed_paths(queues, paths)
    feed = IngestFeed(queues, readers=1, zerocopy="debug")
    first = feed.next_batch(10)
    assert type(first[0]) is memoryview
    assert bytes(first[0])  # the batch in hand is always safe
    retained = first[0]
    second = feed.next_batch(10)
    assert bytes(second[0])  # current batch valid
    with pytest.raises(ValueError):
        bytes(retained)  # released view: loud, not a silent buffer pin


# -- columnar Example decode (schema mode) ------------------------------------


def _write_example_shards(root, gzip_out: bool = False):
    """Two schema'd Example shards (x float[2], y int64 scalar, name str);
    returns (dir, schema, expected y values in row order)."""
    rows = [{"x": [float(i), i + 0.5], "y": i, "name": f"r{i}"}
            for i in range(24)]
    data = PartitionedDataset.from_partitions([rows[:12], rows[12:]])
    out = str(root / "exdata")
    schema = dfutil.save_as_tfrecords(
        data, out, compression="gzip" if gzip_out else None)
    return out, schema, list(range(24))


@pytest.mark.parametrize("gz", [False, True])
def test_columnar_schema_batches(tmp_path, gz):
    """schema= routes shards through the columnar decoder: batches are
    {column: contiguous-buffer views} dicts — float columns [n, k]
    float32, int64 scalars [n], str columns lists — and gzip shards
    (which cannot span-decode) produce IDENTICAL batches via the
    streaming accumulator."""
    import numpy as np

    out, schema, ys = _write_example_shards(tmp_path, gzip_out=gz)
    queues = FeedQueues(("input",))
    _feed_paths(queues, dfutil.shard_files(out))
    feed = IngestFeed(queues, readers=1, schema=schema)
    got_y, got_x, got_names = [], [], []
    while not feed.should_stop():
        batch = feed.next_batch(7)
        if not batch:
            continue
        assert set(batch) == {"x", "y", "name"}
        assert batch["x"].dtype == np.float32 and batch["x"].ndim == 2
        assert batch["x"].shape[1] == 2
        assert batch["y"].dtype == np.int64
        got_y.extend(batch["y"].tolist())
        got_x.extend(batch["x"][:, 0].tolist())
        got_names.extend(batch["name"])
    assert sorted(got_y) == ys
    assert sorted(got_names) == sorted(f"r{i}" for i in ys)
    assert got_x == [float(y) for y in got_y]  # row alignment across columns
    assert queues.partitions_consumed("input") == 2  # watermark exact


def test_columnar_input_mapping_renames(tmp_path):
    out, schema, _ = _write_example_shards(tmp_path)
    queues = FeedQueues(("input",))
    _feed_paths(queues, dfutil.shard_files(out))
    feed = IngestFeed(queues, readers=1, schema=schema,
                      input_mapping={"x": "features", "y": "label"})
    batch = feed.next_batch(6)
    assert set(batch) == {"features", "label"}
    assert batch["features"].shape == (6, 2)


def test_columnar_schema_excludes_decode(tmp_path):
    queues = FeedQueues(("input",))
    with pytest.raises(ValueError, match="mutually exclusive"):
        IngestFeed(queues, readers=1, schema=dfutil.Schema([]),
                   decode=lambda r: r)


# -- sub-shard span work items ------------------------------------------------


def _write_padded_shard(root, name: str, shard_id: int, recs: int,
                        pad: int = 90) -> tuple[str, set[str]]:
    """One shard of ``recs`` ~100-byte records with unique prefixes."""
    records = [f"s{shard_id}-r{i}-".encode() + b"x" * pad for i in range(recs)]
    path = os.path.join(str(root), name)
    tfrecord.write_records(path, records)
    return path, {r.decode() for r in records}


def test_split_shards_spans_and_gzip_fallback(tmp_path):
    """Large plain shards split into contiguous record-aligned ShardSpan
    items; gzip shards — regardless of size — stay whole-path items (a
    gzip stream cannot be span-split or view-sliced from a seekable
    buffer), and small shards stay whole."""
    big, big_ids = _write_padded_shard(tmp_path, "part-00000", 0, 64)
    small, small_ids = _write_padded_shard(tmp_path, "part-00001", 1, 3)
    gz = os.path.join(str(tmp_path), "part-00002.gz")
    gz_records = [f"s2-r{i}-".encode() + b"x" * 90 for i in range(64)]
    tfrecord.write_records(gz, gz_records, compression="gzip")

    items = split_shards([big, small, gz], span_bytes=1000)
    spans = [i for i in items if isinstance(i, ShardSpan)]
    assert spans and all(s.path == big for s in spans)
    assert small in items and gz in items  # whole items, no splitting
    # spans tile the big shard: contiguous, start at 0, end at file size
    assert spans[0].start == 0 and spans[-1].end == os.path.getsize(big)
    assert all(a.end == b.start for a, b in zip(spans, spans[1:]))

    # the reader pipeline delivers exactly the full record set from the
    # mixed item list (span ranges + whole shards)
    pipe = ReaderPipeline(readers=2, autotune=False, chunk_records=8)
    for it in items:
        pipe.submit(it)
    pipe.close()
    got = sorted(str(r, "utf-8") for r in _drain(pipe))
    assert got == sorted(big_ids | small_ids | {r.decode() for r in gz_records})


def test_shards_as_partitioned_span_items(tmp_path):
    big, _ = _write_padded_shard(tmp_path, "part-00000", 0, 64)
    ds = shards_as_partitioned(str(tmp_path), span_bytes=1000)
    assert ds.num_partitions > 1  # one file became many span partitions
    items = [it for p in range(ds.num_partitions) for it in ds.iter_partition(p)]
    assert all(isinstance(it, ShardSpan) for it in items)
    # span_bytes=0 disables splitting
    assert shards_as_partitioned(str(tmp_path), span_bytes=0).num_partitions == 1


def test_ingest_feed_span_items_watermark(tmp_path):
    """ShardSpan items flow the ledger feed exactly like paths: per-item
    EndPartition keys, exact coverage, exact consumption watermark."""
    big, ids = _write_padded_shard(tmp_path, "part-00000", 0, 48)
    items = split_shards([big], span_bytes=800)
    assert len(items) > 2
    queues = FeedQueues(("input",))
    q = queues.get_queue("input")
    for i, item in enumerate(items):
        q.put(item)
        q.put(EndPartition(key=(0, i)))
    q.put(EndOfFeed())
    feed = IngestFeed(queues, readers=2)
    seen: list[str] = []
    while not feed.should_stop():
        seen.extend(str(r, "utf-8") for r in feed.next_batch(13))
    assert sorted(seen) == sorted(ids)
    assert queues.partitions_consumed("input") == len(items)


# -- IngestFeed: watermark contract over the path feed ------------------------


def _feed_paths(queues, paths, keys=True, eof=True):
    q = queues.get_queue("input")
    for i, p in enumerate(paths):
        q.put(p)
        q.put(EndPartition(key=(0, i) if keys else None))
    if eof:
        q.put(EndOfFeed())


def test_ingest_feed_drains_and_reports_watermark(tmp_path):
    paths, ids = _write_shards(tmp_path, 4, 50, gzip_last=True)
    queues = FeedQueues(("input", "output", "error"))
    _feed_paths(queues, paths)
    feed = IngestFeed(queues, readers=2)
    seen = []
    while not feed.should_stop():
        # copy out of the zero-copy views before the batch retires (the
        # decode contract: views are released when the next batch arrives)
        seen.extend(bytes(r) for r in feed.next_batch(37))
    assert sorted(r.decode() for r in seen) == sorted(ids)
    # every partition fully handed over -> watermark exact
    assert queues.partitions_consumed("input") == 4
    # DIRECT mode reports the same feed-occupancy gauge as DataFeed (the
    # per-node signal cluster.stats() serves); fully drained -> depth 0
    assert telemetry.gauge("feed.queue_depth").value() == 0


def test_ingest_feed_dedupes_refed_partition(tmp_path):
    """An at-least-once re-feed re-READS the shard (record duplicates are
    the contract) but the keyed consumption watermark counts it once."""
    paths, _ = _write_shards(tmp_path, 2, 30)
    queues = FeedQueues(("input",))
    q = queues.get_queue("input")
    for _ in range(2):  # the same logical partition fed twice
        q.put(paths[0])
        q.put(EndPartition(key=(0, 0)))
    q.put(paths[1])
    q.put(EndPartition(key=(0, 1)))
    q.put(EndOfFeed())
    feed = IngestFeed(queues, readers=1)
    seen = []
    while not feed.should_stop():
        seen.extend(feed.next_batch(64))
    assert len(seen) == 3 * 30  # duplicates delivered (at-least-once)
    assert queues.partitions_consumed("input") == 2  # counted once per key


def test_ingest_feed_watermark_lags_final_batch(tmp_path):
    """The last partition must not be counted consumed before the batch
    carrying its final records has been handed back (duplicates-allowed,
    loss-never: a death in between must re-deliver)."""
    paths, _ = _write_shards(tmp_path, 1, 10)
    queues = FeedQueues(("input",))
    _feed_paths(queues, paths)
    feed = IngestFeed(queues, readers=1)
    batch = feed.next_batch(10)  # exactly the shard's records
    assert len(batch) == 10
    assert queues.partitions_consumed("input") == 0  # not yet proven processed
    assert feed.next_batch(10) == []  # coming back is the proof
    assert feed.should_stop()
    assert queues.partitions_consumed("input") == 1


def test_ingest_feed_junk_item_raises(tmp_path):
    queues = FeedQueues(("input",))
    queues.get_queue("input").put(12345)  # rows, not paths
    feed = IngestFeed(queues, readers=1)
    with pytest.raises(RuntimeError, match="shard PATHS"):
        while not feed.should_stop():
            feed.next_batch(4)


def test_ingest_feed_input_mapping_columns(tmp_path):
    paths, _ = _write_shards(tmp_path, 1, 8)
    queues = FeedQueues(("input",))
    _feed_paths(queues, paths)
    feed = IngestFeed(queues, readers=1, input_mapping={"payload": "x"},
                      decode=lambda rec: rec)
    cols = feed.next_batch(8)
    assert set(cols) == {"x"} and len(cols["x"]) == 8


# -- shard enumeration --------------------------------------------------------


def test_enumerate_shards_directory_glob_file_list(tmp_path):
    paths, _ = _write_shards(tmp_path, 3, 5)
    (tmp_path / "_schema.json").write_text("{}")  # must be excluded
    assert enumerate_shards(str(tmp_path)) == paths
    assert enumerate_shards(os.path.join(str(tmp_path), "part-*")) == paths
    assert enumerate_shards(paths[1]) == [paths[1]]
    assert enumerate_shards(list(reversed(paths))) == list(reversed(paths))
    with pytest.raises(FileNotFoundError):
        enumerate_shards(os.path.join(str(tmp_path), "nope-*"))
    with pytest.raises(FileNotFoundError):
        enumerate_shards(str(tmp_path / "missing"))


def test_enumerate_shards_preserves_uri_scheme(tmp_path):
    from tensorflowonspark_torch.utils.paths import register_fs_root

    paths, _ = _write_shards(tmp_path / "data", 2, 5)
    register_fs_root("ingesttestfs", str(tmp_path), export=False)
    got = enumerate_shards("ingesttestfs://nn/data")
    assert [os.path.basename(g) for g in got] == \
        [os.path.basename(p) for p in paths]
    assert all(g.startswith("ingesttestfs://nn/data/") for g in got)


def test_shards_as_partitioned_grouping(tmp_path):
    paths, _ = _write_shards(tmp_path, 6, 2)
    assert shards_as_partitioned(str(tmp_path)).num_partitions == 6
    ds = shards_as_partitioned(str(tmp_path), num_partitions=2)
    assert ds.num_partitions == 2
    assert sorted(p for i in range(2) for p in ds.iter_partition(i)) == paths
    with pytest.raises(ValueError, match="num_partitions"):
        shards_as_partitioned(str(tmp_path), num_partitions=7)


# -- cluster end-to-end -------------------------------------------------------


def test_direct_train_e2e_exact_accounting(tmp_path, monkeypatch):
    """2-node DIRECT train over a real cluster: the ledger streams shard
    paths, nodes ingest the bytes, and the epoch's record coverage comes
    out exact (happy path: no duplicates either).  Mode-mismatch APIs
    raise errors that name the supported mode."""
    monkeypatch.setenv("TOS_SHM_RING", "0")
    shard_dir = tmp_path / "shards"
    paths, ids = _write_shards(shard_dir, 6, 40, gzip_last=True)
    cluster = tcluster.run(
        torch_mapfuns.direct_record_counter,
        {"out_dir": str(tmp_path), "batch_size": 16},
        num_executors=2,
        input_mode=tcluster.InputMode.DIRECT,
        log_dir=str(tmp_path / "logs"),
        reservation_timeout=120.0,
    )
    # satellite: mode-mismatch errors name the mode that IS supported
    with pytest.raises(RuntimeError, match="InputMode.STREAMING"):
        cluster.inference([1, 2, 3])
    with pytest.raises(RuntimeError, match="shard path"):
        cluster.train(12345)
    cluster.train(str(shard_dir), num_epochs=1)
    cluster.shutdown(timeout=120.0)
    seen: list[str] = []
    for f in tmp_path.glob("seen_*.txt"):
        seen.extend(x for x in f.read_text().split() if x)
    assert sorted(seen) == sorted(ids)  # exact: every record once
    metas = {m["executor_id"]: m for m in cluster.coordinator.cluster_info()}
    # the driver-published manifest reached the nodes
    manifests = [m.get("manifest") for m in metas.values() if m.get("manifest")]
    assert manifests and manifests[0]["num_shards"] == 6
    assert manifests[0]["num_items"] == 6  # tiny shards: no sub-shard split
    assert manifests[0]["num_epochs"] == 1
    # both nodes participated (ledger round-robin over 6 shard partitions)
    counts = [m.get("records_inc0", 0) for m in metas.values()]
    assert sum(counts) == len(ids) and all(c > 0 for c in counts)


def test_streaming_cluster_rejects_path_train(tmp_path):
    cluster = tcluster.run(
        torch_mapfuns.noop, {}, num_executors=1,
        input_mode=tcluster.InputMode.STREAMING,
        reservation_timeout=120.0,
    )
    try:
        with pytest.raises(RuntimeError, match="InputMode.DIRECT"):
            cluster.train(str(tmp_path / "somewhere"))
    finally:
        cluster.shutdown(timeout=60.0)


@pytest.mark.chaos
def test_direct_kill_mid_subshard_rereads_lost_span(tmp_path, monkeypatch):
    """Chaos at SPAN granularity: ONE large plain shard split into
    sub-shard items across 2 nodes, SIGKILL one node mid-consumption.
    The ledger must re-assign exactly the dead node's unread/unconsumed
    span ranges (to the survivor or the supervised restart) and the
    epoch's DISTINCT record coverage must come out exact — duplicates
    allowed (a re-fed span is re-read from its start offset), loss
    never."""
    monkeypatch.setenv("TOS_SHM_RING", "0")  # a SIGKILL leaves rings wedged
    monkeypatch.setenv("TOS_DEAD_NODE_TIMEOUT", "4")
    monkeypatch.setenv("TOS_RESTART_BACKOFF_BASE", "0.2")
    monkeypatch.setenv("TOS_INGEST_SPAN_BYTES", "2048")
    shard_dir = tmp_path / "shards"
    os.makedirs(shard_dir)
    path, ids = _write_padded_shard(shard_dir, "part-00000", 0, 240)
    assert len(split_shards([path], span_bytes=2048)) >= 8  # real span fan-out
    per_node_env = [{}, {"TOS_FAULTINJECT": "kill:after_batches=3,incarnation=0"}]
    cluster = tcluster.run(
        torch_mapfuns.direct_record_counter,
        {"out_dir": str(tmp_path), "batch_size": 16},
        num_executors=2,
        input_mode=tcluster.InputMode.DIRECT,
        heartbeat_interval=0.5,
        per_node_env=per_node_env,
        log_dir=str(tmp_path / "logs"),
        reservation_timeout=120.0,
        elastic=True,
    )
    cluster.train(str(shard_dir), num_epochs=1)
    metas = {m["executor_id"]: m for m in cluster.coordinator.cluster_info()}
    victims = [eid for eid, m in metas.items() if m.get("incarnation") == 1]
    assert len(victims) == 1, metas
    cluster.shutdown(timeout=120.0)
    assert cluster.coordinator.errors() == []  # recovered, not fatal
    # manifests publish when the feeds EOF at shutdown
    metas = {m["executor_id"]: m for m in cluster.coordinator.cluster_info()}
    manifests = [m.get("manifest") for m in metas.values() if m.get("manifest")]
    assert manifests and manifests[0]["num_shards"] == 1
    assert manifests[0]["num_items"] >= 8  # the shard went out as spans
    seen: list[str] = []
    for f in tmp_path.glob("seen_*.txt"):
        seen.extend(x for x in f.read_text().split() if x)
    # distinct coverage exact: the lost span ranges were re-read in full
    assert set(seen) == ids
    assert len(seen) >= len(ids)  # at-least-once may duplicate, never lose


@pytest.mark.chaos
def test_direct_kill_mid_shard_reassigns_to_survivor(tmp_path, monkeypatch):
    """The acceptance chaos scenario: SIGKILL one node mid-shard-set in
    DIRECT mode with elastic=True.  The ledger must re-assign the dead
    node's unacked/unconsumed shard partitions (to the survivor or the
    supervised restart), train() must complete with no node error, and the
    epoch's DISTINCT record coverage must come out exact — duplicates
    allowed (a re-assigned shard is re-READ from the top), loss never."""
    monkeypatch.setenv("TOS_SHM_RING", "0")  # a SIGKILL leaves rings wedged
    monkeypatch.setenv("TOS_DEAD_NODE_TIMEOUT", "4")
    monkeypatch.setenv("TOS_RESTART_BACKOFF_BASE", "0.2")
    shard_dir = tmp_path / "shards"
    paths, ids = _write_shards(shard_dir, 8, 30)
    per_node_env = [{}, {"TOS_FAULTINJECT": "kill:after_batches=3,incarnation=0"}]
    cluster = tcluster.run(
        torch_mapfuns.direct_record_counter,
        {"out_dir": str(tmp_path), "batch_size": 16},
        num_executors=2,
        input_mode=tcluster.InputMode.DIRECT,
        heartbeat_interval=0.5,
        per_node_env=per_node_env,
        log_dir=str(tmp_path / "logs"),
        reservation_timeout=120.0,
        elastic=True,
    )
    cluster.train(str(shard_dir), num_epochs=1)
    metas = {m["executor_id"]: m for m in cluster.coordinator.cluster_info()}
    victims = [eid for eid, m in metas.items() if m.get("incarnation") == 1]
    assert len(victims) == 1, metas
    assert cluster.supervisor.restart_count(victims[0]) == 1
    cluster.shutdown(timeout=120.0)
    assert cluster.coordinator.errors() == []  # recovered, not fatal
    seen: list[str] = []
    for f in tmp_path.glob("seen_*.txt"):
        seen.extend(x for x in f.read_text().split() if x)
    # dedupe at the coverage level: distinct records exactly the shard set
    assert set(seen) == ids
    # at-least-once: the re-read shard may duplicate records, never lose
    assert len(seen) >= len(ids)


# -- parity with the JAX package ----------------------------------------------


def _parity_shards(root, n_shards=3, per_shard=20, seed=7):
    """Example shards from a numpy seed: ``x`` float[3], ``y`` int64 and a
    ``blob`` of raw bytes per record; returns (paths, schema)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    parts = [[{"x": rng.standard_normal(3).astype(np.float32).tolist(),
               "y": int(rng.integers(0, 1000)),
               "blob": rng.integers(0, 256, 12, dtype=np.uint8).tobytes()}
              for _ in range(per_shard)] for _ in range(n_shards)]
    out = str(root / "parity")
    schema = dfutil.save_as_tfrecords(PartitionedDataset.from_partitions(parts), out)
    return dfutil.shard_files(out), schema


def _drain_feed(feed, batch_size):
    batches = []
    while not feed.should_stop():
        batch = feed.next_batch(batch_size)
        if batch:
            if isinstance(batch, dict):
                batches.append({k: (v.copy() if hasattr(v, "copy") else list(v))
                                for k, v in batch.items()})
            else:
                batches.append([bytes(r) for r in batch])
    return batches


def test_ingest_feed_matches_jax_records_and_columns(tmp_path):
    """The JAX ``IngestFeed`` and the port's, both with one reader and the
    same ``chunk_records``, yield equal record sequences and equal columnar
    dicts from the same shards (exact: both are the same decode)."""
    import numpy as np

    from tensorflowonspark_tpu import dfutil as jdfutil
    from tensorflowonspark_tpu.feeding import FeedQueues as JFeedQueues
    from tensorflowonspark_tpu.ingest import IngestFeed as JIngestFeed
    from tensorflowonspark_tpu.marker import EndOfFeed as JEndOfFeed
    from tensorflowonspark_tpu.marker import EndPartition as JEndPartition

    paths, schema = _parity_shards(tmp_path)
    jschema = jdfutil.Schema.from_json(schema.to_json())

    def jax_feed(**kw):
        queues = JFeedQueues(("input",))
        q = queues.get_queue("input")
        for i, p in enumerate(paths):
            q.put(p)
            q.put(JEndPartition(key=(0, i)))
        q.put(JEndOfFeed())
        return JIngestFeed(queues, readers=1, chunk_records=8, **kw)

    def port_feed(**kw):
        queues = FeedQueues(("input",))
        _feed_paths(queues, paths)
        return IngestFeed(queues, readers=1, chunk_records=8, **kw)

    rows = _drain_feed(port_feed(), 6)
    assert rows == _drain_feed(jax_feed(), 6)
    assert sum(len(b) for b in rows) == 60
    cols = _drain_feed(port_feed(schema=schema, binary_features={"blob"}), 5)
    jcols = _drain_feed(jax_feed(schema=jschema, binary_features={"blob"}), 5)
    assert len(cols) == len(jcols) and sum(len(b["y"]) for b in cols) == 60
    for got, want in zip(cols, jcols):
        assert got.keys() == want.keys()
        np.testing.assert_array_equal(got["x"], want["x"])
        np.testing.assert_array_equal(got["y"], want["y"])
        assert got["blob"] == want["blob"]


def test_device_prefetch_on_the_cpu_matches_jax_and_copies_views(tmp_path, monkeypatch):
    """``device_prefetch(device="cpu")`` gives the JAX function's arrays as
    tensors (exact), copies each batch before pulling the next — under
    ``TOS_INGEST_ZEROCOPY=debug`` a retained record view would fail when the
    feed retires its batch — and without a card it raises unless asked for
    the CPU."""
    import jax
    import numpy as np
    import torch

    from tensorflowonspark_torch.ingest import device_prefetch
    from tensorflowonspark_tpu.ingest import device_prefetch as jax_device_prefetch

    rng = np.random.default_rng(3)
    batches = [{"x": rng.standard_normal((4, 3)).astype(np.float32),
                "ragged": (rng.integers(0, 9, 7), np.array([3, 4])),
                "mask": rng.random(4) > 0.5} for _ in range(5)]
    got = list(device_prefetch(iter(batches), depth=2, device="cpu"))
    want = list(jax_device_prefetch(iter(batches), depth=2))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        gl, gtree = jax.tree_util.tree_flatten(g)
        wl, wtree = jax.tree_util.tree_flatten(w)
        assert gtree == wtree
        for a, b in zip(gl, wl):
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    monkeypatch.setenv("TOS_INGEST_ZEROCOPY", "debug")
    paths, ids = _write_shards(tmp_path, 2, 12)
    queues = FeedQueues(("input",))
    _feed_paths(queues, paths)
    feed = IngestFeed(queues, readers=1)

    def views():
        # every leaf aliases a record view of the shard buffer
        while not feed.should_stop():
            batch = feed.next_batch(3)
            if batch:
                assert all(type(r) is memoryview for r in batch)
                yield {f"r{i}": np.frombuffer(r, np.uint8)
                       for i, r in enumerate(batch)}

    seen = []
    for tensors in device_prefetch(views(), depth=2, device="cpu"):
        seen.extend(bytes(t.numpy()).decode() for t in tensors.values())
    assert sorted(seen) == sorted(ids)

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            next(device_prefetch(iter(batches)))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(device_prefetch(iter(batches), device="cuda"))


# Loss and parameters of the ingest-fed run against the JAX replay, relative:
# both sides train in float32 on the same batches from the same weights.
INGEST_TRAIN_RTOL = 1e-4
INGEST_TRAIN_ATOL = 1e-6


def test_ingest_fed_resnet_training_matches_jax_replay(tmp_path, monkeypatch):
    """A 1-node DIRECT cluster trains ``resnet_cifar`` (32 px, batch 16,
    float32, 3 steps) from TFRecord shards through the ingest feed and
    ``device_prefetch``; the recorded batches, regenerated from their ids,
    replay through the JAX ``make_bn_train_step`` from the same weights
    (``convert.torch_to_flax``): every id exactly once, and each step's
    loss and the final parameters and running statistics agree within
    ``INGEST_TRAIN_RTOL`` relative (``INGEST_TRAIN_ATOL`` absolute)."""
    import json

    import jax
    import numpy as np
    import optax
    import torch

    from tensorflowonspark_torch import convert
    from tensorflowonspark_tpu.models import registry as jreg
    from tensorflowonspark_tpu.models import resnet as jres
    from tensorflowonspark_tpu.parallel import dp as jdp

    monkeypatch.setenv("TOS_SHM_RING", "0")
    config = {"model": "resnet_cifar", "depth_blocks": 1, "width": 8,
              "num_classes": 10, "bf16": False}
    size, n, seed, lr, wd = 32, 48, 5, 0.1, 1e-4
    shard_dir = str(tmp_path / "shards")
    torch_mapfuns.write_image_shards(shard_dir, n, 24, size, seed, 10)
    args = {"device": "cpu", "config": config, "seed": seed, "size": size,
            "batch_size": 16, "lr": lr, "weight_decay": wd, "readers": 1,
            "out_dir": str(tmp_path), "save": True}
    cluster = tcluster.run(torch_mapfuns.ingest_resnet_trainer, args,
                           num_executors=1, input_mode=tcluster.InputMode.DIRECT,
                           log_dir=str(tmp_path / "logs"))
    try:
        cluster.train(shard_dir, num_epochs=1)
    finally:
        cluster.shutdown()
    result = json.loads((tmp_path / "ingest_result_0.json").read_text())
    assert [len(b) for b in result["ids"]] == [16, 16, 16]
    assert sorted(i for b in result["ids"] for i in b) == list(range(n))

    init = torch_mapfuns.build_image_model(config, seed, "cpu")
    variables = convert.torch_to_flax(init.state_dict(), config=config)
    jmodel = jreg.build(config)
    jopt = optax.sgd(lr, momentum=0.9, nesterov=True)
    jstate = jdp.BNTrainState.create(variables["params"], variables["batch_stats"], jopt)
    jstep = jdp.make_bn_train_step(jres.make_loss_fn(jmodel, weight_decay=wd), jopt,
                                   donate=False)
    mean, std = np.float32(torch_mapfuns.IMAGE_MEAN), np.float32(torch_mapfuns.IMAGE_STD)
    for ids, loss in zip(result["ids"], result["losses"]):
        pixels = np.stack([torch_mapfuns.synthetic_image(seed, i, size) for i in ids])
        batch = {"image": (pixels.astype(np.float32) / np.float32(255.0) - mean) / std,
                 "label": np.asarray(ids, np.int32) % 10}
        jstate, jm = jstep(jstate, batch)
        np.testing.assert_allclose(loss, float(jm["loss"]), rtol=INGEST_TRAIN_RTOL)
    trained = torch.load(tmp_path / "trained_0.pt", weights_only=True)
    got = convert.torch_to_flax(trained, config=config)
    want = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_got:
        np.testing.assert_allclose(leaf, np.asarray(flat_want[path]),
                                   rtol=INGEST_TRAIN_RTOL, atol=INGEST_TRAIN_ATOL,
                                   err_msg=jax.tree_util.keystr(path))
