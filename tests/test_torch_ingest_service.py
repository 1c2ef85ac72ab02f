"""``tests/test_ingest_service.py`` restated over the port
(``tensorflowonspark_torch.ingest.service``, a copy of the JAX package's).
Disaggregated ingest tier: the data-service worker role, cross-epoch
chunk cache, global shuffle, and chaos coverage.

Layers under test, bottom-up:

- ``ChunkCache`` units — LRU byte bound, ``TOS_INGEST_CACHE_BYTES=0``
  disables, oversize entries skipped, schema-fingerprint keying (a stale
  schema can NEVER be served, even for the same span);
- pipeline integration — a second read of the same work item is served
  from the cache byte-identical to the first, cold vs warm counters;
- pure-consumer feed — ``DecodedChunk`` items injected through
  ``IngestFeed`` with the partition watermark lagging delivery exactly as
  node-local shards do;
- in-process service e2e — real ``DataServer``s for one worker and N
  trainers, the driver ledger-feeding shard paths, exact distinct-record
  coverage through the forwarding tier, global shuffle on/off
  distribution;
- full-cluster e2e — ``run(ingest_workers=1)``: role assignment, the
  ledger feeding the WORKER slot, trainer coverage, the ``stats()``
  ingest block;
- chaos — SIGKILL an ingest worker mid-span (supervised replacement, no
  trainer restart, coverage exact) and sever a trainer<->worker chunk
  stream (forwarder re-routes, trainers never wedge);
- the ingest autoscale policy + ``Autoscaler(tier="ingest")`` actuation.
"""

from __future__ import annotations

import glob
import os
import threading
import time

import pytest

from tensorflowonspark_torch import cluster as tcluster
from tensorflowonspark_torch import dfutil, tfrecord
from tensorflowonspark_torch.autoscale import Autoscaler, IngestBacklogPolicy
from tensorflowonspark_torch.data import DecodedChunk, chunk_nbytes
from tensorflowonspark_torch.dataserver import DataClient, DataServer
from tensorflowonspark_torch.feeding import FeedQueues
from tensorflowonspark_torch.ingest import (
    ChunkCache,
    IngestFeed,
    IngestService,
    ReaderPipeline,
    ShardSpan,
    work_item_key,
)
from tensorflowonspark_torch.ingest.service import schema_fingerprint
from tensorflowonspark_torch.marker import EndOfFeed, EndPartition
from torch_lock_gate import torch_lock_witness_gate  # noqa: F401 - the port's lock-witness gate

from tests import torch_mapfuns


@pytest.fixture(autouse=True)
def _tcp_data_plane(monkeypatch):
    # apples-to-apples plumbing for every test here: no shm-ring probes
    monkeypatch.setenv("TOS_SHM_RING", "0")


def _write_shards(dirpath, num_shards=3, per_shard=40, prefix="rec"):
    os.makedirs(dirpath, exist_ok=True)
    expected = set()
    paths = []
    for s in range(num_shards):
        recs = [f"{prefix}-{s}-{i}".encode() for i in range(per_shard)]
        expected.update(r.decode() for r in recs)
        p = os.path.join(dirpath, f"part-{s:05d}")
        tfrecord.write_records(p, recs)
        paths.append(p)
    return paths, expected


# -- ChunkCache units ---------------------------------------------------------


def test_cache_disabled_at_zero_budget():
    cache = ChunkCache(0)
    assert not cache.enabled
    key = cache.key_for("part-0")
    assert not cache.put(key, [[b"a", b"b"]])
    assert cache.get(key) is None
    assert cache.stats()["entries"] == 0


def test_cache_lru_eviction_holds_byte_bound():
    chunk = [b"x" * 100]  # 100 payload bytes per entry
    cache = ChunkCache(250)
    for name in ("p0", "p1", "p2"):
        assert cache.put(cache.key_for(name), [list(chunk)])
    # 3 x 100 > 250: the LRU entry (p0) was evicted
    assert cache.stats()["bytes"] <= 250
    assert cache.get(cache.key_for("p0")) is None
    assert cache.get(cache.key_for("p1")) is not None
    # touching p1 made p2 the LRU: inserting p3 evicts p2, not p1
    assert cache.put(cache.key_for("p3"), [list(chunk)])
    assert cache.get(cache.key_for("p2")) is None
    assert cache.get(cache.key_for("p1")) is not None


def test_cache_skips_entries_bigger_than_budget():
    cache = ChunkCache(50)
    assert not cache.put(cache.key_for("big"), [[b"y" * 100]])
    assert cache.stats() == {"entries": 0, "bytes": 0, "max_bytes": 50}


def test_cache_key_includes_span_and_schema():
    cache = ChunkCache(1 << 20)
    schema = dfutil.Schema.from_json(
        '[{"name": "x", "dtype": "float32", "scalar": true}]')
    other = dfutil.Schema.from_json(
        '[{"name": "x", "dtype": "int64", "scalar": true}]')
    span_a = ShardSpan("part-0", 0, 100)
    span_b = ShardSpan("part-0", 100, 200)
    assert cache.key_for(span_a, schema) != cache.key_for(span_b, schema)
    assert cache.key_for(span_a, schema) != cache.key_for(span_a, other)
    assert cache.key_for("part-0") != cache.key_for("part-0", schema)
    # same span + equal-content schema objects key identically
    clone = dfutil.Schema.from_json(schema.to_json())
    assert cache.key_for(span_a, schema) == cache.key_for(span_a, clone)
    assert schema_fingerprint(None) is None
    assert work_item_key(span_a) == ("part-0", 0, 100)


def test_chunk_nbytes_accounts_records_and_columns():
    import numpy as np

    assert chunk_nbytes([b"abc", memoryview(b"defg")]) == 7
    cols, counts = ({"x": np.zeros(8, np.float32)},
                    {"x": np.ones(8, np.int64)})
    cc = dfutil.ColumnChunk(cols, counts, 8)
    assert chunk_nbytes(cc) == 8 * 4 + 8 * 8


# -- pipeline cache integration ----------------------------------------------


def _drain_pipeline(pipeline):
    out = []
    while True:
        try:
            item = pipeline.get(timeout=1.0)
        except Exception:  # noqa: BLE001 - queue.Empty means a test bug
            raise AssertionError("pipeline stalled")
        if item is None:
            return out
        if hasattr(item, "path"):  # ShardDone
            continue
        out.append(item)


def test_second_read_served_from_cache_byte_identical(tmp_path):
    paths, _ = _write_shards(tmp_path / "d", num_shards=1, per_shard=64)
    cache = ChunkCache(1 << 20)

    def read_once():
        pipeline = ReaderPipeline(readers=0, chunk_records=16, cache=cache,
                                  zerocopy="0")
        pipeline.submit(paths[0])
        pipeline.close()
        return _drain_pipeline(pipeline)

    from tensorflowonspark_torch import telemetry

    reg = telemetry.get_registry()
    h0 = reg.snapshot()["counters"].get("ingest.cache_hits", 0)
    cold = read_once()
    warm = read_once()
    h1 = reg.snapshot()["counters"].get("ingest.cache_hits", 0)
    assert h1 == h0 + 1  # the whole second read was one cache hit
    flat_cold = [bytes(r) for c in cold for r in c]
    flat_warm = [bytes(r) for c in warm for r in c]
    assert flat_warm == flat_cold  # byte-identical second epoch


def test_cache_never_serves_stale_schema(tmp_path):
    import numpy as np

    from tensorflowonspark_torch.data import PartitionedDataset

    rows = [{"x": [float(i)], "y": i} for i in range(32)]
    schema = dfutil.save_as_tfrecords(
        PartitionedDataset.from_partitions([rows]), str(tmp_path / "ex"))
    paths = dfutil.shard_files(str(tmp_path / "ex"))
    cache = ChunkCache(1 << 20)

    def read_with(sch):
        pipeline = ReaderPipeline(readers=0, chunk_records=16, cache=cache,
                                  schema=sch)
        pipeline.submit(paths[0])
        pipeline.close()
        return _drain_pipeline(pipeline)

    full = read_with(schema)
    assert all(hasattr(c, "columns") for c in full)
    # a REDECLARED schema (subset of columns) must miss and re-decode:
    # serving the cached two-column chunks would resurrect the old layout
    narrowed = dfutil.Schema([c for c in schema.columns if c.name == "y"])
    narrow = read_with(narrowed)
    assert all(set(c.columns) == {"y"} for c in narrow)
    ys = np.concatenate([np.asarray(c.columns["y"]) for c in narrow])
    assert sorted(int(v) for v in ys) == list(range(32))


def test_cache_tee_abandons_over_budget_items_midread(tmp_path):
    """A work item whose decoded bytes exceed the whole cache budget must
    still DELIVER all its chunks, but the tee abandons its materialized
    copies the moment the running total crosses the budget — never holding
    a full shard's copy just for put() to reject it."""
    paths, _ = _write_shards(tmp_path / "d", num_shards=1, per_shard=64,
                             prefix="a-longer-record-payload")
    cache = ChunkCache(64)  # far under one shard's payload
    pipeline = ReaderPipeline(readers=0, chunk_records=8, cache=cache,
                              zerocopy="0")
    pipeline.submit(paths[0])
    pipeline.close()
    chunks = _drain_pipeline(pipeline)
    assert sum(len(c) for c in chunks) == 64  # delivery unaffected
    assert cache.stats()["entries"] == 0      # nothing admitted


def test_cache_inactive_with_record_decode_callable(tmp_path):
    paths, _ = _write_shards(tmp_path / "d", num_shards=1, per_shard=8)
    cache = ChunkCache(1 << 20)
    pipeline = ReaderPipeline(readers=0, chunk_records=8, cache=cache,
                              decode=lambda b: b.upper())
    pipeline.submit(paths[0])
    pipeline.close()
    chunks = _drain_pipeline(pipeline)
    assert chunks and chunks[0][0].startswith(b"REC")
    # the decoder's identity cannot be keyed: nothing was cached
    assert cache.stats()["entries"] == 0


def test_sync_pipeline_drain_race_never_strands_injected_chunks():
    """The closed-branch drain race: a chunk inject()ed AFTER the consumer
    saw the out queue empty but BEFORE it read the closed flag must still
    be delivered — returning drained there silently loses records the
    worker already acked as delivered (the loss the tier's contract
    forbids).  The interleaving is forced deterministically by making the
    work-queue probe (the step between those two reads) perform the
    inject."""
    import queue as _queue
    from unittest import mock

    pipeline = ReaderPipeline(readers=0)
    pipeline.close()

    def _late_inject():
        pipeline.inject([b"late"], None)
        raise _queue.Empty

    with mock.patch.object(pipeline._work, "get_nowait",
                           side_effect=_late_inject):
        item = pipeline.get(timeout=0.1)
    assert item == [b"late"]
    # the rest drains through subsequent calls: ShardDone, then drained
    assert hasattr(pipeline.get(timeout=0.1), "path")
    assert pipeline.get(timeout=0.1) is None


# -- pure-consumer feed (DecodedChunk injection) ------------------------------


def test_ingest_feed_consumes_forwarded_chunks_with_watermark():
    queues = FeedQueues(("input",), capacity=32)
    q = queues.get_queue("input")
    q.put(DecodedChunk([b"a", b"b"], source=("p", None, None)))
    q.put(DecodedChunk([b"c"]))
    q.put(EndPartition(key=(0, 0, 0)))
    q.put(DecodedChunk([b"d", b"e"]))
    q.put(EndPartition(key=(0, 0, 1)))
    q.put(EndOfFeed())
    feed = IngestFeed(queues, readers=0)
    got = []
    while not feed.should_stop():
        got.extend(bytes(r) for r in feed.next_batch(2))
    assert got == [b"a", b"b", b"c", b"d", b"e"]
    # both ledger partitions reported consumed, each exactly once
    assert queues.partitions_consumed("input") == 2


def test_next_chunk_hands_whole_chunks_and_lags_watermark(tmp_path):
    paths, _ = _write_shards(tmp_path / "d", num_shards=2, per_shard=10)
    queues = FeedQueues(("input",), capacity=32)
    q = queues.get_queue("input")
    q.put(paths[0])
    q.put(EndPartition(key=(0, 0)))
    q.put(paths[1])
    q.put(EndPartition(key=(0, 1)))
    q.put(EndOfFeed())
    feed = IngestFeed(queues, readers=0, chunk_records=5, zerocopy="0")
    chunks = []
    while True:
        c = feed.next_chunk()
        if c is None:
            break
        chunks.append(c)
    assert [len(c) for c in chunks] == [5, 5, 5, 5]
    assert queues.partitions_consumed("input") == 2
    assert feed.should_stop()


# -- in-process service e2e ---------------------------------------------------


def _trainer(capacity=64, authkey=b"k"):
    queues = FeedQueues(capacity=capacity)
    server = DataServer(queues, authkey, feed_timeout=60.0)
    return queues, server, server.start()


def test_service_forwards_exact_coverage_and_watermark(tmp_path):
    paths, expected = _write_shards(tmp_path / "d", num_shards=3,
                                    per_shard=50)
    authkey = b"k"
    tq, tserver, tport = _trainer(authkey=authkey)
    wq = FeedQueues(capacity=64)
    wserver = DataServer(wq, authkey, feed_timeout=60.0)
    wport = wserver.start()
    svc = IngestService(wq, [(0, "127.0.0.1", tport)], authkey,
                        chunk_records=16, readers=0, cache_bytes=1 << 20)
    out: dict = {}
    t = threading.Thread(target=lambda: out.update(svc.run()), daemon=True)
    t.start()
    driver = DataClient("127.0.0.1", wport, authkey, chunk_size=8)
    try:
        assert driver.feed_partition(paths, task_key=(0, 0)) == "running"
        driver.send_eof()
        t.join(30.0)
        assert not t.is_alive()
        assert out["rows"] == len(expected)
        # the worker's consumption watermark advanced only after delivery
        assert wq.partitions_consumed("input") == 1
        tdrv = DataClient("127.0.0.1", tport, authkey)
        tdrv.send_eof()
        feed = IngestFeed(tq, readers=0)
        got = set()
        while not feed.should_stop():
            got.update(bytes(r).decode() for r in feed.next_batch(64))
        tdrv.close()
        assert got == expected
    finally:
        driver.close()
        tserver.stop()
        wserver.stop()


def test_global_shuffle_interleaves_all_trainers(tmp_path):
    paths, expected = _write_shards(tmp_path / "d", num_shards=4,
                                    per_shard=32)
    authkey = b"k"
    trainers = [_trainer(authkey=authkey) for _ in range(2)]
    wq = FeedQueues(capacity=64)
    wserver = DataServer(wq, authkey, feed_timeout=60.0)
    wport = wserver.start()
    svc = IngestService(wq, [(i, "127.0.0.1", t[2])
                             for i, t in enumerate(trainers)], authkey,
                        chunk_records=8, readers=0, shuffle=True)
    t = threading.Thread(target=svc.run, daemon=True)
    t.start()
    driver = DataClient("127.0.0.1", wport, authkey, chunk_size=8)
    try:
        driver.feed_partition(paths, task_key=(0, 0))
        driver.send_eof()
        t.join(30.0)
        per_trainer = []
        for tq, tserver, tport in trainers:
            tdrv = DataClient("127.0.0.1", tport, authkey)
            tdrv.send_eof()
            feed = IngestFeed(tq, readers=0)
            got = set()
            while not feed.should_stop():
                got.update(bytes(r).decode() for r in feed.next_batch(64))
            tdrv.close()
            per_trainer.append(got)
        assert per_trainer[0] | per_trainer[1] == expected
        # GLOBAL shuffle: every trainer's stream interleaves chunks from
        # every shard (4 shards x 4 chunks each, dealt round-robin)
        for got in per_trainer:
            shards_seen = {rec.split("-")[1] for rec in got}
            assert shards_seen == {"0", "1", "2", "3"}
    finally:
        driver.close()
        wserver.stop()
        for _, tserver, _ in trainers:
            tserver.stop()


def test_shuffle_off_pins_worker_to_one_trainer(tmp_path):
    paths, expected = _write_shards(tmp_path / "d", num_shards=2,
                                    per_shard=16)
    authkey = b"k"
    trainers = [_trainer(authkey=authkey) for _ in range(2)]
    wq = FeedQueues(capacity=64)
    wserver = DataServer(wq, authkey, feed_timeout=60.0)
    wport = wserver.start()
    svc = IngestService(wq, [(i, "127.0.0.1", t[2])
                             for i, t in enumerate(trainers)], authkey,
                        chunk_records=8, readers=0, shuffle=False,
                        rr_offset=1)
    t = threading.Thread(target=svc.run, daemon=True)
    t.start()
    driver = DataClient("127.0.0.1", wport, authkey, chunk_size=8)
    try:
        driver.feed_partition(paths, task_key=(0, 0))
        driver.send_eof()
        t.join(30.0)
        # locality mode: rr_offset=1 pins everything to trainer 1
        counts = []
        for tq, tserver, tport in trainers:
            tdrv = DataClient("127.0.0.1", tport, authkey)
            tdrv.send_eof()
            feed = IngestFeed(tq, readers=0)
            got = set()
            while not feed.should_stop():
                got.update(bytes(r).decode() for r in feed.next_batch(64))
            tdrv.close()
            counts.append(got)
        assert counts[0] == set()
        assert counts[1] == expected
    finally:
        driver.close()
        wserver.stop()
        for _, tserver, _ in trainers:
            tserver.stop()


# -- full-cluster e2e ---------------------------------------------------------


def test_cluster_with_ingest_tier_exact_coverage(tmp_path):
    data_dir = str(tmp_path / "data")
    _, expected = _write_shards(data_dir, num_shards=4, per_shard=40)
    out_dir = str(tmp_path / "out")
    os.makedirs(out_dir)
    cluster = tcluster.run(
        torch_mapfuns.direct_record_counter, {"out_dir": out_dir},
        num_executors=1, input_mode=tcluster.InputMode.DIRECT,
        ingest_workers=1, ingest_opts={"cache_bytes": 1 << 20},
        log_dir=str(tmp_path / "logs"))
    try:
        roles = {m["executor_id"]: m["job_name"]
                 for m in cluster.cluster_info}
        assert roles == {0: "chief", 1: "ingest"}
        assert cluster.num_ingest() == 1
        cluster.train(data_dir, num_epochs=1)
        manifest = cluster.coordinator.manifest_state()
        assert manifest["ingest"]["workers"] == 1
        # the manifest reports the tier's REAL configuration: the
        # ingest_opts override, not the (unset) env knob's default
        assert manifest["ingest"]["cache_bytes"] == 1 << 20
        # streams appear with heartbeat metric deltas: poll briefly (the
        # train itself can finish inside one heartbeat interval)
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            stats = cluster.stats(30.0)
            if ("1" in stats["ingest"]["workers"]
                    and stats["ingest"]["trainers_reporting"] >= 1):
                break
            time.sleep(0.5)
        assert "1" in stats["ingest"]["workers"]
        assert stats["ingest"]["trainers_reporting"] == 1
    finally:
        cluster.shutdown()
    seen = set()
    for f in glob.glob(os.path.join(out_dir, "seen_*.txt")):
        seen.update(line for line in open(f).read().splitlines() if line)
    assert seen == expected


def test_run_rejects_ingest_workers_outside_direct():
    with pytest.raises(ValueError, match="InputMode.DIRECT"):
        tcluster.run(torch_mapfuns.noop, None, num_executors=1,
                     input_mode=tcluster.InputMode.STREAMING,
                     ingest_workers=1)
    with pytest.raises(ValueError, match="torch_distributed"):
        tcluster.run(torch_mapfuns.noop, None, num_executors=1,
                     input_mode=tcluster.InputMode.DIRECT,
                     torch_distributed=True, ingest_workers=1)


def test_resize_ingest_refused_on_streaming_cluster():
    """resize_ingest must enforce the same precondition run() does:
    STREAMING clusters produce no shard items, so workers spawned there
    would poll an empty ledger feed forever."""
    cluster = tcluster.run(torch_mapfuns.noop, None, num_executors=1,
                           input_mode=tcluster.InputMode.STREAMING)
    try:
        with pytest.raises(RuntimeError, match="InputMode.DIRECT"):
            cluster.resize_ingest(1)
    finally:
        cluster.shutdown()


# -- chaos --------------------------------------------------------------------


@pytest.mark.chaos
def test_chaos_sigkill_ingest_worker_midspan_recovers(tmp_path, monkeypatch):
    """SIGKILL an ingest worker mid-span: the ledger re-assigns its unacked
    items, the supervisor replaces the worker, distinct record coverage
    stays exact, and the TRAINER never restarts."""
    monkeypatch.setenv("TOS_RECOVERY_TIMEOUT", "60")
    data_dir = str(tmp_path / "data")
    _, expected = _write_shards(data_dir, num_shards=6, per_shard=30)
    out_dir = str(tmp_path / "out")
    os.makedirs(out_dir)
    cluster = tcluster.run(
        torch_mapfuns.direct_record_counter, {"out_dir": out_dir},
        num_executors=1, input_mode=tcluster.InputMode.DIRECT,
        ingest_workers=1, elastic=True, heartbeat_interval=0.5,
        log_dir=str(tmp_path / "logs"),
        env={"TOS_FAULTINJECT":
             "kill:after_batches=3,role=ingest,incarnation=0",
             "TOS_DEAD_NODE_TIMEOUT": "3"})
    try:
        cluster.train(data_dir, num_epochs=1)
        # the worker slot restarted (incarnation bumped past the kill)...
        assert cluster.coordinator.registered_incarnation(1)[0] >= 1
        assert cluster.supervisor.restart_count(1) >= 1
    finally:
        cluster.shutdown()
    seen = set()
    trainer_files = glob.glob(os.path.join(out_dir, "seen_0_*.txt"))
    for f in glob.glob(os.path.join(out_dir, "seen_*.txt")):
        seen.update(line for line in open(f).read().splitlines() if line)
    # ...while the trainer never did: one incarnation-0 coverage file only
    assert trainer_files == [os.path.join(out_dir, "seen_0_inc0.txt")]
    assert seen >= expected  # at-least-once: duplicates allowed, loss never
    assert seen == expected | seen


@pytest.mark.chaos
def test_chaos_severed_chunk_stream_reroutes(tmp_path):
    """Sever a trainer<->ingest-worker chunk stream (the trainer's data
    server drops the chunk_fwd connection with no reply): the forwarder
    re-dials/re-routes, no record is lost, and the trainer never wedges."""
    data_dir = str(tmp_path / "data")
    _, expected = _write_shards(data_dir, num_shards=4, per_shard=30)
    out_dir = str(tmp_path / "out")
    os.makedirs(out_dir)
    cluster = tcluster.run(
        torch_mapfuns.direct_record_counter, {"out_dir": out_dir},
        num_executors=1, input_mode=tcluster.InputMode.DIRECT,
        ingest_workers=1, log_dir=str(tmp_path / "logs"),
        # the chief (trainer) severs its 2nd data-carrying op — with the
        # tier live, every data op the trainer's server sees is a
        # chunk_fwd from the worker
        env={"TOS_FAULTINJECT": "sever:after_data_ops=2,role=chief"})
    try:
        t0 = time.monotonic()
        cluster.train(data_dir, num_epochs=1)
        assert time.monotonic() - t0 < 60.0  # no wedge, no stall-out
    finally:
        cluster.shutdown()
    # asserted AFTER shutdown: the final deregister snapshot is what ships
    # counters a sub-heartbeat-interval run never got to piggyback
    metrics = cluster.metrics()
    assert metrics["counters"].get("ingest.forward_errors", 0) >= 1
    assert metrics["counters"].get("faultinject.injected.sever", 0) >= 1
    seen = set()
    for f in glob.glob(os.path.join(out_dir, "seen_*.txt")):
        seen.update(line for line in open(f).read().splitlines() if line)
    assert seen >= expected


# -- ingest autoscaling -------------------------------------------------------


def test_ingest_backlog_policy_scales_on_starvation():
    policy = IngestBacklogPolicy(min_rows_per_sec=10.0)
    starved = {"ingest": {"workers": {"2": {"forwarded_rows_per_s": 50.0}},
                          "starved_trainers": 1}}
    idle = {"ingest": {"workers": {"2": {"forwarded_rows_per_s": 1.0}},
                       "starved_trainers": 0}}
    steady = {"ingest": {"workers": {"2": {"forwarded_rows_per_s": 50.0}},
                         "starved_trainers": 0}}
    vacuum: dict = {"ingest": {"workers": {}}}
    # "starved" trainers with the pool completely idle = no train in
    # flight (an idle feed's queue gauge also reads 0): must not grow
    idle_starved = {"ingest": {"workers": {"2": {"forwarded_rows_per_s": 0.0}},
                               "starved_trainers": 2}}
    assert policy.desired(starved, 2) == 3
    assert policy.desired(idle, 2) == 1
    assert policy.desired(steady, 2) == 2
    assert policy.desired(vacuum, 2) == 2  # never scale on no signal
    assert policy.desired(idle_starved, 2) == 1  # shrink, never grow


def test_autoscaler_ingest_tier_actuates_resize_ingest():
    class _FakeCluster:
        def __init__(self):
            self.workers = 1
            self.calls: list = []

        def stats(self, window):
            return {"ingest": {"workers": {"1": {"forwarded_rows_per_s": 5.0}},
                               "starved_trainers": 1}}

        def num_ingest(self):
            return self.workers

        def num_feedable(self):
            raise AssertionError("ingest tier must not read trainer count")

        def resize_ingest(self, n, drain_timeout=None):
            self.calls.append(n)
            self.workers = n
            return {"action": "scale_out", "tier": "ingest", "to": n}

    fake = _FakeCluster()
    scaler = Autoscaler(fake, tier="ingest", min_nodes=1, max_nodes=4,
                        tick_secs=60.0, cooldown_secs=0.0)
    decision = scaler.tick()
    assert decision["action"] == "scale_out"
    assert decision["tier"] == "ingest"
    assert fake.calls == [2]
    assert scaler.report()["tier"] == "ingest"


# -- chip_smoke's ingest phase, shrunk onto the CPU ---------------------------


def test_chip_smoke_ingest_phase_runs_on_cpu(monkeypatch, tmp_path):
    """``chip_smoke.phase_ingest_resnet50`` at a few images of 32 px with a
    narrow ``resnet_cifar``: node-local readers (run A) and one
    data-service worker over two epochs (run B), with the phase's own
    gates — exact coverage per epoch, the replayed losses, the worker's
    CUDA state, epoch 2 from the chunk cache."""
    import chip_smoke as cs

    monkeypatch.setattr(cs, "WORK_DIR", str(tmp_path))
    monkeypatch.setattr(cs, "RESNET_CONFIG", {"model": "resnet_cifar", "depth_blocks": 1,
                                              "width": 8, "num_classes": 10, "bf16": False})
    monkeypatch.setattr(cs, "RESNET_BATCH", 16)
    monkeypatch.setattr(cs, "RESNET_SIZE", 32)
    monkeypatch.setattr(cs, "INGEST_IMAGES", 96)
    monkeypatch.setattr(cs, "INGEST_PER_SHARD", 24)
    out = cs.phase_ingest_resnet50(0, "cpu", None, device="cpu")
    a, b = out["runs"]["A"], out["runs"]["B"]
    assert len(out["runs"]["A untraced"]["losses"]) == len(a["losses"]) == 6
    # the node and this process: the same CPU arithmetic on the same batches
    assert a["replay_losses"] == pytest.approx(a["losses"][:3], rel=1e-5)
    assert len(b["losses"]) == 12 and b["cache_hits"] >= 1
    assert b["worker_cuda_visible_devices"] == "" and b["worker_device"]["platform"] == "cpu"
    assert a["epoch1"]["steps"] == b["epoch2"]["steps"] == 4
