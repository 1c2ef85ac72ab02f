"""Central registry of every ``TOS_*`` tuning knob.

One row per knob: name, type, documented default, and a one-line operator
docstring.  This is the single source of truth that

- ``utils/envtune`` warns against at read time (an ``env_*`` call on an
  unregistered ``TOS_*`` name is a knob that ops cannot discover);
- the ``knob-discipline`` checker in ``tensorflowonspark_torch.analysis``
  cross-checks statically: every knob read in the tree must be registered
  here, every registered knob must be read somewhere, and the port's
  "Tuning knobs" table in README must match ``knob_table_markdown()``
  exactly (regenerate with ``python -m tensorflowonspark_torch.analysis
  --write-knob-table``).

Defaults are *rendered* strings — some real defaults are computed (e.g.
``TOS_DEAD_NODE_TIMEOUT``), and the registry documents what ops should
expect, not a value the runtime reads back.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    kind: str  # "float" | "int" | "str" | "bool"
    default: str  # rendered default, as documented to operators
    doc: str  # one-line operator-facing description


_ALL = (
    Knob("TOS_AUTOSCALE", "bool", "1",
         "Autoscaler kill switch: 0 makes cluster.autoscale() a no-op "
         "(cluster.resize() stays available for manual scaling)."),
    Knob("TOS_AUTOSCALE_COOLDOWN_SECS", "float", "30",
         "Autoscaler hysteresis: hold window after any scale action before "
         "the next one may fire (cooldown_hold decisions)."),
    Knob("TOS_AUTOSCALE_MAX", "int", "8",
         "Autoscaler upper bound on feedable node count (policy desired "
         "counts are clamped into [MIN, MAX])."),
    Knob("TOS_AUTOSCALE_MIN", "int", "1",
         "Autoscaler lower bound on feedable node count."),
    Knob("TOS_AUTOSCALE_TICK_SECS", "float", "5",
         "Autoscaler cadence: seconds between policy decision cycles "
         "(each tick samples cluster.stats over ~2 ticks of window)."),
    Knob("TOS_COLLECTIVE_ALGO", "str", "ring",
         "Cross-host collective all-reduce algorithm: 'ring' (bandwidth-"
         "optimal chunked ring) or 'naive' (gather-broadcast through rank "
         "0 — the bench control and tiny-payload fallback)."),
    Knob("TOS_COLLECTIVE_BUCKET_BYTES", "int", "4194304 (4 MiB)",
         "Cross-host collectives: gradient-bucket / wire-chunk size — "
         "pytree leaves pack into buckets of this many bytes (each bucket "
         "reduced as it fills, overlapping communication with host "
         "transfer), and ring transfers sub-chunk to it."),
    Knob("TOS_COLLECTIVE_EVICT_QUORUM", "int", "0 (majority of survivors)",
         "Gray-failure eviction: distinct survivor suspicion votes "
         "(transitive blame resolved) required before the coordinator "
         "evicts a straggling collective member; 0 derives a majority of "
         "the formation's survivors."),
    Knob("TOS_COLLECTIVE_MIN_WORLD", "int", "1",
         "Gray-failure eviction floor: an eviction that would shrink a "
         "collective group's effective world below this is refused (the "
         "group then rides the collective timeout instead)."),
    Knob("TOS_COLLECTIVE_PROBATION_SECS", "float", "30",
         "How long an evicted (slow-but-alive) collective member stays "
         "benched before its continuing heartbeats readmit it; the group "
         "grows back at its next generation barrier."),
    Knob("TOS_COLLECTIVE_SUSPECT_FACTOR", "float", "8",
         "Straggler detection: a peer-plane receive wait running this many "
         "times past the rolling typical wait files a suspicion vote "
         "(floored at 0.5s, capped at a quarter of the collective timeout; "
         "relative, so uniform slowness never flags anyone)."),
    Knob("TOS_COLLECTIVE_TIMEOUT", "float", "120",
         "Budget (seconds) for one cross-host collective exchange and for "
         "the group-formation rendezvous window; expiry poisons the round "
         "(CollectiveAborted) instead of wedging the trainer."),
    Knob("TOS_CONNECT_ATTEMPTS", "int", "3",
         "Dial attempts (with backoff + jitter) for control/data-plane "
         "clients before a connection error surfaces."),
    Knob("TOS_COORDINATOR_GRACE_SECS", "float",
         "max(12, 6 x heartbeat_interval)",
         "Node-side self-fence: heartbeat silence (seconds) after which a "
         "node stops accepting new ledger work and PARKS (a replacement "
         "may own its slot); at 4x this budget the node gives up and "
         "exits.  A supervised coordinator restart re-admits parked nodes "
         "on the next successful ping."),
    Knob("TOS_COORDINATOR_HOST", "str", "(bind all, advertise local_ip())",
         "Interface an *authenticated* coordinator binds and advertises; "
         "ignored without an authkey (loopback-only then)."),
    Knob("TOS_DEAD_NODE_TIMEOUT", "float", "max(12, 6 x heartbeat_interval)",
         "Heartbeat silence (seconds) after which the driver monitor "
         "declares a node dead."),
    Knob("TOS_DRAIN_STALL_TIMEOUT", "float", "300",
         "Elastic train() tail drain: stop waiting for buffered partitions "
         "after this long without consumption progress."),
    Knob("TOS_DRAIN_TIMEOUT", "float", "60",
         "cluster.resize scale-in: budget for a victim to drain (serving "
         "in-flight + buffered partitions) and exit after EOF before the "
         "reaper escalates to terminate."),
    Knob("TOS_EMBED_CKPT_EVERY", "int", "0 (disabled)",
         "Sharded embedding tier: checkpoint each node's resident shard "
         "range every N training steps (ShardedTable.maybe_checkpoint); "
         "0 leaves durability to explicit checkpoint() calls."),
    Knob("TOS_EMBED_DEDUP", "bool", "1",
         "Sharded embedding tier: 1 dedups a batch's flat ids (np.unique) "
         "before the lookup exchange so each unique row crosses the wire "
         "once; 0 ships per-position ids verbatim (debug / tiny batches)."),
    Knob("TOS_EMBED_LOOKUP_TIMEOUT", "float", "30",
         "Serving-side sharded embeddings: budget (seconds) for one "
         "fan-out lookup round against the replica shards before the "
         "request errors."),
    Knob("TOS_EOF_TIMEOUT", "float", "20",
         "Budget (seconds) for the teardown-path EndOfFeed round-trip to "
         "each node."),
    Knob("TOS_FAULTINJECT", "str", "(unset: disabled)",
         "Deterministic chaos-hook spec (kill / drop_heartbeats / sever); "
         "see faultinject.py for the grammar."),
    Knob("TOS_FEED_TIMEOUT", "float", "600",
         "How long one driver feed call may block against a node whose "
         "consumer has stalled."),
    Knob("TOS_FS_ROOTS", "str", "(unset: no mappings)",
         "scheme=root remote-filesystem mappings (os.pathsep-separated) "
         "carrying register_fs_root() into node processes."),
    Knob("TOS_INGEST_CACHE_BYTES", "int", "0 (disabled)",
         "Data-service tier: cross-epoch decoded-chunk cache budget per "
         "ingest worker (payload bytes, LRU); repeated-epoch reads of the "
         "same shard span + schema serve from memory instead of "
         "re-decoding.  0 disables the cache."),
    Knob("TOS_INGEST_SHUFFLE", "bool", "1",
         "Data-service tier: 1 deals each worker's decoded chunks "
         "round-robin across ALL trainers (global shuffle — every "
         "trainer's stream interleaves every shard the pool claims); 0 "
         "pins each worker to one trainer (locality mode)."),
    Knob("TOS_INGEST_WORKERS", "int", "0 (node-local ingest)",
         "Data-service tier size: cluster.run() default for the number of "
         "standalone ingest-worker nodes (role='ingest') that claim the "
         "DIRECT-mode ledger's shard items, decode on their own cores, "
         "and stream chunks to trainers; 0 keeps decode node-local."),
    Knob("TOS_LOCK_WITNESS", "str", "0 (off)",
         "Runtime lock witness (tossan): 1/raise records per-thread "
         "held-sets + the global acquisition-order graph over every "
         "tos_named_lock and raises LockOrderError at acquire time on an "
         "order inversion; 'warn' records inversions without raising; 0 "
         "reduces the witness to a single attribute check per acquire."),
    Knob("TOS_LOCK_STALL_SECS", "float", "5",
         "Lock witness stall budget: a witnessed acquire that has waited "
         "this long dumps all-thread stacks to the flight recorder "
         "(lock_stall event) once per wait episode."),
    Knob("TOS_INGEST_AUTOTUNE", "bool", "1",
         "DIRECT-mode ingest: autotune reader parallelism from decode-queue "
         "occupancy (start at 1, grow while the consumer starves, shrink "
         "when readers saturate); 0 pins TOS_INGEST_READERS threads."),
    Knob("TOS_INGEST_PREFETCH", "int", "8",
         "DIRECT-mode ingest: decoded-chunk prefetch depth (bounded queue "
         "capacity) between the shard readers and the consuming map_fun."),
    Knob("TOS_INGEST_READERS", "int", "4",
         "DIRECT-mode ingest: parallel shard-reader threads per node (the "
         "autotune ceiling; exact pool size when TOS_INGEST_AUTOTUNE=0; "
         "0 = synchronous in-consumer reads, zero pipeline threads)."),
    Knob("TOS_INGEST_SPAN_BYTES", "int", "268435456 (256 MiB)",
         "DIRECT-mode ingest: plain (non-gzip) shards larger than this "
         "split into record-aligned sub-shard work items so N nodes "
         "parallelize inside one multi-GB shard; 0 keeps shards whole."),
    Knob("TOS_INGEST_ZEROCOPY", "str", "1",
         "DIRECT-mode ingest zero-copy record views: 1 delivers records "
         "as memoryview slices of the shard buffer (valid until the batch "
         "retires), 0 restores bytes copies, 'debug' releases retired "
         "batches' views so a retained view fails loudly."),
    Knob("TOS_MAX_PARTITION_ATTEMPTS", "int", "3",
         "Total feed attempts per partition (at-least-once ledger) before "
         "the job fails."),
    Knob("TOS_METRICS", "bool", "1",
         "Telemetry master switch: 0 makes every counter/gauge/histogram a "
         "no-op and stops the heartbeat metric piggyback."),
    Knob("TOS_METRICS_EXPORT_SECS", "float", "30",
         "Cadence of the driver's periodic aggregated-metrics export to "
         "TensorBoard scalars (written under <log_dir>/metrics)."),
    Knob("TOS_RUN_REPORT", "bool", "1",
         "Write the end-of-run JSON run report (run_report.json in the "
         "cluster log_dir) at shutdown; needs TOS_METRICS on."),
    Knob("TOS_MAX_RESTARTS", "int", "2",
         "Supervised restarts allowed per executor slot before it is "
         "permanently failed."),
    Knob("TOS_RECOVERY_TIMEOUT", "float", "90",
         "How long the partition ledger waits for a dead slot to come back "
         "before failing the job."),
    Knob("TOS_REREGISTER_TIMEOUT", "float", "60",
         "Window a respawned replacement gets to re-register before the "
         "supervisor counts another death."),
    Knob("TOS_RESERVATION_TIMEOUT", "float", "120",
         "How long the driver waits for all nodes to register at startup."),
    Knob("TOS_RESTART_BACKOFF_BASE", "float", "0.5",
         "Supervised-restart backoff: delay before the first restart "
         "(seconds)."),
    Knob("TOS_RESTART_BACKOFF_FACTOR", "float", "2.0",
         "Supervised-restart backoff: multiplier per successive restart."),
    Knob("TOS_RESTART_BACKOFF_MAX", "float", "10.0",
         "Supervised-restart backoff: cap on the per-restart delay "
         "(seconds)."),
    Knob("TOS_RING_PROBE_BYTES", "int", "65536",
         "Payload size for the one-shot ring-vs-loopback transport probe "
         "(cached per process; see TOS_SHM_RING)."),
    Knob("TOS_SEND_WINDOW", "int", "4",
         "Pipelined feed: max unacknowledged chunk frames in flight per "
         "node connection (1 = strict request/reply ping-pong)."),
    Knob("TOS_SENDER_POOL", "int", "0 (one sender per node)",
         "Cap on concurrent chunk SENDS across all node connections in "
         "train()/inference() (permit per chunk, never held across a "
         "partition); 0 = unlimited."),
    Knob("TOS_SERVE_CLIENT_SLACK", "float", "30",
         "GatewayClient reply-reaper backstop: extra seconds past the "
         "server-enforced request deadline before an unanswered reply "
         "marks the connection dead (the client then poisons it)."),
    Knob("TOS_SERVE_CONN_OUTSTANDING", "int", "128",
         "Serving frontend: max pipelined requests outstanding per client "
         "connection; excess requests get the fast-fail 'unavailable' "
         "reply instead of queuing."),
    Knob("TOS_SERVE_HANDSHAKE_TIMEOUT", "float", "5",
         "Serving frontend: seconds a new connection may take to finish "
         "the HMAC handshake before the reactor reaps it (slow-loris "
         "protection)."),
    Knob("TOS_SERVE_SWITCH_INTERVAL", "float", "1 (milliseconds)",
         "GIL switch interval (ms) the serving frontend sets for the "
         "driver process while the reactor runs; CPython's 5ms default "
         "convoys reactor/batcher/router handoffs (pass 5 to opt out)."),
    Knob("TOS_SERVE_CANARY_PCT", "int", "25",
         "Staged rollout default: percent of live traffic routed to the "
         "canary cohort by gateway.rollout() when canary_pct is not "
         "passed (shadow rollouts mirror this percent instead)."),
    Knob("TOS_SERVE_ROLLOUT_WINDOW_SECS", "float", "5",
         "Rollout governor cadence: sliding-window length (seconds) over "
         "which canary error-rate/p99/divergence are compared against the "
         "primary baseline before promote/rollback fires."),
    Knob("TOS_SERVE_TENANT_RATE", "float", "0 (unlimited)",
         "Per-tenant admission rate limit: rows/second of token-bucket "
         "budget per unit of tenant weight (1s of burst capacity); a "
         "tenant over its bucket gets fast-fail ServeThrottled replies "
         "while other tenants keep their latency.  0 disables rate "
         "limiting."),
    Knob("TOS_SERVE_SHED_LADDER", "str", "0.5,0.8",
         "Brownout ladder: comma-separated admission-queue occupancy "
         "fractions at which overload shedding escalates — level 1 pauses "
         "shadow-mirror traffic, level 2 sheds tenants past their "
         "weight-proportional queue share (lowest-weight overage first), "
         "before the queue-full cliff (ServeQueueFull) at 100%."),
    Knob("TOS_SERVE_QUEUE", "int", "256",
         "Serving gateway admission control: max queued (not yet "
         "dispatched) predict requests before fast-fail rejection "
         "(ServeQueueFull, the wire 'unavailable' error)."),
    Knob("TOS_SERVE_MAX_BATCH", "int", "64",
         "Serving micro-batcher: rows coalesced into one batch — also the "
         "static batch shape every batch is padded to, so the node's "
         "jitted apply compiles once."),
    Knob("TOS_SERVE_MAX_DELAY_MS", "float", "5",
         "Serving micro-batcher: max milliseconds the oldest queued "
         "request waits for co-riders before a partial batch is flushed."),
    Knob("TOS_SERVE_TIMEOUT", "float", "30",
         "Default per-request deadline (seconds) for gateway predict "
         "calls; expired requests are answered with ServeTimeout."),
    Knob("TOS_SHM_RING", "str", "(unset: measured probe decides)",
         "Same-host shared-memory ring for the data plane: 1 forces it on, "
         "0 forces TCP, unset lets a one-shot ring-vs-loopback probe pick "
         "the faster transport."),
    Knob("TOS_SHUTDOWN_TIMEOUT", "float", "120",
         "Budget for shutdown() to join node processes before escalating "
         "to terminate/kill."),
    Knob("TOS_TRACE", "bool", "0",
         "Distributed request tracing master switch: 1 records sampled "
         "spans into per-thread rings, ships them on heartbeats, and "
         "writes trace_*.json + a merged Perfetto trace.json at shutdown."),
    Knob("TOS_TRACE_SAMPLE", "float", "0.01",
         "Trace sampling rate in (0, 1]: every round(1/rate)-th root "
         "(request / train partition) is traced, deterministically "
         "(counter-based, not random); 1 traces everything."),
    Knob("TOS_FLIGHT_EVENTS", "int", "256",
         "Flight-recorder ring capacity per process (structured "
         "death/restart/retry/resync/reload/fault events, independent of "
         "TOS_TRACE); 0 disables the recorder."),
)

KNOBS: dict[str, Knob] = {k.name: k for k in _ALL}

# README block delimiters; knob_table_markdown() emits the table BETWEEN
# these, and the knob-discipline checker requires the block to match.
# The port's table has markers of its own, so that its --write-knob-table
# never rewrites the JAX package's block of the same README.
TABLE_BEGIN = "<!-- torch-knob-table:begin (generated; run `python -m tensorflowonspark_torch.analysis --write-knob-table`) -->"
TABLE_END = "<!-- torch-knob-table:end -->"


def find_table_block(lines: list[str]) -> tuple[int, int] | None:
    """(begin, end) indices of the marker lines in README lines, else None.
    The one marker-locating implementation shared by the knob-discipline
    checker and ``--write-knob-table`` so the two can never drift."""
    try:
        return lines.index(TABLE_BEGIN), lines.index(TABLE_END)
    except ValueError:
        return None


def knob_table_markdown() -> str:
    """The generated README "Tuning knobs" table body (no markers)."""
    rows = ["| Knob | Type | Default | What it tunes |",
            "|---|---|---|---|"]
    for name in sorted(KNOBS):
        k = KNOBS[name]
        rows.append(f"| `{k.name}` | {k.kind} | `{k.default}` | {k.doc} |")
    return "\n".join(rows)
