"""Driver-side cluster lifecycle API — the ``TFCluster`` replacement.

Reference (``tensorflowonspark/TFCluster.py``): ``run()`` ``:~270-420`` builds
the role template, starts the reservation server, launches node closures on
executors, and returns a cluster handle with ``train`` ``:~70-130``,
``inference`` ``:~130-170``, ``shutdown`` ``:~170-240`` and
``tensorboard_url`` ``:~240-260``; ``InputMode`` at ``:~40``.

Counterpart of ``tensorflowonspark_tpu/cluster.py`` for the PyTorch / CUDA
port; its deltas from the reference (BASELINE.json:5, SURVEY.md §2.3):
- **No parameter servers.** ``num_ps`` is gone; async PS data parallelism is
  replaced by sync data parallelism (``torch.distributed`` across the data
  nodes when ``run(torch_distributed=True)``).  Roles are
  chief/worker/evaluator only.
- **Launcher abstraction** instead of Spark: ``SubprocessLauncher``
  (default) or ``LocalLauncher`` place node processes; partitions stream
  over the data plane (``dataserver.py``) rather than Spark feed tasks.
- ``InputMode.DIRECT`` (framework reads files itself — the reference's
  ``InputMode.TENSORFLOW``) vs ``InputMode.STREAMING`` (driver streams
  partitions — the reference's ``InputMode.SPARK``).  Aliases with the
  reference names are provided.
"""

from __future__ import annotations

import collections
import contextlib
import enum
import glob
import json
import logging
import os
import secrets
import threading
from tensorflowonspark_torch.utils.locks import tos_named_condition, tos_named_lock
import time
from typing import Any, Callable, Sequence

from tensorflowonspark_torch import telemetry
from tensorflowonspark_torch.coordinator import CoordinatorServer
from tensorflowonspark_torch.telemetry import trace as ttrace
from tensorflowonspark_torch.telemetry import trace_export as ttrace_export
from tensorflowonspark_torch.data import as_partitioned
from tensorflowonspark_torch.dataserver import DataClient
from tensorflowonspark_torch.launcher import (  # noqa: F401 - LocalLauncher re-exported
    LocalLauncher,
    SubprocessLauncher,
)
from tensorflowonspark_torch.node import NodeConfig
from tensorflowonspark_torch.supervisor import RestartPolicy, Supervisor
from tensorflowonspark_torch.utils.envtune import env_bool as _env_bool
from tensorflowonspark_torch.utils.envtune import env_float as _env_float
from tensorflowonspark_torch.utils.envtune import env_int as _env_int

logger = logging.getLogger(__name__)


class InputMode(enum.Enum):
    """Reference ``TFCluster.InputMode`` (``TFCluster.py:~40``).

    What each mode supports (this table matches runtime behavior — every
    mode-mismatch error names the mode that IS supported):

    ========================  =======================  ======================
    API                       DIRECT (≈ TENSORFLOW)    STREAMING (≈ SPARK)
    ========================  =======================  ======================
    ``train(data)``           ``data`` = shard path/   ``data`` = rows
                              glob/dir; the ledger     (PartitionedDataset /
                              feeds shard PATHS,       iterable); the driver
                              nodes read the bytes     streams every row
    ``ctx.get_data_feed()``   ``ingest.IngestFeed``    ``feeding.DataFeed``
                              (node-side readers)      (driver-streamed)
    ``inference()``           unsupported — use        supported (ordered,
                              STREAMING, or score      exactly-count)
                              via ``serve()``
    ``serve()``               supported                supported
    ========================  =======================  ======================

    DIRECT map_funs may also ignore the feed entirely and read files
    self-service (``dfutil.shard_files`` strided by ``ctx.executor_id`` —
    the ``examples/mnist/mnist_tfr.py`` idiom); the ledger-driven path feed
    is what adds at-least-once re-feed and elastic recovery on top.
    """

    DIRECT = 0      # nodes read sharded files themselves (reference: TENSORFLOW)
    STREAMING = 1   # driver streams partitions into node feeds (reference: SPARK)

    # Drop-in aliases for TensorFlowOnSpark users.
    TENSORFLOW = 0
    SPARK = 1


def _build_roles(num_executors: int, master_node: str | None, eval_node: bool) -> list[tuple[str, int]]:
    """Role template (reference ``TFCluster.py:~290-330``, minus ``ps``)."""
    roles: list[tuple[str, int]] = []
    chief_name = master_node or "chief"
    roles.append((chief_name, 0))
    num_workers = num_executors - 1 - (1 if eval_node else 0)
    if num_workers < 0:
        raise ValueError("num_executors too small for the requested roles")
    roles.extend(("worker", i) for i in range(num_workers))
    if eval_node:
        roles.append(("evaluator", 0))
    return roles


class _PartitionLedger:
    """Driver-side record of every (epoch, partition) a ``train()`` call must
    deliver: queued on its home slot, in flight on an executor, done, or
    abandoned.

    The reference got this bookkeeping from Spark's task scheduler — a dead
    executor's partition-feed task was simply rerun elsewhere (PAPER.md
    §5.3); with Spark gone the ledger reinstates it driver-side.  Placement
    stays the reference's deterministic round-robin (partition ``i`` belongs
    to feedable slot ``i % W``) while every slot is healthy; when a slot's
    feed fails, its unacknowledged task moves to a shared *orphan* pool that
    any worker — a surviving peer, or the slot's own supervised restart —
    drains once its home queue is empty.  Training is therefore
    at-least-once: a partition whose feed died mid-stream is re-fed from the
    top, and the consumer may see some of its items twice.

    An ack means ``feed_partition`` returned cleanly — the node BUFFERED the
    whole partition + its EndPartition marker, not that the map_fun consumed
    it.  A sudden death takes the queue's buffered tail down with it, so
    acked tasks stay on a per-slot *delivered* list until the node's
    consumption watermark (partitions whose EndPartition the map_fun popped,
    reported with each ack) passes them; when recovery observes an actual
    restart (fresh process, empty queues) the still-unconsumed window is
    re-delivered via ``requeue_unconsumed`` — duplicates allowed, loss not.
    The watermark baseline is conservative (first report after a (re)start
    anchors it), which can only over-requeue, never under.
    """

    def __init__(self, num_partitions: int, num_epochs: int, num_slots: int,
                 max_attempts: int = 3, journal_fn: Callable | None = None,
                 train_gen: int = 0):
        # Control-plane journal rider (ISSUE 13): assign/ack/requeue events
        # append to the coordinator's write-ahead journal so a postmortem
        # (or a future cold-start resume) can reconstruct exact partition
        # accounting across a control-plane failover.  ``journal_fn`` is a
        # callable returning the LIVE Journal (or None mid-crash) — the
        # instance is replaced by every recovery, so it is never cached.
        self._journal_fn = journal_fn
        self._train_gen = train_gen
        self._cond = tos_named_condition("cluster.ledger._cond")
        self._own = [
            collections.deque((e, p)
                              for e in range(num_epochs)
                              for p in range(pos, num_partitions, num_slots))
            for pos in range(num_slots)
        ]
        self._orphans: collections.deque = collections.deque()
        self._inflight: dict[int, tuple[int, int]] = {}
        # whether the slot's in-flight task came from the orphan pool: a
        # terminating consumer may forfeit its OWN share, but a dead peer's
        # requeued work is not its to drop (abandon_slot)
        self._inflight_orphan: dict[int, bool] = {}
        self._attempts: dict[tuple[int, int], int] = {}
        # buffered-on-the-node but not yet known-consumed, in feed order
        self._delivered: list[collections.deque] = [
            collections.deque() for _ in range(num_slots)]
        self._watermark: list[int | None] = [None] * num_slots
        self._outstanding = num_partitions * num_epochs
        self._failure: Exception | None = None
        # slots deliberately drained out mid-run (cluster.resize scale-in):
        # their next_task answers None even with work outstanding — the
        # home queue went to the orphan pool and survivors deliver it
        self._retired_slots: set[int] = set()
        self.max_attempts = max_attempts

    def _note(self, ev: str, pos: int | None, task: tuple | None = None,
              **extra) -> None:
        """Best-effort journal rider for one ledger event (caller may hold
        ``_cond``; the journal has its own lock).  Failures are logged and
        swallowed — the in-memory ledger stays authoritative for the run."""
        if self._journal_fn is None:
            return
        journal = self._journal_fn()
        if journal is None:
            return  # control plane mid-failover; the ledger itself survives
        try:
            # sync=False: ledger riders are flight evidence replay treats as
            # no-ops — an fsync here would serialize every feed worker on
            # disk flushes under the ledger condition for nothing recovery
            # needs (the next mutation append / snapshot flushes them)
            journal.append("ledger", {"ev": ev, "gen": self._train_gen,
                                      "slot": pos,
                                      "task": list(task) if task else None,
                                      **extra}, sync=False)
        except Exception:  # noqa: BLE001 - journaling must not break feeding
            logger.debug("ledger journal append failed", exc_info=True)

    def add_slot(self) -> int:
        """Admit one more feed slot mid-run (cluster.resize scale-out);
        returns its position.  The new slot starts with an empty home queue
        — call :meth:`rebalance_to` to shift pending work onto it, and it
        drains the shared orphan pool either way."""
        with self._cond:
            self._own.append(collections.deque())
            self._delivered.append(collections.deque())
            self._watermark.append(None)
            self._cond.notify_all()
            return len(self._own) - 1

    def rebalance_to(self, pos: int) -> int:
        """Move a fair share of still-queued (never-dispatched) home tasks
        from the most-loaded peers onto slot ``pos`` — how a scale-out
        newcomer gets work NOW instead of waiting for requeues.  Tasks are
        taken from the TAIL of peers' queues (their far-future work), so
        every slot keeps delivering its near-term partitions in order.
        Returns how many tasks moved."""
        with self._cond:
            total = sum(len(q) for q in self._own) + len(self._orphans)
            slots = len(self._own) - len(self._retired_slots)
            target = total // max(1, slots)
            moved = 0
            while len(self._own[pos]) < target:
                donor = max((i for i in range(len(self._own))
                             if i != pos and i not in self._retired_slots),
                            key=lambda i: len(self._own[i]), default=None)
                if donor is None or len(self._own[donor]) <= target:
                    break
                self._own[pos].append(self._own[donor].pop())
                moved += 1
            if moved:
                self._cond.notify_all()
            return moved

    def retire_slot(self, pos: int) -> int:
        """Scale-in: stop assigning slot ``pos`` new work and hand its
        still-queued home tasks to the orphan pool for survivors to deliver.
        Its in-flight task (if any) finishes normally, and its
        acked-but-unconsumed window drains through the usual watermark path
        (the node consumes its buffered queue in FIFO order before the
        retirement EOF reaches it).  Returns how many tasks moved."""
        with self._cond:
            moved = len(self._own[pos])
            self._orphans.extend(self._own[pos])
            self._own[pos].clear()
            self._retired_slots.add(pos)
            self._cond.notify_all()
            self._note("retire_slot", pos, moved=moved)
            return moved

    def slot_idle(self, pos: int) -> bool:
        """True when the slot has no queued home work and no in-flight feed
        — the point at which a retirement EOF cannot truncate a partition
        mid-stream (everything acked is fully buffered ahead of it)."""
        with self._cond:
            return not self._own[pos] and pos not in self._inflight

    def slot_retired(self, pos: int) -> bool:
        with self._cond:
            return pos in self._retired_slots

    def next_task(self, pos: int) -> tuple[int, int] | None:
        """Block until slot ``pos`` has work (home queue first, then orphans)
        or the feed is over; None means stop (all resolved, retired slot, or
        failed)."""
        with self._cond:
            while True:
                if self._failure is not None:
                    return None
                if pos in self._retired_slots:
                    return None
                if self._own[pos]:
                    task = self._own[pos].popleft()
                    self._inflight_orphan[pos] = False
                elif self._orphans:
                    task = self._orphans.popleft()
                    self._inflight_orphan[pos] = True
                elif self._outstanding == 0:
                    return None
                else:
                    # work may still be requeued by a failing peer
                    self._cond.wait(0.5)
                    continue
                self._inflight[pos] = task
                self._attempts[task] = self._attempts.get(task, 0) + 1
                self._note("assign", pos, task,
                           attempt=self._attempts[task])
                return task

    def attempts(self, task: tuple[int, int]) -> int:
        with self._cond:
            return self._attempts.get(task, 0)

    def ack(self, pos: int, consumed: int | None = None) -> None:
        """The slot's in-flight partition was fully BUFFERED on the node;
        ``consumed`` is the node's cumulative consumption watermark as of
        this ack (None when the node predates the watermark protocol)."""
        with self._cond:
            task = self._inflight.pop(pos, None)
            if task is not None:
                self._delivered[pos].append(task)
                self._outstanding -= 1
                self._cond.notify_all()
                self._note("ack", pos, task, consumed=consumed)
            self._advance_watermark_locked(pos, consumed)

    def update_watermark(self, pos: int, consumed: int | None) -> None:
        """Standalone watermark report (tail drain: the slot's feeds are all
        acked, the driver polls the node for consumption progress)."""
        with self._cond:
            self._advance_watermark_locked(pos, consumed)

    def _advance_watermark_locked(self, pos: int, consumed: int | None) -> None:
        if consumed is None:
            return
        if self._watermark[pos] is None or consumed < self._watermark[pos]:
            # first report since this (re)started process: anchor only —
            # the count may include consumption the ledger never saw
            # (an earlier train() on a reused cluster), so advancing on
            # it could drop un-consumed work
            self._watermark[pos] = consumed
            return
        delta = consumed - self._watermark[pos]
        self._watermark[pos] = consumed
        for _ in range(min(delta, len(self._delivered[pos]))):
            self._delivered[pos].popleft()

    def needs_drain(self, pos: int) -> bool:
        """True while the slot has acked-but-not-known-consumed partitions —
        work a sudden death would still take down with the node's queue."""
        with self._cond:
            return self._failure is None and bool(self._delivered[pos])

    def failed(self) -> bool:
        with self._cond:
            return self._failure is not None

    def requeue(self, pos: int) -> tuple[int, int] | None:
        """Return the slot's unacknowledged task to the orphan pool (any
        surviving or restarted worker may take it); returns that task."""
        with self._cond:
            task = self._inflight.pop(pos, None)
            if task is not None:
                self._orphans.append(task)
                self._cond.notify_all()
                self._note("requeue", pos, task)
            return task

    def requeue_unconsumed(self, pos: int) -> int:
        """The slot's process RESTARTED (fresh empty queues): every
        buffered-but-not-known-consumed task died with the predecessor's
        queue — put them back in play.  Only correct after an actual
        restart; on a mere socket loss the healthy node will still drain
        its buffer and re-delivery would be pure duplication."""
        with self._cond:
            n = len(self._delivered[pos])
            self._orphans.extend(self._delivered[pos])
            self._delivered[pos].clear()
            self._watermark[pos] = None  # replacement counts from zero
            self._outstanding += n
            if n:
                self._cond.notify_all()
                self._note("requeue_unconsumed", pos, count=n)
            return n

    def abandon_slot(self, pos: int) -> None:
        """The slot's consumer said 'terminating': resolve its remaining home
        tasks (and its in-flight one, if it was its own) as deliberately
        dropped — reference semantics, an early-terminating node forfeits the
        rest of its share.  An in-flight task acquired from the ORPHAN pool
        is a dead peer's work, not this slot's to forfeit: it goes back for a
        surviving or restarted worker to deliver.  Acked-but-unconsumed
        partitions are forfeited either way: the consumer chose to stop with
        them buffered."""
        with self._cond:
            dropped = len(self._own[pos])
            self._own[pos].clear()
            task = self._inflight.pop(pos, None)
            if task is not None:
                if self._inflight_orphan.get(pos):
                    self._orphans.append(task)
                else:
                    dropped += 1
            self._delivered[pos].clear()  # forfeited, not lost
            self._outstanding -= dropped
            self._cond.notify_all()
            self._note("abandon", pos, dropped=dropped)

    def fail(self, exc: Exception) -> None:
        """Unrecoverable: wake every worker with a stop answer."""
        with self._cond:
            if self._failure is None:
                self._failure = exc
                self._note("fail", None, reason=str(exc)[:200])
            self._cond.notify_all()


class TorchCluster:
    """Handle to a running cluster (reference ``class TFCluster``)."""

    def __init__(
        self,
        coordinator: CoordinatorServer,
        launcher: LocalLauncher,
        cluster_info: list[dict],
        authkey: bytes,
        input_mode: InputMode,
        queues: Sequence[str],
        feed_timeout: float,
        heartbeat_interval: float = 2.0,
        elastic: bool | RestartPolicy = False,
        log_dir: str = "",
    ):
        self.coordinator = coordinator
        self.launcher = launcher
        self.cluster_info = cluster_info
        self.authkey = authkey
        self.input_mode = input_mode
        self.queues = queues
        self.log_dir = log_dir
        self._started_at = time.monotonic()
        self.input_qnames = [q for q in queues if q not in ("output", "error")]
        self.feed_timeout = feed_timeout
        self.heartbeat_interval = heartbeat_interval
        self._clients: dict[int, DataClient] = {}
        # incarnation each cached client was built against — the recovery
        # baseline "which process was I talking to when the call failed"
        # (reading the slot's CURRENT incarnation at failure time would miss
        # a restart that completed while the failed call was still blocked)
        self._client_incs: dict[int, int] = {}
        # executor_id -> (ledger, slot) while a train() feed is live, so the
        # dead-node monitor can re-deliver a dead slot's unconsumed window
        self._active_ledger: dict[int, tuple] = {}
        # Monotonic per-train() generation, prefixed onto every EndPartition
        # dedupe key: node-side FeedQueues outlive a train() call on a reused
        # cluster, and without the prefix a second train()'s (epoch,
        # partition) keys would all hit the first train()'s seen-set, freeze
        # the consumption watermark, and stall every slot's tail drain.
        self._train_gen = 0
        self._shutdown_done = False
        # Feedable nodes: everything except the evaluator (the reference also
        # excluded ps nodes; we have none) and the data-service tier —
        # ingest workers are fed the DIRECT ledger's shard items, trainers
        # are fed rows/paths, and the two lists must never mix.
        self._feed_ids = [m["executor_id"] for m in cluster_info
                          if m["job_name"] not in ("evaluator", "ingest")]
        # Disaggregated ingest tier (ingest/service.py): standalone
        # data-service nodes (role "ingest") that claim shard items from
        # the partition ledger and stream decoded chunks to the trainers.
        # When present, a DIRECT-mode train() feeds THESE slots.
        self._ingest_ids = [m["executor_id"] for m in cluster_info
                            if m["job_name"] == "ingest"]
        # Dead-node monitor (SURVEY.md §5.3 — the role Spark played for the
        # reference: the driver NOTICES executor death instead of waiting for
        # a feed/barrier/collective timeout to expire).  A node whose
        # heartbeat goes silent past the window is recorded as a node error,
        # and the stop signal both aborts in-flight control-plane
        # barriers/reduces and tells surviving nodes to stop — so blocked
        # train()/inference() calls unblock within seconds, not
        # feed_timeout.  Clean exits deregister first and are never flagged.
        self._dead_after = _env_float("TOS_DEAD_NODE_TIMEOUT",
                                      max(12.0, 6.0 * heartbeat_interval))
        # Window for an in-flight death to be DECLARED (monitor poll +
        # heartbeat silence) — _recover_client and _drain_slot_tail both key
        # their "is this slot healthy / cleanly exited" judgements on the
        # same window, and they must not drift apart.
        self._declare_grace = self._dead_after + 3.0 * max(1.0, heartbeat_interval)
        # Elastic recovery (supervisor.py): data-node deaths become supervised
        # restarts instead of job failures; feed workers ride out the restart
        # window (TOS_RECOVERY_TIMEOUT) and re-feed unacknowledged partitions.
        self.supervisor: Supervisor | None = None
        if elastic:
            policy = elastic if isinstance(elastic, RestartPolicy) else None
            self.supervisor = Supervisor(coordinator, launcher, policy)
        # Control-plane crash recovery (ISSUE 13): a journaled coordinator
        # gets a supervisor of its own — crash() wakes it, it waits out the
        # budgeted backoff, and restore() replays the journal under a bumped
        # epoch.  Independent of `elastic` (node restarts need respawnable
        # processes; the coordinator restarts in-process from its journal).
        self.coordinator_supervisor = None
        if getattr(coordinator, "journal_enabled", False):
            from tensorflowonspark_torch.supervisor import CoordinatorSupervisor

            self.coordinator_supervisor = CoordinatorSupervisor(coordinator)
        self._recovery_timeout = _env_float("TOS_RECOVERY_TIMEOUT", 90.0)
        self._max_feed_attempts = _env_int("TOS_MAX_PARTITION_ATTEMPTS", 3)
        # Online serving gateways opened via serve(); closed at shutdown so
        # their routers stop before the feed gets its EOFs.
        self._gateways: list = []
        # Elastic autoscaling (resize / autoscale):
        # - _resize_lock serializes resize() calls (policy loop + user);
        # - _train_lock guards the live train() session handle so a
        #   scale-out can attach a feed worker to an in-flight train();
        # - _retiring marks slots mid-drain (the monitor treats their death
        #   as retirement, never as a recovery candidate);
        # - _audit_waived launch indexes are excluded from shutdown's
        #   exit-code audit (a retired node we terminated, or one killed
        #   mid-drain, must not fail the job post-hoc);
        # - _resize_log / _autoscalers feed the run report's autoscale block;
        # - _closing gates resize() off (and short-circuits an in-flight
        #   drain) the moment shutdown begins, so teardown never races a
        #   resize mutating _feed_ids.
        self._closing = threading.Event()
        self._resize_lock = tos_named_lock("cluster._resize_lock")
        self._train_lock = tos_named_lock("cluster._train_lock")
        self._train_session: dict | None = None
        # live inference() calls (guarded by _train_lock): scale-in refuses
        # while one is in flight — its partitions are statically assigned
        self._inference_live = 0
        self._retiring: set[int] = set()
        self._audit_waived: set[int] = set()
        self._resize_log: list[dict] = []
        self._autoscalers: list = []
        # Feed pump: one sender per node connection (the train/inference
        # worker threads), chunk sends pipelined per connection
        # (TOS_SEND_WINDOW in DataClient) and optionally capped fleet-wide
        # (TOS_SENDER_POOL); the gate is installed on every cached client.
        self._sender_gate = self._make_sender_gate()
        self._monitor_stop = threading.Event()
        self._monitor = threading.Thread(target=self._monitor_loop, daemon=True,
                                         name="dead-node-monitor")
        self._monitor.start()
        # Periodic TensorBoard export of the aggregated cluster metrics
        # (TOS_METRICS_EXPORT_SECS cadence; scalars land under
        # <log_dir>/metrics via summary.SummaryWriter) — TFoS parity: the
        # reference's only live dashboard was TensorBoard, so the metrics
        # subsystem surfaces there too, not just in cluster.metrics().
        self._export_stop = threading.Event()
        self._export_thread: threading.Thread | None = None
        if log_dir and telemetry.enabled():
            self._export_thread = threading.Thread(
                target=self._metrics_export_loop, daemon=True,
                name="metrics-export")
            self._export_thread.start()

    def _record_deaths(self, record_error: bool = True) -> list[int]:
        """Role-aware death bookkeeping, shared by the monitor thread and
        shutdown's death-aware join.  The evaluator is an optional SIDECAR —
        no feed, no collectives — so its death is logged and forgotten
        (training continues; reference parity: a failed auxiliary executor
        didn't fail the job).  Data-node deaths are declared (incarnation
        fenced, in-flight rendezvous aborted) and the newly-declared ids are
        returned for the caller to escalate on; ``record_error=False`` is the
        elastic path — a death the supervisor will recover from must not
        leave a fatal node error behind."""
        dead = self.coordinator.dead_nodes(self._dead_after)
        dead_eval = [i for i in dead if i not in self._feed_ids
                     and i not in self._ingest_ids]
        if dead_eval:
            logger.warning("evaluator node(s) %s stopped heartbeating; "
                           "training continues without them", dead_eval)
            self.coordinator.forget(dead_eval)
        # ingest workers are DATA slots for death handling: their ledger
        # windows requeue and the supervisor recovers them exactly like a
        # trainer's — the elastic contract of the disaggregated tier
        dead_data = [i for i in dead
                     if i in self._feed_ids or i in self._ingest_ids]
        newly: list[int] = []
        # A slot mid-retirement (resize scale-in) dies ON PURPOSE or at
        # worst mid-drain: declare it (fence + rendezvous abort) but never
        # record a fatal node error — the ledger re-feed owns its partitions
        # and resize owns its teardown, elastic or not.
        retiring = [i for i in dead_data if i in self._retiring]
        if retiring:
            newly.extend(self.coordinator.mark_dead(retiring,
                                                    record_error=False))
        rest = [i for i in dead_data if i not in self._retiring]
        if rest:
            newly.extend(self.coordinator.mark_dead(rest,
                                                    record_error=record_error))
        return newly

    def _requeue_dead_slot(self, executor_id: int) -> None:
        """A slot's process is gone (death, or kill mid-drain): put its
        in-flight partition AND its buffered-but-unconsumed window back in
        play, and tear down its cached data client so no feed worker stays
        wedged dialing the dead peer."""
        entry = self._active_ledger.get(executor_id)
        if entry is not None:
            entry[0].requeue(entry[1])
            n = entry[0].requeue_unconsumed(entry[1])
            if n:
                logger.warning("re-delivering %d buffered partition(s) "
                               "node %d died holding", n, executor_id)
        self._drop_client(executor_id, abort=True)

    def _handle_collective_events(self) -> None:
        """React to gray-failure evictions/readmissions the coordinator
        adjudicated (quorum of survivor suspicion votes): an EVICTED slot's
        process is alive-but-benched, so the supervisor PARKS it (no
        respawn — a replacement would split-brain the slot) and its ledger
        slot retires (queued partitions rebalance to survivors, exactly the
        scale-in machinery); a READMITTED slot unparks and — when a train()
        is live — grows back in through the scale-out attach path.  A
        benched process that stops heartbeating altogether is REAPED into
        an ordinary death (eviction must not hide a real corpse forever):
        unparked and handed to the supervisor like any other death."""
        self.coordinator.reap_silent_probation(self._dead_after)
        for ev in self.coordinator.drain_collective_events():
            eid = int(ev["eid"])
            if ev["kind"] == "evicted":
                logger.warning("node %d evicted from collective group %r "
                               "(gray failure); benching its feed slot",
                               eid, ev.get("group"))
                if self.supervisor is not None:
                    self.supervisor.park(eid)
                self._evict_slot_work(eid)
            elif ev["kind"] == "readmitted":
                if self.supervisor is not None:
                    self.supervisor.unpark(eid)
                if self._attach_train_slot(eid):
                    logger.info("readmitted node %d re-attached to the "
                                "live feed", eid)
            elif ev["kind"] == "probation_death":
                self._requeue_dead_slot(eid)
                if self.supervisor is not None:
                    self.supervisor.unpark(eid)
                    self.supervisor.handle_death(eid)

    def _evict_slot_work(self, executor_id: int) -> None:
        """Rebalance an evicted slot's feed work onto survivors: retire its
        ledger slot (no new assignments; queued partitions move — the
        autoscale retire machinery), re-deliver its in-flight and
        buffered-but-unconsumed window, and drop its cached data client so
        no feed worker stays wedged against the benched peer.  The PROCESS
        stays alive in probation; readmission re-attaches a fresh slot."""
        with self._train_lock:
            entry = self._active_ledger.pop(executor_id, None)
        if entry is None:
            return
        ledger, pos = entry
        ledger.requeue(pos)
        moved = ledger.retire_slot(pos)
        n = ledger.requeue_unconsumed(pos)
        if moved or n:
            logger.warning("evicted node %d: %d queued partition(s) "
                           "rebalanced to survivors, %d buffered "
                           "re-delivered", executor_id, moved, n)
        self._drop_client(executor_id, abort=True)

    def _monitor_loop(self) -> None:
        poll = max(1.0, self.heartbeat_interval)
        while not self._monitor_stop.wait(poll):
            try:
                self._handle_collective_events()
            except Exception:  # noqa: BLE001 - eviction bookkeeping must not kill the monitor
                logger.warning("collective eviction bookkeeping failed",
                               exc_info=True)
            newly = self._record_deaths(
                record_error=(self.supervisor is None))
            # Retiring slots first: their death mid-drain is part of the
            # plan — requeue their ledger window (survivors deliver it) and
            # never escalate; resize's reaper finalizes the retirement.
            fatal: list[int] = []
            for eid in newly:
                if eid in self._retiring:
                    logger.warning("retiring node %d died mid-drain; its "
                                   "partitions re-feed to survivors", eid)
                    self._requeue_dead_slot(eid)
                    continue
                fatal.append(eid)
            if self.supervisor is not None:
                # Elastic path: the death is declared WITHOUT a fatal node
                # error and handed to the supervisor; monitoring continues —
                # further deaths (including the replacement's) re-enter here.
                for eid in fatal:
                    logger.warning("node %d stopped heartbeating (>%.0fs); "
                                   "scheduling supervised restart",
                                   eid, self._dead_after)
                    # dead process = dead queue: its in-flight partition AND
                    # its buffered-but-unconsumed window go back in play
                    # BEFORE the restart begins.  The in-flight requeue
                    # matters on a blackholed host: the slot's feed worker is
                    # still wedged inside feed_partition riding out
                    # call_timeout, and without it the task would stay pinned
                    # (and every surviving worker spin-waiting on it) for the
                    # full ~11-minute socket budget; the worker's own later
                    # requeue is then a safe no-op.  The client teardown
                    # matters for the same reason: a worker blocked inside a
                    # dead ring peer (no RST) is woken instead of waited on.
                    self._requeue_dead_slot(eid)
                    self.supervisor.handle_death(eid)
                continue
            if fatal:
                logger.error("nodes %s stopped heartbeating (>%.0fs); failing "
                             "in-flight work and signalling stop",
                             fatal, self._dead_after)
                self.coordinator.signal_stop()
                return

    def dead_nodes(self) -> list[int]:
        """Executor ids currently past the heartbeat window (diagnostic)."""
        return self.coordinator.dead_nodes(self._dead_after)

    # -- data-plane connections ---------------------------------------------

    def _make_sender_gate(self) -> Callable[[], Any]:
        """Send-permit factory for the feed pump (``TOS_SENDER_POOL``):
        0/unset means every node connection sends concurrently (one sender
        thread each); N > 0 bounds how many are mid-send at once.  The
        permit is acquired by ``DataClient`` around individual CHUNK sends
        — never across a whole partition round-trip, where one stalled
        node's backpressure (or a node's inference compute) would pin a
        permit and starve every other connection."""
        pool = _env_int("TOS_SENDER_POOL", 0, minimum=0)
        if pool <= 0:
            return contextlib.nullcontext
        sem = threading.BoundedSemaphore(pool)

        @contextlib.contextmanager
        def _permit():
            with sem:
                yield

        return _permit

    def _fresh_meta(self, executor_id: int) -> dict:
        """Current node meta from the coordinator, not the formation-time
        snapshot: a supervised restart re-registered this slot with a NEW
        host/data_port, and the snapshot would dial the dead one."""
        return (self.coordinator.node_meta(executor_id)
                or self.cluster_info[executor_id])

    def _client(self, executor_id: int, *, connect_timeout: float = 60.0,
                connect_attempts: int | None = None) -> DataClient:
        # Return the looked-up/constructed instance, never a second dict
        # read: the monitor's _drop_client(abort=True) may pop the entry
        # concurrently with a death declaration, and a re-lookup here would
        # KeyError — the caller still holds a usable (if doomed) client whose
        # next call surfaces the real data-plane failure instead.
        client = self._clients.get(executor_id)
        if client is None:
            meta = self._fresh_meta(executor_id)
            inc, _ = self.coordinator.registered_incarnation(executor_id)
            # Record the targeted incarnation BEFORE dialing: even a failed
            # dial establishes the recovery baseline "which process was I
            # trying to reach", which _recover_client compares restarts
            # against.
            self._client_incs[executor_id] = inc
            client = DataClient(
                meta["host"], meta["data_port"], self.authkey,
                call_timeout=self.feed_timeout + 60.0,
                stall_timeout=self.feed_timeout,
                connect_timeout=connect_timeout,
                connect_attempts=connect_attempts)
            client.sender_gate = self._sender_gate
            self._clients[executor_id] = client
        return client

    def _drop_client(self, executor_id: int, *, abort: bool = False) -> None:
        """Discard (and best-effort close) the slot's cached data client —
        its socket/ring died with the failure that led here.  ``abort=True``
        (the monitor's death declaration) tears the socket down WITHOUT the
        per-client lock, so a feed worker wedged mid-call on the dead peer is
        woken instead of waited on."""
        stale = self._clients.pop(executor_id, None)
        if stale is not None:
            with contextlib.suppress(Exception):
                stale.abort() if abort else stale.close()

    def _recover_client(self, executor_id: int, *,
                        require_restart: bool = False,
                        cancel: Callable[[], bool] | None = None) -> DataClient | None:
        """After a data-plane failure on ``executor_id``: wait out the slot's
        restart window and hand back a fresh client, or None when the slot
        cannot (or must not) be re-fed.  ``cancel`` lets the caller's job
        abort this wait early (a peer already failed the whole feed — pinning
        its join on this slot's 90s window would only delay that error).

        ``require_restart=True`` is the inference rule: only a *restarted*
        node (fresh process, empty queues — observable as a bumped
        incarnation) may be re-fed, because a healthy node whose socket
        merely severed can still hold partial results of the failed attempt
        in its output queue, and a re-feed would corrupt the exactly-count
        invariant.  Training re-feeds either way (at-least-once).
        """
        # Baseline = the incarnation the FAILED client was talking to (kept
        # by _client/_drop_client), not the slot's current one: a restart
        # that completed while the failed call was still blocked (e.g. a
        # zombie riding out stall_timeout) already bumped the current value.
        inc0 = self._client_incs.get(
            executor_id, self.coordinator.registered_incarnation(executor_id)[0])
        deadline = time.monotonic() + self._recovery_timeout
        grace_end = time.monotonic() + self._declare_grace
        while time.monotonic() < deadline and not self._shutdown_done:
            if cancel is not None and cancel():
                return None
            if (self.supervisor is not None
                    and self.supervisor.permanently_failed(executor_id) is not None):
                return None
            inc, tracked = self.coordinator.registered_incarnation(executor_id)
            restarted = inc > inc0
            if tracked and (restarted or not require_restart):
                try:
                    # Short bounded dial: the outer loop is the retry.  The
                    # default 60s x 3-attempt dial would let one blackholed
                    # host pin this thread minutes past _recovery_timeout.
                    return self._client(executor_id, connect_timeout=5.0,
                                        connect_attempts=1)
                except Exception:  # noqa: BLE001 - port dark mid-restart
                    time.sleep(0.5)
                    continue
            if not tracked:
                if self.supervisor is None:
                    return None  # declared dead with nobody to revive it
                if (not self.supervisor.restarting(executor_id)
                        and any(e.get("executor_id") == executor_id
                                for e in self.coordinator.errors())):
                    # The node EXITED with a recorded error (map_fun failure:
                    # report_error + deregister, never declared dead) — no
                    # restart was or will be scheduled, so waiting out the
                    # recovery window would just delay the inevitable by 90s.
                    return None
            if require_restart and tracked and not restarted \
                    and time.monotonic() > grace_end:
                return None  # healthy-node sever: re-feeding is not safe
            time.sleep(0.5)
        return None

    def _drain_slot_tail(self, ledger, worker_pos: int, executor_id: int,
                         qname: str, client: DataClient | None) -> DataClient | None:
        """Elastic train tail: poll the slot's consumption watermark until its
        acked-but-unconsumed window empties, the node dies (the monitor then
        requeues the window, clearing it here), or consumption stalls.

        The stall bound (``TOS_DRAIN_STALL_TIMEOUT``) keeps a map_fun that
        deliberately stopped consuming (a ``max_steps`` cutoff) from pinning
        ``train()`` forever — on stall the pre-drain semantics return: the
        buffered tail is the consumer's to lose.  Returns the (possibly
        refreshed or dropped) data client for the caller to keep using."""
        stall_limit = _env_float("TOS_DRAIN_STALL_TIMEOUT", 300.0)
        # Grace for the monitor to turn an observed "untracked" into either a
        # supervised restart or a window requeue before we call it a CLEAN
        # exit (deregister) — same window _recover_client uses.
        untracked_grace = self._declare_grace
        last_wm: int | None = None
        last_progress = time.monotonic()
        untracked_since: float | None = None
        while ledger.needs_drain(worker_pos):
            if self._shutdown_done or (
                    self.supervisor is not None
                    and self.supervisor.permanently_failed(executor_id)
                    is not None):
                return client
            # Checked EVERY iteration (the poll below may fail forever
            # against an exited process): a slot that stays untracked with
            # no restart in flight past the grace deregistered CLEANLY —
            # its consumer chose to exit with the tail buffered, which
            # forfeits it exactly like a 'terminating' answer would.
            _, tracked = self.coordinator.registered_incarnation(executor_id)
            if tracked or (self.supervisor is not None
                           and self.supervisor.restarting(executor_id)):
                untracked_since = None
            elif untracked_since is None:
                untracked_since = time.monotonic()
            elif time.monotonic() - untracked_since > untracked_grace:
                logger.warning(
                    "executor %d exited cleanly with buffered partitions "
                    "unconsumed; its tail is forfeited", executor_id)
                return client
            if time.monotonic() - last_progress > stall_limit:
                logger.warning(
                    "executor %d stopped consuming with buffered partitions "
                    "outstanding (no progress in %.0fs); leaving its tail "
                    "un-drained", executor_id, stall_limit)
                return client
            try:
                if client is None:
                    client = self._client(executor_id, connect_timeout=5.0,
                                          connect_attempts=1)
                wm = client.poll_consumed(qname)
            except Exception:  # noqa: BLE001 - slot mid-death/restart
                self._drop_client(executor_id)
                client = None
                time.sleep(0.5)
                continue
            ledger.update_watermark(worker_pos, wm)
            if wm != last_wm:
                last_wm = wm
                last_progress = time.monotonic()
            time.sleep(0.2)
        return client

    # -- training feed (reference TFCluster.train :~70-130, §3.2) ------------

    def train(self, data: Any, num_epochs: int = 1, qname: str = "input",
              shuffle_seed: int | None = None,
              num_partitions: int | None = None,
              span_bytes: int | None = None,
              mode: str = "async",
              embedding: Any = None) -> None:
        """Feed the workers for ``num_epochs`` epochs; blocks until all
        partitions are consumed (or nodes report 'terminating').

        **STREAMING** (reference ``InputMode.SPARK``): ``data`` is the rows
        themselves (a ``PartitionedDataset`` or any iterable of
        partitions); the driver streams every row over the data plane.

        **DIRECT** (reference ``InputMode.TENSORFLOW``): ``data`` is a
        shard *directory, glob, file, or list of paths*
        (``ingest.enumerate_shards``); the ledger feeds shard PATHS — tens
        of bytes per shard — and each node's ingest pipeline reads, CRC-
        verifies, and decodes the bytes itself (``ctx.get_data_feed`` →
        ``ingest.IngestFeed``), so aggregate feed bandwidth scales with the
        node count and the driver stays out of the training hot path.  One
        shard per ledger partition by default (``num_partitions`` groups
        them round-robin for many-tiny-file datasets).

        Both modes share the SAME partition ledger: partition *i* homes on
        feedable node ``i % W`` (the reference's round-robin placement),
        delivery is at-least-once with the consumption watermark bounding
        what a death can lose, and elastic restart recovery / incarnation
        fencing apply unchanged — in DIRECT mode a dead node's unread
        shards are simply re-assigned to a survivor or its replacement.

        Plain shards larger than ``span_bytes`` (default
        ``TOS_INGEST_SPAN_BYTES``; 0 disables) split into record-aligned
        *sub-shard* ledger items (``ingest.ShardSpan``), so N nodes
        parallelize inside one multi-GB shard instead of pinning it to a
        single reader — with the same at-least-once re-feed and recovery
        semantics at span granularity.  Gzip shards always stay whole
        (no byte-addressable record boundaries to split on).

        ``shuffle_seed`` reorders partitions differently each epoch
        (seed+epoch, deterministic) — the between-epochs shuffle the
        reference inherited from Spark/tf.data file shuffling; in DIRECT
        mode this is a between-epochs *shard* (work-item) shuffle.

        ``mode="sync"`` declares CROSS-HOST SYNCHRONOUS training (the
        MultiWorkerMirrored/ParameterServer replacement at cluster scope):
        the published job manifest carries a ``sync`` block (collective
        group name + world size) so every node's map_fun forms the
        :meth:`NodeContext.collective_group` and exchanges gradients each
        step — a compile-once jit step with a bucketed ring all-reduce via
        ``parallel.dp.make_train_step(cross_host_grad_fn=group.grad_fn())``,
        with the lockstep batch iterator keeping per-host step counts
        aligned (``make_batch_iterator(lockstep=True)``).  The feed
        machinery itself is identical to the default ``"async"``
        (driver-fed, at-least-once) mode; with ``elastic=True`` a node
        death mid-collective aborts the poisoned round at the group's
        generation barrier, the supervised restart rejoins, and training
        resumes from the synced step.
        """
        if mode not in ("async", "sync"):
            raise ValueError(
                f"train mode must be 'async' or 'sync', got {mode!r}")
        # Published for map_funs either way the data travels: the sync block
        # is the map_fun-facing DECLARATION of this train call's mode (one
        # map_fun body can branch on it) with the intended group name and
        # the driver's feedable count at publish time.  Group formation
        # itself defaults to the registration-time num_data_nodes
        # (ctx.collective_group) — after a resize the two can differ; see
        # the collectives caveat on resize().
        sync_block = ({"group": "train", "world": len(self._feedable_ids())}
                      if mode == "sync" else None)
        if embedding is not None:
            # sharded-embedding declaration (ShardPlan or its manifest
            # dict): published under the sync block so every node builds
            # the SAME range-shard layout — the plan is the one authority
            # on row ownership for the sparse collectives
            if sync_block is None:
                raise ValueError(
                    "embedding plans require mode='sync' (the sharded "
                    "table rides the sync collective group)")
            sync_block["embedding"] = (embedding.to_manifest()
                                       if hasattr(embedding, "to_manifest")
                                       else dict(embedding))
        if self.input_mode == InputMode.DIRECT:
            from tensorflowonspark_torch.ingest import shards_as_partitioned

            if not isinstance(data, (str, os.PathLike, list, tuple)) and not \
                    hasattr(data, "iter_partition"):
                raise RuntimeError(
                    "InputMode.DIRECT (reference: InputMode.TENSORFLOW) "
                    "train() takes a shard path/glob/directory (or list of "
                    "paths), not row data — nodes read the files themselves. "
                    "To stream rows from the driver, run the cluster with "
                    "input_mode=InputMode.STREAMING (reference: InputMode.SPARK)")
            if hasattr(data, "iter_partition"):
                dataset = data  # pre-built partitions of paths: passthrough
                num_shards = num_items = None
            else:
                from tensorflowonspark_torch.ingest import (
                    enumerate_shards,
                    split_shards,
                )

                files = enumerate_shards(data)
                num_shards = len(files)
                items = split_shards(files, span_bytes)
                num_items = len(items)
                dataset = shards_as_partitioned(items, num_partitions,
                                                span_bytes=0)
            manifest = {
                "kind": "tfrecord_shards", "qname": qname,
                "num_shards": num_shards,
                # work items the ledger feeds: == num_shards unless large
                # plain shards were split into sub-shard span ranges
                "num_items": num_items,
                "num_partitions": dataset.num_partitions,
                "num_epochs": num_epochs,
                "mode": mode,
                "spec": str(data) if isinstance(data, (str, os.PathLike)) else None,
            }
            if sync_block is not None:
                manifest["sync"] = sync_block
            if self._ingest_ids:
                # disaggregated tier declaration: map_funs (and operators
                # reading ctx.job_manifest()) see which tier the ledger
                # feeds and how the pool is configured — ingest_opts
                # overrides win over the env knobs, mirroring what the
                # workers themselves resolve
                from tensorflowonspark_torch.ingest.service import (
                    cache_bytes_default,
                    shuffle_default,
                )

                opts = self._ingest_opts()
                shuffle = opts.get("shuffle")
                cache_bytes = opts.get("cache_bytes")
                manifest["ingest"] = {
                    "workers": len(self._ingest_feedable_ids()),
                    # None = "not overridden": the env knob applies,
                    # through the SAME helpers IngestService resolves with
                    "shuffle": bool(shuffle_default() if shuffle is None
                                    else shuffle),
                    "cache_bytes": int(cache_bytes_default()
                                       if cache_bytes is None
                                       else cache_bytes),
                }
            self.coordinator.set_manifest(manifest)
        else:
            if isinstance(data, (str, os.PathLike)):
                raise RuntimeError(
                    "train() got a path but this cluster runs "
                    "InputMode.STREAMING (reference: InputMode.SPARK), which "
                    "streams ROWS from the driver — pass the rows (e.g. "
                    "dfutil.load_tfrecords(dir)[0]), or run the cluster with "
                    "input_mode=InputMode.DIRECT (reference: "
                    "InputMode.TENSORFLOW) for node-side shard ingestion")
            dataset = as_partitioned(data, default_partitions=len(self._feed_ids))
            if sync_block is not None:
                # STREAMING publishes a manifest only when sync mode needs
                # one (async streaming kept its no-manifest behavior)
                self.coordinator.set_manifest({
                    "kind": "stream_rows", "qname": qname,
                    "num_partitions": dataset.num_partitions,
                    "num_epochs": num_epochs, "mode": mode,
                    "sync": sync_block,
                })
        # One view per epoch (identity, or the seeded between-epochs shuffle);
        # precomputed so a re-fed partition sees the same epoch ordering.
        views = [dataset if shuffle_seed is None
                 else dataset.shuffle_partitions(shuffle_seed + epoch)
                 for epoch in range(num_epochs)]
        # NOTE: the feedable-slot snapshot, the ledger, and the live-session
        # install all commit TOGETHER under _train_lock just before the
        # workers spawn (same lock _scale_in commits retirement intent
        # under) — the closures below bind the ``ledger``/``feed_ids``
        # names late, so defining them first is safe.  A snapshot taken
        # out here instead would race a concurrent scale-in: the victim
        # would get a fresh ledger slot feeding straight into its teardown.
        self._train_gen += 1
        train_gen = self._train_gen
        errors: list[Exception] = []

        def _feed_worker(worker_pos: int, executor_id: int) -> None:
            client: DataClient | None = None
            while True:
                task = ledger.next_task(worker_pos)
                if task is None:
                    # All partitions resolved — but "acked" only means
                    # buffered on the node.  In elastic mode nobody may walk
                    # away while this slot still holds unconsumed work: a
                    # death seconds after train() returns would be recovered
                    # (no error recorded) with the buffered tail silently
                    # gone.  Poll the node's watermark until the window
                    # drains; if the node dies instead, the monitor requeues
                    # the window and next_task hands it back out here.
                    # A RETIRED slot must drain its watermark even without a
                    # supervisor: scale-in's wait loop polls needs_drain, and
                    # nobody else reads the node's consumed count once this
                    # worker walks away — without this, a resize() on a
                    # non-elastic cluster burns its whole drain_timeout and
                    # then terminates a perfectly healthy victim.
                    if not ledger.needs_drain(worker_pos) or (
                            self.supervisor is None
                            and not ledger.slot_retired(worker_pos)):
                        return
                    client = self._drain_slot_tail(ledger, worker_pos,
                                                   executor_id, qname, client)
                    if not ledger.needs_drain(worker_pos):
                        continue  # drained, or death requeued the window
                    return  # shutdown / permanent failure / consumption stall
                # THIS holder's attempt number, captured at acquisition: after
                # a requeue the task is shared state again, and a peer popping
                # it would bump the live counter — judging the budget off a
                # re-read could fail the job while that peer's viable attempt
                # is still in flight.
                attempt = ledger.attempts(task)
                epoch, p = task
                # sampled partitions get a trace: root span = ledger
                # assignment -> buffered ack, the feed itself a child, and
                # the ctx rides the EndPartition so the node's consume span
                # (feed -> map_fun) joins the same trace
                part_trace = ttrace.sample()
                t_assign = time.monotonic()
                try:
                    if client is None:
                        client = self._client(executor_id)
                    # (train_gen, epoch, partition) is the EndPartition
                    # dedupe key: a re-feed of this same task must not
                    # double-count in the node's consumption watermark, while
                    # a LATER train() on a reused cluster (new generation)
                    # must count afresh
                    # span: wall time to stream + ack one partition (send
                    # rate AND node-side backpressure both land in here —
                    # the first place to look when train() slows down)
                    with telemetry.timed("driver.feed_partition_secs"), \
                            ttrace.span("driver.feed_partition",
                                        parent=part_trace):
                        state = client.feed_partition(
                            views[epoch].iter_partition(p), qname,
                            task_key=(train_gen,) + task,
                            trace=part_trace)
                except Exception as e:  # noqa: BLE001 - wrapped + ledgered below
                    wrapped = RuntimeError(
                        f"feeding executor {executor_id} failed on partition "
                        f"{p} (epoch {epoch}, attempt {attempt}"
                        f"/{ledger.max_attempts}): {e}")
                    wrapped.__cause__ = e
                    # Unacked partition back to the pool (at-least-once), then
                    # ride out the slot's restart window; a surviving peer may
                    # pick the orphan up meanwhile.
                    ledger.requeue(worker_pos)
                    if (ledger.slot_retired(worker_pos)
                            or executor_id in self._retiring):
                        # resize owns this slot's teardown: a feed failing
                        # against a victim reaped mid-drain is part of the
                        # plan, not a train() failure — the partition is
                        # already requeued for survivors, so just walk away
                        # (no restart is ever coming for a retired slot).
                        logger.info(
                            "feed worker for retiring node %d exiting; "
                            "partition %d requeued for survivors",
                            executor_id, p)
                        self._drop_client(executor_id)
                        return
                    inc_failed = self._client_incs.get(executor_id)
                    self._drop_client(executor_id)
                    client = None
                    if attempt >= ledger.max_attempts:
                        errors.append(wrapped)
                        ledger.fail(wrapped)
                        return
                    logger.warning("%s; awaiting recovery", wrapped)
                    client = self._recover_client(executor_id,
                                                  cancel=ledger.failed)
                    if client is None:
                        errors.append(wrapped)
                        ledger.fail(wrapped)
                        return
                    if self._client_incs.get(executor_id) != inc_failed:
                        # actual restart: the predecessor's queue (and every
                        # buffered-but-unconsumed partition in it) is gone
                        n = ledger.requeue_unconsumed(worker_pos)
                        if n:
                            logger.warning(
                                "executor %d restarted with %d buffered "
                                "partition(s) unconsumed; re-delivering them",
                                executor_id, n)
                    continue
                if state == "terminating":
                    logger.info("node %d terminating; dropping remaining feed", executor_id)
                    ledger.abandon_slot(worker_pos)
                    return
                ledger.ack(worker_pos, client.partitions_consumed(qname))
                ttrace.record_span(
                    "train.partition", part_trace, None, t_assign,
                    time.monotonic() - t_assign,
                    {"epoch": epoch, "partition": p, "executor": executor_id,
                     "attempt": attempt} if part_trace else None)

        def _runner(worker_pos: int, executor_id: int) -> None:
            try:
                _feed_worker(worker_pos, executor_id)
            except Exception as e:  # noqa: BLE001 - never strand the ledger
                wrapped = RuntimeError(
                    f"feed worker for executor {executor_id} crashed: {e}")
                wrapped.__cause__ = e
                errors.append(wrapped)
                ledger.fail(wrapped)

        # Live train session: resize() scale-out attaches new feed workers
        # through ``spawn`` while this call is in flight, so the thread list
        # can GROW — the join loop below re-checks until it stabilizes.
        session: dict = {"ledger": None, "threads": []}

        def _spawn_worker(worker_pos: int, executor_id: int) -> None:
            t = threading.Thread(target=_runner, args=(worker_pos, executor_id),
                                 name=f"feed-{executor_id}")
            session["threads"].append(t)
            t.start()

        session["spawn"] = _spawn_worker
        # The monitor re-delivers a dead slot's buffered-but-unconsumed
        # window the moment it declares the death — the slot's own feed
        # worker may be idle in next_task() at that point and would never
        # pass through the recovery path that also checks.
        #
        # Snapshot -> ledger -> install, all in ONE _train_lock hold:
        # _scale_in commits retirement intent under this lock, so a
        # concurrent scale-in either lands before the snapshot (victim
        # excluded, retires with no slot here) or after the install
        # (victim's slot found in _active_ledger and drained properly) —
        # never in between, where it would EOF a slot this train is about
        # to feed.  A slot mid-drain is excluded from the snapshot for the
        # same reason.
        with self._train_lock:
            # Disaggregated tier: a DIRECT train over a cluster with ingest
            # workers feeds THEIR slots — the workers decode and forward,
            # the trainers consume chunks.  The ledger machinery (and every
            # elastic property hanging off it) is identical either way;
            # only the slot membership changes.
            ingest_tier = (self.input_mode == InputMode.DIRECT
                           and bool(self._ingest_ids))
            feed_ids = (self._ingest_feedable_ids() if ingest_tier
                        else self._feedable_ids())
            if not feed_ids:
                raise RuntimeError("no feedable slots for train() (all "
                                   "retired or draining)")
            session["tier"] = "ingest" if ingest_tier else "nodes"
            ledger = _PartitionLedger(dataset.num_partitions, num_epochs,
                                      len(feed_ids),
                                      max_attempts=self._max_feed_attempts,
                                      journal_fn=self.coordinator.live_journal,
                                      train_gen=train_gen)
            session["ledger"] = ledger
            self._train_session = session
            self._active_ledger = {eid: (ledger, pos)
                                   for pos, eid in enumerate(feed_ids)}
            for pos, eid in enumerate(feed_ids):
                _spawn_worker(pos, eid)
        try:
            while True:
                with self._train_lock:
                    threads = list(session["threads"])
                for t in threads:
                    t.join()
                with self._train_lock:
                    if len(session["threads"]) == len(threads):
                        break
        finally:
            with self._train_lock:
                self._train_session = None
                self._active_ledger = {}
        self._raise_node_errors()
        if errors:
            raise RuntimeError(f"feeding failed: {errors[0]}") from errors[0]

    # -- inference (reference TFCluster.inference :~130-170, §3.3) -----------

    def inference(self, data: Any, qname_in: str = "input", qname_out: str = "output",
                  flat: bool = True, eof_when_done: bool = False) -> list:
        """Round-trip partitions through the nodes; ordered, exactly-count.

        Returns the flattened results in partition order — the invariant the
        reference's output RDD preserved (SURVEY.md §3.3).  ``flat=False``
        returns one result list per partition instead (the pipeline layer
        needs partition boundaries to rebuild a PartitionedDataset).

        Materializes everything; for datasets bigger than driver memory use
        ``inference_stream``.
        """
        dataset = as_partitioned(data, default_partitions=len(self._feed_ids))
        results: list[list | None] = [None] * dataset.num_partitions
        for p, part in self.inference_stream(dataset, qname_in, qname_out,
                                             window=dataset.num_partitions + 1,
                                             eof_when_done=eof_when_done):
            results[p] = part
        if not flat:
            return [part or [] for part in results]
        return [item for part in results for item in (part or [])]

    def inference_stream(self, data: Any, qname_in: str = "input",
                         qname_out: str = "output", window: int | None = None,
                         eof_when_done: bool = False):
        """Lazily yield ``(partition_index, results)`` in partition order.

        Restores the reference's lazy-RDD property
        (``TFCluster.py:~130-170``): partitions are read, scored, and yielded
        incrementally, so driver memory holds at most ``window`` completed
        partitions (default ``2 × feedable nodes``) — workers pause instead
        of running ahead of the consumer.

        ``eof_when_done=True`` sends end-of-feed to each node as soon as its
        share of partitions has been dispatched AND collected (instead of at
        shutdown).  REQUIRED for global-mesh scoring map_funs
        (``inference.sharded_bundle_inference_loop``): there, a node whose
        share ran out must learn it is done WHILE the driver is still
        collecting from its peers — its end-of-data consensus votes (and
        filler SPMD rounds) are what let the peers' remaining batches
        execute.  Leave False for task-parallel loops that should keep
        serving across multiple inference calls on one cluster.
        """
        if self.input_mode != InputMode.STREAMING:
            raise RuntimeError(
                "inference()/inference_stream() require InputMode.STREAMING "
                "(reference: InputMode.SPARK) — the exactly-count result "
                "contract needs driver-streamed row partitions.  This "
                "cluster runs InputMode.DIRECT (reference: "
                "InputMode.TENSORFLOW), whose feed carries shard paths for "
                "node-side ingestion; for request/response scoring on a "
                "DIRECT cluster use cluster.serve(export_dir) instead")
        # Snapshot: a concurrent resize() must not skew the worker/partition
        # mapping mid-call (newcomers join the NEXT inference call, and a
        # slot mid-drain must not be handed partitions it will never score).
        # Atomic with the live-call marker: _scale_in checks the marker
        # under the same lock before committing retirement intent, so a
        # scale-in can never EOF a worker that owns statically-assigned
        # partitions of THIS call — it refuses until the call completes
        # (train() has a live re-feed session; inference() deliberately
        # does not, its exactly-once contract is positional).
        with self._train_lock:
            feed_ids = self._feedable_ids()
            self._inference_live += 1
        try:
            dataset = as_partitioned(data, default_partitions=len(feed_ids))
        except Exception:
            with self._train_lock:
                self._inference_live -= 1
            raise
        num_workers = len(feed_ids)
        if eof_when_done:
            # Global-mesh scoring cannot be window-gated: a node whose next
            # partition is gated on earlier global output would stop feeding
            # its SPMD rounds while its peers wait for it in a collective —
            # a circular wait.  Sharded scoring therefore always dispatches
            # freely (driver may hold up to all partitions, as inference()
            # already does).
            window = dataset.num_partitions + 1
        window = window if window is not None else max(2 * num_workers, 4)
        buf: dict[int, list] = {}
        cond = tos_named_condition("cluster.drain._cond")
        state = {"next": 0, "stopped": False, "done": 0}
        errors: list[Exception] = []

        def _infer_worker(worker_pos: int, executor_id: int) -> None:
            # The worker's share of partitions, retried in place on failure.
            # Exactly-once is preserved by construction: the consumer reads a
            # partition's results from ``buf[p]`` exactly once, and a failed
            # attempt is only ever retried against a *restarted* node (fresh
            # queues) — never a healthy one that may hold partial results
            # (``_recover_client(require_restart=True)``).
            pending = collections.deque(
                range(worker_pos, dataset.num_partitions, num_workers))
            client: DataClient | None = None
            attempts = 0
            try:
                while pending:
                    p = pending[0]
                    with cond:
                        cond.wait_for(lambda: p < state["next"] + window
                                      or state["stopped"])
                        if state["stopped"]:
                            return
                    try:
                        if client is None:
                            client = self._client(executor_id)
                        with telemetry.timed("driver.infer_partition_secs"):
                            part = client.infer_partition(
                                dataset.iter_partition(p), qname_in, qname_out)
                    except Exception as e:  # noqa: BLE001 - wrapped below
                        # A failed DIAL (client is still None) sent nothing:
                        # no partial results can exist anywhere, so any live
                        # process is safe to feed — demanding a restart would
                        # wedge recovery when the slot died pre-dial (the
                        # incarnation baseline already includes the death
                        # bump, so "restarted" could never be observed).
                        had_conn = client is not None
                        attempts += 1
                        wrapped = RuntimeError(
                            f"inference executor {executor_id} failed on "
                            f"partition {p} (attempt {attempts}"
                            f"/{self._max_feed_attempts}): {e}")
                        wrapped.__cause__ = e
                        self._drop_client(executor_id)
                        client = None
                        if attempts < self._max_feed_attempts:
                            logger.warning("%s; awaiting recovery", wrapped)
                            client = self._recover_client(
                                executor_id, require_restart=had_conn,
                                cancel=lambda: state["stopped"] or bool(errors))
                        if client is None:
                            with cond:
                                errors.append(wrapped)
                                cond.notify_all()
                            return
                        continue
                    attempts = 0
                    pending.popleft()
                    with cond:
                        buf[p] = part
                        cond.notify_all()
                if eof_when_done:
                    if client is None:
                        client = self._client(executor_id)
                    client.send_eof(qname_in)
            except Exception as e:
                with cond:
                    errors.append(e)
                    cond.notify_all()
            finally:
                with cond:
                    state["done"] += 1
                    cond.notify_all()

        threads = [
            threading.Thread(target=_infer_worker, args=(pos, eid),
                             name=f"infer-{eid}", daemon=True)
            for pos, eid in enumerate(feed_ids)
        ]
        started = 0
        try:
            for t in threads:
                t.start()
                started += 1
        except Exception:
            # partial start (thread exhaustion): stop the live workers and
            # release the scale-in guard — a leaked _inference_live would
            # refuse every scale-in for the cluster's remaining life
            with cond:
                state["stopped"] = True
                cond.notify_all()
            for t in threads[:started]:
                t.join(timeout=10.0)
            with self._train_lock:
                self._inference_live -= 1
            raise
        try:
            for p in range(dataset.num_partitions):
                with cond:
                    cond.wait_for(lambda: p in buf or errors
                                  or state["done"] == num_workers)
                    if errors:
                        raise RuntimeError(f"inference failed: {errors[0]}") from errors[0]
                    if p not in buf:
                        # every worker exited without error yet p is missing
                        self._raise_node_errors()
                        raise RuntimeError(f"inference lost partition {p}")
                    part = buf.pop(p)
                    state["next"] = p + 1
                    cond.notify_all()
                yield p, part
        finally:
            with cond:
                state["stopped"] = True
                cond.notify_all()
            for t in threads:
                t.join()
            with self._train_lock:
                self._inference_live -= 1
        self._raise_node_errors()
        if errors:
            # A worker that failed AFTER its last partition was collected
            # (e.g. send_eof) never trips the consumer loop's error check —
            # surface it here or the node silently misses its EOF and stalls
            # in next_batch until shutdown's kill timeout.
            raise RuntimeError(f"inference worker failed after all results were "
                               f"collected: {errors[0]}") from errors[0]

    # -- online serving (beyond-reference: request/response path) ------------

    def serve(self, export_dir: str, **kwargs) -> Any:
        """Open an online-serving gateway over this cluster's nodes.

        The nodes must be running the resident ``serving.serving_loop``
        map_fun (pass it to ``cluster.run`` with ``{"export_dir": ...}``
        args); the returned :class:`~tensorflowonspark_torch.serving.
        ServingGateway` answers individual requests with dynamic
        micro-batching, least-outstanding replica routing, and a TCP wire
        endpoint — see ``serving/gateway.py``.  Run the cluster with
        ``elastic=True`` so a replica death becomes a supervised restart
        the gateway rides out (in-flight batches retry on a survivor)
        instead of a job failure.

        Keyword args pass through to ``ServingGateway`` (``max_batch``,
        ``max_delay_ms``, ``queue_limit``, ``default_timeout``, ``listen``,
        ``reload_poll_secs``, ...); the ``TOS_SERVE_*`` knobs supply
        defaults.  The gateway closes automatically at ``shutdown()``.
        """
        from tensorflowonspark_torch.serving import ServingGateway

        gateway = ServingGateway(self, export_dir, **kwargs)
        self._gateways.append(gateway)
        return gateway

    # -- elastic autoscaling (beyond-reference: cluster.resize) ---------------

    def _feedable_ids(self) -> list[int]:
        """The ONE definition of 'feedable right now': data slots minus
        those mid-drain (train()/inference() snapshots and the autoscaler's
        ``current`` must never disagree on membership)."""
        return [eid for eid in self._feed_ids if eid not in self._retiring]

    def num_feedable(self) -> int:
        """Feedable (non-evaluator, non-retiring) nodes right now — the
        ``current`` the autoscaler policies compare their desired count to."""
        return len(self._feedable_ids())

    def _ingest_feedable_ids(self) -> list[int]:
        """Live data-service worker slots (ingest role, not mid-drain) —
        the ledger targets of a DIRECT train on a disaggregated cluster."""
        return [eid for eid in self._ingest_ids if eid not in self._retiring]

    def num_ingest(self) -> int:
        """Live ingest-worker count — the ``current`` an ingest-tier
        autoscaler policy compares its desired pool size to."""
        return len(self._ingest_feedable_ids())

    def _ingest_opts(self) -> dict:
        """The tier's decode configuration as launched
        (``run(ingest_opts=...)``, carried on every NodeConfig) — the
        manifest must describe what the workers ACTUALLY run, not the env
        defaults the opts may override."""
        for cfg in getattr(self.launcher, "configs", []):
            opts = getattr(cfg, "ingest_opts", None)
            if opts:
                return dict(opts)
        return {}

    def resize(self, num_nodes: int, *, drain_timeout: float | None = None) -> dict:
        """Grow or shrink the LIVE cluster to ``num_nodes`` feedable nodes.

        **Scale-out** spawns fresh node processes through the launcher
        (cloned from an existing worker's config), admits them through the
        coordinator's rendezvous mid-run, and puts them to work immediately:
        an in-flight ``train()`` gets a new feed worker whose ledger slot is
        rebalanced a fair share of the still-queued partitions (plus the
        shared orphan pool), and every open serving gateway admits the node
        as a routing replica.

        **Scale-in** picks the least-loaded victims (router outstanding,
        then ``feed.queue_depth``; the chief — executor 0 — never retires),
        marks them DRAINING (no new ledger assignments, serving routers stop
        routing to them and drain their in-flight batches), waits for
        buffered partitions to be consumed (``drain_timeout``, default
        ``TOS_DRAIN_TIMEOUT``), sends end-of-feed so the map_fun exits
        cleanly, and retires the slot *intentionally*: no respawn, no
        restart-budget charge, no node error.  A victim killed mid-drain
        cannot wedge the resize — the at-least-once ledger re-feeds its
        partitions to survivors and the reaper escalates to terminate.

        The reference cluster was frozen at ``num_executors`` for life
        (Spark could replace a dead executor, never follow traffic); this is
        the mechanism half of elastic autoscaling — drive it by hand, or let
        :meth:`autoscale` run a telemetry-driven policy loop over it.
        Refused for ``torch.distributed`` jobs (a live process group has a
        fixed world size).  Returns a record of what changed (also appended to
        the run report's ``autoscale`` block).

        Collectives caveat: default-group ``ctx.barrier()``/reduces track
        the live membership (retired slots leave the participant count),
        but ``group="data"`` collectives, ``ctx.all_done`` consensus, and
        tensor-plane :meth:`NodeContext.collective_group` worlds use each
        node's registration-time ``num_data_nodes`` and do NOT follow
        resizes.  Collective groups survive same-world elastic RESTARTS
        (the generation-barrier rejoin, ``collective/group.py``); a
        *changed* world size still means a new ``train()`` call.
        """
        if num_nodes < 1:
            raise ValueError("resize needs num_nodes >= 1")
        if any(getattr(cfg, "torch_distributed", False)
               for cfg in getattr(self.launcher, "configs", [])):
            raise RuntimeError(
                "cannot resize a torch.distributed job: a live process group "
                "has a fixed world size (same constraint as elastic=True)")
        with self._resize_lock:
            if self._closing.is_set() or self._shutdown_done:
                raise RuntimeError("cluster is shutting down")
            current = self.num_feedable()
            t0 = time.monotonic()
            if num_nodes == current:
                return {"action": "noop", "from": current, "to": current}
            if num_nodes > current:
                added = self._scale_out(num_nodes - current)
                record: dict = {"action": "scale_out", "from": current,
                                "to": current + len(added), "added": added}
            else:
                retired = self._scale_in(current - num_nodes, drain_timeout)
                record = {"action": "scale_in", "from": current,
                          "to": current - len(retired), "retired": retired}
            record["secs"] = round(time.monotonic() - t0, 3)
            self._resize_log.append(record)
            telemetry.counter(f"cluster.{record['action']}_total").inc()
            telemetry.gauge("cluster.feedable_nodes").set(self.num_feedable())
            logger.info("cluster resized: %s", record)
            return dict(record)

    def _worker_template(self):
        """The NodeConfig to clone for scale-out newcomers: the highest-
        launch-index feedable node's — a worker wherever one exists (the
        chief's config is only used on a 1-node cluster, where it is the
        worker config too)."""
        best = None
        for meta in self.cluster_info:
            if meta["executor_id"] not in self._feed_ids:
                continue
            li = meta.get("launch_index", -1)
            if 0 <= li < len(self.launcher.configs) and (
                    best is None or li > best):
                best = li
        if best is None:
            raise RuntimeError("no feedable node config to clone for scale-out")
        return self.launcher.configs[best]

    def _spawn_slots(self, count: int, job_name: str, template,
                     spawn_event: str) -> list[int]:
        """Shared scale-out spawner (trainer and ingest tiers): open
        ``count`` slots under ``job_name``, spawn processes cloned from
        ``template``, and await their registration — rolling membership
        back on any failure."""
        import dataclasses as _dc

        new_ids = self.coordinator.open_slots(count, job_name=job_name)
        base = len(self.launcher.processes)
        configs = [_dc.replace(template, launch_index=base + j,
                               replace_executor_id=-1)
                   for j in range(count)]
        timeout = _env_float("TOS_RESERVATION_TIMEOUT", 120.0)
        try:
            self.launcher.spawn_more(configs)
            ttrace.event(spawn_event, executors=new_ids)
            self.coordinator.await_slots(new_ids, timeout)
        except Exception:
            # reap what never registered: an unjoined newcomer must not
            # linger half-booted, and its exit code is not the job's
            # verdict.  A spawn_more failure lands here too (possibly with
            # fewer than count processes appended), so guard the indexing.
            procs = self.launcher.processes
            for j in range(count):
                if base + j >= len(procs):
                    break
                proc = procs[base + j]
                with contextlib.suppress(Exception):
                    if proc.is_alive():
                        proc.terminate()
                self._audit_waived.add(base + j)
            # roll back membership so a LATER resize starts aligned:
            # cancel_slots atomically retires any slot that managed to
            # register before the timeout (it was just reaped — no error,
            # id never reused) and cancels the never-registered rest, so
            # open_slots' promised ids match registration order again and
            # no ghost inflates the default barrier/reduce count
            self.coordinator.cancel_slots(new_ids)
            raise
        self.cluster_info = self.coordinator.cluster_info()
        return new_ids

    def _scale_out(self, count: int) -> list[int]:
        new_ids = self._spawn_slots(count, "worker", self._worker_template(),
                                    "scale_out_spawn")
        for eid in new_ids:
            self._feed_ids.append(eid)
            self._attach_train_slot(eid)
            for gw in self._gateways:
                gw.add_replica(eid)
            ttrace.event("scale_out", executor=eid)
        return new_ids

    def _attach_train_slot(self, executor_id: int, tier: str = "nodes") -> bool:
        """Put a scale-out newcomer to work on an in-flight ``train()``:
        add a ledger slot, rebalance queued partitions onto it, and start
        its feed worker.  No-op (False) when no train is live — or when the
        live train feeds the OTHER tier (a trainer must never be handed the
        ingest ledger's shard items, nor an ingest worker a row feed)."""
        with self._train_lock:
            session = self._train_session
            if session is None or executor_id in self._active_ledger \
                    or session.get("tier", "nodes") != tier:
                return False
            ledger = session["ledger"]
            pos = ledger.add_slot()
            moved = ledger.rebalance_to(pos)
            self._active_ledger[executor_id] = (ledger, pos)
            session["spawn"](pos, executor_id)
        logger.info("executor %d joined the live feed (slot %d, %d queued "
                    "partition(s) rebalanced to it)", executor_id, pos, moved)
        return True

    def _pick_victims(self, count: int) -> list[int]:
        """Least-loaded victim selection: serving-router outstanding first
        (``replica_loads`` — the same numbers routing picks by), then
        ``feed.queue_depth`` from the rolling stats, ties broken newest-
        first.  The chief (executor 0) never retires — its process carries
        cluster-level duties (TensorBoard, the reference's master role)."""
        candidates = [eid for eid in self._feed_ids
                      if eid != 0 and eid not in self._retiring]
        if len(candidates) < count:
            raise ValueError(
                f"cannot retire {count} node(s): only {len(candidates)} "
                "retireable (the chief never retires)")
        loads: dict[int, float] = {eid: 0.0 for eid in candidates}
        for gw in self._gateways:
            for eid, n in gw.replica_loads().items():
                if eid in loads:
                    loads[eid] += n
        try:
            stats = self.coordinator.cluster_stats(5.0)
            fq = (stats.get("serving") or {}).get("feed_queue_depth") or {}
        except Exception:  # noqa: BLE001 - stats are advisory here
            fq = {}
        return sorted(candidates,
                      key=lambda eid: (loads[eid], fq.get(str(eid)) or 0,
                                       -eid))[:count]

    def _proc_for(self, executor_id: int):
        """(launch_index, process handle) for a slot, via the registered
        launch_index (pids cannot map over ssh transports)."""
        meta = next((m for m in self.cluster_info
                     if m["executor_id"] == executor_id), None)
        li = (meta or {}).get("launch_index", -1)
        procs = self.launcher.processes
        if 0 <= li < len(procs):
            return li, procs[li]
        return li, None

    def _send_eof_best_effort(self, executor_id: int, qname: str,
                              proc=None) -> None:
        """Best-effort end-of-feed to one node queue — the teardown
        protocol shared by ``shutdown()`` and scale-in retirement: one
        short dial on the pooled client, then one retry on a FRESH
        one-shot socket client, warning only on final failure.

        One-attempt dials throughout: the default 3x60s backoff would
        stack ~185s per queue against a blackholed host, all outside the
        caller's timeout budget.  The retry client skips shm-ring
        negotiation — no ring handshake just to deliver a ~20-byte EOF
        frame.  A node whose process already exited is a normal teardown
        race (its map_fun finished and closed its data plane first), not
        a failure."""
        try:
            self._client(executor_id, connect_timeout=5.0,
                         connect_attempts=1).send_eof(qname)
            return
        except Exception:  # noqa: BLE001 - retried on a fresh socket below
            if proc is not None and not proc.is_alive():
                logger.debug("node %d exited before EOF on %r",
                             executor_id, qname)
                return
            # The cached client's socket may have died with an earlier
            # timed-out call; this EOF is what unblocks the node's
            # next_batch, so retry once on a FRESH connection before
            # giving up.
            self._drop_client(executor_id)
            try:
                meta = self._fresh_meta(executor_id)
                retry = DataClient(meta["host"], meta["data_port"],
                                   self.authkey, prefer_ring=False,
                                   call_timeout=30.0, stall_timeout=30.0,
                                   connect_timeout=5.0, connect_attempts=1)
                try:
                    retry.send_eof(qname)
                finally:
                    with contextlib.suppress(Exception):
                        retry.close()
            except Exception:  # noqa: BLE001 - best-effort teardown
                logger.warning("could not send EOF to node %d queue %r",
                               executor_id, qname, exc_info=True)

    def _send_retirement_eof(self, executor_id: int) -> None:
        """End-of-feed to one retiring node so its map_fun exits cleanly
        (FIFO: everything already buffered is consumed first).  Best-effort
        — a node that died mid-drain gets reaped by the caller instead."""
        _, proc = self._proc_for(executor_id)
        for qname in self.input_qnames:
            self._send_eof_best_effort(executor_id, qname, proc=proc)

    def _scale_in(self, count: int, drain_timeout: float | None) -> list[int]:
        if drain_timeout is None:
            drain_timeout = _env_float("TOS_DRAIN_TIMEOUT", 60.0)
        victims = self._pick_victims(count)
        # Intent FIRST: from this moment a victim's death is retirement —
        # the supervisor declines recovery, the monitor requeues without
        # escalation, and no restart budget is charged.  Committed under
        # _train_lock against the live-inference marker: an inference()
        # call's partitions are statically assigned to the workers that
        # started it, so a retirement EOF mid-call would fail the whole
        # call on a healthy cluster — refuse instead (the autoscaler's
        # next tick simply retries).
        with self._train_lock:
            if self._inference_live:
                raise RuntimeError(
                    "cannot scale in during a live inference() call: its "
                    "partitions are statically assigned to the workers "
                    "that started it; retry after the call completes")
            for eid in victims:
                self._retiring.add(eid)
        for eid in victims:
            if self.supervisor is not None:
                self.supervisor.retire(eid)
        self.coordinator.mark_draining(victims)
        ttrace.event("drain_begin", executors=victims)
        # TOS_DRAIN_TIMEOUT is a PER-VICTIM budget (the knob's contract),
        # not a shared pot: every victim has been draining concurrently
        # since intent was marked above, so a loaded early victim consuming
        # its full budget must not starve the later ones into forced
        # terminates — each blocking step below gets the full allowance.
        # 1) Serving: drain each victim out of every gateway's routing
        #    (in-flight batches finish; queued ones re-route on timeout).
        for gw in self._gateways:
            for eid in victims:
                with contextlib.suppress(Exception):
                    gw.retire_replica(eid, timeout=max(1.0, drain_timeout))
        # 2) Training ledger: queued home partitions to the orphan pool,
        #    then wait for the in-flight feed and the buffered-but-
        #    unconsumed window to drain (watermark path).  A victim that
        #    dies here breaks the wait via is_tracked — the monitor already
        #    requeued its window.
        with self._train_lock:
            entries = [(eid, self._active_ledger.get(eid)) for eid in victims]
        for eid, entry in entries:
            if entry is not None:
                moved = entry[0].retire_slot(entry[1])
                if moved:
                    logger.info("%d queued partition(s) of retiring node %d "
                                "redistributed", moved, eid)
        for eid, entry in entries:
            if entry is None:
                continue
            ledger, pos = entry
            victim_deadline = time.monotonic() + drain_timeout
            while time.monotonic() < victim_deadline:
                if ledger.slot_idle(pos) and not ledger.needs_drain(pos):
                    break
                if not self.coordinator.is_tracked(eid):
                    break  # died/exited; the ledger re-feed owns its work
                if self._closing.is_set():
                    break  # shutdown owns teardown from here; stop waiting
                time.sleep(0.1)
        # 3) Retirement EOF -> map_fun exits -> clean process exit.
        for eid in victims:
            if self.coordinator.is_tracked(eid):
                self._send_retirement_eof(eid)
        # 4) Reap: join the process (a fresh per-victim budget — the
        #    knob's contract is per victim, and victims drained
        #    concurrently since intent, so a loaded early victim must not
        #    starve a later one into a forced terminate), escalating past
        #    it; then finalize the slot's retirement everywhere.
        for eid in victims:
            self._reap_retired(eid, drain_timeout, "node")
            if self.supervisor is None:
                telemetry.counter("elastic.retirements_total").inc()
            if eid in self._feed_ids:
                self._feed_ids.remove(eid)
            self._retiring.discard(eid)
            ttrace.event("scale_in", executor=eid)
        return victims

    def _reap_retired(self, executor_id: int, drain_timeout: float,
                      kind: str) -> None:
        """Shared scale-in reaper tail (trainer and ingest tiers): join the
        victim past its retirement EOF, escalate to terminate/kill, then
        finalize — requeue its ledger window, waive its exit code, drop
        its client, retire the slot.

        The requeue runs whatever ended the victim — clean EOF exit, our
        terminate, or a kill that landed too close to the reap for the
        monitor to declare (retire_node forecloses that declaration for
        good): idempotent (a fully-drained window requeues nothing), and
        at-least-once semantics demand re-feeding anything that cannot be
        PROVEN consumed."""
        li, proc = self._proc_for(executor_id)
        if proc is not None:
            proc.join(max(2.0, drain_timeout))
            if proc.is_alive():
                logger.warning("retiring %s %d did not exit after EOF; "
                               "terminating it", kind, executor_id)
                # stop liveness tracking FIRST so the monitor never flags
                # the terminate as a death
                self.coordinator.forget([executor_id])
                proc.terminate()
                proc.join(5.0)
                if proc.is_alive():
                    proc.kill()
                    proc.join(5.0)
        self._requeue_dead_slot(executor_id)
        if li >= 0:
            # a retired node's exit code is not the job's verdict (we may
            # have terminated it, or chaos killed it mid-drain)
            self._audit_waived.add(li)
        self._drop_client(executor_id, abort=True)
        self.coordinator.retire_node(executor_id)

    # -- data-service tier scaling (the ingest fleet knob) --------------------

    def resize_ingest(self, num_workers: int, *,
                      drain_timeout: float | None = None) -> dict:
        """Grow or shrink the data-service tier to ``num_workers`` live
        ingest workers — the fleet knob BENCH_r12's per-box decode ceiling
        becomes (decode parallelism was a per-trainer constant before this
        tier existed).

        Scale-out opens ``ingest``-role slots mid-run, spawns fresh node
        processes (the coordinator's role assignment routes them into
        ``ingest.service.ingest_worker_main``), and attaches each to an
        in-flight ingest-fed ``train()`` with a rebalanced ledger share.
        Scale-in drains the highest-numbered workers (ledger retire ->
        orphaned shard items re-feed to surviving workers -> retirement
        EOF -> reap), with the same at-least-once guarantees a worker
        death gets.  Trainers are untouched in both directions.

        Limitation: each worker snapshots the TRAINER endpoints at its own
        boot (``ingest_worker_main`` reads ``ctx.cluster_info``), so a
        trainer added by ``resize()`` mid-run joins the forwarding
        rotation only as workers (re)start — resize the trainer fleet
        between train() calls, or cycle the ingest tier afterwards."""
        if num_workers < 0:
            raise ValueError("resize_ingest needs num_workers >= 0")
        # same preconditions run() enforces for ingest_workers: the tier
        # only has work on a DIRECT cluster, and a torch_distributed world
        # has a fixed process count
        if self.input_mode != InputMode.DIRECT:
            raise RuntimeError(
                "resize_ingest needs InputMode.DIRECT: the data-service "
                "tier claims shard items from the ledger, which a "
                "STREAMING cluster never produces")
        if any(getattr(cfg, "torch_distributed", False)
               for cfg in getattr(self.launcher, "configs", [])):
            raise RuntimeError(
                "cannot resize the ingest tier of a torch.distributed job: "
                "a live process group has a fixed world size")
        with self._resize_lock:
            if self._closing.is_set() or self._shutdown_done:
                raise RuntimeError("cluster is shutting down")
            current = self.num_ingest()
            t0 = time.monotonic()
            if num_workers == current:
                return {"action": "noop", "tier": "ingest",
                        "from": current, "to": current}
            if num_workers > current:
                added = self._scale_out_ingest(num_workers - current)
                record: dict = {"action": "scale_out", "tier": "ingest",
                                "from": current, "to": current + len(added),
                                "added": added}
            else:
                retired = self._scale_in_ingest(current - num_workers,
                                                drain_timeout)
                record = {"action": "scale_in", "tier": "ingest",
                          "from": current, "to": current - len(retired),
                          "retired": retired}
            record["secs"] = round(time.monotonic() - t0, 3)
            self._resize_log.append(record)
            telemetry.counter(f"cluster.ingest_{record['action']}_total").inc()
            telemetry.gauge("cluster.ingest_workers").set(self.num_ingest())
            logger.info("ingest tier resized: %s", record)
            return dict(record)

    def _ingest_template(self):
        """NodeConfig to clone for ingest scale-out: any live config works
        (role assignment — not the config — routes a process into the
        service loop), preferring an existing ingest worker's so its
        ``ingest_opts`` tuning rides along."""
        best = None
        for meta in self.cluster_info:
            li = meta.get("launch_index", -1)
            if not 0 <= li < len(self.launcher.configs):
                continue
            if meta["executor_id"] in self._ingest_ids:
                return self.launcher.configs[li]
            if best is None:
                best = self.launcher.configs[li]
        if best is None:
            raise RuntimeError("no node config to clone for ingest scale-out")
        return best

    def _scale_out_ingest(self, count: int) -> list[int]:
        import dataclasses as _dc

        # ingest_tier: the newcomer reads no device facts before it knows
        # its role, so an ingest worker never initialises CUDA
        template = _dc.replace(self._ingest_template(), ingest_tier=True)
        new_ids = self._spawn_slots(count, "ingest", template,
                                    "ingest_scale_out_spawn")
        for eid in new_ids:
            self._ingest_ids.append(eid)
            self._attach_train_slot(eid, tier="ingest")
            ttrace.event("ingest_scale_out", executor=eid)
        return new_ids

    def _scale_in_ingest(self, count: int,
                         drain_timeout: float | None) -> list[int]:
        if drain_timeout is None:
            drain_timeout = _env_float("TOS_DRAIN_TIMEOUT", 60.0)
        candidates = [eid for eid in self._ingest_ids
                      if eid not in self._retiring]
        if len(candidates) < count:
            raise ValueError(f"cannot retire {count} ingest worker(s): only "
                             f"{len(candidates)} live")
        victims = sorted(candidates)[-count:]  # newest workers first out
        with self._train_lock:
            # A live ingest-fed train() must keep at least one worker: the
            # trainer tier's analogue is the chief-never-retires floor —
            # with ZERO survivors every ledger slot would retire, queued
            # partitions would orphan with nobody to deliver them, and
            # train() would return "success" with records never decoded.
            if (self._train_session is not None
                    and self._train_session.get("tier") == "ingest"
                    and count >= len(candidates)):
                raise RuntimeError(
                    "cannot retire every ingest worker while an ingest-fed "
                    "train() is in flight: its ledger partitions would "
                    "orphan with no worker to deliver them; keep >= 1, or "
                    "retry after the train completes")
            for eid in victims:
                self._retiring.add(eid)
        for eid in victims:
            if self.supervisor is not None:
                self.supervisor.retire(eid)
        self.coordinator.mark_draining(victims)
        ttrace.event("ingest_drain_begin", executors=victims)
        # queued shard items to the orphan pool; surviving workers (or the
        # victims themselves, for their in-flight item) deliver them
        with self._train_lock:
            entries = [(eid, self._active_ledger.get(eid)) for eid in victims]
        for eid, entry in entries:
            if entry is not None:
                moved = entry[0].retire_slot(entry[1])
                if moved:
                    logger.info("%d queued shard item(s) of retiring ingest "
                                "worker %d redistributed", moved, eid)
        for eid, entry in entries:
            if entry is None:
                continue
            ledger, pos = entry
            deadline = time.monotonic() + drain_timeout
            while time.monotonic() < deadline:
                if ledger.slot_idle(pos) and not ledger.needs_drain(pos):
                    break
                if not self.coordinator.is_tracked(eid):
                    break
                if self._closing.is_set():
                    break
                time.sleep(0.1)
        for eid in victims:
            if self.coordinator.is_tracked(eid):
                self._send_retirement_eof(eid)
        for eid in victims:
            self._reap_retired(eid, drain_timeout, "ingest worker")
            if eid in self._ingest_ids:
                self._ingest_ids.remove(eid)
            self._retiring.discard(eid)
            ttrace.event("ingest_scale_in", executor=eid)
        return victims

    def autoscale(self, policy=None, **kwargs):
        """Start a telemetry-driven autoscaling loop over :meth:`resize`:
        each tick samples ``cluster.stats(window)``, asks the policy for a
        desired node count, applies hysteresis (cooldown after any action;
        scale-in only after K consecutive under-target windows) and min/max
        bounds, and resizes.  Returns the started
        :class:`~tensorflowonspark_torch.autoscale.Autoscaler` (stopped
        automatically at shutdown), or None when disabled via
        ``TOS_AUTOSCALE=0`` — the ops kill switch.

        Keyword args (``min_nodes``, ``max_nodes``, ``tick_secs``,
        ``cooldown_secs``, ``scale_in_ticks``, ``window``, ...) pass through
        to ``Autoscaler``; the ``TOS_AUTOSCALE_*`` knobs supply defaults.
        """
        if not _env_bool("TOS_AUTOSCALE", True):
            logger.warning("autoscaling disabled by TOS_AUTOSCALE=0; "
                           "cluster.autoscale() is a no-op")
            return None
        from tensorflowonspark_torch.autoscale import Autoscaler

        scaler = Autoscaler(self, policy, **kwargs)
        scaler.start()
        self._autoscalers.append(scaler)
        return scaler

    # -- teardown (reference TFCluster.shutdown :~170-240, §3.5) -------------

    def shutdown(self, grace_secs: float = 0.0, timeout: float | None = None) -> None:
        """Send end-of-feed, join node processes, propagate node errors.

        ``timeout`` defaults to 120s, env-overridable via
        ``TOS_SHUTDOWN_TIMEOUT`` (and EOF delivery honours
        ``TOS_EOF_TIMEOUT``) — the ``TFOS_SERVER_TIMEOUT``-style ops knobs.
        """
        if timeout is None:
            timeout = _env_float("TOS_SHUTDOWN_TIMEOUT", 120.0)
        if self._shutdown_done:
            return
        # Autoscalers first: a policy loop firing resize() mid-teardown
        # would race the EOF/join sequence below.  _closing makes any
        # FUTURE resize() refuse and tells an in-flight drain to stop
        # waiting; the bare lock acquisition then barriers on that
        # in-flight resize actually releasing _feed_ids before teardown
        # iterates it (scaler.stop's 30s join alone could give up while a
        # long drain still holds the lock).
        self._closing.set()
        for scaler in self._autoscalers:
            with contextlib.suppress(Exception):
                scaler.stop()
        with self._resize_lock:
            pass
        # Stop the dead-node monitor first: shutdown's own escalation
        # (join -> stop -> terminate) owns failure handling from here, and
        # nodes it terminates must not be re-reported as deaths.  The
        # supervisor stops with it — a node dying during teardown is a
        # failure to report, not a slot to refill.
        self._monitor_stop.set()
        if self.supervisor is not None:
            self.supervisor.stop()
        if self.coordinator_supervisor is not None:
            # a coordinator crash during teardown stays down: the journal is
            # about saving runs, not resurrecting a server we are stopping
            self.coordinator_supervisor.stop()
        # Serving gateways first: their routers hold data-plane connections
        # and must stop dispatching before EOF ends the serving_loops.
        for gw in self._gateways:
            with contextlib.suppress(Exception):
                gw.close()
        self._gateways = []
        try:
            # EOF goes to BOTH input modes: a DIRECT-mode IngestFeed
            # consumes the path feed and its claimer winds down on
            # EndOfFeed exactly like a streaming DataFeed (self-service
            # DIRECT map_funs that never touch the feed leave it unread).
            # executor_id is assigned in REGISTRATION order, not launch
            # order — match processes through the launch_index each node
            # reported at registration (pids can't do this: over ssh
            # transports the local handle's pid is the ssh client).
            procs = self.launcher.processes
            id_to_proc = {
                m["executor_id"]: procs[m["launch_index"]]
                for m in self.cluster_info
                if 0 <= m.get("launch_index", -1) < len(procs)
            }
            # Ingest workers FIRST: their EOF ends the shard feed, each
            # service forwards its pipeline tail and exits — and the brief
            # join below lets that tail land BEFORE any trainer's
            # EndOfFeed is queued (FIFO: a chunk delivered before the
            # trainer's EOF is consumed, one after it is teardown-dropped).
            def _eof_node(executor_id: int) -> None:
                proc = id_to_proc.get(executor_id)
                if proc is not None and not proc.is_alive():
                    # node already finished and tore down its data plane;
                    # an EOF would only block on a dead peer
                    logger.debug("node %d already exited; skipping EOF",
                                 executor_id)
                    return
                for qname in self.input_qnames:
                    self._send_eof_best_effort(executor_id, qname, proc=proc)

            for executor_id in self._ingest_ids:
                _eof_node(executor_id)
            if self._ingest_ids:
                tail_deadline = time.monotonic() + min(15.0, timeout / 4.0)
                while time.monotonic() < tail_deadline and any(
                        p is not None and p.is_alive()
                        for p in (id_to_proc.get(e)
                                  for e in self._ingest_ids)):
                    time.sleep(0.1)
            for executor_id in self._feed_ids:
                _eof_node(executor_id)
            if grace_secs:
                time.sleep(grace_secs)
            # Politely wait for map_funs to finish; only then escalate.  The
            # stop flag breaks in-flight barriers/reduces, so raising it early
            # would abort healthy nodes mid-collective.  The wait is
            # DEATH-AWARE: if a node stops heartbeating mid-join, survivors
            # may be wedged in a collective with the dead peer forever —
            # waiting out the full polite timeout would just delay the
            # inevitable escalation (SURVEY.md §5.3 prompt fail-fast).
            forced = False
            death_detected = False
            deadline = time.monotonic() + timeout
            while True:
                slice_ = min(2.0, max(0.05, deadline - time.monotonic()))
                if self.launcher.join(slice_):
                    break
                dead = self._record_deaths()
                if dead:
                    death_detected = True
                    logger.warning("nodes %s died during shutdown; escalating now", dead)
                if death_detected or time.monotonic() >= deadline:
                    alive = self.launcher.alive()
                    logger.warning("nodes %s still running; signalling stop", alive)
                    self.coordinator.signal_stop()  # heartbeats tell stragglers to stop
                    # with a confirmed death, survivors wedged in collectives
                    # never drain — keep the post-stop grace short
                    if not self.launcher.join(5.0 if death_detected else 15.0):
                        forced = True
                        logger.warning("nodes %s ignored stop; terminating", self.launcher.alive())
                        self.launcher.terminate()
                    break
            for c in self._clients.values():
                c.close()
            # Run report BEFORE error propagation: a failed run is exactly
            # when the recorded restarts/faults/spans matter most.  Every
            # node has deregistered (or died) by now, so the coordinator's
            # per-node store holds the final snapshots.
            self._stop_metrics_export()
            # stream assembly copies every bounded span store and parses
            # every flight dump: gather once, feed both writers
            trace_streams: dict[str, dict] | None = None
            try:
                trace_streams = self._trace_streams_with_dumps()
            except Exception:  # noqa: BLE001 - tracing must not mask errors
                logger.warning("could not gather trace streams",
                               exc_info=True)
            try:
                trace_path = self.write_trace_artifacts(trace_streams)
                if trace_path:
                    logger.info("merged trace written to %s (load it at "
                                "https://ui.perfetto.dev)", trace_path)
            except Exception:  # noqa: BLE001 - tracing must not mask errors
                logger.warning("could not write trace artifacts",
                               exc_info=True)
            try:
                if telemetry.enabled() and _env_bool("TOS_RUN_REPORT", True):
                    report_path = self.write_run_report(
                        streams=trace_streams)
                    if report_path:
                        logger.info("run report written to %s", report_path)
            except Exception:  # noqa: BLE001 - reporting must not mask errors
                logger.warning("could not write run report", exc_info=True)
            self._raise_node_errors()
            all_codes = [p.exitcode for p in self.launcher.processes]
            if any(code is None for code in all_codes):
                # survived SIGTERM+SIGKILL: a live zombie may still hold chips
                raise RuntimeError(f"node processes could not be killed (exit codes {all_codes}); "
                                   f"zombie processes may be holding GPU devices")
            # intentionally-retired slots (resize scale-in) are excluded
            # from the audit: their terminate/kill-mid-drain exit codes are
            # the resize's business, not the job's verdict
            exit_codes = [c for i, c in enumerate(all_codes)
                          if i not in self._audit_waived]
            if forced:
                raise RuntimeError(f"node processes had to be force-terminated (exit codes {exit_codes})")
            if any(code != 0 for code in exit_codes):
                raise RuntimeError(f"node processes exited abnormally: {exit_codes}")
        finally:
            self._shutdown_done = True
            # idempotent: normally already stopped before the run report; an
            # early-raising shutdown path must still reap the export thread
            self._stop_metrics_export()
            self.coordinator.stop()

    def _stop_metrics_export(self) -> None:
        self._export_stop.set()
        if self._export_thread is not None:
            self._export_thread.join(timeout=10.0)
            self._export_thread = None

    def _raise_node_errors(self) -> None:
        errs = self.coordinator.errors()
        if errs:
            tb = errs[0].get("traceback", "")
            raise RuntimeError(
                f"node {errs[0].get('executor_id')} failed "
                f"({len(errs)} node error(s) total):\n{tb}"
            )

    # -- observability (reference TFCluster.tensorboard_url :~240-260) -------

    def metrics(self) -> dict:
        """Aggregated cluster-wide metrics snapshot.

        Per-node registry snapshots (as last reported over heartbeats /
        final deregister) plus the driver's own registry under ``"driver"``,
        merged by ``telemetry.aggregate_snapshots``: ``"counters"`` holds
        cluster totals, ``"histograms"`` merged span digests with pooled
        percentiles, ``"nodes"`` the per-node detail.
        """
        return self.coordinator.cluster_metrics()

    def stats(self, window: float = 10.0) -> dict:
        """Rolling-window LIVE stats — the autoscaling signals, not
        run-lifetime aggregates: qps, request p50/p99, serve-queue depth
        and in-flight batches (driver stream), plus per-node counter rates
        and feed-queue occupancy, all computed over the last ``window``
        seconds only.  The same payload is remotely queryable through the
        coordinator's ``statz`` op (``CoordinatorClient.stats``).  Headline
        fields live under ``"serving"``; per-stream detail under
        ``"streams"``."""
        return self.coordinator.cluster_stats(window)

    def _trace_streams_with_dumps(self) -> dict[str, dict]:
        """Every process's trace stream (heartbeat-shipped spans/events +
        clock offsets) keyed for export, plus any on-disk flight dumps a
        chaos kill left in ``log_dir`` (SIGKILL forecloses the heartbeat
        path — the dump file is the dead node's only record)."""
        streams: dict[str, dict] = {}
        for key, stream in self.coordinator.trace_streams().items():
            streams[key if key == "driver" else f"node{key}"] = stream
        if self.log_dir:
            for path in sorted(glob.glob(
                    os.path.join(self.log_dir, "flight_*.json"))):
                key = os.path.basename(path)[len("flight_"):-len(".json")]
                try:
                    with open(path, encoding="utf-8") as f:
                        streams[f"flight:{key}"] = json.load(f)
                except Exception:  # noqa: BLE001 - a torn dump must not mask the run
                    logger.debug("unreadable flight dump %s", path,
                                 exc_info=True)
        return streams

    def write_trace_artifacts(
            self, streams: dict[str, dict] | None = None) -> str | None:
        """Write the run's trace artifacts into ``log_dir``: one
        ``trace_<key>.json`` stream per process plus the merged,
        Perfetto-loadable ``trace.json``.  Returns the merged path, or
        None when tracing is off (``TOS_TRACE=0`` leaves zero artifacts)
        or there is no ``log_dir``.  Called automatically at shutdown;
        the standalone merge CLI is
        ``python -m tensorflowonspark_torch.telemetry.trace_export``."""
        if not self.log_dir:
            return None
        if streams is None:
            streams = self._trace_streams_with_dumps()
        # Tracing may be armed in the node processes only
        # (cluster.run(env={"TOS_TRACE": "1"})): node-shipped spans count
        # even when the driver's own tracer is off.  Flight events alone
        # don't (they're recorded regardless of TOS_TRACE): an untraced
        # chaos run keeps its timeline in run_report.json, and TOS_TRACE=0
        # everywhere still leaves zero trace artifacts.
        if not (ttrace.enabled()
                or any(s.get("spans") for s in streams.values())):
            return None
        if not any(s.get("spans") or s.get("events")
                   for s in streams.values()):
            return None
        for key, stream in streams.items():
            if key.startswith("flight:"):
                continue  # the chaos dump is already its own file
            ttrace_export.write_stream(
                os.path.join(self.log_dir, f"trace_{key}.json"), stream)
        return ttrace_export.write_merged(
            os.path.join(self.log_dir, "trace.json"), streams)

    def debug_dump(self) -> str:
        """Human-readable text report of ``metrics()`` (paste into a bug
        report; the run report is the JSON twin)."""
        return telemetry.debug_dump(self.metrics())

    def write_run_report(self, path: str | None = None,
                         streams: dict[str, dict] | None = None) -> str | None:
        """Write the end-of-run JSON run report; returns the path (None when
        there is nowhere to write: no ``path`` and no ``log_dir``).

        Called automatically at ``shutdown()`` when ``TOS_RUN_REPORT`` is on
        and the cluster has a ``log_dir`` — the report lands next to the
        job's event files / checkpoints as ``run_report.json``.
        """
        if path is None:
            if not self.log_dir:
                return None
            path = os.path.join(self.log_dir, "run_report.json")
        extras: dict = {
            "num_executors": len(self.cluster_info),
            "node_errors": len(self.coordinator.errors()),
            "restarts_by_executor": (
                {str(eid): self.supervisor.restart_count(eid)
                 for eid in self._feed_ids
                 if self.supervisor.restart_count(eid)}
                if self.supervisor is not None else {}),
        }
        if self.coordinator_supervisor is not None and self.coordinator.epoch:
            # a control-plane failover happened: the headline evidence
            extras["coordinator"] = {
                "epoch": self.coordinator.epoch,
                "recoveries": self.coordinator_supervisor.restart_count(),
            }
        if self._resize_log or self._autoscalers:
            # the elasticity postmortem: every resize the run performed and
            # (when a policy loop drove them) every decision it took
            autoscale_block: dict = {
                "final_nodes": self.num_feedable(),
                "resizes": [dict(r) for r in self._resize_log],
            }
            for scaler in self._autoscalers:
                try:
                    autoscale_block.setdefault("policies", []).append(
                        scaler.report())
                except Exception:  # noqa: BLE001 - reporting must not mask the run
                    logger.debug("autoscaler report failed", exc_info=True)
            extras["autoscale"] = autoscale_block
        try:
            # flight-recorder timeline: every process's structured events
            # (kills, deaths, retries, resyncs, reloads) merged onto the
            # driver clock — the postmortem a chaos exit is read by
            flight = ttrace.merge_events(
                self._trace_streams_with_dumps()
                if streams is None else streams)
            if flight:
                extras["flight"] = {"events": flight}
        except Exception:  # noqa: BLE001 - reporting must not mask the run error
            logger.debug("could not merge flight events", exc_info=True)
        report = telemetry.build_run_report(
            self.metrics(),
            wall_secs=round(time.monotonic() - self._started_at, 3),
            extras=extras)
        return telemetry.write_run_report(path, report)

    def _metrics_export_loop(self) -> None:
        """Every ``TOS_METRICS_EXPORT_SECS``: aggregate + write TB scalars."""
        from tensorflowonspark_torch.summary import SummaryWriter

        period = _env_float("TOS_METRICS_EXPORT_SECS", 30.0)
        writer: SummaryWriter | None = None
        step = 0
        while not self._export_stop.wait(period):
            step += 1
            try:
                if writer is None:
                    writer = SummaryWriter(os.path.join(self.log_dir, "metrics"))
                self._export_metrics_once(writer, step)
            except Exception:  # noqa: BLE001 - observability must not kill jobs
                logger.warning("metrics export failed", exc_info=True)
        # final flush on stop so short runs still leave a scalar trail
        try:
            if writer is None:
                writer = SummaryWriter(os.path.join(self.log_dir, "metrics"))
            self._export_metrics_once(writer, step + 1)
            writer.close()
        except Exception:  # noqa: BLE001
            logger.debug("final metrics export failed", exc_info=True)

    def _export_metrics_once(self, writer, step: int) -> None:
        snap = self.metrics()
        scalars: dict[str, float] = {}
        for name, value in (snap.get("counters") or {}).items():
            scalars[f"metrics/{name}"] = float(value)
        for name, d in (snap.get("histograms") or {}).items():
            for key in ("mean", "p50", "p90", "p99"):
                v = d.get(key)
                if v is not None:
                    scalars[f"metrics/{name}/{key}"] = float(v)
        if scalars:
            writer.add_scalars(scalars, step=step)
            writer.flush()

    def tensorboard_url(self) -> str | None:
        for meta in self.coordinator.cluster_info():
            if "tb_url" in meta:
                return meta["tb_url"]
        return None


def run(
    map_fun: Callable,
    tf_args: Any = None,
    num_executors: int = 1,
    input_mode: InputMode = InputMode.DIRECT,
    master_node: str | None = None,
    eval_node: bool = False,
    tensorboard: bool = False,
    log_dir: str = "",
    default_fs: str = "",
    queues: Sequence[str] = ("input", "output", "error"),
    queue_capacity: int = 1024,
    feed_timeout: float | None = None,
    reservation_timeout: float | None = None,
    heartbeat_interval: float = 2.0,
    launcher: Any | None = None,
    env: dict[str, str] | None = None,
    per_node_env: Sequence[dict[str, str]] | None = None,
    torch_distributed: bool = False,
    coordinator_host: str | None = None,
    elastic: bool | RestartPolicy = False,
    ingest_workers: int | None = None,
    ingest_opts: dict | None = None,
) -> TorchCluster:
    """Start a cluster (reference ``TFCluster.run`` ``:~270-420``).

    No ``sc`` (no Spark), no ``num_ps`` (sync SPMD replaces parameter
    servers), no ``driver_ps_nodes``/``release_port`` (their race classes are
    designed out — SURVEY.md §5.2).

    ``env`` applies to every node; ``per_node_env`` (one dict per executor)
    layers per-process overrides on top — the carrier for disjoint
    accelerator slices (``CUDA_VISIBLE_DEVICES``) when several node
    processes share a host.

    ``reservation_timeout``/``feed_timeout`` default from the
    ``TOS_RESERVATION_TIMEOUT``/``TOS_FEED_TIMEOUT`` env vars when not given
    (the reference's ``TFOS_SERVER_TIMEOUT``-style ops knobs), else
    120s/600s.

    ``elastic`` turns data-node deaths into supervised restarts (True for the
    env-tuned ``RestartPolicy``, or pass a policy): the slot's incarnation is
    fenced, the process is respawned with backoff, the replacement resumes
    from the latest checkpoint (``ctx.is_restart`` /
    ``checkpoint.restore_for_restart``), and unacknowledged partitions are
    re-fed (at-least-once for training; exactly-once per partition for
    inference).  Feed-driven map_funs only: a ``torch.distributed`` job
    cannot readmit a process into a live process group, so the combination
    is refused,
    and map_funs built on control-plane consensus (``ctx.all_done``) need
    application-level resync a restart does not provide.

    ``torch_distributed`` makes the data nodes one
    ``torch.distributed`` world: rank = executor id, the chief's port
    handed out through a control-plane max-reduce, NCCL on the card (gloo
    when the map_fun's args ask for ``device="cpu"``).

    ``ingest_workers`` (default ``TOS_INGEST_WORKERS``) adds that many
    standalone DATA-SERVICE nodes (role ``ingest``, the tf.data-service
    design): a DIRECT-mode ``train()`` then feeds its shard items to the
    worker pool, which decodes on its own cores (with the cross-epoch
    chunk cache, ``TOS_INGEST_CACHE_BYTES``) and streams packed chunks to
    every trainer over the zero-copy wire — decode parallelism becomes the
    ``cluster.resize_ingest`` fleet knob instead of a per-trainer
    constant.  ``ingest_opts`` carries the tier's decode configuration
    (``schema=``, ``chunk_records=``, ``readers=``, ``cache_bytes=``,
    ``shuffle=``, ... — :class:`~tensorflowonspark_torch.ingest.service.
    IngestService` keywords).  DIRECT mode only, and not combinable with
    ``torch_distributed`` (the workers are not process-group members).
    An ingest worker decodes on host cores and never opens the card: the
    node hides every CUDA device from itself once it is assigned the
    ``ingest`` role.

    ``coordinator_host`` pins the control-plane bind/advertise interface
    (default: bind all interfaces, advertise the routable ``local_ip()`` so
    remote executors launched over ssh can actually dial back — reference
    ``reservation.Server`` behavior).  The control plane authenticates every
    connection with the per-cluster ``authkey`` (HMAC challenge-response,
    same handshake as the data plane).
    """
    if elastic and torch_distributed:
        raise ValueError(
            "elastic=... cannot be combined with a torch.distributed job: a "
            "restarted process cannot rejoin a live process group "
            "(TF-Replicator generation semantics); run elastic jobs without "
            "torch_distributed")
    if reservation_timeout is None:
        reservation_timeout = _env_float("TOS_RESERVATION_TIMEOUT", 120.0)
    if feed_timeout is None:
        feed_timeout = _env_float("TOS_FEED_TIMEOUT", 600.0)
    if ingest_workers is None:
        ingest_workers = _env_int("TOS_INGEST_WORKERS", 0, minimum=0)
    ingest_workers = max(0, int(ingest_workers))
    if ingest_workers and input_mode != InputMode.DIRECT:
        raise ValueError(
            "ingest_workers need InputMode.DIRECT: the data-service tier "
            "claims shard items from the ledger (STREAMING clusters stream "
            "rows from the driver and have nothing for the tier to decode)")
    if ingest_workers and torch_distributed:
        raise ValueError(
            "ingest_workers cannot be combined with torch_distributed: "
            "data-service workers are not members of the process group, "
            "whose ranks are the contiguous data-node ids")
    total_procs = num_executors + ingest_workers
    if per_node_env is not None and len(per_node_env) not in (
            num_executors, total_procs):
        raise ValueError(f"per_node_env needs {num_executors} (trainer) or "
                         f"{total_procs} (trainer+ingest) entries, got "
                         f"{len(per_node_env)}")
    roles = _build_roles(num_executors, master_node, eval_node)
    # data-service slots come LAST so trainer/evaluator ids keep their
    # contiguous reference layout; role assignment is registration-order,
    # so node_main's role-aware dispatch (not the config) decides which
    # process actually runs the service loop
    roles.extend(("ingest", i) for i in range(ingest_workers))
    authkey = secrets.token_bytes(16)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    # Control-plane write-ahead journal (ISSUE 13): with a log_dir every
    # coordinator mutation is journaled to <log_dir>/coordinator.journal and
    # a coordinator crash becomes a supervised, epoch-bumping restart
    # (TorchCluster wires the CoordinatorSupervisor); journal-less
    # coordinators keep the old behaviour — a crash is fatal.
    coordinator = CoordinatorServer(
        total_procs, roles, authkey=authkey,
        journal_path=(os.path.join(log_dir, "coordinator.journal")
                      if log_dir else None))
    addr = coordinator.start(coordinator_host)

    configs = [
        NodeConfig(
            coordinator_addr=addr,
            authkey=authkey,
            map_fun=map_fun,
            tf_args=tf_args,
            queues=tuple(queues),
            input_qnames=tuple(q for q in queues if q not in ("output", "error")),
            input_mode=("direct" if input_mode == InputMode.DIRECT
                        else "streaming"),
            queue_capacity=queue_capacity,
            feed_timeout=feed_timeout,
            reservation_timeout=reservation_timeout,
            heartbeat_interval=heartbeat_interval,
            default_fs=default_fs,
            log_dir=log_dir,
            tensorboard=tensorboard,
            torch_distributed=torch_distributed,
            env={**(env or {}),
                 **(per_node_env[i] if per_node_env is not None
                    and i < len(per_node_env) else {})},
            launch_index=i,
            ingest_opts=dict(ingest_opts) if ingest_opts else None,
            ingest_tier=bool(ingest_workers),
        )
        for i in range(total_procs)
    ]
    # Default to SubprocessLauncher: children run the lean ``node_entry``
    # module directly (~0.5s to a live node), where multiprocessing-spawn
    # re-imports the driver's __main__ machinery in every child (~3s under
    # pytest), and OS-level env (CUDA_VISIBLE_DEVICES) lands before the
    # child interpreter starts.
    launcher = launcher or SubprocessLauncher()
    try:
        launcher.launch(configs, log_dir or None)
    except BaseException:
        # e.g. a map_fun pickle cannot carry: nothing may outlive the refusal
        launcher.terminate()
        coordinator.stop()
        raise
    try:
        cluster_info = coordinator.await_registrations(reservation_timeout)
    except TimeoutError:
        launcher.terminate()
        coordinator.stop()
        raise
    logger.info("cluster up: %s", [(m["executor_id"], m["job_name"]) for m in cluster_info])
    return TorchCluster(coordinator, launcher, cluster_info, authkey,
                        input_mode, queues, feed_timeout, heartbeat_interval,
                        elastic=elastic, log_dir=log_dir)
