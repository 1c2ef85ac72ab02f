"""Least-outstanding batch routing across node replicas.

The availability half of the serving subsystem: each feedable node runs the
resident ``serving_loop`` map_fun and this router spreads micro-batches
across them — every batch goes to the healthy replica with the fewest
outstanding (queued + in-flight) batches, the closed-loop analogue of the
reference's Spark partition placement, but latency-aware.

Transport is the existing data plane: one ``DataClient`` per replica, each
batch one ``infer_partition`` round-trip (protocol-5 zero-copy frames,
exactly-count ordered results).  One worker thread per replica serializes
its rounds — interleaving two batches on one connection would interleave
their rows in the node's input queue.

Failure semantics (wired into the ISSUE-1 elastic machinery):

- a batch in flight on a replica that dies is retried ONCE on a live
  replica before its waiters see an error;
- the dead replica is marked unhealthy and its queued (not yet attempted)
  batches re-route to survivors without spending their retry;
- a recovery thread re-admits the replica once it is reachable again —
  restarted (bumped incarnation, fresh queues) or still the same live
  process (a severed socket, a timed-out round) — but only after an
  order-fenced *resync*: a nonce'd ping control round whose pong, by the
  map_fun's FIFO processing, proves every result of an abandoned round
  has been drained and discarded, so stale results can never corrupt a
  later batch's exactly-count collection (``_resync``).  A hot reload the
  replica missed while out is replayed before it rejoins routing.

Hot reload support: ``drain()`` blocks until no batch is queued or in
flight, and ``broadcast_ctl()`` round-trips a control item (e.g. the
``serving_loop`` reload command) through every healthy replica while the
workers are idle.

Staged rollouts (ISSUE 16): ``set_rollout`` splits the fleet into a
primary and a canary cohort.  Routing becomes cohort-aware — every
``traffic_every``-th batch rides the canary, every ``mirror_every``-th
successful primary batch is cloned onto the canary as a no-waiter shadow
mirror carrying the primary's results for output diffing, and every batch
outcome (cohort, latency, results, transport error) feeds the rollout
governor's observer.  Live traffic never depends on the canary: a canary
batch with no healthy canary falls back to primary, a failed canary
attempt retries on primary, and mirrors are dropped (shed first under
brownout).  ``ctl_to`` targets control rounds at one cohort, and the
cohort's reload ctl is remembered so a canary that dies mid-rollout is
converged back onto the candidate bundle before re-admission.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import threading
from tensorflowonspark_torch.utils.locks import tos_named_condition
from time import monotonic as _monotonic
from typing import Any

from tensorflowonspark_torch import telemetry
from tensorflowonspark_torch.serving.batcher import (
    CTL_KEY,
    MicroBatch,
    MicroBatcher,
)
from tensorflowonspark_torch.telemetry import trace as ttrace

logger = logging.getLogger(__name__)


class EmbedLookupError(RuntimeError):
    """A sharded-embedding fan-out round failed (a shard OWNER was
    unreachable or timed out).  Deliberately distinct from a scoring-
    replica transport error: the scoring replica is healthy and must not
    be fenced for another node's shard being dark — the batch retries
    (the owner may have recovered) and then fails its waiters."""


class _Replica:
    __slots__ = ("executor_id", "queue", "inflight", "healthy", "client",
                 "client_inc", "pending_ctl", "thread", "last_pick",
                 "draining", "retired", "cohort")

    def __init__(self, executor_id: int):
        self.executor_id = executor_id
        self.queue: list[MicroBatch] = []
        self.inflight = 0
        self.healthy = True
        self.client = None
        self.client_inc = -1
        # a control item (hot reload) this replica missed while unhealthy;
        # replayed by recovery before the replica rejoins routing
        self.pending_ctl: dict | None = None
        self.thread: threading.Thread | None = None
        self.last_pick = 0
        # rollout cohort: "primary" outside a rollout; the canary members
        # of an active rollout carry "canary" (the object outlives the
        # replica PROCESS, so a SIGKILLed canary's restart rejoins the
        # same cohort — recovery replays the cohort's reload ctl first)
        self.cohort = "primary"
        # scale-in lifecycle (retire_replica): a DRAINING replica finishes
        # its queued/in-flight batches but is never picked for new ones;
        # RETIRED tells its worker thread to exit once the queue is empty
        self.draining = False
        self.retired = False


def _load(rep: _Replica) -> int:
    """A replica's outstanding work (queued + in-flight batches) — the ONE
    load definition shared by routing picks, the inflight gauge, the public
    ``replica_loads()`` surface, and autoscaling victim selection."""
    return len(rep.queue) + rep.inflight


# monotone per-process router id: the key each router publishes its serving
# replica set under in the coordinator's journal-backed registry
# (itertools.count: gateways can be opened from concurrent threads)
_ROUTER_SEQ = itertools.count(1)


class ReplicaRouter:
    """Dispatch micro-batches to the cluster's serving replicas."""

    def __init__(self, cluster, batcher: MicroBatcher, *,
                 qname_in: str = "input", qname_out: str = "output",
                 request_timeout: float = 30.0):
        self._cluster = cluster
        self._batcher = batcher
        self.qname_in = qname_in
        self.qname_out = qname_out
        # Data-plane budgets: serving round-trips are sub-second, so a
        # replica that stalls past a couple of request deadlines is treated
        # as failed (the retry path owns recovery) instead of pinning a
        # worker for the feed-path's ~10-minute budget.
        self._stall_timeout = max(10.0, 2.0 * request_timeout)
        self._call_timeout = self._stall_timeout + 30.0
        self._cond = tos_named_condition("router._cond")
        self._stop = False
        self._pick_seq = 0
        self._resync_seq = 0  # recovery-thread only; nonces for _resync
        # rollout state (set_rollout/clear_rollout): deterministic traffic
        # split + shadow mirroring + the per-batch outcome observer the
        # rollout governor feeds on.  All mutated under _cond.
        self._batch_seq = 0
        self._mirror_seq = 0
        self._canary_every = 0   # every Nth batch routes to canary (0=off)
        self._mirror_every = 0   # every Nth primary batch mirrored (0=off)
        self._observer = None    # fn(cohort, eid, ok, secs, results, error, mirror_of)
        self._cohort_ctl: dict[str, dict] = {}  # cohort -> reload ctl for recovery
        self._shed_fn = lambda: 0  # batcher brownout level (sheds mirrors)
        self._replicas: dict[int, _Replica] = {
            eid: _Replica(eid) for eid in cluster._feed_ids}
        # sharded-embedding fan-out state (set_embed_plan): owner plan over
        # the serve fleet, the id-extraction fn from the bundle config, and
        # one DEDICATED DataClient per shard owner on the embed queue pair
        # — reusing rep.client would interleave lookup results into batch
        # rounds and break their exactly-count collection.  Per-owner locks
        # serialize rounds per connection for the same reason.
        self._embed_plan = None
        self._embed_id_fn = None
        self._embed_owners: list[int] = []
        self._embed_clients: dict[int, Any] = {}
        self._embed_locks: dict[int, Any] = {}
        # journal-backed serving registry (ISSUE 13): this router's healthy
        # replica set, published to the coordinator whenever it changes so
        # a control-plane failover restores who was serving
        self._registry_name = f"router{next(_ROUTER_SEQ)}"
        self._published: list[int] | None = None
        self._healthy_gauge = telemetry.gauge("serve.replicas_healthy")
        self._draining_gauge = telemetry.gauge("serve.replicas_draining")
        self._outstanding_gauge = telemetry.gauge("serve.inflight_batches")
        self._healthy_gauge.set(len(self._replicas))
        self._draining_gauge.set(0)
        for rep in self._replicas.values():
            rep.thread = threading.Thread(
                target=self._worker, args=(rep,), daemon=True,
                name=f"serve-replica-{rep.executor_id}")
            rep.thread.start()
        self._recovery = threading.Thread(target=self._recovery_loop,
                                          daemon=True, name="serve-recovery")
        self._recovery.start()
        self._publish_registry()

    def _publish_registry(self) -> None:
        """Best-effort publish of this router's healthy replica set to the
        coordinator's journal-backed serving registry (no-op changes are
        deduped).  Never on a hot path; never raises — the registry is
        failover evidence, not routing state."""
        coord = getattr(self._cluster, "coordinator", None)
        if coord is None or not hasattr(coord, "note_serving_replicas"):
            return
        try:
            healthy = self.healthy_replicas()
            if healthy != self._published:
                self._published = healthy
                coord.note_serving_replicas(self._registry_name, healthy)
        except Exception:  # noqa: BLE001 - registry publish must not break serving
            logger.debug("serving-registry publish failed", exc_info=True)

    # -- dispatch ------------------------------------------------------------

    def submit(self, batch: MicroBatch, exclude: int | None = None) -> None:
        """Queue the batch on the least-outstanding healthy replica of its
        cohort; a batch that finds no healthy replica fails its waiters
        immediately.  Cohort selection: a fresh batch is assigned here
        (every ``canary_every``-th batch rides the canary during a live
        split); a canary batch with no healthy canary replica falls back
        to primary — live traffic must never fail because the canary
        cohort is down — while a shadow MIRROR (nothing waits on it) is
        simply dropped."""
        with self._cond:
            if batch.cohort is None:
                batch.cohort = self._choose_cohort_locked()
            target = None if self._stop else self._pick_locked(
                exclude, batch.cohort)
            if target is None and batch.cohort == "canary" and not self._stop:
                if batch.mirror_of is not None:
                    telemetry.counter("serve.shadow_dropped").inc()
                    return
                batch.cohort = "primary"
                target = self._pick_locked(exclude, "primary")
            if target is not None:
                target.queue.append(batch)
                self._update_outstanding_locked()
                self._cond.notify_all()
                return
        if batch.mirror_of is not None:
            return  # mirrors carry no waiters; nothing to fail
        self._batcher.fail_batch(batch, RuntimeError(
            "no healthy serving replica available"))

    def _choose_cohort_locked(self) -> str:
        if not self._canary_every:
            return "primary"
        self._batch_seq += 1
        return ("canary" if self._batch_seq % self._canary_every == 0
                else "primary")

    def _pick_locked(self, exclude: int | None,
                     cohort: str = "primary") -> _Replica | None:
        live = [r for r in self._replicas.values()
                if r.healthy and not r.draining and r.executor_id != exclude
                and r.cohort == cohort]
        if not live:
            return None
        # least-outstanding, ties broken least-recently-picked: a fixed
        # tiebreak (executor id) would route EVERY batch to replica 0 at
        # low load, leaving the rest cold — LRU rotation spreads them
        target = min(live, key=lambda r: (_load(r), r.last_pick))
        self._pick_seq += 1
        target.last_pick = self._pick_seq
        return target

    def _update_outstanding_locked(self) -> None:
        self._outstanding_gauge.set(sum(
            _load(r) for r in self._replicas.values()))

    def has_capacity(self) -> bool:
        """True while some healthy replica is strictly IDLE (0 outstanding).
        The batcher gates partial-batch flushes on this — see
        ``MicroBatcher``.  Strictly-idle beats allowing one queued batch
        behind the in-flight one on the bench box: the queued slot just
        re-creates a small-batch convoy (fill p50 6 rows / 280 qps at
        ``<= 1`` vs 9+ rows / 430 qps at ``== 0``).  Full batches are
        gated too — they wait in the BATCHER queue rather than a replica
        queue, which costs one completion-notify wakeup but keeps the
        least-outstanding choice as late (= as informed) as possible.
        With NO healthy replica it returns True so batches flush and fail
        fast instead of silently aging out on their deadlines.  Only the
        PRIMARY cohort counts: during a shadow rollout the canary replicas
        sit idle between mirrors, and letting their idleness trigger
        partial flushes would re-create the small-batch convoy on the
        primaries that actually serve the traffic."""
        with self._cond:
            live = [r for r in self._replicas.values()
                    if r.healthy and not r.draining
                    and r.cohort == "primary"]
            if not live:
                return True
            return any(_load(r) == 0 for r in live)

    # -- per-replica worker --------------------------------------------------

    def _worker(self, rep: _Replica) -> None:
        while True:
            exit_client = None
            with self._cond:
                while not self._stop and not rep.queue and not rep.retired:
                    self._cond.wait(0.2)
                if self._stop or (rep.retired and not rep.queue):
                    if rep.retired:
                        # retire_replica leaves the client to us when we
                        # outlived its join (batch completing past the
                        # drain deadline); on stop, close() owns clients
                        exit_client, rep.client = rep.client, None
                    batch = None
                else:
                    batch = rep.queue.pop(0)
                    rep.inflight += 1
                    self._update_outstanding_locked()
            if batch is None:
                if exit_client is not None:
                    with contextlib.suppress(Exception):
                        exit_client.close()
                return
            error: Exception | None = None
            results: list | None = None
            if batch.trace is not None and batch.retries == 0:
                # stage span: batch fill/hold (built -> wire call starts;
                # capacity holds and router queueing both land here).  Only
                # the first dispatch records it — a retried batch would emit
                # a second fill span spanning the failed wire attempt too
                ttrace.record_child(
                    "serve.batch_fill", batch.trace, batch.created_at,
                    _monotonic() - batch.created_at)
            t0 = _monotonic()
            try:
                client = self._client_for(rep)
                wire_rows = batch.rows
                wrapped = False
                if self._embed_plan is not None:
                    # sharded-embedding mode: gather the batch's fused-table
                    # rows from the owner shards first, then ship ONE
                    # wrapped item — the scoring replica answers with one
                    # result item the unwrap below opens (exactly-count: 1)
                    with ttrace.span("serve.embed_fanout",
                                     parent=batch.trace):
                        emb = self._gather_embeddings(batch.rows)
                    wire_rows = [{CTL_KEY: "sharded_batch",
                                  "rows": list(batch.rows), "emb": emb}]
                    wrapped = True
                with telemetry.timed("serve.batch_secs"), \
                        ttrace.span("serve.wire", parent=batch.trace,
                                    tags={"executor": rep.executor_id}) as ws:
                    results = client.infer_round(
                        wire_rows, self.qname_in, self.qname_out,
                        trace=ws.ctx)
                if wrapped:
                    ack = results[0] if results else None
                    if not (isinstance(ack, dict)
                            and ack.get(CTL_KEY) == "sharded_results"):
                        raise RuntimeError(
                            f"sharded batch round answered {type(ack)}")
                    results = list(ack["results"])
            except Exception as e:  # noqa: BLE001 - retried/surfaced below
                error = e
            rerouted: list[MicroBatch] = []
            with self._cond:
                rep.inflight -= 1
                if (error is not None and not self._stop
                        and not isinstance(error, EmbedLookupError)):
                    # a failed LOOKUP owner is not this replica's failure —
                    # fence nothing; the retry redoes the fan-out
                    rerouted = self._mark_unhealthy_locked(rep)
                self._update_outstanding_locked()
                self._cond.notify_all()
            self._observe(batch, rep, error, _monotonic() - t0, results)
            if error is None:
                if batch.mirror_of is None:
                    self._batcher.complete_batch(batch, results)
                    self._maybe_mirror(batch, results)
                # a mirror's results went to the observer (output diff);
                # nothing waits on the batch itself
                continue
            logger.warning("serving replica %d failed a batch: %s",
                           rep.executor_id, error)
            for queued in rerouted:
                # never attempted on this replica: re-route without
                # spending the queued batch's one retry
                self.submit(queued, exclude=rep.executor_id)
            if batch.mirror_of is not None:
                continue  # a failed mirror is dropped, never retried
            self._retry(batch, rep.executor_id, error)

    def _observe(self, batch: MicroBatch, rep: _Replica,
                 error: Exception | None, secs: float,
                 results: list | None) -> None:
        """Feed one batch outcome to the rollout observer (never on the
        lock, never allowed to break serving).  The observer owns the
        canary-vs-primary bookkeeping — error classification (an exception
        HERE is transport/infra, e.g. a dead replica, and must not count
        as model regression), latency windows, NaN/divergence scans."""
        obs = self._observer
        if obs is None:
            return
        try:
            obs(batch.cohort or "primary", rep.executor_id, error is None,
                secs, results, error, batch.mirror_of)
        except Exception:  # noqa: BLE001 - rollout bookkeeping must not break serving
            logger.debug("rollout observer failed", exc_info=True)

    def _maybe_mirror(self, batch: MicroBatch, results: list) -> None:
        """Shadow sampling: clone every ``mirror_every``-th successful
        PRIMARY batch onto the canary cohort, carrying the primary's
        results for the observer's output diff.  Mirrors have no entries —
        no client ever waits on one — and are the FIRST traffic shed under
        brownout (ladder level 1)."""
        if (self._mirror_every <= 0 or batch.cohort != "primary"
                or batch.mirror_of is not None):
            return
        if self._shed_fn() >= 1:
            telemetry.counter("serve.shadow_shed").inc()
            return
        with self._cond:
            self._mirror_seq += 1
            if self._mirror_seq % self._mirror_every:
                return
        mirror = MicroBatch(batch.rows, batch.n, [])
        mirror.cohort = "canary"
        mirror.mirror_of = results
        telemetry.counter("serve.shadow_mirrors").inc()
        self.submit(mirror)

    def _retry(self, batch: MicroBatch, failed_eid: int,
               error: Exception) -> None:
        if batch.retries < 1:
            batch.retries += 1
            telemetry.counter("serve.retries_total").inc()
            ttrace.event("retry", executor=failed_eid, rows=batch.n,
                         error=str(error)[:200])
            logger.warning("retrying in-flight batch from dead replica %d "
                           "on a live replica", failed_eid)
            # a failed canary attempt retries on the PRIMARY cohort: the
            # request's answer must never depend on the canary staying up
            if batch.cohort == "canary":
                batch.cohort = "primary"
            self.submit(batch, exclude=failed_eid)
            return
        wrapped = RuntimeError(
            f"serving batch failed on replica {failed_eid} after retry: "
            f"{error}")
        wrapped.__cause__ = error
        self._batcher.fail_batch(batch, wrapped)

    def _mark_unhealthy_locked(self, rep: _Replica) -> list[MicroBatch]:
        """Fence the replica out of routing; returns its queued batches for
        the caller to re-route OUTSIDE the lock.  Re-admission goes through
        ``_try_recover`` (dial + order-fenced resync), which handles both a
        restarted process and a live one whose round was abandoned."""
        if rep.healthy:
            rep.healthy = False
            telemetry.counter("serve.replica_failures").inc()
            ttrace.event("replica_unhealthy", executor=rep.executor_id)
        stale, rep.client = rep.client, None
        if stale is not None:
            with contextlib.suppress(Exception):
                stale.abort()
        queued, rep.queue = rep.queue, []
        self._healthy_gauge.set(
            sum(1 for r in self._replicas.values() if r.healthy))
        return queued

    def _client_for(self, rep: _Replica):
        """The replica's data client, dialing if needed.  Only its own worker
        (or the drained/paused reload path) calls this, so the mutation needs
        no lock — routing never hands one replica's rounds to another
        thread."""
        if rep.client is None:
            from tensorflowonspark_torch.dataserver import DataClient

            meta = self._cluster._fresh_meta(rep.executor_id)
            inc, _ = self._cluster.coordinator.registered_incarnation(
                rep.executor_id)
            rep.client = DataClient(
                meta["host"], meta["data_port"], self._cluster.authkey,
                call_timeout=self._call_timeout,
                stall_timeout=self._stall_timeout,
                connect_timeout=10.0)
            rep.client_inc = inc
        return rep.client

    # -- sharded-embedding fan-out (gateway.set via set_embed_plan) ----------

    def set_embed_plan(self, block: dict, id_fn) -> None:
        """Enter sharded-embedding mode: the bundle's table (``block`` is
        its ``"sharded_embedding"`` config) is resident range-sharded over
        the serve fleet, and every scoring batch is preceded by a fan-out
        that gathers its unique fused-table rows from the owner replicas.
        ``id_fn(features) -> [B, C] int64`` extracts the table ids from a
        stacked feature batch (model-specific; the gateway builds it from
        the bundle config)."""
        from tensorflowonspark_torch.embedding.sharding import ShardPlan
        from tensorflowonspark_torch.utils.locks import tos_named_lock

        with self._cond:
            owners = sorted(self._replicas)
            if owners != list(range(len(owners))):
                # replica ranks must mirror the node-side shard loading
                # (rank = executor_id, world = num_executors)
                logger.warning(
                    "sharded embeddings over a non-contiguous replica set "
                    "%s; shard ownership assumes rank == executor id",
                    owners)
            self._embed_plan = ShardPlan.even(
                str(block["name"]), int(block["total_rows"]),
                int(block["dim"]), len(owners))
            self._embed_id_fn = id_fn
            self._embed_owners = owners
            self._embed_locks = {
                eid: tos_named_lock(f"router._embed[{eid}]")
                for eid in owners}

    def clear_embed_plan(self) -> None:
        with self._cond:
            self._embed_plan = None
            self._embed_id_fn = None
            clients, self._embed_clients = self._embed_clients, {}
        for client in clients.values():
            with contextlib.suppress(Exception):
                client.close()

    def _gather_embeddings(self, rows: list):
        """One fan-out round: rows -> stacked features -> unique table ids
        -> per-owner lookup sub-requests -> assembled ``[B, C, dim]`` fused
        rows.  Any owner failure raises :class:`EmbedLookupError`."""
        import numpy as np

        from tensorflowonspark_torch.inference import rows_to_features

        plan, id_fn = self._embed_plan, self._embed_id_fn
        ids = id_fn(rows_to_features(list(rows), None))
        flat = np.asarray(ids, np.int64).reshape(-1)
        uniq, inv = np.unique(flat, return_inverse=True)
        idx = plan.partition(uniq)
        out = np.empty((uniq.size, plan.dim), np.float32)
        for r, eid in enumerate(self._embed_owners):
            if not idx[r].size:
                continue
            got = self._embed_lookup_round(eid, uniq[idx[r]])
            out[idx[r]] = got
        telemetry.counter("serve.embed_fanouts").inc()
        telemetry.counter("serve.embed_rows_fetched").inc(int(uniq.size))
        return out[inv].reshape(ids.shape + (plan.dim,))

    def _embed_lookup_round(self, eid: int, ids):
        """One id-lookup sub-request to the shard owner ``eid`` over its
        dedicated embed-queue client (dialed lazily, serialized by the
        per-owner lock, torn down on failure so the next round redials)."""
        from tensorflowonspark_torch.embedding.serve import (
            EMBED_QNAME_IN,
            EMBED_QNAME_OUT,
        )
        from tensorflowonspark_torch.utils.envtune import env_float

        timeout = env_float("TOS_EMBED_LOOKUP_TIMEOUT", 30.0)
        lock = self._embed_locks.get(eid)
        if lock is None:
            raise EmbedLookupError(f"no embed lock for owner {eid}")
        with lock:
            client = self._embed_clients.get(eid)
            try:
                if client is None:
                    from tensorflowonspark_torch.dataserver import DataClient

                    meta = self._cluster._fresh_meta(eid)
                    client = DataClient(
                        meta["host"], meta["data_port"],
                        self._cluster.authkey,
                        call_timeout=timeout + 30.0, stall_timeout=timeout,
                        connect_timeout=5.0)
                    self._embed_clients[eid] = client
                got = client.infer_round(
                    [{"ids": ids}], EMBED_QNAME_IN, EMBED_QNAME_OUT,
                    wait=timeout)
                return got[0]["rows"]
            except Exception as e:  # noqa: BLE001 - wrapped for the worker
                stale = self._embed_clients.pop(eid, None)
                if stale is not None:
                    with contextlib.suppress(Exception):
                        stale.abort()
                raise EmbedLookupError(
                    f"embedding lookup to shard owner {eid} failed: "
                    f"{e}") from e

    # -- recovery ------------------------------------------------------------

    def _recovery_loop(self) -> None:
        while True:
            with self._cond:
                if self._stop:
                    return
                # draining replicas are on their way OUT (retire_replica owns
                # their teardown) — re-admitting one would route new batches
                # onto a node about to receive its EOF
                down = [r for r in self._replicas.values()
                        if not r.healthy and not r.draining]
            for rep in down:
                self._try_recover(rep)
            # keep the coordinator's journal-backed registry current with
            # whatever membership changes this pass (or a death elsewhere)
            # produced — the tick is the change-coalescing boundary
            self._publish_registry()
            with self._cond:
                if self._stop:
                    return
                self._cond.wait(0.5)

    def _try_recover(self, rep: _Replica) -> bool:
        """Re-admit one unhealthy replica: dial, order-fenced resync, replay
        any hot reload it missed, THEN rejoin routing.  Works for a
        supervised restart (fresh queues — the resync pong comes straight
        back) and for a live process whose round was abandoned (sever,
        timeout — the resync drains and discards the stale results first)."""
        inc, tracked = self._cluster.coordinator.registered_incarnation(
            rep.executor_id)
        if not tracked:
            return False  # dead / mid-restart: nothing to dial yet
        try:
            from tensorflowonspark_torch.dataserver import DataClient

            meta = self._cluster._fresh_meta(rep.executor_id)
            client = DataClient(
                meta["host"], meta["data_port"], self._cluster.authkey,
                call_timeout=self._call_timeout,
                stall_timeout=self._stall_timeout,
                connect_timeout=3.0, connect_attempts=1)
        except Exception:  # noqa: BLE001 - port dark mid-restart
            return False
        with self._cond:
            pinned = rep.pending_ctl  # snapshot; re-checked at admission
            # during a rollout the replica's COHORT pins a reload ctl too
            # (set_rollout): a SIGKILLed canary's restart boots from the
            # ORIGINAL export_dir, so recovery must replay the cohort's
            # candidate reload or the "canary" would silently serve the
            # primary bundle and poison the governor's comparison
            pending = pinned or self._cohort_ctl.get(rep.cohort)
        try:
            if not self._resync(client):
                raise RuntimeError("resync did not complete in time")
            if pending is not None:
                # a hot reload landed while this replica was out: a restarted
                # process MAY have loaded the new export already, but the
                # replay is idempotent — never guess, always converge
                client.infer_round([dict(pending)], self.qname_in,
                                   self.qname_out)
        except Exception as e:  # noqa: BLE001 - stay out, retry next pass
            logger.debug("serving replica %d not re-admitted yet: %s",
                         rep.executor_id, e)
            with contextlib.suppress(Exception):
                client.close()
            return False
        with self._cond:
            if rep.pending_ctl is not None and rep.pending_ctl != pinned:
                # a reload broadcast pinned a NEWER ctl while this recovery
                # was in flight: admitting now would serve the old bundle —
                # bail and let the next pass replay it
                admitted = False
            else:
                rep.client = client
                rep.client_inc = inc
                rep.pending_ctl = None
                rep.healthy = True
                self._healthy_gauge.set(sum(
                    1 for r in self._replicas.values() if r.healthy))
                self._cond.notify_all()
                admitted = True
        if not admitted:
            with contextlib.suppress(Exception):
                client.close()
            return False
        ttrace.event("resync", executor=rep.executor_id, incarnation=inc,
                     readmitted=True)
        logger.info("serving replica %d recovered (incarnation %d)",
                    rep.executor_id, inc)
        return True

    def _resync(self, client, timeout: float = 15.0) -> bool:
        """Order-fence a connection before re-admission: round-trip a
        nonce'd ping and drain the output queue until OUR pong surfaces.

        The map_fun consumes its input queue in order, so by the time this
        ping's pong is emitted every result of every abandoned earlier
        round (including earlier failed resync attempts' pongs — hence the
        nonce) has already been popped here and discarded.  Without this, a
        round abandoned mid-compute could leave its late results in the
        output queue and a later batch's exactly-count collection would
        hand them to the WRONG waiters."""
        self._resync_seq += 1
        nonce = f"{id(self)}:{self._resync_seq}"

        def _mine(x) -> bool:
            return (isinstance(x, dict) and x.get(CTL_KEY) == "pong"
                    and x.get("nonce") == nonce)

        deadline = _monotonic() + timeout
        got = client.infer_round([{CTL_KEY: "ping", "nonce": nonce}],
                                 self.qname_in, self.qname_out,
                                 wait=min(10.0, timeout))
        discarded = 0
        while not any(_mine(x) for x in got):
            discarded += len(got)
            if _monotonic() >= deadline:
                return False
            got = client.collect_results(self.qname_out, 64, wait=1.0)
        discarded += sum(1 for x in got if not _mine(x))
        if discarded:
            telemetry.counter("serve.resync_discarded_results").inc(discarded)
            logger.warning("discarded %d stale result(s) of abandoned rounds "
                           "while re-admitting a serving replica", discarded)
        return True

    # -- hot reload support --------------------------------------------------

    def drain(self, timeout: float = 60.0) -> None:
        """Block until no batch is queued or in flight (the gateway pauses
        the batcher first, so nothing new arrives meanwhile)."""
        deadline = _monotonic() + timeout
        with self._cond:
            while any(r.queue or r.inflight for r in self._replicas.values()):
                if self._stop:
                    return
                if _monotonic() >= deadline:
                    raise TimeoutError(
                        f"serving router did not drain within {timeout}s")
                self._cond.wait(0.2)

    def broadcast_ctl(self, item: dict, timeout: float = 60.0) -> dict[int, Any]:
        """Round-trip one control item through every healthy replica (call
        only paused + drained: the workers are idle, so their clients are
        free).  Returns {executor_id: ack}.  A replica that fails the round
        is marked unhealthy, and for a ``reload`` every replica that did
        NOT ack (failed here, or already out) gets the item pinned as its
        ``pending_ctl`` — recovery replays it before re-admission, so a
        replica that was out during a hot swap can never quietly rejoin
        serving the previous bundle."""
        acks: dict[int, Any] = {}
        with self._cond:
            targets = [r for r in self._replicas.values() if r.healthy]
        for rep in targets:
            try:
                client = self._client_for(rep)
                acks[rep.executor_id] = client.infer_round(
                    [item], self.qname_in, self.qname_out)[0]
            except Exception as e:  # noqa: BLE001 - replica fenced below
                logger.warning("control round to serving replica %d failed: "
                               "%s", rep.executor_id, e)
                with self._cond:
                    self._mark_unhealthy_locked(rep)
        if item.get(CTL_KEY) == "reload":
            with self._cond:
                late = [rep for rep in self._replicas.values()
                        if rep.executor_id not in acks and rep.healthy]
                for rep in self._replicas.values():
                    if rep.executor_id not in acks and not rep.healthy:
                        rep.pending_ctl = dict(item)
            # a replica re-admitted BETWEEN the healthy snapshot above and
            # now would otherwise serve the old bundle with nobody left to
            # replay the reload (recovery only scans unhealthy replicas) —
            # send it the round directly; its worker is idle (the batcher
            # is paused + drained for the whole broadcast)
            for rep in late:
                try:
                    client = self._client_for(rep)
                    acks[rep.executor_id] = client.infer_round(
                        [item], self.qname_in, self.qname_out)[0]
                except Exception as e:  # noqa: BLE001 - replica fenced below
                    logger.warning("late control round to serving replica "
                                   "%d failed: %s", rep.executor_id, e)
                    with self._cond:
                        self._mark_unhealthy_locked(rep)
                        rep.pending_ctl = dict(item)
        return acks

    def ctl_to(self, executor_ids, item: dict,
               timeout: float = 60.0) -> dict[int, Any]:
        """``broadcast_ctl`` restricted to a replica subset — the staged-
        rollout primitive (load the candidate on the canary cohort only;
        roll just the canaries back).  Same contract: call only paused +
        drained; a target that fails the round is fenced unhealthy with a
        ``reload`` item pinned as its ``pending_ctl`` so recovery replays
        it before re-admission."""
        acks: dict[int, Any] = {}
        with self._cond:
            targets = [r for eid in executor_ids
                       if (r := self._replicas.get(eid)) is not None
                       and r.healthy]
        for rep in targets:
            try:
                client = self._client_for(rep)
                acks[rep.executor_id] = client.infer_round(
                    [item], self.qname_in, self.qname_out)[0]
            except Exception as e:  # noqa: BLE001 - replica fenced below
                logger.warning("control round to serving replica %d failed: "
                               "%s", rep.executor_id, e)
                with self._cond:
                    self._mark_unhealthy_locked(rep)
        if item.get(CTL_KEY) == "reload":
            with self._cond:
                for eid in executor_ids:
                    rep = self._replicas.get(eid)
                    if rep is not None and eid not in acks:
                        rep.pending_ctl = dict(item)
        return acks

    def quarantine_for_reload(self, executor_id: int, item: dict) -> None:
        """Fence one replica out of routing until recovery has replayed
        ``item`` (a reload ctl) through it — the mixed-fleet guard: a
        replica whose promotion reload acked the WRONG bundle signature
        must not keep serving the stale bundle alongside the promoted
        fleet.  Its queued batches re-route to the survivors."""
        with self._cond:
            rep = self._replicas.get(executor_id)
            if rep is None:
                return
            rerouted = self._mark_unhealthy_locked(rep)
            rep.pending_ctl = dict(item)
            self._update_outstanding_locked()
            self._cond.notify_all()
        telemetry.counter("serve.promotion_laggards").inc()
        ttrace.event("promotion_laggard", executor=executor_id)
        for batch in rerouted:
            self.submit(batch, exclude=executor_id)

    # -- staged rollouts (gateway.rollout) -----------------------------------

    def set_rollout(self, canary_eids, *, traffic_every: int = 0,
                    mirror_every: int = 0, observer=None,
                    canary_ctl: dict | None = None,
                    shed_fn=None) -> None:
        """Enter a rollout split: replicas in ``canary_eids`` form the
        canary cohort, every ``traffic_every``-th batch routes to them,
        every ``mirror_every``-th primary batch is shadow-mirrored, and
        every batch outcome feeds ``observer`` (the rollout governor).
        ``canary_ctl`` is the candidate's reload item, remembered per
        cohort so a canary that dies and restarts mid-rollout is converged
        back onto the CANDIDATE bundle before it rejoins (see
        ``_try_recover``)."""
        eids = set(canary_eids)
        with self._cond:
            for rep in self._replicas.values():
                rep.cohort = "canary" if rep.executor_id in eids \
                    else "primary"
            self._batch_seq = 0
            self._mirror_seq = 0
            self._canary_every = max(0, int(traffic_every))
            self._mirror_every = max(0, int(mirror_every))
            self._observer = observer
            self._cohort_ctl = ({"canary": dict(canary_ctl)}
                                if canary_ctl else {})
            if shed_fn is not None:
                self._shed_fn = shed_fn
            self._cond.notify_all()

    def clear_rollout(self) -> None:
        """Leave the split (promotion or rollback both end here): every
        replica rejoins the primary cohort, traffic/mirror counters stop,
        the observer detaches."""
        with self._cond:
            for rep in self._replicas.values():
                rep.cohort = "primary"
            self._canary_every = 0
            self._mirror_every = 0
            self._observer = None
            self._cohort_ctl = {}
            self._cond.notify_all()

    def cohort_members(self, cohort: str) -> list[int]:
        with self._cond:
            return sorted(r.executor_id for r in self._replicas.values()
                          if r.cohort == cohort)

    def healthy_replicas(self) -> list[int]:
        with self._cond:
            return sorted(r.executor_id for r in self._replicas.values()
                          if r.healthy)

    def replica_loads(self) -> dict[int, int]:
        """Outstanding (queued + in-flight) batches per replica — the same
        numbers least-outstanding routing picks by, exposed for autoscaling
        victim selection and ``cluster.stats()`` so the policy and the
        router can never disagree on per-replica load."""
        with self._cond:
            return {r.executor_id: _load(r)
                    for r in self._replicas.values()}

    # -- elastic membership (cluster.resize) ---------------------------------

    def add_replica(self, executor_id: int) -> bool:
        """Admit a freshly-joined serving node into routing (scale-out).
        Idempotent; returns True when a new replica was added."""
        with self._cond:
            if self._stop or executor_id in self._replicas:
                return False
            rep = self._replicas[executor_id] = _Replica(executor_id)
            self._healthy_gauge.set(
                sum(1 for r in self._replicas.values() if r.healthy))
        rep.thread = threading.Thread(
            target=self._worker, args=(rep,), daemon=True,
            name=f"serve-replica-{executor_id}")
        rep.thread.start()
        ttrace.event("replica_added", executor=executor_id)
        logger.info("serving replica %d admitted into routing", executor_id)
        self._publish_registry()
        return True

    def retire_replica(self, executor_id: int, timeout: float = 60.0) -> bool:
        """Drain one replica out of routing (scale-in): no new batches are
        routed to it, its queued/in-flight batches finish normally, then it
        is removed.  If the drain times out (or the replica dies mid-drain),
        its never-attempted queued batches re-route to the survivors without
        spending their retry.  Returns True when the drain completed clean,
        False on timeout/forced reroute; idempotent for unknown ids."""
        with self._cond:
            rep = self._replicas.get(executor_id)
            if rep is None:
                return True
            rep.draining = True
            self._draining_gauge.set(
                sum(1 for r in self._replicas.values() if r.draining))
            self._cond.notify_all()
        deadline = _monotonic() + timeout
        leftovers: list[MicroBatch] = []
        clean = True
        with self._cond:
            while _load(rep) and not self._stop:
                if not rep.healthy:
                    # died mid-drain: its worker already rerouted the queue
                    # via _mark_unhealthy_locked; whatever is left is ours
                    break
                if _monotonic() >= deadline:
                    clean = False
                    break
                self._cond.wait(0.2)
            leftovers, rep.queue = rep.queue, []
            rep.retired = True
            self._replicas.pop(executor_id, None)
            self._healthy_gauge.set(
                sum(1 for r in self._replicas.values() if r.healthy))
            self._draining_gauge.set(
                sum(1 for r in self._replicas.values() if r.draining))
            self._update_outstanding_locked()
            self._cond.notify_all()
        for batch in leftovers:
            # never attempted on the retiring replica: re-route without
            # spending the batch's one retry
            self.submit(batch, exclude=executor_id)
        if rep.thread is not None:
            rep.thread.join(timeout=10.0)
        # Close the client only once the worker has actually exited: a
        # worker still blocked mid-``infer_round`` past the join (node
        # compute longer than drain_timeout + 10s) is about to COMPLETE
        # that batch — yanking its socket here would fail it and spend its
        # one retry for nothing.  The worker's retired-exit path owns the
        # teardown in that case.
        with self._cond:
            worker_live = rep.thread is not None and rep.thread.is_alive()
            client, rep.client = (None, rep.client) if worker_live \
                else (rep.client, None)
        if client is not None:
            with contextlib.suppress(Exception):
                client.close()
        ttrace.event("replica_retired", executor=executor_id,
                     clean=clean and not leftovers)
        logger.info("serving replica %d drained out of routing%s",
                    executor_id,
                    "" if clean else " (drain timed out; queue rerouted)")
        self._publish_registry()
        return clean and not leftovers

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        pending: list[MicroBatch] = []
        with self._cond:
            if self._stop:
                return
            self._stop = True
            for rep in self._replicas.values():
                pending.extend(rep.queue)
                rep.queue = []
            self._cond.notify_all()
        err = RuntimeError("serving gateway closed with the batch in flight")
        for batch in pending:
            self._batcher.fail_batch(batch, err)
        for rep in self._replicas.values():
            if rep.thread is not None:
                rep.thread.join(timeout=10.0)
            if rep.client is not None:
                with contextlib.suppress(Exception):
                    rep.client.close()
                rep.client = None
        with self._cond:
            embed_clients, self._embed_clients = self._embed_clients, {}
        for client in embed_clients.values():
            with contextlib.suppress(Exception):
                client.close()
        self._recovery.join(timeout=10.0)
        # retract this router's registry entry: a closed gateway must not
        # keep presenting healthy replicas in statz / post-failover replay
        coord = getattr(self._cluster, "coordinator", None)
        if coord is not None and hasattr(coord, "note_serving_replicas"):
            with contextlib.suppress(Exception):
                coord.note_serving_replicas(self._registry_name, [])
