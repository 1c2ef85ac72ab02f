"""Dynamic micro-batching for the online serving gateway.

The latency half of the serving subsystem (PAPERS.md: tf.data's lesson that
deadline-driven batching turns a throughput engine into a latency one):
individual predict requests are coalesced into device-sized batches —
flushed the moment ``TOS_SERVE_MAX_BATCH`` rows are queued OR the oldest
request has waited ``TOS_SERVE_MAX_DELAY_MS``, whichever comes first — and
each batch is padded to exactly ``max_batch`` rows so the node's jitted
apply sees ONE static batch shape and never recompiles.

Admission control happens here too: the request queue is bounded
(``TOS_SERVE_QUEUE``) and an arriving request that finds it full is
rejected immediately with :class:`ServeQueueFull` (the 503 of this wire
protocol) — a loaded gateway sheds load at the door instead of growing an
unbounded latency tail.  The queue itself is tenant-aware
(:class:`~.tenancy.TenantQueues`): requests carry an optional tenant key,
admission applies per-tenant token-bucket rate limits and the brownout
ladder (:class:`~.tenancy.ServeThrottled` — the 429), and batch building
drains the per-tenant FIFOs deficit-round-robin so one hot tenant cannot
monopolize batch fill.  Every request carries a deadline
(``TOS_SERVE_TIMEOUT`` default); requests that expire while still queued
are dropped before dispatch, and a late result for an expired waiter is
discarded — each accepted request is answered exactly once, with either
its results or one error.

A request may carry several rows; rows scatter back to their waiter by
position, and a request larger than ``max_batch`` simply spans batches.
"""

from __future__ import annotations

import logging
import threading
from tensorflowonspark_torch.utils.locks import tos_named_condition
from time import monotonic as _monotonic
from typing import Any, Callable, Sequence

from tensorflowonspark_torch import telemetry
from tensorflowonspark_torch.serving.tenancy import (  # noqa: F401 - ServeThrottled re-exported
    ServeThrottled,
    TenantQueues,
)
from tensorflowonspark_torch.telemetry import trace as ttrace

logger = logging.getLogger(__name__)

#: Marker key for in-band control items on the serving stream (reload /
#: ping); ``serving_loop`` answers each with a one-item ack, preserving the
#: exactly-count invariant of the transport.  Lives here (the leaf serving
#: module) so gateway, router, and loop can all import it cycle-free.
CTL_KEY = "_tos_serve_ctl"


class ServeClosed(RuntimeError):
    """The gateway is shut down; no further requests are accepted."""


class ServeQueueFull(RuntimeError):
    """Admission control rejection: the bounded request queue is full
    (the wire protocol's 503 — retry later or add replicas)."""


class ServeTimeout(TimeoutError):
    """The request's deadline expired before its results arrived."""


class _Request:
    """One predict call: rows in, results (or one error) out, exactly once."""

    __slots__ = ("rows", "results", "remaining", "offset", "error",
                 "event", "deadline", "t_submit", "dispatched_at",
                 "callbacks", "trace", "resolved_at", "tenant")

    def __init__(self, rows: list, deadline: float, tenant: str = ""):
        self.rows = rows
        self.tenant = tenant
        self.results: list = [None] * len(rows)
        self.remaining = len(rows)
        self.offset = 0              # rows already pulled into batches
        self.error: Exception | None = None
        self.event = threading.Event()
        self.deadline = deadline
        self.t_submit = _monotonic()
        self.dispatched_at: float | None = None
        # done callbacks (the reactor frontend's completion path); invoked
        # exactly once, never with the batcher lock held
        self.callbacks: list = []
        # sampled request's trace context (None = unsampled/tracing off);
        # the root serve.request span records at resolution
        self.trace = None
        self.resolved_at: float | None = None


class MicroBatch:
    """One dispatchable unit: ``rows`` padded to the static batch shape,
    ``n`` real rows, and the (request, request_offset, count, batch_offset)
    entries that scatter results back to their waiters.  ``retries`` counts
    re-dispatches after a replica failure (the router allows one)."""

    __slots__ = ("rows", "n", "entries", "retries", "created_at",
                 "trace", "trace_parent", "cohort", "mirror_of")

    def __init__(self, rows: list, n: int,
                 entries: list[tuple[_Request, int, int, int]]):
        self.rows = rows
        self.n = n
        self.entries = entries
        self.retries = 0
        self.created_at = _monotonic()
        # rollout support (router-owned): which replica cohort this batch
        # must run on (None = router decides at submit); a shadow MIRROR
        # batch carries the primary's results here for output diffing and
        # has no entries — nothing waits on it
        self.cohort: str | None = None
        self.mirror_of: list | None = None
        # batch span context: derived from the FIRST sampled request in the
        # batch (the batcher "links N request spans to their batch span" —
        # the other sampled requests are listed in the span's link tags);
        # the router/wire/node spans all parent onto this ctx
        self.trace = None
        self.trace_parent: int | None = None


class PendingPrediction:
    """Async handle returned by ``predict_async``: ``result()`` blocks until
    the request's deadline and returns its results or raises its error."""

    def __init__(self, batcher: "MicroBatcher", request: _Request):
        self._batcher = batcher
        self._request = request

    def done(self) -> bool:
        return self._request.event.is_set()

    def result(self) -> list:
        return self._batcher.await_request(self._request)


class MicroBatcher:
    """Bounded request queue + the coalescing flush loop.

    ``dispatch`` (the router's ``submit``) receives each built
    :class:`MicroBatch`; ``pause_fn`` returning True holds flushes (the
    gateway raises it while a hot reload drains in-flight batches —
    requests keep queuing under the same admission bound meanwhile).

    ``capacity_fn`` makes the flush *capacity-aware*: a ripe partial batch
    is only dispatched while a replica can start it soon (the router's
    ``has_capacity``).  When every replica is already busy, flushing would
    just park a tiny batch in a replica queue — so the batcher keeps
    coalescing instead, and the arrivals that land during the in-flight
    round ride the next batch for free.  Measured on the 2-core bench box
    this is the difference between ~1-row fills convoying behind each
    other (95 qps, p50 296ms at 32 clients) and full-fill batches
    (~3400 qps, p50 9ms).
    """

    def __init__(self, dispatch: Callable[[MicroBatch], None], *,
                 max_batch: int, max_delay_secs: float, queue_limit: int,
                 pause_fn: Callable[[], bool] | None = None,
                 capacity_fn: Callable[[], bool] | None = None,
                 tenant_weights: dict[str, float] | None = None):
        self.max_batch = max(1, int(max_batch))
        self.max_delay = max(0.0, float(max_delay_secs))
        self.queue_limit = max(1, int(queue_limit))
        self._dispatch = dispatch
        self._pause_fn = pause_fn or (lambda: False)
        self._capacity_fn = capacity_fn or (lambda: True)
        self._cond = tos_named_condition("batcher._cond")
        # tenant-aware admission queue (per-tenant FIFOs, DRR drain, token
        # buckets, brownout ladder) — owned here, every access under _cond
        self._queue = TenantQueues(queue_limit=self.queue_limit,
                                   weights=tenant_weights)
        self._rows_queued = 0
        self._closed = False
        # requests finished while the lock was held, their callbacks not yet
        # run — drained by _fire_done() after every lock release
        self._done_pending: list[_Request] = []
        self._depth = telemetry.gauge("serve.queue_depth")
        self._thread = threading.Thread(target=self._flush_loop, daemon=True,
                                        name="serve-batcher")
        self._thread.start()

    # -- admission -----------------------------------------------------------

    def submit(self, rows: Sequence[Any], deadline: float,
               tenant: str = "") -> _Request:
        """Admit one request or fast-fail; never blocks on a full queue."""
        rows = list(rows)
        if not rows:
            raise ValueError("predict needs at least one row")
        res = self.submit_many([(rows, deadline, None, tenant)])[0]
        if isinstance(res, Exception):
            raise res
        return res

    def submit_many(self, entries: list) -> list:
        """Bulk admission for the reactor: admit ``[(rows, deadline,
        done_cb[, tenant]), ...]`` under ONE lock acquisition with ONE
        flush-loop notify — a pipelined burst decoded in one read pass
        costs one critical section, not one per request.  Returns one
        entry per input: the admitted request, or the admission error
        instance (:class:`ServeClosed` / :class:`ServeQueueFull` /
        :class:`~.tenancy.ServeThrottled`) for refusals.  Callbacks are
        attached inside the lock, so a request can never resolve before
        its callback is registered."""
        out: list = []
        accepted = rows_total = 0
        with self._cond:
            for entry in entries:
                rows, deadline, done_cb = entry[0], entry[1], entry[2]
                tenant = entry[3] if len(entry) > 3 else ""
                if self._closed:
                    out.append(ServeClosed("serving gateway is closed"))
                    continue
                if len(self._queue) >= self.queue_limit:
                    telemetry.counter("serve.rejected_total").inc()
                    out.append(ServeQueueFull(
                        f"request queue full ({self.queue_limit} queued); "
                        "retry later or add replicas"))
                    continue
                shed = self._queue.admission_error(tenant, len(rows))
                if shed is not None:
                    out.append(shed)
                    continue
                req = _Request(rows, deadline, tenant)
                # gateway-side trace stamping: the deterministic sampler
                # (TOS_TRACE_SAMPLE) decides here, once, for the request's
                # whole cross-process life; None costs one check downstream
                req.trace = ttrace.sample()
                if done_cb is not None:
                    req.callbacks.append(done_cb)
                self._queue.append(req)
                self._rows_queued += len(rows)
                accepted += 1
                rows_total += len(rows)
                out.append(req)
            if accepted:
                self._depth.set(len(self._queue))
                self._cond.notify_all()
        if accepted:
            telemetry.counter("serve.requests_total").inc(accepted)
            telemetry.counter("serve.rows_total").inc(rows_total)
        return out

    def shed_level(self) -> int:
        """Current brownout rung (0 = normal) — the rollout layer pauses
        shadow mirroring at level >= 1; see ``tenancy.TenantQueues``."""
        with self._cond:
            return self._queue.shed_level()

    def tenant_depths(self) -> dict[str, int]:
        """Queued requests per tenant — the per-tenant stats surface."""
        with self._cond:
            return self._queue.depths()

    def await_request(self, req: _Request) -> list:
        """Block until the request resolves or its deadline passes; returns
        results or raises the request's single error."""
        if not req.event.wait(max(0.0, req.deadline - _monotonic())):
            self.expire(req)
            req.event.wait()  # expire (or a racing completion) resolved it
        if req.error is not None:
            raise req.error
        return req.results

    def add_done_callback(self, req: _Request, fn) -> None:
        """Register ``fn(req)`` to run once the request resolves (results or
        error) — the reactor frontend's completion hook, so no thread ever
        blocks in ``await_request`` for a wire request.  Runs on whichever
        thread resolves the request (router worker, flush loop, expiry,
        close), never with the batcher lock held; when the request already
        resolved, runs immediately on the calling thread."""
        with self._cond:
            if not req.event.is_set():
                req.callbacks.append(fn)
                return
        fn(req)

    def expire(self, req: _Request) -> None:
        """Resolve ``req`` with :class:`ServeTimeout` unless completion won
        the race — idempotent; callable from the waiter thread
        (``await_request``) or the reactor's deadline sweep."""
        with self._cond:
            if req.event.is_set():
                return  # completion won the race
            try:
                self._queue.remove(req)
                self._rows_queued -= len(req.rows) - req.offset
                self._depth.set(len(self._queue))
            except ValueError:  # toslint: allow-silent(already pulled into an in-flight batch; the late results are discarded below)
                pass
            telemetry.counter("serve.expired_total").inc()
            self._finish_locked(req, ServeTimeout(
                f"request deadline expired after "
                f"{_monotonic() - req.t_submit:.3f}s"))
        self._fire_done()

    def cancel(self, req: _Request, error: Exception | None = None) -> None:
        """Resolve ``req`` with ``error`` (default :class:`ServeClosed`)
        without waiting for results: queued rows — including a spanning
        request's tail — are pulled out so they never reach a replica or
        hold an admission slot; a slice already in flight completes on its
        replica and is discarded at scatter time (the set event).  The
        frontend calls this when a client disconnects with requests
        outstanding."""
        with self._cond:
            if req.event.is_set():
                return
            try:
                self._queue.remove(req)
                self._rows_queued -= len(req.rows) - req.offset
                self._depth.set(len(self._queue))
            except ValueError:  # toslint: allow-silent(already pulled into an in-flight batch; the late results are discarded at scatter time)
                pass
            telemetry.counter("serve.cancelled_total").inc()
            self._finish_locked(req, error or ServeClosed(
                "request cancelled (client gone)"))
        self._fire_done()

    # -- flush loop ----------------------------------------------------------

    def _flush_loop(self) -> None:
        while True:
            batch: MicroBatch | None = None
            with self._cond:
                while not self._closed and batch is None:
                    self._drop_expired_locked()
                    if self._done_pending:
                        break  # run expiry callbacks before waiting again
                    if self._queue and not self._pause_fn():
                        oldest = self._queue.oldest_submit()
                        age = (_monotonic() - oldest if oldest is not None
                               else 0.0)
                        ripe = (self._rows_queued >= self.max_batch
                                or age >= self.max_delay)
                        if ripe and self._capacity_fn():
                            batch = self._build_batch_locked()
                            if batch is not None:
                                break
                            continue  # only already-resolved requests queued
                        # ripe but no downstream capacity: hold — completion
                        # notifies this cond, and every arrival meanwhile
                        # raises the eventual batch's fill
                        self._cond.wait(0.05 if ripe
                                        else min(self.max_delay - age, 0.05))
                    else:
                        self._cond.wait(0.05)
                closed = self._closed
            self._fire_done()
            if batch is not None:
                self._dispatch(batch)
            elif closed:
                return  # close() already resolved the queue

    def _drop_expired_locked(self) -> None:
        now = _monotonic()
        expired = [r for r in self._queue if r.deadline <= now]
        for req in expired:
            self._queue.remove(req)
            self._rows_queued -= len(req.rows) - req.offset
            telemetry.counter("serve.expired_total").inc()
            self._finish_locked(req, ServeTimeout(
                "request deadline expired while queued"))
        if expired:
            self._depth.set(len(self._queue))

    def _build_batch_locked(self) -> MicroBatch | None:
        """Pull up to ``max_batch`` rows in deficit-round-robin tenant
        order (``TenantQueues.next_for_batch``); None when everything
        queued turned out to be already resolved."""
        rows: list = []
        entries: list[tuple[_Request, int, int, int]] = []
        now = _monotonic()
        while len(rows) < self.max_batch:
            req = self._queue.next_for_batch()
            if req is None:
                break
            if req.event.is_set():
                # already resolved (expired, or an earlier slice's batch
                # failed): its queued tail must not reach a replica or keep
                # occupying an admission slot
                self._queue.discard(req)
                self._rows_queued -= len(req.rows) - req.offset
                continue
            take = min(len(req.rows) - req.offset, self.max_batch - len(rows))
            entries.append((req, req.offset, take, len(rows)))
            rows.extend(req.rows[req.offset:req.offset + take])
            if req.dispatched_at is None:
                req.dispatched_at = now
                telemetry.histogram("serve.queue_wait_secs").observe(
                    now - req.t_submit)
                # stage span: admission wait (submit -> pulled into a batch)
                ttrace.record_child("serve.admission", req.trace,
                                    req.t_submit, now - req.t_submit)
            req.offset += take
            self._queue.charge(req, take)
        if not rows:
            self._depth.set(len(self._queue))
            return None
        n = len(rows)
        self._rows_queued -= n
        self._depth.set(len(self._queue))
        telemetry.counter("serve.batches_total").inc()
        telemetry.histogram("serve.batch_fill").observe(n / self.max_batch)
        # pad to the static batch shape: the jitted apply compiles once
        rows.extend(rows[-1] for _ in range(self.max_batch - n))
        batch = MicroBatch(rows, n, entries)
        sampled = [r for r, _roff, _cnt, _boff in entries
                   if r.trace is not None]
        if sampled:
            # batch span under the first sampled request; the rest are
            # linked by id so their traces reach this batch in the export
            batch.trace = ttrace.derive(sampled[0].trace)
            batch.trace_parent = sampled[0].trace[1]
        return batch

    # -- completion (router threads) -----------------------------------------

    def complete_batch(self, batch: MicroBatch, results: list) -> None:
        """Scatter one batch's results back to each waiter (positional)."""
        self._record_batch_span(batch)
        with self._cond:
            for req, roff, cnt, boff in batch.entries:
                if req.event.is_set():
                    continue  # expired/errored while the batch was in flight
                req.results[roff:roff + cnt] = results[boff:boff + cnt]
                req.remaining -= cnt
                if req.remaining <= 0:
                    self._finish_locked(req, None)
            self._cond.notify_all()  # capacity freed: the flush loop may act
        self._fire_done()

    def fail_batch(self, batch: MicroBatch, error: Exception) -> None:
        """Resolve every waiter of a failed batch with one error.  A
        spanning request whose later rows are still queued is pulled out —
        one error answers the whole request, and scoring its tail would be
        wasted replica work charged against the admission bound."""
        self._record_batch_span(batch, error=error)
        with self._cond:
            for req, _roff, _cnt, _boff in batch.entries:
                if not req.event.is_set():
                    self._finish_locked(req, error)
                    if req.offset < len(req.rows):
                        try:
                            self._queue.remove(req)
                            self._rows_queued -= len(req.rows) - req.offset
                        except ValueError:  # toslint: allow-silent(tail already pulled into another in-flight batch; complete/fail will skip the set event)
                            pass
            self._depth.set(len(self._queue))
            self._cond.notify_all()
        self._fire_done()

    def _record_batch_span(self, batch: MicroBatch,
                           error: Exception | None = None) -> None:
        """Record the serve.batch span (build -> scatter) with its request
        links; called OUTSIDE the lock, once per batch resolution."""
        if batch.trace is None:
            return
        tags: dict = {"rows": batch.n, "retries": batch.retries}
        links = [[r.trace[0], r.trace[1]]
                 for r, _roff, _cnt, _boff in batch.entries
                 if r.trace is not None]
        if len(links) > 1:
            tags["links"] = links[1:]
        if error is not None:
            tags["error"] = type(error).__name__
        ttrace.record_span("serve.batch", batch.trace, batch.trace_parent,
                           batch.created_at, _monotonic() - batch.created_at,
                           tags)

    def _finish_locked(self, req: _Request, error: Exception | None) -> None:
        req.error = error
        req.resolved_at = _monotonic()
        if error is None:
            telemetry.histogram("serve.request_secs").observe(
                req.resolved_at - req.t_submit)
        if req.trace is not None:
            # root span: the whole request, submit -> resolution (stage
            # spans — admission/batch_fill/wire/node_round/reply — nest
            # under it in the merged trace)
            tags = {"rows": len(req.rows)}
            if error is not None:
                tags["error"] = type(error).__name__
            ttrace.record_span("serve.request", req.trace, None,
                               req.t_submit, req.resolved_at - req.t_submit,
                               tags)
        req.event.set()
        if req.callbacks:
            self._done_pending.append(req)

    def _fire_done(self) -> None:
        """Run done callbacks of requests resolved under the lock — outside
        it, so a callback may safely re-enter the batcher (submit / cancel)
        without deadlocking."""
        while True:
            with self._cond:
                if not self._done_pending:
                    return
                pending, self._done_pending = self._done_pending, []
            for req in pending:
                callbacks, req.callbacks = req.callbacks, []
                for fn in callbacks:
                    try:
                        fn(req)
                    except Exception:  # noqa: BLE001 - one bad callback must not orphan the rest
                        logger.exception("serve done-callback failed")

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            err = ServeClosed("serving gateway closed with the request queued")
            for req in self._queue:
                self._finish_locked(req, err)
            self._queue.clear()
            self._rows_queued = 0
            self._depth.set(0)
            self._cond.notify_all()
        self._fire_done()
        self._thread.join(timeout=10.0)
