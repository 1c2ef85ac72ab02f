"""Driver-side online serving gateway: request/response over a live cluster.

The reference stack only ever scored data as Spark partitions — a batch
path (PAPER.md §3.3).  This gateway adds the missing request/response
path: ``cluster.serve(export_dir)`` returns a handle whose ``predict`` /
``predict_async`` answer individual requests with micro-batched, replica-
routed inference over the SAME resident nodes, data plane, telemetry, and
elastic machinery the batch path uses.

Three layers, composed here:

- admission + coalescing: :class:`~.batcher.MicroBatcher` (bounded queue
  ``TOS_SERVE_QUEUE``, fast-fail rejection, per-request deadlines
  ``TOS_SERVE_TIMEOUT``, flush at ``TOS_SERVE_MAX_BATCH`` rows or
  ``TOS_SERVE_MAX_DELAY_MS``);
- routing + failover: :class:`~.router.ReplicaRouter` (least-outstanding
  replica choice, one retry on a live replica after a death, incarnation-
  fenced recovery);
- the wire endpoint: :class:`~.frontend.ReactorFrontend` — a single-thread
  ``selectors`` reactor speaking the data plane's framing (HMAC handshake
  on the cluster authkey, then protocol-5 zero-copy v2 frames) with
  request *pipelining*: many id-tagged requests outstanding per socket,
  responses written back out of order as their micro-batches complete.
  :class:`GatewayClient` is the matching pipelined remote caller;
  :class:`GatewayClientPool` fans closed-loop callers over several
  sockets.

Hot reload: a version watcher polls ``export_dir``; when a newer export
lands, in-flight batches drain, every replica swaps its bundle via a
control round (``serving_loop`` + ``checkpoint.invalidate_bundle``), and
dispatch resumes — requests keep queuing during the swap.

Staged rollouts (ISSUE 16): ``rollout(export_dir, ...)`` replaces the
stop-the-world swap with a supervised one — load the candidate bundle on
a canary cohort only (signature-verified targeted control round), split
``canary_pct`` of live traffic onto it, optionally shadow-mirror primary
batches for output diffing, and let a :class:`~.rollout.RolloutGovernor`
watch the canary's error rate / NaN rate / divergence / p99 against the
primary baseline over a sliding window.  A healthy window promotes
(fleet-wide verified swap, laggards quarantined until converged); a
regression auto-rolls the canaries back to the prior export.  Every state
transition is journaled through the coordinator's rollout registry, so a
control-plane failover restores what was in flight.

Per-tenant fairness: requests may carry a tenant key (``predict(...,
tenant=...)``; v2/v3 frames carry it on the wire, legacy id-less clients
land in the anonymous tenant).  Admission runs per-tenant token buckets
and weighted DRR queues with a brownout ladder instead of one cliff —
see ``serving/tenancy.py``.
"""

from __future__ import annotations

import contextlib
import logging
import math
import threading
from tensorflowonspark_torch.utils.locks import tos_named_lock
from time import monotonic as _monotonic
from typing import Any, Sequence

from tensorflowonspark_torch import telemetry
from tensorflowonspark_torch.checkpoint import bundle_signature
from tensorflowonspark_torch.telemetry import trace as ttrace
from tensorflowonspark_torch.dataserver import _recv, _send
from tensorflowonspark_torch.serving.batcher import (  # noqa: F401 - CTL_KEY re-exported
    CTL_KEY,
    MicroBatcher,
    PendingPrediction,
    ServeClosed,
    ServeQueueFull,
    ServeThrottled,
    ServeTimeout,
)
from tensorflowonspark_torch.serving.frontend import ReactorFrontend
from tensorflowonspark_torch.serving.rollout import RolloutGovernor, RolloutState
from tensorflowonspark_torch.serving.router import ReplicaRouter
from tensorflowonspark_torch.utils.envtune import env_float, env_int
from tensorflowonspark_torch.utils.net import (
    bound_socket,
    connect_with_backoff,
    hmac_handshake_client,
    local_ip,
)

logger = logging.getLogger(__name__)

_ERR_TYPES = {"unavailable": ServeQueueFull, "deadline": ServeTimeout,
              "closed": ServeClosed, "throttled": ServeThrottled}


class ServingGateway:
    """Handle returned by ``cluster.serve(export_dir, ...)``.

    ``predict(rows, timeout)`` blocks for one request; ``predict_async``
    returns a :class:`~.batcher.PendingPrediction`.  ``endpoint`` is the
    TCP frontend's ``(host, port)`` for :class:`GatewayClient` callers.
    """

    def __init__(self, cluster, export_dir: str, *,
                 qname_in: str = "input", qname_out: str = "output",
                 max_batch: int | None = None,
                 max_delay_ms: float | None = None,
                 queue_limit: int | None = None,
                 default_timeout: float | None = None,
                 listen: bool = True, listen_host: str = "",
                 handshake_timeout: float | None = None,
                 max_conn_outstanding: int | None = None,
                 reload_poll_secs: float = 2.0,
                 tenant_weights: dict[str, float] | None = None):
        self.export_dir = export_dir
        self._cluster = cluster
        self.max_batch = (int(max_batch) if max_batch is not None
                          else env_int("TOS_SERVE_MAX_BATCH", 64))
        delay_ms = (float(max_delay_ms) if max_delay_ms is not None
                    else env_float("TOS_SERVE_MAX_DELAY_MS", 5.0))
        self.queue_limit = (int(queue_limit) if queue_limit is not None
                            else env_int("TOS_SERVE_QUEUE", 256))
        self.default_timeout = (float(default_timeout)
                                if default_timeout is not None
                                else env_float("TOS_SERVE_TIMEOUT", 30.0))
        if self.max_batch < 1 or self.queue_limit < 1:
            raise ValueError("max_batch and queue_limit must be >= 1")
        if delay_ms < 0 or self.default_timeout <= 0:
            raise ValueError("max_delay_ms must be >= 0 and default_timeout "
                             "> 0")
        self._authkey = cluster.authkey
        self._closed = False
        self._reloading = False
        self._reload_lock = tos_named_lock("gateway._reload_lock")
        self._rollout: RolloutGovernor | None = None
        self._router = ReplicaRouter(cluster, None,  # batcher set just below
                                     qname_in=qname_in, qname_out=qname_out,
                                     request_timeout=self.default_timeout)
        self._batcher = MicroBatcher(
            self._router.submit, max_batch=self.max_batch,
            max_delay_secs=delay_ms / 1e3, queue_limit=self.queue_limit,
            pause_fn=lambda: self._reloading,
            capacity_fn=self._router.has_capacity,
            tenant_weights=tenant_weights)
        self._router._batcher = self._batcher
        # sharded-embedding bundles: the config's "sharded_embedding" block
        # puts the router into fan-out mode (gather each batch's fused-
        # table rows from the replica shards before scoring)
        self._refresh_embed_plan()
        # version watch: swap in a newer export, draining in-flight first
        self._export_sig = self._export_signature()
        self._watch_stop = threading.Event()
        self._watch_thread: threading.Thread | None = None
        if reload_poll_secs and reload_poll_secs > 0:
            self._watch_thread = threading.Thread(
                target=self._watch_loop, args=(float(reload_poll_secs),),
                daemon=True, name="serve-version-watch")
            self._watch_thread.start()
        # TCP frontend (the wire endpoint): a single-thread reactor serving
        # every connection — see serving/frontend.py.  Default
        # listen_host="" binds ALL interfaces — remote callers are the
        # point, and every connection must pass the HMAC handshake on the
        # cluster authkey; pass listen_host="127.0.0.1" to confine it.
        self._frontend: ReactorFrontend | None = None
        self._endpoint: tuple[str, int] | None = None
        if listen:
            listener = bound_socket(listen_host)
            port = listener.getsockname()[1]
            self._endpoint = (listen_host or local_ip() or "127.0.0.1", port)
            self._frontend = ReactorFrontend(
                listener, self._authkey, self._batcher,
                default_timeout=self.default_timeout,
                handshake_timeout=handshake_timeout,
                max_conn_outstanding=max_conn_outstanding)
        logger.info("serving gateway up: %d replica(s), max_batch=%d, "
                    "max_delay=%.1fms, queue=%d%s",
                    len(cluster._feed_ids), self.max_batch, delay_ms,
                    self.queue_limit,
                    f", endpoint={self._endpoint}" if self._endpoint else "")

    # -- request API ---------------------------------------------------------

    @property
    def endpoint(self) -> tuple[str, int] | None:
        """(host, port) of the TCP frontend (None when ``listen=False``)."""
        return self._endpoint

    def predict(self, rows: Sequence[Any], timeout: float | None = None,
                tenant: str | None = None) -> list:
        """Score ``rows``; returns one result per row, in order.

        Raises :class:`ServeQueueFull` when admission control rejects the
        request (queue full — the 503), :class:`ServeThrottled` when the
        request's *tenant* is over its rate limit or brownout share (the
        429 — other tenants are still being served), :class:`ServeTimeout`
        when the deadline (``timeout``, default ``TOS_SERVE_TIMEOUT``)
        expires first, and :class:`ServeClosed` after shutdown.
        """
        return self.predict_async(rows, timeout, tenant).result()

    def predict_async(self, rows: Sequence[Any],
                      timeout: float | None = None,
                      tenant: str | None = None) -> PendingPrediction:
        """Admit one request and return immediately; ``result()`` blocks.
        ``tenant`` scopes fairness (queues, rate limits, brownout shares);
        omitted means the anonymous tenant."""
        deadline = _monotonic() + (timeout if timeout is not None
                                   else self.default_timeout)
        return PendingPrediction(
            self._batcher,
            self._batcher.submit(rows, deadline, tenant or ""))

    def healthy_replicas(self) -> list[int]:
        return self._router.healthy_replicas()

    def replica_loads(self) -> dict[int, int]:
        """Per-replica outstanding batches (the router's routing signal) —
        what autoscaling victim selection reads."""
        return self._router.replica_loads()

    def shed_level(self) -> int:
        """Current brownout rung (0 = normal; see ``TOS_SERVE_SHED_LADDER``)."""
        return self._batcher.shed_level()

    def tenant_depths(self) -> dict[str, int]:
        """Queued requests per tenant (nonzero only)."""
        return self._batcher.tenant_depths()

    # -- elastic membership (driven by cluster.resize) -----------------------

    def add_replica(self, executor_id: int) -> bool:
        """Admit a freshly-registered serving node into this gateway's
        routing (scale-out)."""
        return self._router.add_replica(executor_id)

    def retire_replica(self, executor_id: int, timeout: float = 60.0) -> bool:
        """Drain one replica out of this gateway's routing (scale-in): stop
        routing to it, let its in-flight batches finish (re-routing them to
        survivors on timeout or death), then drop it."""
        return self._router.retire_replica(executor_id, timeout)

    # -- hot reload ----------------------------------------------------------

    def reload(self) -> dict[int, Any]:
        """Swap every replica onto the bundle currently in ``export_dir``:
        pause dispatch, drain in-flight batches, round-trip the reload
        control item through each replica, resume.  Returns per-replica
        acks.  Called automatically by the version watcher; safe to call
        by hand after an in-place re-export.  Refused while a staged
        rollout is in flight — a fleet-wide swap would clobber the canary
        cohort's candidate bundle under the governor."""
        with self._reload_lock:
            if self._rollout is not None and self._rollout.active():
                raise RuntimeError(
                    "a staged rollout is in flight; wait for it to resolve "
                    "(or roll it back) before a fleet-wide reload")
            self._reloading = True
            try:
                self._router.drain()
                ctl = {CTL_KEY: "reload", "export_dir": self.export_dir}
                acks = self._router.broadcast_ctl(ctl)
                self._quarantine_laggards(
                    acks, bundle_signature(self.export_dir), ctl)
                self._refresh_embed_plan()
                telemetry.counter("serve.reloads_total").inc()
                ttrace.event("reload", export_dir=self.export_dir,
                             replicas=sorted(acks))
                logger.info("serving bundle reloaded on replicas %s",
                            sorted(acks))
                return acks
            finally:
                self._reloading = False

    def _quarantine_laggards(self, acks: dict[int, Any], want: tuple,
                             ctl: dict) -> list[int]:
        """The mixed-fleet guard: every replica whose reload ack does not
        carry the expected bundle signature is fenced out of routing with
        the ctl pinned for recovery replay (``quarantine_for_reload``), so
        a half-applied swap can never keep silently serving the stale
        bundle next to the converged fleet.  (Replicas that failed the
        round outright were already fenced + pinned by the broadcast.)"""
        laggards = [eid for eid, ack in acks.items()
                    if not (isinstance(ack, dict)
                            and tuple(ack.get("signature") or ()) == want)]
        for eid in laggards:
            logger.warning("serving replica %d acked the reload with the "
                           "wrong bundle signature; quarantined until "
                           "recovery converges it", eid)
            self._router.quarantine_for_reload(eid, ctl)
        return laggards

    def _refresh_embed_plan(self) -> None:
        """Read the active export's bundle config and (re)arm the router's
        sharded-embedding fan-out when it carries a ``sharded_embedding``
        block — called at construction and after every fleet-wide reload
        (a newer export may have moved the table's final step or
        geometry).  Never raises: a malformed block degrades to plain
        dense routing with a warning."""
        import json
        import os

        from tensorflowonspark_torch.utils.paths import resolve_uri

        try:
            with open(os.path.join(resolve_uri(self.export_dir),
                                   "bundle.json")) as f:
                config = json.load(f)
            block = config.get("sharded_embedding")
            if block:
                from tensorflowonspark_torch.embedding.serve import make_id_fn

                self._router.set_embed_plan(block, make_id_fn(config))
        except Exception:  # noqa: BLE001 - degrade to dense routing
            logger.warning("could not arm sharded-embedding routing from "
                           "%s", self.export_dir, exc_info=True)

    def _export_signature(self) -> tuple:
        """Change signature of the active export (see
        ``checkpoint.bundle_signature``): a changed tuple is a complete
        newer export, thanks to the atomic-rename commit."""
        return bundle_signature(self.export_dir)

    def _watch_loop(self, poll: float) -> None:
        while not self._watch_stop.wait(poll):
            try:
                cur = self._export_signature()
            except Exception:  # noqa: BLE001 - transient fs hiccup
                logger.debug("export version check failed", exc_info=True)
                continue
            if cur and cur != self._export_sig:
                logger.info("newer export detected in %s; hot-reloading",
                            self.export_dir)
                try:
                    self.reload()
                except Exception:  # noqa: BLE001 - keep serving the old bundle
                    # signature NOT advanced: the next poll retries the swap
                    # instead of pinning the stale bundle forever
                    logger.warning("hot reload failed; still serving the "
                                   "previous bundle (will retry)",
                                   exc_info=True)
                else:
                    # under the reload lock: a promotion updates the active
                    # signature too, and the two must not interleave
                    with self._reload_lock:
                        self._export_sig = cur

    # -- staged rollouts (shadow/canary + governed promote/rollback) ---------

    def rollout(self, export_dir: str, *, canary_pct: int | None = None,
                shadow: bool | int = True,
                window_secs: float | None = None,
                auto_promote: bool = True,
                **governor_kwargs) -> RolloutGovernor:
        """Stage the bundle at ``export_dir`` as a rollout CANDIDATE
        instead of swapping the fleet onto it.

        Mechanics: pause + drain, load the candidate on a canary cohort
        (``canary_pct`` percent of the healthy replicas, at least one,
        never all) via a targeted signature-verified control round, then
        resume with split routing — every ``100/canary_pct``-th batch
        rides the canary, and with ``shadow`` enabled primary batches are
        mirrored onto it (every Nth when ``shadow`` is an int) so the
        governor can diff candidate outputs against primary answers that
        were already served.  The returned :class:`RolloutGovernor` then
        watches the canary for ``window_secs`` (default
        ``TOS_SERVE_ROLLOUT_WINDOW_SECS``) and promotes fleet-wide or
        auto-rolls the canaries back; ``.wait()`` blocks for the outcome,
        ``.status()`` is the live picture.  The in-flight state is
        journaled in the coordinator's rollout registry.
        """
        if self._closed:
            raise ServeClosed("serving gateway is closed")
        pct = (int(canary_pct) if canary_pct is not None
               else env_int("TOS_SERVE_CANARY_PCT", 25))
        if not 0 < pct <= 100:
            raise ValueError("canary_pct must be in (0, 100]")
        want = bundle_signature(export_dir)
        if not want:
            raise ValueError(f"no exported bundle found at {export_dir!r}")
        ctl = {CTL_KEY: "reload", "export_dir": export_dir,
               "candidate": True}
        with self._reload_lock:
            if self._rollout is not None and self._rollout.active():
                raise RuntimeError("a staged rollout is already in flight")
            healthy = self._router.healthy_replicas()
            if len(healthy) < 2:
                raise RuntimeError(
                    "staged rollout needs >= 2 healthy replicas (one must "
                    "keep serving primary traffic); use reload() on a "
                    "single-replica fleet")
            # deterministic cohort: lowest executor ids — stable across
            # retries and reconstructable from the journaled state
            n = max(1, min(len(healthy) - 1,
                           math.ceil(len(healthy) * pct / 100)))
            canary = healthy[:n]
            self._reloading = True
            try:
                self._router.drain()
                acks = self._router.ctl_to(canary, ctl)
                laggards = set(self._quarantine_laggards(acks, want, ctl))
                cohort = [eid for eid in canary
                          if eid in acks and eid not in laggards]
                if not cohort:
                    raise RuntimeError(
                        f"no canary replica loaded the candidate bundle "
                        f"from {export_dir!r}; rollout aborted "
                        f"(fleet unchanged)")
                mirror_every = (0 if not shadow
                                else 1 if shadow is True else max(1, int(shadow)))
                state = RolloutState(candidate=export_dir,
                                     prior=self.export_dir, canary=cohort,
                                     pct=pct, shadow=bool(shadow))
                governor = RolloutGovernor(
                    self, state, window_secs=window_secs,
                    auto_promote=auto_promote, **governor_kwargs)
                self._router.set_rollout(
                    cohort,
                    traffic_every=max(1, round(100 / pct)),
                    mirror_every=mirror_every,
                    observer=governor.observe,
                    canary_ctl=ctl,
                    shed_fn=self._batcher.shed_level)
                self._rollout = governor
            finally:
                self._reloading = False
        telemetry.counter("serve.rollouts_total").inc()
        ttrace.event("rollout_started", candidate=export_dir,
                     canary=cohort, pct=pct, shadow=bool(shadow))
        logger.info("staged rollout of %s: canary cohort %s (%d%% traffic"
                    "%s)", export_dir, cohort, pct,
                    ", shadow mirroring" if mirror_every else "")
        self._note_rollout(state.payload())
        governor.start()
        return governor

    def rollout_status(self) -> dict | None:
        """The current (or last) rollout's live status dict, or None if
        this gateway never staged one."""
        gov = self._rollout
        return None if gov is None else gov.status()

    def _promote_rollout(self, governor: RolloutGovernor) -> None:
        """Governor callback: the canary window stayed clean — swap the
        WHOLE fleet onto the candidate via the verified reload path and
        end the split.  The candidate becomes the gateway's active
        ``export_dir`` (the version watcher now tracks it)."""
        candidate = governor.state.candidate
        want = bundle_signature(candidate)
        with self._reload_lock:
            self._reloading = True
            try:
                self._router.drain()
                # no `candidate` bit: post-promotion this is the active
                # bundle everywhere (bad_model chaos stops firing too)
                ctl = {CTL_KEY: "reload", "export_dir": candidate}
                acks = self._router.broadcast_ctl(ctl)
                self._quarantine_laggards(acks, want, ctl)
                self._router.clear_rollout()
                self.export_dir = candidate
                self._export_sig = want
            finally:
                self._reloading = False
        telemetry.counter("serve.promotions_total").inc()
        ttrace.event("rollout_promoted", candidate=candidate,
                     replicas=sorted(acks))
        logger.info("rollout promoted: fleet now serving %s", candidate)

    def _rollback_rollout(self, governor: RolloutGovernor,
                          reason: str | None) -> None:
        """Governor callback: the canary regressed — reload the canary
        cohort back onto the prior export and end the split.  Primary
        replicas never touched the candidate, so they need nothing."""
        state = governor.state
        ctl = {CTL_KEY: "reload", "export_dir": state.prior}
        with self._reload_lock:
            self._reloading = True
            try:
                self._router.drain()
                acks = self._router.ctl_to(state.canary, ctl)
                self._quarantine_laggards(acks, bundle_signature(state.prior),
                                          ctl)
                self._router.clear_rollout()
            finally:
                self._reloading = False
        telemetry.counter("serve.rollbacks_total").inc()
        ttrace.event("rollout_rolled_back", candidate=state.candidate,
                     reason=reason, replicas=sorted(acks))
        logger.warning("rollout of %s rolled back: %s", state.candidate,
                       reason)

    def _note_rollout(self, payload: dict) -> None:
        """Best-effort journal of the rollout state through the
        coordinator's rollout registry (keyed by this gateway's router
        name) — failover/statz evidence, never allowed to break serving."""
        coord = getattr(self._cluster, "coordinator", None)
        if coord is None or not hasattr(coord, "note_rollout"):
            return
        try:
            coord.note_rollout(self._router._registry_name, payload)
        except Exception:  # noqa: BLE001 - journal publish must not break serving
            logger.debug("rollout journal publish failed", exc_info=True)

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Stop accepting, fail queued requests, tear the layers down.
        Called automatically by ``cluster.shutdown()``."""
        if self._closed:
            return
        self._closed = True
        self._watch_stop.set()
        if self._watch_thread is not None:
            self._watch_thread.join(timeout=10.0)
        if self._rollout is not None:
            # journal the abort before the layers come down: the registry
            # must not read "canary" forever off a gateway that is gone
            with contextlib.suppress(Exception):
                self._rollout.stop()
        # router + batcher first: closing them resolves every request (the
        # last completion producers), so the frontend's reactor — still
        # draining — delivers the final error replies, and stop() can then
        # safely retire the wake pipe with no racing writers left.
        self._router.close()
        self._batcher.close()
        if self._frontend is not None:
            self._frontend.stop()


class _GatewayFuture:
    """Async handle for one pipelined :class:`GatewayClient` request:
    ``result()`` blocks until the id-matched reply arrives and returns the
    results or raises the mapped gateway error."""

    __slots__ = ("_event", "_reply", "_error", "_timeout", "_slack",
                 "_deadline")

    def __init__(self, timeout: float, slack: float = 30.0):
        self._event = threading.Event()
        self._reply: tuple | None = None
        self._error: Exception | None = None
        self._timeout = timeout
        self._slack = slack
        # client-side hang detector: the gateway answers every accepted
        # request by its server-side deadline, so a reply this overdue
        # (TOS_SERVE_CLIENT_SLACK past it) means the connection is dead,
        # not slow
        self._deadline = _monotonic() + timeout + slack

    def done(self) -> bool:
        return self._event.is_set()

    def _resolve(self, reply: tuple) -> None:
        self._reply = reply
        self._event.set()

    def _resolve_error(self, error: Exception) -> None:
        self._error = error
        self._event.set()

    def result(self, timeout: float | None = None):
        """The request's results (or raises its error).  ``timeout`` is a
        client-side backstop on top of the server-enforced deadline — the
        gateway answers every accepted request, so this should only fire
        when the server is unreachable (then the receiver poisons the
        client and resolves every future with the connection error)."""
        budget = timeout if timeout is not None else self._timeout + self._slack
        if not self._event.wait(budget):
            raise ServeTimeout(
                f"no gateway reply within the client-side budget ({budget:.1f}s)")
        if self._error is not None:
            raise self._error
        reply = self._reply
        if isinstance(reply, tuple) and reply and reply[0] == "ok":
            return reply[1]
        if isinstance(reply, tuple) and len(reply) >= 3 and reply[0] == "err":
            raise _ERR_TYPES.get(reply[1], RuntimeError)(reply[2])
        raise RuntimeError(f"malformed gateway reply: {reply!r}")


class GatewayClient:
    """Pipelined remote caller for a gateway's TCP endpoint.

    Same wire stack as the data plane — HMAC challenge-response on the
    cluster authkey, then v2 (protocol-5, zero-copy) frames — but
    *multiplexed*: every request carries a client-assigned id, many
    requests stay outstanding on the one socket (``predict_async``), and a
    receiver thread resolves futures as id-tagged replies arrive, in
    whatever order the gateway finishes them.  ``predict`` is the
    closed-loop convenience (``predict_async(...).result()``).

    ``max_outstanding`` (0 = unbounded) caps the client-side pipeline
    depth with a semaphore — the gateway additionally enforces its own
    per-connection cap (``TOS_SERVE_CONN_OUTSTANDING``) with fast-fail
    ``ServeQueueFull`` replies.
    """

    def __init__(self, host: str, port: int, authkey: bytes, *,
                 connect_timeout: float = 30.0, call_timeout: float = 120.0,
                 max_outstanding: int = 0, tenant: str | None = None):
        self._sock = connect_with_backoff((host, port),
                                          timeout=connect_timeout)
        self._sock.settimeout(call_timeout)
        if not hmac_handshake_client(self._sock, authkey):
            self._sock.close()
            raise RuntimeError("gateway auth handshake failed")
        self._call_timeout = call_timeout
        # fairness identity: rides every predict frame as a trailing field
        # (absent for the default "" — byte-identical to the pre-tenant
        # wire, which is what keeps id-less/legacy clients compatible;
        # they all land in the anonymous tenant)
        self._tenant = str(tenant) if tenant else ""
        # reply-reaper backstop past the server-enforced deadline: how much
        # grace an overdue reply gets before the connection is presumed dead
        self._slack = env_float("TOS_SERVE_CLIENT_SLACK", 30.0)
        # frame-write serializer: interleaved sendmsg from two threads would
        # interleave frame bytes (same deliberate hold-lock-across-I/O
        # pattern as DataClient._call; baselined in analysis/baseline.json)
        self._send_lock = tos_named_lock("gateway.client._send_lock")
        self._lock = tos_named_lock("gateway.client._lock")  # id counter + pending map + closed
        self._pending: dict[int, _GatewayFuture] = {}
        self._next_id = 1
        self._closed = False
        self._sem = (threading.Semaphore(max_outstanding)
                     if max_outstanding > 0 else None)
        self._rx = threading.Thread(target=self._recv_loop, daemon=True,
                                    name="gateway-client-rx")
        self._rx.start()

    # -- wire ----------------------------------------------------------------

    def _start(self, msg: tuple, timeout: float,
               tail: tuple = ()) -> _GatewayFuture:
        """Register a future under a fresh id and send ``msg + (id,) +
        tail`` (``tail`` carries optional post-id fields like the tenant
        key — old gateways ignore trailing fields they don't know)."""
        if self._sem is not None:
            self._sem.acquire()
        with self._lock:
            if self._closed:
                if self._sem is not None:
                    self._sem.release()
                raise ServeClosed("gateway client is closed")
            rid = self._next_id
            self._next_id += 1
            fut = _GatewayFuture(timeout, self._slack)
            self._pending[rid] = fut
        try:
            with self._send_lock:
                _send(self._sock, (*msg, rid, *tail), wire=2)
        except (TimeoutError, OSError) as e:
            self._poison(e)
            raise
        return fut

    def _recv_loop(self) -> None:
        import select as _select

        try:
            while True:
                # Wait for readability OUTSIDE the frame reader: a timeout
                # here consumes no stream bytes, so an idle (or
                # about-to-reply) connection is never poisoned by quiet
                # time — only a genuinely overdue pending request is.
                # Once bytes are ready, _recv runs with call_timeout armed
                # on the socket: a stall MID-frame at that scale really is
                # a dead peer.
                while True:
                    ready, _, _ = _select.select([self._sock], [], [], 1.0)
                    if ready:
                        break
                    self._check_overdue()
                reply = _recv(self._sock)
                if not isinstance(reply, tuple) or not reply:
                    continue
                if reply[0] == "okm":
                    # multi-reply frame: one batch scatter's worth of
                    # (rid, "ok"/"err", ...) entries coalesced by the
                    # reactor; entry[1:] is the single-reply tuple shape
                    for entry in reply[1]:
                        self._resolve_one(entry[0], tuple(entry[1:]))
                    continue
                rid = (reply[-1] if len(reply) >= 2
                       and isinstance(reply[-1], int) else None)
                if rid is None:
                    continue  # close ack / unsolicited frame
                self._resolve_one(rid, reply[:-1])
        except (ConnectionError, OSError, EOFError, ValueError) as e:
            # ValueError: select() on a socket another thread just closed
            self._poison(e)

    def _check_overdue(self) -> None:
        now = _monotonic()
        with self._lock:
            if self._closed:
                raise ConnectionError("gateway client closed")
            overdue = any(f._deadline <= now for f in self._pending.values())
        if overdue:
            raise ConnectionError(
                "no gateway reply well past the request deadline; "
                "connection presumed dead")

    def _resolve_one(self, rid, payload: tuple) -> None:
        with self._lock:
            fut = self._pending.pop(rid, None)
        if fut is not None:
            if self._sem is not None:
                self._sem.release()
            fut._resolve(payload)

    def _poison(self, error: Exception) -> None:
        """Terminal: fail every pending future and close the socket.  A
        stream that errored may hold partial frames — there is no way to
        resync, so the client is done (mirror of DataClient._call)."""
        with self._lock:
            was_closed, self._closed = self._closed, True
            pending, self._pending = self._pending, {}
        with contextlib.suppress(OSError):
            self._sock.close()
        err = (ServeClosed("gateway client closed") if was_closed
               else ConnectionError(f"gateway connection lost: {error}"))
        for fut in pending.values():
            if self._sem is not None:
                self._sem.release()
            fut._resolve_error(err)

    # -- API -----------------------------------------------------------------

    def predict_async(self, rows: Sequence[Any],
                      timeout: float | None = None,
                      tenant: str | None = None) -> _GatewayFuture:
        """Send one predict request; returns a future resolved by reply id.
        Many may be outstanding — that is the point.  ``tenant`` overrides
        the client's default fairness identity for this request."""
        t = float(timeout) if timeout is not None else self._call_timeout
        ten = self._tenant if tenant is None else str(tenant)
        return self._start(("predict", list(rows), timeout), t,
                           (ten,) if ten else ())

    def predict(self, rows: Sequence[Any], timeout: float | None = None,
                tenant: str | None = None) -> list:
        """Round-trip one predict request; mirrors ``ServingGateway.predict``
        including its error types (``ServeThrottled`` = this tenant is over
        its rate limit / brownout share)."""
        return self.predict_async(rows, timeout, tenant).result()

    def outstanding(self) -> int:
        """Requests currently awaiting replies (the pool's load signal)."""
        with self._lock:
            return len(self._pending)

    def ping(self, timeout: float = 10.0) -> bool:
        try:
            return self._start(("ping",), timeout).result(timeout) == "pong"
        except (ConnectionError, OSError, ServeTimeout):
            return False

    def close(self) -> None:
        """Best-effort close op, then poison: outstanding futures resolve
        with ``ServeClosed``."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        try:
            with self._send_lock:
                _send(self._sock, ("close",), wire=2)
        except OSError:  # toslint: allow-silent(best-effort teardown; the poison below closes the socket regardless)
            pass
        self._poison(ServeClosed("client closed"))
        self._rx.join(timeout=5.0)


class GatewayClientPool:
    """A fixed pool of pipelined :class:`GatewayClient` connections.

    Closed-loop callers (one request in flight per caller thread) cannot
    exploit pipelining on their own; the pool gives a fleet of them
    connection reuse + multiplexing for free: each call goes to the pooled
    connection with the fewest outstanding requests, so T caller threads
    share ``size`` sockets instead of opening T.  All methods are
    thread-safe; every client maps its own futures by id, so interleaving
    is free of head-of-line blocking at the protocol level.
    """

    def __init__(self, host: str, port: int, authkey: bytes, *,
                 size: int = 4, **client_kwargs):
        if size < 1:
            raise ValueError("pool size must be >= 1")
        self._clients = [GatewayClient(host, port, authkey, **client_kwargs)
                         for _ in range(size)]

    def _pick(self) -> GatewayClient:
        return min(self._clients, key=lambda c: c.outstanding())

    def predict_async(self, rows: Sequence[Any],
                      timeout: float | None = None,
                      tenant: str | None = None) -> _GatewayFuture:
        return self._pick().predict_async(rows, timeout, tenant)

    def predict(self, rows: Sequence[Any], timeout: float | None = None,
                tenant: str | None = None) -> list:
        return self.predict_async(rows, timeout, tenant).result()

    def ping(self) -> bool:
        return all(c.ping() for c in self._clients)

    def close(self) -> None:
        for c in self._clients:
            with contextlib.suppress(Exception):
                c.close()


class LegacyGatewayClient:
    """The pre-reactor one-request-per-round-trip caller: id-less predict
    frames, blocking request/reply on one socket.  Kept as the wire-
    compatibility reference — the reactor must answer these clients
    forever (depth 1, id-less replies) — and for minimal embedded callers
    that want no background thread."""

    def __init__(self, host: str, port: int, authkey: bytes, *,
                 connect_timeout: float = 30.0, call_timeout: float = 120.0):
        self._sock = connect_with_backoff((host, port),
                                          timeout=connect_timeout)
        self._sock.settimeout(call_timeout)
        if not hmac_handshake_client(self._sock, authkey):
            self._sock.close()
            raise RuntimeError("gateway auth handshake failed")
        # request/reply serializer (same deliberate hold-lock-across-I/O
        # pattern as DataClient._call; baselined in analysis/baseline.json)
        self._lock = tos_named_lock("gateway.legacy._lock")

    def _call(self, msg: tuple):
        with self._lock:
            try:
                _send(self._sock, msg, wire=2)
                return _recv(self._sock)
            except (TimeoutError, OSError):
                # the stream may hold a partial frame or a late reply; a
                # retry on it would read the PREVIOUS request's answer as
                # its own — poison the socket (mirror of DataClient._call)
                with contextlib.suppress(OSError):
                    self._sock.close()
                raise

    def predict(self, rows: Sequence[Any], timeout: float | None = None) -> list:
        reply = self._call(("predict", list(rows), timeout))
        if isinstance(reply, tuple) and reply and reply[0] == "ok":
            return reply[1]
        if isinstance(reply, tuple) and len(reply) >= 3 and reply[0] == "err":
            raise _ERR_TYPES.get(reply[1], RuntimeError)(reply[2])
        raise RuntimeError(f"malformed gateway reply: {reply!r}")

    def ping(self) -> bool:
        reply = self._call(("ping",))
        return bool(isinstance(reply, tuple) and reply and reply[0] == "ok")

    def close(self) -> None:
        try:
            with self._lock:
                _send(self._sock, ("close",), wire=2)
                try:
                    _recv(self._sock)
                except (ConnectionError, OSError, EOFError):  # toslint: allow-silent(best-effort close ack; the gateway may already be gone)
                    pass
        except OSError:  # toslint: allow-silent(best-effort teardown; socket close below is what matters)
            pass
        finally:
            self._sock.close()
