"""Cluster rendezvous / control-plane coordinator.

TPU-native replacement for ``tensorflowonspark/reservation.py`` (reference:
``MessageSocket`` 4-byte length framing ``:~20-60``; REG/QUERY/QINFO/STOP
``:~100-200``; ``Server.await_reservations`` ``:~120-160``).  Differences by
design (SURVEY.md §5.2, §5.8):

- **Race-free identity**: the server *assigns* ``executor_id`` and the job
  role (chief/worker/evaluator) at registration, instead of deriving it from a
  Spark partition id — this is the ``CUDA_VISIBLE_DEVICES``-handout replaced
  by mesh-coordinate handout (BASELINE.json:5).
- **Barrier + reduce primitives**: sync SPMD needs *global* agreement (e.g.
  the end-of-data consensus of SURVEY.md §7.3-1), which the reference's async
  PS design never needed.  ``reduce`` implements an all-reduce over the
  control plane (DCN), not the tensor plane.
- **Heartbeats**: the reference relied on Spark noticing dead executors;
  with no Spark layer the coordinator tracks liveness itself (SURVEY.md §5.3).
- **JSON framing, not pickle**: the control plane carries only small metadata
  dicts; JSON avoids arbitrary-object deserialization on the driver.

The *tensor* plane never touches this module: device-to-device traffic is XLA
collectives over ICI emitted by jit-compiled SPMD programs (SURVEY.md §5.8-2).
"""

from __future__ import annotations

import contextlib
import json
import logging
import socket
import socketserver
import struct
import threading
from tensorflowonspark_torch.utils.locks import tos_named_condition, tos_named_lock
import time
from typing import Any

from tensorflowonspark_torch import faultinject, telemetry
from tensorflowonspark_torch.telemetry import trace as ttrace
from tensorflowonspark_torch.telemetry.registry import percentile_of

logger = logging.getLogger(__name__)

# Per-node "recent span samples" kept for cluster-wide percentile pooling
# (each heartbeat delta ships up to telemetry.OUTBOX_SIZE new samples per
# histogram; the store keeps a bounded tail per (node, metric)).
_HIST_RECENT_CAP = 256
# Per-node trace-stream store bounds: spans a run keeps for the merged
# trace.json, flight events for the run report's timeline.
_TRACE_SPAN_CAP = 16384
_TRACE_EVENT_CAP = 1024
# Rolling-stats history: one entry per heartbeat merge (nodes) / sampler
# tick (driver); 240 entries at ~1-2s cadence cover several minutes of
# window, far past any sensible `cluster.stats(window=...)`.
_STATS_HISTORY_CAP = 240
# Write-ahead journal snapshot cadence: after this many appended records the
# stats thread folds the full control-plane state into <journal>.snap and
# truncates the tail, so crash recovery replays O(delta) records.
_JOURNAL_SNAPSHOT_EVERY = 256
# Straggler-suspicion vote freshness: votes older than this never count
# toward an eviction quorum (a live straggler's accusers re-file every
# second; a one-off hiccup's vote must age out, not lie in ambush).
_SUSPECT_VOTE_TTL = 30.0
# Eviction confirmation hold: quorum against a suspect must SURVIVE this
# window before the eviction fires.  Uniform slowness makes everyone blame
# their upstream at once, but the votes arrive one by one — a partial
# blame cycle is indistinguishable from a genuine chain until the would-be
# suspect's own vote lands and dissolves it.  A true straggler files
# nothing (it is busy being wedged), so it only costs ~this much detection
# latency; accusers re-file every second, which re-evaluates the hold.
_EVICT_CONFIRM_SECS = 2.0

_LEN = struct.Struct(">I")
_MAX_FRAME = 64 * 1024 * 1024


class CoordinatorRestarted(RuntimeError):
    """The control plane crashed and restarted under this call: the
    connection (or rendezvous generation) the request rode is gone, or the
    request carried a pre-crash coordinator epoch and was fenced.  The
    client has already reconnected and learned the new epoch — callers own
    the retry at their own abstraction level (a collective group re-forms
    at the next generation barrier; idempotent ops are retried
    transparently and never raise this)."""


class CoordinatorFenced(RuntimeError):
    """This client's (executor_id, incarnation) is FENCED: the slot was
    declared dead and re-fenced, or — the gray-failure case — the process
    was EVICTED from its collective group at quorum and parked in
    probation.  A RuntimeError subclass so existing retry loops keep
    working; typed so a collective ``form`` can tell "ride out probation,
    readmission will hand me a fresh incarnation" apart from transient
    rendezvous churn."""


def _send_msg(sock: socket.socket, obj: dict) -> None:
    # chaos seam: `delay_net:ms=M` injects latency on every control-plane
    # send in the armed process (no-op unless TOS_FAULTINJECT armed it)
    faultinject.net_delay()
    data = json.dumps(obj).encode("utf-8")
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_msg(sock: socket.socket) -> dict:
    from tensorflowonspark_torch.utils.net import recv_exact

    (n,) = _LEN.unpack(recv_exact(sock, 4))
    if n > _MAX_FRAME:
        raise ValueError(f"frame too large: {n}")
    return json.loads(recv_exact(sock, n).decode("utf-8"))


class _Rendezvous:
    """One barrier/reduce *generation* shared by ``count`` participants.

    Lifecycle: participants join until ``count`` values arrive, the last one
    computes the result and marks ``done`` (popping the registry entry, so a
    subsequent same-named call starts a fresh generation while waiters still
    hold this object).  A participant that times out marks the generation
    ``aborted`` and pops it, so retries never observe stale values.
    """

    def __init__(self, count: int):
        self.count = count
        self.cond = tos_named_condition("coordinator.rendezvous._cond")
        self.values: list[Any] = []
        self.result: Any = None
        self.done = False
        self.aborted = False
        # span anchor: generation open -> last participant closes it
        self.t0 = time.monotonic()


def _window_stats(entries: list, now: float, window: float) -> dict | None:
    """Rolling-window view of one stream's history entries
    ``(t, cumulative_counters, gauges, hist_samples)``: counter rates over
    the window, percentiles pooled from in-window samples only, latest
    gauges.  None when the stream has no history at all."""
    if not entries:
        return None
    start = now - window
    last_t, last_counters, last_gauges, _ = entries[-1]
    # baseline: the newest entry at/before the window start (so the delta
    # spans the whole window); with a short history, the earliest entry
    base = entries[0]
    for e in entries:
        if e[0] <= start:
            base = e
        else:
            break
    rates: dict[str, float] = {}
    if last_t <= start:
        # nothing moved inside the window: every rate is flat zero (a stale
        # delta must not report phantom load after traffic stops)
        rates = {name: 0.0 for name in last_counters}
    else:
        dt = last_t - base[0]
        if dt > 0:
            for name, v in last_counters.items():
                # clamp: a counter reset inside the window (process restart
                # the history clear raced) must read as idle, never negative
                delta = max(0, v - base[1].get(name, 0))
                if delta:
                    rates[name] = round(delta / dt, 3)
                else:
                    rates[name] = 0.0
    pool: dict[str, list[float]] = {}
    for t, _c, _g, samples in entries:
        if t < start:
            continue
        for name, vals in samples.items():
            pool.setdefault(name, []).extend(vals)
    percentiles = {
        name: {"n": len(vals),
               "p50": percentile_of(vals, 50.0),
               "p99": percentile_of(vals, 99.0)}
        for name, vals in ((n, sorted(v)) for n, v in pool.items()) if vals}
    return {"age_secs": round(now - last_t, 3), "rates": rates,
            "gauges": dict(last_gauges), "percentiles": percentiles}


def _pct_ms(stream: dict, name: str, q: str) -> float | None:
    v = ((stream.get("percentiles") or {}).get(name) or {}).get(q)
    return round(v * 1e3, 3) if v is not None else None


def _reduce(kind: str, values: list[Any]) -> Any:
    if kind == "any":
        return any(values)
    if kind == "all":
        return all(values)
    if kind == "sum":
        return sum(values)
    if kind == "min":
        return min(values)
    if kind == "max":
        return max(values)
    if kind == "gather":
        return values
    if kind == "form":
        # Collective-group formation rendezvous (collective/group.py): each
        # participant contributes {eid, host, port, gen, step}; everyone
        # gets back the SAME membership view — eid-sorted members (rank =
        # index of own eid), the max proposed generation (survivors propose
        # cur+1, a cold joiner proposes 1 — max keeps generations monotone
        # across any mix), and the max step vote (the resume point
        # sync_state levels the group onto).  Arrival order never matters.
        members = sorted((dict(v) for v in values),
                         key=lambda m: int(m["eid"]))
        return {"members": members,
                "generation": max(int(m.get("gen", 1)) for m in members),
                "step": max(int(m.get("step", 0)) for m in members)}
    raise ValueError(f"unknown reduce kind: {kind}")


class CoordinatorServer:
    """Driver-side rendezvous server for ``expected`` node processes.

    Mirrors ``reservation.Server`` but also assigns identities/roles and
    provides barrier/reduce/heartbeat/error channels.
    """

    def __init__(self, expected: int, roles: list[tuple[str, int]] | None = None,
                 authkey: bytes | None = None, stats_interval: float = 1.0,
                 journal_path: str | None = None):
        if roles is not None and len(roles) != expected:
            raise ValueError("roles must have one entry per expected node")
        self.expected = expected
        # Shared cluster authkey: when set, every connection must pass the
        # HMAC challenge-response before its first frame is read.  The control
        # plane accepts register/stop from the network once it binds a
        # routable interface, so it gets the same gate the pickle-carrying
        # data plane always had (utils/net.py handshake).
        self.authkey = authkey
        # role for executor i; default: executor 0 is chief, rest workers.
        self.roles = roles or [("chief", 0)] + [("worker", i) for i in range(1, expected)]
        self._lock = tos_named_lock("coordinator._lock")
        self._nodes: list[dict] = []
        self._complete = threading.Event()
        self._stop_flag = threading.Event()
        self._errors: list[dict] = []
        self._rdv: dict[str, _Rendezvous] = {}
        self._last_seen: dict[int, float] = {}
        # Generation fencing (TF-Replicator-style, PAPERS.md): each executor
        # slot has an incarnation number, bumped the moment the slot is
        # declared dead.  Every node-side message carries its incarnation;
        # anything from a stale incarnation — a zombie that lost its network,
        # not its life — is rejected, so a restarted replacement can never
        # race its predecessor on heartbeats, barriers, or reduces.
        self._incarnations: dict[int, int] = {}
        # Elastic membership (cluster.resize): slots being deliberately
        # drained out of service (no new work; death mid-drain finalizes the
        # retirement instead of triggering recovery) and slots already
        # retired for good (their executor_id is never reused — SPMD-style
        # positional identity stays stable across the cluster's lifetime).
        self._draining: set[int] = set()
        self._retired: set[int] = set()
        # Telemetry store: the latest raw registry snapshot per executor,
        # merged key-by-key from the compact deltas nodes piggyback on
        # heartbeats (and the final snapshot sent with deregister).  Values
        # are absolute cumulative per process, so merging is replacement and
        # a dropped heartbeat never loses counts; a restarted slot's
        # counters restart with its process (per-incarnation counters).
        self._node_metrics: dict[int, dict] = {}
        self._hist_recent: dict[int, dict[str, list[float]]] = {}
        # Trace-stream store: spans/flight events each node piggybacks on
        # heartbeats (and the final deregister), plus its latest clock
        # offset estimate, keyed by executor id; "driver" entries accumulate
        # from this process's own tracer on demand (bounded like the rest).
        self._node_trace: dict[str, dict] = {}
        # Rolling-stats history (cluster.stats): per node one timestamped
        # entry per heartbeat merge; the "driver" stream is appended by a
        # sampler thread started with the server (the driver sends no
        # heartbeats, and its registry holds the serving-gateway signals
        # the autoscaler wants).
        self._stats_history: dict[str, list] = {}
        self._stats_interval = max(0.05, float(stats_interval))
        self._stats_stop = threading.Event()
        self._stats_thread: threading.Thread | None = None
        # DIRECT-mode job manifest: what the driver's shard enumeration
        # produced for the current train() (shard/partition/epoch counts),
        # published so map_funs can read progress denominators without a
        # side channel (ctx.job_manifest()).
        self._manifest: dict = {}
        # Serving replica registry: each ReplicaRouter publishes its healthy
        # replica set here (journal-backed), so a control-plane failover
        # restores which replicas were serving — statz/run-report evidence
        # operators read after the fact.
        self._serving: dict[str, list[int]] = {}
        # Staged-rollout registry (ISSUE 16): each gateway journals its
        # in-flight rollout's state (candidate/prior/canary cohort/status)
        # here, so a control-plane failover restores what was mid-rollout
        # and statz shows promotions/rollbacks after the fact.
        self._rollouts: dict[str, dict] = {}
        # Gray-failure tolerance (ISSUE 15): suspicion votes per collective
        # group ({group: {suspect_eid: {voter_eid: mono_time}}}), the live
        # membership each group's last `form` produced, members EVICTED at
        # quorum and parked in probation ({eid: {"group", "probation_until",
        # "last_ping", "incarnation"}}), slots whose evicted process was
        # readmitted and must relearn its bumped incarnation over its next
        # round-trips ({eid: incarnation}), the event feed the cluster
        # monitor drains (park/unpark the supervisor, rebalance the
        # ledger), and the run-lifetime eviction log for stats/tests.
        self._suspicions: dict[str, dict[int, dict[int, float]]] = {}
        self._evict_pending: dict[tuple[str, int], float] = {}
        self._collective: dict[str, dict] = {}
        self._evicted: dict[int, dict] = {}
        self._readmit_pending: dict[int, int] = {}
        self._collective_events: list[dict] = []
        self._eviction_log: list[dict] = []
        self._readmits_total = 0
        # Write-ahead journal (ISSUE 13): every control-plane mutation
        # appends an fsync'd record (under self._lock, so record order IS
        # mutation order); crash() + restore() replay it into this same
        # object under a bumped COORDINATOR EPOCH carried on every reply.
        # truncate=True: a fresh server is a fresh run — a stale journal
        # from a previous cluster in the same log_dir must never replay.
        self._journal_path = journal_path
        self._journal = None
        if journal_path:
            from tensorflowonspark_torch.journal import Journal

            self._journal = Journal(journal_path, truncate=True)
        self._epoch = 0
        self._crashed = threading.Event()
        self._crash_listeners: list = []
        # live handler connections, severed wholesale by crash() so every
        # client observes an abrupt coordinator death (ECONNRESET), exactly
        # like a real process kill would present
        self._conns: set[socket.socket] = set()
        # initial role template, the restore() fallback when no snapshot
        # exists yet (the journal tail then replays every mutation since)
        self._init_roles = list(self.roles)
        self._init_expected = expected
        self._bind_host: str | None = None
        self._port = 0
        self._server: socketserver.ThreadingTCPServer | None = None
        self._thread: threading.Thread | None = None
        self.address: tuple[str, int] | None = None

    # -- lifecycle -----------------------------------------------------------

    def start(self, host: str | None = None) -> tuple[str, int]:
        """Bind and return the address nodes should dial.

        When an ``authkey`` is set, binds all interfaces by default so
        *remote* executors can register (reference parity:
        ``reservation.Server`` served the driver's routable address to every
        executor, ``reservation.py:~120-200``) — but **advertises** the
        routable ``local_ip()``, never the wildcard or loopback, because the
        returned address is baked into every ``NodeConfig.coordinator_addr``
        shipped to (possibly remote) nodes.  Without an authkey the default
        bind stays loopback: an unauthenticated register/stop channel must
        not be network-reachable.  Pass ``host`` (or set
        ``TOS_COORDINATOR_HOST``) to pin a specific interface; that exact
        address is then advertised.
        """
        # Chaos hooks (kill_coordinator / delay_net) arm from the driver's
        # own environment; idempotent when a test armed them explicitly.
        faultinject.init_from_env()
        if host is None:
            # Only an authenticated server may take a network bind from the
            # environment — TOS_COORDINATOR_HOST must never silently expose
            # an unauthenticated register/stop channel.
            from tensorflowonspark_torch.utils.envtune import env_str

            host = (env_str("TOS_COORDINATOR_HOST", "")
                    if self.authkey is not None else "127.0.0.1")
        bind_host = "" if host in ("", "0.0.0.0") else host
        self._bind_host = bind_host
        self._start_server(bind_host, 0)
        if bind_host == "":
            from tensorflowonspark_torch.utils.net import local_ip

            advertise = local_ip()
        else:
            advertise = bind_host
        self.address = (advertise, self._port)
        self._start_stats_thread()
        logger.info("coordinator listening on %s:%d (expecting %d nodes)", *self.address, self.expected)
        return self.address

    def _start_server(self, bind_host: str, port: int) -> None:
        """Bind + start the request server on ``(bind_host, port)`` (port 0
        = pick one; restore() passes the ORIGINAL port so recovering clients
        redial the address baked into every NodeConfig)."""
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:  # one connection, many requests
                from tensorflowonspark_torch.utils.net import set_nodelay

                # request/reply stream of small JSON frames: with Nagle on,
                # every barrier/reduce/heartbeat risks a ~40ms delayed-ACK
                # stall (the client side already dials with nodelay)
                set_nodelay(self.request)
                if outer.authkey is not None:
                    from tensorflowonspark_torch.utils.net import hmac_handshake_server

                    # Bounded handshake: an idle peer (port scanner, half-open
                    # connect) must not pin this handler thread + fd forever.
                    try:
                        self.request.settimeout(10.0)
                        if not hmac_handshake_server(self.request, outer.authkey):
                            logger.warning("rejected control-plane connection: bad authkey")
                            return
                        self.request.settimeout(None)
                    except (ConnectionError, OSError):
                        return
                with outer._lock:
                    outer._conns.add(self.request)
                try:
                    while True:
                        msg = _recv_msg(self.request)
                        resp = outer._dispatch(msg)
                        _send_msg(self.request, resp)
                        if msg.get("op") in ("stop", "bye"):
                            return
                except (ConnectionError, OSError):
                    return
                finally:
                    with outer._lock:
                        outer._conns.discard(self.request)

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((bind_host, port), Handler)
        self._port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="coordinator")
        self._thread.start()

    def _start_stats_thread(self) -> None:
        # driver stats sampler: the rolling-window half of cluster.stats()
        # for THIS process's registry (nodes sample themselves implicitly,
        # one history entry per heartbeat merge)
        self._stats_thread = threading.Thread(target=self._stats_loop,
                                              daemon=True,
                                              name="coordinator-stats")
        self._stats_thread.start()

    def stop(self) -> None:
        self._stop_flag.set()
        self._stats_stop.set()
        if self._stats_thread is not None:
            self._stats_thread.join(timeout=5.0)
            self._stats_thread = None
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._journal is not None:
            with contextlib.suppress(Exception):
                self._journal.close()

    # -- crash / journaled recovery (ISSUE 13) -------------------------------

    @property
    def epoch(self) -> int:
        """Coordinator epoch: bumped by every journaled recovery; carried on
        every control-plane reply so clients detect a failover (0 = the
        control plane has never crashed)."""
        return self._epoch

    @property
    def journal_enabled(self) -> bool:
        return self._journal_path is not None

    def live_journal(self):
        """The current Journal instance, or None while crashed / journal-
        less — the indirection ledger riders use so they never append to a
        pre-crash journal generation's closed fd."""
        if self._crashed.is_set():
            return None
        return self._journal

    def add_crash_listener(self, callback) -> None:
        """Register a zero-arg callable invoked (once, from the crashing
        thread) when the control plane crashes — the CoordinatorSupervisor's
        wake-up."""
        self._crash_listeners.append(callback)

    def crashed(self) -> bool:
        return self._crashed.is_set()

    def _log(self, rec_kind: str, sync: bool = True, **payload) -> None:
        """Append one journal record.  Caller MUST hold ``self._lock`` when
        journaling a state mutation (record order is replay order).
        ``sync=False`` is for the purely observational rendezvous-lifecycle
        records replay treats as no-ops: they skip the fsync (the next
        synced mutation or snapshot flushes them), so the per-generation
        hot path never pays a disk flush for flight evidence."""
        j = self._journal
        if j is None or self._crashed.is_set():
            return
        try:
            j.append(rec_kind, payload, sync=sync)
        except Exception:  # noqa: BLE001 - a full disk must not kill the control plane
            logger.warning("journal append (%s) failed", rec_kind,
                           exc_info=True)

    def _snapshot_state_locked(self) -> dict:
        """Full control-plane state, JSON-safe, for a journal snapshot."""
        return {
            "epoch": self._epoch,
            "expected": self.expected,
            "roles": [[name, task] for name, task in self.roles],
            "nodes": [dict(m) for m in self._nodes],
            "incarnations": {str(k): v for k, v in self._incarnations.items()},
            "draining": sorted(self._draining),
            "retired": sorted(self._retired),
            "manifest": dict(self._manifest),
            "errors": [dict(e) for e in self._errors],
            "serving": {k: list(v) for k, v in self._serving.items()},
            "rollouts": {k: dict(v) for k, v in self._rollouts.items()},
            # gray-failure state: who sits in probation (probation clocks
            # are monotonic and restart conservatively at restore) and who
            # is mid-relearn of a readmitted incarnation
            "evicted": {str(e): d["group"] for e, d in self._evicted.items()},
            "readmit_pending": {str(e): i
                                for e, i in self._readmit_pending.items()},
            "complete": self._complete.is_set(),
            # registered slots with no liveness clock (declared dead, or
            # cleanly deregistered): restore must NOT re-seed them, or a
            # finished node would later be re-declared dead and fail the job
            "untracked": sorted(int(m["executor_id"]) for m in self._nodes
                                if m["executor_id"] not in self._last_seen),
        }

    def _maybe_snapshot(self) -> None:
        """Periodic snapshot (stats-thread cadence): fold the journal tail
        into ``<journal>.snap`` once it grows past the threshold, holding
        ``_lock`` across build-and-write so the snapshot is consistent with
        every mutation record it truncates."""
        j = self._journal
        if j is None or self._crashed.is_set():
            return
        if j.appended_since_snapshot() < _JOURNAL_SNAPSHOT_EVERY:
            return
        try:
            with self._lock:
                j.snapshot(self._snapshot_state_locked())
        except Exception:  # noqa: BLE001 - snapshotting is an optimization, never fatal
            logger.warning("journal snapshot failed", exc_info=True)

    def crash(self) -> None:
        """Kill the control-plane server component abruptly (chaos /
        ``kill_coordinator``): sever every live connection, stop the server
        and sampler threads, abort in-flight rendezvous, and WIPE the
        in-memory control-plane state — everything a real coordinator
        process death would take with it.  The fsync'd journal on disk is
        the only survivor; :meth:`restore` rebuilds from it.  Telemetry /
        trace stores are process-local observability, kept so the run's
        postmortem spans the failover."""
        if self._crashed.is_set():
            return
        self._crashed.set()
        logger.error("coordinator control plane CRASHED (epoch %d); journal "
                     "at %s", self._epoch, self._journal_path)
        telemetry.counter("coordinator.crashes_total").inc()
        ttrace.event("coordinator_crash", epoch=self._epoch)
        if self._journal is not None:
            with contextlib.suppress(Exception):
                self._journal.close()
        # sever: listening socket + every accepted connection, abruptly
        server, self._server = self._server, None
        if server is not None:
            with contextlib.suppress(Exception):
                server.shutdown()
                server.server_close()
        with self._lock:
            conns, self._conns = list(self._conns), set()
        for conn in conns:
            with contextlib.suppress(OSError):
                conn.close()
        # waiters blocked inside _op_reduce would otherwise ride out their
        # full timeout against a server that no longer exists
        self._abort_rendezvous()
        self._stats_stop.set()
        if self._stats_thread is not None:
            self._stats_thread.join(timeout=5.0)
            self._stats_thread = None
        with self._lock:
            self._nodes = []
            self._last_seen = {}
            self._incarnations = {}
            self._draining = set()
            self._retired = set()
            self._errors = []
            self._manifest = {}
            self._serving = {}
            self._rollouts = {}
            self._rdv = {}
            self._suspicions = {}
            self._evict_pending = {}
            self._collective = {}
            self._evicted = {}
            self._readmit_pending = {}
            self._collective_events = []
        for cb in list(self._crash_listeners):
            try:
                cb()
            except Exception:  # noqa: BLE001 - a listener bug must not mask the crash
                logger.warning("coordinator crash listener failed",
                               exc_info=True)

    def restore(self) -> int:
        """Recover from :meth:`crash`: replay the journal (snapshot + tail)
        into this object, bump the coordinator epoch, rebind the ORIGINAL
        port, and seed every registered live slot's liveness clock so
        reconnecting nodes get the full death-declaration window to
        re-assert themselves.  Returns the new epoch."""
        if not self._crashed.is_set():
            raise RuntimeError("restore() is only valid after crash()")
        if self._journal_path is None:
            raise RuntimeError("cannot restore a journal-less coordinator")
        from tensorflowonspark_torch import journal as journal_mod

        snap, records = journal_mod.replay(self._journal_path)
        snap = snap or {}
        with self._lock:
            self.roles = [tuple(r) for r in snap.get("roles",
                                                     self._init_roles)]
            self.expected = int(snap.get("expected", self._init_expected))
            self._epoch = int(snap.get("epoch", self._epoch))
            self._nodes = [dict(m) for m in snap.get("nodes") or []]
            self._incarnations = {int(k): int(v) for k, v in
                                  (snap.get("incarnations") or {}).items()}
            self._draining = set(snap.get("draining") or [])
            self._retired = set(snap.get("retired") or [])
            self._manifest = dict(snap.get("manifest") or {})
            self._errors = [dict(e) for e in snap.get("errors") or []]
            self._serving = {k: [int(x) for x in v] for k, v in
                             (snap.get("serving") or {}).items()}
            self._rollouts = {k: dict(v) for k, v in
                              (snap.get("rollouts") or {}).items()}
            self._evicted = {}
            for e, group in (snap.get("evicted") or {}).items():
                self._restore_evicted_locked(int(e), str(group))
            self._readmit_pending = {
                int(e): int(i)
                for e, i in (snap.get("readmit_pending") or {}).items()}
            complete = bool(snap.get("complete", False))
            untracked = {int(x) for x in snap.get("untracked") or []}
            for rec in records:
                complete = self._apply_record_locked(rec, complete, untracked)
            # Re-emit eviction/readmission events for the restored state:
            # the crash wiped any not-yet-drained event (and the monitor
            # may have missed the originals entirely if the crash raced its
            # tick), so the cluster-side side effects — supervisor
            # park/unpark, ledger rebalance, train re-attach — are replayed
            # from scratch.  All of them are idempotent by construction.
            for eid, d in self._evicted.items():
                self._collective_events.append(
                    {"kind": "evicted", "eid": eid, "group": d["group"]})
            for eid in self._readmit_pending:
                if eid not in self._evicted:
                    self._collective_events.append(
                        {"kind": "readmitted", "eid": eid, "group": ""})
            self._epoch += 1
            epoch = self._epoch
            if complete or (self._nodes and len(self._nodes) >= self.expected):
                self._complete.set()
            # re-admit grace: every slot that was liveness-tracked at the
            # crash is treated as alive NOW — its node has the full
            # dead-node window to reconnect and re-assert itself.  Slots
            # already dead / deregistered / retired pre-crash stay
            # untracked: re-seeding a finished node would get it
            # re-declared dead later and fail a healthy run.
            now = time.monotonic()
            for m in self._nodes:
                eid = int(m["executor_id"])
                if eid not in self._retired and eid not in untracked:
                    self._last_seen[eid] = now
            live = len(self._last_seen)
        # fresh journal generation anchored by a snapshot of the restored
        # state (carries the bumped epoch; keeps the replay tail O(delta))
        self._journal = journal_mod.Journal(self._journal_path)
        with self._lock:
            self._journal.snapshot(self._snapshot_state_locked())
        self._start_server(self._bind_host or "", self._port)
        self._stats_stop.clear()
        self._start_stats_thread()
        self._crashed.clear()
        telemetry.counter("coordinator.recoveries_total").inc()
        telemetry.gauge("coordinator.epoch").set(epoch)
        telemetry.gauge("coordinator.live_slots").set(live)
        ttrace.event("coordinator_replay", epoch=epoch,
                     records=len(records), nodes=len(self._nodes))
        ttrace.event("coordinator_up", epoch=epoch)
        logger.warning("coordinator RECOVERED at epoch %d (%d slot(s) "
                       "replayed, %d tail record(s)); clients re-admit over "
                       "the next heartbeats", epoch, len(self._nodes),
                       len(records))
        return epoch

    def _apply_record_locked(self, rec: dict, complete: bool,
                             untracked: set[int]) -> bool:
        """Replay one journal tail record into live state (``untracked``
        accumulates slots that must NOT get a liveness clock re-seeded);
        returns the updated formation-complete flag.  Purely-observational
        kinds (rendezvous lifecycle, ledger riders) replay as no-ops."""
        kind, d = rec.get("k"), rec.get("d") or {}
        if kind == "register":
            meta = dict(d["meta"])
            eid = int(meta["executor_id"])
            untracked.discard(eid)
            self._evicted.pop(eid, None)
            slot = next((m for m in self._nodes
                         if m["executor_id"] == eid), None)
            if d.get("replace") and slot is not None:
                slot.clear()
                slot.update(meta)
            elif slot is None:
                self._nodes.append(meta)
            if len(self._nodes) >= self.expected:
                complete = True
        elif kind == "dead":
            for eid in d.get("eids") or []:
                untracked.add(int(eid))
                self._incarnations[int(eid)] = \
                    self._incarnations.get(int(eid), 0) + 1
                # death wins over any probation/relearn record before it
                # (mirrors mark_dead and the silent-probation reap)
                self._evicted.pop(int(eid), None)
                self._readmit_pending.pop(int(eid), None)
        elif kind == "deregister":
            untracked.add(int(d["eid"]))
        elif kind == "open_slots":
            self.roles.extend((name, int(task))
                              for name, task in d.get("roles") or [])
            self.expected += len(d.get("roles") or [])
        elif kind == "cancel_slots":
            for eid in d.get("cancelled") or []:
                if int(eid) == len(self.roles) - 1:
                    self.roles.pop()
                    self.expected -= 1
            for eid in d.get("retired") or []:
                self._retire_replay_locked(int(eid))
        elif kind == "draining":
            self._draining.update(int(e) for e in d.get("eids") or [])
        elif kind == "retired":
            self._retire_replay_locked(int(d["eid"]))
        elif kind == "manifest":
            self._manifest = dict(d.get("manifest") or {})
        elif kind == "error":
            self._errors.append({"executor_id": d.get("executor_id"),
                                 "traceback": d.get("traceback", "")})
        elif kind == "serving":
            self._serving[str(d.get("gateway"))] = \
                [int(x) for x in d.get("replicas") or []]
        elif kind == "rollout":
            self._rollouts[str(d.get("gateway"))] = dict(d.get("state") or {})
        elif kind == "evict":
            eid = int(d["eid"])
            untracked.add(eid)
            self._incarnations[eid] = self._incarnations.get(eid, 0) + 1
            self._restore_evicted_locked(eid, str(d.get("group") or "train"))
            self._readmit_pending.pop(eid, None)
        elif kind == "readmit":
            eid = int(d["eid"])
            untracked.discard(eid)
            self._evicted.pop(eid, None)
            self._readmit_pending[eid] = self._incarnations.get(eid, 0)
        # rdv_open / rdv_close / rdv_abort / form / ledger: flight-record
        # riders — the generations they describe died with the crash and
        # re-form client-side at the next generation barrier.  The epoch
        # itself persists exclusively through snapshots (restore() writes
        # one immediately after every bump), never through tail records.
        return complete

    def _restore_evicted_locked(self, executor_id: int, group: str) -> None:
        """The ONE probation-entry constructor (live eviction AND crash
        replay — the two must never diverge on shape or clock semantics):
        the window starts NOW relative to this process's monotonic clock.
        For a journal replay that is conservative — the original eviction's
        clock died with the crash, and a failover never shortens a
        straggler's bench time — and the readmission health probe works
        unchanged either way."""
        from tensorflowonspark_torch.utils.envtune import env_float

        probation = max(0.0, env_float("TOS_COLLECTIVE_PROBATION_SECS", 30.0))
        now = time.monotonic()
        self._evicted[executor_id] = {
            "group": group, "at": now, "last_ping": now,
            "probation_until": now + probation,
            "incarnation": self._incarnations.get(executor_id, 0)}

    def _retire_replay_locked(self, executor_id: int) -> None:
        self._incarnations[executor_id] = \
            self._incarnations.get(executor_id, 0) + 1
        self._draining.discard(executor_id)
        self._retired.add(executor_id)
        for m in self._nodes:
            if m["executor_id"] == executor_id:
                m["retired"] = True

    # -- serving replica registry (journal-backed) ----------------------------

    def note_serving_replicas(self, gateway: str, replicas: list[int]) -> None:
        """Record one router's healthy replica set (journaled, restored
        across a control-plane failover)."""
        with self._lock:
            self._serving[str(gateway)] = sorted(int(r) for r in replicas)
            self._log("serving", gateway=str(gateway),
                      replicas=self._serving[str(gateway)])

    def serving_replicas(self) -> dict[str, list[int]]:
        with self._lock:
            return {k: list(v) for k, v in self._serving.items()}

    def note_rollout(self, gateway: str, state: dict) -> None:
        """Record one gateway's staged-rollout state (journaled, restored
        across a control-plane failover): the full payload on start, then
        re-noted on every transition (promoted / rolled_back / aborted)."""
        with self._lock:
            self._rollouts[str(gateway)] = dict(state or {})
            self._log("rollout", gateway=str(gateway),
                      state=self._rollouts[str(gateway)])

    def rollout_state(self) -> dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._rollouts.items()}

    # -- gray-failure eviction (straggler suspicion -> quorum -> probation) ---

    @staticmethod
    def _resolve_blame_locked(reports: dict[int, dict[int, float]],
                              blamed: int) -> int | None:
        """Transitive blame resolution: a blamed member that is ITSELF
        filing suspicion against its own upstream is a pipeline victim
        (in a ring, everyone downstream of the straggler stalls in order),
        so the blame shifts upstream until it lands on a member that is
        blamed but not blaming.  A CYCLE — the walk revisiting a member —
        is the uniform-slowness signature (everyone waiting on everyone)
        and resolves to None: no clear straggler, nobody evicted.  The
        walk follows blame edges without excluding visited nodes (that
        exclusion would make every cycle terminate on an arbitrary member
        and falsely convict it; the revisit IS the terminator)."""
        seen: set[int] = set()
        cur = blamed
        while cur not in seen:
            seen.add(cur)
            upstream = [b for b, voters in reports.items() if cur in voters]
            if not upstream:
                return cur
            cur = min(upstream)  # deterministic walk on fan-out
        return None  # cycle: no clear straggler

    def _op_suspect(self, msg: dict) -> dict:
        """Record one survivor's suspicion vote and evaluate the quorum.

        Votes are keyed (group, suspect, voter) — refiling refreshes, never
        double-counts — cleared wholesale at each formation (a new
        generation is a fresh slate).  Zombie voters never reach here
        (standard incarnation fencing), so an evicted member cannot vote
        its survivors out in revenge."""
        from tensorflowonspark_torch.utils.envtune import env_int

        group = str(msg.get("group") or "train")
        suspect = int(msg["suspect"])
        voter = int(msg.get("executor_id", -1))
        wait = float(msg.get("wait_secs") or 0.0)
        now = time.monotonic()
        evicted_now: int | None = None
        with self._lock:
            info = self._collective.get(group)
            members = list(info["members"]) if info else []
            reports = self._suspicions.setdefault(group, {})
            if suspect != voter and voter >= 0:
                reports.setdefault(suspect, {})[voter] = now
            # vote freshness: a live straggler's accusers renew every
            # second; a cold-start hiccup's lone vote must not linger and
            # later combine with an unrelated incident into a bogus quorum
            cutoff = now - _SUSPECT_VOTE_TTL
            for blamed in list(reports):
                voters_at = reports[blamed]
                for v in [v for v, t in voters_at.items() if t < cutoff]:
                    del voters_at[v]
                if not voters_at:
                    del reports[blamed]
            # resolve every report's transitive blame, then tally distinct
            # voters per FINAL suspect (a transferred vote still counts —
            # in a ring only the straggler's direct neighbor observes it
            # first-hand, so quorum must credit downstream victims too)
            tally: dict[int, set[int]] = {}
            for blamed, voters in reports.items():
                final = self._resolve_blame_locked(reports, blamed)
                if final is None:
                    continue
                tally.setdefault(final, set()).update(voters)
            survivors = max(1, len(members) - 1)
            quorum = env_int("TOS_COLLECTIVE_EVICT_QUORUM", 0) \
                or (survivors // 2 + 1)
            min_world = max(1, env_int("TOS_COLLECTIVE_MIN_WORLD", 1))
            votes = 0
            confirmed: set[tuple[str, int]] = set()
            for target in sorted(tally):
                voters = {v for v in tally[target] if v != target}
                if not (target in members and target not in self._evicted
                        and len(voters) >= quorum
                        and len(members) - 1 >= min_world):
                    continue
                key = (group, target)
                confirmed.add(key)
                pending_since = self._evict_pending.setdefault(key, now)
                if now - pending_since < _EVICT_CONFIRM_SECS:
                    # hold: a partial blame cycle (uniform slowness, votes
                    # still in flight) must get the chance to dissolve
                    continue
                del self._evict_pending[key]
                self._evict_locked(target, group, wait)
                evicted_now = target
                votes = len(voters)
                break
            # any hold whose quorum evaporated (the cycle completed, votes
            # aged out, membership changed) is dropped, not left armed
            for key in [k for k in self._evict_pending
                        if k[0] == group and k not in confirmed]:
                del self._evict_pending[key]
            evicted = sorted(e for e, d in self._evicted.items()
                             if d["group"] == group)
        if evicted_now is not None:
            telemetry.counter("collective.evictions_total").inc()
            telemetry.gauge("coordinator.live_slots").set(
                len(self._last_seen))
            ttrace.event("evicted", executor=evicted_now, group=group,
                         votes=votes, wait_secs=round(wait, 2))
            logger.error(
                "executor %d EVICTED from collective group %r at quorum "
                "(%d survivor vote(s); gray failure — slow or wedged, not "
                "dead); parked in probation, group continues at world %d",
                evicted_now, group, votes, len(members) - 1)
            # survivors may be blocked in a formation sized for the full
            # world — abort so they re-enter at the degraded count
            self._abort_rendezvous()
        return {"ok": True, "evicted": evicted, "quorum": quorum}

    def _evict_locked(self, executor_id: int, group: str,
                      wait_secs: float) -> None:
        """State half of a quorum eviction (caller holds ``_lock``): fence
        the incarnation, stop liveness tracking (the monitor must not ALSO
        declare a death — the process is alive, just benched), start the
        probation clock, and shrink the group's live membership."""
        self._last_seen.pop(executor_id, None)
        self._incarnations[executor_id] = \
            self._incarnations.get(executor_id, 0) + 1
        self._stats_history.pop(str(executor_id), None)
        self._readmit_pending.pop(executor_id, None)
        self._restore_evicted_locked(executor_id, group)
        info = self._collective.get(group)
        if info and executor_id in info["members"]:
            info["members"].remove(executor_id)
        sus = self._suspicions.get(group)
        if sus:
            sus.pop(executor_id, None)
            for voters in sus.values():
                voters.pop(executor_id, None)
        self._collective_events.append(
            {"kind": "evicted", "eid": executor_id, "group": group})
        self._eviction_log.append(
            {"eid": executor_id, "group": group,
             "wait_secs": round(wait_secs, 2)})
        self._log("evict", eid=executor_id, group=group)

    def _maybe_readmit_locked(self, executor_id: int) -> int | None:
        """Probation check on a fenced heartbeat from an evicted process:
        once the probation window expired — and the heartbeat arriving IS
        the health probe: the process is alive and can reach us — readmit
        the slot.  Returns the incarnation the process must adopt, or None
        while probation holds."""
        ent = self._evicted.get(executor_id)
        if ent is None:
            return None
        now = time.monotonic()
        ent["last_ping"] = now
        if now < ent["probation_until"]:
            return None
        del self._evicted[executor_id]
        inc = self._incarnations.get(executor_id, 0)
        # every stale client of the readmitted process relearns the bumped
        # incarnation on its next served round-trip (see _dispatch_inner)
        self._readmit_pending[executor_id] = inc
        self._last_seen[executor_id] = now
        self._readmits_total += 1
        self._collective_events.append(
            {"kind": "readmitted", "eid": executor_id,
             "group": ent["group"]})
        self._log("readmit", eid=executor_id)
        return inc

    def reap_silent_probation(self, heartbeat_timeout: float) -> list[int]:
        """Probation entries whose process went HEARTBEAT-SILENT: an
        evicted member is untracked by normal liveness (eviction popped its
        clock so the monitor never double-declares), so if it genuinely
        dies while benched nothing else would ever notice — the world would
        stay degraded forever with a ghost probation entry.  Called from
        the cluster monitor's tick: silent entries convert into ordinary
        deaths (fenced again, probation record dropped, journaled) and are
        returned for the caller to hand to the supervisor — which unparks
        and respawns, exactly as if the death had never hidden behind the
        eviction."""
        newly: list[int] = []
        now = time.monotonic()
        with self._lock:
            for eid in [e for e, d in self._evicted.items()
                        if now - d["last_ping"] > heartbeat_timeout]:
                del self._evicted[eid]
                self._incarnations[eid] = self._incarnations.get(eid, 0) + 1
                self._readmit_pending.pop(eid, None)
                self._collective_events.append(
                    {"kind": "probation_death", "eid": eid})
                self._log("dead", eids=[eid])
                newly.append(eid)
        for eid in newly:
            telemetry.counter("coordinator.deaths_total").inc()
            ttrace.event("death", executor=eid)
            logger.error("evicted node %d went silent in probation "
                         "(>%.0fs without a heartbeat); its bench death is "
                         "now an ordinary death", eid, heartbeat_timeout)
        return newly

    def evicted_members(self) -> dict[int, dict]:
        """Slots currently evicted to probation (diagnostic + tests)."""
        with self._lock:
            return {e: dict(d) for e, d in self._evicted.items()}

    def evictions(self) -> list[dict]:
        """Run-lifetime eviction log (survives readmission)."""
        with self._lock:
            return [dict(x) for x in self._eviction_log]

    def drain_collective_events(self) -> list[dict]:
        """One-shot drain of eviction/readmission events — the cluster
        monitor's feed for parking/unparking the supervisor and
        rebalancing the evicted slot's ledger work."""
        with self._lock:
            events, self._collective_events = self._collective_events, []
        return events

    # -- driver-side queries -------------------------------------------------

    def await_registrations(self, timeout: float | None = None) -> list[dict]:
        """Block until all nodes registered (``Server.await_reservations``)."""
        if not self._complete.wait(timeout):
            with self._lock:
                n = len(self._nodes)
            raise TimeoutError(f"only {n}/{self.expected} nodes registered within {timeout}s")
        return self.cluster_info()

    def cluster_info(self) -> list[dict]:
        with self._lock:
            return [dict(m) for m in sorted(self._nodes, key=lambda m: m["executor_id"])]

    def node_meta(self, executor_id: int) -> dict | None:
        """Current meta of one slot (a replacement rewrites it wholesale) —
        the single lookup the supervisor and the driver's data-plane recovery
        both use, so they can never disagree on a slot's host/port."""
        with self._lock:
            meta = next((m for m in self._nodes
                         if m["executor_id"] == executor_id), None)
            return dict(meta) if meta is not None else None

    def errors(self) -> list[dict]:
        with self._lock:
            return list(self._errors)

    def dead_nodes(self, heartbeat_timeout: float) -> list[int]:
        """Nodes whose heartbeat went silent (deregistered nodes excluded).
        Empty while the control plane is mid-failover: liveness was wiped
        with the crash, and declaring anyone dead before recovery re-seeds
        the clocks would fence every healthy reconnecting node."""
        if self._crashed.is_set():
            return []
        now = time.monotonic()
        with self._lock:
            return [i for i, t in self._last_seen.items() if now - t > heartbeat_timeout]

    def forget(self, executor_ids: list[int]) -> None:
        """Stop liveness-tracking nodes WITHOUT recording an error (used for
        non-fatal sidecar deaths, e.g. the evaluator)."""
        with self._lock:
            for i in executor_ids:
                self._last_seen.pop(i, None)

    def mark_dead(self, executor_ids: list[int],
                  record_error: bool = True) -> list[int]:
        """Declare heartbeat-silent nodes dead: stop tracking them, FENCE
        their incarnation (everything the old process sends from now on is
        rejected), and abort any in-flight barrier/reduce generation — the
        dead peer will never arrive, so waiters would only ride out their
        full timeout.  Idempotent: only nodes still being tracked are
        processed, so the monitor thread and shutdown's death-aware join
        racing on the same death act exactly once; the newly-declared ids
        are returned for the caller to escalate (or hand to the supervisor).

        ``record_error=False`` is the elastic path: a death the supervisor
        will recover from must not leave a fatal node error behind."""
        newly: list[int] = []
        with self._lock:
            for i in executor_ids:
                if self._last_seen.pop(i, None) is None:
                    continue
                newly.append(i)
                self._incarnations[i] = self._incarnations.get(i, 0) + 1
                # a readmitted-then-dead slot forfeits its relearn window
                # (and any straggler probation record): death wins
                self._readmit_pending.pop(i, None)
                self._evicted.pop(i, None)
                # a restarted slot's counters restart at 0: its rolling-stats
                # stream must restart with them, or the first post-restart
                # window computes negative rates against the old cumulatives
                self._stats_history.pop(str(i), None)
                if record_error:
                    self._errors.append({
                        "executor_id": i,
                        "traceback": (f"node {i} stopped heartbeating (process died "
                                      "or host unreachable); detected by driver "
                                      "monitor (SURVEY.md §5.3)"),
                    })
                    self._log("error", **self._errors[-1])
            if newly:
                self._log("dead", eids=newly)
            live = len(self._last_seen)
        if newly:
            telemetry.counter("coordinator.deaths_total").inc(len(newly))
            telemetry.gauge("coordinator.live_slots").set(live)
            for eid in newly:
                ttrace.event("death", executor=eid)
            self._abort_rendezvous()
        return newly

    def set_manifest(self, manifest: dict) -> None:
        """Publish the DIRECT-mode shard manifest (driver-side; replaced
        wholesale per train() call — JSON-serializable values only, the
        control plane is JSON-framed)."""
        with self._lock:
            self._manifest = dict(manifest)
            self._log("manifest", manifest=self._manifest)

    def manifest_state(self) -> dict:
        """Driver-side view of the published job manifest (the ``manifest``
        op's payload)."""
        with self._lock:
            return dict(self._manifest)

    def record_failure(self, executor_id: int, reason: str) -> None:
        """Driver-side synthesized node error (e.g. supervised restart budget
        exhausted) — surfaces through the same channel map_fun errors use."""
        with self._lock:
            self._errors.append({"executor_id": executor_id, "traceback": reason})
            self._log("error", executor_id=executor_id, traceback=reason)

    def is_tracked(self, executor_id: int) -> bool:
        """Whether the executor is currently liveness-tracked (alive)."""
        with self._lock:
            return executor_id in self._last_seen

    def registered_incarnation(self, executor_id: int) -> tuple[int, bool]:
        """(current incarnation, is currently liveness-tracked)."""
        with self._lock:
            return (self._incarnations.get(executor_id, 0),
                    executor_id in self._last_seen)

    def role_of(self, executor_id: int) -> str | None:
        """The slot's assigned role name ('chief'/'worker'/'evaluator'/
        'ingest'/...), or None for an unknown id — the role-aware half of
        the slot registry (executor ids index the role table by
        construction: ids are assigned in registration order)."""
        with self._lock:
            if 0 <= executor_id < len(self.roles):
                return self.roles[executor_id][0]
            return None

    def role_ids(self, job_name: str) -> list[int]:
        """Executor ids whose slot carries the named role."""
        with self._lock:
            return [i for i, (name, _t) in enumerate(self.roles)
                    if name == job_name]

    # -- elastic membership (cluster.resize) ---------------------------------

    def open_slots(self, count: int, job_name: str = "worker") -> list[int]:
        """Admit ``count`` NEW executor slots mid-run (scale-out): extend the
        role template and raise ``expected`` so the next ``count``
        registrations are assigned the fresh ids.  Returns the executor ids
        the newcomers will receive (registration order).  The initial
        formation barrier (``await_registrations``) is unaffected — it
        completed long ago; latecomers join a cluster that is already live.
        """
        if count < 1:
            raise ValueError("open_slots needs count >= 1")
        with self._lock:
            if not self._complete.is_set():
                raise RuntimeError("cannot open slots before the cluster formed")
            next_task = 1 + max(
                (t for name, t in self.roles if name == job_name), default=-1)
            new_ids = list(range(len(self.roles), len(self.roles) + count))
            new_roles = [(job_name, next_task + i) for i in range(count)]
            self.roles.extend(new_roles)
            self.expected += count
            self._log("open_slots", ids=new_ids,
                      roles=[[n, t] for n, t in new_roles])
        logger.info("opened %d new executor slot(s): ids %s", count, new_ids)
        return new_ids

    def await_slots(self, executor_ids: list[int], timeout: float) -> None:
        """Block until every listed slot has registered (scale-out join)."""
        deadline = time.monotonic() + timeout
        pending = set(executor_ids)
        while True:
            with self._lock:
                have = {m["executor_id"] for m in self._nodes}
            pending -= have
            if not pending:
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"new node slot(s) {sorted(pending)} did not register "
                    f"within {timeout}s")
            time.sleep(0.1)

    def cancel_slots(self, executor_ids: list[int]) -> None:
        """Roll back :meth:`open_slots` for slots that never registered (a
        scale-out that timed out): pop the unfilled tail roles and lower
        ``expected`` so the NEXT scale-out's promised ids line up with
        registration order again.  ``_op_register`` assigns
        ``executor_id = len(_nodes)`` while ``open_slots`` promises ids from
        ``len(roles)`` — without this rollback one failed scale-out leaves
        them desynchronized forever (every later ``await_slots`` waits on
        ids no registration can ever be assigned).  Slots that DID register
        before the timeout are RETIRED in the same lock hold — doing the
        registered-check driver-side would race a register RPC landing in
        between, leaving a ghost that every default-count barrier/reduce
        waits on forever."""
        retired: list[int] = []
        with self._lock:
            taken = {m["executor_id"] for m in self._nodes}
            cancelled: list[int] = []
            # ids are assigned in registration order, so the unregistered
            # promised slots are always the tail of the role table
            for eid in sorted(executor_ids, reverse=True):
                if eid in taken:
                    live = self._retire_locked(eid)
                    retired.append(eid)
                    continue
                if eid == len(self.roles) - 1:
                    self.roles.pop()
                    self.expected -= 1
                    cancelled.append(eid)
            if cancelled or retired:
                self._log("cancel_slots", cancelled=cancelled, retired=retired)
        if retired:
            telemetry.gauge("coordinator.live_slots").set(live)
        for eid in retired:
            ttrace.event("retired", executor=eid)
            logger.info("executor %d retired (failed scale-out reaped it)",
                        eid)

    def mark_draining(self, executor_ids: list[int]) -> None:
        """Flag slots as DRAINING (scale-in in progress): still alive and
        serving their in-flight work, but no new assignments — and a death
        mid-drain finalizes the retirement instead of scheduling recovery."""
        with self._lock:
            self._draining.update(executor_ids)
            self._log("draining", eids=list(executor_ids))

    def draining_nodes(self) -> list[int]:
        with self._lock:
            return sorted(self._draining)

    def is_draining(self, executor_id: int) -> bool:
        with self._lock:
            return executor_id in self._draining

    def _retire_locked(self, executor_id: int) -> int:
        """State half of :meth:`retire_node` (caller holds ``_lock``);
        returns the live-slot count for the gauge."""
        self._last_seen.pop(executor_id, None)
        self._incarnations[executor_id] = \
            self._incarnations.get(executor_id, 0) + 1
        self._draining.discard(executor_id)
        self._retired.add(executor_id)
        self._readmit_pending.pop(executor_id, None)
        self._evicted.pop(executor_id, None)
        self._stats_history.pop(str(executor_id), None)
        for m in self._nodes:
            if m["executor_id"] == executor_id:
                m["retired"] = True
        return len(self._last_seen)

    def retire_node(self, executor_id: int) -> None:
        """Finalize an INTENTIONAL retirement (scale-in): stop liveness
        tracking with no error recorded, fence the incarnation so any
        straggler process is rejected, flag the slot meta ``retired`` (the
        executor_id is never reused), and drop the slot's rolling-stats
        stream so dashboards stop averaging a ghost."""
        with self._lock:
            live = self._retire_locked(executor_id)
            self._log("retired", eid=executor_id)
        telemetry.gauge("coordinator.live_slots").set(live)
        ttrace.event("retired", executor=executor_id)
        logger.info("executor %d retired (intentional scale-in)", executor_id)

    def is_retired(self, executor_id: int) -> bool:
        with self._lock:
            return executor_id in self._retired

    # -- telemetry (cluster metrics transport) -------------------------------

    def _merge_metrics_locked(self, executor_id: int, payload: dict) -> None:
        """Fold one node's heartbeat delta into its stored snapshot.  Every
        value in the payload is absolute-cumulative, so the merge is plain
        replacement per key; histogram ``recent`` samples append to a
        bounded per-(node, metric) pool for cluster-wide percentiles."""
        store = self._node_metrics.setdefault(
            executor_id, {"counters": {}, "gauges": {}, "histograms": {}})
        store["counters"].update(payload.get("counters") or {})
        store["gauges"].update(payload.get("gauges") or {})
        window_samples: dict[str, list[float]] = {}
        for name, d in (payload.get("histograms") or {}).items():
            store["histograms"][name] = {
                k: d.get(k) for k in ("count", "sum", "min", "max")}
            recent = d.get("recent")
            if recent:
                pool = self._hist_recent.setdefault(
                    executor_id, {}).setdefault(name, [])
                pool.extend(float(v) for v in recent)
                del pool[:-_HIST_RECENT_CAP]
                window_samples[name] = [float(v) for v in recent]
        # rolling-stats history: the heartbeat cadence IS the node's sample
        # clock — one timestamped cumulative snapshot per merge
        self._append_stats_locked(str(executor_id),
                                  dict(store["counters"]),
                                  dict(store["gauges"]), window_samples)

    # -- trace streams (span/flight-event transport) --------------------------

    def _merge_trace_locked(self, key: str, payload: dict) -> None:
        """Fold one process's heartbeat trace delta (spans + flight events +
        clock offset) into its bounded stream store."""
        store = self._node_trace.setdefault(
            key, {"spans": [], "events": [], "offset": None, "rtt": None,
                  "dropped": 0})
        spans = payload.get("spans")
        if spans:
            store["spans"].extend(spans)
            del store["spans"][:-_TRACE_SPAN_CAP]
        events = payload.get("events")
        if events:
            store["events"].extend(events)
            del store["events"][:-_TRACE_EVENT_CAP]
        if payload.get("offset") is not None:
            store["offset"] = float(payload["offset"])
            store["rtt"] = payload.get("rtt")
        if payload.get("dropped"):
            store["dropped"] = int(payload["dropped"])

    def _drain_driver_trace(self) -> None:
        """Accumulate this process's own tracer into the store under
        ``"driver"`` (the driver sends no heartbeats; offset is 0 by
        definition — its clock IS the merge timeline)."""
        delta = ttrace.collect_final()  # uncapped: no next beat ships the rest
        if delta is not None:
            delta["offset"] = 0.0
            with self._lock:
                self._merge_trace_locked("driver", delta)

    def clear_trace_streams(self) -> None:
        """Drop every accumulated trace stream (driver included) — phase
        isolation for benches that run several differently-shaped loads on
        one cluster and must not pool spans across them."""
        ttrace.collect_final()  # discard the driver tracer's whole backlog
        with self._lock:
            self._node_trace.clear()

    def trace_streams(self) -> dict[str, dict]:
        """Every process's trace stream, export-ready: ``{key: {"spans",
        "events", "clock_offset", ...}}`` (``trace_export.build_stream``
        shape).  Driver spans are drained into the store first."""
        self._drain_driver_trace()
        with self._lock:
            out: dict[str, dict] = {}
            for key, store in self._node_trace.items():
                out[key] = {"schema": "tos-trace-stream-v1", "node": key,
                            "clock_offset": store["offset"],
                            "spans": list(store["spans"]),
                            "events": list(store["events"]),
                            "dropped": store["dropped"]}
            return out

    # -- rolling-window stats (cluster.stats / the `statz` op) ----------------

    def _append_stats_locked(self, key: str, counters: dict, gauges: dict,
                             samples: dict[str, list[float]]) -> None:
        hist = self._stats_history.setdefault(key, [])
        hist.append((time.monotonic(), counters, gauges, samples))
        del hist[:-_STATS_HISTORY_CAP]

    def _stats_loop(self) -> None:
        while not self._stats_stop.wait(self._stats_interval):
            try:
                self._sample_driver_stats()
            except Exception:  # noqa: BLE001 - observability must not kill jobs
                logger.debug("driver stats sample failed", exc_info=True)
            # journal housekeeping rides the same tick: fold the tail into a
            # snapshot once it grows past the threshold (keeps recovery
            # replay O(delta) without adding a thread)
            self._maybe_snapshot()

    def _sample_driver_stats(self) -> None:
        """One driver history entry: cumulative counters + gauges + the
        histogram samples observed since the last tick (outbox drain — the
        driver's outboxes have no heartbeat consumer, so this is their one
        reader)."""
        if not telemetry.enabled():
            return
        reg = telemetry.get_registry()
        snap = reg.snapshot()
        samples = reg.drain_recent()
        with self._lock:
            self._append_stats_locked("driver", snap.get("counters") or {},
                                      snap.get("gauges") or {}, samples)

    def cluster_stats(self, window: float = 10.0) -> dict:
        """Rolling-window live stats — the signals replica autoscaling will
        consume, NOT run-lifetime aggregates: per-key windowed counter
        rates (qps and friends), windowed histogram percentiles (p50/p99
        over the last ``window`` seconds' samples only), and latest gauges
        (serve-queue depth, feed-queue occupancy).  ``"driver"`` carries
        the gateway-side view; node keys carry each node's own."""
        self._sample_driver_stats()  # stats() must be current, not ticked
        window = max(0.1, float(window))
        now = time.monotonic()
        with self._lock:
            history = {k: list(v) for k, v in self._stats_history.items()}
        out: dict = {"schema": "tos-statz-v1", "window_secs": window,
                     "streams": {}}
        for key, entries in history.items():
            stream = _window_stats(entries, now, window)
            if stream is not None:
                out["streams"][key] = stream
        driver = out["streams"].get("driver") or {}
        # headline: the exact autoscaler inputs, pre-plucked
        out["serving"] = {
            "qps": (driver.get("rates") or {}).get("serve.requests_total"),
            "p50_ms": _pct_ms(driver, "serve.request_secs", "p50"),
            "p99_ms": _pct_ms(driver, "serve.request_secs", "p99"),
            "queue_depth": (driver.get("gauges") or {}).get(
                "serve.queue_depth"),
            "inflight_batches": (driver.get("gauges") or {}).get(
                "serve.inflight_batches"),
            "replicas_healthy": (driver.get("gauges") or {}).get(
                "serve.replicas_healthy"),
            # "shrinking on purpose" vs "losing replicas": draining replicas
            # are a deliberate scale-in in progress, not a failure signal
            "replicas_draining": (driver.get("gauges") or {}).get(
                "serve.replicas_draining"),
            "draining_nodes": self.draining_nodes(),
            # the journal-backed registry: which replicas each router had
            # healthy as of its last publish (survives a coordinator
            # failover — the epoch shows whether one happened)
            "replica_registry": self.serving_replicas(),
            # staged rollouts: what each gateway has in flight (or last
            # resolved) — same journal-backed failover story
            "rollouts": self.rollout_state(),
            "coordinator_epoch": self._epoch,
            "feed_queue_depth": {
                key: (s.get("gauges") or {}).get("feed.queue_depth")
                for key, s in out["streams"].items() if key != "driver"},
        }
        ingest_ids = self.role_ids("ingest")
        if ingest_ids:
            out["ingest"] = self._ingest_stats_block(out["streams"],
                                                     ingest_ids)
        with self._lock:
            if self._collective or self._evicted or self._eviction_log:
                # the gray-failure block: which formations stand, who sits
                # in probation (and for how much longer), live suspicion
                # votes, and the run-lifetime eviction/readmit tallies —
                # the evidence operators read when a sync run degrades
                out["collective"] = {
                    "groups": {g: {"members": list(i["members"]),
                                   "generation": i["generation"]}
                               for g, i in self._collective.items()},
                    "evicted": {str(e): {
                        "group": d["group"],
                        "probation_secs_left": round(max(
                            0.0, d["probation_until"] - now), 1)}
                        for e, d in self._evicted.items()},
                    "suspicion_votes": {
                        g: {str(s): sorted(v) for s, v in sus.items()}
                        for g, sus in self._suspicions.items() if sus},
                    "evictions_total": len(self._eviction_log),
                    "readmits_total": self._readmits_total,
                }
        return out

    def _ingest_stats_block(self, streams: dict, ingest_ids: list[int]) -> dict:
        """The data-service tier's headline stats: per-worker decode MB/s
        and cache hit rate, plus the starved-trainer gauge — ONE surface
        the ingest autoscale policy and operators both read (satellite of
        the disaggregated-ingest tier)."""
        workers: dict[str, dict] = {}
        hits = misses = 0.0
        for eid in ingest_ids:
            s = streams.get(str(eid))
            if s is None:
                continue
            rates = s.get("rates") or {}
            gauges = s.get("gauges") or {}
            h = rates.get("ingest.cache_hits") or 0.0
            m = rates.get("ingest.cache_misses") or 0.0
            hits += h
            misses += m
            workers[str(eid)] = {
                "decode_mb_per_s": round(
                    (rates.get("ingest.bytes_read") or 0.0) / 1e6, 3),
                "rows_per_s": rates.get("ingest.records_read"),
                "forwarded_rows_per_s": rates.get("ingest.rows_forwarded"),
                "cache_hit_rate": (round(h / (h + m), 4)
                                   if (h + m) > 0 else None),
                "cache_bytes": gauges.get("ingest.cache_bytes"),
            }
        ingest_set = set(ingest_ids)
        trainer_keys = [key for key in streams
                        if key != "driver" and key.isdigit()
                        and int(key) not in ingest_set
                        and self.role_of(int(key)) != "evaluator"]
        starved = sum(
            1 for key in trainer_keys
            if ((streams[key].get("gauges") or {}).get("feed.queue_depth")
                == 0))
        return {
            "workers": workers,
            "cache_hit_rate": (round(hits / (hits + misses), 4)
                               if (hits + misses) > 0 else None),
            # trainers whose prefetch queue gauge reads EMPTY right now —
            # the tier-is-undersized signal the autoscale policy scales on
            "starved_trainers": starved,
            # windowed rate of empty feed polls across the trainer fleet
            # (feed.starved_polls — the counter form of the same signal)
            "trainer_starved_polls_per_s": round(sum(
                (streams[key].get("rates") or {}).get("feed.starved_polls")
                or 0.0 for key in trainer_keys), 3),
            "trainers_reporting": len(trainer_keys),
            "draining_workers": sorted(
                eid for eid in self.draining_nodes() if eid in ingest_set),
        }

    def cluster_metrics(self) -> dict:
        """Aggregated cluster snapshot (the ``metrics`` op / the
        ``cluster.metrics()`` driver API): per-node registry snapshots as
        last reported over heartbeats, plus THIS process's registry under
        ``"driver"`` (the coordinator runs in the driver, whose registry
        holds the feed-pump, supervisor, and rendezvous-span metrics)."""
        with self._lock:
            nodes: dict[str, dict] = {}
            for eid, snap in self._node_metrics.items():
                hists = {}
                for name, d in snap["histograms"].items():
                    d = dict(d)
                    recent = self._hist_recent.get(eid, {}).get(name)
                    if recent:
                        d["recent"] = list(recent)
                    hists[name] = d
                nodes[str(eid)] = {"counters": dict(snap["counters"]),
                                   "gauges": dict(snap["gauges"]),
                                   "histograms": hists}
        driver = telemetry.snapshot(include_samples=True)
        if any(driver.values()):
            nodes["driver"] = driver
        return telemetry.aggregate_snapshots(nodes)

    def _abort_rendezvous(self) -> None:
        """Abort every in-flight barrier/reduce generation (peer death)."""
        with self._lock:
            rdvs = list(self._rdv.values())
            self._rdv.clear()
        for rdv in rdvs:
            with rdv.cond:
                if not rdv.done:
                    rdv.aborted = True
                    rdv.cond.notify_all()

    def signal_stop(self) -> None:
        """Make subsequent heartbeats tell nodes to stop (zombie-free teardown)."""
        self._stop_flag.set()

    # -- request dispatch ----------------------------------------------------

    def _is_fenced(self, msg: dict) -> bool:
        """True when the message comes from a stale incarnation of a slot
        that was declared dead (the sender is a zombie predecessor of a
        restarted node).  Messages that carry no incarnation pass — only a
        peer that knows the fencing protocol can be fenced by it, and a
        slot that never died has incarnation 0 which every fresh client
        stamps anyway."""
        eid, inc = msg.get("executor_id"), msg.get("incarnation")
        if eid is None or inc is None:
            return False
        with self._lock:
            return int(inc) < self._incarnations.get(int(eid), 0)

    def _dispatch(self, msg: dict) -> dict:
        # chaos seam (`kill_coordinator:after_ops=N`): the Nth control-plane
        # request crashes the server BEFORE being served — its reply dies
        # with the connection, exactly like a request in flight at a real
        # coordinator death
        if faultinject.coordinator_op():
            self.crash()
            return {"ok": False, "error": "coordinator crashed (fault injection)"}
        if self._crashed.is_set():
            # a request raced the crash on a not-yet-severed socket: refuse
            # it rather than serving wiped state; the client's reconnect
            # backoff owns riding out the restart window
            return {"ok": False, "error": "coordinator is mid-failover; retry"}
        resp = self._dispatch_inner(msg)
        # coordinator epoch rides EVERY reply: clients detect a failover by
        # the bump and re-assert (idempotent ops retry; rendezvous re-form)
        resp.setdefault("epoch", self._epoch)
        return resp

    def _readmit_relearn(self, msg: dict) -> int | None:
        """The post-eviction identity hand-back: once a parked process is
        READMITTED, its slot's incarnation was bumped past every client the
        process already holds (main, heartbeat, consensus, collective) —
        and there is no replacement process to race, because eviction parks
        instead of respawning.  So a stale-incarnation message from a
        readmit-pending slot is served NORMALLY and its reply carries
        ``readmit_incarnation``: every client self-heals on its next
        round-trip.  Returns the incarnation to advertise, or None (no
        relearn in progress / the sender already caught up)."""
        eid, inc = msg.get("executor_id"), msg.get("incarnation")
        if eid is None or inc is None:
            return None
        with self._lock:
            pend = self._readmit_pending.get(int(eid))
            if pend is None or int(inc) != pend - 1:
                # No relearn in progress, this client already caught up, or
                # the sender is an OLDER incarnation than the one evicted —
                # i.e. a pre-eviction zombie from an ordinary death/respawn
                # cycle, which must stay fenced (only the readmitted
                # process's clients hold exactly pend-1).  The window stays
                # OPEN for those clients (main/consensus/collective relearn
                # at their own pace) and closes only when the slot dies,
                # retires, or re-evicts — safe, because eviction never
                # respawns: the readmitted process is the slot's only owner.
                return None
            return pend

    def _fenced_reply(self, op: str, msg: dict) -> dict:
        """Replies for a fenced (stale-incarnation) sender.

        Two populations land here: a dead slot's zombie predecessor
        (classic fencing — heartbeats answer stop so it winds down) and an
        EVICTED-but-alive gray member parked in probation.  The evicted
        process must NOT stop: its heartbeats are the probation health
        probe, and the first one past the probation window readmits the
        slot (handing back a fresh incarnation for every stale client to
        adopt)."""
        eid = int(msg.get("executor_id", -1))
        sender_inc = int(msg.get("incarnation", -1))
        with self._lock:
            ent = self._evicted.get(eid)
            # The probation probe is ONLY the evicted process itself: its
            # clients hold exactly the pre-eviction incarnation.  An even
            # older zombie (a predecessor from an ordinary death/respawn
            # before the eviction) must neither refresh the probe clock —
            # it would mask a real probation death from the reaper — nor,
            # at expiry, be handed the slot: it gets the classic fenced
            # stop reply below.
            if ent is not None and sender_inc != ent["incarnation"] - 1:
                ent = None
            if ent is not None and op == "heartbeat":
                inc = self._maybe_readmit_locked(eid)
                if inc is not None:
                    readmitted = True
                else:
                    readmitted = False
                    remaining = max(
                        0.0, ent["probation_until"] - time.monotonic())
                # the benched process is the slot's legitimate owner: its
                # telemetry/trace riders merge as usual — the probation
                # window is exactly the stretch a postmortem needs (the
                # classic fenced-ZOMBIE drop below stays a drop)
                if msg.get("metrics"):
                    self._merge_metrics_locked(eid, msg["metrics"])
                if msg.get("trace"):
                    self._merge_trace_locked(str(eid), msg["trace"])
            evicted = ent is not None
        if evicted and op == "heartbeat":
            if readmitted:
                telemetry.counter("collective.readmits_total").inc()
                ttrace.event("readmitted", executor=eid)
                logger.warning(
                    "executor %d passed its probation health probe; "
                    "READMITTED at incarnation %d — the group grows back "
                    "at its next generation barrier", eid, inc)
                return {"ok": True, "stop": self._stop_flag.is_set(),
                        "evicted": False, "readmit_incarnation": inc,
                        "now": time.monotonic()}
            return {"ok": True, "stop": self._stop_flag.is_set(),
                    "evicted": True,
                    "probation_secs": round(remaining, 3),
                    "now": time.monotonic()}
        if op == "heartbeat":
            return {"ok": True, "stop": True, "fenced": True}
        if op in ("barrier", "reduce"):
            if evicted:
                return {"ok": False, "fenced": True, "evicted": True,
                        "error": (f"executor {eid} was evicted from "
                                  f"collective group {ent['group']!r} (gray "
                                  "failure) and is parked in probation; "
                                  "rejoin follows readmission")}
            return {"ok": False, "fenced": True,
                    "error": (f"stale incarnation {msg.get('incarnation')} for "
                              f"executor {msg.get('executor_id')}: slot was "
                              "declared dead and re-fenced")}
        return {"ok": True, "fenced": True}

    def _dispatch_inner(self, msg: dict) -> dict:
        op = msg.get("op")
        try:
            ep = msg.get("coordinator_epoch")
            if ep is not None and int(ep) < self._epoch \
                    and op in ("barrier", "reduce"):
                # Epoch fencing, the failover twin of incarnation fencing: a
                # barrier/reduce composed against a pre-crash epoch belongs
                # to a generation that died with the crash — joining a live
                # one could satisfy (and corrupt) a rendezvous its sender
                # never meant.  Idempotent ops pass: the reply's epoch
                # re-syncs the client.
                return {"ok": False, "stale_epoch": True,
                        "error": (f"request from coordinator epoch {ep} fenced "
                                  f"(current epoch {self._epoch}): the control "
                                  "plane restarted; re-sync and retry")}
            relearn = self._readmit_relearn(msg)
            if op != "register" and relearn is None and self._is_fenced(msg):
                # TF-Replicator-style generation fencing: the zombie must
                # never influence live state — with the one carve-out of a
                # readmitted-from-eviction process relearning its identity
                # (relearn above; there is no replacement to race).
                return self._fenced_reply(op, msg)
            resp = self._serve_op(op, msg)
            if relearn is not None and resp.get("ok"):
                resp["readmit_incarnation"] = relearn
            return resp
        except Exception as e:  # keep the server alive on handler bugs
            logger.exception("coordinator op %s failed", op)
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}

    def _serve_op(self, op: str, msg: dict) -> dict:
        if op == "register":
            return self._op_register(msg)
        if op == "query":
            return {"ok": True, "complete": self._complete.is_set(), "count": len(self._nodes)}
        if op == "cluster_info":
            if not self._complete.is_set():
                return {"ok": False, "error": "cluster incomplete"}
            return {"ok": True, "nodes": self.cluster_info()}
        if op == "barrier":
            msg = dict(msg, kind="all", value=True)
            return self._op_reduce(msg)
        if op == "reduce":
            return self._op_reduce(msg)
        if op == "update_meta":
            with self._lock:
                for m in self._nodes:
                    if m["executor_id"] == msg["executor_id"]:
                        m.update(msg.get("patch") or {})
            return {"ok": True}
        if op == "heartbeat":
            with self._lock:
                # a deregistered (cleanly exited) node sends no further
                # beats; never resurrect one from a late in-flight ping —
                # and never let such a ping's metric delta overwrite the
                # FINAL snapshot the deregister already merged (the
                # heartbeat thread races teardown on its own connection)
                if msg["executor_id"] in self._last_seen:
                    self._last_seen[msg["executor_id"]] = time.monotonic()
                    if msg.get("metrics"):
                        self._merge_metrics_locked(int(msg["executor_id"]),
                                                   msg["metrics"])
                # trace deltas are append-only (spans/events, never a
                # snapshot overwrite), so keep one even from a ping that
                # raced deregister — it holds spans the final delta
                # doesn't, and the node-side restore path never sees a
                # reply that said ok.  Zombies never reach here (fenced).
                if msg.get("trace"):
                    self._merge_trace_locked(str(msg["executor_id"]),
                                             msg["trace"])
            # "now" is this process's monotonic clock at reply build —
            # the client's RTT-midpoint clock-offset estimate hangs off
            # it (trace timeline merging, trace_export.py)
            return {"ok": True, "stop": self._stop_flag.is_set(),
                    "now": time.monotonic()}
        if op == "metrics":
            return {"ok": True, "snapshot": self.cluster_metrics()}
        if op == "statz":
            return {"ok": True, "stats": self.cluster_stats(
                float(msg.get("window") or 10.0))}
        if op == "manifest":
            with self._lock:
                return {"ok": True, "manifest": dict(self._manifest)}
        if op == "deregister":
            # node exiting deliberately (map_fun done, or error already
            # reported): stop liveness tracking so the driver's dead-node
            # monitor never flags a clean exit as a death.  The final
            # metrics snapshot rides along — work done after the last
            # heartbeat must still reach the cluster view.
            with self._lock:
                if self._last_seen.pop(msg["executor_id"], None) is not None:
                    self._log("deregister",
                              eid=int(msg["executor_id"]))
                if msg.get("metrics"):
                    self._merge_metrics_locked(int(msg["executor_id"]),
                                               msg["metrics"])
                if msg.get("trace"):
                    self._merge_trace_locked(str(msg["executor_id"]),
                                             msg["trace"])
            return {"ok": True}
        if op == "error":
            with self._lock:
                self._errors.append({"executor_id": msg.get("executor_id"), "traceback": msg.get("traceback", "")})
            logger.error("node %s reported error:\n%s", msg.get("executor_id"), msg.get("traceback", ""))
            return {"ok": True}
        if op == "suspect":
            return self._op_suspect(msg)
        if op == "cworld":
            # effective-world adjudication for a degraded formation:
            # nominal world minus the group's members parked in probation
            group = str(msg.get("group") or "train")
            nominal = int(msg.get("world") or 0)
            with self._lock:
                ev = sorted(e for e, d in self._evicted.items()
                            if d["group"] == group)
            return {"ok": True, "evicted": ev,
                    "effective": (max(1, nominal - len(ev))
                                  if nominal else None)}
        if op == "stop":
            self._stop_flag.set()
            return {"ok": True}
        if op == "bye":
            return {"ok": True}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def _op_register(self, msg: dict) -> dict:
        meta = dict(msg.get("meta") or {})
        replace = msg.get("replace")
        if replace is not None:
            return self._op_register_replacement(int(replace), meta)
        with self._lock:
            if len(self._nodes) >= self.expected:
                # complete AND no opened scale-out slots outstanding
                return {"ok": False, "error": "cluster already complete"}
            executor_id = len(self._nodes)
            job_name, task_index = self.roles[executor_id]
            meta.update(executor_id=executor_id, job_name=job_name, task_index=task_index)
            self._nodes.append(meta)
            self._log("register", meta=dict(meta), replace=False)
            self._last_seen[executor_id] = time.monotonic()
            incarnation = self._incarnations.get(executor_id, 0)
            if len(self._nodes) == self.expected:
                self._complete.set()
            live = len(self._last_seen)
        telemetry.gauge("coordinator.live_slots").set(live)
        logger.info("registered node %d as %s:%d (%s)", executor_id, job_name, task_index, meta.get("host"))
        return {"ok": True, "executor_id": executor_id, "job_name": job_name,
                "task_index": task_index, "expected": self.expected,
                "incarnation": incarnation}

    def _op_register_replacement(self, executor_id: int, meta: dict) -> dict:
        """Re-register a supervised restart into its predecessor's slot.

        The slot keeps its executor_id/role (SPMD layout is positional), the
        meta (host/data_port/pid) is replaced wholesale, and the node adopts
        the slot's CURRENT incarnation — already bumped past the dead
        predecessor by ``mark_dead``, so the zombie stays fenced while the
        replacement is fully live."""
        with self._lock:
            if not self._complete.is_set():
                return {"ok": False, "error": "cannot replace before the cluster formed"}
            slot = next((m for m in self._nodes if m["executor_id"] == executor_id), None)
            if slot is None:
                return {"ok": False, "error": f"no executor slot {executor_id} to replace"}
            if executor_id in self._retired:
                # a supervised respawn racing retire_node: the slot was
                # scaled in while the replacement booted — admitting it
                # would resurrect a ghost member nobody feeds or retires
                return {"ok": False, "error": (f"executor slot {executor_id} "
                                               "was retired (scale-in); "
                                               "refusing replacement")}
            if executor_id in self._evicted:
                # an evicted slot's PROCESS IS ALIVE (parked in probation);
                # registering a replacement would split-brain the slot —
                # eviction parks, it never respawns
                return {"ok": False, "error": (f"executor slot {executor_id} "
                                               "is evicted to probation (its "
                                               "process is alive); refusing "
                                               "replacement")}
            if executor_id in self._last_seen:
                return {"ok": False, "error": (f"executor {executor_id} is still "
                                               "liveness-tracked; refusing replacement")}
            job_name, task_index = self.roles[executor_id]
            meta.update(executor_id=executor_id, job_name=job_name, task_index=task_index)
            slot.clear()
            slot.update(meta)
            self._log("register", meta=dict(meta), replace=True)
            self._last_seen[executor_id] = time.monotonic()
            incarnation = self._incarnations.get(executor_id, 0)
            live = len(self._last_seen)
        telemetry.gauge("coordinator.live_slots").set(live)
        logger.info("replacement registered for node %d as %s:%d (%s, incarnation %d)",
                    executor_id, job_name, task_index, meta.get("host"), incarnation)
        return {"ok": True, "executor_id": executor_id, "job_name": job_name,
                "task_index": task_index, "expected": self.expected,
                "incarnation": incarnation}

    def _op_reduce(self, msg: dict) -> dict:
        name, kind, value = msg["name"], msg.get("kind", "gather"), msg.get("value")
        timeout = msg.get("timeout", 300.0)
        # Participant count may be a subgroup (e.g. feedable nodes excluding
        # the evaluator); every participant must pass the same count.
        count = msg.get("count")
        with self._lock:
            if not count:
                # Default = LIVE membership: expected only ever grows, and
                # retired slots (scale-in) are gone for good — a barrier at
                # the pre-resize count would wait on ghosts forever.
                count = self.expected - len(self._retired)
            count = int(count)
            rdv = self._rdv.get(name)
            # done/aborted generations are popped by whoever finished them,
            # but guard anyway: never join a finished generation.
            if rdv is None or rdv.done or rdv.aborted:
                rdv = self._rdv[name] = _Rendezvous(count)
                self._log("rdv_open", sync=False, name=name, count=count,
                          kind=kind)
            elif rdv.count != count:
                return {"ok": False, "error": f"reduce {name!r}: conflicting participant counts "
                                              f"({rdv.count} vs {count})"}
        with rdv.cond:
            if rdv.done or rdv.aborted:
                # generation finished between registry lookup and here; the
                # caller raced a completed round — treat as a fresh failure
                # rather than returning another round's result.
                return {"ok": False, "error": f"barrier/reduce {name!r} generation closed; retry"}
            rdv.values.append(value)
            if len(rdv.values) == rdv.count:
                rdv.result = _reduce(kind, rdv.values)
                rdv.done = True
                # consensus latency span: generation open -> last arrival
                # (the SURVEY §5.8-3 number ops watch when scaling steps)
                telemetry.histogram("coordinator.rendezvous_secs").observe(
                    time.monotonic() - rdv.t0)
                with self._lock:
                    if self._rdv.get(name) is rdv:
                        del self._rdv[name]
                    self._log("rdv_close", sync=False, name=name, kind=kind)
                    if kind == "form":
                        # collective membership is control-plane state worth
                        # keeping: the postmortem (and a future cold-start
                        # resume) can see who stood at which generation
                        member_eids = [int(m["eid"])
                                       for m in rdv.result["members"]]
                        self._log("form", name=name, members=member_eids,
                                  generation=rdv.result["generation"],
                                  step=rdv.result["step"])
                        # live membership for the gray-failure machinery:
                        # suspicion quorums count against THIS formation,
                        # and a fresh generation is a fresh slate of votes
                        gname = name
                        if gname.startswith("cg.") and gname.endswith(".form"):
                            gname = gname[3:-5]
                        self._collective[gname] = {
                            "members": member_eids,
                            "generation": int(rdv.result["generation"])}
                        self._suspicions.pop(gname, None)
                        for key in [k for k in self._evict_pending
                                    if k[0] == gname]:
                            del self._evict_pending[key]
                rdv.cond.notify_all()
            else:
                deadline = time.monotonic() + timeout
                while not (rdv.done or rdv.aborted):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._stop_flag.is_set():
                        rdv.aborted = True
                        with self._lock:
                            if self._rdv.get(name) is rdv:
                                del self._rdv[name]
                            self._log("rdv_abort", sync=False, name=name)
                        rdv.cond.notify_all()
                        return {"ok": False, "error": f"barrier/reduce {name!r} timed out"}
                    rdv.cond.wait(min(remaining, 0.5))
                if rdv.aborted:
                    return {"ok": False, "error": f"barrier/reduce {name!r} aborted (peer timed out)"}
            return {"ok": True, "result": rdv.result}


class CoordinatorClient:
    """Node-side client (reference ``reservation.Client``), persistent socket.

    Failover behaviour (ISSUE 13): every reply carries the coordinator
    EPOCH; a bump means the control plane crashed and recovered from its
    journal.  On a broken connection the client redials with backoff
    (``TOS_CONNECT_ATTEMPTS``) and transparently retries IDEMPOTENT ops
    (heartbeat, queries, update_meta, deregister, error); a barrier/reduce
    instead raises :class:`CoordinatorRestarted` after reconnecting — its
    rendezvous generation died with the crash, and whether to re-enter (a
    fresh generation) is the caller's SPMD-consistency decision, never the
    transport's.
    """

    def __init__(self, address: tuple[str, int], connect_timeout: float = 30.0,
                 authkey: bytes | None = None,
                 connect_attempts: int | None = None,
                 call_timeout: float | None = None):
        from tensorflowonspark_torch.utils.envtune import env_int

        self.address = (address[0], int(address[1]))
        self._lock = tos_named_lock("coordinator.client._lock")
        self._authkey = authkey
        self._connect_timeout = connect_timeout
        # Backoff on the dial (TOS_CONNECT_ATTEMPTS): a single-shot connect
        # fails hard during a coordinator restart window or early-boot race;
        # the elastic layer leans on clients riding that window out.
        self._connect_attempts = (env_int("TOS_CONNECT_ATTEMPTS", 3)
                                  if connect_attempts is None
                                  else int(connect_attempts))
        # None = block indefinitely (barriers/reduces legitimately wait
        # minutes).  The heartbeat channel passes a bound so a BLACKHOLED
        # coordinator (packets dropped, not refused) surfaces as a timeout
        # the self-fence logic can count, instead of wedging the liveness
        # thread forever — the zombie asymmetry ISSUE 13 closes.
        self._call_timeout = call_timeout
        self._sock = self._dial()
        self._gen = 0
        self._executor_id: int | None = None
        self._incarnation = 0
        # last coordinator epoch observed on a reply (None until the first
        # round-trip); a bump is flight-recorded once per change
        self.epoch: int | None = None
        # True when the last heartbeat reply said this slot is EVICTED to
        # probation (gray failure) — the node's heartbeat loop parks on it
        self.last_evicted = False
        # latest clock estimate from a heartbeat round-trip (driver-mono =
        # local-mono + offset, midpoint method); the node's heartbeat loop
        # feeds the best of these to the tracer for timeline merging
        self.last_clock_offset: float | None = None
        self.last_rtt: float | None = None

    def _dial(self) -> socket.socket:
        from tensorflowonspark_torch.utils.net import connect_with_backoff

        sock = connect_with_backoff(
            self.address, timeout=self._connect_timeout,
            attempts=self._connect_attempts)
        if self._authkey is not None:
            from tensorflowonspark_torch.utils.net import hmac_handshake_client

            # connect_timeout still governs the socket here, so a server
            # that never sends a nonce (authkey=None config mismatch) fails
            # within it rather than hanging; close the fd on ANY failure.
            try:
                accepted = hmac_handshake_client(sock, self._authkey)
            except (OSError, ConnectionError) as e:
                sock.close()
                raise ConnectionError(
                    f"coordinator handshake failed ({e}); authkey mismatch or "
                    "unauthenticated server?") from e
            if not accepted:
                sock.close()
                raise ConnectionError("coordinator rejected authkey")
        sock.settimeout(self._call_timeout)
        return sock

    def _reconnect_locked(self) -> None:
        """Redial (with backoff) after a broken connection — the coordinator
        may be mid-supervised-restart; caller holds ``_lock``."""
        with contextlib.suppress(OSError):
            self._sock.close()
        self._sock = self._dial()

    def set_identity(self, executor_id: int, incarnation: int = 0) -> None:
        """Adopt the registration-assigned identity: every subsequent message
        is stamped with (executor_id, incarnation) so the coordinator can
        fence this client the moment its slot is declared dead and handed to
        a replacement."""
        self._executor_id = int(executor_id)
        self._incarnation = int(incarnation)

    @property
    def incarnation(self) -> int:
        """The incarnation this client currently stamps — bumped in place
        when a readmission reply hands back ``readmit_incarnation``."""
        return self._incarnation

    def _stamp(self, msg: dict) -> dict:
        if self._executor_id is not None and msg.get("op") != "register":
            msg.setdefault("executor_id", self._executor_id)
            msg.setdefault("incarnation", self._incarnation)
        if self.epoch is not None:
            # epoch fencing: the server rejects barrier/reduce requests
            # composed against a pre-crash epoch (stale_epoch reply)
            msg.setdefault("coordinator_epoch", self.epoch)
        return msg

    def _note_epoch(self, resp: dict) -> None:
        ep = resp.get("epoch")
        if ep is None:
            return
        ep = int(ep)
        if self.epoch is not None and ep > self.epoch:
            ttrace.event("coordinator_epoch", epoch=ep,
                         executor=self._executor_id)
            logger.warning("coordinator epoch %d -> %d: the control plane "
                           "restarted; re-asserting over this connection",
                           self.epoch, ep)
        if self.epoch is None or ep > self.epoch:
            self.epoch = ep

    def _call(self, msg: dict, retry: bool = False) -> dict:
        """One request/reply round-trip.  On a broken connection the client
        reconnects with backoff either way; ``retry=True`` (idempotent ops
        only) then resends the request, while ``retry=False`` raises
        :class:`CoordinatorRestarted` — a non-idempotent request may have
        been served before the connection died, and blind replay could
        join (and corrupt) a fresh rendezvous generation."""
        msg = self._stamp(msg)
        with self._lock:
            try:
                _send_msg(self._sock, msg)
                resp = _recv_msg(self._sock)
            except (ConnectionError, OSError, ValueError) as e:
                try:
                    self._reconnect_locked()
                except Exception as e2:
                    raise ConnectionError(
                        f"coordinator unreachable ({e2}); original failure: "
                        f"{e}") from e
                if not retry:
                    raise CoordinatorRestarted(
                        f"control-plane connection lost mid-call ({e}); "
                        "reconnected, but a non-idempotent op is never "
                        "replayed — re-enter at the caller's barrier") from e
                _send_msg(self._sock, msg)
                resp = _recv_msg(self._sock)
        self._note_epoch(resp)
        ri = resp.get("readmit_incarnation")
        if ri is not None and self._executor_id is not None \
                and int(ri) > self._incarnation:
            # the slot was evicted (gray failure) and READMITTED: the
            # coordinator hands back the bumped incarnation on served
            # replies so every stale client of the process self-heals
            logger.warning("executor %d readmitted after eviction; this "
                           "client adopts incarnation %d",
                           self._executor_id, int(ri))
            self._incarnation = int(ri)
        return resp

    def _check(self, resp: dict) -> dict:
        if not resp.get("ok"):
            if resp.get("stale_epoch"):
                raise CoordinatorRestarted(
                    f"coordinator error: {resp.get('error')}")
            if resp.get("fenced"):
                raise CoordinatorFenced(
                    f"coordinator error: {resp.get('error')}")
            raise RuntimeError(f"coordinator error: {resp.get('error')}")
        return resp

    def register(self, meta: dict, replace: int | None = None) -> dict:
        """Register this node; returns assigned identity {executor_id,
        job_name, task_index, incarnation}.  ``replace`` re-registers a
        supervised restart into the named (dead) executor slot."""
        msg: dict = {"op": "register", "meta": meta}
        if replace is not None:
            msg["replace"] = int(replace)
        return self._check(self._call(msg))

    def await_cluster(self, timeout: float | None = None, poll: float = 0.1) -> list[dict]:
        """Poll QUERY until all nodes registered, then fetch cluster info (QINFO)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            resp = self._check(self._call({"op": "query"}, retry=True))
            if resp.get("fenced"):
                # a fenced sender's query is answered without ``complete``
                raise CoordinatorFenced(
                    f"executor {self._executor_id} (incarnation "
                    f"{self._incarnation}) was declared dead before the "
                    "cluster formed: its heartbeat was silent past the "
                    "driver's dead-node window")
            if resp["complete"]:
                return self._check(self._call({"op": "cluster_info"}, retry=True))["nodes"]
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("cluster did not complete in time")
            time.sleep(poll)

    def barrier(self, name: str, executor_id: int, timeout: float = 300.0,
                count: int | None = None) -> None:
        self._check(self._call({"op": "barrier", "name": name, "executor_id": executor_id,
                                "timeout": timeout, "count": count}))

    def reduce(self, name: str, value: Any, kind: str = "gather", timeout: float = 300.0,
               count: int | None = None) -> Any:
        """Control-plane all-reduce; ``count`` scopes it to a subgroup of nodes."""
        return self._check(
            self._call({"op": "reduce", "name": name, "value": value, "kind": kind,
                        "timeout": timeout, "count": count})
        )["result"]

    def reduce_begin(self, name: str, value: Any, kind: str = "gather",
                     timeout: float = 300.0, count: int | None = None):
        """Pipelined reduce: send this participant's value NOW, collect the
        result later via the returned zero-arg callable.

        Lets a caller overlap the control-plane round-trip with its own work
        (e.g. a training step) instead of blocking one RTT per global step
        (SURVEY.md §5.8-3).  The client lock is HELD from begin to finish —
        strict request-reply ordering on the socket — so run pipelined
        reduces on a dedicated connection, never on a client shared with
        other mid-flight operations."""
        self._lock.acquire()
        sent = False
        try:
            _send_msg(self._sock, self._stamp(
                {"op": "reduce", "name": name, "value": value,
                 "kind": kind, "timeout": timeout, "count": count}))
            sent = True
        finally:
            if not sent:
                self._lock.release()

        def finish() -> Any:
            try:
                return self._check(_recv_msg(self._sock))["result"]
            finally:
                self._lock.release()

        return finish

    def collective_form(self, name: str, member: dict, count: int,
                        timeout: float = 300.0) -> dict:
        """Collective-group formation rendezvous (the ``form`` reduce kind):
        block until ``count`` members contributed their endpoint dicts, then
        return the shared view ``{"members": [...eid-sorted...],
        "generation": max, "step": max}``.  The caller's rank is the index
        of its eid in ``members``.  Incarnation fencing applies: a fenced
        zombie's join is rejected, so a dead predecessor can never occupy
        its replacement's seat at the barrier."""
        return self.reduce(name, dict(member), kind="form", timeout=timeout,
                           count=count)

    def suspect(self, group: str, suspect_eid: int,
                wait_secs: float) -> dict:
        """File one straggler-suspicion vote against ``suspect_eid`` (the
        peer this node has been waiting on).  Idempotent per voter —
        refiling refreshes the vote — so it retries transparently; the
        reply carries the group's current ``evicted`` list, which doubles
        as the "is my round doomed" poll."""
        return self._check(self._call(
            {"op": "suspect", "group": str(group),
             "suspect": int(suspect_eid),
             "wait_secs": float(wait_secs)}, retry=True))

    def collective_world(self, group: str, world: int) -> dict:
        """Effective-world adjudication for a degraded formation:
        ``{"effective": nominal - evicted, "evicted": [...]}``."""
        return self._check(self._call(
            {"op": "cworld", "group": str(group), "world": int(world)},
            retry=True))

    def next_collective_name(self, prefix: str) -> str:
        """Locally-generated unique name; callers must use it SPMD-consistently."""
        self._gen += 1
        return f"{prefix}:{self._gen}"

    def update_meta(self, executor_id: int, patch: dict) -> None:
        """Patch this node's registered metadata (e.g. tensorboard URL)."""
        self._check(self._call({"op": "update_meta", "executor_id": executor_id, "patch": patch}, retry=True))

    def heartbeat(self, executor_id: int, metrics: dict | None = None,
                  trace: dict | None = None) -> bool:
        """Send liveness ping; returns True if the driver asked us to stop.
        ``metrics`` piggybacks a compact telemetry delta
        (``telemetry.collect_changed``) and ``trace`` a span/flight-event
        delta (``telemetry.trace.collect_delta``) on the ping — the cluster
        observability transport costs no extra round-trips.  Each ping also
        refreshes ``last_clock_offset``/``last_rtt`` from the reply's
        server clock (NTP-style midpoint), the estimate trace export uses
        to merge per-node span streams onto the driver timeline."""
        msg: dict = {"op": "heartbeat", "executor_id": executor_id}
        if metrics:
            msg["metrics"] = metrics
        if trace:
            msg["trace"] = trace
        t0 = time.monotonic()
        resp = self._check(self._call(msg, retry=True))
        t1 = time.monotonic()
        server_now = resp.get("now")
        if server_now is not None:
            self.last_rtt = t1 - t0
            self.last_clock_offset = float(server_now) - (t0 + t1) / 2.0
        self.last_evicted = bool(resp.get("evicted"))
        return bool(resp["stop"])

    def metrics(self) -> dict:
        """Aggregated cluster metrics snapshot (the ``metrics`` op)."""
        return self._check(self._call({"op": "metrics"}, retry=True))["snapshot"]

    def stats(self, window: float = 10.0) -> dict:
        """Rolling-window cluster stats (the ``statz`` op): live qps /
        p50/p99 / queue depths over the last ``window`` seconds."""
        return self._check(self._call({"op": "statz", "window": float(window)},
                                       retry=True))["stats"]

    def manifest(self) -> dict:
        """The driver-published DIRECT-mode job manifest (empty dict until
        a DIRECT train() publishes one)."""
        return self._check(self._call({"op": "manifest"}, retry=True))["manifest"]

    def report_error(self, executor_id: int, traceback_str: str) -> None:
        self._call({"op": "error", "executor_id": executor_id,
                    "traceback": traceback_str}, retry=True)

    def deregister(self, executor_id: int, metrics: dict | None = None,
                   trace: dict | None = None) -> None:
        """Announce a deliberate exit (stops dead-node tracking for this id);
        ``metrics`` carries the node's final telemetry snapshot and
        ``trace`` its final span/flight-event delta."""
        msg: dict = {"op": "deregister", "executor_id": executor_id}
        if metrics:
            msg["metrics"] = metrics
        if trace:
            msg["trace"] = trace
        self._call(msg, retry=True)

    def request_stop(self) -> None:
        self._call({"op": "stop"}, retry=True)

    def close(self) -> None:
        try:
            with self._lock:
                _send_msg(self._sock, {"op": "bye"})
                try:
                    _recv_msg(self._sock)
                except (ConnectionError, OSError, ValueError):  # toslint: allow-silent(best-effort bye ack; the server may already be gone)
                    pass
        except OSError:  # toslint: allow-silent(best-effort teardown; socket close below is what matters)
            pass
        finally:
            self._sock.close()
