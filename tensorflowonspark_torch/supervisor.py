"""Supervised worker restart — the elastic half of fault tolerance.

The reference outsourced this to Spark: a dead executor's task was rerun by
the scheduler, and the reservation server simply saw a fresh registration
(PAPER.md §5.3).  With no Spark layer, detection already lives in the driver
(heartbeats → ``CoordinatorServer.dead_nodes`` → the cluster monitor); this
module adds *recovery*: when the monitor declares a data node dead, the
supervisor reaps whatever is left of the process, waits out a bounded
exponential backoff (with jitter, so a correlated failure doesn't respawn a
whole fleet in lockstep), and relaunches the node into the same slot via
``launcher.respawn``.  The replacement re-registers with
``replace_executor_id`` and adopts the slot's bumped *incarnation number* —
the coordinator fences everything the dead predecessor might still send
("TensorFlow: A system for large-scale machine learning" treats checkpoint
restart as the baseline contract; TF-Replicator adds the generation fencing
this implements).

Classification keeps restarts honest:

- a node that *reported a map_fun error* before dying failed on the
  application, not the infrastructure — restarting would just crash-loop the
  same bug, so the death stays fatal;
- a node past ``max_restarts`` is permanently failed: the supervisor records
  a node error (surfacing through the same channel map_fun errors use) and
  signals stop, restoring the non-elastic fail-fast behaviour.

Scope: restartable jobs are the streaming/DIRECT per-host-mesh kind.  A
``jax.distributed`` job cannot readmit a process into a live XLA world —
``cluster.run(elastic=...)`` refuses the combination up front.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from tensorflowonspark_torch.utils.locks import tos_named_lock
import time

from tensorflowonspark_torch import telemetry
from tensorflowonspark_torch.telemetry import trace as ttrace
from tensorflowonspark_torch.utils.envtune import env_float, env_int
from tensorflowonspark_torch.utils.net import backoff_delay

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class RestartPolicy:
    """Per-node restart budget + backoff schedule (env-overridable)."""

    max_restarts: int = 2
    backoff_base: float = 0.5
    backoff_factor: float = 2.0
    backoff_max: float = 10.0
    jitter: float = 0.25

    @classmethod
    def from_env(cls) -> "RestartPolicy":
        return cls(
            max_restarts=env_int("TOS_MAX_RESTARTS", 2, minimum=0),
            backoff_base=env_float("TOS_RESTART_BACKOFF_BASE", 0.5),
            backoff_factor=env_float("TOS_RESTART_BACKOFF_FACTOR", 2.0),
            backoff_max=env_float("TOS_RESTART_BACKOFF_MAX", 10.0),
        )

    def delay(self, attempt: int) -> float:
        """Backoff before restart ``attempt`` (0-based), jittered ±jitter."""
        return backoff_delay(attempt, self.backoff_base, self.backoff_factor,
                             self.backoff_max, self.jitter)


class CoordinatorSupervisor:
    """Supervised restart of the control-plane server ITSELF (ISSUE 13).

    The coordinator was the last unsupervised failure domain: node death,
    severed sockets, and mid-drain kills all recover, but a coordinator
    crash used to kill the run.  With the write-ahead journal
    (``journal.py``) the server can be rebuilt from disk; this class reuses
    the node supervisor's budgeted-backoff machinery (same
    :class:`RestartPolicy` / ``TOS_MAX_RESTARTS`` / ``TOS_RESTART_BACKOFF_*``
    knobs) to drive ``CoordinatorServer.restore()`` after a ``crash()``:
    wait out a jittered backoff, replay the journal, resume under a bumped
    coordinator epoch.  Budget exhausted (or restore itself raising past
    the budget) fails the run through the node-error channel — the
    non-supervised fail-fast behaviour, delayed by the budget, not removed.
    """

    def __init__(self, server, policy: RestartPolicy | None = None):
        self.server = server
        self.policy = policy or RestartPolicy.from_env()
        self._lock = tos_named_lock("supervisor.coord._lock")
        self._stopped = threading.Event()
        self._restarts = 0
        self._permanent: str | None = None
        self._inflight = False
        self._threads: list[threading.Thread] = []
        server.add_crash_listener(self._on_crash)

    def restart_count(self) -> int:
        with self._lock:
            return self._restarts

    def permanently_failed(self) -> str | None:
        with self._lock:
            return self._permanent

    def _on_crash(self) -> None:
        if self._stopped.is_set():
            return
        with self._lock:
            if self._inflight or self._permanent is not None:
                return
            self._inflight = True
            t = threading.Thread(target=self._recover, daemon=True,
                                 name="coordinator-supervisor")
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
        t.start()

    def _recover(self) -> None:
        try:
            while True:
                with self._lock:
                    attempt = self._restarts
                if attempt >= self.policy.max_restarts:
                    self._fail_permanently(
                        f"coordinator exhausted its restart budget "
                        f"({self.policy.max_restarts} restart(s)); giving up")
                    return
                delay = self.policy.delay(attempt)
                logger.warning("restarting coordinator in %.2fs "
                               "(attempt %d/%d)", delay, attempt + 1,
                               self.policy.max_restarts)
                if self._stopped.wait(delay):
                    return
                with self._lock:
                    self._restarts = attempt + 1
                try:
                    self.server.restore()
                    return
                except Exception:
                    logger.exception("coordinator restore failed; spending "
                                     "another budget unit")
        finally:
            with self._lock:
                self._inflight = False

    def _fail_permanently(self, reason: str) -> None:
        telemetry.counter("coordinator.permanent_failures").inc()
        ttrace.event("permanent_failure", executor=-1, reason=reason[:200])
        logger.error("control plane permanently failed: %s", reason)
        # surface through the node-error channel (executor -1 = the control
        # plane itself) so shutdown()'s error propagation raises it; the
        # _permanent flag is set LAST — it is the observable "verdict is in"
        # signal, and a watcher acting on it must find the error recorded
        self.server.record_failure(
            -1, f"control plane permanently failed: {reason}")
        self.server.signal_stop()
        with self._lock:
            self._permanent = reason

    def stop(self, timeout: float = 10.0) -> None:
        """No coordinator restarts past this point (shutdown owns teardown)."""
        self._stopped.set()
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout)


class Supervisor:
    """Watches launcher children and restarts failed nodes under a policy."""

    def __init__(self, coordinator, launcher, policy: RestartPolicy | None = None):
        self.coordinator = coordinator
        self.launcher = launcher
        self.policy = policy or RestartPolicy.from_env()
        # How long a respawned replacement gets to re-register before the
        # supervisor treats its boot as another death (the monitor can only
        # re-detect nodes that made it into liveness tracking).
        self._reregister_timeout = env_float("TOS_REREGISTER_TIMEOUT", 60.0)
        self._lock = tos_named_lock("supervisor._lock")
        self._stopped = threading.Event()
        self._restarts: dict[int, int] = {}
        self._permanent: dict[int, str] = {}
        self._inflight: set[int] = set()
        # Slots being retired ON PURPOSE (cluster.resize scale-in): their
        # death — clean exit, or a kill mid-drain — is classified as
        # retirement, never recovery: no respawn, no restart-budget charge,
        # no elastic.restarts_total increment.
        self._retired: set[int] = set()
        # Slots EVICTED from a collective group at quorum (gray failure):
        # the process is alive, benched in probation — respawning a
        # replacement into the slot would split-brain it, so recovery is
        # declined until the coordinator readmits (unpark) or the slot is
        # definitively dead after probation.
        self._parked: set[int] = set()
        self._threads: list[threading.Thread] = []

    # -- status (consumed by the partition ledger's recovery waits) ----------

    def permanently_failed(self, executor_id: int) -> str | None:
        """The recorded reason when the slot is beyond recovery, else None."""
        with self._lock:
            return self._permanent.get(executor_id)

    def retire(self, executor_id: int) -> None:
        """Mark the slot's upcoming death INTENTIONAL (scale-in drain has
        begun): ``handle_death`` will decline to recover it.  Distinct from
        a permanent failure — retirement records no node error and signals
        no stop; the cluster simply got smaller on purpose."""
        with self._lock:
            self._retired.add(executor_id)
        telemetry.counter("elastic.retirements_total").inc()

    def retired(self, executor_id: int) -> bool:
        with self._lock:
            return executor_id in self._retired

    def park(self, executor_id: int) -> None:
        """Collective eviction (gray failure): bench the slot.  Its process
        is ALIVE — slow or wedged, not dead — so ``handle_death`` declines
        to respawn while parked: a replacement would split-brain the slot
        against the still-running original.  The coordinator's readmission
        (probation health probe passed) unparks it."""
        with self._lock:
            if executor_id in self._parked:
                return
            self._parked.add(executor_id)
        telemetry.counter("elastic.parked_total").inc()
        logger.warning("executor %d parked in probation (collective "
                       "eviction); supervised restart declined while its "
                       "process is alive", executor_id)

    def unpark(self, executor_id: int) -> None:
        """The evicted process passed its probation health probe and was
        readmitted — normal death recovery applies again."""
        with self._lock:
            if executor_id not in self._parked:
                return
            self._parked.discard(executor_id)
        logger.info("executor %d unparked (readmitted after probation)",
                    executor_id)

    def parked(self, executor_id: int) -> bool:
        with self._lock:
            return executor_id in self._parked

    def restart_count(self, executor_id: int) -> int:
        with self._lock:
            return self._restarts.get(executor_id, 0)

    def restarting(self, executor_id: int) -> bool:
        with self._lock:
            return executor_id in self._inflight

    # -- lifecycle -----------------------------------------------------------

    def handle_death(self, executor_id: int) -> None:
        """Non-blocking: schedule recovery of a node the monitor just
        declared dead (its incarnation is already fenced).  Backoff and
        respawn run on their own thread so one slot's restart window never
        delays detection or recovery of its peers."""
        if self._stopped.is_set():
            return
        with self._lock:
            if executor_id in self._retired:
                # intentional retirement (scale-in): the death IS the plan —
                # no respawn, no budget charge, no restart counted
                logger.info("executor %d died while retiring; not recovering "
                            "(intentional scale-in)", executor_id)
                return
            if executor_id in self._parked:
                # evicted to probation: the original process is (or was
                # moments ago) alive — respawning would split-brain the
                # slot; readmission or an explicit unpark re-enables
                # recovery
                logger.warning("executor %d declared dead while parked in "
                               "probation; not respawning (eviction parks, "
                               "it never refills the slot)", executor_id)
                return
            if executor_id in self._inflight or executor_id in self._permanent:
                return
            self._inflight.add(executor_id)
            self._threads = [t for t in self._threads if t.is_alive()]
            t = threading.Thread(target=self._restart, args=(executor_id,),
                                 daemon=True, name=f"supervisor-restart-{executor_id}")
            self._threads.append(t)
        t.start()

    def stop(self, timeout: float = 10.0) -> None:
        """No restarts past this point (shutdown owns escalation now)."""
        self._stopped.set()
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout)

    # -- the restart path ----------------------------------------------------

    def _fail_permanently(self, executor_id: int, reason: str) -> None:
        with self._lock:
            self._permanent[executor_id] = reason
        telemetry.counter("elastic.permanent_failures").inc()
        ttrace.event("permanent_failure", executor=executor_id,
                     reason=reason[:200])
        logger.error("executor %d permanently failed: %s", executor_id, reason)
        # Surface through the node-error channel and fail fast, exactly like
        # the non-elastic path would have on first death.
        self.coordinator.record_failure(executor_id, reason)
        self.coordinator.signal_stop()

    def _classify(self, executor_id: int, attempt: int) -> str | None:
        """Reason this death is NOT restartable, else None."""
        if attempt >= self.policy.max_restarts:
            return (f"node {executor_id} exhausted its restart budget "
                    f"({self.policy.max_restarts} restart(s)); giving up")
        if any(e.get("executor_id") == executor_id for e in self.coordinator.errors()):
            return (f"node {executor_id} reported a map_fun error before dying; "
                    "an application failure is not restartable")
        return None

    def _await_reregister(self, executor_id: int) -> bool:
        """True once the replacement is liveness-tracked (it re-registered);
        False when the re-register window expires or the supervisor stops."""
        deadline = time.monotonic() + self._reregister_timeout
        while time.monotonic() < deadline and not self._stopped.is_set():
            _, tracked = self.coordinator.registered_incarnation(executor_id)
            if tracked:
                return True
            time.sleep(0.25)
        return False

    def _restart(self, executor_id: int) -> None:
        try:
            # Loop rather than fire-and-forget: a replacement that dies
            # DURING BOOT (before registering) never enters liveness
            # tracking, so the monitor cannot re-detect it — the supervisor
            # itself must notice and spend the remaining budget on it.
            while True:
                if self.retired(executor_id):
                    # a resize retired this slot while recovery was pending:
                    # the restart is no longer wanted
                    return
                attempt = self.restart_count(executor_id)
                reason = self._classify(executor_id, attempt)
                if reason is not None:
                    self._fail_permanently(executor_id, reason)
                    return
                delay = self.policy.delay(attempt)
                logger.warning("restarting executor %d in %.2fs (attempt %d/%d)",
                               executor_id, delay, attempt + 1, self.policy.max_restarts)
                if self._stopped.wait(delay):
                    return
                meta = self.coordinator.node_meta(executor_id)
                launch_index = (meta or {}).get("launch_index", -1)
                if not 0 <= launch_index < len(self.launcher.processes):
                    self._fail_permanently(
                        executor_id,
                        f"node {executor_id} has no launch_index mapping; cannot respawn")
                    return
                config = dataclasses.replace(self.launcher.configs[launch_index],
                                             replace_executor_id=executor_id)
                # Last look before reaping: a replacement that booted slower
                # than the re-register window (cold jax/TPU init) may have
                # registered DURING the backoff we just waited out — killing
                # it now would burn the budget on a recovered slot (and its
                # stale liveness entry would make the next replacement's
                # register(replace=...) be refused as still-tracked).  A
                # registration landing in the microseconds between this check
                # and respawn() is still reaped — that residual race is not
                # closed, only narrowed: the reaped slot goes heartbeat-silent,
                # the monitor re-declares the death, and recovery re-enters
                # here at the cost of one extra budget unit.
                _, tracked = self.coordinator.registered_incarnation(executor_id)
                if tracked:
                    logger.info("executor %d re-registered late; restart "
                                "attempt %d not needed", executor_id, attempt + 1)
                    return
                with self._lock:
                    if self._stopped.is_set():
                        return
                    self._restarts[executor_id] = attempt + 1
                # respawn reaps the predecessor first: a fenced-but-alive
                # zombie (network partition, dropped heartbeats) must release
                # the slot's ports/devices before its replacement takes them.
                self.launcher.respawn(launch_index, config)
                telemetry.counter("elastic.restarts_total").inc()
                ttrace.event("restart", executor=executor_id,
                             attempt=attempt + 1)
                logger.info("executor %d respawned (launch_index %d, restart %d)",
                            executor_id, launch_index, attempt + 1)
                if self._await_reregister(executor_id):
                    return
                if self._stopped.is_set():
                    return
                logger.warning(
                    "replacement for executor %d died before re-registering "
                    "(%.0fs window); treating as another death",
                    executor_id, self._reregister_timeout)
        except Exception:
            logger.exception("supervised restart of executor %d failed", executor_id)
            self._fail_permanently(
                executor_id, f"supervised restart of node {executor_id} raised; see driver log")
        finally:
            with self._lock:
                self._inflight.discard(executor_id)
