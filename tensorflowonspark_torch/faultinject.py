"""Deterministic, env-gated fault injection for the recovery paths.

The elastic-recovery layer (``supervisor.py``, the partition ledger in
``cluster.py``, incarnation fencing in ``coordinator.py``) is only trustworthy
if every recovery path runs in fast tier-1 tests — not just in soak runs that
happen to hit a flake.  This module plants three chaos hooks at the exact
seams a real failure would hit, all disabled unless ``TOS_FAULTINJECT`` is
set (typically via ``per_node_env``, so one node of a test cluster misbehaves
deterministically while its peers stay healthy):

- ``kill`` — SIGKILL this node after its map_fun consumed N feed batches
  (hook: ``feeding.DataFeed.next_batch``).  Models an OOM kill / preemption
  mid-epoch: no deregister, no error report, just silence.
- ``drop_heartbeats`` — swallow the first K liveness pings (hook: the
  heartbeat loop in ``node.py``).  Models a network partition: the process
  lives on as a *zombie* the coordinator has declared dead, which is exactly
  what incarnation fencing exists for.
- ``sever`` — abruptly close the node's data-plane connection on the M-th
  data-carrying op (hook: ``dataserver.DataServer``).  Models a mid-partition
  socket loss with the node still healthy; the driver must requeue and refeed.
- ``kill_collective`` — SIGKILL this node inside its N-th collective
  all-reduce, after the first chunk exchange (hook: ``collective/ops.py``).
  Models a preemption mid-gradient-exchange: partial chunks in flight,
  peers blocked in the same round — survivors must abort at the generation
  barrier and the restart must rejoin (``collective/group.py``).
- ``kill_coordinator`` — crash the control-plane server on its N-th
  dispatched op (hook: ``coordinator.CoordinatorServer._dispatch``): every
  connection severed, in-memory state wiped, the request in flight never
  answered.  The journaled-recovery path (``journal.py`` + the coordinator
  supervisor) must replay and resume under a bumped epoch.  Armed in the
  DRIVER process (the coordinator lives there).
- ``delay_net:ms=M`` — network degradation: injects M milliseconds of
  latency on every control-plane send (``coordinator._send_msg``) and every
  data-carrying server op (``dataserver``) in the armed process, for as
  long as the process lives.
- ``flap:period=S`` — periodic network flapping: during every ODD
  S-second window since arming, this node's liveness pings are swallowed
  (zombie phase) and its first data-carrying op of the window severs the
  connection; even windows are healthy (re-admit phase).  Wall-clock
  driven by design — the action models link flap, not a counted event.
- ``stall_collective:after_rounds=N[,secs=S]`` — the GRAY failure: inside
  its N-th collective all-reduce (same seam as ``kill_collective``) the
  process goes silent for S seconds (default 300) and then resumes —
  alive the whole time, heartbeating, just not moving gradient bytes.
  Models a long GC pause / stolen core / wedged NIC queue: the case
  straggler detection + quorum eviction exist for (survivors must evict
  and continue at W-1 instead of thrashing on the collective timeout).
- ``slow_peer:ms=M`` — degraded-NIC gray fault: injects M milliseconds of
  latency on every collective PEER-PLANE send (``collective/transport``)
  in the armed process, for as long as it lives.  Armed on every node it
  models uniform slowness — the false-positive case eviction must never
  fire on; armed on one it models the persistent outlier.
- ``bad_model:nan=1,ms=M`` — model regression on the CANDIDATE bundle:
  while this serving replica is serving a rollout candidate (never the
  boot/primary bundle — the hook carries that bit), every batch's outputs
  are corrupted to NaN (``nan=1``) and/or delayed M milliseconds (hook:
  ``serving/loop.py``).  Models a bad export mid-canary: the rollout
  governor must detect the divergence/latency and auto-roll-back with
  zero failed primary requests.
- ``hot_tenant:mult=K,tenant=T`` — driver-side overload amplifier: every
  admission-time token-bucket charge for tenant T (all tenants when
  ``tenant`` is omitted) is multiplied by K (hook:
  ``serving/tenancy.py``), so a modest real load presents as K× the
  tenant's rate limit.  Models one tenant flooding: only T may see
  throttled replies while other tenants keep their p99.

Spec grammar (``TOS_FAULTINJECT``): semicolon-separated actions, each
``name:key=value,key=value`` —

    TOS_FAULTINJECT="kill:after_batches=3,incarnation=0"
    TOS_FAULTINJECT="drop_heartbeats:count=8;sever:after_data_ops=2"
    TOS_FAULTINJECT="kill_coordinator:after_ops=40"
    TOS_FAULTINJECT="delay_net:ms=5;flap:period=2"
    TOS_FAULTINJECT="stall_collective:after_rounds=3,secs=8,executor=1"
    TOS_FAULTINJECT="slow_peer:ms=25"

Common keys: ``executor=E`` fires only on that executor id (ids are assigned
at registration, so per-node targeting usually rides ``per_node_env``
instead); ``role=R`` fires only in processes whose ASSIGNED cluster role
matches (``role=ingest`` targets the data-service tier from a cluster-wide
spec — roles are registration-order, so per-launch-index env cannot);
``incarnation=I`` fires only at that node incarnation — the idiom
for "die once": a restarted node re-parses the same env but its incarnation
moved on, so the fault stays disarmed.  Counters are plain in-process
counts — same schedule every run.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
from tensorflowonspark_torch.utils.locks import tos_named_lock
import time

logger = logging.getLogger(__name__)

ENV_VAR = "TOS_FAULTINJECT"


class FaultInjected(Exception):
    """Raised by hooks that simulate infrastructure faults (e.g. ``sever``);
    handlers treat it as the fault itself, never as a handler bug."""


class _Action:
    __slots__ = ("name", "threshold", "executor", "incarnation", "role",
                 "extra", "fired", "count", "hb_cycle", "sever_cycle")

    def __init__(self, name: str, threshold: int,
                 executor: int | None, incarnation: int | None,
                 role: str | None = None, extra: dict | None = None):
        self.name = name
        self.threshold = threshold
        self.executor = executor
        self.incarnation = incarnation
        self.role = role
        # secondary action parameters (e.g. stall_collective's `secs=`)
        self.extra = extra or {}
        self.fired = False
        self.count = 0
        # flap bookkeeping: last down-window index counted / severed, so
        # each odd window is metered once and severs exactly one connection
        self.hb_cycle = -1
        self.sever_cycle = -1


class FaultPlan:
    """Parsed ``TOS_FAULTINJECT`` spec with deterministic counters."""

    _KEYS = {"kill": "after_batches",
             "drop_heartbeats": "count",
             "sever": "after_data_ops",
             # SIGKILL mid-collective: fires inside the Nth all-reduce, after
             # the first chunk exchange (ops.py), so partial gradient chunks
             # are genuinely in flight when the process dies — the round the
             # generation-barrier rejoin must fence and survive
             "kill_collective": "after_rounds",
             # crash the control-plane server on its Nth dispatched op
             # (coordinator._dispatch) — the journaled-recovery chaos clock
             "kill_coordinator": "after_ops",
             # gray failure: go silent for `secs` inside the Nth all-reduce
             # (same seam as kill_collective) — alive, heartbeating, not
             # moving bytes; straggler detection must evict, not thrash
             "stall_collective": "after_rounds",
             # continuous network degradation: the "threshold" is the
             # parameter (ms of latency / seconds of flap period), not a
             # count — see _CONTINUOUS
             "delay_net": "ms",
             "slow_peer": "ms",
             "flap": "period",
             # candidate-bundle regression: nan=1 corrupts outputs, the
             # ms= extra inflates latency — fires only while the serving
             # replica is on a rollout CANDIDATE bundle (see serving/loop)
             "bad_model": "nan",
             # driver-side tenant-flood amplifier: every token-bucket
             # charge for the targeted tenant is multiplied by `mult`
             "hot_tenant": "mult"}
    # optional secondary keys per action (float-valued)
    _EXTRA_KEYS = {"stall_collective": frozenset({"secs"}),
                   "bad_model": frozenset({"ms"})}
    # optional string-valued keys per action (never int-coerced)
    _STR_KEYS = {"hot_tenant": frozenset({"tenant"})}
    # one-shot actions fire once when the counter REACHES the threshold;
    # windowed actions fire on EVERY call until the threshold is spent
    # (drop_heartbeats swallows the first K pings — one dropped ping would
    # never outlast the driver's dead-node timeout)
    _WINDOWED = frozenset({"drop_heartbeats"})
    # continuous actions never "fire and disarm": they degrade the process
    # for its whole life (delay_net / slow_peer / bad_model / hot_tenant)
    # or on a periodic schedule (flap)
    _CONTINUOUS = frozenset({"delay_net", "slow_peer", "flap", "bad_model",
                             "hot_tenant"})

    def __init__(self, actions: list[_Action]):
        self._lock = tos_named_lock("faultinject._lock")
        self._actions = actions
        self._executor_id: int | None = None
        self._incarnation = 0
        self._role = ""
        self._t0 = time.monotonic()  # flap phase anchor (arming time)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        actions: list[_Action] = []
        for chunk in spec.split(";"):
            chunk = chunk.strip()
            if not chunk:
                continue
            name, _, rest = chunk.partition(":")
            name = name.strip()
            if name not in cls._KEYS:
                raise ValueError(
                    f"unknown fault action {name!r} in {spec!r} "
                    f"(known actions: {', '.join(sorted(cls._KEYS))})")
            kv = {}
            role: str | None = None
            for pair in filter(None, (p.strip() for p in rest.split(","))):
                k, _, v = pair.partition("=")
                k = k.strip()
                if k == "role":
                    # role filter (string-valued): fire only in processes
                    # whose ASSIGNED cluster role matches — the idiom for
                    # targeting the data-service tier, whose role is
                    # registration-order and so cannot ride per_node_env
                    role = v.strip()
                    continue
                # secondary parameters (e.g. stall secs) may be fractional
                # and a few (e.g. hot_tenant's tenant=) are strings;
                # thresholds/filters stay integral
                if k in cls._STR_KEYS.get(name, frozenset()):
                    kv[k] = v.strip()
                else:
                    kv[k] = (float(v)
                             if k in cls._EXTRA_KEYS.get(name, frozenset())
                             else int(v))
            threshold = kv.pop(cls._KEYS[name], 1)
            executor = kv.pop("executor", None)
            incarnation = kv.pop("incarnation", None)
            extra = {k: kv.pop(k) for k in list(kv)
                     if k in (cls._EXTRA_KEYS.get(name, frozenset())
                              | cls._STR_KEYS.get(name, frozenset()))}
            if kv:
                raise ValueError(f"unknown keys {sorted(kv)} for fault {name!r}")
            actions.append(_Action(name, threshold, executor, incarnation,
                                   role, extra))
        return cls(actions)

    def set_identity(self, executor_id: int, incarnation: int = 0,
                     role: str = "") -> None:
        with self._lock:
            self._executor_id = executor_id
            self._incarnation = incarnation
            self._role = role

    def _tick(self, name: str) -> "_Action | None":
        """Advance the named action's counter; the fired action (truthy)
        when it fires this call, else None."""
        with self._lock:
            for a in self._actions:
                if a.name != name or a.fired:
                    continue
                if a.executor is not None and a.executor != self._executor_id:
                    continue
                if a.incarnation is not None and a.incarnation != self._incarnation:
                    continue
                if a.role is not None and a.role != self._role:
                    continue
                a.count += 1
                if a.name in self._WINDOWED:
                    if a.count >= a.threshold:
                        a.fired = True
                    self._count_injection(name)
                    return a
                if a.count >= a.threshold:
                    a.fired = True
                    self._count_injection(name)
                    return a
        return None

    def _armed(self, name: str) -> _Action | None:
        """The identity-matched action of a CONTINUOUS kind, else None."""
        with self._lock:
            for a in self._actions:
                if a.name != name:
                    continue
                if a.executor is not None and a.executor != self._executor_id:
                    continue
                if a.incarnation is not None and a.incarnation != self._incarnation:
                    continue
                if a.role is not None and a.role != self._role:
                    continue
                return a
        return None

    def delay_ms(self, name: str = "delay_net") -> int:
        """Injected per-send latency (``delay_net:ms=M`` on the control/data
        planes, ``slow_peer:ms=M`` on the collective peer plane), 0 when
        unarmed.  Metered once at first delay (flight event) and per
        delayed send (``faultinject.delayed_sends`` counter) — the caller
        sleeps."""
        a = self._armed(name)
        if a is None:
            return 0
        with self._lock:
            first = not a.fired
            a.fired = True
            a.count += 1
        if first:
            self._count_injection(name)
        return a.threshold

    def stall_secs(self) -> float:
        """Seconds the ``stall_collective`` gray fault wants this process to
        go silent for, when its round counter fires NOW; 0.0 otherwise."""
        a = self._tick("stall_collective")
        if a is None:
            return 0.0
        return float(a.extra.get("secs", 300))

    def _flap_window(self, a: _Action) -> tuple[int, bool]:
        """(window index since arming, is this a DOWN window)."""
        period = max(1, a.threshold)
        cycle = int((time.monotonic() - self._t0) // period)
        return cycle, cycle % 2 == 1

    def flap_down(self) -> bool:
        """True while inside a flap DOWN window (liveness pings swallowed);
        each down window is metered once."""
        a = self._armed("flap")
        if a is None:
            return False
        cycle, down = self._flap_window(a)
        if down:
            with self._lock:
                count = a.hb_cycle != cycle
                a.hb_cycle = cycle
            if count:
                self._count_injection("flap")
        return down

    def flap_sever(self) -> bool:
        """True exactly once per flap DOWN window on the data plane: the
        window's first data-carrying op severs its connection; the rest of
        the window (and every even window) passes — the re-admit phase."""
        a = self._armed("flap")
        if a is None:
            return False
        cycle, down = self._flap_window(a)
        if not down:
            return False
        with self._lock:
            if a.sever_cycle == cycle:
                return False
            a.sever_cycle = cycle
        return True

    @staticmethod
    def _count_injection(name: str) -> None:
        """Meter the fired fault (telemetry): chaos tests assert recovery
        counters against these, and a soak run's report shows how many
        faults it actually exercised.  A ``kill`` SIGKILLs before the next
        heartbeat can ship the count — that loss is the fault's own point
        (which is exactly why the flight recorder dumps to DISK before a
        kill: see ``batch_consumed``)."""
        from tensorflowonspark_torch import telemetry
        from tensorflowonspark_torch.telemetry import trace as ttrace

        telemetry.counter("faultinject.injected_total").inc()
        telemetry.counter(f"faultinject.injected.{name}").inc()
        ttrace.event("fault", action=name, pid=os.getpid())


_PLAN: FaultPlan | None = None
# Flight-recorder postmortem path (node_main sets it from the cluster's
# log_dir): a `kill` dumps the process's recent spans + events here in the
# instant before SIGKILL — the ONE artifact a kill cannot destroy, since
# SIGKILL forecloses every in-memory channel (heartbeats, deregister).
_FLIGHT_DUMP_PATH: str | None = None
_FLIGHT_DUMP_NODE: str = ""


def set_flight_dump(path: str | None, node: str = "") -> None:
    """Where (and as whom) this process should dump its flight recorder if
    a ``kill`` fault fires."""
    global _FLIGHT_DUMP_PATH, _FLIGHT_DUMP_NODE
    _FLIGHT_DUMP_PATH = path
    _FLIGHT_DUMP_NODE = node


def init_from_env(force: bool = False) -> None:
    """Parse ``TOS_FAULTINJECT`` (call after per-node env is applied)."""
    global _PLAN
    if _PLAN is not None and not force:
        return
    from tensorflowonspark_torch.utils.envtune import env_str

    spec = env_str("TOS_FAULTINJECT", "")
    if not spec:
        _PLAN = None
        return
    _PLAN = FaultPlan.parse(spec)
    logger.warning("fault injection armed: %s=%r", ENV_VAR, spec)


def set_identity(executor_id: int, incarnation: int = 0,
                 role: str = "") -> None:
    if _PLAN is not None:
        _PLAN.set_identity(executor_id, incarnation, role=role)


def _sigkill_self() -> None:
    """SIGKILL this process — the most brutal death available: no atexit,
    no deregister, no flush, exactly what a preempted VM looks like.  The
    one concession: the flight recorder dumps to disk first (a real
    preemption grants no such grace, but the dump is the postmortem
    artifact the chaos tests and operators read — and it costs
    microseconds)."""
    logger.warning("fault injection: SIGKILL self (pid %d)", os.getpid())
    if _FLIGHT_DUMP_PATH:
        try:
            from tensorflowonspark_torch.telemetry import trace as ttrace

            ttrace.dump_flight(_FLIGHT_DUMP_PATH, node=_FLIGHT_DUMP_NODE)
        except Exception:  # noqa: BLE001 - the kill must still fire
            logger.warning("flight dump before kill failed", exc_info=True)
    os.kill(os.getpid(), signal.SIGKILL)


def batch_consumed() -> None:
    """Hook: one feed batch fully consumed by the map_fun; ``kill`` fires
    here with SIGKILL (see :func:`_sigkill_self`)."""
    if _PLAN is not None and _PLAN._tick("kill"):
        _sigkill_self()


def collective_round() -> None:
    """Hook: mid-collective — called once per all-reduce, after the first
    chunk exchange (``collective/ops.py``); ``kill_collective`` SIGKILLs
    here, dying with partial chunks on the wire and peers blocked in the
    same round (the poisoned-round case incarnation fencing + the
    generation barrier exist for).  ``stall_collective`` fires at the same
    seam but SLEEPS instead of dying — the gray failure: partial chunks in
    flight, heartbeats still flowing, peers blocked on a member that is
    slow, not dead (the case quorum eviction exists for)."""
    if _PLAN is None:
        return
    if _PLAN._tick("kill_collective"):
        _sigkill_self()
    secs = _PLAN.stall_secs()
    if secs > 0:
        logger.warning("fault injection: stalling collective for %.1fs "
                       "(gray failure; pid %d)", secs, os.getpid())
        time.sleep(secs)
        logger.warning("fault injection: collective stall over (pid %d)",
                       os.getpid())


def peer_send_delay() -> None:
    """Hook: about to ship a chunk frame on the collective peer plane
    (``collective/transport.PeerTransport.send``); ``slow_peer:ms=M``
    sleeps M milliseconds here — the degraded-NIC gray fault."""
    if _PLAN is None:
        return
    ms = _PLAN.delay_ms("slow_peer")
    if ms:
        from tensorflowonspark_torch import telemetry

        telemetry.counter("faultinject.delayed_sends").inc()
        time.sleep(ms / 1000.0)


def drop_heartbeat() -> bool:
    """Hook: about to send a liveness ping; True = swallow it (the counted
    ``drop_heartbeats`` action, or a ``flap`` DOWN window)."""
    if _PLAN is None:
        return False
    return bool(_PLAN._tick("drop_heartbeats")) or _PLAN.flap_down()


def data_op() -> None:
    """Hook: a data-carrying op (feed / infer_send) reached the node's data
    server; ``sever`` (or the first op of a ``flap`` DOWN window) raises so
    the connection closes with no reply."""
    if _PLAN is None:
        return
    if _PLAN._tick("sever"):
        raise FaultInjected("severing data-plane connection (TOS_FAULTINJECT)")
    if _PLAN.flap_sever():
        raise FaultInjected("flap window severing data-plane connection "
                            "(TOS_FAULTINJECT)")


def coordinator_op() -> bool:
    """Hook: a control-plane request reached the coordinator's dispatcher;
    True = ``kill_coordinator`` fires now (the server crash()es itself —
    the journaled-recovery path owns what happens next)."""
    return _PLAN is not None and bool(_PLAN._tick("kill_coordinator"))


def bad_model(candidate: bool) -> tuple[bool, float]:
    """Hook: one serving micro-batch is about to be answered
    (``serving/loop.py``); returns ``(corrupt_outputs, extra_latency_secs)``.
    Fires only while the replica serves a rollout CANDIDATE bundle
    (``candidate`` — the reload control item carried the bit), so the
    injected regression models a bad export, never a bad fleet: primary
    replicas keep answering correctly while the canary cohort degrades."""
    if _PLAN is None or not candidate:
        return False, 0.0
    a = _PLAN._armed("bad_model")
    if a is None:
        return False, 0.0
    with _PLAN._lock:
        first = not a.fired
        a.fired = True
        a.count += 1
    if first:
        _PLAN._count_injection("bad_model")
    return bool(a.threshold), float(a.extra.get("ms", 0.0)) / 1e3


def tenant_charge_mult(tenant: str) -> int:
    """Hook: the serving admission path is about to charge ``tenant``'s
    token bucket (``serving/tenancy.py``); returns the charge multiplier
    (1 = unarmed).  ``hot_tenant:mult=K,tenant=T`` makes tenant T's real
    load present as K× its rate budget — the deterministic stand-in for a
    flooding client."""
    if _PLAN is None:
        return 1
    a = _PLAN._armed("hot_tenant")
    if a is None:
        return 1
    target = a.extra.get("tenant", "")
    if target and target != tenant:
        return 1
    with _PLAN._lock:
        first = not a.fired
        a.fired = True
        a.count += 1
    if first:
        _PLAN._count_injection("hot_tenant")
    return max(1, a.threshold)


def net_delay() -> None:
    """Hook: about to send on the control plane (or serve a data op);
    ``delay_net:ms=M`` sleeps M milliseconds here — injected wire latency
    for the armed process."""
    if _PLAN is None:
        return
    ms = _PLAN.delay_ms()
    if ms:
        from tensorflowonspark_torch import telemetry

        telemetry.counter("faultinject.delayed_sends").inc()
        time.sleep(ms / 1000.0)
