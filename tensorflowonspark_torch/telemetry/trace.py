"""Sampled distributed tracing + flight recorder — the "where did it go" half
of the telemetry subsystem (stdlib-only).

The metrics registry (``registry.py``) answers "how much"; this module
answers "where did this request's 40 ms go" and "what happened in the 2 s
before that node died":

- **Spans** — structured records ``(trace_id, span_id, parent, monotonic
  start, duration, tags)`` written into **lock-free per-thread bounded
  rings**: each thread appends only to its own ring (list-slot assignment
  is atomic under the GIL, mirroring the registry's per-thread counter
  cells), so recording a span on the serving hot path costs an append and
  never takes a lock.  A full ring overwrites its oldest entries; the
  drain reports how many were lost.
- **Sampling** — ``TOS_TRACE`` (default off) gates everything; when on,
  ``TOS_TRACE_SAMPLE`` picks every ``round(1/rate)``-th root
  deterministically (a counter, not an RNG — identical runs sample
  identical requests, which is what the trace tests pin).  Child spans
  never re-sample: a context handed across threads/processes means the
  root already won the lottery.
- **Context propagation** — a :class:`TraceContext` is a plain
  ``(trace_id, span_id)`` pair, JSON- and pickle-safe, carried in wire
  frames (v3 ``infer_round``/``end_partition``) and queue markers so one
  request's spans assemble across processes.
- **Flight recorder** — every process keeps a separate bounded ring of
  structured *events* (deaths, restarts, retries, resyncs, reloads, fault
  injections; ``TOS_FLIGHT_EVENTS`` sizes it, 0 disables) independent of
  the trace switch, plus ``flight_snapshot()``/``dump_flight()`` so a
  chaos exit leaves a readable timeline behind.
- **Transport** — ``collect_delta()`` drains new spans/events for the
  heartbeat piggyback (``node.py``), stamped with this process's current
  clock-offset estimate (driver-monotonic = local-monotonic + offset, the
  NTP-style midpoint estimate from heartbeat RTTs) so the export can
  merge per-node streams onto one timeline (``trace_export.py``).

Disabled (the default), every accessor returns ``None`` / a shared no-op
span, so instrumented code pays one attribute check.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, NamedTuple

#: Per-thread span-ring capacity: recent-window postmortems need seconds of
#: history, the heartbeat drain empties it every ~2s — 2048 spans/thread
#: absorbs bursts well past both.
RING_SIZE = 2048
#: Max spans shipped per heartbeat delta (the rest ride the next one, or are
#: counted dropped by the ring overwrite if the producer outruns the drain).
DRAIN_SPAN_CAP = 1024
#: Flight-event ring default capacity (TOS_FLIGHT_EVENTS overrides; 0 off).
FLIGHT_EVENTS_DEFAULT = 256


class TraceContext(NamedTuple):
    """Wire-portable span identity: share ``trace_id``, parent ``span_id``.

    Serialized as a plain 2-tuple (pickle) / 2-list (JSON); ``coerce``
    accepts either back.
    """

    trace_id: int
    span_id: int

    @classmethod
    def coerce(cls, value) -> "TraceContext | None":
        if value is None:
            return None
        try:
            tid, sid = value
            return cls(int(tid), int(sid))
        except (TypeError, ValueError):
            return None


class _Ring:
    """Bounded append-only ring owned by ONE writer thread.

    ``buf[n % cap] = item; n += 1`` — the owning thread is the only writer,
    slot assignment is atomic under the GIL, and readers (the drain, the
    flight snapshot) tolerate racing a concurrent overwrite: they read
    whole immutable dicts, either the old span or the new one.
    """

    __slots__ = ("buf", "cap", "n", "owner")

    def __init__(self, cap: int):
        self.buf: list = [None] * cap
        self.cap = cap
        self.n = 0
        self.owner: threading.Thread | None = None  # writer, for dead-ring pruning

    def append(self, item) -> None:
        self.buf[self.n % self.cap] = item
        self.n += 1

    def read_from(self, cursor: int) -> tuple[list, int, int]:
        """(items, new_cursor, dropped) — entries appended since ``cursor``
        that are still in the ring."""
        n = self.n  # snapshot; concurrent appends land in the next drain
        start = max(cursor, n - self.cap)
        items = [self.buf[i % self.cap] for i in range(start, n)]
        return [x for x in items if x is not None], n, start - cursor

    def tail(self, limit: int) -> list:
        n = self.n
        start = max(0, n - min(self.cap, limit))
        return [x for x in (self.buf[i % self.cap] for i in range(start, n))
                if x is not None]


class _LiveSpan:
    """``with tracer.span(name, parent=ctx):`` — times the block and records
    it on exit; ``.ctx`` is the context to hand to children (including
    remote ones, before the span ends)."""

    __slots__ = ("_tracer", "name", "ctx", "_parent", "_tags", "_t0")

    def __init__(self, tracer: "Tracer", name: str, ctx: TraceContext,
                 parent: int | None, tags: dict | None):
        self._tracer = tracer
        self.name = name
        self.ctx = ctx
        self._parent = parent
        self._tags = tags

    def __enter__(self) -> "_LiveSpan":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self._tracer.record_span(self.name, self.ctx, self._parent,
                                 self._t0, time.monotonic() - self._t0,
                                 self._tags)


class _NullSpan:
    """Shared no-op stand-in: disabled tracer / unsampled request."""

    __slots__ = ()
    ctx = None
    name = "<off>"

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


NULL_SPAN = _NullSpan()


class Tracer:
    """Process-local trace recorder (one per process, like the metrics
    registry).  All public methods are safe to call with tracing disabled —
    they return ``None``/no-ops and cost an attribute check."""

    def __init__(self, enabled: bool = False, sample: float = 0.01,
                 flight_events: int = FLIGHT_EVENTS_DEFAULT,
                 ring_size: int = RING_SIZE):
        self.enabled = bool(enabled)
        sample = min(1.0, float(sample))
        # deterministic counter sampling: every period-th root is traced
        self._period = max(1, round(1.0 / sample)) if sample > 0 else 0
        self._seq = itertools.count()        # CPython next() is atomic
        self._ids = itertools.count(1)
        # span ids carry per-process random high bits so two processes can
        # never mint the same id inside one merged trace; ids need no
        # determinism (sampling has it), so urandom is fine here
        self._id_base = int.from_bytes(os.urandom(6), "big") << 24
        self._ring_size = ring_size
        self._local = threading.local()
        self._rings_lock = threading.Lock()
        self._rings: list[_Ring] = []
        self._cursors: dict[int, int] = {}   # id(ring) -> drain cursor
        self.dropped = 0                     # spans lost to ring overwrite
        # drained-but-unshipped carryover (span-cap overflow, failed
        # heartbeat restore) — owned by the single drain thread, like
        # ``_cursors``; bounded so a dead coordinator can't grow it forever
        self._pending_spans: list = []
        self._pending_events: list = []
        # flight events: rare, multi-writer -> one small locked ring
        self._events_cap = max(0, int(flight_events))
        self._events = _Ring(self._events_cap) if self._events_cap else None
        self._events_lock = threading.Lock()
        self._events_cursor = 0
        #: driver-monotonic = local-monotonic + offset (heartbeat RTT
        #: midpoint estimate; None until the first heartbeat, 0.0 on the
        #: driver itself).  Last-write-wins float: atomic attribute store.
        self.clock_offset: float | None = None
        self.clock_rtt: float | None = None

    # -- id allocation / sampling ---------------------------------------------

    def _new_id(self) -> int:
        # addition, not OR: injective for ANY counter value, so a process
        # that mints more than 2^24 ids (long fully-sampled soak) can never
        # alias an earlier id — OR would wrap into the base bits
        return self._id_base + next(self._ids)

    def sample(self) -> TraceContext | None:
        """Root sampling decision: a fresh root context for every
        ``round(1/TOS_TRACE_SAMPLE)``-th call, else None.  Deterministic —
        a counter, not an RNG."""
        if not self.enabled or not self._period:
            return None
        if next(self._seq) % self._period:
            return None
        return TraceContext(self._new_id(), self._new_id())

    def derive(self, parent: TraceContext | None) -> TraceContext | None:
        """A child context under ``parent`` (same trace, fresh span id) —
        for spans whose context must exist before they end."""
        if not self.enabled or parent is None:
            return None
        return TraceContext(parent[0], self._new_id())

    # -- recording ------------------------------------------------------------

    def _ring(self) -> _Ring:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            ring = _Ring(self._ring_size)
            ring.owner = threading.current_thread()
            self._local.ring = ring
            with self._rings_lock:
                self._rings.append(ring)
        return ring

    def record_span(self, name: str, ctx: TraceContext | None,
                    parent: int | None, t0: float, dur: float,
                    tags: dict | None = None) -> None:
        """Append one finished span.  No-op when disabled or ``ctx`` is
        None (the unsampled path), so call sites need no guard."""
        if not self.enabled or ctx is None:
            return
        span = {"n": name, "t": ctx[0], "s": ctx[1], "p": parent,
                "t0": t0, "d": dur, "th": threading.get_ident()}
        if tags:
            span["tags"] = tags
        self._ring().append(span)

    def record_child(self, name: str, parent: TraceContext | None,
                     t0: float, dur: float,
                     tags: dict | None = None) -> TraceContext | None:
        """Record a retrospective child span under ``parent``; returns the
        child's context (None when unsampled/disabled)."""
        ctx = self.derive(parent)
        if ctx is not None:
            self.record_span(name, ctx, parent[1], t0, dur, tags)
        return ctx

    def span(self, name: str, parent: TraceContext | None = None,
             tags: dict | None = None, root: bool = False):
        """Context manager timing a live block.  ``parent=None`` records
        nothing unless ``root=True``, which applies root sampling."""
        if not self.enabled:
            return NULL_SPAN
        if parent is None:
            if not root:
                return NULL_SPAN
            ctx = self.sample()
            if ctx is None:
                return NULL_SPAN
            return _LiveSpan(self, name, ctx, None, tags)
        return _LiveSpan(self, name, self.derive(parent), parent[1], tags)

    # -- flight recorder ------------------------------------------------------

    def event(self, kind: str, **fields) -> None:
        """Record one structured flight event (death/restart/retry/resync/
        reload/fault...).  Independent of the trace switch — gated only by
        ``TOS_FLIGHT_EVENTS`` (0 disables).  Rare by contract, so a small
        lock is fine."""
        if self._events is None:
            return
        ev = {"kind": kind, "t0": time.monotonic(), "wall": time.time()}
        if fields:
            ev.update(fields)
        with self._events_lock:
            self._events.append(ev)

    def flight_snapshot(self, span_limit: int = 512) -> dict:
        """Recent history for a postmortem dump: every flight event still in
        the ring plus the most recent spans of every thread, oldest first."""
        with self._events_lock:
            events = self._events.tail(self._events_cap) if self._events else []
        with self._rings_lock:
            rings = list(self._rings)
        spans: list = []
        for ring in rings:
            spans.extend(ring.tail(span_limit))
        spans.sort(key=lambda s: s["t0"])
        return {"events": list(events), "spans": spans,
                "clock_offset": self.clock_offset}

    # -- transport (heartbeat piggyback) --------------------------------------

    def collect_delta(self, span_cap: int = DRAIN_SPAN_CAP) -> dict | None:
        """New spans/events since the last collect, for the heartbeat
        piggyback; None when there is nothing to ship.  Spans only travel
        while tracing is on; flight events travel whenever their ring is
        enabled.  Single-consumer: the heartbeat thread (it owns the drain
        cursors and the pending carryover)."""
        payload: dict = {}
        if self.enabled:
            with self._rings_lock:
                rings = list(self._rings)
            spans, self._pending_spans = self._pending_spans, []
            dead: list[_Ring] = []
            for ring in rings:
                got, cursor, lost = ring.read_from(
                    self._cursors.get(id(ring), 0))
                self._cursors[id(ring)] = cursor
                self.dropped += lost
                spans.extend(got)
                # a dead writer appends nothing more: once its ring is fully
                # drained, drop it (a long soak with elastic restarts mints a
                # 2048-slot ring per short-lived recording thread otherwise)
                if (ring.owner is not None and not ring.owner.is_alive()
                        and cursor >= ring.n):
                    dead.append(ring)
            if dead:
                with self._rings_lock:
                    for ring in dead:
                        self._rings.remove(ring)
                        self._cursors.pop(id(ring), None)
            if spans:
                spans.sort(key=lambda s: s["t0"])
                if len(spans) > span_cap:
                    # overflow rides the next beat (bounded: past 4 beats'
                    # worth the oldest are dropped and counted)
                    carry = spans[:-span_cap]
                    spans = spans[-span_cap:]
                    excess = len(carry) - 4 * span_cap
                    if excess > 0:
                        self.dropped += excess
                        carry = carry[excess:]
                    self._pending_spans = carry
                payload["spans"] = spans
        if self._events is not None:
            events, self._pending_events = self._pending_events, []
            with self._events_lock:
                got_ev, self._events_cursor, _ = self._events.read_from(
                    self._events_cursor)
            events.extend(got_ev)
            if events:
                payload["events"] = events
        if not payload:
            return None
        if self.clock_offset is not None:
            payload["offset"] = self.clock_offset
            payload["rtt"] = self.clock_rtt
        if self.dropped:
            payload["dropped"] = self.dropped
        return payload

    def collect_final(self) -> dict | None:
        """Everything still unshipped, uncapped — the one-shot drain for
        paths with no next beat (deregister's final delta, the driver's
        export gather): the span-cap defer contract must not strand the
        carryover when this is the last collect."""
        return self.collect_delta(span_cap=1 << 62)

    def restore_delta(self, payload: dict | None) -> None:
        """Give a failed heartbeat's drained delta back so the next beat
        re-ships it: unlike metric deltas (absolute values, implicitly
        re-sent), drained spans and flight events are not re-derivable.
        Same single-consumer contract as ``collect_delta``."""
        if not payload:
            return
        spans = payload.get("spans")
        if spans:
            self._pending_spans = list(spans) + self._pending_spans
        events = payload.get("events")
        if events:
            self._pending_events = list(events) + self._pending_events

    def note_clock(self, offset: float, rtt: float) -> None:
        """Adopt a heartbeat's clock estimate when it beats (or refreshes)
        the current one: the lowest-RTT midpoint is the least skewed, but a
        stale low-RTT estimate must not pin forever against drift — a new
        reading within 2x the best RTT refreshes it, and every rejected
        reading relaxes the bar a little so a permanently degraded network
        (best-ever RTT no longer achievable) re-arms within ~15 beats
        instead of freezing the offset for the rest of the run."""
        best = self.clock_rtt
        if best is None or rtt <= 2.0 * best:
            self.clock_offset = float(offset)
            self.clock_rtt = float(rtt) if best is None else min(best, rtt)
        else:
            self.clock_rtt = best * 1.05


# -- process-local singleton ---------------------------------------------------

_lock = threading.Lock()
_tracer: Tracer | None = None


def get_tracer() -> Tracer:
    """The process tracer, created on first use from the TOS_TRACE knobs."""
    global _tracer
    t = _tracer
    if t is None:
        with _lock:
            if _tracer is None:
                from tensorflowonspark_torch.utils.envtune import (
                    env_bool,
                    env_float,
                    env_int,
                )

                _tracer = Tracer(
                    enabled=env_bool("TOS_TRACE", False),
                    sample=env_float("TOS_TRACE_SAMPLE", 0.01),
                    flight_events=env_int("TOS_FLIGHT_EVENTS",
                                          FLIGHT_EVENTS_DEFAULT, minimum=0))
            t = _tracer
    return t


def reset(enabled: bool | None = None, sample: float | None = None,
          flight_events: int | None = None) -> Tracer:
    """Replace the process tracer (tests / the bench's off-vs-on compare):
    re-reads the env knobs unless overridden."""
    global _tracer
    with _lock:
        from tensorflowonspark_torch.utils.envtune import (
            env_bool,
            env_float,
            env_int,
        )

        _tracer = Tracer(
            enabled=(env_bool("TOS_TRACE", False) if enabled is None
                     else enabled),
            sample=(env_float("TOS_TRACE_SAMPLE", 0.01) if sample is None
                    else sample),
            flight_events=(env_int("TOS_FLIGHT_EVENTS",
                                   FLIGHT_EVENTS_DEFAULT, minimum=0)
                           if flight_events is None else flight_events))
        return _tracer


def enabled() -> bool:
    return get_tracer().enabled


def sample() -> TraceContext | None:
    return get_tracer().sample()


def derive(parent: TraceContext | None) -> TraceContext | None:
    return get_tracer().derive(parent)


def span(name: str, parent: TraceContext | None = None,
         tags: dict | None = None, root: bool = False):
    return get_tracer().span(name, parent, tags, root=root)


def record_span(name: str, ctx: TraceContext | None, parent: int | None,
                t0: float, dur: float, tags: dict | None = None) -> None:
    get_tracer().record_span(name, ctx, parent, t0, dur, tags)


def record_child(name: str, parent: TraceContext | None, t0: float,
                 dur: float, tags: dict | None = None) -> TraceContext | None:
    return get_tracer().record_child(name, parent, t0, dur, tags)


def event(kind: str, **fields) -> None:
    get_tracer().event(kind, **fields)


def collect_delta() -> dict | None:
    return get_tracer().collect_delta()


def collect_final() -> dict | None:
    return get_tracer().collect_final()


def flight_snapshot(span_limit: int = 512) -> dict:
    return get_tracer().flight_snapshot(span_limit)


def dump_flight(path: str, node: str = "") -> str:
    """Write this process's flight snapshot as JSON (the chaos-exit
    postmortem; ``faultinject`` calls this in the instant before a
    self-SIGKILL).  Returns ``path``."""
    snap = flight_snapshot()
    snap["schema"] = "tos-flight-v1"
    snap["node"] = node
    snap["pid"] = os.getpid()
    with open(path, "w", encoding="utf-8") as f:
        json.dump(snap, f)
        f.write("\n")
    return path


def map_time(t0: float, offset: float | None) -> float:
    """Local monotonic -> driver-monotonic (identity when no estimate)."""
    return t0 + (offset or 0.0)


def event_origin(key: str) -> str:
    """The recording process behind a stream key: a chaos dump
    (``flight:node0``) and the heartbeat-shipped stream (``node0``) share
    one origin, so their common events can be deduplicated."""
    return key[len("flight:"):] if key.startswith("flight:") else key


def merge_events(streams: dict[str, dict]) -> list[dict]:
    """Flatten per-stream flight events onto the driver timeline: each
    event gains ``node`` and ``t`` (driver-monotonic seconds), ordered by
    ``t``.  ``streams`` maps a node key to ``{"events": [...],
    "offset": float|None}`` (the trace-stream / flight-dump shape).

    A chaos dump repeats events its process already shipped on heartbeats
    (the drain advances a cursor, the dump tails the whole ring), so events
    identical per origin are emitted once — heartbeat copy preferred (its
    stream carries them with the offset they shipped under)."""
    out: list[dict] = []
    seen: set = set()
    for key in sorted(streams, key=lambda k: (k.startswith("flight:"), k)):
        stream = streams[key]
        offset = stream.get("clock_offset", stream.get("offset"))
        for ev in stream.get("events") or ():
            ident = (event_origin(key), ev.get("kind"), ev.get("t0"),
                     ev.get("wall"))
            if ident in seen:
                continue
            seen.add(ident)
            ev = dict(ev)
            ev["node"] = key
            ev["t"] = map_time(float(ev.get("t0", 0.0)), offset)
            out.append(ev)
    out.sort(key=lambda e: e["t"])
    return out


def coerce_context(value: Any) -> TraceContext | None:
    """Best-effort TraceContext from a wire value (tuple/list/None)."""
    return TraceContext.coerce(value)
