"""Process-local metrics primitives — stdlib-only, hot-path-safe.

The data plane meters every frame it sends (dataserver.py), so the
primitives here are designed around one constraint: an increment on the hot
path must cost nanoseconds and take **no lock**.

- ``Counter``: per-thread cells.  Each thread mutates only its own dict
  slot (``cells[tid] = cells.get(tid, 0) + n`` — the owning thread is the
  only writer of that key, and dict item assignment is atomic under the
  GIL), so ``inc()`` is lock-free AND exact: no increment can be lost to a
  read-modify-write race the way a shared ``self._value += n`` could.
  ``value()`` sums the cells.
- ``Gauge``: last-write-wins float (a single attribute store is atomic).
- ``Histogram``: bounded reservoir (Algorithm R, deterministic per-name
  seed) + running count/sum/min/max digest, guarded by a small lock —
  histograms meter *spans* (rendezvous latency, per-partition feed time),
  which are orders of magnitude rarer than data-plane increments.
- ``timed(name)``: context manager observing its wall duration into a
  histogram.

``MetricsRegistry`` interns one instance per metric name and renders
JSON-safe snapshots for the control plane (the coordinator heartbeat
piggyback in ``node.py`` — see ``collect_changed``).  A disabled registry
(``TOS_METRICS=0``) hands out shared no-op singletons so instrumented code
pays only a dict miss.
"""

from __future__ import annotations

import random
import threading
import time
import zlib
from typing import Any, Iterable

# Default bounded-reservoir size: enough for stable p99 estimates on the
# span histograms while keeping a snapshot's wire footprint small.
RESERVOIR_SIZE = 256
# Per-collection cap on the "recent samples" outbox that rides heartbeats
# (the coordinator pools these for cluster-wide percentiles).
OUTBOX_SIZE = 64


class Counter:
    """Monotonic counter with lock-free, exact increments (see module doc)."""

    __slots__ = ("name", "_cells")

    def __init__(self, name: str):
        self.name = name
        self._cells: dict[int, int] = {}

    def inc(self, amount: int = 1) -> None:
        cells = self._cells
        tid = threading.get_ident()
        cells[tid] = cells.get(tid, 0) + amount

    def value(self) -> int:
        while True:
            try:
                return sum(self._cells.values())
            except RuntimeError:
                # a thread inserted its first cell mid-iteration; reread
                continue


class Gauge:
    """Last-write-wins instantaneous value (attribute store is atomic)."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value: float | None = None

    def set(self, value: float) -> None:
        self._value = float(value)

    def value(self) -> float | None:
        return self._value


class Histogram:
    """Running digest + bounded reservoir of observed values (spans)."""

    __slots__ = ("name", "_lock", "count", "total", "min", "max",
                 "_reservoir", "_reservoir_size", "_rng", "_outbox")

    def __init__(self, name: str, reservoir_size: int = RESERVOIR_SIZE):
        self.name = name
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0
        self.min: float | None = None
        self.max: float | None = None
        self._reservoir: list[float] = []
        self._reservoir_size = reservoir_size
        # deterministic per-name stream so identical runs sample identically
        # (crc32, not hash(): str hashing is per-process randomized)
        self._rng = random.Random(0xC0FFEE ^ zlib.crc32(name.encode("utf-8")))
        self._outbox: list[float] = []

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self.count += 1
            self.total += value
            if self.min is None or value < self.min:
                self.min = value
            if self.max is None or value > self.max:
                self.max = value
            if len(self._reservoir) < self._reservoir_size:
                self._reservoir.append(value)
            else:
                # Algorithm R: keep each of the N observations with
                # probability reservoir_size/N
                idx = self._rng.randrange(self.count)
                if idx < self._reservoir_size:
                    self._reservoir[idx] = value
            if len(self._outbox) < OUTBOX_SIZE:
                self._outbox.append(value)

    def percentile(self, q: float) -> float | None:
        """Estimate the q-th percentile (0..100) from the reservoir."""
        with self._lock:
            samples = sorted(self._reservoir)
        return percentile_of(samples, q)

    def digest(self) -> dict:
        """JSON-safe running summary (no samples)."""
        with self._lock:
            return {"count": self.count, "sum": self.total,
                    "min": self.min, "max": self.max}

    def drain_outbox(self) -> list[float]:
        """Samples observed since the last drain (capped at OUTBOX_SIZE);
        the wire-delta path ships these for cluster-wide percentiles."""
        with self._lock:
            out, self._outbox = self._outbox, []
            return out

    def restore_outbox(self, samples: list[float]) -> None:
        """Give drained samples back (the carrying send failed) so the
        cluster percentile pool doesn't silently lose them; bounded — on
        overflow the oldest restored samples are dropped."""
        with self._lock:
            merged = list(samples) + self._outbox
            self._outbox = merged[-OUTBOX_SIZE:]

    def reservoir(self) -> list[float]:
        with self._lock:
            return list(self._reservoir)


def percentile_of(samples: list[float], q: float) -> float | None:
    """Nearest-rank percentile of an already-sorted sample list."""
    if not samples:
        return None
    if len(samples) == 1:
        return samples[0]
    rank = (q / 100.0) * (len(samples) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(samples) - 1)
    frac = rank - lo
    return samples[lo] * (1.0 - frac) + samples[hi] * frac


class _Timer:
    """``with registry.timed(name):`` — observes wall seconds on exit."""

    __slots__ = ("_hist", "_t0")

    def __init__(self, hist):
        self._hist = hist

    def __enter__(self) -> "_Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._hist.observe(time.perf_counter() - self._t0)


# -- no-op variants (TOS_METRICS=0) -------------------------------------------


class _NullCounter:
    __slots__ = ()
    name = "<disabled>"

    def inc(self, amount: int = 1) -> None:
        return None

    def value(self) -> int:
        return 0


class _NullGauge:
    __slots__ = ()
    name = "<disabled>"

    def set(self, value: float) -> None:
        return None

    def value(self) -> None:
        return None


class _NullHistogram:
    __slots__ = ()
    name = "<disabled>"
    count = 0
    total = 0.0
    min = None
    max = None

    def observe(self, value: float) -> None:
        return None

    def percentile(self, q: float) -> None:
        return None

    def digest(self) -> dict:
        return {"count": 0, "sum": 0.0, "min": None, "max": None}

    def drain_outbox(self) -> list:
        return []

    def restore_outbox(self, samples: list) -> None:
        return None

    def reservoir(self) -> list:
        return []


class _NullTimer:
    __slots__ = ()

    def __enter__(self) -> "_NullTimer":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_HISTOGRAM = _NullHistogram()
_NULL_TIMER = _NullTimer()


class MetricsRegistry:
    """Process-local registry interning one metric object per name."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()  # creation only — never the hot path
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    # -- metric accessors (hot path: one dict get) ---------------------------

    def counter(self, name: str) -> Counter | _NullCounter:
        if not self.enabled:
            return _NULL_COUNTER
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge | _NullGauge:
        if not self.enabled:
            return _NULL_GAUGE
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str) -> Histogram | _NullHistogram:
        if not self.enabled:
            return _NULL_HISTOGRAM
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram(name))
        return h

    def timed(self, name: str) -> _Timer | _NullTimer:
        if not self.enabled:
            return _NULL_TIMER
        return _Timer(self.histogram(name))

    # -- snapshots -----------------------------------------------------------

    def snapshot(self, include_samples: bool = False) -> dict:
        """Full JSON-safe snapshot: ``{"counters": {name: int},
        "gauges": {name: float}, "histograms": {name: digest}}``.
        ``include_samples=True`` adds each histogram's reservoir under
        ``"recent"`` (the shape the cluster aggregation pools)."""
        counters = {n: c.value() for n, c in list(self._counters.items())}
        gauges = {n: g.value() for n, g in list(self._gauges.items())
                  if g.value() is not None}
        hists = {}
        for n, h in list(self._histograms.items()):
            d = h.digest()
            if not d["count"]:
                continue
            if include_samples:
                d["recent"] = h.reservoir()
            hists[n] = d
        return {"counters": counters, "gauges": gauges, "histograms": hists}

    def collect_changed(self, last: dict | None) -> tuple[dict, dict]:
        """Compact wire delta for the heartbeat piggyback.

        Returns ``(payload, state)``: ``payload`` holds only the entries
        whose cumulative value moved since ``last`` (the previous call's
        returned ``state``) — but every value in it is **absolute**, so the
        receiver merges by replacement and a lost heartbeat can never lose
        counts.  Histograms additionally carry the samples observed since
        the last drain (``"recent"``, capped) for cluster-wide percentiles.
        """
        last = last or {"counters": {}, "gauges": {}, "hist_counts": {}}
        payload: dict = {}
        counters = {n: c.value() for n, c in list(self._counters.items())}
        changed_c = {n: v for n, v in counters.items()
                     if v != last["counters"].get(n)}
        if changed_c:
            payload["counters"] = changed_c
        gauges = {n: g.value() for n, g in list(self._gauges.items())
                  if g.value() is not None}
        changed_g = {n: v for n, v in gauges.items()
                     if v != last["gauges"].get(n)}
        if changed_g:
            payload["gauges"] = changed_g
        hist_counts: dict[str, int] = {}
        changed_h: dict[str, dict] = {}
        for n, h in list(self._histograms.items()):
            d = h.digest()
            hist_counts[n] = d["count"]
            if not d["count"] or d["count"] == last["hist_counts"].get(n):
                continue
            recent = h.drain_outbox()
            if recent:
                d["recent"] = recent
            changed_h[n] = d
        if changed_h:
            payload["histograms"] = changed_h
        state = {"counters": counters, "gauges": gauges,
                 "hist_counts": hist_counts}
        return payload, state

    def drain_recent(self) -> dict[str, list[float]]:
        """Drain every histogram's outbox: the samples observed since the
        last drain, per name.  Used by the DRIVER's rolling-stats sampler
        (the driver sends no heartbeats, so its outboxes have no other
        consumer); node processes must leave this to ``collect_changed``."""
        out: dict[str, list[float]] = {}
        for name, h in list(self._histograms.items()):
            recent = h.drain_outbox()
            if recent:
                out[name] = recent
        return out

    def restore_recent(self, payload: dict | None) -> None:
        """Return a failed delta's drained histogram samples to their
        outboxes (``collect_changed`` drains destructively, and counters/
        digests re-send themselves by being absolute — samples are the one
        thing a lost ping would otherwise lose)."""
        for name, d in ((payload or {}).get("histograms") or {}).items():
            recent = d.get("recent")
            if recent:
                self.histogram(name).restore_outbox(recent)

    def reset(self) -> None:
        """Drop every metric (tests / the bench's on-vs-off comparison)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


def iter_metric_names(snapshot: dict) -> Iterable[tuple[str, str, Any]]:
    """(kind, name, value/digest) triples of one snapshot, sorted."""
    for kind in ("counters", "gauges", "histograms"):
        for name in sorted(snapshot.get(kind) or {}):
            yield kind, name, snapshot[kind][name]
