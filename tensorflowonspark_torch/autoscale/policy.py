"""Autoscaling policies + the hysteresis governor.

A *policy* maps one ``cluster.stats(window)`` snapshot to a desired node
count — pure, stateless, unit-testable with literal dicts.  The
*governor* owns the state machine that keeps a policy from flapping:
cooldown after any action, K-consecutive-windows evidence before a
scale-in, min/max clamping.  The :class:`~tensorflowonspark_torch.autoscale.
loop.Autoscaler` composes the two over a live cluster.

The split mirrors tf.data's autotuning (Murray et al., 2101.12127): the
signal model (occupancy, latency) is separate from the actuation schedule,
so policies stay one-screen readable and the anti-flap logic is tested
once.  Lineage for the signals themselves: ``serving.queue_depth`` is the
gateway's admission-queue occupancy, ``serving.p99_ms`` the rolling
request percentile, per-node ``feed.rows_consumed`` rates the training
throughput — all from ``cluster.stats()``.
"""

from __future__ import annotations

import math
from typing import Any


def _serving(stats: dict) -> dict:
    return stats.get("serving") or {}


class Policy:
    """Base: map a rolling-stats snapshot to a desired feedable-node count.

    ``desired(stats, current)`` returns the count the policy would run at
    — the governor (not the policy) owns clamping, cooldown, and scale-in
    hysteresis, so policies are free to answer naively every tick.
    """

    name = "policy"

    def desired(self, stats: dict, current: int) -> int:
        raise NotImplementedError

    def describe(self) -> dict[str, Any]:
        """One-line parameter dump for the run report / flight events."""
        return {"name": self.name}


class QueueDepthBandPolicy(Policy):
    """Hold the serving admission-queue depth inside a band.

    Depth above ``high`` means requests are waiting on capacity — add
    ``step`` node(s); depth at/below ``low`` means the fleet is idle
    enough to shrink by one.  The gateway queue is the single earliest
    congestion signal (it grows the moment replicas stop keeping up,
    before latency percentiles move), which makes this the default policy.
    """

    name = "queue_depth_band"

    def __init__(self, low: float = 1.0, high: float = 16.0, step: int = 1):
        if low < 0 or high <= low:
            raise ValueError("need 0 <= low < high")
        self.low = float(low)
        self.high = float(high)
        self.step = max(1, int(step))

    def desired(self, stats: dict, current: int) -> int:
        depth = _serving(stats).get("queue_depth")
        if depth is None:
            return current
        if depth > self.high:
            return current + self.step
        if depth <= self.low:
            return current - 1
        return current

    def describe(self) -> dict[str, Any]:
        return {"name": self.name, "low": self.low, "high": self.high,
                "step": self.step}


class LatencyCeilingPolicy(Policy):
    """Hold rolling request p99 under a ceiling.

    p99 above ``ceiling_ms`` adds ``step`` node(s); p99 below
    ``relax_frac * ceiling_ms`` (default 30%) with traffic present shrinks
    by one.  Quiet windows (no qps, no percentile) leave the count alone —
    "no traffic" is the queue-depth/rows policies' call, not a latency
    signal.
    """

    name = "latency_ceiling"

    def __init__(self, ceiling_ms: float, relax_frac: float = 0.3,
                 step: int = 1):
        if ceiling_ms <= 0 or not 0 < relax_frac < 1:
            raise ValueError("need ceiling_ms > 0 and 0 < relax_frac < 1")
        self.ceiling_ms = float(ceiling_ms)
        self.relax_frac = float(relax_frac)
        self.step = max(1, int(step))

    def desired(self, stats: dict, current: int) -> int:
        serving = _serving(stats)
        p99 = serving.get("p99_ms")
        if p99 is None or not serving.get("qps"):
            return current
        if p99 > self.ceiling_ms:
            return current + self.step
        if p99 < self.relax_frac * self.ceiling_ms:
            return current - 1
        return current

    def describe(self) -> dict[str, Any]:
        return {"name": self.name, "ceiling_ms": self.ceiling_ms,
                "relax_frac": self.relax_frac, "step": self.step}


class RowsPerNodeFloorPolicy(Policy):
    """Shrink-to-fit for training feeds: keep per-node consumption above a
    floor.

    Sums the per-node ``counter`` rates (default ``feed.rows_consumed``,
    the rows/s each node's feed actually popped) and answers the largest
    node count that keeps rows/s-per-node >= ``min_rows_per_sec`` — i.e.
    it only ever shrinks an over-provisioned feed, one node per action
    (the governor rate-limits anyway).  Driver-fed training throughput is
    bounded by the driver, so "add nodes" is deliberately not this
    policy's call; compose it with a queue/latency policy when serving
    shares the cluster.
    """

    name = "rows_per_node_floor"

    def __init__(self, min_rows_per_sec: float,
                 counter: str = "feed.rows_consumed"):
        if min_rows_per_sec <= 0:
            raise ValueError("need min_rows_per_sec > 0")
        self.min_rows_per_sec = float(min_rows_per_sec)
        self.counter = counter

    def desired(self, stats: dict, current: int) -> int:
        total = 0.0
        seen = False
        for key, stream in (stats.get("streams") or {}).items():
            if key == "driver":
                continue
            rate = (stream.get("rates") or {}).get(self.counter)
            if rate is not None:
                seen = True
                total += rate
        if not seen:
            return current
        fit = int(math.floor(total / self.min_rows_per_sec))
        # shrink-to-fit only, one node at a time
        return min(current, max(1, fit, current - 1))

    def describe(self) -> dict[str, Any]:
        return {"name": self.name,
                "min_rows_per_sec": self.min_rows_per_sec,
                "counter": self.counter}


class IngestBacklogPolicy(Policy):
    """Scale the DATA-SERVICE tier on trainer starvation (the disaggregated
    ingest tier's satellite policy).

    Reads the ``ingest`` stats block (``cluster.stats()``): any starved
    trainer — a trainer whose prefetch-queue gauge reads empty — means
    decode capacity is behind consumption, so add ``step`` worker(s).
    With nobody starved and the pool's decode throughput per worker under
    ``min_rows_per_sec`` (decode capacity idling), shrink by one.  The
    signals are exactly the ``feed.queue_depth``/starvation gauges the
    node-local feed already exported — the tier reuses them, it does not
    invent new ones.  Drive it with ``cluster.autoscale(policy=...,
    tier="ingest")`` so the governor actuates ``cluster.resize_ingest``.
    """

    name = "ingest_backlog"

    def __init__(self, min_rows_per_sec: float = 1.0, step: int = 1):
        if min_rows_per_sec <= 0:
            raise ValueError("need min_rows_per_sec > 0")
        self.min_rows_per_sec = float(min_rows_per_sec)
        self.step = max(1, int(step))

    def desired(self, stats: dict, current: int) -> int:
        block = stats.get("ingest") or {}
        workers = block.get("workers") or {}
        if not workers:
            return current  # no live signal yet: never scale on a vacuum
        rates = [w.get("forwarded_rows_per_s") or w.get("rows_per_s") or 0.0
                 for w in workers.values()]
        # An empty trainer queue alone cannot distinguish "starving behind
        # decode" from "idle between train() calls" (both read depth 0, and
        # an idle feed still polls): only starvation WITH the pool actually
        # decoding is scale-out evidence — an idle cluster instead shrinks
        # through the under-floor branch below until the governor's min.
        if (block.get("starved_trainers") or 0) > 0 and any(
                r > 0.0 for r in rates):
            return current + self.step
        if rates and all(r < self.min_rows_per_sec for r in rates):
            return current - 1
        return current

    def describe(self) -> dict[str, Any]:
        return {"name": self.name,
                "min_rows_per_sec": self.min_rows_per_sec,
                "step": self.step}


class HysteresisGovernor:
    """The anti-flap state machine between a policy and ``cluster.resize``.

    Rules, in order:

    - the desired count is clamped to ``[min_nodes, max_nodes]``;
    - after ANY action, a ``cooldown_secs`` window holds further actions
      (``cooldown_hold``) — resizes are not free, and the stats window
      needs time to reflect the new capacity;
    - scale-OUT fires on a single over-target window (congestion is
      urgent);
    - scale-IN needs ``scale_in_ticks`` CONSECUTIVE under-target windows
      (idleness must prove itself) — one over-or-at-target window resets
      the evidence, and windows sampled inside a cooldown don't count
      (the evidence must be gathered entirely after the fleet settled),
      so a load oscillating around the threshold never flaps the fleet.

    Pure and clock-free: callers pass ``now`` (monotonic seconds), so unit
    tests drive it with literal timestamps.
    """

    def __init__(self, min_nodes: int = 1, max_nodes: int = 8,
                 cooldown_secs: float = 30.0, scale_in_ticks: int = 3):
        if not 1 <= min_nodes <= max_nodes:
            raise ValueError("need 1 <= min_nodes <= max_nodes")
        if cooldown_secs < 0 or scale_in_ticks < 1:
            raise ValueError("need cooldown_secs >= 0 and scale_in_ticks >= 1")
        self.min_nodes = int(min_nodes)
        self.max_nodes = int(max_nodes)
        self.cooldown_secs = float(cooldown_secs)
        self.scale_in_ticks = int(scale_in_ticks)
        self._cooldown_until = float("-inf")
        self._under_streak = 0

    def decide(self, desired: int, current: int, now: float) -> tuple[str, int]:
        """(action, target): action is ``hold`` / ``cooldown_hold`` /
        ``scale_out`` / ``scale_in``; target is the count to resize to
        (== current unless the action scales)."""
        desired = max(self.min_nodes, min(self.max_nodes, int(desired)))
        if desired == current:
            self._under_streak = 0
            return ("hold", current)
        if now < self._cooldown_until:
            # Windows inside the cooldown are NOT shrink evidence: the
            # fleet just changed and the stats window is still settling —
            # counting them would let a scale-in fire on the first tick
            # after a scale-out's cooldown expires, oscillating the fleet
            # with period == cooldown_secs on bursty load.
            self._under_streak = 0
            return ("cooldown_hold", current)
        if desired < current:
            self._under_streak += 1
        else:
            self._under_streak = 0
        if desired > current:
            self._cooldown_until = now + self.cooldown_secs
            return ("scale_out", desired)
        if self._under_streak >= self.scale_in_ticks:
            self._under_streak = 0
            self._cooldown_until = now + self.cooldown_secs
            return ("scale_in", desired)
        return ("hold", current)

    def cooling_down(self, now: float) -> bool:
        return now < self._cooldown_until
