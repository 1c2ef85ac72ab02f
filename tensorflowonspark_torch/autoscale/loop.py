"""The driver-side autoscaling loop: stats -> policy -> governor -> resize.

One daemon thread per :class:`Autoscaler`: every ``tick_secs`` it samples
``cluster.stats(window)``, asks the policy for a desired feedable-node
count, runs the :class:`~.policy.HysteresisGovernor` (cooldown, K-window
scale-in evidence, min/max bounds), and — when the governor fires —
calls ``cluster.resize(target)``.  Every decision that is not a plain
hold is flight-recorded (``scale_out`` / ``scale_in`` / ``cooldown_hold``)
with the stats snapshot that justified it, so a postmortem can replay why
the fleet moved; the same trail lands in ``run_report.json``'s
``autoscale`` block.

This is the closed loop that follows traffic: ``cluster.stats()`` gives
the live signals (rolling qps/p50/p99, serve queue depth, per-node feed
occupancy), ``cluster.resize`` is the actuator, and this module is the
controller between them — the whole-cluster analogue
of tf.data's occupancy-driven autotuning (Murray et al., 2101.12127) in
the spirit of the TF system paper's dynamic worker sets (Abadi et al.,
1605.08695).
"""

from __future__ import annotations

import logging
import threading
from tensorflowonspark_torch.utils.locks import tos_named_lock
import time

from tensorflowonspark_torch import telemetry
from tensorflowonspark_torch.autoscale.policy import (
    HysteresisGovernor,
    Policy,
    QueueDepthBandPolicy,
)
from tensorflowonspark_torch.telemetry import trace as ttrace
from tensorflowonspark_torch.utils.envtune import env_float, env_int

logger = logging.getLogger(__name__)

# Decision-trail bound for the run report: at the default 5s tick this is
# well over an hour of non-hold decisions — plenty for a postmortem, and a
# week-long serving job cannot grow the driver's heap with it.
_DECISION_LOG_CAP = 1024


def _snapshot(stats: dict) -> dict:
    """The compact justification attached to every decision's flight event:
    the exact headline signals the policies read, nothing else."""
    serving = stats.get("serving") or {}
    out = {k: serving.get(k) for k in ("qps", "p50_ms", "p99_ms",
                                       "queue_depth", "inflight_batches",
                                       "replicas_healthy",
                                       "replicas_draining")}
    return {k: v for k, v in out.items() if v is not None}


class Autoscaler:
    """Telemetry-driven policy loop over ``cluster.resize`` (start it via
    ``cluster.autoscale(...)``, which also honours the ``TOS_AUTOSCALE``
    kill switch and stops the loop at shutdown).

    Defaults come from the ``TOS_AUTOSCALE_*`` knobs: bounds
    (``_MIN``/``_MAX``), cadence (``_TICK_SECS``) and the post-action
    cooldown (``_COOLDOWN_SECS``); ``scale_in_ticks`` is the K-consecutive
    under-target windows a shrink must earn.  ``window`` (default
    ``max(2 x tick, 5)``) is the rolling-stats horizon each tick reads.
    """

    def __init__(self, cluster, policy: Policy | None = None, *,
                 tier: str = "nodes",
                 min_nodes: int | None = None, max_nodes: int | None = None,
                 tick_secs: float | None = None,
                 cooldown_secs: float | None = None,
                 scale_in_ticks: int = 3,
                 window: float | None = None,
                 drain_timeout: float | None = None):
        if tier not in ("nodes", "ingest"):
            raise ValueError(f"tier must be 'nodes' or 'ingest', got {tier!r}")
        self._cluster = cluster
        # tier="ingest" scales the DATA-SERVICE pool (cluster.resize_ingest
        # over num_ingest) on the feed starvation signals; the default tier
        # scales the trainer/serving fleet exactly as before
        self.tier = tier
        if policy is None:
            if tier == "ingest":
                from tensorflowonspark_torch.autoscale.policy import (
                    IngestBacklogPolicy,
                )

                policy = IngestBacklogPolicy()
            else:
                policy = QueueDepthBandPolicy()
        self.policy = policy
        self.tick_secs = (float(tick_secs) if tick_secs is not None
                          else env_float("TOS_AUTOSCALE_TICK_SECS", 5.0))
        cooldown = (float(cooldown_secs) if cooldown_secs is not None
                    else env_float("TOS_AUTOSCALE_COOLDOWN_SECS", 30.0))
        self.governor = HysteresisGovernor(
            min_nodes=(int(min_nodes) if min_nodes is not None
                       else env_int("TOS_AUTOSCALE_MIN", 1)),
            max_nodes=(int(max_nodes) if max_nodes is not None
                       else env_int("TOS_AUTOSCALE_MAX", 8)),
            cooldown_secs=cooldown,
            scale_in_ticks=scale_in_ticks)
        self.window = (float(window) if window is not None
                       else max(2.0 * self.tick_secs, 5.0))
        self._drain_timeout = drain_timeout
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = tos_named_lock("autoscale._lock")
        self._decisions: list[dict] = []
        self._counts = {"scale_out": 0, "scale_in": 0, "cooldown_hold": 0,
                        "resize_failures": 0}

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "Autoscaler":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="autoscaler")
        self._thread.start()
        logger.info("autoscaler up: policy=%s bounds=[%d, %d] tick=%.1fs "
                    "cooldown=%.1fs scale_in_ticks=%d",
                    self.policy.name, self.governor.min_nodes,
                    self.governor.max_nodes, self.tick_secs,
                    self.governor.cooldown_secs, self.governor.scale_in_ticks)
        return self

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    # -- the loop ----------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.wait(self.tick_secs):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - the loop must survive a bad tick
                logger.warning("autoscaler tick failed", exc_info=True)

    def tick(self) -> dict | None:
        """One decision cycle (public so tests and benches can drive the
        loop synchronously).  Returns the decision record for every
        non-hold outcome, else None."""
        coord = getattr(self._cluster, "coordinator", None)
        if coord is not None and getattr(coord, "crashed", None) \
                and coord.crashed():
            # control plane mid-failover: the stats streams were
            # wiped with the crash — a decision made against that vacuum
            # would scale on ghosts.  Hold; the journal-recovered epoch's
            # fresh windows feed the next tick.
            return None
        stats = self._cluster.stats(self.window)
        current = (self._cluster.num_ingest() if self.tier == "ingest"
                   else self._cluster.num_feedable())
        desired = self.policy.desired(stats, current)
        action, target = self.governor.decide(desired, current,
                                              time.monotonic())
        if action == "hold":
            return None
        snapshot = _snapshot(stats)
        if self.tier == "ingest":
            block = stats.get("ingest") or {}
            snapshot["starved_trainers"] = block.get("starved_trainers")
            snapshot["cache_hit_rate"] = block.get("cache_hit_rate")
        decision = {"action": action, "current": current,
                    "desired": desired, "target": target, "tier": self.tier,
                    "policy": self.policy.name, "stats": snapshot}
        # flight-record EVERY decision with its justification — including
        # cooldown holds, which are where "why didn't it scale?" lives
        ttrace.event(action, current=current, desired=desired,
                     target=target, policy=self.policy.name, **snapshot)
        with self._lock:
            self._counts[action] = self._counts.get(action, 0) + 1
            self._decisions.append(decision)
            del self._decisions[:-_DECISION_LOG_CAP]
        telemetry.counter(f"autoscale.{action}_total").inc()
        if action == "cooldown_hold":
            return decision
        logger.info("autoscaler: %s %d -> %d (desired %d, policy %s, %s)",
                    action, current, target, desired, self.policy.name,
                    snapshot)
        telemetry.gauge("autoscale.target_nodes" if self.tier == "nodes"
                        else "autoscale.target_ingest_workers").set(target)
        try:
            resize = (self._cluster.resize_ingest if self.tier == "ingest"
                      else self._cluster.resize)
            decision["resize"] = resize(
                target, drain_timeout=self._drain_timeout)
        except Exception as e:  # noqa: BLE001 - keep the loop alive; next tick retries
            with self._lock:
                self._counts["resize_failures"] += 1
            decision["error"] = str(e)
            logger.warning("autoscaler resize to %d failed: %s", target, e)
        return decision

    # -- reporting -----------------------------------------------------------

    def decisions(self) -> list[dict]:
        with self._lock:
            return [dict(d) for d in self._decisions]

    def report(self) -> dict:
        """The run report's per-policy autoscale summary."""
        with self._lock:
            counts = dict(self._counts)
            trail = [dict(d) for d in self._decisions]
        return {"policy": self.policy.describe(),
                "tier": self.tier,
                "bounds": [self.governor.min_nodes, self.governor.max_nodes],
                "tick_secs": self.tick_secs,
                "cooldown_secs": self.governor.cooldown_secs,
                "scale_in_ticks": self.governor.scale_in_ticks,
                "counts": counts,
                "decisions": trail}
