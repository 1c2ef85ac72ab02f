"""tensorflowonspark_torch.telemetry — cluster-wide metrics and span tracing.

The framework's observability substrate (stdlib-only):

- **Process-local registry** — ``counter(name)`` / ``gauge(name)`` /
  ``histogram(name)`` / ``timed(name)`` intern one metric per name in this
  process.  Counter increments are lock-free and exact (per-thread cells),
  so the data plane meters every frame without measurable overhead; see
  ``registry.py``.
- **Transport** — nodes piggyback compact deltas of their registry on the
  control-plane heartbeats they already send (``node.py``); the coordinator
  merges them into a per-node store and serves the aggregated cluster view
  through a ``metrics`` control-plane op (``coordinator.py``).
- **Sinks** — ``cluster.metrics()`` (aggregated dict), ``cluster.
  debug_dump()`` (text), ``cluster.stats()`` (rolling-window live stats,
  the ``statz`` op), periodic TensorBoard scalar export through
  ``summary.SummaryWriter``, and an end-of-run JSON run report written at
  shutdown (``cluster.py``; ``report.py`` builds the aggregates).
- **Distributed tracing + flight recorder** — ``trace.py``: sampled
  spans with cross-process context propagation (``TOS_TRACE``), shipped
  on the same heartbeats and merged into a Perfetto-loadable
  ``trace.json`` by ``trace_export.py``; a bounded ring of structured
  events (deaths/restarts/retries/resyncs/reloads/faults) feeds the run
  report's ``"flight"`` timeline and crash dumps.

Master switch: ``TOS_METRICS`` (default on).  Disabled, every accessor
returns a shared no-op object, so instrumentation costs one dict miss.

Usage inside a ``map_fun`` (via ``ctx.metrics``) or anywhere in-process::

    from tensorflowonspark_torch import telemetry
    telemetry.counter("myjob.records_scored").inc(len(batch))
    telemetry.gauge("myjob.steps_per_sec").set(rate)
    with telemetry.timed("myjob.step_secs"):
        state = step(state, batch)
"""

from __future__ import annotations

import threading

from tensorflowonspark_torch.telemetry.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    OUTBOX_SIZE,
    RESERVOIR_SIZE,
    percentile_of,
)
from tensorflowonspark_torch.telemetry.report import (  # noqa: F401
    aggregate_snapshots,
    build_run_report,
    debug_dump,
    write_run_report,
)
from tensorflowonspark_torch.telemetry import trace  # noqa: F401

_lock = threading.Lock()
_registry: MetricsRegistry | None = None


def get_registry() -> MetricsRegistry:
    """The process-local registry, created on first use from ``TOS_METRICS``."""
    global _registry
    reg = _registry
    if reg is None:
        with _lock:
            if _registry is None:
                from tensorflowonspark_torch.utils.envtune import env_bool

                _registry = MetricsRegistry(enabled=env_bool("TOS_METRICS", True))
            reg = _registry
    return reg


def reset(enabled: bool | None = None) -> MetricsRegistry:
    """Replace the process registry (tests and the bench's metrics-on/off
    comparison only): re-reads ``TOS_METRICS`` unless ``enabled`` is given.
    Metric objects handed out before the reset keep working but report into
    the abandoned registry."""
    global _registry
    with _lock:
        if enabled is None:
            from tensorflowonspark_torch.utils.envtune import env_bool

            enabled = env_bool("TOS_METRICS", True)
        _registry = MetricsRegistry(enabled=enabled)
        return _registry


def enabled() -> bool:
    return get_registry().enabled


def counter(name: str):
    return get_registry().counter(name)


def gauge(name: str):
    return get_registry().gauge(name)


def histogram(name: str):
    return get_registry().histogram(name)


def timed(name: str):
    return get_registry().timed(name)


def snapshot(include_samples: bool = False) -> dict:
    return get_registry().snapshot(include_samples=include_samples)


def collect_changed(last: dict | None) -> tuple[dict, dict]:
    return get_registry().collect_changed(last)
