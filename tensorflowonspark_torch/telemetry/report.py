"""Cluster-wide metric aggregation and human/machine-readable reports.

The coordinator keeps one raw snapshot per node (replaced key-by-key as
heartbeat deltas arrive); this module turns ``{node_key: snapshot}`` into

- an **aggregated snapshot** (``aggregate_snapshots``): counters summed
  across nodes, histogram digests merged, cluster-wide percentiles pooled
  from the nodes' shipped samples, per-node detail preserved under
  ``"nodes"`` — the ``cluster.metrics()`` payload;
- a **text report** (``debug_dump``) for eyeballs and bug reports;
- an **end-of-run JSON run report** (``build_run_report``), written next to
  the job's checkpoints/logs at shutdown — throughput, restarts, span
  percentiles, per-node detail (the tf.data-paper "built-in per-stage
  counters" idea applied run-level).
"""

from __future__ import annotations

import json
import time
from typing import Any

from tensorflowonspark_torch.telemetry.registry import percentile_of

#: Percentiles rendered for every merged histogram.
PERCENTILES = (50.0, 90.0, 99.0)


def aggregate_snapshots(nodes: dict[str, dict]) -> dict:
    """Merge per-node snapshots into one cluster view.

    ``nodes`` maps a node key (stringified executor id, or ``"driver"``) to
    a registry snapshot (``{"counters": ..., "gauges": ...,
    "histograms": {name: digest [+ "recent" samples]}}``).  Counter values
    are cumulative per process, so the aggregate is their plain sum; gauges
    stay per-node (a cluster-summed gauge is rarely meaningful); histogram
    digests merge exactly (count/sum/min/max) and percentiles are estimated
    from the pooled per-node samples.
    """
    counters: dict[str, int] = {}
    hists: dict[str, dict] = {}
    samples: dict[str, list[float]] = {}
    for snap in nodes.values():
        for name, value in (snap.get("counters") or {}).items():
            counters[name] = counters.get(name, 0) + value
        for name, d in (snap.get("histograms") or {}).items():
            agg = hists.setdefault(name, {"count": 0, "sum": 0.0,
                                          "min": None, "max": None})
            agg["count"] += int(d.get("count") or 0)
            agg["sum"] += float(d.get("sum") or 0.0)
            for key, pick in (("min", min), ("max", max)):
                v = d.get(key)
                if v is not None:
                    agg[key] = v if agg[key] is None else pick(agg[key], v)
            samples.setdefault(name, []).extend(d.get("recent") or ())
    for name, agg in hists.items():
        pool = sorted(samples.get(name) or ())
        for q in PERCENTILES:
            agg[f"p{q:g}"] = percentile_of(pool, q)
        if agg["count"]:
            agg["mean"] = agg["sum"] / agg["count"]
    return {"nodes": _strip_samples(nodes), "counters": counters,
            "histograms": hists}


def _strip_samples(nodes: dict[str, dict]) -> dict[str, dict]:
    """Per-node detail without the raw sample lists (digest-only)."""
    out: dict[str, dict] = {}
    for key, snap in nodes.items():
        hists = {name: {k: v for k, v in d.items() if k != "recent"}
                 for name, d in (snap.get("histograms") or {}).items()}
        out[key] = {"counters": dict(snap.get("counters") or {}),
                    "gauges": dict(snap.get("gauges") or {}),
                    "histograms": hists}
    return out


def debug_dump(aggregated: dict) -> str:
    """Render an ``aggregate_snapshots`` result as a text report."""
    lines: list[str] = ["== cluster metrics =="]
    counters = aggregated.get("counters") or {}
    if counters:
        lines.append("-- counters (cluster total) --")
        width = max(len(n) for n in counters)
        for name in sorted(counters):
            lines.append(f"  {name:<{width}}  {counters[name]}")
    hists = aggregated.get("histograms") or {}
    if hists:
        lines.append("-- spans (cluster merged) --")
        for name in sorted(hists):
            d = hists[name]
            parts = [f"count={d.get('count')}"]
            if d.get("count"):
                parts.append(f"mean={d.get('mean'):.6g}")
                parts.append(f"min={d.get('min'):.6g}")
                parts.append(f"max={d.get('max'):.6g}")
                for q in PERCENTILES:
                    v = d.get(f"p{q:g}")
                    if v is not None:
                        parts.append(f"p{q:g}={v:.6g}")
            lines.append(f"  {name}  " + " ".join(parts))
    for key in sorted(aggregated.get("nodes") or {}):
        snap = aggregated["nodes"][key]
        lines.append(f"-- node {key} --")
        for kind in ("counters", "gauges"):
            for name in sorted(snap.get(kind) or {}):
                lines.append(f"  {name} = {snap[kind][name]}")
        for name in sorted(snap.get("histograms") or {}):
            d = snap["histograms"][name]
            lines.append(f"  {name} count={d.get('count')} sum={d.get('sum')}")
    return "\n".join(lines)


def _gauge_max(aggregated: dict, name: str):
    """Largest per-node value of a gauge, or None when no node reports it
    (gauges stay per-node in the aggregate; for the serving frontend's
    connection/outstanding gauges the driver is the only reporter, so max
    IS the value)."""
    vals = [snap["gauges"][name]
            for snap in (aggregated.get("nodes") or {}).values()
            if name in (snap.get("gauges") or {})]
    return max(vals) if vals else None


def _hist_ms(aggregated: dict, name: str, q: str):
    """A merged histogram's percentile in milliseconds, or None."""
    v = ((aggregated.get("histograms") or {}).get(name) or {}).get(q)
    return round(v * 1e3, 3) if v is not None else None


def build_run_report(aggregated: dict, *, wall_secs: float | None = None,
                     extras: dict | None = None) -> dict:
    """End-of-run JSON document: the aggregate + derived headline numbers.

    Headlines are best-effort derivations from well-known counter names —
    absent instrumentation just omits them (``None``), it never fails the
    report.
    """
    counters = aggregated.get("counters") or {}
    rx_bytes = counters.get("dataplane.rx_bytes")
    ingest_bytes = counters.get("ingest.bytes_read")
    serve_requests = counters.get("serve.requests_total")
    serving = None
    if serve_requests:
        # serving headlines: gateway qps/latency plus the reactor
        # frontend's health next to them (connections, pipelining depth,
        # frame counts, loop lag) — the wire endpoint is a single thread,
        # so its loop-lag p99 is the first thing to check when TCP p99
        # diverges from in-process
        serving = {
            "requests_total": serve_requests,
            "qps": (round(serve_requests / wall_secs, 1)
                    if wall_secs else None),
            "request_p50_ms": _hist_ms(aggregated, "serve.request_secs", "p50"),
            "request_p99_ms": _hist_ms(aggregated, "serve.request_secs", "p99"),
            "frontend_frames_in": counters.get("serve.frontend.frames_in"),
            "frontend_frames_out": counters.get("serve.frontend.frames_out"),
            "frontend_connections_open": _gauge_max(
                aggregated, "serve.frontend.connections"),
            "frontend_outstanding_requests": _gauge_max(
                aggregated, "serve.frontend.outstanding"),
            "frontend_loop_lag_p99_ms": _hist_ms(
                aggregated, "serve.frontend.loop_lag_secs", "p99"),
        }
    ingest_tier = None
    fwd_rows = counters.get("ingest.rows_forwarded")
    cache_hits = counters.get("ingest.cache_hits", 0)
    cache_misses = counters.get("ingest.cache_misses", 0)
    if fwd_rows or cache_hits or cache_misses:
        # the disaggregated data-service tier ran (or the chunk cache was
        # live node-locally): the run's ingest postmortem block
        ingest_tier = {
            "chunks_forwarded": counters.get("ingest.chunks_forwarded"),
            "rows_forwarded": fwd_rows,
            "forwarded_mb": (
                round(counters["ingest.bytes_forwarded"] / 1e6, 3)
                if counters.get("ingest.bytes_forwarded") else None),
            "cache_hits": cache_hits,
            "cache_misses": cache_misses,
            "cache_hit_rate": (
                round(cache_hits / (cache_hits + cache_misses), 4)
                if (cache_hits + cache_misses) else None),
            "cache_evictions": counters.get("ingest.cache_evictions", 0),
            "forward_errors": counters.get("ingest.forward_errors", 0),
        }
    collective = None
    if counters.get("collective.rounds_total") \
            or counters.get("collective.formations_total") \
            or counters.get("collective.evictions_total"):
        # the sync-training postmortem block: how many rounds/formations
        # ran, how often the group aborted and re-formed, and the gray-
        # failure tallies (suspicion votes filed, quorum evictions,
        # probation readmissions) — the first place to look when a sync
        # run degraded to W-1 or thrashed
        collective = {
            "rounds_total": counters.get("collective.rounds_total", 0),
            "formations_total": counters.get(
                "collective.formations_total", 0),
            "reforms_total": counters.get("collective.reforms_total", 0),
            "aborts_total": counters.get("collective.aborts_total", 0),
            "suspects_total": counters.get("collective.suspects_total", 0),
            "evictions_total": counters.get(
                "collective.evictions_total", 0),
            "readmits_total": counters.get("collective.readmits_total", 0),
            "form_p50_ms": _hist_ms(aggregated, "collective.form_secs",
                                    "p50"),
            "all_reduce_p50_ms": _hist_ms(
                aggregated, "collective.all_reduce_secs", "p50"),
        }
    report: dict[str, Any] = {
        "schema": "tos-run-report-v1",
        "written_at": time.time(),
        "wall_secs": wall_secs,
        "throughput_mb_per_s": (
            round(rx_bytes / wall_secs / 1e6, 3)
            if rx_bytes and wall_secs else None),
        # DIRECT-mode twin of the driver-pump number: bytes the nodes read
        # straight from storage (cluster aggregate), which never transit
        # the data plane and so never land in dataplane.rx_bytes
        "ingest_mb_per_s": (
            round(ingest_bytes / wall_secs / 1e6, 3)
            if ingest_bytes and wall_secs else None),
        "records_ingested": counters.get("ingest.records_read"),
        "ingest_tier": ingest_tier,
        "rows_fed": counters.get("dataplane.rows_in"),
        "rows_consumed": counters.get("feed.rows_consumed"),
        "serving": serving,
        "collective": collective,
        "restarts_total": counters.get("elastic.restarts_total", 0),
        "faults_injected": counters.get("faultinject.injected_total", 0),
        "counters": counters,
        "histograms": aggregated.get("histograms") or {},
        "nodes": aggregated.get("nodes") or {},
    }
    if extras:
        report.update(extras)
    return report


def write_run_report(path: str, report: dict) -> str:
    """Write the report JSON (pretty, stable key order) and return ``path``."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")
    return path
