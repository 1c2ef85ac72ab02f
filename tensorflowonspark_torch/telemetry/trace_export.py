"""Merge per-process span streams into one Chrome-trace-format timeline.

Every process records spans against its own ``time.monotonic()`` clock;
the heartbeat transport ships each node's NTP-style clock-offset estimate
(driver-monotonic = node-monotonic + offset, midpoint of the heartbeat
round-trip) along with its spans.  This module folds the per-node streams
onto the driver timeline and emits the Chrome trace event format — one
``trace.json`` loadable in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``:

- each stream becomes one "process" track (metadata ``process_name``
  events name them ``driver`` / ``node 0`` / ...);
- spans are complete (``ph: "X"``) events, microsecond timestamps, with
  trace/span/parent ids and tags under ``args`` (Perfetto's flow/args
  panes show the cross-process request assembly);
- flight-recorder events are instant (``ph: "i"``) events on the same
  timeline, so a chaos kill renders as a mark between the victim's last
  span and the router's retry.

Standalone CLI (merge + validate a run's per-node files)::

    python -m tensorflowonspark_torch.telemetry.trace_export <run_dir>

reads every ``trace_<key>.json`` stream (written at ``cluster.shutdown()``)
and ``flight_<key>.json`` postmortem dump (written on chaos exit) in
``run_dir`` and writes ``run_dir/trace.json``.
"""

from __future__ import annotations

import glob
import json
import math
import os
import sys

from tensorflowonspark_torch.telemetry.trace import event_origin, map_time

STREAM_SCHEMA = "tos-trace-stream-v1"


def build_stream(key: str, spans: list, events: list,
                 offset: float | None) -> dict:
    """One per-process stream document (the ``trace_<key>.json`` shape)."""
    return {"schema": STREAM_SCHEMA, "node": key,
            "clock_offset": offset, "spans": list(spans),
            "events": list(events)}


def _stream_offset(stream: dict) -> float | None:
    off = stream.get("clock_offset", stream.get("offset"))
    return float(off) if off is not None else None


def merge_streams(streams: dict[str, dict]) -> dict:
    """``{key: stream}`` -> Chrome trace document.

    ``stream`` is a ``build_stream`` document (or a flight dump: same
    ``spans``/``events``/``clock_offset`` fields).  Timestamps shift so
    the earliest event lands at t=0.
    """
    raw: list[tuple[float, dict]] = []  # (driver-mono seconds, event)
    trace_events: list[dict] = []
    keys = sorted(streams)
    pids = {key: i + 1 for i, key in enumerate(keys)}
    # a chaos dump (flight:nodeN) repeats spans/events its process already
    # shipped on heartbeats into the nodeN stream — emit each once, the
    # heartbeat copy preferred (non-flight streams walk first)
    seen_spans: set = set()
    seen_events: set = set()
    for key in sorted(keys, key=lambda k: (k.startswith("flight:"), k)):
        stream = streams[key]
        offset = _stream_offset(stream)
        pid = pids[key]
        trace_events.append({"ph": "M", "name": "process_name", "pid": pid,
                             "tid": 0, "args": {"name": key}})
        for span in stream.get("spans") or ():
            ident = (span["t"], span["s"])  # span ids are process-unique
            if ident in seen_spans:
                continue
            seen_spans.add(ident)
            t = map_time(float(span["t0"]), offset)
            ev = {"ph": "X", "cat": "span", "name": str(span["n"]),
                  "pid": pid, "tid": int(span.get("th") or 0) % (1 << 31),
                  "ts": t, "dur": max(0.0, float(span.get("d") or 0.0)) * 1e6,
                  "args": {"trace_id": f"{span['t']:x}",
                           "span_id": f"{span['s']:x}",
                           "parent": (f"{span['p']:x}"
                                      if span.get("p") else None),
                           **(span.get("tags") or {})}}
            raw.append((t, ev))
        for fev in stream.get("events") or ():
            ident = (event_origin(key), fev.get("kind"),
                     fev.get("t0"), fev.get("wall"))
            if ident in seen_events:
                continue
            seen_events.add(ident)
            t = map_time(float(fev.get("t0", 0.0)), offset)
            args = {k: v for k, v in fev.items()
                    if k not in ("kind", "t0", "t", "node")}
            raw.append((t, {"ph": "i", "cat": "flight", "s": "g",
                            "name": str(fev.get("kind", "event")),
                            "pid": pid, "tid": 0, "ts": t, "args": args}))
    t_base = min((t for t, _ in raw), default=0.0)
    for t, ev in sorted(raw, key=lambda p: p[0]):
        ev["ts"] = round((t - t_base) * 1e6, 3)
        trace_events.append(ev)
    return {"traceEvents": trace_events, "displayTimeUnit": "ms",
            "otherData": {"format": "tos-trace-v1", "streams": keys}}


def validate_chrome_trace(doc: dict) -> int:
    """Schema check of a merged document; returns the event count or raises
    ``ValueError`` — the tier-1 export test and the CLI both run this, so a
    trace that Perfetto would reject fails loudly here first."""
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        ph = ev.get("ph")
        if ph not in ("X", "i", "M"):
            raise ValueError(f"event {i}: unsupported ph {ph!r}")
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            raise ValueError(f"event {i}: missing name")
        if not isinstance(ev.get("pid"), int):
            raise ValueError(f"event {i}: missing pid")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or not math.isfinite(ts) or ts < 0:
            raise ValueError(f"event {i}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if (not isinstance(dur, (int, float)) or not math.isfinite(dur)
                    or dur < 0):
                raise ValueError(f"event {i}: bad dur {dur!r}")
    return len(events)


def write_stream(path: str, stream: dict) -> str:
    _write_doc(path, stream)
    return path


def _write_doc(path: str, doc: dict) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
        f.write("\n")


def write_merged(path: str, streams: dict[str, dict]) -> str:
    """Merge, validate, write; returns ``path``."""
    doc = merge_streams(streams)
    validate_chrome_trace(doc)
    _write_doc(path, doc)
    return path


def load_run_dir(run_dir: str) -> dict[str, dict]:
    """Collect every per-process stream in a run directory: the
    ``trace_<key>.json`` files shutdown wrote plus any ``flight_<key>.json``
    chaos dumps (their key gains a ``flight:`` prefix so a node that left
    both contributes two distinguishable tracks)."""
    streams: dict[str, dict] = {}
    for path in sorted(glob.glob(os.path.join(run_dir, "trace_*.json"))):
        key = os.path.basename(path)[len("trace_"):-len(".json")]
        with open(path, encoding="utf-8") as f:
            streams[key] = json.load(f)
    for path in sorted(glob.glob(os.path.join(run_dir, "flight_*.json"))):
        key = os.path.basename(path)[len("flight_"):-len(".json")]
        with open(path, encoding="utf-8") as f:
            streams[f"flight:{key}"] = json.load(f)
    return streams


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or argv[0] in ("-h", "--help"):
        print("usage: python -m tensorflowonspark_torch.telemetry.trace_export "
              "<run_dir>", file=sys.stderr)
        return 2
    run_dir = argv[0]
    streams = load_run_dir(run_dir)
    if not streams:
        print(f"no trace_*.json / flight_*.json streams in {run_dir}",
              file=sys.stderr)
        return 1
    out = os.path.join(run_dir, "trace.json")
    doc = merge_streams(streams)
    n = validate_chrome_trace(doc)
    _write_doc(out, doc)
    n_spans = sum(len(s.get("spans") or ()) for s in streams.values())
    n_events = sum(len(s.get("events") or ()) for s in streams.values())
    print(f"{out}: {n} trace events ({n_spans} spans, {n_events} flight "
          f"events, {len(streams)} streams) — load it at "
          "https://ui.perfetto.dev")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
