"""TensorBoard event-file writer — hand-rolled Event/Summary protos.

The reference's only observability surface is TensorBoard (SURVEY.md §5.1):
user ``map_fun``s write summaries via TF and ``TFCluster.run(tensorboard=True)``
spawns the viewer.  Here nodes can write scalars without TF: an event file is
a TFRecord stream of ``Event`` protos, which we encode with the same varint
helpers as ``example.py``:

    Event   { double wall_time = 1; int64 step = 2;
              oneof { string file_version = 3; Summary summary = 5; } }
    Summary { repeated Value value = 1; }
    Value   { string tag = 1; float simple_value = 2; }

TensorBoard's scalar dashboard reads exactly this subset.
"""

from __future__ import annotations

import atexit
import os
import struct
import time

from tensorflowonspark_torch.example import _write_len_delimited, _write_varint
from tensorflowonspark_torch.tfrecord import RecordWriter
from tensorflowonspark_torch.utils.paths import resolve_uri

_F64 = struct.Struct("<d")
_F32 = struct.Struct("<f")


def _encode_value(tag: str, value: float) -> bytes:
    out = bytearray()
    _write_len_delimited(out, 1, tag.encode("utf-8"))
    _write_varint(out, (2 << 3) | 5)  # field 2, 32-bit
    out += _F32.pack(float(value))
    return bytes(out)


def _encode_event(wall_time: float, step: int, scalars: dict[str, float] | None,
                  file_version: str | None = None) -> bytes:
    out = bytearray()
    _write_varint(out, (1 << 3) | 1)  # field 1, 64-bit double
    out += _F64.pack(wall_time)
    _write_varint(out, (2 << 3) | 0)  # field 2, varint
    _write_varint(out, int(step))
    if file_version is not None:
        _write_len_delimited(out, 3, file_version.encode("utf-8"))
    if scalars:
        summary = bytearray()
        for tag, value in scalars.items():
            _write_len_delimited(summary, 1, _encode_value(tag, value))
        _write_len_delimited(out, 5, bytes(summary))
    return bytes(out)


class SummaryWriter:
    """Write TensorBoard scalar events (one file per writer).

    Crash-robust by default: nodes in an elastic cluster get killed mid-run
    (supervised restarts, ``TOS_FAULTINJECT`` kills, preemption), and an
    event file cut inside a buffered record is truncated garbage from the
    last flush onward.  So the writer (a) flushes at *record boundaries* on
    a ``flush_secs`` cadence — a hard kill can only cost the last few
    seconds of scalars, never leave a half-written record the OS already
    had; (b) registers an ``atexit`` close so orderly teardowns (SIGTERM
    handlers, interpreter exit with the writer still open) always land a
    complete file; (c) makes ``close()`` idempotent, so atexit after an
    explicit close (or the context manager) is a no-op.
    """

    def __init__(self, log_dir: str, filename_suffix: str = "",
                 flush_secs: float = 5.0):
        log_dir = resolve_uri(log_dir)
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{time.time():.0f}.{os.getpid()}{filename_suffix}"
        self._writer = RecordWriter(os.path.join(log_dir, fname))
        self._flush_secs = max(0.0, float(flush_secs))
        self._closed = False
        # TensorBoard requires a leading file_version event.
        self._writer.write(_encode_event(time.time(), 0, None, file_version="brain.Event:2"))
        self._writer.flush()
        self._last_flush = time.monotonic()
        atexit.register(self.close)

    def _wrote_record(self) -> None:
        if time.monotonic() - self._last_flush >= self._flush_secs:
            self.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._writer.write(_encode_event(time.time(), step, {tag: value}))
        self._wrote_record()

    def add_scalars(self, scalars: dict[str, float], step: int) -> None:
        self._writer.write(_encode_event(time.time(), step, scalars))
        self._wrote_record()

    def flush(self) -> None:
        if not self._closed:
            self._writer.flush()
            self._last_flush = time.monotonic()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._writer.close()
        # a closed writer needs no interpreter-exit hook (and unregistering
        # keeps long-lived processes from accumulating dead callbacks)
        atexit.unregister(self.close)

    def __enter__(self) -> "SummaryWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
