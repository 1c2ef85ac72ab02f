"""Write-ahead journal for the control plane (ISSUE 13).

Every durable control-plane mutation (slot register/death/retire, incarnation
bump, manifest set, collective ``form`` membership, serving replica registry,
rendezvous open/close, partition-ledger assign/ack/requeue) appends one
compact JSON-lines record here, fsync'd before the mutation's reply leaves
the coordinator — so a coordinator crash loses nothing that was acknowledged.
Recovery is O(delta): a periodic snapshot (atomic ``<path>.snap`` replace +
journal truncate) bounds the tail :func:`replay` has to walk.

This module is the ONE home of journal file opens and ``os.fsync`` calls
(enforced by the toslint ``journal-discipline`` checker): the durability
contract — append ordering, torn-tail tolerance, snapshot/truncate atomicity
— lives in one reviewed place instead of being re-derived at every call
site.

Record wire shape (one JSON object per line)::

    {"n": <monotone seq>, "k": "<kind>", "d": {...payload...}}

Snapshot shape (``<path>.snap``)::

    {"schema": "tos-journal-v1", "seq": <last seq folded in>, "state": {...}}

Crash-ordering contract: the snapshot is replaced atomically BEFORE the
journal is truncated, and records carry sequence numbers — if a crash lands
between the two, :func:`replay` skips tail records the snapshot already
folded in (``n <= seq``) instead of double-applying them.  A torn final
line (a crash mid-append) is dropped with a warning; corruption anywhere
else fails replay loudly (a silently half-replayed control plane is worse
than a dead one).
"""

from __future__ import annotations

import json
import logging
import os
import threading
from tensorflowonspark_torch.utils.locks import tos_named_lock

logger = logging.getLogger(__name__)

SCHEMA = "tos-journal-v1"
SNAPSHOT_SUFFIX = ".snap"


class Journal:
    """Append-only fsync'd JSON-lines journal with atomic snapshots.

    Thread contract: all methods are safe to call from any thread; appends
    are totally ordered by the internal lock.  Callers that need record
    order to match state-mutation order must append while holding the same
    lock that guards the mutation (the coordinator does).
    """

    def __init__(self, path: str, truncate: bool = False):
        self.path = str(path)
        self._lock = tos_named_lock("journal._lock")
        self._closed = False
        self._seq = 0
        self._since_snapshot = 0
        if truncate:
            # a fresh server run must never replay a previous run's tail
            try:
                os.remove(self.path + SNAPSHOT_SUFFIX)
            except FileNotFoundError:  # toslint: allow-silent(no prior snapshot is the common fresh-run case)
                pass
            flags = os.O_WRONLY | os.O_CREAT | os.O_TRUNC | os.O_APPEND
        else:
            flags = os.O_WRONLY | os.O_CREAT | os.O_APPEND
        self._fd = os.open(self.path, flags, 0o644)

    # -- appending -----------------------------------------------------------

    def append(self, kind: str, payload: dict | None = None,
               sync: bool = True) -> int:
        """Durably append one record; returns its sequence number.  With
        ``sync=True`` (the default for state mutations) the record is on
        disk (fsync) before this returns — the caller may acknowledge the
        mutation to the network.  ``sync=False`` is for OBSERVATIONAL
        riders (ledger assign/ack records, replayed as no-ops): the write
        lands in the OS immediately and is flushed by the next synced
        append or snapshot, so a crash can lose at most the rider tail —
        never a mutation — while callers holding hot locks (the ledger
        condition) skip the fsync latency cliff."""
        with self._lock:
            if self._closed:
                raise ValueError("journal is closed")
            self._seq += 1
            seq = self._seq
            line = json.dumps({"n": seq, "k": kind, "d": payload or {}},
                              separators=(",", ":"), default=str)
            os.write(self._fd, line.encode("utf-8") + b"\n")
            if sync:
                os.fsync(self._fd)
            self._since_snapshot += 1
        return seq

    def appended_since_snapshot(self) -> int:
        with self._lock:
            return self._since_snapshot

    # -- snapshots -----------------------------------------------------------

    def snapshot(self, state: dict) -> None:
        """Atomically persist a full-state snapshot and truncate the journal
        (the records it folds in are no longer needed for recovery).  The
        caller must pass a ``state`` consistent with every record appended
        so far — hold the state lock across build-and-snapshot."""
        doc = json.dumps({"schema": SCHEMA, "seq": self._seq, "state": state},
                         separators=(",", ":"), default=str)
        tmp = self.path + SNAPSHOT_SUFFIX + ".tmp"
        with self._lock:
            if self._closed:
                raise ValueError("journal is closed")
            fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
            try:
                os.write(fd, doc.encode("utf-8"))
                os.fsync(fd)
            finally:
                os.close(fd)
            # replace-then-truncate: a crash in between leaves records the
            # snapshot already folded in — replay's seq filter skips them
            os.replace(tmp, self.path + SNAPSHOT_SUFFIX)
            os.ftruncate(self._fd, 0)
            os.fsync(self._fd)
            self._since_snapshot = 0

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                self._closed = True
                os.close(self._fd)

    @property
    def closed(self) -> bool:
        return self._closed


def replay(path: str) -> tuple[dict | None, list[dict]]:
    """Read back ``(snapshot_state_or_None, tail_records)`` for recovery.

    Deterministic: two replays of the same files return identical results.
    Records the snapshot already folded in (``n <= snapshot seq``) are
    skipped; a torn final line is dropped with a warning; any other
    corruption raises.
    """
    snap_state: dict | None = None
    snap_seq = 0
    snap_path = str(path) + SNAPSHOT_SUFFIX
    if os.path.exists(snap_path):
        with open(snap_path, encoding="utf-8") as f:
            doc = json.load(f)
        if doc.get("schema") != SCHEMA:
            raise ValueError(f"unknown journal snapshot schema in {snap_path}: "
                             f"{doc.get('schema')!r}")
        snap_state = doc.get("state") or {}
        snap_seq = int(doc.get("seq") or 0)
    records: list[dict] = []
    if os.path.exists(path):
        with open(path, "rb") as f:
            lines = f.read().split(b"\n")
        last_payload = max((i for i, raw in enumerate(lines) if raw.strip()),
                           default=-1)
        for i, raw in enumerate(lines):
            if not raw.strip():
                continue
            try:
                rec = json.loads(raw.decode("utf-8"))
            except ValueError:
                if i == last_payload:
                    # torn tail: the crash landed mid-append; the record was
                    # never acknowledged, dropping it is the correct outcome
                    logger.warning("dropping torn final journal record in %s",
                                   path)
                    break
                raise ValueError(
                    f"corrupt journal record at {path} line {i + 1}") from None
            if int(rec.get("n") or 0) <= snap_seq:
                continue  # already folded into the snapshot
            records.append(rec)
    return snap_state, records
