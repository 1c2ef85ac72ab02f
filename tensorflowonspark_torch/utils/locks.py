"""tossan, runtime half: named locks with an optional deadlock witness.

Every threaded module constructs its locks through :func:`tos_named_lock` /
:func:`tos_named_condition` instead of bare ``threading.Lock()`` /
``threading.Condition()``.  The *name* is the lock's identity in the global
acquisition-order graph — one node per name, so every ``Coordinator``
instance's ``coordinator._lock`` is the same node, which is the granularity
lock-order discipline is defined at (the static half,
``analysis/lockgraph.py``, resolves ``with self._lock:`` scopes to the same
names).

Witness off (the production default), a :class:`TosLock` costs one
attribute check per acquire/release on top of the underlying primitive —
the trace-stub pattern (``telemetry/trace.py``): instrumented code pays a
``None`` check, nothing else.

Witness on (``TOS_LOCK_WITNESS=1``; the tier-1 conftest turns it on for the
whole suite), every acquire:

- records the lock into a **per-thread held-set**;
- folds ``held -> acquired`` edges into a **global order graph**, keeping
  the first-observed stack per edge;
- **raises** :class:`LockOrderError` *at acquire time* when the new edge
  closes a cycle — catching an AB/BA deadlock the moment the second order
  is attempted, even when the threads never actually interleave into the
  deadly embrace this run (``TOS_LOCK_WITNESS=warn`` records a flight
  event + counter instead of raising, for soaks that must keep running);
- raises immediately on re-acquiring a non-reentrant lock this thread
  already holds (a guaranteed self-deadlock, no interleaving needed);
- waits in **stall-sized slices**: a lock with waiters held past
  ``TOS_LOCK_STALL_SECS`` dumps every thread's stack to the flight
  recorder (``telemetry.trace.event("lock_stall", ...)``) once per stall
  episode, then keeps waiting — the postmortem lands even if the process
  later wedges for good;
- emits **hold-time histograms** (``lock.hold_ms.<name>``) through the
  telemetry registry on release.

``threading.Condition`` integration: :class:`TosLock` implements the
``_is_owned`` / ``_release_save`` / ``_acquire_restore`` protocol, so
``cond.wait()`` keeps the witness held-set exact across the release/
re-acquire inside the wait.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback

from tensorflowonspark_torch.utils.envtune import env_float, env_str

#: Frames kept per recorded stack (first-observed edge sites, error reports).
STACK_DEPTH = 12


class LockOrderError(RuntimeError):
    """An acquisition order inversion: taking this lock while holding those
    locks closes a cycle in the global order graph — two threads running
    the two orders concurrently can deadlock."""


class _Witness:
    """Global lock-order witness shared by every :class:`TosLock`.

    Edge fast path: ``(held, acquired)`` pairs already in the graph are a
    dict hit with no lock taken (dict reads are atomic under the GIL);
    only a never-seen edge pays the graph lock + cycle check.
    """

    def __init__(self, mode: str = "raise",
                 stall_secs: float | None = None):
        self.mode = mode  # "raise" | "warn"
        self.stall_secs = (env_float("TOS_LOCK_STALL_SECS", 5.0)
                           if stall_secs is None else stall_secs)
        self._local = threading.local()
        # (held_name, acquired_name) -> first-observed formatted stack.
        # Guarded by _graph_lock for writes; read lock-free on the fast path.
        self._edges: dict[tuple[str, str], str] = {}
        self._succ: dict[str, set[str]] = {}  # name -> direct successors
        self._graph_lock = threading.Lock()
        self.inversions: list[str] = []  # warn-mode reports (tests assert ==[])

    # -- held-set ------------------------------------------------------------

    def _held(self) -> list:
        held = getattr(self._local, "held", None)
        if held is None:
            held = self._local.held = []
        return held

    def held_names(self) -> list[str]:
        return [lock.name for lock, _ in self._held()]

    # -- order graph ----------------------------------------------------------

    def _reachable(self, src: str, dst: str) -> list[str] | None:
        """A path ``src -> ... -> dst`` in the order graph, else None.
        Caller holds ``_graph_lock``."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._succ.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def _note_edges(self, lock: "TosLock", held: list) -> None:
        """Fold ``held -> lock`` edges in; raise/report on a closed cycle."""
        name = lock.name
        for other, _ in held:
            if other.name == name:
                continue  # distinct same-named instances: one graph node
            key = (other.name, name)
            if key in self._edges:  # fast path: known-good order
                continue
            with self._graph_lock:
                if key in self._edges:
                    continue
                back = self._reachable(name, other.name)
                if back is not None:
                    self._report_inversion(other.name, name, back)
                    continue  # warn mode fell through: record it anyway
                self._edges[key] = _brief_stack()
                self._succ.setdefault(other.name, set()).add(name)

    def _report_inversion(self, held_name: str, name: str,
                          back_path: list[str]) -> None:
        chain = " -> ".join(back_path + [name])
        first_hop = self._edges.get((back_path[0], back_path[1])) if (
            len(back_path) > 1) else None
        msg = (f"lock order inversion: acquiring '{name}' while holding "
               f"'{held_name}' closes the cycle {chain}\n"
               f"--- this acquisition (thread "
               f"{threading.current_thread().name}) ---\n{_brief_stack()}")
        if first_hop:
            msg += (f"--- first-observed reverse edge "
                    f"'{back_path[0]}' -> '{back_path[1]}' ---\n{first_hop}")
        from tensorflowonspark_torch.telemetry import trace

        trace.event("lock_inversion", lock=name, held=held_name, chain=chain)
        if self.mode == "raise":
            raise LockOrderError(msg)
        self.inversions.append(msg)

    # -- acquire / release -----------------------------------------------------

    def acquire(self, lock: "TosLock", blocking: bool, timeout: float) -> bool:
        held = self._held()
        if not lock.reentrant:
            for other, _ in held:
                if other is lock:
                    raise LockOrderError(
                        f"self-deadlock: thread "
                        f"{threading.current_thread().name} re-acquires "
                        f"non-reentrant lock '{lock.name}' it already "
                        f"holds\n{_brief_stack()}")
        if held:
            self._note_edges(lock, held)
        got = self._acquire_sliced(lock, blocking, timeout)
        if got:
            held.append((lock, time.monotonic()))
        return got

    def _acquire_sliced(self, lock: "TosLock", blocking: bool,
                        timeout: float) -> bool:
        """Blocking acquire in stall-sized slices so a starved waiter can
        dump the fleet's stacks without a watchdog thread."""
        inner = lock._inner
        if not blocking:
            return inner.acquire(False)
        deadline = None if timeout < 0 else time.monotonic() + timeout
        dumped = False
        waited = 0.0
        while True:
            if deadline is None:
                wait = self.stall_secs
            else:
                wait = min(self.stall_secs, deadline - time.monotonic())
                if wait < 0:
                    return False
            if inner.acquire(True, wait):
                return True
            waited += wait
            # only a wait that actually exceeded the stall budget is a
            # stall (a short caller timeout expiring is not)
            if not dumped and waited >= self.stall_secs:
                self._dump_stall(lock)
                dumped = True

    def _dump_stall(self, lock: "TosLock") -> None:
        """A lock with a waiter (us) held past the stall budget: dump every
        thread's stack to the flight recorder, once per episode."""
        from tensorflowonspark_torch.telemetry import trace

        names = {t.ident: t.name for t in threading.enumerate()}
        stacks = {}
        for ident, frame in sys._current_frames().items():
            tb = traceback.format_stack(frame, limit=STACK_DEPTH)
            stacks[names.get(ident, str(ident))] = "".join(tb)
        trace.event("lock_stall", lock=lock.name,
                    holder=lock.owner_name(), waiter=
                    threading.current_thread().name,
                    stall_secs=self.stall_secs, stacks=stacks)

    def release(self, lock: "TosLock") -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lock:
                _, t0 = held.pop(i)
                from tensorflowonspark_torch import telemetry

                telemetry.histogram(f"lock.hold_ms.{lock.name}").observe(
                    (time.monotonic() - t0) * 1e3)
                break
        lock._inner.release()


def _brief_stack() -> str:
    frames = traceback.format_stack(limit=STACK_DEPTH)
    # drop the witness's own frames from the tail: the report should end at
    # the acquire call site, not inside this module
    return "".join(f for f in frames if "/utils/locks.py" not in f)


class TosLock:
    """A named lock: raw ``threading.Lock``/``RLock`` semantics when the
    witness is off (one attribute check extra), full order/stall/hold-time
    witnessing when on.  Owner tracking (for ``Condition`` integration and
    stall reports) is two attribute stores per acquire/release."""

    __slots__ = ("name", "reentrant", "_inner", "_owner", "_count")

    def __init__(self, name: str, reentrant: bool = False):
        self.name = name
        self.reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()
        self._owner: int | None = None
        self._count = 0

    # -- core protocol ---------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        w = _witness
        if w is None:
            got = self._inner.acquire(blocking, timeout)
        else:
            got = w.acquire(self, blocking, timeout)
        if got:
            self._owner = threading.get_ident()
            self._count += 1
        return got

    def release(self) -> None:
        if self._count == 1:
            self._owner = None
        self._count -= 1
        w = _witness
        if w is None:
            self._inner.release()
        else:
            w.release(self)

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._owner is not None

    def owner_name(self) -> str | None:
        ident = self._owner
        if ident is None:
            return None
        for t in threading.enumerate():
            if t.ident == ident:
                return t.name
        return str(ident)

    # -- threading.Condition protocol -----------------------------------------
    # Condition(lock) drives these so cond.wait() keeps the witness held-set
    # exact across its internal release/re-acquire.

    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    def _release_save(self):
        state = (self._owner, self._count)
        self._owner, self._count = None, 0
        w = _witness
        if w is None:
            if state[1] > 1:  # reentrant: unwind every level
                for _ in range(state[1]):
                    self._inner.release()
            else:
                self._inner.release()
        else:
            for _ in range(state[1]):
                w.release(self)
        return state

    def _acquire_restore(self, state) -> None:
        owner, count = state
        w = _witness
        for _ in range(max(1, count)):
            if w is None:
                self._inner.acquire()
            else:
                w.acquire(self, True, -1)
        self._owner, self._count = owner, max(1, count)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "locked" if self.locked() else "unlocked"
        return f"<TosLock {self.name!r} {state}>"


def tos_named_lock(name: str, reentrant: bool = False) -> TosLock:
    """The one sanctioned lock constructor for threaded modules: ``name``
    is the node in the global order graph (convention:
    ``<module>.<attr>``, e.g. ``"coordinator._lock"``)."""
    _ensure_witness_init()
    return TosLock(name, reentrant=reentrant)


def tos_named_condition(name: str) -> threading.Condition:
    """A ``threading.Condition`` over a witnessed named lock."""
    return threading.Condition(tos_named_lock(name))


# -- witness lifecycle ---------------------------------------------------------

_witness: _Witness | None = None
_witness_init = False
_init_lock = threading.Lock()


def _ensure_witness_init() -> None:
    """Arm the witness from ``TOS_LOCK_WITNESS`` on first factory use
    (lazily, like the tracer singleton): '1'/'raise' raise on inversion,
    'warn' record-only, anything else off."""
    global _witness, _witness_init
    if _witness_init:
        return
    with _init_lock:
        if _witness_init:
            return
        raw = env_str("TOS_LOCK_WITNESS", "0").strip().lower()
        if raw in ("1", "true", "yes", "on", "raise"):
            _witness = _Witness(mode="raise")
        elif raw == "warn":
            _witness = _Witness(mode="warn")
        _witness_init = True


def enable_witness(mode: str = "raise",
                   stall_secs: float | None = None) -> _Witness:
    """Arm (or re-arm, resetting the graph) the witness — tests and the
    bench's off/on compare."""
    global _witness, _witness_init
    with _init_lock:
        _witness = _Witness(mode=mode, stall_secs=stall_secs)
        _witness_init = True
        return _witness


def disable_witness() -> None:
    global _witness, _witness_init
    with _init_lock:
        _witness = None
        _witness_init = True


def get_witness() -> _Witness | None:
    return _witness


def order_graph() -> dict[str, list[str]]:
    """The observed order graph (name -> sorted successors) — empty when
    the witness is off."""
    w = _witness
    if w is None:
        return {}
    with w._graph_lock:
        return {a: sorted(bs) for a, bs in w._succ.items()}
