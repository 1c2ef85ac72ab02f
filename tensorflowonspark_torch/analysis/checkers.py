"""The toslint checkers — this codebase's invariants, mechanically enforced.

Eight disciplines, each born from a class of bug the elastic control/data
plane makes likely (see ISSUE 2 / ROADMAP):

- ``knob-discipline``: every ``TOS_*`` env read goes through
  ``utils/envtune`` and is registered in ``utils/knobs.py`` (which the
  README table mirrors) — an undocumented knob is untunable in production.
- ``dial-discipline``: no raw ``socket.create_connection`` outside
  ``utils/net.py`` — a single-shot dial turns every restart window into a
  hard failure; ``connect_with_backoff`` is the one sanctioned dial.
- ``shard-io-discipline``: binary reads of record-shard files are confined
  to ``tfrecord.py``/``ingest/`` — an ad-hoc ``open(shard, 'rb')`` skips
  CRC verification and gzip detection.
- ``lock-discipline``: in the threaded modules, attributes mutated both
  under and outside ``self._lock`` (a data race until proven otherwise),
  and blocking calls made while a lock is held (a convoy/deadlock seed).
- ``reactor-discipline``: in the serving frontend's reactor classes, no
  blocking calls (sleeps, joins, blocking socket loops, lock waits) inside
  the reactor callback scope — one blocking call stalls EVERY connection.
- ``silent-except``: ``except ...: pass`` without a log line or an explicit
  ``# toslint: allow-silent(<reason>)`` pragma — silence is how invariants
  rot.
- ``metrics-discipline``: metric stores are created through the telemetry
  registry, never as ad-hoc module-level dicts of counters — an ad-hoc
  store is invisible to ``cluster.metrics()``/the run report and ignores
  the ``TOS_METRICS`` switch.  Spans follow the same rule: recorded
  through ``telemetry.trace`` with dotted-lowercase names, never buffered
  in module-level span lists.
- ``trace-purity``: no wall-clock reads, ``np.random``, ``os.environ`` or
  global/nonlocal mutation inside ``jax.jit``/``pjit``/``shard_map``-traced
  functions — tracing bakes the first value in forever.

All heuristics are lexical and intra-file by design: cheap enough for
tier-1, no imports of the checked code, false positives go to the committed
baseline (except the two never-baselined classes, which are always fixed).
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterator

from tensorflowonspark_torch.analysis.core import (
    Checker,
    Finding,
    ModuleSource,
    register_checker,
)


def _scoped_walk(node: ast.AST, scope: tuple[str, ...] = ()):
    """Yield (node, enclosing-scope tuple); scope nodes include themselves."""
    for child in ast.iter_child_nodes(node):
        child_scope = scope
        if isinstance(child, (ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            child_scope = scope + (child.name,)
        yield child, child_scope
        yield from _scoped_walk(child, child_scope)


def _qual(scope: tuple[str, ...]) -> str:
    return ".".join(scope) or "<module>"


def _terminal_name(func: ast.AST) -> str | None:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _module_consts(tree: ast.Module) -> dict[str, str]:
    """Module-level ``NAME = "literal"`` string constants (so the common
    ``ENV_VAR = "TOS_X"`` indirection stays visible to the env checkers)."""
    out: dict[str, str] = {}
    for stmt in tree.body:
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and isinstance(stmt.value, ast.Constant)
                and isinstance(stmt.value.value, str)):
            out[stmt.targets[0].id] = stmt.value.value
    return out


def _literal_str(node: ast.AST | None, consts: dict[str, str]) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    return None


# -- 1. knob discipline -------------------------------------------------------

_ENV_READ_QUALS = frozenset({
    "os.environ.get", "os.getenv", "os.environ.setdefault", "os.environ.pop",
})
_ENV_HELPERS = frozenset({"env_float", "env_int", "env_str", "env_bool"})


@register_checker
class KnobDisciplineChecker(Checker):
    """TOS_* env reads must go through utils/envtune + the knob registry."""

    id = "knob-discipline"
    hint = ("read the knob via utils/envtune (env_float/env_int/env_str/"
            "env_bool) and register it in utils/knobs.py")

    def __init__(self) -> None:
        self._used: set[str] = set()

    def check(self, mod: ModuleSource) -> Iterator[Finding]:
        exempt = mod.path.endswith("utils/envtune.py")
        consts = _module_consts(mod.tree)
        from tensorflowonspark_torch.utils import knobs

        for node, scope in _scoped_walk(mod.tree):
            if isinstance(node, ast.Call):
                fq = mod.imports.qualify(node.func)
                # alias-resolved terminal name: `env_float as _env_float`
                # still counts as the helper it is
                name = (fq.rsplit(".", 1)[-1] if fq
                        else _terminal_name(node.func))
                if fq in _ENV_READ_QUALS and not exempt:
                    knob = _literal_str(node.args[0] if node.args else None, consts)
                    if knob and knob.startswith("TOS_"):
                        yield Finding(
                            self.id, mod.path, node.lineno,
                            f"raw env read of {knob} (via {fq}) bypasses utils/envtune",
                            self.hint, f"{_qual(scope)}@{knob}")
                elif name in _ENV_HELPERS:
                    knob = _literal_str(node.args[0] if node.args else None, consts)
                    if knob is None:
                        yield Finding(
                            self.id, mod.path, node.lineno,
                            f"{name}() knob name is not a resolvable string "
                            "literal; static cross-checks cannot see it",
                            "pass the TOS_* name as a literal (or module "
                            "constant)", f"{_qual(scope)}@<dynamic>")
                    elif knob.startswith("TOS_"):
                        self._used.add(knob)
                        if knob not in knobs.KNOBS:
                            yield Finding(
                                self.id, mod.path, node.lineno,
                                f"knob {knob} is read but not registered in "
                                "utils/knobs.py",
                                "add a Knob(name, kind, default, doc) entry "
                                "and regenerate the README table",
                                f"{_qual(scope)}@{knob}")
            elif (isinstance(node, ast.Subscript)
                  and isinstance(node.ctx, ast.Load) and not exempt):
                if mod.imports.qualify(node.value) == "os.environ":
                    knob = _literal_str(node.slice, consts)
                    if knob and knob.startswith("TOS_"):
                        yield Finding(
                            self.id, mod.path, node.lineno,
                            f"raw env read of {knob} (os.environ[...]) "
                            "bypasses utils/envtune",
                            self.hint, f"{_qual(scope)}@{knob}")

    def finalize(self, project_root: Path | None) -> Iterator[Finding]:
        from tensorflowonspark_torch.utils import knobs

        for name in sorted(set(knobs.KNOBS) - self._used):
            yield Finding(
                self.id, "tensorflowonspark_torch/utils/knobs.py", 1,
                f"registered knob {name} is never read through utils/envtune",
                "delete the stale registry entry or wire the read through "
                "envtune", f"<registry>@{name}")
        readme = None if project_root is None else project_root / "README.md"
        if readme is None or not readme.exists():
            return
        lines = readme.read_text(encoding="utf-8").splitlines()
        span = knobs.find_table_block(lines)
        if span is None:
            yield Finding(
                self.id, "README.md", 1,
                "README has no generated knob table "
                f"({knobs.TABLE_BEGIN.split(' ')[0]}... markers missing)",
                "run `python -m tensorflowonspark_torch.analysis "
                "--write-knob-table`", "<readme>@knob-table")
            return
        begin, end = span
        block = "\n".join(lines[begin + 1:end]).strip()
        if block != knobs.knob_table_markdown().strip():
            yield Finding(
                self.id, "README.md", begin + 1,
                "README knob table is out of sync with utils/knobs.py",
                "run `python -m tensorflowonspark_torch.analysis "
                "--write-knob-table`", "<readme>@knob-table")


# -- 2. dial discipline -------------------------------------------------------


# The zero-copy socket primitives are easy to get subtly wrong (short
# writes, IOV_MAX, partial recv_into) — they live behind utils/net.py
# helpers (sendmsg_all / recv_exact_into), the framing layer in
# dataserver.py, and the collective peer transport built on that layer.
_ZEROCOPY_IO_NAMES = frozenset({"sendmsg", "recv_into"})
_ZEROCOPY_IO_ALLOWED = ("utils/net.py", "dataserver.py",
                        "collective/transport.py")
# Collective peer sockets (dials AND listeners) are confined to
# collective/transport.py: a peer channel outside it would sidestep the
# generation stamping / broken-connection abort cascade that makes a ring
# death recoverable — group.py/ops.py speak in ranks and tags only.
_COLLECTIVE_SOCKET_CALLS = frozenset({
    "connect_with_backoff", "bound_socket", "create_connection", "socket",
})
_COLLECTIVE_TRANSPORT = "collective/transport.py"
# Ingest-worker peer channels (the data-service tier's worker->trainer
# chunk streams) are confined to the existing transport homes: ingest/
# modules must speak through dataserver.DataClient/DataServer (authkey
# handshake, v2/v3 framing, ring upgrade, poison-on-failure) — an ad-hoc
# socket there would bypass authentication AND the at-least-once failure
# contract the forwarder's re-route path implements.
_INGEST_SOCKET_CALLS = _COLLECTIVE_SOCKET_CALLS


@register_checker
class DialDisciplineChecker(Checker):
    """Raw socket dials are forbidden outside utils/net.py; raw zero-copy
    socket I/O (sendmsg/recv_into) is confined to utils/net.py +
    dataserver.py + collective/transport.py; and within ``collective/``,
    peer sockets of ANY kind are confined to transport.py."""

    id = "dial-discipline"
    hint = ("dial via utils.net.connect_with_backoff (bounded retries + "
            "jitter); a one-shot connect fails hard across restart windows")
    collective_hint = ("open/dial collective peer sockets only in "
                       "collective/transport.py — it owns generation "
                       "stamping and the broken-connection abort cascade; "
                       "group.py/ops.py must go through PeerTransport")
    embed_hint = ("the embedding tier has no wire of its own: shard "
                  "exchanges ride the CollectiveGroup sparse ops and "
                  "serving lookups ride the embed data-feed queue pair — "
                  "a raw socket there would bypass generation fencing "
                  "and the authkey handshake")
    ingest_hint = ("ingest-worker peer channels ride dataserver."
                   "DataClient/DataServer (the transport homes): the "
                   "authkey handshake, wire framing, and the forwarder's "
                   "at-least-once re-route all live there — no raw "
                   "sockets in ingest/")

    def check(self, mod: ModuleSource) -> Iterator[Finding]:
        if mod.path.endswith("utils/net.py"):
            return
        io_exempt = mod.path.endswith(_ZEROCOPY_IO_ALLOWED)
        collective_confined = ("/collective/" in mod.path
                               and not mod.path.endswith(_COLLECTIVE_TRANSPORT))
        ingest_confined = "/ingest/" in mod.path
        embed_confined = "/embedding/" in mod.path
        for node, scope in _scoped_walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            fq = mod.imports.qualify(node.func)
            if collective_confined:
                name = (fq.rsplit(".", 1)[-1] if fq
                        else _terminal_name(node.func))
                if name in _COLLECTIVE_SOCKET_CALLS:
                    yield Finding(
                        self.id, mod.path, node.lineno,
                        f"collective peer socket ({name}()) outside "
                        "collective/transport.py bypasses the transport's "
                        "generation fencing and abort cascade",
                        self.collective_hint, f"{_qual(scope)}@{name}")
                    continue
            if embed_confined:
                name = (fq.rsplit(".", 1)[-1] if fq
                        else _terminal_name(node.func))
                if name in _COLLECTIVE_SOCKET_CALLS:
                    yield Finding(
                        self.id, mod.path, node.lineno,
                        f"raw socket ({name}()) in embedding/ — the tier "
                        "rides the collective transport and the embed "
                        "queue pair, never its own connections",
                        self.embed_hint, f"{_qual(scope)}@{name}")
                    continue
            if ingest_confined:
                name = (fq.rsplit(".", 1)[-1] if fq
                        else _terminal_name(node.func))
                if name in _INGEST_SOCKET_CALLS:
                    yield Finding(
                        self.id, mod.path, node.lineno,
                        f"ingest-worker peer socket ({name}()) in ingest/ "
                        "bypasses the data-plane transport homes "
                        "(authkey handshake + at-least-once re-route)",
                        self.ingest_hint, f"{_qual(scope)}@{name}")
                    continue
            if fq == "socket.create_connection":
                yield Finding(
                    self.id, mod.path, node.lineno,
                    "raw socket.create_connection bypasses connect_with_backoff",
                    self.hint, f"{_qual(scope)}@create_connection")
            elif not io_exempt:
                name = _terminal_name(node.func)
                if name in _ZEROCOPY_IO_NAMES:
                    yield Finding(
                        self.id, mod.path, node.lineno,
                        f"raw {name}() outside utils/net.py/dataserver.py/"
                        "collective/transport.py — scatter-gather/"
                        "preallocated-buffer socket I/O must go through the "
                        "shared helpers (short writes, IOV_MAX, partial "
                        "reads are handled there once)",
                        "use utils.net.sendmsg_all / recv_exact_into (or the "
                        "dataserver framing layer)",
                        f"{_qual(scope)}@{name}")


# -- 2b. shard IO discipline --------------------------------------------------

# Record shards carry per-record CRCs and optional whole-stream gzip; the
# ONLY readers that honour both live in tfrecord.py (read_records /
# read_record_spans) and the ingest pipeline built on them.  An ad-hoc
# `open(shard_path, "rb")` elsewhere silently skips CRC verification (and
# misparses gzip shards), so binary opens of shard-looking paths are
# confined.  Heuristic is lexical like the rest of toslint: the filename
# expression's source text mentioning shard/tfrecord/part- is the signal.
_SHARDISH_ARG = re.compile(r"shard|tfrecord|part-", re.IGNORECASE)
_SHARD_OPEN_QUALS = frozenset({"open", "io.open", "gzip.open"})
# View producers over shard buffers: confined tighter than binary opens
# (tfrecord.py + dfutil.py only) because a view carries the zero-copy
# LIFETIME contract — valid until its chunk is released, the whole shard
# buffer pinned while it lives — and an ad-hoc producer hands out views
# that no release/debug machinery tracks.
_SHARD_VIEW_QUALS = frozenset({"memoryview", "mmap.mmap"})


@register_checker
class ShardIODisciplineChecker(Checker):
    """Binary reads of record-shard files are confined to tfrecord.py and
    ingest/ — everything else must go through the verifying codecs.  Raw
    buffer/mmap views of shard data are confined tighter still
    (tfrecord.py/dfutil.py): view producers own the zero-copy lifetime
    contract."""

    id = "shard-io-discipline"
    hint = ("read shards via tfrecord.read_records/read_record_spans (or "
            "the ingest pipeline / dfutil.read_shard) — a raw open() "
            "bypasses CRC verification and gzip detection")
    view_hint = ("produce record views via tfrecord.record_views / "
                 "read_record_spans (or dfutil.decode_span_columns) — "
                 "ad-hoc memoryview/mmap slicing of shard data bypasses "
                 "the zero-copy lifetime contract (views valid only until "
                 "their chunk is released)")

    def check(self, mod: ModuleSource) -> Iterator[Finding]:
        if mod.path.endswith("tfrecord.py"):
            return
        view_exempt = mod.path.endswith("dfutil.py")
        open_exempt = "/ingest/" in mod.path
        for node, scope in _scoped_walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            fq = mod.imports.qualify(node.func)
            if fq in _SHARD_VIEW_QUALS:
                if view_exempt:
                    continue
                call_src = ast.unparse(node)
                if _SHARDISH_ARG.search(call_src):
                    yield Finding(
                        self.id, mod.path, node.lineno,
                        f"raw shard-buffer view ({call_src[:60]}) outside "
                        "tfrecord.py/dfutil.py bypasses the zero-copy "
                        "lifetime contract",
                        self.view_hint, f"{_qual(scope)}@{fq}")
                continue
            if open_exempt:
                continue
            name = fq if fq in _SHARD_OPEN_QUALS else None
            if name is None and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "read_bytes":
                # Path(...).read_bytes() — a binary read by construction
                target_src = ast.unparse(node.func.value)
                if _SHARDISH_ARG.search(target_src):
                    yield Finding(
                        self.id, mod.path, node.lineno,
                        f"raw binary read of a record shard "
                        f"({target_src}.read_bytes()) outside "
                        "tfrecord.py/ingest/ skips CRC verification",
                        self.hint, f"{_qual(scope)}@read_bytes")
                continue
            if name is None:
                continue
            if not self._is_binary_read(node, name):
                continue
            target = node.args[0] if node.args else None
            target_src = ast.unparse(target) if target is not None else ""
            if _SHARDISH_ARG.search(target_src):
                yield Finding(
                    self.id, mod.path, node.lineno,
                    f"raw binary open of a record shard ({name}("
                    f"{target_src}, ...)) outside tfrecord.py/ingest/ "
                    "skips CRC verification",
                    self.hint, f"{_qual(scope)}@{name}")

    @staticmethod
    def _is_binary_read(call: ast.Call, name: str) -> bool:
        """True when the open() mode is a literal binary READ ('rb'...).
        Dynamic (non-literal) modes stay quiet (can't judge without false
        positives) — but an ABSENT mode on ``gzip.open`` counts: its
        default is 'rb', exactly the CRC-bypassing read this checker
        confines.  Writes are the writer's business (RecordWriter owns
        shard writes, but e.g. benchmarks legitimately stage raw files)."""
        mode_node = None
        if len(call.args) >= 2:
            mode_node = call.args[1]
        for kw in call.keywords:
            if kw.arg == "mode":
                mode_node = kw.value
        if mode_node is None:
            return name == "gzip.open"  # plain open() defaults to text 'r'
        if not (isinstance(mode_node, ast.Constant)
                and isinstance(mode_node.value, str)):
            return False
        mode = mode_node.value
        return "b" in mode and not any(c in mode for c in "wax+")


# -- journal-write discipline (ISSUE 13) --------------------------------------

# Journal-ish path expressions: the coordinator's write-ahead journal files
# (coordinator.journal / *.snap) — lexical signal, like the shard heuristic.
_JOURNALISH_ARG = re.compile(r"journal", re.IGNORECASE)
_JOURNAL_OPEN_QUALS = frozenset({"open", "io.open", "os.open"})


@register_checker
class JournalDisciplineChecker(Checker):
    """The write-ahead journal's durability contract lives in ONE module:
    ``journal.py`` owns every ``os.fsync`` call and every journal-file
    open.  An ad-hoc fsync elsewhere is a hidden latency cliff on whatever
    lock its caller holds; an ad-hoc journal-file open bypasses the
    append-ordering / torn-tail / snapshot-atomicity rules recovery
    correctness depends on (replay must be able to trust the file)."""

    id = "journal-discipline"
    hint = ("route durable appends/snapshots through journal.Journal (and "
            "reads through journal.replay) — fsync discipline and journal "
            "file opens are confined to journal.py")

    def check(self, mod: ModuleSource) -> Iterator[Finding]:
        if mod.path.endswith("/journal.py"):
            return
        for node, scope in _scoped_walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            fq = mod.imports.qualify(node.func)
            if fq == "os.fsync":
                yield Finding(
                    self.id, mod.path, node.lineno,
                    "os.fsync outside journal.py: durable-write discipline "
                    "is confined to the journal module",
                    self.hint, f"{_qual(scope)}@os.fsync")
                continue
            if fq not in _JOURNAL_OPEN_QUALS:
                continue
            target = node.args[0] if node.args else None
            target_src = ast.unparse(target) if target is not None else ""
            if _JOURNALISH_ARG.search(target_src):
                yield Finding(
                    self.id, mod.path, node.lineno,
                    f"journal file opened outside journal.py ({fq}("
                    f"{target_src[:60]}, ...)) bypasses the append/replay "
                    "contract",
                    self.hint, f"{_qual(scope)}@{fq}")


# -- 3. lock discipline / race heuristics ------------------------------------

_THREADED_BASENAMES = frozenset({
    "coordinator.py", "cluster.py", "dataserver.py", "supervisor.py",
    "node.py", "feeding.py",
    # the write-ahead journal: appended from handler threads + the stats
    # thread's snapshot fold under its own lock
    "journal.py",
    # the collective layer: dataserver connection threads deliver into the
    # inbox while the comm executor sends and the map_fun thread reforms
    "transport.py", "group.py", "ops.py",
    # the online-serving subsystem is thread-per-replica + flush/watch
    # threads throughout — same race classes, same discipline
    "gateway.py", "batcher.py", "router.py",
    # staged rollouts + tenant fairness: the governor thread shares its
    # sliding windows with router workers (rollout.py), and the tenant
    # queues (tenancy.py) are owned by the batcher under ITS lock — new
    # locked sections added there must keep the same discipline
    "rollout.py", "tenancy.py",
    # the reactor frontend: completion threads hand replies to the reactor
    "frontend.py",
    # the DIRECT-mode ingest pipeline: claimer + reader pool + consumer —
    # and the data-service tier (service.py): reader threads tee into the
    # shared ChunkCache while the forwarder thread serves from it
    "readers.py", "feed.py", "service.py",
    # the autoscaling subsystem: the Autoscaler tick thread (loop.py) races
    # user stop()/report() calls, and the governor (policy.py) is mutated
    # from whatever thread drives decide()
    "loop.py", "policy.py",
    # the sharded-embedding tier: the serving replica's responder thread
    # reads shard rows the reload handler swaps (serve.py), and the table/
    # shard state (table.py, sharding.py) is shared between the train-step
    # thread and checkpoint/restore paths
    "serve.py", "table.py", "sharding.py",
})
_BLOCKING_NAMES = frozenset({
    "recv", "accept", "join", "sleep", "connect_with_backoff",
    # this tree's blocking socket-I/O wrappers (dataserver/coordinator frame
    # helpers + utils.net.recv_exact) — without these the checker would be
    # blind to blocking-under-lock written the idiomatic way here
    "_send", "_recv", "_send_msg", "_recv_msg", "recv_exact",
})
# join() on paths/strings is not the thread join this checker hunts
_SAFE_JOIN_QUALS = frozenset({
    "os.path.join", "posixpath.join", "ntpath.join",
    "os.pathsep.join", "os.sep.join", "os.linesep.join",
})
_LOCKISH_FRAGMENTS = ("lock", "cond", "mutex")


def _is_lockish(expr: ast.AST) -> bool:
    name = _terminal_name(expr)
    return bool(name) and any(s in name.lower() for s in _LOCKISH_FRAGMENTS)


@register_checker
class LockDisciplineChecker(Checker):
    """Race heuristics for the threaded modules: attributes mutated both
    under and outside the instance lock, and blocking calls under a lock."""

    id = "lock-discipline"
    hint = ("hold the lock for every mutation of shared attributes, and "
            "move blocking calls (I/O, sleeps, joins) outside the critical "
            "section")

    def check(self, mod: ModuleSource) -> Iterator[Finding]:
        if mod.basename not in _THREADED_BASENAMES:
            return
        for node, scope in _scoped_walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                yield from self._check_class(mod, node, scope)

    def _check_class(self, mod: ModuleSource, cls: ast.ClassDef,
                     scope: tuple[str, ...]) -> Iterator[Finding]:
        # attr -> list of (locked, line, method)
        mutations: dict[str, list[tuple[bool, int, str]]] = {}
        blocking: list[tuple[str, int, str]] = []  # (call name, line, method)

        def scan(node: ast.AST, locked: bool, method: str) -> None:
            if isinstance(node, (ast.With, ast.AsyncWith)):
                inner = locked or any(_is_lockish(i.context_expr) for i in node.items)
                for item in node.items:
                    scan(item, locked, method)
                for stmt in node.body:
                    scan(stmt, inner, method)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                # a closure runs later, not while this frame holds the lock
                body = node.body if isinstance(node.body, list) else [node.body]
                for stmt in body:
                    scan(stmt, False, method)
                return
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)) and not (
                    isinstance(node, ast.AnnAssign) and node.value is None):
                # a bare `self.x: T` annotation writes nothing
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    for attr in self._self_attrs(t):
                        mutations.setdefault(attr, []).append(
                            (locked, node.lineno, method))
            if isinstance(node, ast.Call) and locked:
                name = _terminal_name(node.func)
                if name in _BLOCKING_NAMES and not self._safe_join(mod, node):
                    blocking.append((name, node.lineno, method))
            for child in ast.iter_child_nodes(node):
                scan(child, locked, method)

        for item in cls.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if item.name == "__init__":
                    continue  # construction happens-before publication
                # `*_locked` suffix is this codebase's caller-holds-the-lock
                # contract: the body runs inside the caller's critical
                # section (so its mutations ARE locked, and blocking calls
                # in it ARE blocking-under-lock)
                held = item.name.endswith("_locked")
                for stmt in item.body:
                    scan(stmt, held, item.name)

        qual = _qual(scope)
        for name, line, method in blocking:
            yield Finding(
                self.id, mod.path, line,
                f"blocking call {name}() while holding a lock "
                f"(in {qual}.{method})",
                self.hint, f"{qual}.{method}@block:{name}")
        for attr, sites in sorted(mutations.items()):
            locked_methods = sorted({m for locked, _, m in sites if locked})
            if not locked_methods:
                continue
            for locked, line, method in sites:
                if locked:
                    continue
                yield Finding(
                    self.id, mod.path, line,
                    f"self.{attr} is mutated under the lock elsewhere "
                    f"(e.g. {qual}.{locked_methods[0]}) but without it in "
                    f"{qual}.{method} — racy unless externally serialized",
                    self.hint, f"{qual}.{method}@mixed:{attr}")

    @staticmethod
    def _self_attrs(target: ast.AST) -> list[str]:
        """Attribute names a target mutates on ``self`` (including
        ``self.x[...] = ...`` container writes)."""
        if isinstance(target, (ast.Tuple, ast.List)):
            return [a for t in target.elts for a in LockDisciplineChecker._self_attrs(t)]
        if isinstance(target, ast.Starred):
            return LockDisciplineChecker._self_attrs(target.value)
        node = target
        if isinstance(node, ast.Subscript):
            node = node.value
        if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return [node.attr]
        return []

    @staticmethod
    def _safe_join(mod: ModuleSource, call: ast.Call) -> bool:
        func = call.func
        if not isinstance(func, ast.Attribute) or func.attr != "join":
            return False
        if isinstance(func.value, ast.Constant):  # "".join / b"".join
            return True
        return mod.imports.qualify(func) in _SAFE_JOIN_QUALS


# -- 3b. reactor discipline ---------------------------------------------------

# The serving frontend multiplexes EVERY gateway connection on one reactor
# thread; a single blocking call in its callback scope stalls the whole
# endpoint (every client's p99, not one).  Scope contract, mirrored in
# serving/frontend.py's threading docstring: every method of a ``*Reactor*``
# class runs on (or must be safe on) the reactor thread, EXCEPT ``__init__``
# (pre-publication) and ``stop`` (the caller-thread join point).
_REACTOR_PATH_SUFFIXES = ("serving/frontend.py",)
_REACTOR_EXEMPT_METHODS = frozenset({"__init__", "stop"})
# Calls that block: sleeps/joins, the blocking socket-loop helpers
# (recv_exact*/sendall/sendmsg_all loop until done — the reactor must use
# one-shot recv/sendmsg_some), dials, and lock/event waits.  Non-blocking
# recv/accept/select on the reactor's own non-blocking fds stay legal.
_REACTOR_BLOCKING = frozenset({
    "sleep", "join", "recv_exact", "recv_exact_into", "sendall",
    "sendmsg_all", "connect_with_backoff", "wait", "acquire",
})


@register_checker
class ReactorDisciplineChecker(Checker):
    """No blocking calls inside the serving reactor's callback scope."""

    id = "reactor-discipline"
    hint = ("the reactor thread serves every connection: park partial I/O "
            "on the write queue / decode buffer and let the selector re-arm "
            "it, or hand the work to a completion thread")

    def check(self, mod: ModuleSource) -> Iterator[Finding]:
        if not mod.path.endswith(_REACTOR_PATH_SUFFIXES):
            return
        for node, scope in _scoped_walk(mod.tree):
            if not (isinstance(node, ast.ClassDef) and "Reactor" in node.name):
                continue
            for item in node.body:
                if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if item.name in _REACTOR_EXEMPT_METHODS:
                    continue
                # _scoped_walk scopes include the class node itself
                yield from self._scan_method(mod, scope, item)

    def _scan_method(self, mod: ModuleSource, scope: tuple[str, ...],
                     fn: ast.AST) -> Iterator[Finding]:
        qual = f"{_qual(scope)}.{fn.name}"
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = _terminal_name(node.func)
            if name not in _REACTOR_BLOCKING:
                continue
            if name == "join" and LockDisciplineChecker._safe_join(mod, node):
                continue
            yield Finding(
                self.id, mod.path, node.lineno,
                f"blocking call {name}() inside reactor callback scope "
                f"({qual}) — it stalls every gateway connection at once",
                self.hint, f"{qual}@block:{name}")


@register_checker
class TimeoutDisciplineChecker(Checker):
    """Every blocking wait in ``collective/`` must be bounded.

    The gray-failure machinery (straggler detection, quorum eviction,
    degraded-world continuation) only works because NO wait in the
    collective layer can exceed one collective timeout: an unbounded
    ``fut.result()``, ``cond.wait()``, or default-budget peer ``recv``
    turns one slow peer into a wedged trainer no eviction can rescue.
    This pins the invariant mechanically: ``result``/``wait`` calls need a
    timeout (keyword or positional), and peer-plane ``recv`` calls must
    pass their budget EXPLICITLY (the ops layer derives per-op deadlines —
    relying on an implicit transport default hides the bound from the
    reader and from this checker alike)."""

    id = "timeout-discipline"
    hint = ("bound the wait: fut.result(timeout=...), cond.wait(secs), "
            "tp.recv(..., timeout=_left(deadline)) — an unbounded block in "
            "collective/ turns one gray peer into an unevictable wedge")

    _WAIT_ATTRS = frozenset({"result", "wait", "recv"})

    def check(self, mod: ModuleSource) -> Iterator[Finding]:
        if "/collective/" not in mod.path:
            return
        for node, scope in _scoped_walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            attr = node.func.attr
            if attr not in self._WAIT_ATTRS:
                continue
            bounded_kw = any(
                kw.arg == "timeout"
                and not (isinstance(kw.value, ast.Constant)
                         and kw.value.value is None)
                for kw in node.keywords)
            if attr == "recv":
                # inbox.recv carries a required positional timeout (5 args);
                # transport-level recv must say its budget out loud
                if bounded_kw or len(node.args) >= 4:
                    continue
            elif bounded_kw or node.args:
                continue
            yield Finding(
                self.id, mod.path, node.lineno,
                f"unbounded blocking {attr}() in the collective layer — a "
                "gray (slow-not-dead) peer wedges this wait past any "
                "eviction",
                self.hint, f"{_qual(scope)}@{attr}")


# -- 4. silent-exception discipline ------------------------------------------


@register_checker
class SilentExceptChecker(Checker):
    """``except ...: pass`` needs a log line or an allow-silent pragma."""

    id = "silent-except"
    hint = ("log the swallow (logger.debug at least, with exc_info where "
            "useful) or annotate `# toslint: allow-silent(<reason>)`")

    def check(self, mod: ModuleSource) -> Iterator[Finding]:
        for node, scope in _scoped_walk(mod.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not all(self._is_noop(stmt) for stmt in node.body):
                continue
            if mod.pragmas.allow_silent(node.lineno, node.body[0].lineno):
                continue
            exc = ast.unparse(node.type) if node.type is not None else "<bare>"
            yield Finding(
                self.id, mod.path, node.lineno,
                f"`except {exc}: pass` swallows the error with no trace",
                self.hint, f"{_qual(scope)}@except:{exc}")

    @staticmethod
    def _is_noop(stmt: ast.stmt) -> bool:
        return isinstance(stmt, ast.Pass) or (
            isinstance(stmt, ast.Expr)
            and isinstance(stmt.value, ast.Constant)
            and stmt.value.value is Ellipsis)


# -- 5. metrics discipline ----------------------------------------------------

# Names that telegraph "this is a metrics container" — a module-level dict
# of ad-hoc counters is invisible to cluster.metrics()/the run report and
# bypasses the no-op TOS_METRICS switch.
_METRICISH_NAME = re.compile(
    r"(?:^|_)(metrics?|counters?|gauges?|histograms?|stats?|timings?)(?:_|$)",
    re.IGNORECASE)
# container constructors that make a mutable metrics store
_METRIC_CONTAINER_CALLS = frozenset({
    "dict", "defaultdict", "OrderedDict",
})
# Same idea for trace spans: a module-level list/deque of span records
# bypasses telemetry.trace's per-thread rings — it never reaches the
# heartbeat piggyback, the merged trace.json, or the TOS_TRACE switch.
_SPANISH_NAME = re.compile(r"(?:^|_)(spans?|traces?)(?:_|$)", re.IGNORECASE)
_SPAN_CONTAINER_CALLS = _METRIC_CONTAINER_CALLS | frozenset({"list", "deque"})
# Span-name-bearing telemetry.trace entry points: their literal name must be
# dotted lowercase (`layer.what`), matching the metric-name convention, so
# merged traces group by subsystem instead of by whoever spelled it.
_SPAN_RECORD_ATTRS = frozenset({"span", "record_span", "record_child"})
_SPAN_NAME_RE = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_]+)+$")


@register_checker
class MetricsDisciplineChecker(Checker):
    """Metric stores must be created through the telemetry registry
    (``telemetry.counter/gauge/histogram``), not as ad-hoc module-level
    dicts/``collections.Counter``s of counts: an ad-hoc store never reaches
    the heartbeat piggyback, ``cluster.metrics()``, or the run report, and
    ignores the ``TOS_METRICS`` kill switch."""

    id = "metrics-discipline"
    hint = ("create the metric through tensorflowonspark_torch.telemetry "
            "(counter()/gauge()/histogram()/timed()) so it reaches "
            "cluster.metrics(), the run report, and the TOS_METRICS switch")
    span_hint = ("record spans through tensorflowonspark_torch.telemetry."
                 "trace (span()/record_span()/record_child()) with a "
                 "dotted-lowercase name (e.g. 'serve.wire') so they reach "
                 "the heartbeat piggyback, trace.json, and the TOS_TRACE "
                 "switch")

    def check(self, mod: ModuleSource) -> Iterator[Finding]:
        # the registry/tracer implementations are the one sanctioned home
        if "/telemetry/" in mod.path:
            return
        yield from self._check_span_calls(mod)
        for stmt in mod.tree.body:
            if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                continue
            targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            names = [t.id for t in targets if isinstance(t, ast.Name)]
            if not names:
                continue
            value = stmt.value
            if value is None:
                continue
            if self._is_collections_counter(mod, value):
                yield Finding(
                    self.id, mod.path, stmt.lineno,
                    f"module-level collections.Counter {names[0]!r} is an "
                    "ad-hoc metrics store outside the telemetry registry",
                    self.hint, f"<module>@{names[0]}")
                continue
            if (any(_SPANISH_NAME.search(n) for n in names)
                    and self._is_span_container(mod, value)):
                yield Finding(
                    self.id, mod.path, stmt.lineno,
                    f"module-level span buffer {names[0]!r} bypasses the "
                    "telemetry tracer (invisible to the heartbeat "
                    "piggyback, trace.json, and the TOS_TRACE switch)",
                    self.span_hint, f"<module>@{names[0]}")
                continue
            if not any(_METRICISH_NAME.search(n) for n in names):
                continue
            if self._is_container_literal(mod, value):
                yield Finding(
                    self.id, mod.path, stmt.lineno,
                    f"module-level metrics container {names[0]!r} bypasses "
                    "the telemetry registry (invisible to cluster.metrics() "
                    "and the TOS_METRICS switch)",
                    self.hint, f"<module>@{names[0]}")

    def _check_span_calls(self, mod: ModuleSource) -> Iterator[Finding]:
        """Span names recorded through telemetry.trace must be dotted
        lowercase (``layer.what``) — the metric-name convention, applied to
        spans so merged traces group by subsystem."""
        consts = _module_consts(mod.tree)
        for node, scope in _scoped_walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _SPAN_RECORD_ATTRS):
                continue
            if not self._is_tracer_receiver(mod, node.func):
                continue  # e.g. re.Match.span("group") is not our API
            name = _literal_str(node.args[0] if node.args else None, consts)
            if name is None or _SPAN_NAME_RE.match(name):
                continue
            yield Finding(
                self.id, mod.path, node.lineno,
                f"span name {name!r} is not dotted lowercase "
                "(expected e.g. 'serve.wire')",
                self.span_hint, f"{_qual(scope)}@span:{name}")

    @staticmethod
    def _is_tracer_receiver(mod: ModuleSource, func: ast.Attribute) -> bool:
        """True when ``<recv>.span/record_*`` plausibly targets
        telemetry.trace: the imported module (any alias), a Tracer-ish
        local (``tracer``/``ttrace``/``trace``/``tr``), or a
        ``get_tracer()`` call — not every object with a ``.span`` method
        (``re.Match.span`` takes a group, not a span name)."""
        fq = mod.imports.qualify(func)
        if fq and (".telemetry.trace." in fq
                   or fq.startswith("telemetry.trace.")):
            return True
        recv = func.value
        if isinstance(recv, ast.Call):
            return _terminal_name(recv.func) == "get_tracer"
        return _terminal_name(recv) in ("trace", "ttrace", "tracer", "tr")

    @staticmethod
    def _is_span_container(mod: ModuleSource, value: ast.AST) -> bool:
        if isinstance(value, (ast.List, ast.Dict, ast.DictComp, ast.ListComp)):
            return True
        if isinstance(value, ast.Call):
            fq = mod.imports.qualify(value.func)
            name = fq.rsplit(".", 1)[-1] if fq else _terminal_name(value.func)
            return name in _SPAN_CONTAINER_CALLS
        return False

    @staticmethod
    def _is_collections_counter(mod: ModuleSource, value: ast.AST) -> bool:
        return (isinstance(value, ast.Call)
                and mod.imports.qualify(value.func) == "collections.Counter")

    @staticmethod
    def _is_container_literal(mod: ModuleSource, value: ast.AST) -> bool:
        if isinstance(value, (ast.Dict, ast.DictComp)):
            return True
        if isinstance(value, ast.Call):
            fq = mod.imports.qualify(value.func)
            name = fq.rsplit(".", 1)[-1] if fq else _terminal_name(value.func)
            return name in _METRIC_CONTAINER_CALLS
        return False


# -- 6. trace purity ----------------------------------------------------------

_JIT_NAMES = frozenset({"jit", "pjit", "shard_map"})
_IMPURE_CALL_QUALS = frozenset({
    "time.time", "time.monotonic", "time.perf_counter", "time.time_ns",
    "os.getenv",
})


def _is_jit_expr(mod: ModuleSource, expr: ast.AST) -> bool:
    """True for ``jax.jit`` / ``pjit`` / ``shard_map`` (bare or aliased),
    ``jax.jit(...)`` calls, and ``partial(jax.jit, ...)``."""
    name = _terminal_name(expr)
    if name in _JIT_NAMES:
        return True
    if isinstance(expr, ast.Call):
        if _terminal_name(expr.func) == "partial":
            return any(_is_jit_expr(mod, a) for a in expr.args)
        return _is_jit_expr(mod, expr.func)
    return False


@register_checker
class TracePurityChecker(Checker):
    """No wall-clock, np.random, os.environ, or global/nonlocal mutation
    inside jit/pjit/shard_map-traced functions: tracing runs the Python body
    ONCE, so any such value is frozen into the compiled program."""

    id = "trace-purity"
    hint = ("hoist the impure read out of the traced function and pass the "
            "value (or a jax.random key) as an argument")

    def check(self, mod: ModuleSource) -> Iterator[Finding]:
        traced: list[ast.AST] = []
        wrapped_names: set[str] = set()
        for node, _ in _scoped_walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if any(_is_jit_expr(mod, d) for d in node.decorator_list):
                    traced.append(node)
            elif isinstance(node, ast.Call) and _terminal_name(node.func) in _JIT_NAMES:
                if node.args:
                    if isinstance(node.args[0], ast.Name):
                        wrapped_names.add(node.args[0].id)
                    elif isinstance(node.args[0], ast.Lambda):
                        traced.append(node.args[0])
        if wrapped_names:
            for node, _ in _scoped_walk(mod.tree):
                if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and node.name in wrapped_names and node not in traced):
                    traced.append(node)

        seen: set[tuple[int, str]] = set()
        for fn in traced:
            fn_name = getattr(fn, "name", "<lambda>")
            for finding in self._scan_traced(mod, fn, fn_name):
                key = (finding.line, finding.anchor)
                if key not in seen:
                    seen.add(key)
                    yield finding

    def _scan_traced(self, mod: ModuleSource, fn: ast.AST,
                     fn_name: str) -> Iterator[Finding]:
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                fq = mod.imports.qualify(node.func)
                if fq in _IMPURE_CALL_QUALS:
                    yield Finding(
                        self.id, mod.path, node.lineno,
                        f"impure call {fq}() inside traced function "
                        f"{fn_name!r} — the traced value is frozen at "
                        "compile time", self.hint, f"{fn_name}@{fq}")
                elif fq and fq.startswith("numpy.random."):
                    yield Finding(
                        self.id, mod.path, node.lineno,
                        f"{fq}() inside traced function {fn_name!r} — host "
                        "RNG state is invisible to XLA; every trace replays "
                        "the same draw",
                        "use jax.random with an explicit PRNGKey argument",
                        f"{fn_name}@{fq}")
            elif isinstance(node, ast.Attribute):
                if mod.imports.qualify(node) == "os.environ":
                    yield Finding(
                        self.id, mod.path, node.lineno,
                        f"os.environ read inside traced function {fn_name!r}"
                        " — the trace bakes in the value at compile time",
                        "read the env before tracing and pass the value in",
                        f"{fn_name}@os.environ")
            elif isinstance(node, (ast.Global, ast.Nonlocal)):
                kind = "global" if isinstance(node, ast.Global) else "nonlocal"
                names = ", ".join(node.names)
                yield Finding(
                    self.id, mod.path, node.lineno,
                    f"{kind} mutation of {names} inside traced function "
                    f"{fn_name!r} — side effects run once at trace time, "
                    "not per step",
                    "traced functions must be pure; return the new value "
                    "instead", f"{fn_name}@{kind}:{names}")


@register_checker
class LockOrderChecker(Checker):
    """tossan static half: whole-tree interprocedural lock-order analysis.

    Per-file ``check`` only accumulates parsed modules; the graph build,
    cycle detection, and callback-under-lock flags all happen in
    ``finalize`` because an acquisition-order cycle is by definition a
    property of the whole tree (see ``analysis/lockgraph.py``).  Findings
    are in ``NEVER_BASELINE``: a cycle is a latent deadlock — fixed, or
    explained inline with ``# toslint: allow-lock-order(<why>)``.
    """

    id = "lock-order"
    hint = ("establish one global acquisition order, or annotate the edge "
            "with `# toslint: allow-lock-order(<why>)`")

    def __init__(self) -> None:
        self._mods: list[ModuleSource] = []

    def check(self, mod: ModuleSource) -> Iterator[Finding]:
        self._mods.append(mod)
        return iter(())

    def finalize(self, project_root: Path | None) -> Iterator[Finding]:
        from tensorflowonspark_torch.analysis import lockgraph

        graph = lockgraph.build_lockgraph(self._mods)
        yield from lockgraph.lock_order_findings(graph)
