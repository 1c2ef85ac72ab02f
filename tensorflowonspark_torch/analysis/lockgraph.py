"""tossan, static half: whole-tree lock-order analysis (the ``lock-order``
checker).

The per-file ``lock-discipline`` checker sees one module at a time, so an
acquisition-order cycle between two modules (coordinator takes its lock and
calls into the journal, which takes its own; elsewhere the journal calls
back into the coordinator) is invisible until a chaos test hangs.  This
pass is interprocedural over the whole package tree:

1. **Type inference from constructors** — ``self._journal = Journal(...)``
   in ``__init__`` gives attribute ``_journal`` the tree-class type
   ``journal.Journal``; ``self._lock = tos_named_lock("coordinator._lock")``
   (or a bare ``threading.Lock()``) makes ``_lock`` a lock attribute whose
   graph node is the literal name (or ``<module>.<Class>.<attr>`` for
   unnamed locks).  ``self._cb = on_flush`` (a constructor parameter)
   makes ``_cb`` a *callback slot*; every construction site in the tree
   that passes ``on_flush=self._handle`` binds the slot to that method.
2. **Per-callable summaries** — a scoped walk of every method/function
   records, with the set of locks held *locally* at that point, each
   direct lock acquisition (``with self._lock:`` / ``.acquire()``) and
   each resolvable call (self-methods, typed-attribute methods including
   locals assigned from tree-class constructors, module functions,
   constructors, callback slots).
3. **Transitive closure** — a fixpoint propagates "may acquire" sets up
   the call graph, keeping one witness chain (call path + line numbers)
   per (callable, lock).
4. **Global edge fold + cycle report** — every acquisition or call made
   while holding ``H`` contributes ``h -> acquired`` edges for ``h ∈ H``;
   strongly connected components with a cycle are reported once each,
   with the full witness chain for every edge on a representative cycle.
   Also flagged: **callback slots invoked while a lock is held** whose
   bound targets acquire locks — the batcher/reactor "callback under my
   lock" hazard, where the callback's author cannot see the lock they
   run under.

Suppression: ``# toslint: allow-lock-order(<reason>)`` on the line of any
acquisition/call edge on the cycle breaks that cycle for reporting (a
reasoned pragma documents WHY the order is safe — e.g. one side is
startup-only).  ``lock-order`` findings are never baselined
(``core.NEVER_BASELINE``): like knob/dial findings, a real cycle is fixed
or explained inline, never grandfathered.
"""

from __future__ import annotations

import ast
import dataclasses
import json
from typing import Iterator

from tensorflowonspark_torch.analysis.core import (
    Finding,
    ModuleSource,
)

_LOCK_CTORS = frozenset({
    "threading.Lock", "threading.RLock", "threading.Condition",
})
_NAMED_LOCK_CTORS = frozenset({"tos_named_lock", "tos_named_condition"})


def _terminal_name(func: ast.AST) -> str | None:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _mod_stem(path: str) -> str:
    return path.rsplit("/", 1)[-1].rsplit(".", 1)[0]


@dataclasses.dataclass
class _Event:
    """One acquisition or call inside a callable, with the locks held
    *locally within this callable* at that point."""

    kind: str  # "acquire" | "call" | "callback"
    target: object  # lock node id (acquire) | callable key(s) (call/callback)
    line: int
    held: tuple[str, ...]  # lock node ids held locally at this event


@dataclasses.dataclass
class _ClassInfo:
    key: str  # "<path>:<ClassName>"
    path: str
    name: str
    lock_attrs: dict = dataclasses.field(default_factory=dict)  # attr -> node id
    typed_attrs: dict = dataclasses.field(default_factory=dict)  # attr -> class key
    callback_attrs: dict = dataclasses.field(default_factory=dict)  # attr -> param
    methods: dict = dataclasses.field(default_factory=dict)  # name -> callable key
    init_params: list = dataclasses.field(default_factory=list)  # positional order


class LockGraph:
    """The resolved whole-tree graph; built by :func:`build_lockgraph`."""

    def __init__(self) -> None:
        self.classes: dict[str, _ClassInfo] = {}  # class key -> info
        self.class_by_name: dict[str, list[str]] = {}  # bare name -> keys
        self.functions: dict[str, ast.AST] = {}  # callable key -> def node
        self.fn_mod: dict[str, ModuleSource] = {}  # callable key -> module
        self.fn_class: dict[str, str] = {}  # callable key -> class key
        self.module_locks: dict[str, dict[str, str]] = {}  # path -> var -> node
        self.events: dict[str, list[_Event]] = {}  # callable key -> events
        # callback slot bindings: (class key, attr) -> set of callable keys
        self.bindings: dict[tuple[str, str], set[str]] = {}
        self.may_acquire: dict[str, dict[str, list[str]]] = {}
        # lock node -> lock node -> witness chain (list of "site" strings)
        self.edges: dict[str, dict[str, list[str]]] = {}
        # (path, line) pragma sites that bless edges through them
        self.blessed: set[tuple[str, int]] = set()
        # callback-under-lock findings raw material:
        # (path, line, held node, slot, callee key, acquired node)
        self.callback_sites: list[tuple] = []

    # -- resolution helpers ----------------------------------------------------

    def resolve_class(self, mod: ModuleSource, expr: ast.AST) -> str | None:
        """Class key for a Name/Attribute expression, via the import map:
        the qualified dotted name's tail is matched against tree classes
        (module tail + class name when qualifiable, bare class name as the
        over-approximating fallback)."""
        fq = mod.imports.qualify(expr)
        name = _terminal_name(expr)
        if fq and "." in fq:
            mod_dotted, cls = fq.rsplit(".", 1)
            tail = mod_dotted.rsplit(".", 1)[-1]
            for key in self.class_by_name.get(cls, ()):
                info = self.classes[key]
                if _mod_stem(info.path) == tail or info.path == mod.path:
                    return key
        if name:
            keys = self.class_by_name.get(name, ())
            if len(keys) == 1:
                return keys[0]
            for key in keys:  # same-module definition wins
                if self.classes[key].path == mod.path:
                    return key
        return None


# -- pass 1: declarations ------------------------------------------------------


def _lock_node_for(mod: ModuleSource, cls_name: str, attr: str,
                   value: ast.Call) -> str | None:
    """Graph node id for a lock-constructing assignment, else None."""
    fq = mod.imports.qualify(value.func)
    term = _terminal_name(value.func)
    name = fq.rsplit(".", 1)[-1] if fq else term
    if name in _NAMED_LOCK_CTORS:
        if value.args and isinstance(value.args[0], ast.Constant) \
                and isinstance(value.args[0].value, str):
            return value.args[0].value
        return f"{_mod_stem(mod.path)}.{cls_name}.{attr}" if cls_name else \
            f"{_mod_stem(mod.path)}.{attr}"
    if fq in _LOCK_CTORS or (fq is None and term in
                             ("Lock", "RLock", "Condition")):
        stem = _mod_stem(mod.path)
        return f"{stem}.{cls_name}.{attr}" if cls_name else f"{stem}.{attr}"
    return None


def _collect_declarations(graph: LockGraph, mods: list[ModuleSource]) -> None:
    for mod in mods:
        graph.module_locks.setdefault(mod.path, {})
        for stmt in mod.tree.body:
            # module-level locks: _registry_lock = threading.Lock()
            if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and isinstance(stmt.value, ast.Call)):
                node = _lock_node_for(mod, "", stmt.targets[0].id, stmt.value)
                if node:
                    graph.module_locks[mod.path][stmt.targets[0].id] = node
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                key = f"{mod.path}:{stmt.name}"
                graph.functions[key] = stmt
                graph.fn_mod[key] = mod
            elif isinstance(stmt, ast.ClassDef):
                ckey = f"{mod.path}:{stmt.name}"
                info = _ClassInfo(ckey, mod.path, stmt.name)
                graph.classes[ckey] = info
                graph.class_by_name.setdefault(stmt.name, []).append(ckey)
                for item in stmt.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        mkey = f"{ckey}.{item.name}"
                        info.methods[item.name] = mkey
                        graph.functions[mkey] = item
                        graph.fn_mod[mkey] = mod
                        graph.fn_class[mkey] = ckey


def _scan_constructors(graph: LockGraph, mods: list[ModuleSource]) -> None:
    """Attribute typing from EVERY method's ``self.x = ...`` (constructors
    dominate, but lazily-built clients — ``self._client = DataClient(...)``
    in a getter — matter for exactly the cross-module edges this pass
    exists to see)."""
    for info in graph.classes.values():
        mod = graph.fn_mod[next(iter(info.methods.values()))] if \
            info.methods else None
        if mod is None:
            continue
        init = graph.functions.get(info.methods.get("__init__", ""))
        if init is not None:
            info.init_params = [a.arg for a in init.args.args[1:]]
        for mname, mkey in info.methods.items():
            fn = graph.functions[mkey]
            params = {a.arg for a in getattr(fn.args, "args", [])[1:]}
            for node in ast.walk(fn):
                if not isinstance(node, ast.Assign):
                    continue
                for target in node.targets:
                    if not (isinstance(target, ast.Attribute)
                            and isinstance(target.value, ast.Name)
                            and target.value.id == "self"):
                        continue
                    attr = target.attr
                    value = node.value
                    if isinstance(value, ast.Call):
                        lock = _lock_node_for(mod, info.name, attr, value)
                        if lock:
                            info.lock_attrs.setdefault(attr, lock)
                            continue
                        ckey = graph.resolve_class(mod, value.func)
                        if ckey:
                            info.typed_attrs.setdefault(attr, ckey)
                            continue
                    if (mname == "__init__" and isinstance(value, ast.Name)
                            and value.id in params):
                        info.callback_attrs.setdefault(attr, value.id)


def _scan_bindings(graph: LockGraph, mods: list[ModuleSource]) -> None:
    """Callback-slot bindings: every ``SomeClass(..., cb=self._handle)``
    construction in the tree binds SomeClass's callback slots (union over
    all sites — the over-approximating bias of the rest of toslint)."""
    for mod in mods:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            ckey = graph.resolve_class(mod, node.func)
            if ckey is None:
                continue
            info = graph.classes[ckey]
            param_of_attr = info.callback_attrs  # attr -> param name
            if not param_of_attr:
                continue
            passed: dict[str, ast.AST] = {}
            for i, arg in enumerate(node.args):
                if i < len(info.init_params):
                    passed[info.init_params[i]] = arg
            for kw in node.keywords:
                if kw.arg:
                    passed[kw.arg] = kw.value
            # which class' method does the value refer to?
            encl = _enclosing_class(graph, mod, node)
            for attr, param in param_of_attr.items():
                value = passed.get(param)
                if value is None:
                    continue
                target = _callable_ref(graph, mod, encl, value)
                if target:
                    graph.bindings.setdefault((ckey, attr), set()).add(target)


def _enclosing_class(graph: LockGraph, mod: ModuleSource,
                     node: ast.AST) -> str | None:
    """Class key whose body lexically contains ``node`` (linear rescan;
    fine at toslint scale)."""
    for ckey, info in graph.classes.items():
        if info.path != mod.path:
            continue
        for mkey in info.methods.values():
            fn = graph.functions[mkey]
            if (fn.lineno <= node.lineno <=
                    getattr(fn, "end_lineno", fn.lineno)):
                return ckey
    return None


def _callable_ref(graph: LockGraph, mod: ModuleSource, encl: str | None,
                  value: ast.AST) -> str | None:
    """Callable key a callback argument refers to: ``self._m`` /
    ``self._attr.m`` / a module function name."""
    if isinstance(value, ast.Attribute):
        if isinstance(value.value, ast.Name) and value.value.id == "self" \
                and encl is not None:
            return graph.classes[encl].methods.get(value.attr)
        if (isinstance(value.value, ast.Attribute)
                and isinstance(value.value.value, ast.Name)
                and value.value.value.id == "self" and encl is not None):
            attr_t = graph.classes[encl].typed_attrs.get(value.value.attr)
            if attr_t:
                return graph.classes[attr_t].methods.get(value.attr)
    if isinstance(value, ast.Name):
        key = f"{mod.path}:{value.id}"
        if key in graph.functions:
            return key
    return None


# -- pass 2: per-callable event summaries --------------------------------------


class _BodyScanner:
    """Walk one callable's body tracking locally-held locks and recording
    acquisition/call events."""

    def __init__(self, graph: LockGraph, mod: ModuleSource,
                 ckey: str | None):
        self.graph = graph
        self.mod = mod
        self.ckey = ckey
        self.events: list[_Event] = []
        self.local_types: dict[str, str] = {}  # var -> class key

    def _self_lock(self, expr: ast.AST) -> str | None:
        """Lock node id for ``self._lock`` / module-level lock names."""
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self" and self.ckey):
            return self.graph.classes[self.ckey].lock_attrs.get(expr.attr)
        if isinstance(expr, ast.Name):
            return self.graph.module_locks.get(self.mod.path, {}).get(expr.id)
        return None

    def _tree_function(self, func: ast.AST) -> str | None:
        """Module-function key for a (possibly from-imported) reference,
        matched by qualified module tail + function name."""
        fq = self.mod.imports.qualify(func)
        if not fq or "." not in fq:
            return None
        mod_dotted, fname = fq.rsplit(".", 1)
        tail = mod_dotted.rsplit(".", 1)[-1]
        for key in self.graph.functions:
            if key in self.graph.fn_class:
                continue
            path, name = key.split(":", 1)
            if name == fname and _mod_stem(path) == tail:
                return key
        return None

    def _callees(self, call: ast.Call) -> tuple[list[str], str | None]:
        """(resolved callable keys, callback slot attr if this is one)."""
        g, mod, ckey = self.graph, self.mod, self.ckey
        func = call.func
        if isinstance(func, ast.Name):
            # module function or tree-class constructor
            key = f"{mod.path}:{func.id}"
            if key in g.functions and key not in g.fn_class:
                return [key], None
            cls = g.resolve_class(mod, func)
            if cls:
                init = g.classes[cls].methods.get("__init__")
                return ([init] if init else []), None
            fn = self._tree_function(func)  # from-imported module function
            return ([fn] if fn else []), None
        if not isinstance(func, ast.Attribute):
            return [], None
        recv = func.value
        # self.m(...)
        if isinstance(recv, ast.Name) and recv.id == "self" and ckey:
            info = g.classes[ckey]
            m = info.methods.get(func.attr)
            if m:
                return [m], None
            if func.attr in info.callback_attrs:
                bound = g.bindings.get((ckey, func.attr), set())
                return sorted(bound), func.attr
            attr_t = info.typed_attrs.get(func.attr)
            # self._cb(...) where _cb is an untyped constructor capture:
            # fall through (opaque)
            if attr_t:
                m = g.classes[attr_t].methods.get("__call__")
                return ([m] if m else []), None
            return [], None
        # self._attr.m(...)
        if (isinstance(recv, ast.Attribute)
                and isinstance(recv.value, ast.Name)
                and recv.value.id == "self" and ckey):
            attr_t = g.classes[ckey].typed_attrs.get(recv.attr)
            if attr_t:
                m = g.classes[attr_t].methods.get(func.attr)
                return ([m] if m else []), None
            return [], None
        # local_var.m(...) where local_var = TreeClass(...)
        if isinstance(recv, ast.Name):
            local_t = self.local_types.get(recv.id)
            if local_t:
                m = g.classes[local_t].methods.get(func.attr)
                return ([m] if m else []), None
        # mod.func(...) via imports
        cls = g.resolve_class(mod, func)
        if cls:
            init = g.classes[cls].methods.get("__init__")
            return ([init] if init else []), None
        fn = self._tree_function(func)
        return ([fn] if fn else []), None

    def scan(self, body: list[ast.stmt], held: tuple[str, ...]) -> None:
        for stmt in body:
            self._scan_stmt(stmt, held)

    def _scan_stmt(self, node: ast.AST, held: tuple[str, ...]) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = held
            for item in node.items:
                self._scan_expr(item.context_expr, held, skip_call=False)
                lock = self._self_lock(item.context_expr)
                if lock:
                    self.events.append(
                        _Event("acquire", lock, node.lineno, inner))
                    if lock not in inner:
                        inner = inner + (lock,)
            for stmt in node.body:
                self._scan_stmt(stmt, inner)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def runs later, not under this frame's locks
            self.scan(node.body, ())
            return
        if isinstance(node, ast.Lambda):
            self._scan_expr(node.body, ())
            return
        if isinstance(node, ast.Assign):
            # local type inference: x = TreeClass(...)
            if (isinstance(node.value, ast.Call)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                cls = self.graph.resolve_class(self.mod, node.value.func)
                if cls:
                    self.local_types[node.targets[0].id] = cls
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._scan_expr(child, held)
            else:
                self._scan_stmt(child, held)

    def _scan_expr(self, node: ast.AST, held: tuple[str, ...],
                   skip_call: bool = False) -> None:
        if isinstance(node, (ast.Lambda,)):
            self._scan_expr(node.body, ())
            return
        if isinstance(node, ast.Call) and not skip_call:
            self._scan_call(node, held)
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.scan(child.body, ())
            elif isinstance(child, ast.expr):
                self._scan_expr(child, held)
            else:
                self._scan_stmt(child, held)

    def _scan_call(self, node: ast.Call, held: tuple[str, ...]) -> None:
        func = node.func
        # explicit .acquire() / .release() on a lock attribute
        if isinstance(func, ast.Attribute) and func.attr in ("acquire",
                                                            "release"):
            lock = self._self_lock(func.value)
            if lock and func.attr == "acquire":
                self.events.append(_Event("acquire", lock, node.lineno, held))
            if lock:
                for arg in node.args:
                    self._scan_expr(arg, held)
                return
        callees, cb_attr = self._callees(node)
        if callees or cb_attr is not None:
            kind = "callback" if cb_attr is not None else "call"
            self.events.append(
                _Event(kind, (tuple(callees), cb_attr), node.lineno, held))
        self._scan_expr(func, held, skip_call=True)
        for arg in node.args:
            self._scan_expr(arg, held)
        for kw in node.keywords:
            self._scan_expr(kw.value, held)


def _collect_events(graph: LockGraph, mods: list[ModuleSource]) -> None:
    for key, fn in graph.functions.items():
        mod = graph.fn_mod[key]
        scanner = _BodyScanner(graph, mod, graph.fn_class.get(key))
        scanner.scan(fn.body, ())
        graph.events[key] = scanner.events


# -- pass 3: transitive may-acquire --------------------------------------------


def _site(graph: LockGraph, key: str, line: int) -> str:
    mod = graph.fn_mod[key]
    name = key.split(":", 1)[1]
    return f"{mod.path}:{line} ({name})"


def _close_may_acquire(graph: LockGraph) -> None:
    """Fixpoint: may_acquire[f] = own acquires + union over callees, with
    one witness chain (call sites down to the acquire) kept per lock."""
    may: dict[str, dict[str, list[str]]] = {k: {} for k in graph.functions}
    changed = True
    while changed:
        changed = False
        for key, events in graph.events.items():
            mine = may[key]
            for ev in events:
                if ev.kind == "acquire":
                    if ev.target not in mine:
                        mine[ev.target] = [_site(graph, key, ev.line)]
                        changed = True
                else:
                    callees, _ = ev.target
                    for callee in callees:
                        for lock, chain in may.get(callee, {}).items():
                            if lock not in mine:
                                mine[lock] = ([_site(graph, key, ev.line)]
                                              + chain)
                                changed = True
    graph.may_acquire = may


# -- pass 4: edge fold + cycles ------------------------------------------------


def _collect_pragmas(graph: LockGraph, mods: list[ModuleSource]) -> None:
    for mod in mods:
        for line, reason in getattr(mod.pragmas, "lock_order", {}).items():
            if reason:  # a reason-less pragma blesses nothing
                graph.blessed.add((mod.path, line))


def _fold_edges(graph: LockGraph) -> None:
    edges = graph.edges
    edge_sites: dict[tuple[str, str], tuple[str, int]] = {}

    def add(a: str, b: str, chain: list[str], path: str, line: int) -> None:
        if a == b:
            return
        if b not in edges.setdefault(a, {}):
            edges[a][b] = chain
            edge_sites[(a, b)] = (path, line)

    for key, events in graph.events.items():
        mod = graph.fn_mod[key]
        for ev in events:
            if not ev.held:
                continue
            if ev.kind == "acquire":
                for h in ev.held:
                    add(h, ev.target, [_site(graph, key, ev.line)],
                        mod.path, ev.line)
            else:
                callees, cb_attr = ev.target
                for callee in callees:
                    acq = graph.may_acquire.get(callee, {})
                    for lock, chain in acq.items():
                        for h in ev.held:
                            add(h, lock,
                                [_site(graph, key, ev.line)] + chain,
                                mod.path, ev.line)
                        if cb_attr is not None:
                            graph.callback_sites.append(
                                (mod.path, ev.line, ev.held[-1], cb_attr,
                                 callee, lock))
    graph.edge_sites = edge_sites  # type: ignore[attr-defined]


def _sccs(edges: dict[str, dict[str, list[str]]]) -> list[list[str]]:
    """Tarjan strongly-connected components (iterative)."""
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    out: list[list[str]] = []
    counter = [0]

    nodes = sorted(set(edges) | {b for bs in edges.values() for b in bs})

    def strongconnect(v: str) -> None:
        work = [(v, iter(sorted(edges.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(edges.get(w, ())))))
                    advanced = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                out.append(comp)

    for v in nodes:
        if v not in index:
            strongconnect(v)
    return out


def _cycle_in(edges: dict[str, dict[str, list[str]]],
              comp: list[str]) -> list[str]:
    """A representative simple cycle within one SCC (node list, first ==
    entry, closed implicitly)."""
    comp_set = set(comp)
    start = min(comp)
    path = [start]
    seen = {start}
    node = start
    while True:
        nxt = min(w for w in edges.get(node, ()) if w in comp_set)
        if nxt == start:
            return path
        if nxt in seen:
            i = path.index(nxt)
            return path[i:]
        path.append(nxt)
        seen.add(nxt)
        node = nxt


# -- public API ----------------------------------------------------------------


def build_lockgraph(mods: list[ModuleSource]) -> LockGraph:
    graph = LockGraph()
    _collect_declarations(graph, mods)
    _scan_constructors(graph, mods)
    _scan_bindings(graph, mods)
    _collect_events(graph, mods)
    _close_may_acquire(graph)
    _collect_pragmas(graph, mods)
    _fold_edges(graph)
    return graph


LOCK_ORDER_HINT = (
    "break the cycle: take the locks in one global order, move the "
    "cross-module call outside the critical section, or — if one side is "
    "provably safe (startup-only, externally serialized) — annotate the "
    "acquisition site with `# toslint: allow-lock-order(<why>)`")
CALLBACK_HINT = (
    "fire callbacks outside the lock (collect under the lock, invoke "
    "after release — the batcher's _fire_done pattern), or annotate "
    "`# toslint: allow-lock-order(<why>)` at the call site")


def lock_order_findings(graph: LockGraph) -> Iterator[Finding]:
    """Cycle + callback-under-lock findings from a built graph."""
    edge_sites = getattr(graph, "edge_sites", {})

    for comp in _sccs(graph.edges):
        has_cycle = len(comp) > 1 or (
            comp and comp[0] in graph.edges.get(comp[0], {}))
        if not has_cycle:
            continue
        cycle = _cycle_in(graph.edges, comp)
        closed = cycle + [cycle[0]]
        if any(edge_sites.get((a, b)) in graph.blessed
               for a, b in zip(closed, closed[1:])):
            continue
        chain_lines = []
        for a, b in zip(closed, closed[1:]):
            via = " -> ".join(graph.edges[a][b])
            chain_lines.append(f"{a} -> {b} (via {via})")
        path, line = edge_sites.get((closed[0], closed[1]), ("<tree>", 1))
        yield Finding(
            "lock-order", path, line,
            "potential deadlock: acquisition-order cycle "
            + " -> ".join(closed) + "; witness: "
            + "; ".join(chain_lines),
            LOCK_ORDER_HINT,
            "cycle:" + "->".join(sorted(set(cycle))))

    seen: set[tuple] = set()
    for path, line, held, slot, callee, lock in sorted(graph.callback_sites):
        if (path, line) in graph.blessed:
            continue
        key = (path, line, slot, lock)
        if key in seen:
            continue
        seen.add(key)
        callee_name = callee.split(":", 1)[1]
        yield Finding(
            "lock-order", path, line,
            f"callback slot '{slot}' fired while holding '{held}', and a "
            f"bound target ({callee_name}) acquires '{lock}' — the "
            "callback's author cannot see the lock they run under",
            CALLBACK_HINT,
            f"callback:{slot}@{lock}")


# -- CI artifact dumps ---------------------------------------------------------


def graph_as_json(graph: LockGraph) -> dict:
    return {
        "schema": "tos-lockgraph-v1",
        "nodes": sorted(set(graph.edges)
                        | {b for bs in graph.edges.values() for b in bs}),
        "edges": [
            {"from": a, "to": b, "witness": chain}
            for a in sorted(graph.edges)
            for b, chain in sorted(graph.edges[a].items())
        ],
    }


def graph_as_dot(graph: LockGraph) -> str:
    lines = ["digraph lockgraph {", '  rankdir="LR";',
             '  node [shape=box, fontname="monospace"];']
    cyclic = {n for comp in _sccs(graph.edges)
              if len(comp) > 1 or (comp and comp[0] in
                                   graph.edges.get(comp[0], {}))
              for n in comp}
    nodes = sorted(set(graph.edges)
                   | {b for bs in graph.edges.values() for b in bs})
    for n in nodes:
        color = ', color="red"' if n in cyclic else ""
        lines.append(f'  "{n}" [label="{n}"{color}];')
    for a in sorted(graph.edges):
        for b, chain in sorted(graph.edges[a].items()):
            tip = chain[0].replace('"', "'")
            style = ' color="red"' if a in cyclic and b in cyclic else ""
            lines.append(f'  "{a}" -> "{b}" [tooltip="{tip}"{style}];')
    lines.append("}")
    return "\n".join(lines)


def dump_lockgraph(graph: LockGraph, directory) -> tuple[str, str]:
    """Write ``lockgraph.dot`` + ``lockgraph.json`` into ``directory``;
    returns the two paths."""
    from pathlib import Path

    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    dot = directory / "lockgraph.dot"
    js = directory / "lockgraph.json"
    dot.write_text(graph_as_dot(graph) + "\n", encoding="utf-8")
    js.write_text(json.dumps(graph_as_json(graph), indent=2, sort_keys=True)
                  + "\n", encoding="utf-8")
    return str(dot), str(js)
