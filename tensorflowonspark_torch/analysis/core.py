"""toslint core: findings, pragmas, checker registry, tree runner, baseline.

An AST-based, stdlib-only lint framework for *this* codebase's invariants —
the locked/threaded/env-tuned discipline the elastic control and data planes
depend on (see ``tensorflowonspark_torch/analysis/checkers.py`` for the
checkers themselves).  Modeled on the mechanically-enforced replica/fencing
discipline TF-Replicator credits for its reliability: conventions a reviewer
must remember become conventions a tier-1 test enforces.

Key design points:

- **Stable finding ids, no line numbers.**  A baseline entry must survive
  unrelated edits above it, so ids anchor on (checker, path, enclosing
  qualname, token) with an occurrence counter for exact duplicates — never
  on line numbers.
- **Committed baseline** (``analysis/baseline.json``): grandfathered
  findings are suppressed, anything new fails the gate.  Two checker
  classes (knob-discipline, dial-discipline) are *never* baselined — those
  are fixed outright (``NEVER_BASELINE``).
- **Pragmas**: ``# toslint: allow-silent(<reason>)`` blesses an intentional
  silent except (reason required); ``# toslint: disable=<checker-id>`` is
  the generic same-line suppression.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path
from typing import Iterable, Iterator, Sequence

PRAGMA_RE = re.compile(
    r"#\s*toslint:\s*"
    r"(?:(?P<silent>allow-silent)\((?P<reason>[^)]*)\)"
    r"|(?P<lockorder>allow-lock-order)\((?P<lockreason>[^)]*)\)"
    r"|disable=(?P<ids>[\w,-]+))")

# Checker classes whose findings must be FIXED, never grandfathered: a raw
# env read or raw dial is always a mechanical one-line migration, and a
# lock-order cycle is a latent deadlock — fixed or explained inline with
# `# toslint: allow-lock-order(<why>)`, never waved through.
NEVER_BASELINE = frozenset({"knob-discipline", "dial-discipline",
                            "lock-order"})


@dataclasses.dataclass(frozen=True)
class Finding:
    checker: str  # checker id, e.g. "silent-except"
    path: str  # repo-relative posix path
    line: int  # 1-based line (for humans; never part of the baseline id)
    message: str
    hint: str  # one-line fix hint
    anchor: str  # stable anchor, e.g. "Class.method@token" (baseline id part)


def format_finding(f: Finding) -> str:
    return f"{f.path}:{f.line}: [{f.checker}] {f.message}\n    hint: {f.hint}"


# -- pragmas ------------------------------------------------------------------


class Pragmas:
    """Per-line ``# toslint:`` pragma index for one source file."""

    def __init__(self, lines: Sequence[str]):
        self._silent: dict[int, str] = {}  # line -> reason
        self._disabled: dict[int, set[str]] = {}  # line -> checker ids
        self.lock_order: dict[int, str] = {}  # line -> reason
        for i, text in enumerate(lines, start=1):
            m = PRAGMA_RE.search(text)
            if not m:
                continue
            if m.group("silent"):
                self._silent[i] = (m.group("reason") or "").strip()
            elif m.group("lockorder"):
                self.lock_order[i] = (m.group("lockreason") or "").strip()
            else:
                self._disabled[i] = {s.strip() for s in m.group("ids").split(",") if s.strip()}

    def allow_silent(self, *lines: int) -> bool:
        """True when any of the lines carries allow-silent WITH a reason
        (a reason-less pragma documents nothing and suppresses nothing)."""
        return any(self._silent.get(i) for i in lines)

    def allow_lock_order(self, *lines: int) -> bool:
        """True when any of the lines carries allow-lock-order WITH a
        reason (same rule as allow-silent: no reason, no suppression)."""
        return any(self.lock_order.get(i) for i in lines)

    def disabled(self, line: int, checker_id: str) -> bool:
        ids = self._disabled.get(line)
        return bool(ids) and (checker_id in ids or "all" in ids)


# -- parsed module ------------------------------------------------------------


class ImportMap:
    """Resolve local names to dotted qualnames via the module's imports.

    ``import numpy as np`` makes ``np.random.RandomState`` qualify to
    ``numpy.random.RandomState``; ``from time import monotonic as _m`` makes
    ``_m`` qualify to ``time.monotonic``.  Function-local imports count too
    (this tree imports lazily a lot); collisions across scopes over-approx,
    which is the right bias for a linter.
    """

    def __init__(self, tree: ast.AST):
        self.names: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    root = alias.name.split(".")[0]
                    self.names[alias.asname or root] = alias.name if alias.asname else root
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                for alias in node.names:
                    self.names[alias.asname or alias.name] = f"{node.module}.{alias.name}"

    def qualify(self, node: ast.AST) -> str | None:
        """Dotted qualname of a Name/Attribute chain, else None."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(self.names.get(node.id, node.id))
        return ".".join(reversed(parts))


class ModuleSource:
    """One parsed file: source text, AST, pragma index, import map."""

    def __init__(self, path: str, text: str):
        self.path = path.replace("\\", "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=self.path)
        self.pragmas = Pragmas(self.lines)
        self.imports = ImportMap(self.tree)

    @property
    def basename(self) -> str:
        return self.path.rsplit("/", 1)[-1]


# -- checker registry ---------------------------------------------------------


class Checker:
    """Base checker.  One instance lives for a whole ``run_analysis`` pass:
    ``check`` runs per file (and may accumulate state), ``finalize`` runs
    once afterwards for tree-level invariants (e.g. registry/README sync)."""

    id: str = ""
    hint: str = ""

    def check(self, mod: ModuleSource) -> Iterator[Finding]:
        raise NotImplementedError

    def finalize(self, project_root: Path | None) -> Iterator[Finding]:
        return iter(())


_REGISTRY: dict[str, type[Checker]] = {}


def register_checker(cls: type[Checker]) -> type[Checker]:
    if not cls.id:
        raise ValueError(f"checker {cls.__name__} has no id")
    if cls.id in _REGISTRY:
        raise ValueError(f"duplicate checker id {cls.id!r}")
    _REGISTRY[cls.id] = cls
    return cls


def all_checker_ids() -> list[str]:
    _load_checkers()
    return sorted(_REGISTRY)


def _load_checkers() -> None:
    # registration happens at import; keep it lazy so `core` stays
    # importable from the checkers module itself without a cycle
    from tensorflowonspark_torch.analysis import checkers  # noqa: F401


def _make_checkers(checker_ids: Iterable[str] | None) -> list[Checker]:
    _load_checkers()
    ids = sorted(_REGISTRY) if checker_ids is None else list(checker_ids)
    unknown = [i for i in ids if i not in _REGISTRY]
    if unknown:
        raise ValueError(f"unknown checker id(s) {unknown}; have {sorted(_REGISTRY)}")
    return [_REGISTRY[i]() for i in ids]


# -- running ------------------------------------------------------------------

_SORT_KEY = lambda f: (f.path, f.line, f.checker, f.anchor, f.message)  # noqa: E731


def _checked(checker: Checker, mod: ModuleSource) -> list[Finding]:
    return [f for f in checker.check(mod)
            if not mod.pragmas.disabled(f.line, f.checker)]


def analyze_source(text: str, path: str,
                   checker_ids: Iterable[str] | None = None) -> list[Finding]:
    """Per-file checks on one in-memory snippet (the unit-test surface).
    Tree-level ``finalize`` checks do not run here."""
    mod = ModuleSource(path, text)
    out: list[Finding] = []
    for checker in _make_checkers(checker_ids):
        out.extend(_checked(checker, mod))
    return sorted(out, key=_SORT_KEY)


def default_package_root() -> Path:
    return Path(__file__).resolve().parent.parent


def iter_package_files(package_root: Path) -> list[Path]:
    return sorted(p for p in package_root.rglob("*.py"))


def run_analysis(package_root: Path | None = None,
                 checker_ids: Iterable[str] | None = None) -> list[Finding]:
    """Run the registered checkers over the whole package tree."""
    package_root = Path(package_root or default_package_root()).resolve()
    project_root = package_root.parent
    checkers = _make_checkers(checker_ids)
    findings: list[Finding] = []
    for path in iter_package_files(package_root):
        rel = path.relative_to(project_root).as_posix()
        # a file that does not parse cannot be vouched for — surface it
        # through the same channel instead of crashing the whole pass
        try:
            mod = ModuleSource(rel, path.read_text(encoding="utf-8"))
        except SyntaxError as e:
            findings.append(Finding("parse-error", rel, e.lineno or 1,
                                    f"file does not parse: {e.msg}",
                                    "fix the syntax error", "<module>@syntax"))
            continue
        for checker in checkers:
            findings.extend(_checked(checker, mod))
    for checker in checkers:
        findings.extend(checker.finalize(project_root))
    return sorted(findings, key=_SORT_KEY)


# -- baseline -----------------------------------------------------------------


def finding_ids(findings: Iterable[Finding]) -> list[tuple[Finding, str]]:
    """Pair findings with their stable baseline ids, deterministically.

    Id = ``checker:path:anchor``; exact duplicates (two identical tokens in
    one scope) get ``#2``, ``#3``... in line order, so the id set is stable
    under edits that do not touch the finding's own scope.
    """
    ordered = sorted(findings, key=_SORT_KEY)
    seen: dict[str, int] = {}
    out: list[tuple[Finding, str]] = []
    for f in ordered:
        base = f"{f.checker}:{f.path}:{f.anchor}"
        n = seen.get(base, 0) + 1
        seen[base] = n
        out.append((f, base if n == 1 else f"{base}#{n}"))
    return out


def default_baseline_path() -> Path:
    return Path(__file__).resolve().parent / "baseline.json"


def load_baseline(path: Path | None = None) -> set[str]:
    path = Path(path or default_baseline_path())
    if not path.exists():
        return set()
    data = json.loads(path.read_text(encoding="utf-8"))
    return set(data.get("findings", []))


def write_baseline(path: Path, findings: Iterable[Finding],
                   replace_checkers: Iterable[str] | None = None) -> list[Finding]:
    """Write a deterministic baseline (sorted ids, stable formatting).

    ``NEVER_BASELINE`` classes are excluded — they must be fixed, not
    grandfathered — and returned so the caller can keep failing on them.

    ``replace_checkers`` scopes the update to those checker ids: entries of
    OTHER checkers already in the baseline are preserved (a subset run sees
    only the subset's findings; a full replace from it would silently drop
    every other checker's grandfathered entries).
    """
    with_ids = finding_ids(findings)
    refused = [f for f, _ in with_ids if f.checker in NEVER_BASELINE]
    ids = {fid for f, fid in with_ids if f.checker not in NEVER_BASELINE}
    if replace_checkers is not None:
        scoped = set(replace_checkers)
        ids |= {fid for fid in load_baseline(path)
                if fid.split(":", 1)[0] not in scoped}
    payload = {"version": 1, "findings": sorted(ids)}
    Path(path).write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n",
                          encoding="utf-8")
    return refused


def partition_by_baseline(
    findings: Iterable[Finding], baseline: set[str],
) -> tuple[list[Finding], list[Finding], set[str]]:
    """(new findings, suppressed findings, stale baseline ids)."""
    with_ids = finding_ids(findings)
    current_ids = {fid for _, fid in with_ids}
    new = [f for f, fid in with_ids if fid not in baseline]
    suppressed = [f for f, fid in with_ids if fid in baseline]
    stale = baseline - current_ids
    return new, suppressed, stale
