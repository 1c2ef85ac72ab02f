"""CLI for toslint: ``python -m tensorflowonspark_torch.analysis``.

Exit codes: 0 = clean (every finding baselined), 1 = new findings (or
never-baselined classes present), 2 = usage error.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from tensorflowonspark_torch.analysis import core


def _write_knob_table(readme: Path) -> int:
    from tensorflowonspark_torch.utils import knobs

    table = f"{knobs.TABLE_BEGIN}\n{knobs.knob_table_markdown()}\n{knobs.TABLE_END}"
    if not readme.exists():
        print(f"error: {readme} not found", file=sys.stderr)
        return 2
    lines = readme.read_text(encoding="utf-8").splitlines()
    span = knobs.find_table_block(lines)
    if span is None:
        print(f"error: {readme} has no knob-table markers; add\n"
              f"{knobs.TABLE_BEGIN}\n{knobs.TABLE_END}\n"
              "where the table should live", file=sys.stderr)
        return 2
    begin, end = span
    lines[begin:end + 1] = table.splitlines()
    readme.write_text("\n".join(lines) + "\n", encoding="utf-8")
    print(f"wrote knob table to {readme}")
    return 0


def _dump_lockgraph(package_root: Path, out_dir: Path) -> int:
    from tensorflowonspark_torch.analysis import lockgraph

    project_root = package_root.parent
    mods = []
    for path in core.iter_package_files(package_root):
        rel = path.relative_to(project_root).as_posix()
        try:
            mods.append(core.ModuleSource(rel, path.read_text(encoding="utf-8")))
        except SyntaxError:
            continue  # the lock-order gate itself reports parse errors
    graph = lockgraph.build_lockgraph(mods)
    dot, js = lockgraph.dump_lockgraph(graph, out_dir)
    n_edges = sum(len(bs) for bs in graph.edges.values())
    print(f"lockgraph: {n_edges} edge(s) -> {dot}, {js}")
    return 0


def _findings_json(findings, baseline: set[str]) -> str:
    rows = [
        {"checker": f.checker, "path": f.path, "line": f.line,
         "message": f.message, "hint": f.hint, "id": fid,
         "baselined": fid in baseline}
        for f, fid in core.finding_ids(findings)
    ]
    return json.dumps({"schema": "toslint-findings-v1", "findings": rows},
                      indent=2, sort_keys=True)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="toslint",
        description="framework-aware static analysis for tensorflowonspark_torch")
    parser.add_argument("--baseline", type=Path, default=None,
                        help="baseline file (default: analysis/baseline.json)")
    parser.add_argument("--baseline-update", action="store_true",
                        help="regenerate the baseline from current findings "
                             "(deterministic: sorted, stable ids); "
                             "knob-/dial-discipline findings are refused")
    parser.add_argument("--package-root", type=Path, default=None,
                        help="package directory to lint (default: the "
                             "installed tensorflowonspark_torch package)")
    parser.add_argument("--checkers", default=None,
                        help="comma-separated checker ids (default: all)")
    parser.add_argument("--list-checkers", action="store_true")
    parser.add_argument("--knob-table", action="store_true",
                        help="print the generated README knob table and exit")
    parser.add_argument("--write-knob-table", action="store_true",
                        help="rewrite the README knob-table block in place")
    parser.add_argument("--dump-lockgraph", type=Path, default=None,
                        metavar="DIR",
                        help="write the resolved whole-tree lock graph as "
                             "lockgraph.dot + lockgraph.json into DIR (CI "
                             "artifacts) and exit")
    parser.add_argument("--format", choices=("text", "json"), default="text",
                        help="finding output format (json = machine-readable "
                             "rows for every finding, new and baselined)")
    args = parser.parse_args(argv)

    if args.list_checkers:
        print("\n".join(core.all_checker_ids()))
        return 0

    from tensorflowonspark_torch.utils import knobs

    if args.knob_table:
        print(knobs.knob_table_markdown())
        return 0

    package_root = (args.package_root or core.default_package_root()).resolve()
    if args.write_knob_table:
        return _write_knob_table(package_root.parent / "README.md")
    if args.dump_lockgraph is not None:
        return _dump_lockgraph(package_root, args.dump_lockgraph)

    checker_ids = (None if args.checkers is None
                   else [s.strip() for s in args.checkers.split(",") if s.strip()])
    try:
        findings = core.run_analysis(package_root, checker_ids)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    baseline_path = args.baseline or core.default_baseline_path()
    if args.baseline_update:
        # a --checkers subset update is scoped: other checkers' entries are
        # preserved, never silently dropped
        refused = core.write_baseline(baseline_path, findings,
                                      replace_checkers=checker_ids)
        kept = len(core.load_baseline(baseline_path))
        print(f"baseline: wrote {kept} finding id(s) to {baseline_path}")
        if refused:
            print(f"\n{len(refused)} finding(s) are never baselined "
                  f"({', '.join(sorted(core.NEVER_BASELINE))}) — fix these:",
                  file=sys.stderr)
            for f in refused:
                print(core.format_finding(f), file=sys.stderr)
            return 1
        return 0

    baseline = core.load_baseline(baseline_path)
    new, suppressed, stale = core.partition_by_baseline(findings, baseline)
    if args.format == "json":
        print(_findings_json(findings, baseline))
        return 1 if new else 0
    for f in new:
        print(core.format_finding(f))
    if stale:
        print(f"note: {len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'} no longer fire(s); "
              "run --baseline-update to trim:", file=sys.stderr)
        for fid in sorted(stale):
            print(f"    {fid}", file=sys.stderr)
    status = (f"toslint: {len(new)} new finding(s), "
              f"{len(suppressed)} baselined, {len(stale)} stale")
    print(status, file=sys.stderr)
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
