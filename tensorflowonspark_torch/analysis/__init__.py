"""toslint — framework-aware static analysis for tensorflowonspark_torch.

Run it::

    python -m tensorflowonspark_torch.analysis            # gate: exit 0 = clean
    python -m tensorflowonspark_torch.analysis --baseline-update
    python -m tensorflowonspark_torch.analysis --write-knob-table

Stdlib-``ast`` only; see ``core.py`` for the framework and ``checkers.py``
for the five codebase-specific disciplines.
"""

from tensorflowonspark_torch.analysis.core import (
    Finding,
    analyze_source,
    all_checker_ids,
    default_baseline_path,
    finding_ids,
    format_finding,
    load_baseline,
    partition_by_baseline,
    run_analysis,
    write_baseline,
)

__all__ = [
    "Finding",
    "analyze_source",
    "all_checker_ids",
    "default_baseline_path",
    "finding_ids",
    "format_finding",
    "load_baseline",
    "partition_by_baseline",
    "run_analysis",
    "write_baseline",
]
