"""Tier-1 gate: the port's toslint (``tensorflowonspark_torch/analysis``, a
copy of the JAX package's) over the port's package — zero non-baselined
findings, restating ``tests/test_lint.py`` against the port's package and
baseline.  The port's checker cases are in
``tests/test_torch_analysis.py``."""

from __future__ import annotations

import functools
from pathlib import Path

from tensorflowonspark_torch.analysis import core
from torch_lock_gate import torch_lock_witness_gate  # noqa: F401 - the port's lock-witness gate

REPO = Path(__file__).resolve().parent.parent


@functools.cache
def _findings():
    return tuple(core.run_analysis())


def _gate():
    findings = _findings()
    baseline = core.load_baseline(core.default_baseline_path())
    return core.partition_by_baseline(findings, baseline)


def test_lint_runs_over_the_port():
    assert core.default_package_root() == REPO / "tensorflowonspark_torch"
    paths = {f.path.split("/")[0] for f in _findings()}
    assert paths <= {"tensorflowonspark_torch"}, paths


def test_toslint_zero_new_findings():
    new, _suppressed, _stale = _gate()
    assert not new, (
        "toslint found new violations in the port (fix them, or — for "
        "heuristic classes only — add to analysis/baseline.json via "
        "--baseline-update):\n" + "\n".join(core.format_finding(f) for f in new))


def test_baseline_has_no_stale_entries():
    _new, _suppressed, stale = _gate()
    assert not stale, f"stale baseline entries (run --baseline-update): {sorted(stale)}"


def test_baseline_never_grandfathers_knob_or_dial_findings():
    for fid in sorted(core.load_baseline(core.default_baseline_path())):
        assert not fid.startswith(tuple(f"{c}:" for c in core.NEVER_BASELINE)), (
            f"baseline grandfathers a never-baseline class: {fid}")


def test_baseline_grandfathers_only_what_the_jax_baseline_does():
    """Every port entry is a JAX package entry with the package renamed:
    the port adds nothing to what the JAX package grandfathers."""
    from tensorflowonspark_tpu.analysis import core as jcore

    jax_ids = {fid.replace("tensorflowonspark_tpu/", "tensorflowonspark_torch/")
               for fid in jcore.load_baseline(jcore.default_baseline_path())}
    assert core.load_baseline(core.default_baseline_path()) <= jax_ids


def test_cli_module_exits_zero_on_clean_tree():
    from tensorflowonspark_torch.analysis.__main__ import main

    assert main([]) == 0


def test_lock_order_gate_zero_unexplained_cycles():
    findings = core.run_analysis(checker_ids=["lock-order"])
    assert not findings, (
        "lock-order cycles (fix the acquisition order or annotate the "
        "edge):\n" + "\n".join(core.format_finding(f) for f in findings))


def test_write_knob_table_rewrites_only_the_ports_block(tmp_path):
    """The port's ``--write-knob-table`` regenerates the block under its own
    markers and leaves the JAX package's block (and its markers) as they
    were."""
    from tensorflowonspark_torch.analysis.__main__ import _write_knob_table
    from tensorflowonspark_torch.utils import knobs
    from tensorflowonspark_tpu.utils import knobs as jknobs

    text = (REPO / "README.md").read_text(encoding="utf-8")
    lines = text.splitlines()
    jb, je = jknobs.find_table_block(lines)
    jax_block = lines[jb:je + 1]
    b, e = knobs.find_table_block(lines)
    stale = lines[:b + 1] + ["| stale |"] + lines[e:]
    readme = tmp_path / "README.md"
    readme.write_text("\n".join(stale) + "\n", encoding="utf-8")
    assert _write_knob_table(readme) == 0
    out = readme.read_text(encoding="utf-8").splitlines()
    assert out == lines
    assert out[jb:je + 1] == jax_block
    assert knobs.TABLE_BEGIN != jknobs.TABLE_BEGIN and knobs.TABLE_END != jknobs.TABLE_END
