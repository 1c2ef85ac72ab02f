"""A run with the timed path broken underneath comes out not correct, and
the control separates from the reference: the harness driven on the CPU
at a tiny size, past its look for a card, judged by the cells' own
limits."""

from __future__ import annotations

import time

import pytest

from portbench import control, run
from portbench.faults import FAULTS, planted
from portbench.tests.tiny import CELLS, tiny_bench

SEEDS = (2**31 + 7, 12, 2**33 + 1)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_bench(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("fault", [None, *FAULTS])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_planted_fault_is_not_correct(tiny, cell, fault):
    with planted(fault):
        result, checks = run.run_cell(tiny, cell, SEEDS[0], 0.2, False, "cpu",
                                      time.perf_counter())
    assert result["correct"] is (fault is None), checks


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_fails_and_the_program_passes(tiny, cell):
    """The reference in float8 in the program's place fails one of the
    cell's numbers on every seed; the program passes them all."""
    from portbench.bench import Bench

    limits = Bench(tiny).workload(cell)["limits"]
    lines = []
    control.readings(tiny, cell, list(SEEDS), list(SEEDS), [], "cpu", lines.append)
    for line in lines:
        over = [n for n, (value, _) in line["numbers"].items() if value > limits[n]]
        assert bool(over) is (line["side"] == "control"), line
