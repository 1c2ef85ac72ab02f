"""The harness on the CPU: every piece found by name, a cell and a metric
added as files, the result line's shape, ``BENCHMARK.json`` against the
contract, and the imports the benchmark may not make."""

from __future__ import annotations

import ast
import json
import math
import os
import re
import subprocess
import sys
import time

import pytest

from portbench.bench import Bench
from portbench.tests.tiny import REPO, tiny_bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device", "breakdown", "checks")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "tensorflowonspark_tpu"}
PROGRAM = {"tensorflowonspark_torch", "examples_torch"}


def _spec():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_every_listed_piece_loads_by_name():
    bench = Bench(REPO)
    spec = bench.spec
    for cell in spec["workloads"]:
        found = bench.workload(cell["name"])
        assert found["why"] == cell["why"]
        cfg = bench.config(found["config"])
        assert cfg["name"] == cell["config"]
        assert bench.mix(found["traffic"])["kind"]
        assert callable(bench.entry(found["entry"]).build)
        assert set(found["limits"]) == {"loss_gap", "grad_norm_gap", "change_norm_gap"}
        ends = {m["name"] for m in bench.metrics_for(cell["name"], traced=False)}
        assert "setup_s" in ends and len(ends) >= 2
        assert bench.metrics_for(cell["name"], traced=True)
    for metric in spec["end_to_end"] + spec["per_layer"]:
        assert callable(bench.reader(metric["name"]).read)
    for cfg in spec["configs"]:
        data = json.loads((REPO / cfg["file"]).read_text())
        assert data["source"] == cfg["source"]
        assert sorted(data["reduced"]) == sorted(cfg["reduced"])
        assert data["assumed"] and data["deployment"]


def test_benchmark_json_keeps_the_contract():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["portbench"] and spec["command"][1] == "portbench/run.py"
    cells = spec["workloads"]
    assert 1 <= len(cells) <= 24 and 1 <= len(spec["configs"]) <= 24
    # a full check with 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for x in spec["configs"] + cells + spec["end_to_end"]
             + spec["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(x["name"] for x in cells)) == len(cells)
    assert len({(c["config"], c["traffic"]) for c in cells}) == len(cells)
    assert {c["config"] for c in cells} == {c["name"] for c in spec["configs"]}
    assert sum(c["chips"] == 4 for c in cells) <= max(1, len(cells) // 4)
    for c in cells + spec["configs"]:
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200 and c["file"].startswith("portbench/")
        assert not any(k.endswith(("_dim", "_rank", "_size")) for k in c["reduced"])
    ends = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in ends and ends["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in ends and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for cell in m.get("workloads", []):  # the cell reports what it moves
            assert "workloads" not in ends[m["moves"]] or cell in ends[m["moves"]]["workloads"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(spec)) <= 64 * 1024


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            found.add(node.module.split(".")[0])
    return found


def test_no_portbench_module_imports_the_jax_side():
    for path in (REPO / "portbench").rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_the_references_import_nothing_of_the_program():
    for path in (REPO / "portbench" / "reference").rglob("*.py"):
        assert not _imports(path) & PROGRAM, path


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny copy, with a metric added as a file and an entry."""
    root = tiny_bench(tmp_path_factory.mktemp("bench"))
    (root / "portbench" / "metrics" / "steps_in_window.tiny.py").write_text(
        "def read(run):\n    return float(run.steps)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "steps_in_window.tiny", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "Train step", "moves": "lm_train_tokens_per_s",
                              "workloads": ["tiny-lm-train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.mark.parametrize("traced", [False, True])
def test_an_added_cell_and_metric_run_on_the_cpu(tiny, traced):
    from portbench import run

    result, checks = run.run_cell(tiny, "tiny-lm-train", 2**31 + 11, 0.5, traced, "cpu",
                                  time.perf_counter())
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    wanted = Bench(tiny).metrics_for("tiny-lm-train", traced)
    # a CPU run reports no metric whose source is the device
    assert set(result["metrics"]) == {m["name"] for m in wanted
                                      if m["source"] != "device_trace"}
    if traced:
        assert result["metrics"]["steps_in_window.tiny"]["value"] == result["attempted"]
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert {"setup_s", "lm_train_tokens_per_s"} <= set(result["metrics"])
    keys = list(result)
    assert set(keys) <= set(RESULT_KEYS) and keys[-1] == "checks"
    assert keys[:5] == list(RESULT_KEYS[:5])
    for value in result["metrics"].values():
        assert set(value) == {"value", "unit"} and math.isfinite(value["value"])
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    assert set(checks) == {"loss_gap", "grad_norm_gap", "change_norm_gap", "kernel_path"}
    json.dumps(result, allow_nan=False)


def test_a_cell_is_found_only_when_listed(tiny):
    with pytest.raises(KeyError):
        Bench(tiny).workload("no-such-cell")


def _command(cwd, *args):
    env = {**os.environ, "PYTHONPATH": ""}
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    done = _command(REPO, "--workload", "lm7b-train-s4096", "--seed", str(2**31 + 3),
                    "--seconds", "1", "--trace", "0")
    assert done.returncode != 0 and done.stdout == ""


def test_no_program_no_result(tmp_path):
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = _command(tmp_path, "--workload", "resnet50-train-b256", "--seed", "5",
                    "--seconds", "1", "--trace", "0")
    assert done.returncode != 0 and done.stdout == ""


def test_idle_gaps_are_named_by_what_the_host_was_doing():
    from portbench.devtrace import _idle_by_host

    main, other = 1, 2
    host = [(0, 100, "portbench.step", main), (10, 20, "aten::mm", main),
            (30, 90, "autograd::engine", other), (40, 50, "aten::sum", other),
            (100, 120, "portbench.feed", main)]
    gaps = [(15, 17), (45, 47), (60, 70), (110, 130)]
    assert _idle_by_host(gaps, host, main) == {
        "portbench.step / aten::mm": pytest.approx(2e-9),
        "portbench.step / aten::sum": pytest.approx(2e-9),
        "portbench.step / autograd::engine": pytest.approx(10e-9),
        "portbench.feed": pytest.approx(20e-9)}
