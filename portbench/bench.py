"""Finds the benchmark's pieces by name.  ``BENCHMARK.json`` at the root of
the checkout lists the cells and metrics; each piece is a file of its own
under ``portbench/``:

- ``workloads/<cell>.json``: the configuration, the traffic mix, the entry,
  the chips, the libraries its path builds, the limits of its comparison
  and why it exists;
- ``configs/<config>.json``: the configuration as it is run, its source,
  what was reduced and assumed, and the deployment it stands for;
- ``mixes/<traffic>.json``: the traffic's parameters, for ``traffic.py``;
- ``entries/<entry>.py``: the code that drives one kind of path;
- ``metrics/<metric>.py``: one reader a metric, ``read(run) -> value | None``.

A later cell, configuration or metric is new files and new entries in
``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path


class Bench:
    def __init__(self, root):
        self.root = Path(root)
        self.dir = self.root / "portbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self._modules: dict = {}

    def _json(self, folder: str, name: str) -> dict:
        return json.loads((self.dir / folder / f"{name}.json").read_text())

    def _module(self, folder: str, name: str):
        key = (folder, name)
        if key not in self._modules:
            path = self.dir / folder / f"{name}.py"
            spec = importlib.util.spec_from_file_location(
                f"portbench_{folder}_{name.replace('.', '_')}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            self._modules[key] = module
        return self._modules[key]

    def workload(self, name: str) -> dict:
        """The cell's file, checked against its entry in ``BENCHMARK.json``."""
        listed = {w["name"]: w for w in self.spec["workloads"]}
        if name not in listed:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        cell = self._json("workloads", name)
        for key in ("config", "traffic", "chips"):
            if cell[key] != listed[name][key]:
                raise ValueError(f"{name}: {key} is {cell[key]!r} in its file and "
                                 f"{listed[name][key]!r} in BENCHMARK.json")
        return cell

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def mix(self, name: str) -> dict:
        return self._json("mixes", name)

    def entry(self, name: str):
        return self._module("entries", name)

    def reader(self, name: str):
        return self._module("metrics", name)

    def metrics_for(self, cell: str, traced: bool) -> list[dict]:
        """The metrics a run of ``cell`` reports: its end-to-end metrics
        untraced, its per-layer metrics traced.  A metric with a
        ``workloads`` list is the listed cells'; one without it is every
        cell's (a per-layer metric: every cell that reports what it moves)."""
        ends = [m for m in self.spec["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]
        if not traced:
            return ends
        reported = {m["name"] for m in ends}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in reported else [])]
