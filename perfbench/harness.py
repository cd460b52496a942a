"""The harness's plan of one cell, found by name from ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix, driver,
per-layer metric, kernel list or cell's limits sits in a file of its own:

* ``perfbench/configs/<config>.json``: the model (``model``: the
  configuration dict the program and the reference both read), ``source``,
  ``reduced``, ``assumed``;
* ``perfbench/traffic/<traffic>.json``: the mix's parameters, with
  ``driver`` naming ``perfbench/drivers/<driver>.py``;
* ``perfbench/metrics/<metric>.py``: ``read(facts)``, one per per-layer
  metric; it returns None where the run gives it nothing to read;
* ``perfbench/kernels/<operation>/*.json``: ``{"kernels": [names]}``, the
  device kernels that implement an operation;
* ``perfbench/limits/<workload>.json``: each compared number's limit.

A later cell, configuration, mix, metric or kernel is added by adding files
and entries; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import glob
import importlib.util
import json
import os
import sys
from pathlib import Path
from types import ModuleType

BENCH_DIR = "perfbench"


@dataclasses.dataclass
class Plan:
    root: Path
    workload: dict
    config: dict
    traffic: dict
    driver: Path
    end_to_end: list[dict]  # the cell's end-to-end metrics
    per_layer: list[dict]  # the cell's per-layer metrics, each with its reader's path
    limits: dict

    def summary(self) -> dict:
        return {"workload": self.workload["name"], "config": self.config["name"], "traffic": self.traffic["name"],
                "driver": str(self.driver.relative_to(self.root)), "chips": self.workload["chips"],
                "end_to_end": [m["name"] for m in self.end_to_end],
                "per_layer": [m["name"] for m in self.per_layer], "limits": sorted(self.limits)}


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def plan(root: str | Path, workload: str) -> Plan:
    """The cell ``workload`` of ``root``'s ``BENCHMARK.json``: its files
    found and read, or a ``ValueError`` saying which is missing."""
    root = Path(root)
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise ValueError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config_entry = configs[cell["config"]]
    config = {**_json(root / config_entry["file"]), "name": cell["config"]}
    traffic = {**_json(root / BENCH_DIR / "traffic" / f"{cell['traffic']}.json"), "name": cell["traffic"]}
    driver = root / BENCH_DIR / "drivers" / f"{traffic['driver']}.py"
    if not driver.exists():
        raise ValueError(f"traffic {cell['traffic']} names a driver with no file: {driver}")
    end_to_end = [m for m in bench["end_to_end"] if _reports(m, workload)]
    per_layer = []
    for m in bench["per_layer"]:
        if _reports(m, workload):
            reader = root / BENCH_DIR / "metrics" / f"{m['name']}.py"
            if not reader.exists():
                raise ValueError(f"per-layer metric {m['name']} has no reader: {reader}")
            per_layer.append({**m, "reader": reader})
    limits = _json(root / BENCH_DIR / "limits" / f"{workload}.json")
    return Plan(root, cell, config, traffic, driver, end_to_end, per_layer, limits)


def load_module(path: Path, name: str | None = None) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name or "perfbench_" + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def kernel_names(root: str | Path, operation: str) -> list[str]:
    """Every kernel name listed under ``perfbench/kernels/<operation>/``."""
    names = []
    for path in sorted(glob.glob(os.path.join(root, BENCH_DIR, "kernels", operation, "*.json"))):
        names += _json(Path(path))["kernels"]
    return names


def read_per_layer(p: Plan, facts: dict) -> dict[str, dict]:
    """Each per-layer metric's reading; a reader that finds nothing to read
    leaves its metric out."""
    out = {}
    for m in p.per_layer:
        value = load_module(m["reader"]).read(facts)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
