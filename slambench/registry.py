"""Finds what BENCHMARK.json names, by name, so that a later cell or
metric is added by adding files and entries, never by editing one:

  configs:  the `file` of the configuration's entry
  traffic:  slambench/traffic/<traffic>.json
  limits:   slambench/limits/<workload>.json (each compared number's limit)
  metrics:  slambench/metrics/<metric>.py, whose read(ctx) returns the
            value, or None where it finds nothing to read
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return _json(root / "BENCHMARK.json")


def _named(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json names no {what} {name!r}")


def workload(bench: Dict, name: str) -> Dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: Dict, name: str, root: Path = ROOT) -> Dict:
    return _json(root / _named(bench["configs"], name, "configuration")["file"])


def traffic(name: str, here: Path = HERE) -> Dict:
    return _json(here / "traffic" / f"{name}.json")


def limits(workload_name: str, here: Path = HERE) -> Dict[str, float]:
    return _json(here / "limits" / f"{workload_name}.json")["limits"]


def metrics(bench: Dict, kind: str, workload_name: str) -> List[Dict]:
    """The `end_to_end` or `per_layer` entries that apply to the workload:
    those without a `workloads` key, and those that list it."""
    return [m for m in bench[kind] if workload_name in m.get("workloads", [workload_name])]


def reader(name: str, here: Path = HERE) -> Callable:
    """slambench/metrics/<name>.py's read function."""
    path = here / "metrics" / f"{name}.py"
    mod_name = "slambench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
