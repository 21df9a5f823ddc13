"""``BENCHMARK.json`` and the files its names lead to.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; a configuration's file is the ``file`` its entry gives; a traffic mix
is ``vbench/traffic/<name>.json``; a cell's limits are
``vbench/limits/<cell>.json``; a per-layer metric's reader is
``vbench/metrics/<name>.py``.  Adding a configuration, a traffic mix, a
cell or a metric is adding files and entries: nothing here names one.

A configuration's file may name its model family under a top-level
``model`` key, a family the program's ``make_engine`` takes
(``"auralizer"``, ``"orthomodes"``); where it names none, the family is
``"auralizer"``, the flagship.  Every entry builds that family
(``vbench/drive.py``), and its file states what the family runs: a field
the family would change (the mono OrthoModes family's ``channels``)
fails the run before any frame.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def _read_json(path: Path) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def _named(entries: List[Dict], name: str, what: str) -> Dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def workload(manifest: Dict, name: str) -> Dict:
    return _named(manifest["workloads"], name, "workload")


def config(manifest: Dict, name: str, root: Path = ROOT) -> Dict:
    return _read_json(root / _named(manifest["configs"], name,
                                    "configuration")["file"])


def traffic(name: str, root: Path = ROOT) -> Dict:
    return _read_json(root / "vbench" / "traffic" / f"{name}.json")


def limits(cell: str, root: Path = ROOT) -> Dict:
    return _read_json(root / "vbench" / "limits" / f"{cell}.json")


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """The ``read(trace)`` of ``vbench/metrics/<name>.py``."""
    path = root / "vbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "vbench.metrics." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def end_to_end(manifest: Dict, cell: str) -> List[Dict]:
    """The end-to-end metrics a cell reports."""
    return [m for m in manifest["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer(manifest: Dict, cell: str) -> List[Dict]:
    """The per-layer metrics read in a cell: those that list it, and those
    with no list whose end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end(manifest, cell)}
    return [m for m in manifest["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]
