"""What one cell of BENCHMARK.json asks for, found by name in its files.

A workload entry names a configuration and a traffic mix; each lives in a
file of its own (`configs/<config>.json`, `traffic/<traffic>.json`), and
the cell's own settings (its correctness limit, its traced chunks) in
`cells/<workload>.json`. A configuration names its model module
(`models/<model>.py`: its sizes, tensors, hand-over to the port and work
counts) and its plain reference (`reference/<reference>.py`). A metric is
read by `e2e/<name>.py` (end to end) or `metrics/<name>.py` (per layer),
each a module with `read(run)`. So a cell, a model, a mix or a metric is
added as files and entries, and no file of the harness names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    reader: ModuleType


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    settings: dict
    end_to_end: list[Metric]
    per_layer: list[Metric]
    bench_dir: Path


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """A reader, model or reference module from its file (not from
    sys.path, so that a checkout's own copy is the one that runs)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell `workload` of `root`/BENCHMARK.json with its files; raises
    KeyError for a workload the file does not list."""
    bench = _json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(it lists {[w['name'] for w in bench['workloads']]})")
    bench_dir = root / "cudabench"

    def metrics(kind: str, folder: str) -> list[Metric]:
        return [Metric(m["name"], m["unit"],
                       load_module(bench_dir / folder / f"{m['name']}.py",
                                   f"cudabench_{folder}_{m['name']}"))
                for m in bench[kind] if _applies(m, workload)]

    return Cell(
        name=workload, chips=int(entry["chips"]),
        config=_json(bench_dir / "configs" / f"{entry['config']}.json"),
        traffic=_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        settings=_json(bench_dir / "cells" / f"{workload}.json"),
        end_to_end=metrics("end_to_end", "e2e"),
        per_layer=metrics("per_layer", "metrics"),
        bench_dir=bench_dir)
