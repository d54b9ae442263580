"""Finding a cell's pieces by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix; each lives in a file of its
own that the harness finds by name: ``configs/<config>.json`` (the file
``BENCHMARK.json`` gives), ``mixes/<traffic>.json``, ``limits/<cell>.json``
(the limits of the numbers that decide ``correct``) and, for each per-layer
metric, ``metrics/<metric>.py``. A cell, a configuration, a mix or a metric
is added by adding files and entries; no code here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List

PACKAGE_DIR = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict          # the configuration file's object
    mix_name: str
    mix: Dict             # the traffic mix's parameters
    limits: Dict          # number -> limit
    end_to_end: List[Dict] = field(default_factory=list)   # metric entries this cell reports
    per_layer: List[Dict] = field(default_factory=list)


def load_benchmark(root: Path) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find(bench: Dict, workload: str, root: Path, package_dir: Path = PACKAGE_DIR) -> Cell:
    """The cell ``workload`` of ``bench`` with its files read from
    ``package_dir`` (configuration files from ``root``, where
    ``BENCHMARK.json`` names them)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; the benchmark has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(package_dir / "mixes" / f"{w['traffic']}.json") as f:
        mix = json.load(f)
    with open(package_dir / "limits" / f"{workload}.json") as f:
        limits = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    layers = [m for m in bench["per_layer"] if _reports(m, workload)]
    return Cell(workload, int(w["chips"]), w["config"], config, w["traffic"], mix, limits,
                e2e, layers)


def metric_reader(name: str, package_dir: Path = PACKAGE_DIR) -> Callable:
    """``read(ctx)`` of ``metrics/<name>.py``: the metric from the traced
    run's context, or None where there is nothing to read."""
    path = package_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
