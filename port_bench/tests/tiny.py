"""Tiny cells for the CPU tests: the benchmark's own configurations and
mixes at a size the CPU runs in seconds (a quarter of the widths, a few
thousand points, small images), written as the files a cell is made of."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from port_bench import cells

TINY = {
    "nusc_teacher": {"model": {"cr": 0.25, "head_dim": 4},
                     "dataset": {"num_points": 2048},
                     "capacities": [2048, 1024, 512, 256, 128]},
    "ours_star": {"model": {"cr": 0.25, "cr_t": 0.5, "head_dim": 4},
                  "dataset": {"num_points": 2048, "num_points_student": 1024, "im_cr": 0.08},
                  "capacities": [2048, 1024, 512, 256, 128],
                  "student_capacities": [1024, 512, 256, 128, 64]},
}


REQUEST = "ours_star.request_6cam"


def _merge(dst, src):
    for k, v in src.items():
        if isinstance(v, dict):
            _merge(dst[k], v)
        else:
            dst[k] = v


def tiny_root(tmp: Path) -> Path:
    """A checkout-like directory with ``BENCHMARK.json`` and a copy of
    ``port_bench``'s files whose configurations are cut to TINY; returns
    the copy of the package directory (mixes, limits, metrics)."""
    pkg = tmp / "port_bench"
    shutil.copytree(cells.PACKAGE_DIR, pkg, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, cut in TINY.items():
        path = pkg / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        _merge(cfg["config"], copy.deepcopy(cut))
        path.write_text(json.dumps(cfg))
    shutil.copy(cells.PACKAGE_DIR.parent / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return pkg


def tiny_cell(tmp: Path, workload: str, **mix) -> cells.Cell:
    pkg = tiny_root(tmp)
    cell = cells.find(cells.load_benchmark(tmp), workload, tmp, pkg)
    cell.mix.update(mix)
    return cell
