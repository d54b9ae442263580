"""Every cell's pieces are found by name, and a cell made of new files
alone runs."""

import json
import math
import shutil

import numpy as np
import pytest
import torch

from port_bench import cells, session
from port_bench.tests import tiny

ROOT = cells.PACKAGE_DIR.parent


def test_every_cell_finds_its_files():
    bench = cells.load_benchmark(ROOT)
    for w in bench["workloads"]:
        cell = cells.find(bench, w["name"], ROOT)
        assert cell.config["name"] == w["config"]
        assert cell.mix["kind"] in ("train", "request")
        assert cell.limits
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cells.metric_reader(m["name"]))
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    bench = cells.load_benchmark(ROOT)
    names = {m["name"] for key in ("end_to_end", "per_layer")
             for m in bench[key]}
    files = {p.name[:-3] for p in (cells.PACKAGE_DIR / "metrics").glob("*.py")}
    assert names == files


def test_configuration_files_hold_the_configs_as_run():
    bench = cells.load_benchmark(ROOT)
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert set(c["reduced"]) == set(cfg["reduced"])


def _added_cell(tmp_path):
    """A configuration, a mix, its limits, a per-layer metric and a cell,
    added as files and entries only."""
    pkg = tiny.tiny_root(tmp_path)
    cfg = json.loads((pkg / "configs" / "nusc_teacher.json").read_text())
    cfg["name"] = "small_teacher"
    cfg["config"]["dataset"]["num_points"] = 1024
    cfg["config"]["capacities"] = [1024, 512, 256, 128, 64]
    (pkg / "configs" / "small_teacher.json").write_text(json.dumps(cfg))
    mix = json.loads((pkg / "mixes" / "train_b3.json").read_text())
    mix.update(batch_size=2, pool=2, checked_steps=2)
    (pkg / "mixes" / "train_b2.json").write_text(json.dumps(mix))
    shutil.copy(pkg / "limits" / "nusc_teacher.train_b3.json",
                pkg / "limits" / "small_teacher.train_b2.json")
    (pkg / "metrics" / "calls_in_window.py").write_text(
        "def read(ctx):\n    return float(ctx.calls)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "small_teacher", "source": "test", "file":
                             "port_bench/configs/small_teacher.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "small_teacher.train_b2", "config": "small_teacher",
                               "traffic": "train_b2", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "calls_in_window", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "step entry",
                               "moves": "train_scans_per_s",
                               "workloads": ["small_teacher.train_b2"]})
    bench["end_to_end"][0]["workloads"].append("small_teacher.train_b2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return pkg


def test_a_cell_from_new_files_alone_runs(tmp_path):
    pkg = _added_cell(tmp_path)
    cell = cells.find(cells.load_benchmark(tmp_path), "small_teacher.train_b2", tmp_path, pkg)
    assert [m["name"] for m in cell.per_layer][-1] == "calls_in_window"
    out = session.run(cell, 2 ** 31 + 7, 0.5, False, torch.device("cpu"), 0.0)
    assert out["ctx"].calls >= 1
    assert set(out["compared"]) == set(cell.limits)
    assert all(math.isfinite(c["value"]) for c in out["compared"].values())
    assert cells.metric_reader("calls_in_window", pkg)(out["ctx"]) == out["ctx"].calls


def test_the_pool_is_drawn_from_the_seed(tmp_path):
    cell = tiny.tiny_cell(tmp_path, tiny.REQUEST)
    cell.config["config"]["dataset"].update(num_points=512, num_points_student=256, im_cr=0.02)
    a = session.make_pool(cell, 2 ** 31 + 3, False)
    b = session.make_pool(cell, 2 ** 31 + 3, False)
    c = session.make_pool(cell, 2 ** 31 + 4, False)
    assert len(a) == cell.mix["pool"]
    for x, y in zip(a, b):
        for k in x["student"]:
            assert (x["student"][k] == y["student"][k]).all()
    assert not (a[0]["student"]["feats"] == c[0]["student"]["feats"]).all()
    assert a[0]["student"]["images"].shape[1] == 6


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, 2 ** 40])
def test_derived_seeds_take_large_seeds(seed):
    assert 0 <= session.derived(seed, 1) < 2 ** 63
    session.rng_of(seed, 0).rand()


@pytest.mark.parametrize("workload", [tiny.REQUEST, "ours_star.train_b4"])
def test_fixed_scenes_give_every_seed_the_same_scenes_in_another_order(tmp_path, workload):
    cell = tiny.tiny_cell(tmp_path, workload)
    assert cell.mix["scenes"] == "fixed"
    cell.config["config"]["dataset"].update(num_points=512, num_points_student=256, im_cr=0.02)
    train = cell.mix["kind"] == "train"

    def scans(seed):
        pool = session.make_pool(cell, seed, train)
        return [(raw["student"]["xyz"][i], raw["student"]["feats"][i, :, 3], raw)
                for raw in pool for i in range(len(raw["student"]["xyz"]))]

    a, b = scans(2 ** 31 + 3), scans(2 ** 40 + 1)
    key = [x.tobytes() for x, _, _ in a]
    assert sorted(key) == sorted(x.tobytes() for x, _, _ in b) and key != [
        x.tobytes() for x, _, _ in b]
    assert not any((ia == ib).all() for _, ia, _ in a for _, ib, _ in b)
    for _, _, raw in a + b:
        s = raw["student"]
        assert ((s["feats"][..., 3] != 0) == s["pmask"]).all()
        assert (s["feats"][..., :3] == np.where(s["pmask"][..., None], s["xyz"], 0)).all()
        if train:
            t = raw["teacher"]
            kf = raw["t2s"] >= 0
            assert (t["xyz"][np.arange(len(kf))[:, None], np.maximum(raw["t2s"], 0)][kf]
                    == s["xyz"][kf]).all()


def test_the_request_window_keeps_a_sample_of_what_it_served(tmp_path):
    cell = tiny.tiny_cell(tmp_path, tiny.REQUEST, pool=2, sampled=2)
    out = session.run(cell, 2 ** 31 + 9, 0.5, False, torch.device("cpu"), 0.0)
    ctx = out["ctx"]
    assert ctx.calls >= 1 and len(ctx.latencies_ms) == ctx.calls
    assert 1 <= len(out["detail"]) <= 2
    first = cell.mix["pool"]
    assert all(first <= j < first + ctx.calls for j in out["detail"])
