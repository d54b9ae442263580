"""A traced run of a tiny cell on the card: the profiler sees device work,
every per-layer metric of the cell reads, no share passes 100%. Skips
without a CUDA device (decided inside the test)."""

import pytest
import torch

from port_bench import run, session
from port_bench.tests import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["nusc_teacher.train_b3", "ours_star.request_6cam"])
def test_a_traced_tiny_run_on_the_card(tmp_path, workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mix = {"pool": 2, "checked_steps": 2} if "train" in workload else {}
    cell = tiny.tiny_cell(tmp_path, workload, **mix)
    out = session.run(cell, 2 ** 31 + 31, 2.0, True, torch.device("cuda", 0), 0.0)
    res = run.result_line(cell, out, True, torch.cuda.get_device_name(0), 1)
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    for name, m in res["metrics"].items():
        if "roofline" in name or "mfu" in name:
            assert 0 < m["value"] <= 100.0, (name, m)
    assert {m["name"] for m in cell.per_layer} <= set(res["metrics"]) | {
        "image_conv_ms.train", "segment_sum_ms.train"}
