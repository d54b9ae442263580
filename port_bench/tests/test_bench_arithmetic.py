"""The roofline, FLOP and trace arithmetic against hand counts at small
shapes, and the shape of the result line."""

import math

import pytest
import torch

from port_bench import cells, readers, roofline, run, session
from port_bench.trace import TRACED, Trace

PEAKS = {"tf32_flops": 494.7e12, "bf16_flops": 989.4e12, "hbm_bytes_per_s": 3.35e12}


def test_conv_launch_counts_valid_pairs_and_each_byte_once():
    x = torch.zeros(2, 5, 3)
    w = torch.zeros(27, 3, 4)
    nbr = torch.full((2, 27, 5), -1, dtype=torch.int32)
    nbr[0, 0] = torch.tensor([0, 1, 2, 3, 4])
    nbr[1, 3, :2] = torch.tensor([1, 5])      # 5 >= V: not a pair
    out = torch.zeros(2, 5, 4)
    rec = roofline.conv_launch("fwd", x, w, nbr, out)
    assert int(rec["pairs"]) == 6
    assert rec["ops_per_pair"] == 2 * 3 * 4
    assert rec["bytes"] == (30 + 27 * 12 + 2 * 27 * 5 + 40) * 4
    g = torch.zeros(2, 5, 4)
    gw = torch.zeros(27, 3, 4)
    rec = roofline.conv_launch("dw", x, g, nbr, gw)
    assert rec["ops_per_pair"] == 24 and rec["bytes"] == (30 + 40 + 270 + 324) * 4


def test_window_pairs_sum_squares_of_runs_without_pads():
    rank = torch.tensor([0, 0, 0, 1, 2, 2, -7, -7], dtype=torch.float32)
    assert float(roofline.window_pairs(rank)) == 9 + 1 + 4


def test_attention_launch_and_useful_flops():
    n, h, d = 8, 2, 4
    qs = torch.zeros(n, h, d)
    rank = torch.tensor([0, 0, 1, 1, 1, 2, -7, -7], dtype=torch.float32)
    rec = roofline.attn_launch("bwd_k", (qs, qs), (qs,), qs, rank)
    assert float(rec["pairs"]) == 4 + 9 + 1
    assert rec["ops_per_pair"] == h * d * 8
    assert rec["bytes"] == 3 * n * h * d * 4
    assert roofline.attn_useful_flops(14, h, d, train=False) == 14 * h * d * 4
    assert roofline.attn_useful_flops(14, h, d, train=True) == 14 * h * d * 12


def test_share_of_roofline_takes_the_larger_bound():
    compute = {"pairs": 1e6, "ops_per_pair": 4.947e8, "bytes": 0.0, "dtype": torch.float32}
    memory = {"pairs": 0.0, "ops_per_pair": 1.0, "bytes": 3.35e9, "dtype": torch.bfloat16}
    # 1 s of operations at the TF32 peak and 1 ms of bytes, over 2.002 s
    assert roofline.share_of_roofline([compute, memory], 2.002, PEAKS) == pytest.approx(50.0)
    assert roofline.share_of_roofline([], 1.0, PEAKS) is None


def _trace():
    ms = 1_000_000
    device = [("k1", 1 * ms, 3 * ms), ("k2", 2 * ms, 4 * ms), ("rulebook_conv_kernel", 6 * ms,
                                                                9 * ms)]
    host = [(TRACED, 0, 10 * ms), ("aten::sort", 4 * ms, 5 * ms),
            ("cudaStreamSynchronize", 9 * ms, 10 * ms)]
    return Trace(calls=2, span=(0, 10 * ms), call_spans=[(0, 5 * ms), (5 * ms, 9 * ms)],
                 device=device, host=host,
                 op_device_us={"aten::index_put_": 3000.0, "aten::index_add_": 1000.0})


def test_trace_busy_idle_and_gaps():
    t = _trace()
    assert t.window_s == pytest.approx(0.010)
    assert t.busy_s == pytest.approx(0.006)
    assert t.kernel_s(("rulebook_conv",)) == pytest.approx(0.003)
    gaps = t.idle_gaps()
    assert gaps[0] == ["aten::sort", pytest.approx(0.002)]
    assert [g[1] for g in gaps] == pytest.approx([0.002, 0.001, 0.001])
    assert t.top_device_ops()[0] == ["rulebook_conv_kernel", pytest.approx(0.003)]


def test_idle_counts_only_the_calls_time():
    t = _trace()
    assert t.calls_s == pytest.approx(0.009)
    assert t.busy_in_calls_s == pytest.approx(0.006)


def test_readers():
    ctx = session.RunContext("train", 3, torch.float32, trace=_trace(), peaks=PEAKS,
                             dispatch_ms=[1.0, 5.0, 2.0], traced_flops=4.947e12 * 0.01)
    assert readers.idle_share(ctx, "train") == pytest.approx(100.0 / 3)
    assert readers.idle_share(ctx, "request") is None
    assert readers.dispatch_ms(ctx, "train") == 2.0
    assert readers.op_device_ms(ctx, "train", ("aten::index_put_", "aten::index_add_")) == 2.0
    assert readers.mfu(ctx, "train") == pytest.approx(10.0 / 9)
    ctx.launches = {"spconv": [{"pairs": 0.0, "ops_per_pair": 0.0, "bytes": 3.35e12 * 0.0015,
                                "dtype": torch.float32}], "wattn": []}
    assert readers.roofline_share(ctx, "train", "spconv", ("rulebook_conv",)) == \
        pytest.approx(50.0)
    assert readers.roofline_share(ctx, "train", "wattn", ("wattn_rpe",)) is None


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    bench = cells.load_benchmark(cells.PACKAGE_DIR.parent)
    cell = cells.find(bench, "nusc_teacher.train_b3", cells.PACKAGE_DIR.parent)
    ctx = session.RunContext("train", 3, torch.float32, setup_s=12.5, window_s=2.0, calls=4,
                             peak_window_bytes=2 ** 30, dispatch_ms=[3.0],
                             trace=_trace() if trace else None, peaks=PEAKS)
    out = {"ctx": ctx, "correct": True, "memory_peak": 2 ** 31,
           "compared": {"loss_gap": {"value": 1e-6, "limit": 1e-3}}}
    res = run.result_line(cell, out, trace, "NVIDIA H100 80GB HBM3", 1)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res) == keys + (["breakdown"] if trace else []) + ["compared"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    if trace:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert res["device"]["busy_s"] == pytest.approx(0.006)
        assert "idle_share.train" in res["metrics"]
    else:
        assert res["metrics"]["train_scans_per_s"] == {"value": 6.0, "unit": "scans/s"}
        assert res["metrics"]["peak_mem_gib"]["value"] == 1.0
        assert set(res["metrics"]) == {"train_scans_per_s", "peak_mem_gib", "setup_s"}
    assert all(math.isfinite(m["value"]) for m in res["metrics"].values())


def test_a_nudge_moves_every_weight_by_one_ulp():
    from port_bench import weights

    model = torch.nn.Sequential(torch.nn.Linear(16, 8), torch.nn.LayerNorm(8))
    weights.fill(model, 3)
    before = [p.detach().clone() for p in model.parameters()]
    weights.nudge(model, 4)
    for a, b in zip(before, model.parameters()):
        ulp = torch.nextafter(a, torch.tensor(float("inf"))) - a
        down = a - torch.nextafter(a, torch.tensor(float("-inf")))
        step = (b.detach() - a)
        assert ((step == ulp) | (-step == down)).all()
        assert (step > 0).any() and (step < 0).any()
