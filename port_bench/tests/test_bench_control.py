"""The control, the program with its own bfloat16 path switched on (one
precision below the configurations' float32), fails at least one of each
cell's limits: here at a size a test run holds, the tiny cells on the CPU,
where the bf16 policy casts as it does on the card (``port_bench.control``
runs it at the cells' own size on the card)."""

import pytest
import torch

from port_bench import control
from port_bench.tests import tiny

CELLS = ["nusc_teacher.train_b3", "ours_star.train_b4", "ours_star.request_6cam"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [2 ** 31 + 21, 2 ** 31 + 22, 2 ** 31 + 23])
def test_the_control_fails_a_limit(tmp_path, workload, seed):
    mix = {"pool": 2, "checked_steps": 2} if "train" in workload else {"pool": 2}
    cell = tiny.tiny_cell(tmp_path, workload, **mix)
    numbers = control.control_numbers(cell, seed, torch.device("cpu"))
    assert any(numbers[k] > lim for k, lim in cell.limits.items()), numbers


def test_the_sound_and_nudged_sides_read_within_the_limits(tmp_path):
    cell = tiny.tiny_cell(tmp_path, "nusc_teacher.train_b3", pool=2, checked_steps=2)
    numbers = control.side_numbers(cell, 2 ** 31 + 24, torch.device("cpu"),
                                   ("program", "nudged"))
    for side, n in numbers.items():
        assert all(n[k] <= lim for k, lim in cell.limits.items()), (side, n)
        assert 0 < n["update1_gap"] < 1 and 0 <= n["bn1_gap"] < 1, (side, n)
