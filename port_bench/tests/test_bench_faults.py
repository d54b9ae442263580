"""A run with its timed path broken underneath reads ``correct`` false:
once for each fault a cell can have (no cell spans chips, so none leaves
out an exchange). The harness's look for a card is skipped: the runs are
tiny cells on the CPU, where the program takes its kernels' plain versions,
held to the cells' own limits."""

import pytest
import torch

from port_bench import session
from port_bench.tests import tiny

SMALL = {"pool": 2, "checked_steps": 2}
FAULTS = [("nusc_teacher.train_b3", "unchanged_state"),
          ("nusc_teacher.train_b3", "half_batch"),
          ("ours_star.train_b4", "unchanged_state"),
          ("ours_star.train_b4", "half_batch"),
          ("ours_star.request_6cam", "altered_answer")]


def _run(tmp_path, workload, fault=None):
    mix = dict(SMALL) if "train" in workload else {"pool": 2, "sampled": 2}
    cell = tiny.tiny_cell(tmp_path, workload, **mix)
    return session.run(cell, 2 ** 31 + 11, 0.5, False, torch.device("cpu"), 0.0, fault=fault)


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_planted_fault_reads_incorrect(tmp_path, workload, fault):
    out = _run(tmp_path, workload, fault)
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("workload", ["nusc_teacher.train_b3", "ours_star.request_6cam"])
def test_a_sound_run_reads_correct(tmp_path, workload):
    out = _run(tmp_path, workload)
    assert out["correct"], out["compared"]
