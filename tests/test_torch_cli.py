"""The port's two training entry points, run as a user runs them, on the CPU:
stage 1 (``python -m u2mkd_tpu_torch.train_spformer``) on the tiny synthetic
teacher config at cr=0.5, then stage 2
(``python -m u2mkd_tpu_torch.train_lc_nusc_tsd_full``) on the tiny TSD config
with ``model.teacher_pretrain=`` stage 1's checkpoint, whose teacher is that
cr_t=0.5 model, and again with ``train.remat=true``, which must print the
same loss and mIoU. One epoch of 4 steps each (``data.training_size=8``, as
``tests/test_cli_smoke.py``). The processes run without the JAX package on
their path.
"""

import math
import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(args, threads=2):
    # two threads each: the tier-1 run shares the machine's cores among
    # several workers
    env = dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS=str(threads))
    res = subprocess.run([sys.executable, "-m"] + args, cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         timeout=900)
    assert res.returncode == 0, f"{args} failed:\n{res.stdout[-4000:]}"
    return res.stdout


def _epoch_line(out):
    """(loss, miou) of the loop's last epoch line."""
    m = re.findall(r"^epoch 1/1: steps=4 loss=([-0-9.naif]+) miou=([0-9.]+)", out, re.M)
    assert m, out[-2000:]
    return float(m[-1][0]), float(m[-1][1])


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    run_dir = str(tmp_path_factory.mktemp("stage1"))
    out = run_cli(["u2mkd_tpu_torch.train_spformer", "configs/synthetic/train/spformer_tiny.yaml",
                   "--run-dir", run_dir, "--cpu", "num_epochs=1", "data.training_size=8",
                   "model.cr=0.5"])
    return run_dir, out


def test_teacher_cli(stage1):
    """Stage 1 trains, validates (``miou=``, an IoU table) and writes the
    latest and best checkpoints and the metric log."""
    run_dir, out = stage1
    loss, miou = _epoch_line(out)
    assert math.isfinite(loss) and 0.0 <= miou <= 100.0
    assert "[val] counts:" in out and "device: cpu" in out
    for name in ("latest.pt", "max-iou-val-vox.pt", "latest.json", "best.json"):
        assert os.path.isfile(os.path.join(run_dir, "checkpoints", name)), name
    assert os.path.getsize(os.path.join(run_dir, "metrics.jsonl")) > 0


def _stage2(stage1, run_dir, *opts):
    """Stage 2 on one thread: with two, the image branch's backward sums in
    an order that varies from run to run, and the remat cases compare runs
    bitwise."""
    s1_ckpt = os.path.join(stage1[0], "checkpoints", "latest.pt")
    out = run_cli(["u2mkd_tpu_torch.train_lc_nusc_tsd_full",
                   "configs/synthetic/train/tsd_tiny.yaml", "--run-dir", run_dir, "--cpu",
                   "num_epochs=1", "data.training_size=8",
                   f"model.teacher_pretrain={s1_ckpt}", *opts], threads=1)
    return s1_ckpt, out


@pytest.fixture(scope="module")
def stage2(stage1, tmp_path_factory):
    run_dir = str(tmp_path_factory.mktemp("stage2"))
    return (run_dir, *_stage2(stage1, run_dir))


def test_student_cli_restores_teacher(stage2):
    """Stage 2 restores stage 1's model as its frozen teacher, bitwise, and
    keeps it so through training; it validates both heads and keeps the
    best checkpoint on the voxel head."""
    run_dir, s1_ckpt, out = stage2
    assert f"loaded frozen teacher from {s1_ckpt}" in out
    assert "[val] counts_vox:" in out and "[val] counts_pix:" in out
    loss, _ = _epoch_line(out)
    assert math.isfinite(loss)
    ckpts = os.path.join(run_dir, "checkpoints")
    assert os.path.isfile(os.path.join(ckpts, "max-iou-val-vox.pt"))
    teacher = torch.load(s1_ckpt, weights_only=True)["model"]
    tsd = torch.load(os.path.join(ckpts, "latest.pt"), weights_only=True)
    restored = {k[len("model_t."):]: v for k, v in tsd["model"].items()
                if k.startswith("model_t.")}
    assert sorted(restored) == sorted(teacher)
    for k, v in teacher.items():
        assert torch.equal(restored[k], v), k
    assert tsd["step"] == 4


def test_student_cli_remat_prints_the_same_losses(stage1, stage2, tmp_path):
    """``train.remat=true`` prints the epoch's loss and mIoU of the run
    without it."""
    _, out = _stage2(stage1, str(tmp_path / "stage2"), "train.remat=true")
    assert _epoch_line(out) == _epoch_line(stage2[2])


# torch's TF32 defaults, which no module of the port changes (ops/precision.py)
NUMERICS = "numerics: precision=float32 cudnn.allow_tf32=True cuda.matmul.allow_tf32=False"


@pytest.mark.parametrize("cli", ["stage1", "stage2", "evaluate"])
def test_start_line_states_the_numerics(cli, stage1, stage2):
    """Each entry point prints, after its ``device:`` line, one line with
    the compute policy and both TF32 flags as the process runs with them:
    the training CLIs above, and ``python -m u2mkd_tpu_torch.evaluate`` on
    stage 1's checkpoint."""
    if cli == "evaluate":
        out = run_cli(["u2mkd_tpu_torch.evaluate", "configs/synthetic/train/spformer_tiny.yaml",
                       "--checkpoint", os.path.join(stage1[0], "checkpoints", "latest.pt"),
                       "--cpu", "data.training_size=8", "model.cr=0.5"])
        assert re.search(r"^mIoU: [0-9.]+$", out, re.M), out[-2000:]
    else:
        out = {"stage1": stage1[1], "stage2": stage2[2]}[cli]
    lines = out.splitlines()
    assert lines.count(NUMERICS) == 1, out[-2000:]
    assert lines.index(NUMERICS) > lines.index("device: cpu")
