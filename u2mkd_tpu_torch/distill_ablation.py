"""Distillation-efficacy ablation of the port: does the frozen teacher help?

Twin of ``tools/distill_ablation.py`` (the JAX package's), on the port's
training entry points and the nuScenes-mini configs, on a
``tools/make_nusc_mini.py`` set:

  1. the stage-1 teacher trains on full labels
     (``python -m u2mkd_tpu_torch.train_spformer`` on
     ``configs/nuscenes/mini/spformer_mini.yaml``), unless a teacher
     checkpoint is given;
  2. the distilled student trains with ``dataset.label_drop_p`` of its
     keyframe labels marked ignore (and, with ``drop_classes``, every label
     of those classes), plus the teacher's KL and feature losses
     (``python -m u2mkd_tpu_torch.train_lc_nusc_tsd_full`` on
     ``configs/nuscenes/mini/tsd_mini.yaml``);
  3. the scratch student trains on the same labels and rng stream with
     ``criterion.w_kl=0 criterion.w_feat=0``, every other term the same.

The two arms run side by side, each a process of its own (their steps
repeat bitwise, so neither changes the other's result). The gap,
distilled mIoU minus scratch mIoU (best validation epoch of each),
is what the teacher adds beyond the labels; with held-out classes, the
held classes' IoU of each arm at its best epoch. Each run's output goes to
``WORKDIR/{teacher,distilled,scratch}.txt``. Runs go to the card unless
``cpu``; ``precision`` passes ``precision=...`` to every run started
(``bfloat16``: the bf16 compute policy), so that the arms of both
precisions can share one teacher checkpoint. Prints one JSON line, the JAX
tool's keys.

Usage:
  python -m u2mkd_tpu_torch.distill_ablation [--root=DIR] [--workdir=DIR] \\
      [--drop=0.9] [--teacher-epochs=3] [--student-epochs=2] \\
      [--drop-classes=4,7,10] [--teacher-ckpt=PT --teacher-miou=X] \\
      [--precision=bfloat16] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE1 = ("u2mkd_tpu_torch.train_spformer", "configs/nuscenes/mini/spformer_mini.yaml")
STAGE2 = ("u2mkd_tpu_torch.train_lc_nusc_tsd_full", "configs/nuscenes/mini/tsd_mini.yaml")


def _command(module_cfg: Sequence[str], run_dir: str, opts: Sequence[str]) -> List[str]:
    return [sys.executable, "-m", *module_cfg, "--run-dir", run_dir, *opts]


def _run(cmd: List[str], timeout: float = 3600) -> str:
    """Run ``cmd`` from the repository root -> its output (standard output
    and errors); raises if it fails."""
    res = subprocess.run(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, timeout=timeout)
    if res.returncode != 0:
        raise RuntimeError(f"{cmd} failed:\n{res.stdout[-5000:]}")
    return res.stdout


def _logged(cmd: List[str], workdir: str, name: str) -> str:
    """:func:`_run`, its output also written to ``workdir/name.txt``."""
    out = _run(cmd)
    with open(os.path.join(workdir, f"{name}.txt"), "w") as f:
        f.write(out)
    return out


def _mious(out: str) -> List[float]:
    return [float(m) / 100 for m in re.findall(r"miou=([0-9.]+)", out)]


def _vox_tables(out: str) -> List[Dict[str, float]]:
    """Per-epoch ``{class row: iou}`` of the ``[val] counts_vox:`` tables the
    training loop prints (``train/loop.format_iou_table``: rows ``c{i}`` by
    class index, and ``Mean``)."""
    tables = []
    for block in out.split("[val] counts_vox:")[1:]:
        rows = {}
        for line in block.splitlines():
            m = re.match(r"\| *(\S+) *\| *([0-9.]+) *\|", line)
            if m:
                rows[m.group(1)] = float(m.group(2)) / 100
            elif rows and not line.startswith(("|", "+")):
                break
        tables.append(rows)
    return tables


def _held_iou(out: str, drop_classes: Optional[Sequence[int]]) -> Optional[float]:
    """Mean IoU over the held-out classes at the best validation epoch (the
    ``max-iou-val-vox`` checkpoint's)."""
    tables = _vox_tables(out)
    if not tables or not drop_classes:
        return None
    best = max(range(len(tables)), key=lambda i: tables[i].get("Mean", 0.0))
    vals = [tables[best].get(f"c{int(c)}", 0.0) for c in drop_classes]
    return sum(vals) / len(vals)


def train_teacher(root: str, workdir: str, teacher_epochs: int, precision: str = "float32",
                  cpu: bool = False):
    """Step 1: the stage-1 teacher on full labels -> (its best checkpoint,
    its last epoch's mIoU)."""
    os.makedirs(workdir, exist_ok=True)
    teacher_dir = os.path.join(workdir, "teacher")
    flags = [f"precision={precision}"] + (["--cpu"] if cpu else [])
    out = _logged(_command(STAGE1, teacher_dir, [
        f"dataset.root={root}", f"num_epochs={teacher_epochs}", *flags]), workdir, "teacher")
    return os.path.join(teacher_dir, "checkpoints", "max-iou-val-vox.pt"), _mious(out)[-1]


def run_ablation(root=None, workdir=None, drop=0.9, teacher_epochs=3, student_epochs=2,
                 teacher_ckpt=None, teacher_miou=None, drop_classes=None,
                 precision="float32", cpu=False) -> Dict:
    """The ablation's result, the JAX tool's keys (module docstring)."""
    workdir = workdir or tempfile.mkdtemp(prefix="distill_ablation_")
    os.makedirs(workdir, exist_ok=True)
    if root is None:
        sys.path.insert(0, os.path.join(REPO, "tools"))
        from make_nusc_mini import generate

        root = os.path.join(workdir, "nusc_mini")
        generate(root)
    flags = [f"precision={precision}"] + (["--cpu"] if cpu else [])

    prebuilt_teacher = teacher_ckpt is not None
    if teacher_ckpt is None:
        teacher_ckpt, teacher_miou = train_teacher(root, workdir, teacher_epochs, precision, cpu)
    elif teacher_miou is None:
        teacher_miou = float("nan")

    # the arms' configs differ in the two teacher-loss weights alone, so
    # their rng streams (label drop, camera drop, augmentation) are the same
    common = [f"dataset.root={root}", f"num_epochs={student_epochs}",
              f"dataset.label_drop_p={drop}", f"model.teacher_pretrain={teacher_ckpt}", *flags]
    if drop_classes:
        # class holdout: no label shows the scratch arm a held class; the
        # distilled arm can learn it from the teacher's dense predictions
        common.append("dataset.label_drop_classes=[" + ",".join(
            str(int(c)) for c in drop_classes) + "]")
    arms = {"distilled": common,
            "scratch": common + ["criterion.w_kl=0.0", "criterion.w_feat=0.0"]}
    with ThreadPoolExecutor(len(arms)) as pool:
        runs = {name: pool.submit(_logged, _command(STAGE2, os.path.join(workdir, name), opts),
                                  workdir, name) for name, opts in arms.items()}
        out_d, out_s = runs["distilled"].result(), runs["scratch"].result()
    # best validation over the epochs: the MaxSaver protocol of the
    # reference and of evaluate.py
    distilled, scratch = max(_mious(out_d)), max(_mious(out_s))
    result = {
        "metric": "distill_gap_miou",
        "teacher_miou": round(teacher_miou, 4),
        "distilled_miou": round(distilled, 4),
        "scratch_miou": round(scratch, 4),
        "gap": round(distilled - scratch, 4),
        "config": {"label_drop_p": drop, "label_drop_classes": list(drop_classes or ()),
                   "teacher_epochs": "prebuilt" if prebuilt_teacher else teacher_epochs,
                   "student_epochs": student_epochs, "fixture": "nusc_mini"},
    }
    if drop_classes:
        # a scratch student gets no gradient toward a held class, so its
        # held IoU stays ~0; the distilled arm's comes from the teacher
        hd, hs = _held_iou(out_d, drop_classes), _held_iou(out_s, drop_classes)
        result["held_iou_distilled"] = round(hd, 4)
        result["held_iou_scratch"] = round(hs, 4)
        result["held_gap"] = round(hd - hs, 4)
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=None, help="a make_nusc_mini set (made if absent)")
    parser.add_argument("--workdir", default=None)
    parser.add_argument("--drop", type=float, default=0.9)
    parser.add_argument("--teacher-epochs", type=int, default=3)
    parser.add_argument("--student-epochs", type=int, default=2)
    parser.add_argument("--teacher-ckpt", default=None)
    parser.add_argument("--teacher-miou", type=float, default=None)
    parser.add_argument("--drop-classes", default=None,
                        type=lambda s: [int(c) for c in s.split(",") if c])
    parser.add_argument("--precision", default="float32", choices=("float32", "bfloat16"))
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    a = parser.parse_args(argv)
    print(json.dumps(run_ablation(
        root=a.root, workdir=a.workdir, drop=a.drop, teacher_epochs=a.teacher_epochs,
        student_epochs=a.student_epochs, teacher_ckpt=a.teacher_ckpt,
        teacher_miou=a.teacher_miou, drop_classes=a.drop_classes, precision=a.precision,
        cpu=a.cpu)))


if __name__ == "__main__":
    main()
