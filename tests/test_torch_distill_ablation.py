"""The port's distillation-efficacy ablation
(``u2mkd_tpu_torch/distill_ablation.py``) against the JAX package's tool
(``tools/distill_ablation.py``), on the CPU.

The parsers read the same training-loop output alike; ``run_ablation``
starts the runs the JAX tool starts, on the port's entry points, with the
two arms' commands differing in the teacher-loss weights alone, and returns
the JAX tool's result for the same outputs. A real run on the CPU at one
epoch each is ``slow`` (about 100 s: three training processes). The
protocol's bounds are asserted on the card
(``tests/test_torch_cuda.py::test_distill_ablation_bounds_on_card``).
"""

import os
import sys

import numpy as np
import pytest

from test_torch_config_builder import REPO

sys.path.insert(0, os.path.join(REPO, "tools"))
import distill_ablation as jax_tool  # noqa: E402
from make_nusc_mini import generate  # noqa: E402

from u2mkd_tpu_torch import distill_ablation  # noqa: E402
from u2mkd_tpu_torch.train.loop import format_iou_table  # noqa: E402

HELD = (4, 7, 10)
NCLS = 17


def _loop_output(seed, epochs=3):
    """What the training loop prints for a stage-2 run of ``epochs``
    epochs: per epoch the voxel and pixel tables (``format_iou_table``,
    classes 0 and 5 never seen: NaN, left out) and the epoch line."""
    rng = np.random.RandomState(seed)
    lines = ["device: cpu", "[val] scored on raw points: counts_pix, counts_vox"]
    for epoch in range(1, epochs + 1):
        for key in ("counts_vox", "counts_pix"):
            per_class = rng.uniform(0, 1, NCLS)
            per_class[[0, 5]] = np.nan
            miou = float(np.nanmean(per_class))
            lines += [f"[val] {key}:", format_iou_table(per_class, miou)]
            if key == "counts_vox":
                vox = miou
        lines.append(f"epoch {epoch}/{epochs}: steps=3 loss={rng.uniform(1, 3):.4f} "
                     f"miou={vox * 100:.2f} wall=1.0s")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parsers_read_loop_output_as_jax(seed):
    """``_mious``, ``_vox_tables`` and ``_held_iou`` of both packages on the
    same recorded output: equal, the held classes read at the best epoch."""
    out = _loop_output(seed)
    assert distill_ablation._mious(out) == jax_tool._mious(out)
    assert len(distill_ablation._mious(out)) == 3
    tables = distill_ablation._vox_tables(out)
    assert tables == jax_tool._vox_tables(out) and len(tables) == 3
    assert sorted(tables[0]) == sorted([f"c{i}" for i in range(NCLS) if i not in (0, 5)]
                                       + ["Mean"])
    held = distill_ablation._held_iou(out, HELD)
    assert held == jax_tool._held_iou(out, HELD)
    best = max(tables, key=lambda t: t["Mean"])
    assert held == pytest.approx(np.mean([best[f"c{c}"] for c in HELD]))
    assert distill_ablation._held_iou(out, None) is None


def test_run_ablation_starts_the_jax_tools_runs(tmp_path, monkeypatch):
    """With the runs replaced by recorded outputs: the teacher on
    ``spformer_mini.yaml`` and the two arms on ``tsd_mini.yaml`` through the
    port's entry points, each with ``precision=`` and ``--cpu``; the arms'
    commands equal but for their run directories and
    ``criterion.w_kl=0.0 criterion.w_feat=0.0``; the result the JAX tool
    computes from the same outputs, key for key."""
    outputs = {"teacher": _loop_output(3), "distilled": _loop_output(4),
               "scratch": _loop_output(5)}
    cmds = {}

    def fake_run(cmd, timeout=3600):
        tag = os.path.basename(cmd[cmd.index("--run-dir") + 1])
        cmds[tag] = cmd
        return outputs[tag]

    monkeypatch.setattr(distill_ablation, "_run", fake_run)
    kw = dict(root=str(tmp_path / "set"), drop=0.0, teacher_epochs=12, student_epochs=12,
              drop_classes=HELD)
    got = distill_ablation.run_ablation(workdir=str(tmp_path / "port"), precision="bfloat16",
                                        cpu=True, **kw)
    assert sorted(cmds) == ["distilled", "scratch", "teacher"]
    for tag, (module, cfg) in (("teacher", distill_ablation.STAGE1),
                               ("distilled", distill_ablation.STAGE2),
                               ("scratch", distill_ablation.STAGE2)):
        assert cmds[tag][:4] == [sys.executable, "-m", module, cfg], tag
        assert "precision=bfloat16" in cmds[tag] and "--cpu" in cmds[tag], tag
    teacher_ckpt = os.path.join(str(tmp_path / "port"), "teacher", "checkpoints",
                                "max-iou-val-vox.pt")
    assert f"model.teacher_pretrain={teacher_ckpt}" in cmds["distilled"]
    assert "dataset.label_drop_classes=[4,7,10]" in cmds["distilled"]

    def without_run_dir(cmd):
        i = cmd.index("--run-dir")
        return cmd[:i] + cmd[i + 2:]

    d, s = without_run_dir(cmds["distilled"]), without_run_dir(cmds["scratch"])
    assert s == d + ["criterion.w_kl=0.0", "criterion.w_feat=0.0"]

    jax_outputs = iter([outputs["teacher"], outputs["distilled"], outputs["scratch"]])
    monkeypatch.setattr(jax_tool, "_run", lambda args, timeout=3600: next(jax_outputs))
    want = jax_tool.run_ablation(workdir=str(tmp_path / "jax"), **kw)
    assert got == want


@pytest.mark.slow
def test_run_ablation_on_cpu(tmp_path):
    """The port's ablation run for real on the CPU at one epoch each on a
    ``make_nusc_mini`` set: the JAX tool's keys, finite readings."""
    generate(str(tmp_path / "set"))
    r = distill_ablation.run_ablation(root=str(tmp_path / "set"), workdir=str(tmp_path / "w"),
                                      drop=0.0, drop_classes=HELD, teacher_epochs=1,
                                      student_epochs=1, cpu=True)
    assert sorted(r) == sorted(["metric", "teacher_miou", "distilled_miou", "scratch_miou",
                                "gap", "config", "held_iou_distilled", "held_iou_scratch",
                                "held_gap"])
    assert all(np.isfinite(v) for k, v in r.items() if k not in ("metric", "config"))
    for arm in ("distilled", "scratch"):
        assert os.path.isfile(tmp_path / "w" / arm / "checkpoints" / "max-iou-val-vox.pt")
