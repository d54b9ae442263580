"""The stage-2 student's eval step (port of ``make_distill_eval_step`` of
``u2mkd_tpu/train/distill.py``): one inference request of the camera +
LiDAR student, and optionally of the frozen teacher on its own multisweep
cloud. The distillation train step is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from u2mkd_tpu_torch.models.tsd import TSDFull
from u2mkd_tpu_torch.train import metrics
from u2mkd_tpu_torch.train.state import batch_reader

STUDENT_KEYS = {"feats": torch.float32, "images": torch.float32,
                "pix_coords": torch.float32, "cam_masks": torch.bool,
                "fov_mask": torch.bool}


def make_distill_eval_step(model: TSDFull, s_caps: Sequence[int], t_caps: Sequence[int],
                           num_classes: int, ignore_label: int = 0,
                           run_teacher: bool = False) -> Callable:
    """Returns ``eval_fn(batch)`` for ``batch = {"student": ..., "teacher":
    ...}`` as ``data/synthetic.make_multimodal_batch`` gives it (numpy
    arrays; a ``plumbing`` entry in either skips its host build) ->
    {"pred_vox", "pred_pix", "counts_vox", "counts_pix", "logits",
    "logits_pix"} and, with ``run_teacher``, "counts_teacher" and the
    teacher's "logits_teacher" (a key the JAX step does not return). The pixel
    head is scored on the points in a camera's field of view only; the
    teacher on its valid keyframe points. The student's plumbing carries the
    point maps of every level and the window geometry of
    ``wgeom_host.params_from_model(model.model_s)``; the teacher's those of
    ``model.model_t``."""
    _, student_plumbing, tensor_of = batch_reader(model.model_s, s_caps)
    _, teacher_plumbing, _ = batch_reader(model.model_t, t_caps)

    def eval_fn(batch: Dict) -> Dict:
        sb, tb = batch["student"], batch.get("teacher")
        spl = student_plumbing(sb)
        tpl = teacher_plumbing(tb) if run_teacher else None
        s_in = {k: tensor_of(sb, k, dt) for k, dt in STUDENT_KEYS.items()}
        t_in = {"feats": tensor_of(tb, "feats", torch.float32)} if run_teacher else None
        model.eval()
        with torch.no_grad():
            out = model(s_in, spl, t_in, tpl, run_teacher)
        stu = out["stu"]
        pred_vox = torch.argmax(stu["x_vox"], dim=-1)
        pred_pix = torch.argmax(stu["x_pix"], dim=-1)
        labels = tensor_of(sb, "labels", torch.int64).reshape(-1)
        valid = spl.pmask
        fov = valid & s_in["fov_mask"]
        res = {"pred_vox": pred_vox, "pred_pix": pred_pix,
               "counts_vox": metrics.iou_counts(pred_vox.reshape(-1), labels,
                                                valid.reshape(-1), num_classes, ignore_label),
               "counts_pix": metrics.iou_counts(pred_pix.reshape(-1), labels,
                                                fov.reshape(-1), num_classes, ignore_label),
               "logits": stu["x_vox"], "logits_pix": stu["x_pix"]}
        if run_teacher:
            pred_t = torch.argmax(out["t"]["x_vox"], dim=-1)
            t_valid = tpl.pmask & tensor_of(tb, "keyframe_mask", torch.bool)
            res["counts_teacher"] = metrics.iou_counts(
                pred_t.reshape(-1), tensor_of(tb, "labels", torch.int64).reshape(-1),
                t_valid.reshape(-1), num_classes, ignore_label)
            res["logits_teacher"] = out["t"]["x_vox"]
        return res

    return eval_fn
