"""Evaluation CLI of the port, with multi-vote test-time augmentation
(counterpart of the root ``evaluate.py``).

The reference's ``NuScenes_Evaluator`` path (``core/nusc_trainers.py:441-550``):
load a checkpoint of the port, run the val split, devoxelize the predictions
to every raw point, print the per-class IoU table and the mIoU. With
``--num-vote N`` > 1 the val datasets augment each pass afresh and the
logits of the N views of each scan are summed before the argmax; one vote
keeps the clean val pipeline, which gives the training loop's validation
number for the same checkpoint.

Both stages: a teacher config evaluates the uni-modal model; a
``spvcnn_swiftnet18_spformer_tsd_full`` config loads the whole stage-2
checkpoint and runs only the student, scoring its devoxelized voxel head as
the reference's evaluator does (``nusc_trainers.py:493-550``). The val
loaders are the training CLIs' (``train/builder.py``; the synthetic
teacher's from ``train.seed`` too, as its training loop's), and a stage-2
val batch carries no teacher plumbing. Runs on the card unless ``--cpu``
is given.

Usage:
  python -m u2mkd_tpu_torch.evaluate configs/nuscenes/train/spformer.yaml \\
      --checkpoint RUN/checkpoints/max-iou-val-vox.pt [--num-vote 3] [--cpu] \\
      dataset.name=semantic_nusc dataset.root=/data/nuscenes [k.e.y=value ...]
"""

from __future__ import annotations

import argparse
from typing import Dict

from u2mkd_tpu_torch.core.device import resolve_device
from u2mkd_tpu_torch.ops import precision
from u2mkd_tpu_torch.train import builder, checkpoints, distill, evaluator, loop, state
from u2mkd_tpu_torch.utils import config as config_lib

STUDENT_MODEL = "spvcnn_swiftnet18_spformer_tsd_full"


def tsd_student_view(batch: Dict) -> Dict:
    """The flat scoring view of a stage-2 batch for ``evaluate_tta``: the
    student's mask, labels and keyframe mask and each sample's student
    devoxelize information (the reference scores the student's voxel head,
    ``nusc_trainers.py:517-536``)."""
    stu = batch["student"]
    infos = batch.get("infos")
    return {"pmask": stu["pmask"], "labels": stu["labels"],
            "keyframe_mask": stu.get("keyframe_mask"),
            "infos": [i["student"] for i in infos] if infos else None}


def main(argv=None) -> Dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("config")
    parser.add_argument("--checkpoint", required=True, help="a checkpoint of the port")
    parser.add_argument("--num-vote", type=int, default=1,
                        help="views summed per scan (test-time augmentation)")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    parser.add_argument("opts", nargs="*", help="dotted config overrides")
    # intermixed: overrides may come before or after the flags
    args = parser.parse_intermixed_args(argv)

    cfg = config_lib.load(args.config)
    config_lib.update_dotted(cfg, args.opts)
    device = resolve_device("cpu" if args.cpu else None)
    print(f"device: {device}")
    model = builder.make_model(cfg, device)
    print(precision.numerics_line())
    model.load_state_dict(checkpoints.load(args.checkpoint)["model"])
    print(f"loaded {args.checkpoint}")
    ncls = cfg.data.num_classes
    tta = args.num_vote > 1
    if cfg.model.name == STUDENT_MODEL:
        ignore = cfg.criterion.ignore_index
        s_caps = tuple(cfg.get_path("student_capacities") or cfg.capacities)
        t_caps = tuple(cfg.get_path("teacher_capacities") or cfg.capacities)
        _, val_loader = builder.make_distill_loaders(cfg, model, tta_val=tta)
        eval_step = distill.make_distill_eval_step(model, s_caps, t_caps, ncls, ignore)
        view = tsd_student_view
    else:
        ignore = cfg.data.ignore_label
        _, val_loader = builder.make_loaders(cfg, model, tta_val=tta)
        eval_step = state.make_eval_step(model, tuple(cfg.capacities), ncls, ignore)
        view = None
    res = evaluator.evaluate_tta(eval_step, val_loader, ncls, ignore, num_vote=args.num_vote,
                                 logits_key="logits", sample_view=view)
    print(loop.format_iou_table(res["per_class"], res["miou"]))
    print(f"mIoU: {res['miou'] * 100:.2f}")
    return res


if __name__ == "__main__":
    main()
