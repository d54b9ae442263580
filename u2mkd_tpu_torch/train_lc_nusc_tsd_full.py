"""Stage-2 training CLI of the port: the camera+LiDAR student distilled
from the frozen teacher (TSD; counterpart of the root
``train_lc_nusc_tsd_full.py``).

Paired student/teacher batches (``dataset.name``: the synthetic dataset, or
``lc_semantic_nusc_tsd_full`` on nuScenes files under ``dataset.root``), the
five-term distillation loss, voxel and pixel mIoU validation on every raw
point of a real dataset's scans (the best checkpoint follows the voxel
head's). The
frozen teacher comes from a stage-1 checkpoint of the port or a reference
``SPVCNN_SPFORMER`` ``.pt`` through the dotted option
``model.teacher_pretrain=PATH``; ``model.imagenet_pretrain=PATH`` starts
the image branch from torchvision's ResNet-18 (``resnet18-5c106cde.pth``);
``model.pretrain_weight`` loads a backbone without its classifier;
``--weight-path`` resumes a run. ``train.overflow_checks`` (on by default)
logs both parts' capacity counters every ``log_every`` steps;
``train.strict_capacity`` (off by default) fails the run when a voxel grid
saturates. ``train.remat`` (off by default) recomputes the student's
forward segments in the backward (``models/blocks.Remat``): the same
losses and updates in less device memory, for more device time.
``train.split_step`` has no effect: in torch the split step is the fused
step's computation. Runs on the card unless ``--cpu`` is given.
``--multihost
--coordinator --num-processes --process-id`` run one process of a
data-parallel run, as the stage-1 CLI.

Usage:
  python -m u2mkd_tpu_torch.train_lc_nusc_tsd_full configs/synthetic/train/tsd_tiny.yaml \\
      --run-dir RUN [--weight-path CKPT] [--cpu] [model.teacher_pretrain=CKPT] [k.e.y=value ...]
  python -m u2mkd_tpu_torch.train_lc_nusc_tsd_full \\
      configs/nuscenes/train/spformer_tsd_full_ours_star.yaml --run-dir RUN \\
      dataset.root=/data/nuscenes model.teacher_pretrain=max-iou-val-vox.pt \\
      model.imagenet_pretrain=resnet18-5c106cde.pth
"""

from __future__ import annotations

import argparse

import torch

from u2mkd_tpu_torch.models import convert_weights
from u2mkd_tpu_torch.ops import precision
from u2mkd_tpu_torch.parallel import mesh
from u2mkd_tpu_torch.train import builder, checkpoints, distill, loop
from u2mkd_tpu_torch.utils import config as config_lib


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config")
    parser.add_argument("--run-dir", required=True)
    parser.add_argument("--weight-path", default=None,
                        help="a checkpoint of the port to resume from")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    mesh.add_multihost_args(parser)
    parser.add_argument("opts", nargs="*", help="dotted config overrides")
    args = parser.parse_intermixed_args(argv)

    cfg = config_lib.load(args.config)
    config_lib.update_dotted(cfg, args.opts)
    group, world = mesh.setup_multihost(args, cfg)
    device = mesh.local_device("cpu" if args.cpu else None)
    seed = cfg.train.seed % (2 ** 31)
    print(f"device: {device}")

    model = builder.make_model(cfg, device, seed, process_group=group)
    print(precision.numerics_line())
    name, lr, kw = builder.optimizer_spec(cfg, world)
    optimizer, scheduler = distill.make_frozen_teacher_optimizer(model, name, lr, **kw)
    generator = torch.Generator(device=device).manual_seed(seed)
    s_caps = tuple(cfg.get_path("student_capacities") or cfg.capacities)
    t_caps = tuple(cfg.get_path("teacher_capacities") or cfg.capacities)
    train_loader, val_loader = builder.make_distill_loaders(cfg, model)
    # ImageNet init of the image branch (reference swiftnet.py:338-343)
    imagenet = cfg.get_path("model.imagenet_pretrain")
    if imagenet:
        convert_weights.load_imagenet_pretrain(imagenet, model.model_s)
        print(f"loaded ImageNet backbone from {imagenet}")

    # three restore modes (reference nusc_trainers.py:173-201)
    start_step = 0
    if args.weight_path:
        start_step = checkpoints.load_training_state(checkpoints.load(args.weight_path), model,
                                                     optimizer, scheduler, generator)
        print(f"resumed from {args.weight_path}")
    else:
        pretrain = cfg.get_path("model.pretrain_weight")
        if pretrain:
            checkpoints.load_pretrain_params(pretrain, model)
            print(f"loaded pretrain (no classifier) from {pretrain}")
        teacher = cfg.get_path("model.teacher_pretrain")
        if teacher:
            checkpoints.load_teacher_any(teacher, model)
            print(f"loaded frozen teacher from {teacher}")

    ignore = cfg.criterion.ignore_index
    ncls = cfg.data.num_classes
    debug_val = bool(cfg.get_path("debug.debug_val", False))
    step = distill.make_distill_train_step(
        model, optimizer, s_caps, t_caps, w_kl=cfg.criterion.get("w_kl", 1.0),
        w_feat=cfg.criterion.get("w_feat", 1.0), ignore_label=ignore,
        mse_norm_feat=cfg.criterion.get("mse_norm_feat", False), scheduler=scheduler,
        generator=generator, overflow_checks=bool(cfg.get_path("train.overflow_checks", True)),
        remat=bool(cfg.get_path("train.remat", False)), process_group=group)
    ev = distill.make_distill_eval_step(model, s_caps, t_caps, ncls, ignore,
                                        run_teacher=debug_val, process_group=group)
    step = mesh.data_parallel_step(step, model, group)
    ev = mesh.data_parallel_distill_eval(ev, model, group)
    loop.Trainer(
        run_dir=args.run_dir, model=model, optimizer=optimizer, scheduler=scheduler,
        generator=generator, train_step=step, eval_step=ev, train_loader=train_loader,
        val_loader=val_loader, num_epochs=cfg.num_epochs, num_classes=ncls, ignore_label=ignore,
        eval_counts_key="counts_vox",
        extra_count_keys=("counts_pix",) + (("counts_teacher",) if debug_val else ()),
        epoch_to_save=cfg.get_path("epoch_to_save", 0), start_step=start_step,
        # raw-cloud scoring as the reference (nusc_trainers.py:368-390): the
        # voxel head's logits devoxelized to every raw point, the pixel
        # head's to the raw points in a camera's view; batches without
        # devoxelize information (synthetic) are scored on their padded points
        eval_raw_points=bool(cfg.get_path("eval.raw_points", True)),
        raw_specs=[loop.RawSpec("counts_vox", "logits", "student", None),
                   loop.RawSpec("counts_pix", "logits_pix", "student", "fov_full")],
        strict_capacity=bool(cfg.get_path("train.strict_capacity", False)),
    ).train()
    mesh.finish_multihost(args, model)


if __name__ == "__main__":
    main()
