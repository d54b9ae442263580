"""Stage-1 teacher training CLI of the port (counterpart of the root
``train_spformer.py``).

Loads a recursive YAML config with dotted overrides, builds the teacher, its
optimizer and schedule and the loaders (``dataset.name``: the synthetic
dataset, or nuScenes, SemanticKITTI or Waymo files under ``dataset.root``),
and runs the epoch loop with mIoU validation (on every raw point of a real
dataset's scans) and the ``latest`` / ``max-iou-val-vox`` checkpoints under
``--run-dir``. ``train.overflow_checks`` (on by default) logs the capacity
counters every ``log_every`` steps; ``train.strict_capacity`` (off by
default) fails the run when a voxel grid saturates. Runs on the card unless
``--cpu`` is given. ``--multihost`` runs one process of a data-parallel run
(``parallel/mesh.py``): each of ``--num-processes`` processes trains on its
own shard of every batch and epoch, with its BN statistics, gradients and
counters reduced over the group; rank 0 alone writes ``--run-dir``.

Usage:
  python -m u2mkd_tpu_torch.train_spformer configs/synthetic/train/spformer_tiny.yaml \\
      --run-dir RUN [--weight-path RUN/checkpoints/latest.pt] [--cpu] [k.e.y=value ...]
  python -m u2mkd_tpu_torch.train_spformer configs/nuscenes/train/spformer.yaml \\
      --run-dir RUN dataset.root=/data/nuscenes
  python -m u2mkd_tpu_torch.train_spformer CONFIG --run-dir RUN --multihost \\
      --coordinator HOST:PORT --num-processes N --process-id I [--backend gloo] [--cpu]
"""

from __future__ import annotations

import argparse

import torch

from u2mkd_tpu_torch.ops import precision
from u2mkd_tpu_torch.parallel import mesh
from u2mkd_tpu_torch.train import builder, checkpoints, loop, state
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
    # intermixed: overrides may come before or after the flags
    args = parser.parse_intermixed_args(argv)

    cfg = config_lib.load(args.config)
    config_lib.update_dotted(cfg, args.opts)
    group, world = mesh.setup_multihost(args, cfg)
    device = mesh.local_device("cpu" if args.cpu else None)
    seed = cfg.train.seed % (2 ** 31)
    print(f"device: {device}")

    model = builder.make_model(cfg, device, seed, process_group=group)
    print(precision.numerics_line())
    optimizer, scheduler = builder.make_optimizer_and_schedule(cfg, model.named_parameters(),
                                                               world)
    generator = torch.Generator(device=device).manual_seed(seed)
    caps = tuple(cfg.capacities)
    train_loader, val_loader = builder.make_loaders(cfg, model)
    start_step = 0
    if args.weight_path:
        start_step = checkpoints.load_training_state(checkpoints.load(args.weight_path), model,
                                                     optimizer, scheduler, generator)
        print(f"resumed from {args.weight_path}")

    ignore = cfg.data.ignore_label
    ncls = cfg.data.num_classes
    ovf = bool(cfg.get_path("train.overflow_checks", True))
    loop.Trainer(
        run_dir=args.run_dir, model=model, optimizer=optimizer, scheduler=scheduler,
        generator=generator,
        train_step=mesh.data_parallel_step(
            state.make_train_step(model, optimizer, caps, ignore, scheduler, generator,
                                  overflow_checks=ovf, process_group=group), model, group),
        eval_step=mesh.data_parallel_eval(
            state.make_eval_step(model, caps, ncls, ignore, process_group=group), model, group),
        train_loader=train_loader, val_loader=val_loader, num_epochs=cfg.num_epochs,
        num_classes=ncls, ignore_label=ignore,
        epoch_to_save=cfg.get_path("epoch_to_save", 0), start_step=start_step,
        strict_capacity=bool(cfg.get_path("train.strict_capacity", False)),
    ).train()
    mesh.finish_multihost(args, model)


if __name__ == "__main__":
    main()
