"""LR multipliers per optimizer step (port of ``u2mkd_tpu/train/schedulers.py``).

Each returns ``schedule(step) -> float``, the factor a ``LambdaLR`` applies
to the base learning rate; step 0 is the first update.
"""

from __future__ import annotations

import math


def cosine_schedule_with_warmup(num_epochs: int, batch_size: int,
                                dataset_size: int, world_size: int = 1):
    """Linear warmup over 1000 / world_size iterations (none on one
    device), then cosine to zero over the whole run, with the world-scaled
    batch of the reference's schedule."""
    eff_batch = batch_size * world_size
    warmup_iters = 0 if world_size == 1 else 1000 // world_size
    iter_per_epoch = (dataset_size + eff_batch - 1) // eff_batch
    total = num_epochs * iter_per_epoch

    def schedule(step: int) -> float:
        if step < warmup_iters:
            return (step + 1) / max(warmup_iters, 1)
        return 0.5 * (1 + math.cos(math.pi * (step - warmup_iters) / total))

    return schedule


def poly_lr(max_iter: int, power: float = 0.9):
    """DeepLab poly schedule."""

    def schedule(step: int) -> float:
        return (1.0 - step / (max_iter + 1)) ** power

    return schedule
