"""Optimizers with transformer-block LR scaling (port of
``u2mkd_tpu/train/optim.py``), on ``torch.optim``.

The optax chains of the JAX package map onto torch's optimizers:

  * ``sgd`` / ``sgd_spformer``: decayed weights, Nesterov momentum 0.9, then
    the LR: ``SGD(momentum, nesterov=True, dampening=0, weight_decay)``;
  * ``adam``: L2 decay coupled into the gradient before the moments, as
    torch's ``Adam(weight_decay)`` does;
  * ``adamw`` / ``adamw_spformer``: decoupled decay, ``AdamW``.

Weight decay covers every parameter, BN scales and biases included
(optax ``add_decayed_weights`` has no mask). The ``_spformer`` variants put
every parameter whose name contains ``sphereformer`` in a group at
``lr * transformer_lr_scale``, which equals optax's masked ``scale`` applied
after the LR. A callable ``lr`` is a schedule of the step: the groups then
start at 1 (times the scale) and a ``LambdaLR`` multiplies them, evaluated at
step 0 for the first update as optax evaluates its schedule at count 0.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple, Union

import torch

NAMES = ("sgd", "sgd_spformer", "adam", "adamw", "adamw_spformer")


def make_optimizer(
    named_params: Iterable[Tuple[str, torch.nn.Parameter]],
    name: str,
    lr: Union[float, Callable[[int], float]],
    weight_decay: float = 1e-4,
    momentum: float = 0.9,
    nesterov: bool = True,
    transformer_lr_scale: float = 0.1,
) -> Tuple[torch.optim.Optimizer, Optional[torch.optim.lr_scheduler.LambdaLR]]:
    """``named_params`` as ``model.named_parameters()`` gives them -> the
    optimizer and, for a callable ``lr``, its ``LambdaLR`` (else None). Call
    the scheduler's ``step()`` after each ``optimizer.step()``."""
    if name not in NAMES:
        raise NotImplementedError(name)
    base = 1.0 if callable(lr) else float(lr)
    named = list(named_params)
    if name.endswith("_spformer"):
        groups = [
            {"params": [p for n, p in named if "sphereformer" not in n], "lr": base},
            {"params": [p for n, p in named if "sphereformer" in n],
             "lr": base * transformer_lr_scale},
        ]
        groups = [g for g in groups if g["params"]]
    else:
        groups = [{"params": [p for _, p in named], "lr": base}]

    if name.startswith("sgd"):
        opt = torch.optim.SGD(groups, lr=base, momentum=momentum, dampening=0,
                              nesterov=nesterov, weight_decay=weight_decay)
    elif name == "adam":
        opt = torch.optim.Adam(groups, lr=base, weight_decay=weight_decay)
    else:
        opt = torch.optim.AdamW(groups, lr=base, weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lr) if callable(lr) else None
    return opt, sched
