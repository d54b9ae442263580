"""Criterion factories (port of ``u2mkd_tpu/train/criterions.py``; API parity
with the reference's ``core/builder.py:626-659`` and the criterion modules
in ``core/criterions.py``).

The port's steps call the mask-based functions of
:mod:`u2mkd_tpu_torch.ops.losses` directly; these factories give the
reference's named-criterion surface for users composing their own loops.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from u2mkd_tpu_torch.ops import losses


def _valid_of(ignore: int):
    """Ignore-mask composition shared by every criterion factory: labels at
    ``ignore`` are dropped, AND-ed with any caller mask."""

    def valid_of(labels: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
        v = labels != ignore
        return v if valid is None else (v & valid)

    return valid_of


def make_criterion(cfg) -> Callable:
    """name in {cross_entropy, lovasz}: (logits [N,C], labels [N], valid [N])
    -> scalar."""
    name = cfg.criterion.name
    valid_of = _valid_of(cfg.criterion.get("ignore_index", 0))
    if name == "cross_entropy":
        def crit(logits, labels, valid=None):
            return losses.cross_entropy(logits, labels, valid_of(labels, valid))
        return crit
    if name == "lovasz":
        def crit(logits, labels, valid=None):
            return losses.lovasz_ce(logits, labels, valid_of(labels, valid))
        return crit
    raise NotImplementedError(name)


def make_criterion_dict(cfg) -> Dict[str, Callable]:
    """List-config form: {'ce', 'lovasz', 'kl', 'mse'} callables (reference
    ``make_criterion_dict``, keys as ``nusc_trainers`` uses them)."""
    valid_of = _valid_of(cfg.criterion.get("ignore_index", 0))

    def lovasz(logits, labels, valid=None):
        return losses.lovasz_ce(logits, labels, valid_of(labels, valid))

    def ce(logits, labels, valid=None):
        return losses.cross_entropy(logits, labels, valid_of(labels, valid))

    def kl(student_logits, teacher_logits, valid=None):
        v = torch.ones(student_logits.shape[:-1], dtype=torch.bool,
                       device=student_logits.device) if valid is None else valid
        return losses.kl_div_batchmean(student_logits, teacher_logits, v)

    def mse(a, b, valid=None):
        v = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device) if valid is None else valid
        return losses.masked_mse(a, b, v)

    return {"ce": ce, "lovasz": lovasz, "kl": kl, "mse": mse}
