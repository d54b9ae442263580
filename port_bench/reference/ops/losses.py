"""Segmentation losses: masked Lovász-softmax, cross-entropy, KL distillation.

Port of ``u2mkd_tpu/ops/losses.py``. Everything is fixed-shape and
mask-driven: padding stays in place and is weighted out, so the valid mask
can carry ``pmask`` and ``keyframe_mask`` besides the ignore label.

Lovász batches its C per-class problems into one ``[C, N]`` descending
sort. The sort is stable, so ties keep index order as the JAX package's
stable ``argsort(-e)`` does; invalid entries sort to the tail with error -1
and are clamped back to 0 so they contribute nothing.
"""

from __future__ import annotations

from typing import Optional

import torch


def lovasz_softmax(logits: torch.Tensor, labels: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """Multi-class Lovász-softmax over valid entries, averaged over the
    classes present in the valid labels (``classes='present'``).

    logits [N, C] float, labels [N] int, valid [N] bool."""
    n, c = logits.shape
    probs = torch.softmax(logits, dim=-1)
    fg = (labels[:, None] == torch.arange(c, device=logits.device)[None, :]) & valid[:, None]
    fg = fg.to(probs.dtype)
    errors = torch.where(valid[:, None], (fg - probs).abs(), -1.0)
    errors_sorted, order = torch.sort(errors.T, dim=-1, descending=True, stable=True)
    fg_sorted = torch.gather(fg.T, 1, order)
    errors_sorted = errors_sorted.clamp(min=0.0)
    gts = fg_sorted.sum(-1, keepdim=True)                          # [C, 1]
    intersection = gts - torch.cumsum(fg_sorted, -1)
    union = gts + torch.cumsum(1.0 - fg_sorted, -1)
    jaccard = 1.0 - intersection / union.clamp(min=1e-12)
    grad = torch.cat([jaccard[:, :1], jaccard[:, 1:] - jaccard[:, :-1]], dim=-1)
    losses = (errors_sorted * grad).sum(-1)                         # [C]
    present = gts[:, 0] > 0
    denom = present.sum().clamp(min=1)
    return torch.where(present, losses, 0.0).sum() / denom


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                  class_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over valid entries, weight-normalized as torch's
    ``CrossEntropyLoss(weight, ignore_index)``; labels clipped into range."""
    logp = torch.log_softmax(logits, dim=-1)
    safe = labels.long().clamp(0, logits.shape[-1] - 1)
    nll = -torch.gather(logp, 1, safe[:, None])[:, 0]
    w = class_weight[safe] if class_weight is not None else torch.ones_like(nll)
    w = torch.where(valid, w, 0.0)
    return (nll * w).sum() / w.sum().clamp(min=1e-12)


def lovasz_ce(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
              class_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``MixLovaszCrossEntropy``: Lovász-softmax plus cross-entropy."""
    return lovasz_softmax(logits, labels, valid) + cross_entropy(
        logits, labels, valid, class_weight)


def kl_div_batchmean(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """KL(softmax(teacher) || softmax(student)) summed over classes and
    divided by the number of valid rows (torch ``KLDivLoss('batchmean')``);
    the caller detaches the teacher."""
    logp = torch.log_softmax(student_logits, dim=-1)
    logq = torch.log_softmax(teacher_logits, dim=-1)
    pointwise = (torch.softmax(teacher_logits, dim=-1) * (logq - logp)).sum(-1)
    pointwise = torch.where(valid, pointwise, 0.0)
    return pointwise.sum() / valid.sum().clamp(min=1)


def masked_mse(a: torch.Tensor, b: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean squared error over the elements of the valid rows."""
    d = torch.where(valid[:, None], (a - b) ** 2, 0.0)
    return d.sum() / (valid.sum() * a.shape[-1]).clamp(min=1)
