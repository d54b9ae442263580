"""Mean-IoU counters (port of ``u2mkd_tpu/train/metrics.py``).

Targets equal to the ignore label are dropped; per class iou = correct /
(seen + positive - correct); classes never seen count as 1, except the
ignore class, which is skipped.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def iou_counts(pred: torch.Tensor, target: torch.Tensor, valid: torch.Tensor,
               num_classes: int, ignore_label: int = 0) -> Dict[str, torch.Tensor]:
    """Per-class seen/correct/positive counts [C] int32 of one batch."""
    keep = valid & (target != ignore_label)
    t = target[keep].long()
    p = pred[keep].long()

    def count(x):
        return torch.bincount(x, minlength=num_classes)[:num_classes].to(torch.int32)

    return {"seen": count(t), "correct": count(t[p == t]), "positive": count(p)}


def compute_miou(counts: Dict, ignore_label: int = 0):
    """(miou, per-class iou with nan for the skipped ignore class), on the host."""
    seen = np.asarray(counts["seen"], np.float64)
    correct = np.asarray(counts["correct"], np.float64)
    positive = np.asarray(counts["positive"], np.float64)
    ious = []
    per_class = np.full(len(seen), np.nan)
    for i in range(len(seen)):
        if seen[i] == 0:
            if i == ignore_label:
                continue
            v = 1.0
        else:
            v = correct[i] / (seen[i] + positive[i] - correct[i])
        ious.append(v)
        per_class[i] = v
    return (float(np.mean(ious)) if ious else 0.0), per_class
