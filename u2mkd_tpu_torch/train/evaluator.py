"""Raw-point scoring and multi-vote test-time augmentation (port of
``u2mkd_tpu/train/evaluator.py``).

Equivalent of the reference ``NuScenes_Evaluator``
(``core/nusc_trainers.py:441-550``): run the model over the val split,
optionally summing logits over ``num_vote`` augmented copies of each scan
(TTA), devoxelize predictions back to the raw points through the stored
inverse maps, and compute per-class IoU. Vote sums and devoxelization run on
the host over the full-resolution clouds; the eval step stays fixed-shape.
Its command-line entry point is ``python -m u2mkd_tpu_torch.evaluate``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from u2mkd_tpu_torch.train import metrics as M


def host_array(x) -> np.ndarray:
    """``x`` (a tensor on any device, or an array) as a numpy array."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def devoxelize_predictions(logits: np.ndarray, pmask: np.ndarray,
                           info: Dict) -> np.ndarray:
    """Map per-voxel (point) logits back to the raw cloud via the inverse map
    (reference eval branch ``spformer_trainer.py:96-115``). Returns raw-point
    logits [N_raw, C]; raw points whose voxel was dropped at capacity get
    zeros."""
    inverse = info["inverse_map"]
    n_model = int(pmask.sum())
    safe = np.clip(inverse, 0, n_model - 1)
    out = logits[safe]
    out[inverse >= n_model] = 0.0
    return out


def evaluate_tta(eval_step: Callable, loader: Callable[[], Iterable], num_classes: int,
                 ignore_label: int = 0, num_vote: int = 1, logits_key: str = "logits",
                 sample_view: Optional[Callable[[Dict], Dict]] = None) -> Dict:
    """Accumulate IoU over the val set with optional vote-summed logits.

    ``loader()`` must yield, for each vote round, batches with identical
    sample order (vote > 1 implies the loader applies fresh random TTA
    augmentation per round; the reference sums logits over votes,
    ``nusc_trainers.py:517-536``). ``eval_step(batch)`` is one of the port's
    eval steps, which hold their model.

    ``sample_view`` maps a loader batch to the flat scoring view
    ``{pmask, labels, keyframe_mask, infos}`` for batch layouts that nest
    those keys: the TSD student batches nest them under ``"student"`` (the
    reference's evaluator likewise scores the student's ``outputs_vox``
    only). The full batch is still what ``eval_step`` receives.
    """
    counts = {k: np.zeros(num_classes, np.int64) for k in ("seen", "correct", "positive")}
    vote_sums: Dict[int, np.ndarray] = {}
    sample_meta: Dict[int, Dict] = {}
    for _ in range(num_vote):
        si = 0
        for batch in loader():
            logits = host_array(eval_step(batch)[logits_key])
            view = sample_view(batch) if sample_view is not None else batch
            infos = view.get("infos")
            for i in range(logits.shape[0]):
                info = infos[i] if infos else None
                pmask = host_array(view["pmask"][i])
                if info is not None:
                    raw_logits = devoxelize_predictions(logits[i], pmask, info)
                    labels = info["labels_full"]
                    kf = info.get("keyframe_mask_full")
                else:
                    raw_logits = logits[i][pmask]
                    labels = host_array(view["labels"][i])[pmask]
                    kf = host_array(view["keyframe_mask"][i])[pmask]
                if num_vote > 1:
                    vote_sums[si] = vote_sums.get(si, 0) + raw_logits
                    sample_meta[si] = {"labels": labels, "kf": kf}
                else:
                    _accumulate(counts, raw_logits, labels, kf, num_classes, ignore_label)
                si += 1
    for si, summed in vote_sums.items():
        meta = sample_meta[si]
        _accumulate(counts, summed, meta["labels"], meta["kf"], num_classes, ignore_label)
    miou, per_class = M.compute_miou(counts, ignore_label)
    return {"miou": miou, "per_class": per_class, "counts": counts}


def _accumulate(counts, logits, labels, kf, num_classes, ignore_label):
    pred = np.argmax(logits, axis=-1)
    keep = np.ones(len(pred), bool) if kf is None else kf.astype(bool)
    keep &= labels != ignore_label
    counts["seen"] = counts["seen"] + np.bincount(labels[keep],
                                                  minlength=num_classes)[:num_classes]
    counts["positive"] = counts["positive"] + np.bincount(pred[keep],
                                                          minlength=num_classes)[:num_classes]
    correct = (pred == labels) & keep
    counts["correct"] = counts["correct"] + np.bincount(labels[correct],
                                                        minlength=num_classes)[:num_classes]
