"""The teacher's eval step (port of ``make_eval_step`` of
``u2mkd_tpu/train/state.py``): one inference request from a host batch to
argmax predictions, IoU counters and logits."""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from u2mkd_tpu_torch.data import plumbing_host, wgeom_host
from u2mkd_tpu_torch.models import plumbing as P
from u2mkd_tpu_torch.train import metrics


def make_eval_step(model: torch.nn.Module, capacities: Sequence[int],
                   num_classes: int, ignore_label: int = 0) -> Callable:
    """Returns ``eval_fn(batch) -> {"pred", "counts", "logits"}``.

    ``batch`` holds numpy arrays (``feats``, ``pmask``, ``keyframe_mask``,
    ``labels``, and ``pcoords``/``xyz``) as ``data/synthetic.make_batch``
    gives them; with a ``plumbing`` entry (``plumbing_host.batch_plumbing``)
    the host build is skipped. Everything runs on the model's device."""
    device = next(model.parameters()).device
    wparams = wgeom_host.params_from_model(model)

    def eval_fn(batch: Dict) -> Dict:
        arrays = batch.get("plumbing")
        if arrays is None:
            arrays = plumbing_host.batch_plumbing(
                batch["pcoords"], batch["xyz"], batch["pmask"], capacities,
                wgeom_params=wparams)
        pl = P.from_precomputed(arrays, batch["pmask"], device)

        def dev(key, dtype):
            return torch.as_tensor(batch[key]).to(device=device, dtype=dtype)

        model.eval()
        with torch.no_grad():
            logits = model(dev("feats", torch.float32), pl)["x_vox"]
        pred = torch.argmax(logits, dim=-1)
        valid = pl.pmask & dev("keyframe_mask", torch.bool)
        counts = metrics.iou_counts(pred.reshape(-1), dev("labels", torch.int64).reshape(-1),
                                    valid.reshape(-1), num_classes, ignore_label)
        return {"pred": pred, "counts": counts, "logits": logits}

    return eval_fn
