"""Checkpoints with the reference's saver semantics (port of
``u2mkd_tpu/train/checkpoints.py``), on ``torch.save``.

``CheckpointManager`` keeps ``latest`` (torchpack ``Saver(max_to_keep=1)``),
``max-iou-val-vox`` (``MaxSaver``, the best validation mIoU) and, every N
epochs, ``epoch-N``: one file ``<run_dir>/checkpoints/<name>.pt`` each,
written through a crash-safe rename. A checkpoint holds the state dicts of
the model, the optimizer and the scheduler, the step and the state of the
step's generator (:func:`training_state`). Stage 2 restores in three modes
(reference ``nusc_trainers.py:173-201``): a full resume
(:func:`load_training_state`), a backbone pretrain without the classifier
(:func:`load_pretrain_params`), and the frozen teacher alone from a stage-1
run (:func:`load_teacher_any`: a stage-1 checkpoint of the port, or a
reference ``.pt`` through ``models/convert_weights.load_teacher_pt``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

FORMAT = "u2mkd_tpu_torch"


def training_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                   scheduler=None, generator: Optional[torch.Generator] = None,
                   step: int = 0) -> Dict:
    """What a checkpoint holds: every state dict a resumed run needs."""
    return {"format": FORMAT, "model": model.state_dict(), "optimizer": optimizer.state_dict(),
            "scheduler": None if scheduler is None else scheduler.state_dict(),
            "generator": None if generator is None else generator.get_state(), "step": step}


def load_training_state(state: Dict, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                        scheduler=None, generator: Optional[torch.Generator] = None) -> int:
    """Full resume from :func:`training_state`'s dict (strict) -> its step."""
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    if scheduler is not None:
        scheduler.load_state_dict(state["scheduler"])
    if generator is not None:
        generator.set_state(state["generator"])
    return int(state["step"])


def _read(path: str):
    """The object a checkpoint file holds, or None for a path that is no
    file (a directory: the JAX package's orbax checkpoints)."""
    if not os.path.isfile(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


def _is_port(state) -> bool:
    return isinstance(state, dict) and state.get("format") == FORMAT


def load(path: str) -> Dict:
    """A checkpoint file of the port -> its dict. Raises for anything else:
    a directory (the JAX package's orbax checkpoints) or a ``.pt`` of the
    reference (a teacher's goes in through :func:`load_teacher_any`)."""
    path = os.path.abspath(path)
    state = _read(path)
    if _is_port(state):
        return state
    raise NotImplementedError(f"{path} is no checkpoint of this port (a reference .pt teacher "
                              f"goes in through load_teacher_any, model.teacher_pretrain)")


class CheckpointManager:
    """Latest + best-metric + periodic-epoch checkpoints."""

    def __init__(self, run_dir: str, metric_name: str = "iou-val-vox", epoch_to_save: int = 0):
        self.run_dir = os.path.abspath(run_dir)
        self.dir = os.path.join(self.run_dir, "checkpoints")
        os.makedirs(self.dir, exist_ok=True)
        self.metric_name = metric_name
        self.epoch_to_save = epoch_to_save
        self.best = -np.inf
        meta = os.path.join(self.dir, "best.json")
        if os.path.exists(meta):
            with open(meta) as f:
                self.best = json.load(f)["best"]

    def path(self, name: str) -> str:
        return os.path.join(self.dir, f"{name}.pt")

    def _save(self, name: str, state: Dict) -> None:
        """Crash-safe save: write ``<name>.pt.tmp``, then swap by renames, so
        that every interruption leaves the old or the new checkpoint on
        disk. A crash between the two renames leaves the survivor under the
        ``.old`` name only: this method and :meth:`restore` first promote an
        orphaned ``.old`` back to the live name."""
        path = self.path(name)
        tmp, old = path + ".tmp", path + ".old"
        self._recover(path)
        for p in (tmp, old):
            if os.path.exists(p):
                os.remove(p)
        torch.save(state, tmp)
        if os.path.exists(path):
            os.rename(path, old)
        os.rename(tmp, path)
        if os.path.exists(old):
            os.remove(old)

    def save_latest(self, state: Dict, epoch: int) -> None:
        self._save("latest", state)
        with open(os.path.join(self.dir, "latest.json"), "w") as f:
            json.dump({"epoch": epoch}, f)
        if self.epoch_to_save and epoch and epoch % self.epoch_to_save == 0:
            self._save(f"epoch-{epoch}", state)

    def save_best(self, state: Dict, metric_value: float) -> bool:
        """MaxSaver: keep ``max-<metric>`` when the metric improved."""
        if metric_value > self.best:
            self.best = float(metric_value)
            self._save(f"max-{self.metric_name}", state)
            with open(os.path.join(self.dir, "best.json"), "w") as f:
                json.dump({"best": self.best}, f)
            return True
        return False

    @staticmethod
    def _recover(path: str) -> None:
        """Promote an orphaned ``<path>.old`` back to the live name: a save
        preempted between its two renames leaves the only intact checkpoint
        there."""
        old = path + ".old"
        if not os.path.exists(path) and os.path.exists(old):
            os.rename(old, path)

    def restore(self, name: str) -> Dict:
        path = self.path(name)
        self._recover(path)
        return load(path)

    def latest_epoch(self) -> Optional[int]:
        meta = os.path.join(self.dir, "latest.json")
        if not os.path.exists(meta):
            return None
        with open(meta) as f:
            return json.load(f)["epoch"]


def load_pretrain_params(path: str, model: torch.nn.Module,
                         skip_classifier: bool = True) -> Dict[str, int]:
    """Backbone pretrain restore (reference ``nusc_trainers.py:180-188``,
    ``strict=False`` minus ``classifier``): every parameter and BN buffer
    of ``model`` whose name and shape match the checkpoint's is loaded,
    classifier entries are skipped, the rest stay at init. Raises when no
    parameter matches (a wrong checkpoint would otherwise train from random
    weights) or when the model has BN statistics and none matches (eval
    forwards would run on mean 0 / var 1). -> the counts."""
    src = load(path)["model"]
    params = dict(model.named_parameters())
    target = model.state_dict()
    stats = {"matched": 0, "unmatched": 0, "skipped": 0, "buffers_matched": 0,
             "buffers_unmatched": 0}
    loaded = {}
    for k, v in target.items():
        kind = "" if k in params else "buffers_"
        if skip_classifier and "classifier" in k:
            stats["skipped"] += 1
        elif k in src and tuple(src[k].shape) == tuple(v.shape):
            loaded[k] = src[k]
            stats[kind + "matched"] += 1
        else:
            stats[kind + "unmatched"] += 1
    if stats["matched"] == 0:
        raise ValueError(f"pretrain restore from {path} matched ZERO parameters (the model has "
                         f"{stats['unmatched']} unmatched): wrong checkpoint or another "
                         f"architecture or cr")
    if stats["buffers_unmatched"] and stats["buffers_matched"] == 0:
        raise ValueError(f"pretrain restore from {path} matched ZERO batch-stats buffers: "
                         f"eval forwards would run on initial running statistics")
    model.load_state_dict(loaded, strict=False)
    if stats["unmatched"] or stats["buffers_unmatched"]:
        print(f"pretrain restore: {stats['matched']} parameters and "
              f"{stats['buffers_matched']} buffers loaded, {stats['unmatched']} and "
              f"{stats['buffers_unmatched']} left at init, {stats['skipped']} classifier "
              f"entries skipped")
    return stats


def load_teacher_any(path: str, tsd: torch.nn.Module) -> Optional[Dict]:
    """Teacher-only restore into the TSD wrapper, strictly (reference
    ``nusc_trainers.py:190-199``): a stage-1 checkpoint of the port
    (parameters and BN statistics) becomes ``tsd.model_t``, or a reference
    ``SPVCNN_SPFORMER`` ``.pt`` file (such as the published
    ``max-iou-val-vox.pt``) is imported into it by
    ``convert_weights.load_teacher_pt``, whose report it returns (None for a
    checkpoint of the port). Raises for anything else."""
    from u2mkd_tpu_torch.models import convert_weights

    path = os.path.abspath(path)
    state = _read(path)
    if _is_port(state):
        tsd.model_t.load_state_dict(state["model"])
        return None
    if state is None:
        load(path)
    return convert_weights.teacher_from_state_dict(state, tsd, scope="model_t", source=path)
