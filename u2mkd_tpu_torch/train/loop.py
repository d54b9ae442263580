"""Epoch training loop with validation, metric logging and checkpoints (port
of ``u2mkd_tpu/train/loop.py``).

Replaces torchpack's ``Trainer.train_with_defaults`` with its ``MeanIoU``,
``Saver`` and ``MaxSaver`` callbacks (reference ``train_spformer.py:97-115``):
one Python loop over the port's train and eval steps on one device, a JSONL
metric log (and TensorBoard's, where installed), per-class IoU tables, and
the mean eval time with the reference's warm-up trim (``InferTime``).
Validation scores every raw point of a real dataset's scans, devoxelized
through the inverse maps its batches carry (:class:`RawSpec`), and the
padded points of batches that carry none (the synthetic ones), as the JAX
loop does. Under data parallelism (``parallel/mesh.py``) every rank runs
the loop on its own shard, and only rank 0 writes the run directory (its
metrics, TensorBoard events and checkpoints); the steps' collectives run on
every rank, and the raw-point counters, which each rank scores on its own
scans, are summed over the ranks at the end of each evaluation.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional

import numpy as np
import torch

from u2mkd_tpu_torch.parallel import mesh
from u2mkd_tpu_torch.train import evaluator as E
from u2mkd_tpu_torch.train import metrics as M
from u2mkd_tpu_torch.train import overflow
from u2mkd_tpu_torch.train.checkpoints import CheckpointManager, training_state


class SummaryWriter:
    """JSONL metrics log, and TensorBoard events where
    ``torch.utils.tensorboard`` can be imported."""

    def __init__(self, run_dir: str, tensorboard: bool = True):
        os.makedirs(run_dir, exist_ok=True)
        self._f = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter as TBWriter
            except ImportError:
                TBWriter = None
            if TBWriter is not None:
                self._tb = TBWriter(log_dir=os.path.join(run_dir, "tb"))

    def add_scalar(self, name: str, value: float, step: int) -> None:
        self._f.write(json.dumps({"name": name, "value": float(value), "step": int(step),
                                  "ts": time.time()}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(name, value, step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def format_iou_table(per_class: np.ndarray, miou: float,
                     class_names: Optional[List[str]] = None) -> str:
    names = class_names or [f"c{i}" for i in range(len(per_class))]
    rows = [(n, f"{v * 100:.2f}") for n, v in zip(names, per_class) if not np.isnan(v)]
    rows.append(("Mean", f"{miou * 100:.2f}"))
    w1 = max(len(r[0]) for r in rows)
    w2 = max(len(r[1]) for r in rows)
    sep = "+" + "-" * (w1 + 2) + "+" + "-" * (w2 + 2) + "+"
    lines = [sep]
    for n, v in rows:
        lines.append(f"| {n:<{w1}} | {v:>{w2}} |")
    lines.append(sep)
    return "\n".join(lines)


class _NullSummary:
    """The summary writer of a rank other than 0: writes nothing."""

    def add_scalar(self, name: str, value: float, step: int) -> None:
        pass

    def close(self) -> None:
        pass


class RawSpec(NamedTuple):
    """One raw-point scoring rule for ``Trainer.evaluate``.

    counts_key:  counter dict in the totals to accumulate into.
    logits_key:  eval-step output holding padded per-voxel logits [B, P, C].
    info_key:    sub-entry of ``batch['infos'][i]`` holding the devox info
                 (None -> the info dict itself; "student" for distill
                 batches), also selects the sub-batch carrying ``pmask``.
    filter_key:  optional boolean raw-cloud mask inside the info to restrict
                 scoring (e.g. "keyframe_mask_full" for multisweep teachers,
                 "fov_full" for the student pixel head).
    """

    counts_key: str
    logits_key: str
    info_key: Optional[str] = None
    filter_key: Optional[str] = "keyframe_mask_full"


class Trainer:
    """Epoch loop over the port's train and eval steps.

    ``train_loader()`` / ``val_loader()`` return a fresh iterable of batches
    each epoch. ``eval_counts_key`` names the counter dict of the eval
    step's output whose mIoU picks the best checkpoint (``counts_vox`` for
    the stage-2 student); ``extra_count_keys`` are scored and logged too.
    With ``eval_raw_points``, a val batch that carries devoxelize
    information (``infos``) is scored on its raw points by ``raw_specs``
    (by default ``eval_counts_key`` on ``logits``, keyframe points only);
    the other counters come from the eval step. Every ``log_every`` steps
    the train step's aux is fetched and logged, and its capacity counters
    checked (``overflow.check_aux``; ``strict_capacity`` fails the run on a
    violation). A checkpoint holds the model, ``optimizer``, ``scheduler``
    and the step's ``generator`` (:func:`checkpoints.training_state`); a
    resumed run passes its step as ``start_step``."""

    def __init__(self, run_dir: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 scheduler, generator: Optional[torch.Generator], train_step: Callable,
                 eval_step: Callable, train_loader: Callable[[], Iterable],
                 val_loader: Callable[[], Iterable], num_epochs: int, num_classes: int,
                 ignore_label: int = 0, class_names: Optional[List[str]] = None,
                 eval_counts_key: str = "counts", extra_count_keys: Iterable[str] = (),
                 epoch_to_save: int = 0, log_every: int = 10, start_step: int = 0,
                 eval_raw_points: bool = True, raw_specs: Optional[List[RawSpec]] = None,
                 strict_capacity: bool = False):
        # data parallelism: rank 0 alone writes the run directory
        self.is_master = mesh.process_index() == 0
        self.run_dir = os.path.abspath(run_dir)
        if self.is_master:
            os.makedirs(self.run_dir, exist_ok=True)
        self.model, self.optimizer = model, optimizer
        self.scheduler, self.generator = scheduler, generator
        self.train_step, self.eval_step = train_step, eval_step
        self.train_loader, self.val_loader = train_loader, val_loader
        self.num_epochs = num_epochs
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.class_names = class_names
        self.eval_counts_key = eval_counts_key
        self.extra_count_keys = tuple(extra_count_keys)
        self.summary = SummaryWriter(self.run_dir) if self.is_master else _NullSummary()
        self.ckpt = (CheckpointManager(self.run_dir, epoch_to_save=epoch_to_save)
                     if self.is_master else None)
        self.log_every = log_every
        self.global_step = start_step
        self.eval_raw_points = eval_raw_points
        self.strict_capacity = strict_capacity
        self.raw_specs = raw_specs or [RawSpec(eval_counts_key, "logits", None,
                                               "keyframe_mask_full")]

    def state(self) -> Dict:
        return training_state(self.model, self.optimizer, self.scheduler, self.generator,
                              self.global_step)

    def _spec_info(self, batch, spec: RawSpec, i: int):
        info = batch["infos"][i]
        if info is not None and spec.info_key is not None:
            info = info.get(spec.info_key)
        return info

    def _raw_point_counts(self, out, batch, spec: RawSpec) -> Dict[str, np.ndarray]:
        """The reference's eval semantics: logits devoxelized to the raw
        cloud through the stored inverse maps, the spec's raw-cloud filter
        applied (keyframe points for multisweep teachers, FOV for the
        student pixel head), every raw point scored against its own label
        (``spformer_trainer.py:96-115``, ``nusc_trainers.py:368-390``)."""
        sub = batch if spec.info_key is None else batch[spec.info_key]
        logits = E.host_array(out[spec.logits_key])
        pmasks = E.host_array(sub["pmask"])
        total = {k: np.zeros(self.num_classes, np.int64) for k in ("seen", "correct", "positive")}
        for i in range(len(batch["infos"])):
            info = self._spec_info(batch, spec, i)
            raw_logits = E.devoxelize_predictions(logits[i], pmasks[i], info)
            pred = np.argmax(raw_logits, axis=-1)
            labels = info["labels_full"]
            keep = labels != self.ignore_label
            if spec.filter_key is not None:
                filt = info.get(spec.filter_key)
                if filt is not None:
                    keep &= filt.astype(bool)
            total["seen"] += np.bincount(labels[keep], minlength=self.num_classes)
            total["positive"] += np.bincount(pred[keep], minlength=self.num_classes)
            agree = keep & (pred == labels)
            total["correct"] += np.bincount(labels[agree], minlength=self.num_classes)
        return total

    def evaluate(self) -> Dict[str, float]:
        keys = (self.eval_counts_key,) + self.extra_count_keys
        totals = {k: {n: np.zeros(self.num_classes, np.int64)
                      for n in ("seen", "correct", "positive")} for k in keys}
        infer_times = []
        raw_keys = set()
        for batch in self.val_loader():
            t0 = time.perf_counter()
            out = self.eval_step(batch)
            counts = {k: {n: v.cpu().numpy() for n, v in out[k].items()} for k in keys}
            infer_times.append(time.perf_counter() - t0)
            use_raw = (self.eval_raw_points and batch.get("infos")
                       and self._spec_info(batch, self.raw_specs[0], 0) is not None
                       and all(s.logits_key in out for s in self.raw_specs))
            if use_raw:
                for spec in self.raw_specs:
                    raw_keys.add(spec.counts_key)
                    counts[spec.counts_key] = self._raw_point_counts(out, batch, spec)
            for k in keys:
                totals[k] = {n: totals[k][n] + counts[k][n] for n in totals[k]}
        group = mesh.data_group()
        if raw_keys and group is not None:
            # each rank scored its own scans' raw points; the eval step
            # already summed the device counters
            device = next(self.model.parameters()).device
            for k in sorted(raw_keys):
                ts = {n: torch.as_tensor(v, device=device) for n, v in totals[k].items()}
                mesh.all_reduce_coalesced(ts.values(), group)
                totals[k] = {n: t.cpu().numpy() for n, t in ts.items()}
        if raw_keys:
            print(f"[val] scored on raw points: {', '.join(sorted(raw_keys))}")
        results = {}
        for k, counts in totals.items():
            miou, per_class = M.compute_miou(counts, self.ignore_label)
            results[k] = miou
            print(f"[val] {k}:")
            print(format_iou_table(per_class, miou, self.class_names))
        if len(infer_times) > 13:  # the reference's warm-up trim, InferTime [10:-3]
            results["infer_time_ms"] = float(np.mean(infer_times[10:-3]) * 1000)
        return results

    def train(self) -> None:
        for epoch in range(1, self.num_epochs + 1):
            t_epoch = time.time()
            n_steps = 0
            aux = {}
            for batch in self.train_loader():
                aux = self.train_step(batch)
                self.global_step += 1
                n_steps += 1
                if self.global_step % self.log_every == 0:
                    host_aux = {k: float(v) for k, v in aux.items()}
                    for k, v in host_aux.items():
                        self.summary.add_scalar(f"train/{k}", v, self.global_step)
                    overflow.check_aux(host_aux, self.strict_capacity)
            results = self.evaluate()
            for k, v in results.items():
                self.summary.add_scalar(f"val/{k}", v, self.global_step)
            miou = results[self.eval_counts_key]
            improved = False
            if self.is_master:
                state = self.state()
                self.ckpt.save_latest(state, epoch)
                improved = self.ckpt.save_best(state, miou)
            loss = f" loss={float(aux['loss']):.4f}" if "loss" in aux else ""
            print(f"epoch {epoch}/{self.num_epochs}: steps={n_steps}{loss} "
                  f"miou={miou * 100:.2f}{' (best)' if improved else ''} "
                  f"wall={time.time() - t_epoch:.1f}s", flush=True)
        self.summary.close()
