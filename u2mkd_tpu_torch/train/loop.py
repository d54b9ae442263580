"""Epoch training loop with validation, metric logging and checkpoints (port
of ``u2mkd_tpu/train/loop.py``).

Replaces torchpack's ``Trainer.train_with_defaults`` with its ``MeanIoU``,
``Saver`` and ``MaxSaver`` callbacks (reference ``train_spformer.py:97-115``):
one Python loop over the port's train and eval steps on one device, a JSONL
metric log (and TensorBoard's, where installed), per-class IoU tables, and
the mean eval time with the reference's warm-up trim (``InferTime``).

Not ported here: the raw-point scoring of the JAX loop (``RawSpec``), which
reads the devoxelize information the real datasets attach to a batch, waits
for those datasets (ROADMAP section 1, item 3): the synthetic batches carry
none, and the JAX loop scores them on their padded points as this one does.
Data parallelism is ROADMAP section 1, item 6.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from u2mkd_tpu_torch.train import metrics as M
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


class Trainer:
    """Epoch loop over the port's train and eval steps.

    ``train_loader()`` / ``val_loader()`` return a fresh iterable of batches
    each epoch. ``eval_counts_key`` names the counter dict of the eval
    step's output whose mIoU picks the best checkpoint (``counts_vox`` for
    the stage-2 student); ``extra_count_keys`` are scored and logged too.
    A checkpoint holds the model, ``optimizer``, ``scheduler`` and the
    step's ``generator`` (:func:`checkpoints.training_state`); a resumed run
    passes its step as ``start_step``."""

    def __init__(self, run_dir: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 scheduler, generator: Optional[torch.Generator], train_step: Callable,
                 eval_step: Callable, train_loader: Callable[[], Iterable],
                 val_loader: Callable[[], Iterable], num_epochs: int, num_classes: int,
                 ignore_label: int = 0, class_names: Optional[List[str]] = None,
                 eval_counts_key: str = "counts", extra_count_keys: Iterable[str] = (),
                 epoch_to_save: int = 0, log_every: int = 10, start_step: int = 0):
        self.run_dir = os.path.abspath(run_dir)
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
        self.summary = SummaryWriter(self.run_dir)
        self.ckpt = CheckpointManager(self.run_dir, epoch_to_save=epoch_to_save)
        self.log_every = log_every
        self.global_step = start_step

    def state(self) -> Dict:
        return training_state(self.model, self.optimizer, self.scheduler, self.generator,
                              self.global_step)

    def evaluate(self) -> Dict[str, float]:
        keys = (self.eval_counts_key,) + self.extra_count_keys
        totals = {k: {n: np.zeros(self.num_classes, np.int64)
                      for n in ("seen", "correct", "positive")} for k in keys}
        infer_times = []
        for batch in self.val_loader():
            t0 = time.perf_counter()
            out = self.eval_step(batch)
            counts = {k: {n: v.cpu().numpy() for n, v in out[k].items()} for k in keys}
            infer_times.append(time.perf_counter() - t0)
            for k in keys:
                totals[k] = {n: totals[k][n] + counts[k][n] for n in totals[k]}
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
                    for k, v in aux.items():
                        self.summary.add_scalar(f"train/{k}", float(v), self.global_step)
            results = self.evaluate()
            for k, v in results.items():
                self.summary.add_scalar(f"val/{k}", v, self.global_step)
            miou = results[self.eval_counts_key]
            state = self.state()
            self.ckpt.save_latest(state, epoch)
            improved = self.ckpt.save_best(state, miou)
            loss = f" loss={float(aux['loss']):.4f}" if "loss" in aux else ""
            print(f"epoch {epoch}/{self.num_epochs}: steps={n_steps}{loss} "
                  f"miou={miou * 100:.2f}{' (best)' if improved else ''} "
                  f"wall={time.time() - t_epoch:.1f}s", flush=True)
        self.summary.close()
