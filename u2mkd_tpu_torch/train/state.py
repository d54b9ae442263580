"""The teacher's train and eval steps (port of ``make_train_step`` and
``make_eval_step`` of ``u2mkd_tpu/train/state.py``): one training step or one
inference request from a batch, with its host plumbing or with plumbing
built on the device (the JAX package's ``get_plumbing``).

With a ``process_group`` (data parallelism, ``parallel/mesh.py``) each rank
runs the step on its own shard, with a model built on the same group (its
BN statistics synced): after the backward the gradients and the loss are
averaged over the ranks in one coalesced ``all_reduce``, as JAX's
``pmean`` (``state.py:127-145``), the capacity counters take their max, and
the eval step's counters are summed.

``remat`` (JAX's ``jax.checkpoint`` around the forward) runs the model's
segments under ``torch.utils.checkpoint`` (``models/blocks.Remat``): the
same loss, gradients, update, BN running statistics and dropout masks, with
fewer activations kept between the forward and the backward, for more
device time.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from u2mkd_tpu_torch.models import plumbing as P
from u2mkd_tpu_torch.ops import losses
from u2mkd_tpu_torch.parallel import mesh
from u2mkd_tpu_torch.train import metrics, overflow


def batch_reader(model: torch.nn.Module, capacities: Sequence[int]):
    """-> (device, plumbing_of(batch), tensor_of(batch, key, dtype)).

    ``batch`` holds numpy arrays (``feats``, ``pmask``, ``keyframe_mask``,
    ``labels``, and ``pcoords``/``xyz``) as ``data/synthetic.make_batch``
    gives them, or tensors, as the loaders upload them
    (``data/loaders.to_device``): a tensor already on ``model``'s device in
    the dtype asked for is used as it is, with no second copy.
    ``plumbing_of`` follows the JAX package's ``get_plumbing``: a batch
    with a ``plumbing`` entry (``plumbing_host.batch_plumbing``, with the
    model's window geometry where it runs kernel K3) is assembled from it
    (``models/plumbing.from_precomputed``); a batch without one is built on
    ``model``'s device from its ``pcoords``, ``xyz`` and ``pmask``
    (``models/plumbing.build_plumbing``), with no window geometry, so the
    attention sorts its windows in the step. Either way the point maps are
    those of the model's ``point_levels``."""
    device = next(model.parameters()).device

    def plumbing_of(batch: Dict) -> P.UNetPlumbing:
        arrays = batch.get("plumbing")
        if arrays is None:
            return P.build_plumbing(tensor_of(batch, "pcoords", torch.float32),
                                    tensor_of(batch, "xyz", torch.float32),
                                    tensor_of(batch, "pmask", torch.bool), capacities,
                                    model.point_levels)
        return P.from_precomputed(arrays, batch["pmask"], device, model.point_levels,
                                  vox_xyz=P.reads_vox_xyz(model, "wgeom" in arrays))

    def tensor_of(batch: Dict, key: str, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(batch[key]).to(device=device, dtype=dtype)

    return device, plumbing_of, tensor_of


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    capacities: Sequence[int], ignore_label: int = 0,
                    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
                    generator: Optional[torch.Generator] = None,
                    overflow_checks: bool = False, process_group=None,
                    remat: bool = False) -> Callable:
    """Returns ``step_fn(batch) -> {"loss"}``: Lovász + CE on the points
    that are valid, in a keyframe and not ``ignore_label``; the forward in
    train mode (batch-stat BN, whose running stats update in place as flax's
    mutable ``batch_stats`` do; dropout and drop path drawn from
    ``generator``, a seeded one on the model's device by default); then the
    backward, ``optimizer.step()`` and ``scheduler.step()``. The loss comes
    back as a device tensor, so the step does not wait for the device.
    ``overflow_checks`` adds the batch's capacity counters
    (``overflow.stats_for_model``), device tensors too. With
    ``process_group`` the loss and gradients are the ranks' means and the
    counters their max (module docstring). ``remat`` recomputes the
    forward's segments in the backward (module docstring); a model without
    segments raises."""
    device, plumbing_of, tensor_of = batch_reader(model, capacities)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def step_fn(batch: Dict) -> Dict:
        pl = plumbing_of(batch)
        labels = tensor_of(batch, "labels", torch.int64)
        valid = pl.pmask & tensor_of(batch, "keyframe_mask", torch.bool) & (labels != ignore_label)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = model(tensor_of(batch, "feats", torch.float32), pl, generator,
                       remat=remat)["x_vox"]
        loss = losses.lovasz_ce(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                                valid.reshape(-1))
        loss.backward()
        aux = {"loss": loss.detach()}
        if process_group is not None:
            mesh.all_reduce_coalesced(gradients(model) + [aux["loss"]], process_group, "mean")
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        if overflow_checks:
            stats = overflow.stats_for_model(model, pl)
            if process_group is not None:
                mesh.all_reduce_coalesced(stats.values(), process_group, "max")
            aux.update(stats)
        return aux

    return step_fn


def gradients(model: torch.nn.Module) -> List[torch.Tensor]:
    """The gradients the backward gave ``model``'s parameters, in their
    order (a frozen or unused parameter has none)."""
    return [p.grad for p in model.parameters() if p.grad is not None]


def make_eval_step(model: torch.nn.Module, capacities: Sequence[int],
                   num_classes: int, ignore_label: int = 0, process_group=None) -> Callable:
    """Returns ``eval_fn(batch) -> {"pred", "counts", "logits"}`` (argmax
    predictions, IoU counters and logits). Everything runs on the model's
    device. With ``process_group`` the counters are summed over its ranks;
    ``pred`` and ``logits`` stay the rank's own."""
    _, plumbing_of, tensor_of = batch_reader(model, capacities)

    def eval_fn(batch: Dict) -> Dict:
        pl = plumbing_of(batch)
        model.eval()
        with torch.no_grad():
            logits = model(tensor_of(batch, "feats", torch.float32), pl)["x_vox"]
        pred = torch.argmax(logits, dim=-1)
        valid = pl.pmask & tensor_of(batch, "keyframe_mask", torch.bool)
        counts = metrics.iou_counts(pred.reshape(-1),
                                    tensor_of(batch, "labels", torch.int64).reshape(-1),
                                    valid.reshape(-1), num_classes, ignore_label)
        if process_group is not None:
            mesh.all_reduce_coalesced(counts.values(), process_group)
        return {"pred": pred, "counts": counts, "logits": logits}

    return eval_fn
