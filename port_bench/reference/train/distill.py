"""TSD distillation train and eval steps (port of
``u2mkd_tpu/train/distill.py``).

A train step runs the student in training mode and the frozen teacher in
eval mode without gradients, then the five-term loss (reference
``NuScenesLCTSDFullTrainer._run_step``)::

  loss = LovaszCE(x_vox) + LovaszCE(x_pix | FOV) + w_kl * KL(stu || teacher)
       + sum(per-stage learner MSE) + w_feat * MSE(adapted stage-4 feats)

The teacher's outputs come to student point order through ``t2s`` ([B, Ps]
teacher row of each student point, -1 where none), which the data pipeline
builds. The eval step scores the student's voxel and pixel heads, and
optionally the teacher on its own multisweep cloud.

With a ``process_group`` (data parallelism, ``parallel/mesh.py``) the train
step averages the student's gradients and the loss terms over the ranks in
one coalesced ``all_reduce`` and takes the max of the capacity counters (JAX
``distill.py:185-199``); the eval step sums ``counts_vox``, ``counts_pix``
and ``counts_teacher``. The split step takes no group, as in JAX.
``remat`` runs the student's segments checkpointed, as the teacher step
does (``train/state.py``); the frozen teacher runs without gradients
either way.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from port_bench.reference.models import plumbing
from port_bench.reference.models.tsd import TSDFull
from port_bench.reference.ops import losses
from port_bench.reference.parallel import mesh
from port_bench.reference.train import metrics, optim, overflow
from port_bench.reference.train.state import batch_reader, gradients

STUDENT_KEYS = {"feats": torch.float32, "images": torch.float32,
                "pix_coords": torch.float32, "cam_masks": torch.bool,
                "fov_mask": torch.bool}
LOSS_TERMS = ("loss", "ce_vox", "ce_pix", "kl", "feat", "mse")


def make_frozen_teacher_optimizer(model: TSDFull, name: str, lr, **kw):
    """The named optimizer (:func:`optim.make_optimizer`, ``kw`` passed on)
    over the student's parameters only, and the teacher's parameters set to
    need no gradient: the frozen teacher (reference
    ``model_t.requires_grad_(False)``; the JAX package masks its updates to
    zero). -> (optimizer, scheduler or None)."""
    model.model_t.requires_grad_(False)
    return optim.make_optimizer(model.model_s.named_parameters(), name, lr, **kw)


def _minmax(x: torch.Tensor) -> torch.Tensor:
    mx = x.max(-1, keepdim=True).values
    mn = x.min(-1, keepdim=True).values
    return (x - mn) / (mx - mn).clamp(min=1e-12)


def _distill_losses(stu: Dict, x_vox_t2s: torch.Tensor, feat_t2s: torch.Tensor,
                    labels: torch.Tensor, fov: torch.Tensor, label_valid: torch.Tensor,
                    t2s_valid: torch.Tensor, w_kl: float, w_feat: float,
                    mse_norm_feat: bool) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The five-term TSD loss from the student's outputs and the teacher's,
    already in student point order. -> (loss, {LOSS_TERMS: detached})."""
    def flat(x):
        return x.reshape(-1, x.shape[-1])

    fl = labels.reshape(-1)
    ce_vox = losses.lovasz_ce(flat(stu["x_vox"]), fl, label_valid.reshape(-1))
    ce_pix = losses.lovasz_ce(flat(stu["x_pix"]), fl, (label_valid & fov).reshape(-1))
    kl = losses.kl_div_batchmean(flat(stu["x_vox"]), flat(x_vox_t2s), t2s_valid.reshape(-1))
    feat_s = stu["pts_feats"]
    if mse_norm_feat:
        feat_s, feat_t2s = _minmax(feat_s), _minmax(feat_t2s)
    feat = losses.masked_mse(flat(feat_s), flat(feat_t2s), t2s_valid.reshape(-1))
    mse_sum = sum(stu["mse_loss"])
    loss = ce_vox + ce_pix + w_kl * kl + mse_sum + w_feat * feat
    terms = (loss, ce_vox, ce_pix, kl, feat, mse_sum)
    return loss, {k: v.detach() for k, v in zip(LOSS_TERMS, terms)}


def _gather_t2s(x: torch.Tensor, t2s: torch.Tensor) -> torch.Tensor:
    """Teacher rows x [B, Pt, C] -> [B, Ps, C] in student point order (rows
    without a teacher point read row 0; their mask drops them)."""
    return plumbing.batch_rows(x, t2s, negative_reads_row0=True)


def make_distill_train_step(model: TSDFull, optimizer: torch.optim.Optimizer,
                            s_caps: Sequence[int], t_caps: Sequence[int], w_kl: float = 1.0,
                            w_feat: float = 1.0, ignore_label: int = 0,
                            mse_norm_feat: bool = False,
                            scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
                            generator: Optional[torch.Generator] = None,
                            overflow_checks: bool = False, process_group=None,
                            remat: bool = False) -> Callable:
    """Returns ``step_fn(batch) -> aux`` for ``batch = {"student",
    "teacher", "t2s"}`` as ``data/synthetic.make_multimodal_batch`` gives it
    (numpy arrays or device tensors; a part without a ``plumbing`` entry is
    built on the device, ``state.batch_reader``). The teacher runs first, in eval mode without gradients; then the
    student in training mode (batch-statistic BN updating its running
    statistics; dropout and drop path drawn from ``generator``, a seeded one
    on the model's device by default), the loss, the backward,
    ``optimizer.step()`` (the optimizer holds the student's parameters only:
    :func:`make_frozen_teacher_optimizer`) and ``scheduler.step()``. ``aux``
    holds LOSS_TERMS as detached device tensors: the step does not wait for
    the device. ``overflow_checks`` adds the capacity counters of both
    parts' plumbing (``overflow.stats_for_model``), suffixed ``_s`` and
    ``_t``, and ``overflow/violations``, the sum of both parts'. It is
    :func:`make_distill_split_steps`'s step: in torch the fused step and the
    split one are the same computation. With ``process_group`` the
    gradients and LOSS_TERMS are the ranks' means, the counters their max
    (module docstring). ``remat`` recomputes the student's segments in the
    backward."""
    return _train_steps(model, optimizer, s_caps, t_caps, w_kl, w_feat, ignore_label,
                        mse_norm_feat, scheduler, generator, overflow_checks, process_group,
                        remat)


def make_distill_split_steps(model: TSDFull, optimizer: torch.optim.Optimizer,
                             s_caps: Sequence[int], t_caps: Sequence[int], w_kl: float = 1.0,
                             w_feat: float = 1.0, ignore_label: int = 0,
                             mse_norm_feat: bool = False,
                             scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
                             generator: Optional[torch.Generator] = None,
                             overflow_checks: bool = False, remat: bool = False) -> Callable:
    """The train step of :func:`make_distill_train_step` in two calls, as
    the JAX package's two programs: ``step.teacher_fn(batch)`` runs the
    frozen teacher and gathers its logits and stage-4 features to student
    order ({"x_vox_t2s", "feat_t2s"}, detached; with ``overflow_checks``
    also the teacher plumbing's counters); ``step.student_fn(batch, t_out)``
    runs the student's forward, the loss, the backward and the update.
    ``step(batch)`` is the two in turn; no gradient crosses between
    them. ``remat`` as :func:`make_distill_train_step`'s."""
    return _train_steps(model, optimizer, s_caps, t_caps, w_kl, w_feat, ignore_label,
                        mse_norm_feat, scheduler, generator, overflow_checks, None, remat)


def _train_steps(model: TSDFull, optimizer: torch.optim.Optimizer, s_caps: Sequence[int],
                 t_caps: Sequence[int], w_kl: float, w_feat: float, ignore_label: int,
                 mse_norm_feat: bool, scheduler, generator: Optional[torch.Generator],
                 overflow_checks: bool, process_group, remat: bool) -> Callable:
    device, student_plumbing, tensor_of = batch_reader(model.model_s, s_caps)
    _, teacher_plumbing, _ = batch_reader(model.model_t, t_caps)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def teacher_fn(batch: Dict) -> Dict[str, torch.Tensor]:
        tb = batch["teacher"]
        tpl = teacher_plumbing(tb)
        t_out = model.frozen_teacher({"feats": tensor_of(tb, "feats", torch.float32)}, tpl)
        t2s = tensor_of(batch, "t2s", torch.int64)
        out = {"x_vox_t2s": _gather_t2s(t_out["x_vox"], t2s),
               "feat_t2s": _gather_t2s(t_out["pts_feats"], t2s)}
        if overflow_checks:
            out["overflow"] = overflow.stats_for_model(model.model_t, tpl)
        return out

    def student_fn(batch: Dict, t_out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        sb = batch["student"]
        spl = student_plumbing(sb)
        s_in = {k: tensor_of(sb, k, dt) for k, dt in STUDENT_KEYS.items()}
        labels = tensor_of(sb, "labels", torch.int64)
        pmask = spl.pmask
        fov = s_in["fov_mask"] & pmask
        label_valid = pmask & (labels != ignore_label)
        t2s_valid = pmask & (tensor_of(batch, "t2s", torch.int64) >= 0)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        stu = model(s_in, spl, run_teacher=False, generator=generator, remat=remat)["stu"]
        loss, aux = _distill_losses(stu, t_out["x_vox_t2s"], t_out["feat_t2s"], labels, fov,
                                    label_valid, t2s_valid, w_kl, w_feat, mse_norm_feat)
        loss.backward()
        if process_group is not None:
            mesh.all_reduce_coalesced(gradients(model) + list(aux.values()), process_group,
                                      "mean")
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        if overflow_checks:
            # the two parts' counters apart, their violations summed (the
            # JAX step's keys)
            for tag, stats in (("s", overflow.stats_for_model(model.model_s, spl)),
                               ("t", t_out["overflow"])):
                if process_group is not None:
                    mesh.all_reduce_coalesced(stats.values(), process_group, "max")
                aux.update({f"{k}_{tag}": v for k, v in stats.items()})
            aux["overflow/violations"] = (aux.pop("overflow/violations_s")
                                          + aux.pop("overflow/violations_t"))
        return aux

    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        return student_fn(batch, teacher_fn(batch))

    step.teacher_fn = teacher_fn
    step.student_fn = student_fn
    return step


def make_distill_eval_step(model: TSDFull, s_caps: Sequence[int], t_caps: Sequence[int],
                           num_classes: int, ignore_label: int = 0,
                           run_teacher: bool = False, process_group=None) -> Callable:
    """Returns ``eval_fn(batch)`` for ``batch = {"student": ..., "teacher":
    ...}`` as ``data/synthetic.make_multimodal_batch`` gives it (numpy
    arrays; a part without a ``plumbing`` entry is built on the device) ->
    {"pred_vox", "pred_pix", "counts_vox", "counts_pix", "logits",
    "logits_pix"} and, with ``run_teacher``, "counts_teacher" and the
    teacher's "logits_teacher" (a key the JAX step does not return). The pixel
    head is scored on the points in a camera's field of view only; the
    teacher on its valid keyframe points. The student's plumbing carries the
    point maps of every level and, from the host, the window geometry of
    ``wgeom_host.params_from_model(model.model_s)``; the teacher's those of
    ``model.model_t``. With ``process_group`` the counters are summed over
    its ranks; the per-point outputs stay the rank's own."""
    _, student_plumbing, tensor_of = batch_reader(model.model_s, s_caps)
    _, teacher_plumbing, _ = batch_reader(model.model_t, t_caps)

    def eval_fn(batch: Dict) -> Dict:
        sb, tb = batch["student"], batch.get("teacher")
        spl = student_plumbing(sb)
        tpl = teacher_plumbing(tb) if run_teacher else None
        s_in = {k: tensor_of(sb, k, dt) for k, dt in STUDENT_KEYS.items()}
        t_in = {"feats": tensor_of(tb, "feats", torch.float32)} if run_teacher else None
        model.eval()
        with torch.no_grad():
            out = model(s_in, spl, t_in, tpl, run_teacher)
        stu = out["stu"]
        pred_vox = torch.argmax(stu["x_vox"], dim=-1)
        pred_pix = torch.argmax(stu["x_pix"], dim=-1)
        labels = tensor_of(sb, "labels", torch.int64).reshape(-1)
        valid = spl.pmask
        fov = valid & s_in["fov_mask"]
        res = {"pred_vox": pred_vox, "pred_pix": pred_pix,
               "counts_vox": metrics.iou_counts(pred_vox.reshape(-1), labels,
                                                valid.reshape(-1), num_classes, ignore_label),
               "counts_pix": metrics.iou_counts(pred_pix.reshape(-1), labels,
                                                fov.reshape(-1), num_classes, ignore_label),
               "logits": stu["x_vox"], "logits_pix": stu["x_pix"]}
        if run_teacher:
            pred_t = torch.argmax(out["t"]["x_vox"], dim=-1)
            t_valid = tpl.pmask & tensor_of(tb, "keyframe_mask", torch.bool)
            res["counts_teacher"] = metrics.iou_counts(
                pred_t.reshape(-1), tensor_of(tb, "labels", torch.int64).reshape(-1),
                t_valid.reshape(-1), num_classes, ignore_label)
            res["logits_teacher"] = out["t"]["x_vox"]
        if process_group is not None:
            mesh.all_reduce_coalesced(
                [v for k in ("counts_vox", "counts_pix", "counts_teacher") if k in res
                 for v in res[k].values()], process_group)
        return res

    return eval_fn
