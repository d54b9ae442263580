"""Where a train step spends its time, part by part (port of the JAX
package's ``bench_parts.py``).

Teacher mode, B=2 synthetic scans at ``--points`` (capacities P, P/2 ...
P/16, voxel 0.1 m, 17 classes), on host plumbing with window geometry:

  (a) ``host_plumbing_ms``: the host build (``data/plumbing_host``), by the
      host clock;
  (b) ``conv_unet_step_ms``: the conv-only SPVCNN's train step (``sgd``, lr
      0.02, ``train/state.make_train_step``);
  (c) ``teacher_step_ms``: the SphereFormer teacher's train step
      (``sgd_spformer``, lr 0.02, kernel K3 on both branches);
      ``attention_share_ms`` is (c) - (b);
  (d) ``kernel_budget``: per level and branch, the forward and backward of
      ``ops/kernels/wattn_kernel.flash_pregeom_batched`` (K3, K4, K5 on the
      card) on the batch's own geometry of that level, with random q, k, v
      and one table tensor for all three tables, gradients into all four;
      ``kernel_sum_ms`` their sum. ``flash_gflops_per_step`` is the JAX
      kernels' executed count (``utils/flops.flash_attention_flops``).

Student mode (``--student``), B=1 at ``--points`` student points and twice
as many teacher points, 3 cameras at 360x640, ``TSDFull`` (cr 1.0, cr_t
2.0, windows 0.6 m in 24 steps):

  (a) ``full_distill_step_ms``: ``train/distill.make_distill_train_step``
      over ``sgd_spformer`` at lr 0.02, the teacher frozen;
  (b) ``student_fwd_bwd_ms``: the student alone (``run_teacher=False``),
      the gradient of Lovasz + CE plus the learners' MSE;
  (c) ``teacher_fwd_ms``: the frozen teacher's forward;
  (d) ``student_lidar_only_fwd_bwd_ms``: the camera-free student
      (``TSDFull.lidar_only``) under autograd, Lovasz + CE;
  ``image_fusion_cost_ms`` is (b) - (d), ``kd_glue_cost_ms`` (a) - (b) - (c).

Every device field is one warm call, then ``--iters`` calls (10), each
timed on its own: with CUDA events after a ``synchronize()`` on the card,
by the host clock on the CPU. A field holds their mean, with ``_min`` and
``_max`` beside it; the host build is timed HOST_BUILDS times. The
training calls run in training mode, so the BN running statistics move
from call to call, as in any run of steps. On the card the compute policy
is bf16 (``ops/precision``), as the JAX tool's; with ``--cpu`` f32. The
policy is restored when the split returns.

Usage: ``python -m u2mkd_tpu_torch.bench_parts [--student] [--points=N]
[--iters=N] [--cpu]``. Prints one JSON line: the JAX tool's keys, the
device (``platform`` ``gpu`` or ``cpu``; on the card its name and the
``nvidia-smi`` name and power limit) and the numerics line. Writes no file.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from u2mkd_tpu_torch.core.device import resolve_device
from u2mkd_tpu_torch.core.structures import WindowGeom
from u2mkd_tpu_torch.data import loaders, plumbing_host, synthetic, wgeom_host
from u2mkd_tpu_torch.models import plumbing as P
from u2mkd_tpu_torch.models.spvcnn import SPVCNN, teacher_model
from u2mkd_tpu_torch.models.tsd import TSDFull
from u2mkd_tpu_torch.ops import losses, precision
from u2mkd_tpu_torch.ops.kernels import wattn_kernel
from u2mkd_tpu_torch.train import distill, optim, state
from u2mkd_tpu_torch.utils import flops

NUM_CLASSES = 17
VOXEL = 0.1
LR = 0.02
TEACHER_BATCH = 2
STUDENT_BATCH = 1
NUM_CAMS = 3
IM_HW = (360, 640)
STUDENT_WINDOW = 0.6
ITERS = 10
HOST_BUILDS = 3


def device_record(device: torch.device) -> Dict:
    """Where the numbers were taken: ``{"platform": "cpu"}``, or on the card
    ``{"platform": "gpu", "kind": its torch name, "nvidia_smi": its name and
    power limit}`` (None where ``nvidia-smi`` is missing)."""
    if device.type != "cuda":
        return {"platform": "cpu"}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip().splitlines()
        smi = smi[device.index or 0]
    except (OSError, subprocess.CalledProcessError):
        smi = None
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "nvidia_smi": smi}


def timed_calls(fn: Callable, device: torch.device, iters: int) -> List[float]:
    """``fn()`` once to warm, then ``iters`` calls -> each call's ms: CUDA
    events after a ``synchronize()`` on the card, the host clock on the
    CPU."""
    fn()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def put_times(res: Dict, key: str, times: List[float]) -> float:
    """``res[key]`` the mean of ``times``, ``key_min`` and ``key_max``
    beside it (``key`` ends in ``_ms``) -> the mean."""
    mean = float(np.mean(times))
    res[key] = mean
    res[f"{key}_min"], res[f"{key}_max"] = float(min(times)), float(max(times))
    return mean


class BudgetCase(NamedTuple):
    """One level and branch of the attention budget: q, k, v [B, V, h, d]
    and the table tensor ``tq`` [L2, 3, h, d] (leaves that want gradients),
    the level's valid rows and geometry."""
    name: str
    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    tq: torch.Tensor
    valid: torch.Tensor
    geom: WindowGeom
    grid_len: int
    a: float


def budget_cases(model: SPVCNN, plumbing: P.UNetPlumbing, caps, batch: int,
                 seed: int = 0) -> List[BudgetCase]:
    """The attention budget's cases: for each encoder level 1-4 and branch
    (``utils/flops.level_attn_specs``), q, k, v and ``tq`` from a standard
    normal (a CPU generator of ``seed``, moved to the plumbing's device), on
    the plumbing's valid rows and window geometry of that level."""
    gen = torch.Generator().manual_seed(seed)
    dev = plumbing.pmask.device
    cases = []
    for li, (h1, h2, d, g_cub, g_sph) in enumerate(flops.level_attn_specs(model)):
        vcap = caps[li + 1]
        geoms = P.level_geom(plumbing, li + 1)
        sphere_a = float(getattr(model, f"sphereformer{li + 1}").attn.a)
        for branch, hh, g, radial, a in (("cubic", h1, g_cub, False, 0.0),
                                         ("sphere", h2, g_sph, True, sphere_a)):
            l2 = 2 * g if radial else 2 * g - 1
            q, k, v = (torch.randn(batch, vcap, hh, d, generator=gen).to(dev).requires_grad_()
                       for _ in range(3))
            tq = torch.randn(l2, 3, hh, d, generator=gen).to(dev).requires_grad_()
            cases.append(BudgetCase(f"L{li + 1}_{branch}", q, k, v, tq,
                                    plumbing.levels[li + 1].grid.mask, geoms[branch], g, a))
    return cases


def budget_fwd_bwd(case: BudgetCase):
    """One budget call: the attention on ``case`` with ``tq`` as all three
    tables, and the gradients of sum(out^2) for q, k, v and ``tq`` (the
    three tables' gradients summed) -> (out, (dq, dk, dv, dtq))."""
    out = wattn_kernel.flash_pregeom_batched(case.q, case.k, case.v, case.valid, case.geom,
                                             case.tq, case.tq, case.tq, case.grid_len, case.a)
    grads = torch.autograd.grad((out * out).sum(), (case.q, case.k, case.v, case.tq))
    return out, grads


def teacher_split(num_points: int, device: torch.device, iters: int = ITERS,
                  hold: Optional[Callable] = None) -> Dict:
    """The teacher mode's fields (module docstring). ``hold``, a context
    manager factory, runs each budget case once inside it before anything is
    timed (a check of the launches on these shapes)."""
    caps = tuple(num_points >> i for i in range(5))
    raw = synthetic.make_batch(np.random.RandomState(0), TEACHER_BATCH, num_points,
                               voxel_size=VOXEL)
    model = teacher_model(num_classes=NUM_CLASSES, cr=1.0, voxel_size=VOXEL, seed=0,
                          device=device, pallas_attention=True, pallas_cubic=True)
    wp = wgeom_host.params_from_model(model)
    res: Dict = {}
    builds = []
    for _ in range(HOST_BUILDS):
        t0 = time.perf_counter()
        pl = plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"], caps,
                                          wgeom_params=wp)
        builds.append((time.perf_counter() - t0) * 1e3)
    put_times(res, "host_plumbing_ms", builds)
    batch = loaders.to_device(dict(raw, plumbing=pl), device)

    cases = budget_cases(model, state.batch_reader(model, caps)[1](batch), caps,
                         TEACHER_BATCH)
    if hold is not None:
        with hold():
            for case in cases:
                budget_fwd_bwd(case)

    conv = SPVCNN(num_classes=NUM_CLASSES, cr=1.0, sphereformer=False,
                  generator=torch.Generator().manual_seed(0)).to(device)
    for name, net, opt_name in (("conv_unet_step_ms", conv, "sgd"),
                                ("teacher_step_ms", model, "sgd_spformer")):
        opt, _ = optim.make_optimizer(net.named_parameters(), opt_name, LR)
        step = state.make_train_step(net, opt, caps,
                                     generator=torch.Generator(device=device).manual_seed(1))
        put_times(res, name, timed_calls(lambda: step(batch), device, iters))
    del conv
    res["attention_share_ms"] = res["teacher_step_ms"] - res["conv_unet_step_ms"]

    budget: Dict = {}
    kernel_sum = 0.0
    for case in cases:
        kernel_sum += put_times(budget, f"{case.name}_ms",
                                timed_calls(lambda: budget_fwd_bwd(case), device, iters))
    res["kernel_budget"] = budget
    res["kernel_sum_ms"] = kernel_sum
    res["flash_gflops_per_step"] = flops.flash_attention_flops(model, pl, train=True) / 1e9
    res["platform"] = "gpu" if device.type == "cuda" else "cpu"
    res["num_points"] = num_points
    return res


def student_model(device: torch.device, seed: int = 0) -> TSDFull:
    """The student mode's ``TSDFull``: cr 1.0, the cr_t 2.0 teacher, windows
    of STUDENT_WINDOW quantized in 24 steps, K3 on both branches; random
    weights from ``seed`` on ``device``."""
    ws = STUDENT_WINDOW
    return TSDFull(num_classes=NUM_CLASSES, cr=1.0, cr_t=2.0, window_size=(ws,) * 3,
                   quant_size=(ws / 24,) * 3, pallas_attention=True,
                   generator=torch.Generator().manual_seed(seed)).to(device)


def student_batch(model: TSDFull, s_points: int, s_caps, t_caps, seed: int = 0) -> Dict:
    """A multimodal host batch at B=1 (twice the student's points for the
    teacher, NUM_CAMS cameras at IM_HW), each part with its host plumbing
    and its model's window geometry."""
    raw = synthetic.make_multimodal_batch(np.random.RandomState(seed), STUDENT_BATCH,
                                          s_points, 2 * s_points, voxel_size=VOXEL,
                                          num_cams=NUM_CAMS, im_hw=IM_HW)
    for key, caps, sub in (("student", s_caps, model.model_s), ("teacher", t_caps, model.model_t)):
        part = raw[key]
        part["plumbing"] = plumbing_host.batch_plumbing(
            part["pcoords"], part["xyz"], part["pmask"], caps,
            wgeom_params=wgeom_host.params_from_model(sub))
    return raw


def student_inputs(model: TSDFull, batch: Dict, s_caps, t_caps) -> Dict:
    """What (b)-(d) read, assembled once on the model's device: the
    student's inputs, both parts' plumbing, the flat labels and the rows
    the loss counts (valid and not label 0)."""
    _, s_plumbing, tensor_of = state.batch_reader(model.model_s, s_caps)
    _, t_plumbing, _ = state.batch_reader(model.model_t, t_caps)
    sb, tb = batch["student"], batch["teacher"]
    labels = tensor_of(sb, "labels", torch.int64).reshape(-1)
    return {"s_in": {k: tensor_of(sb, k, dt) for k, dt in distill.STUDENT_KEYS.items()},
            "spl": s_plumbing(sb), "tpl": t_plumbing(tb),
            "t_feats": tensor_of(tb, "feats", torch.float32), "labels": labels,
            "valid": tensor_of(sb, "pmask", torch.bool).reshape(-1) & (labels != 0)}


def student_loss_grads(model: TSDFull, inputs: Dict, generator: torch.Generator,
                       lidar_only: bool = False):
    """(b), or with ``lidar_only`` (d): the student in training mode, its
    dropout and drop path drawn from ``generator``; the loss Lovasz + CE of
    its voxel logits (plus the learners' MSE on the camera path) and its
    gradient for every student parameter -> (loss, {name: gradient, None
    where the loss does not reach it})."""
    model.train()
    if lidar_only:
        out = model.lidar_only({"feats": inputs["s_in"]["feats"]}, inputs["spl"],
                               generator=generator)
    else:
        out = model(inputs["s_in"], inputs["spl"], run_teacher=False,
                    generator=generator)["stu"]
    x = out["x_vox"]
    loss = losses.lovasz_ce(x.reshape(-1, x.shape[-1]), inputs["labels"], inputs["valid"])
    if not lidar_only:
        loss = loss + sum(out["mse_loss"])
    names, params = zip(*model.model_s.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), dict(zip(names, grads))


def teacher_forward(model: TSDFull, inputs: Dict) -> torch.Tensor:
    """(c): the frozen teacher's voxel logits (eval mode, no gradients)."""
    return model.frozen_teacher({"feats": inputs["t_feats"]}, inputs["tpl"])["x_vox"]


def student_split(s_points: int, device: torch.device, iters: int = ITERS) -> Dict:
    """The student mode's fields (module docstring)."""
    s_caps = tuple(s_points >> i for i in range(5))
    t_caps = tuple((2 * s_points) >> i for i in range(5))
    model = student_model(device)
    batch = loaders.to_device(student_batch(model, s_points, s_caps, t_caps), device)
    opt, _ = distill.make_frozen_teacher_optimizer(model, "sgd_spformer", LR)
    res: Dict = {}
    step = distill.make_distill_train_step(
        model, opt, s_caps, t_caps, generator=torch.Generator(device=device).manual_seed(1))
    put_times(res, "full_distill_step_ms", timed_calls(lambda: step(batch), device, iters))
    inputs = student_inputs(model, batch, s_caps, t_caps)
    gen = torch.Generator(device=device).manual_seed(2)
    put_times(res, "student_fwd_bwd_ms",
              timed_calls(lambda: student_loss_grads(model, inputs, gen), device, iters))
    put_times(res, "teacher_fwd_ms",
              timed_calls(lambda: teacher_forward(model, inputs), device, iters))
    gen = torch.Generator(device=device).manual_seed(2)
    put_times(res, "student_lidar_only_fwd_bwd_ms",
              timed_calls(lambda: student_loss_grads(model, inputs, gen, lidar_only=True),
                          device, iters))
    res["image_fusion_cost_ms"] = (res["student_fwd_bwd_ms"]
                                   - res["student_lidar_only_fwd_bwd_ms"])
    res["kd_glue_cost_ms"] = (res["full_distill_step_ms"] - res["student_fwd_bwd_ms"]
                              - res["teacher_fwd_ms"])
    res["platform"] = "gpu" if device.type == "cuda" else "cpu"
    res["s_points"], res["t_points"], res["batch"] = s_points, 2 * s_points, STUDENT_BATCH
    return res


def split(student: bool = False, points: Optional[int] = None, device=None,
          iters: int = ITERS, hold: Optional[Callable] = None) -> Dict:
    """One mode's fields on ``device`` (the card unless asked otherwise),
    under the JAX tools' compute policy (bf16 on the card, f32 on the CPU),
    the caller's policy again afterwards; with the numerics line (read under
    the split's policy) and the device record. ``points`` defaults to the
    JAX tool's 4096."""
    dev = resolve_device(device)
    points = 4096 if points is None else points
    before = precision.compute_dtype()
    precision.set_compute_dtype("bfloat16" if dev.type == "cuda" else "float32")
    try:
        if student:
            res = student_split(points, dev, iters)
        else:
            res = teacher_split(points, dev, iters, hold)
        res["numerics"] = precision.numerics_line()
    finally:
        precision.set_compute_dtype(before)
    res["device"] = device_record(dev)
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--student", action="store_true",
                        help="the stage-2 distillation step's split")
    parser.add_argument("--points", type=int, default=4096,
                        help="points a scan (the student's in student mode)")
    parser.add_argument("--iters", type=int, default=ITERS, help="timed calls a field")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args(argv)
    res = split(args.student, args.points, "cpu" if args.cpu else None, args.iters)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
