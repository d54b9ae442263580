#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``u2mkd_tpu_torch``) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and the CUDA toolkit (``nvcc``); it builds the kernels
from ``u2mkd_tpu_torch/csrc/`` on first use. Phases, one JSON line each:

  1. env: the card (``nvidia-smi``), torch and CUDA versions, kernel build time;
  2. kernels: each kernel (K1 forward and as the input gradient, K1b, K3,
     K4, K5) against its plain PyTorch version on the card, f32 and bf16, on
     a small random case and at the main path's real shapes, with errors,
     tolerances and CUDA-event times (and, at the real shapes, the bound:
     the least time the card could take for the same work; for K1 and K1b
     also the rulebook plan's build ms, the slots multiplied per valid pair
     with and without it, and a dense f32 GEMM of the same operations; for
     K2-K5 the window occupancy, the lane steps per pair of a walk over
     each tile's key range and of one over each row's own window
     (``wattn_kernel.walk_counts``), and the kernel's shared bytes per block
     and resident blocks and warps per SM);
  3. main path: three teacher inference requests (SPVCNN + SphereFormer,
     cr=1.0, P=131072, B=1) through ``train.state.make_eval_step``, counting
     kernel launches;
  4. profile: three more requests under ``torch.profiler``, device time by
     kernel (and of the ``conv_plan`` range, the rulebook plans' build),
     and the device's busy share against the unprofiled requests'
     CUDA-event time, so that no cost of the profiler counts as idle time;
  5. plain check: one request through the plain versions on the card, its
     logits and predictions against the kernel request's;
  6. train: three teacher train steps (cr=1.0, P=131072, B=1, dropout and
     drop path at their config rates from a seeded device generator,
     ``sgd_spformer`` at lr 0.02) through ``train.state.make_train_step``,
     with host ms, device ms, loss and launches per step and the peak
     device memory; then two more steps under ``torch.profiler``, device
     time by kernel;
  7. grad check: every kernel launch of one train step against its plain
     version on the same arguments; and one step through the kernels and
     one through the plain versions from one copy of the weights and one
     generator seed: the loss and every parameter's gradient;
  8. window entry: K2's own entry point, ``sparse_window_attention_flash``
     (no model path reaches K2), at the level-1 shape of a teacher request
     (N=65536, h=4, d=16) on its cubic and its sphere windows, counting K2's
     launches; its kernel rows (small, and both main-path shapes, f32 and
     bf16, with the jagged ``scaled_dot_product_attention`` as the library
     yardstick and the compiled ``flex_attention`` with a document mask as
     a second one) are in phase 2;
  9. student: three stage-2 student inference requests (``TSDFull`` cr=1.0,
     cr_t=2.0; P=65536, capacities (65536 ... 4096), 6 cameras at 360x640,
     B=1) through ``train.distill.make_distill_eval_step`` without the
     teacher, counting K1 and K3 launches; three more under
     ``torch.profiler``; one through the plain versions on the card (the
     voxel and pixel heads' logits and argmax agreement); and one request
     with the teacher (cr_t=2.0 on its own 131072-point cloud), then again
     with every K1 and K3 launch held to its plain version on the same
     arguments, and again through the plain versions (both models' logits).

Then a ``{"kernels": [...]}`` line, the card's name and power limit, and as
the last line ``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero without that line. Long outputs (the compiler's register counts,
the profiler's table) go to ``chiprun_out/``.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

P = 131072
CAPS = (P, P // 2, P // 4, P // 8, P // 16)
NUM_CLASSES = 17
VOXEL = 0.1
SEEDS = (11, 12, 13)
PROFILED_REQUESTS = 3
# device kernels named apart in the profile; everything else by its own name
PROFILE_GROUPS = {"rulebook_conv_kernel": "K1 rulebook_conv",
                  "rulebook_conv_dw_kernel": "K1b rulebook_conv_dw",
                  "sum_splits_kernel": "K1b sum_splits",
                  "wattn_fwd_kernel": "K2 wattn_fwd",
                  "wattn_rpe_fwd_kernel": "K3 wattn_rpe_fwd",
                  "wattn_rpe_bwd_q_kernel": "K4 wattn_rpe_bwd_q",
                  "wattn_rpe_bwd_k_kernel": "K5 wattn_rpe_bwd_k"}
# ranges named in the port (torch.profiler.record_function), shown beside
# the kernel groups with the device ms of the kernels they launched, which
# the groups also count
PROFILE_ANNOTATIONS = {"conv_plan": "conv_plan (K1/K1b plans, range)"}
TRAIN_SEEDS = (21, 22, 23)
PROFILED_STEPS = 2
LR = 0.02
# launches per train step: 34 ks=3 convs forward, 33 input gradients (the
# stem's first conv takes the point features, which need none), 34 weight
# gradients; 8 attention branches (4 levels x 2) forward, and K4 and K5 once
# each per branch in the backward
TRAIN_LAUNCHES = {"rulebook_conv": 34, "rulebook_conv_dx": 33, "rulebook_conv_dw": 34,
                  "flash_rpe_fwd": 8, "flash_rpe_bwd_q": 8, "flash_rpe_bwd_k": 8}
# Kernel step against plain step on the card, whole-step gradients. They
# move with rounding: a ReLU that flips when an activation moves by one f32
# ulp moves a weight gradient (a sum over ~10^5 voxels of terms of either
# sign) by about one term, ~1/sqrt(V) of it. So the run measures that
# spread itself: one more plain step from the weights times (1 + 2^-23
# N(0, 1)), about one ulp, and the kernel step may differ from the plain one
# by GRAD_SPREADS times that spread, or GRAD_RTOL, whichever is larger.
# Differences are per parameter, max |difference| over the parameter's
# largest gradient entry, the scale floored at GRAD_FLOOR of the model's
# largest entry (a bias before batch-stat BN has a true gradient of 0, and
# both sides give f32 noise there). The loss agrees to GRAD_LOSS_RTOL. The
# tight check is per launch: each kernel launch of the step against its
# plain version on the same arguments, to TOL.
GRAD_LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-3
GRAD_SPREADS = 4.0
GRAD_FLOOR = 1e-3
# the stage-2 student (configs/nuscenes/train/spformer_tsd_full_ours_star.yaml:
# num_points_student, student_capacities, voxels of 0.05 m, im_cr 0.4 of
# nuScenes' 900x1600 images, the validation protocol's 6 cameras); its
# teacher at cr_t=2.0 takes the teacher's P and CAPS
STUDENT_P = 65536
STUDENT_CAPS = (65536, 32768, 16384, 8192, 4096)
STUDENT_VOXEL = 0.05
NUM_CAMS = 6
IM_HW = (360, 640)
STUDENT_SEEDS = (41, 42, 43)
CR_T = 2.0
# launches per student request, read from models/msp2ifm.py as for the
# teacher: 34 ks=3 convs (stem 2, encoder 16, decoder 16; the stride-2 downs
# and 1x1 shortcuts are not K1) and 8 attention branches; the teacher adds
# its own 34 and 8
STUDENT_LAUNCHES = {"rulebook_conv": 34, "flash_rpe_fwd": 8}
WITH_TEACHER_LAUNCHES = {"rulebook_conv": 68, "flash_rpe_fwd": 16}
# K2's main-path shape: the teacher's level-1 voxels (N = 65536 capacity),
# h=4, d=16; the level's cubic windows (6 voxels of 0.1 m) and sphere
# windows on cart2sphere coordinates
WINDOW_CUBIC = (0.6, 0.6, 0.6)
WINDOW_SPHERE = (2.0, 2.0, 120.0)
WINDOW_HEADS = 4
F32_PEAK = 67e12      # H100 SXM f32 FLOP/s outside the tensor cores
# K1 and K1b compute f32 in 3xTF32: three TF32 tensor-core products (495
# TFLOP/s dense) per f32 product
F32_3XTF32_PEAK = 495e12 / 3
BF16_PEAK = 989e12    # H100 SXM dense bf16 FLOP/s
HBM_BYTES_S = 3.35e12
# max |kernel - plain| <= TOL * max|plain|: f32 sums in another order (K1
# over 27*Cin terms, K3 over a window's keys); bf16 K1 also rounds its
# output to bf16 (2^-9 relative) while the plain version rounds once more
# at a different point. K3 computes in f32 from the same bf16 inputs.
# K1 as the input gradient is the same kernel (1e-4, 1e-2). K1b sums over
# all V rows of an offset in f32 from the same (f32 or bf16) inputs as its
# plain version and returns f32: 1e-4 either way. K4 and K5 compute in f32
# from the same inputs and return f32; each of their outputs is held to 1e-4
# of its own largest entry. K2 computes in f32 from the same (f32 or bf16)
# inputs as its plain version and returns f32: 1e-4 either way.
TOL = {("flash_window_sorted", "f32"): 1e-4, ("flash_window_sorted", "bf16"): 1e-4,
       ("rulebook_conv", "f32"): 1e-4, ("rulebook_conv", "bf16"): 1e-2,
       ("rulebook_conv_dx", "f32"): 1e-4, ("rulebook_conv_dx", "bf16"): 1e-2,
       ("rulebook_conv_dw", "f32"): 1e-4, ("rulebook_conv_dw", "bf16"): 1e-4,
       ("flash_rpe_fwd", "f32"): 1e-4, ("flash_rpe_fwd", "bf16"): 1e-4,
       ("flash_rpe_bwd_q", "f32"): 1e-4, ("flash_rpe_bwd_q", "bf16"): 1e-4,
       ("flash_rpe_bwd_k", "f32"): 1e-4, ("flash_rpe_bwd_k", "bf16"): 1e-4}
# a whole request through the kernels against the same request through the
# plain versions on the card: each head's logits on its rows within
# REQUEST_RTOL of the largest plain logit (f32 sums in another order, and
# scatters that add in no fixed order), and its predictions agreeing on
# ARGMAX_AGREEMENT of the rows (two logits closer than that may swap)
REQUEST_RTOL = 1e-4
ARGMAX_AGREEMENT = 0.999
OUT_DIR = "chiprun_out"
DEVICE = "cuda"


def emit(obj):
    print(json.dumps(obj), flush=True)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=10, warmup=2):
    """Median CUDA-event time of ``fn`` in ms."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _timed(fn, batch):
    """fn(batch) between two CUDA events -> (output, device ms, wall ms)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn(batch)
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


def phase_env():
    import torch
    from u2mkd_tpu_torch.data import native
    from u2mkd_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    logs = build.build()
    nvcc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.load()
    native_s = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for name, log in logs.items():
            f.write(f"== {name}\n{log}\n")
    emit({"phase": "env", "gpu": gpu_line(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "kernel_build_s": round(nvcc_s, 3), "native_build_s": round(native_s, 3),
          "kernels_built": sorted(logs)})


def host_batch(seed, model):
    from u2mkd_tpu_torch.data import plumbing_host, synthetic, wgeom_host

    raw = synthetic.make_batch(np.random.RandomState(seed), 1, P, voxel_size=VOXEL)
    t0 = time.perf_counter()
    raw["plumbing"] = plumbing_host.batch_plumbing(
        raw["pcoords"], raw["xyz"], raw["pmask"], CAPS,
        wgeom_params=wgeom_host.params_from_model(model))
    return raw, (time.perf_counter() - t0) * 1e3


def _errors(outs, refs):
    """(largest |out - ref|, largest such error over its max |ref|) over
    pairs of tensors; inf where any value is NaN or inf."""
    err, rel = 0.0, 0.0
    for out, ref in zip(outs, refs):
        ref = ref.float()
        e = (out.float() - ref).abs().max().item()
        r = e / max(ref.abs().max().item(), 1e-30)
        err = max(err, e if math.isfinite(e) else math.inf)
        rel = max(rel, r if math.isfinite(r) else math.inf)
    return err, rel


def _compare(name, dtype, case, kernel, plain, bound, plain_ms=None, timed=None):
    """Run ``kernel`` and ``plain`` (each returning a tensor or a tuple of
    tensors), hold every output of the kernel to TOL of the largest entry of
    the plain one, then time both (the plain one unless its time comes as
    ``plain_ms``; ``timed``, a (kernel, plain) pair, times those instead)."""
    import torch

    outs_k, outs_p = kernel(), plain()
    if torch.is_tensor(outs_k):
        outs_k, outs_p = (outs_k,), (outs_p,)
    torch.cuda.synchronize()
    tol = TOL[(name, dtype)]
    err, rel = _errors(outs_k, outs_p)
    row = {"kernel": name, "dtype": dtype, "case": case,
           "shape": [list(o.shape) for o in outs_k] if len(outs_k) > 1 else list(outs_k[0].shape),
           "max_abs_err": err, "max_rel_err": rel, "tol_rel": tol,
           "finite": all(bool(torch.isfinite(o).all().item()) for o in outs_k)}
    if not rel <= tol:
        raise AssertionError(f"{name} {dtype} {case} disagrees with its plain "
                             f"version: {row}")
    if timed is not None:
        kernel, plain = timed
    row["ms"] = cuda_ms(kernel)
    row["plain_ms"] = cuda_ms(plain, reps=5, warmup=1) if plain_ms is None else plain_ms
    if case == "main_path":
        row.update(bound)
    return row


def _bound(nbytes, flops, peak):
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "bound_peak_flop_s": peak}


def _popcount(m):
    """Set bits of each entry of an int32 tensor of masks (27 bits)."""
    import torch

    return ((m[..., None] >> torch.arange(27, device=m.device, dtype=torch.int32)) & 1).sum(-1)


def conv_slots(nbr, plan, cin, cout):
    """(row, offset) slots K1 and K1b multiply per valid pair of ``nbr``,
    before the plan (PR 3's kernels: K1 a whole tile of 64 Morton rows at
    every offset one of them has; K1b a whole chunk of 32 rows at every
    offset one of them has) and with it (K1 the plan's mask-sorted tiles at
    their offsets' union; K1b each range's pairs in steps of 32), read from
    the plan on the host."""
    import torch
    from u2mkd_tpu_torch.ops.kernels import spconv_kernel as K

    b, k, v = nbr.shape
    valid = (nbr >= 0) & (nbr < v)
    n_valid = int(valid.sum())

    def union_slots(valid_rows, tile):
        pad = -v % tile
        vv = torch.cat([valid_rows, valid_rows.new_zeros(b, k, pad)], 2)
        return int(vv.view(b, k, -1, tile).any(-1).sum()) * tile

    tile = K.PLAN_TILE
    k1_after = int(_popcount(plan.tile_mask).sum()) * tile
    seg = plan.seg.tolist()
    splits = K.dw_splits(b * v, cin, cout,
                         torch.cuda.get_device_properties(nbr.device).multi_processor_count)
    total, k1b_after = seg[-1], 0
    for s in range(splits):
        p0, p1 = total * s // splits, total * (s + 1) // splits
        for kk in range(k):
            n = min(p1, seg[kk + 1]) - max(p0, seg[kk])
            k1b_after += -(-n // 32) * 32 if n > 0 else 0
    return {"K1": (union_slots(valid, 64) / n_valid, k1_after / n_valid),
            "K1b": (union_slots(valid, 32) / n_valid, k1b_after / n_valid)}


def conv_cases(level0):
    """K1 at the largest launch of the main path (level 0, Cin 128 -> Cout
    96: up3_res0's first conv) on the real rulebook, and a small case; K1 as
    that conv's input gradient (96 -> 128 with the reversed weights) and
    K1b, its weight gradient, likewise. Each case builds its plan once and
    hands it to the kernels, as a level does for its convs; the main-path
    rows carry the plan's build ms, the slots multiplied per valid pair
    before and after the plan (:func:`conv_slots`) and ``dense_gemm_ms``,
    one ``torch.matmul`` of the same operations as a dense product of
    n_valid rows in the row's dtype (a yardstick of the arithmetic alone,
    not the same function). The f32 bound is at the 3xTF32 rate."""
    import torch
    from u2mkd_tpu_torch.ops.kernels import spconv_kernel as K

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    nbr27 = level0.nbr27
    mask = level0.grid.mask
    v = nbr27.shape[-1]
    n_valid = int(((nbr27 >= 0) & (nbr27 < v)).sum())
    small_nbr = torch.randint(-1, 310, (2, 27, 300), device=dev, generator=gen,
                              dtype=torch.int32)  # includes -1 and >= V rows
    small_valid = int(((small_nbr >= 0) & (small_nbr < 300)).sum())
    plans = {"small": K.conv_plan(small_nbr), "main_path": K.conv_plan(nbr27)}
    plan_ms = cuda_ms(lambda: K.conv_plan(nbr27))
    slots = conv_slots(nbr27, plans["main_path"], 128, 96)
    for dtype, tag, peak in ((torch.float32, "f32", F32_3XTF32_PEAK),
                             (torch.bfloat16, "bf16", BF16_PEAK)):
        for case, nbr, cin, cout, vmask, nv in (
                ("small", small_nbr, 40, 72, None, small_valid),
                ("main_path", nbr27, 128, 96, mask, n_valid)):
            b, k, vv = nbr.shape
            plan = plans[case]

            def rand(*shape):
                t = torch.randn(*shape, device=dev, generator=gen)
                if vmask is not None:
                    t = torch.where(vmask[..., None], t, 0.0)
                return t.to(dtype).contiguous()

            x, g = rand(b, vv, cin), rand(b, vv, cout)
            w = ((torch.rand(k, cin, cout, device=dev, generator=gen) * 2 - 1)
                 * (k * cin) ** -0.5).to(dtype).contiguous()
            es = x.element_size()
            flops = 2.0 * cin * cout * nv
            dense = [torch.randn(*s, device=dev, generator=gen).to(dtype)
                     for s in ((nv, cin), (cin, cout), (nv, cout), (cout, cin))]

            def extra(kid, gemm):
                return ({"slots_per_pair_before": slots[kid][0],
                         "slots_per_pair_after": slots[kid][1], "plan_ms": plan_ms,
                         "dense_gemm_ms": cuda_ms(gemm), "n_valid": nv}
                        if case == "main_path" else {})

            row = _compare(
                "rulebook_conv", tag, case,
                lambda: K.rulebook_conv(x, w, nbr, plan),
                lambda: K.rulebook_conv_plain(x, w, nbr),
                _bound(es * (x.numel() + w.numel() + b * vv * cout) + 4 * nbr.numel(),
                       flops, peak))
            rows.append(dict(row, **extra("K1", lambda: dense[0] @ dense[1])))
            row = _compare(
                "rulebook_conv_dx", tag, case,
                lambda: K.rulebook_conv_dx(g, w, nbr, plan),
                lambda: K.rulebook_conv_plain(g, K.reversed_weights(w), nbr),
                _bound(es * (g.numel() + w.numel() + b * vv * cin) + 4 * nbr.numel(),
                       flops, peak))
            rows.append(dict(row, **extra("K1", lambda: dense[2] @ dense[3])))
            row = _compare(
                "rulebook_conv_dw", tag, case,
                lambda: K.rulebook_conv_dw(x, g, nbr, plan),
                lambda: K.rulebook_conv_dw_plain(x, g, nbr),
                _bound(es * (x.numel() + g.numel()) + 4 * (nbr.numel() + w.numel()),
                       flops, peak))
            rows.append(dict(row, **extra("K1b", lambda: dense[0].T @ dense[2])))
            del dense
    return rows


def _pairs(rank):
    """sum over windows of occupancy^2: the (query, key) pairs K2 and K3
    attend."""
    import torch
    from u2mkd_tpu_torch.ops import wattn

    counts = torch.bincount(torch.cumsum(wattn.window_starts(rank).long(), 0) - 1)
    return int((counts.long() ** 2).sum())


def _small_geometry(n, g, radial, gen):
    """Random window-sorted geometry: 40 windows of random sizes, quantized
    coordinates in [-1, G] (clipping exercised), per-tile key ranges."""
    import torch
    from types import SimpleNamespace
    from u2mkd_tpu_torch.ops import wattn

    dev = gen.device
    rank = torch.sort(torch.randint(0, 40, (n,), device=dev, generator=gen)).values.float()
    start, end = wattn.window_bounds_from_sorted(rank)
    return SimpleNamespace(
        rank=rank,
        quant=torch.randint(-1, g + 1, (n, 3), device=dev, generator=gen,
                            dtype=torch.int32),
        r=(torch.rand(n, device=dev, generator=gen) * 3) if radial else None,
        kmin=start[::128].contiguous(),
        kmax=torch.maximum(end[127::128], start[::128] + 1).contiguous())


def attention_cases(geoms):
    """K3, K4 and K5 at every attention level of both branches on the real
    host geometry (``geoms[branch][level - 1]``; d=16, G=24, and per branch
    h = 1, 2, 4, 8 heads at levels 1-4, as the teacher has them), f32, and
    bf16 at level 1; and a small case per branch. The backward kernels take
    the forward's lse and a random output gradient."""
    import torch
    from u2mkd_tpu_torch.ops import wattn
    from u2mkd_tpu_torch.ops.kernels import wattn_kernel as K

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    d, g = 16, 24
    for branch, levels in geoms.items():
        radial = levels[0].r is not None
        l2, a = (2 * g, 0.0125) if radial else (2 * g - 1, 0.0)
        small = _small_geometry(1024, g, radial, gen)
        cases = [("small", 0, small, 2, "f32"), ("small", 0, small, 2, "bf16")]
        cases += [("main_path", lv + 1, gm, 2 ** lv, "f32") for lv, gm in enumerate(levels)]
        cases.append(("main_path", 1, levels[0], 1, "bf16"))
        for case, level, gm, h, tag in cases:
            dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[tag]
            n = gm.rank.shape[0]
            q, k, v = (torch.randn(n, h, d, device=dev, generator=gen)
                       .mul(s).to(dtype).contiguous() for s in (d ** -0.5, 1.0, 1.0))
            tq, tk, tv = (0.02 * torch.randn(l2, 3, h, d, device=dev, generator=gen)
                          for _ in range(3))
            qT, kT = wattn.table_projections(q, tq), wattn.table_projections(k, tk)
            geo = (gm.rank, gm.quant, gm.r)
            pairs = _pairs(gm.rank)
            es = q.element_size()
            proj = 4 * n * h * 3 * l2                      # one [N, h, 3, L2] f32
            rows_in = 3 * es * n * h * d + 4 * n * (1 + 3 + radial)
            # beside each kernel's time, what sets it: how far a walk over
            # each tile's key range (the earlier design of K3) and one over
            # each row's own window (K3's, K4's and K5's) go per pair, and
            # the warps the launch keeps resident on an SM
            walk = K.walk_counts(gm.rank, gm.kmin, gm.kmax)
            occ = {src: K.window_attention_occupancy(src, dtype, d, g, radial)
                   for src in ("wattn_rpe_fwd", "wattn_rpe_bwd_q", "wattn_rpe_bwd_k")}
            rows.append(_compare(
                "flash_rpe_fwd", tag, case,
                lambda: K.flash_rpe_fwd(q, k, v, qT, kT, tv, *geo, gm.kmin, gm.kmax, g, a),
                lambda: K.flash_rpe_fwd_plain(q, k, v, qT, kT, tv, *geo, g, a),
                dict(_bound(rows_in + 2 * proj + 4 * tv.numel() + 4 * n * h * (d + 1),
                            pairs * h * (7 * d + 6), F32_PEAK),
                     **walk, **occ["wattn_rpe_fwd"])))
            out, lse = K.flash_rpe_fwd(q, k, v, qT, kT, tv, *geo, gm.kmin, gm.kmax, g, a)
            do = torch.randn(n, h, d, device=dev, generator=gen)
            dfac = (do * out).sum(-1)
            edo = wattn.table_projections(do, tv)
            bwd = (q, k, v, qT, kT, edo, *geo, lse, do, dfac)
            bytes_in = rows_in + 3 * proj + 4 * n * h * (d + 2)
            # one plain backward computes K4's and K5's outputs together; it
            # runs and is timed once, and its time stands as the plain time
            # of both
            ref = K.flash_rpe_bwd_plain(*bwd, g, a)
            plain_ms = cuda_ms(lambda: K.flash_rpe_bwd_plain(*bwd, g, a), reps=5, warmup=1)
            # per pair and head, K4: two d-dots, the dq update, nine lookups
            # and six mass adds; K5: two d-dots, the dk and dv updates, nine
            # lookups and three mass adds
            rows.append(_compare(
                "flash_rpe_bwd_q", tag, case,
                lambda: K.flash_rpe_bwd_q(*bwd, gm.kmin, gm.kmax, g, a),
                lambda: (ref[0], ref[3], ref[5]),
                dict(_bound(bytes_in + 4 * n * h * d + 2 * proj,
                            pairs * h * (6 * d + 18), F32_PEAK),
                     **walk, **occ["wattn_rpe_bwd_q"]), plain_ms))
            rows.append(_compare(
                "flash_rpe_bwd_k", tag, case,
                lambda: K.flash_rpe_bwd_k(*bwd, gm.kmin, gm.kmax, g, a),
                lambda: (ref[1], ref[2], ref[4]),
                dict(_bound(bytes_in + 8 * n * h * d + proj,
                            pairs * h * (8 * d + 14), F32_PEAK),
                     **walk, **occ["wattn_rpe_bwd_k"]), plain_ms))
            del ref
            for row in rows[-3:]:
                row.update(branch=branch, level=level, heads=h)
    return rows


def _jagged_sdpa(qs, ks, vs, rank):
    """The library yardstick of K2: windows are contiguous runs of the
    sorted rows, so ``scaled_dot_product_attention`` over jagged nested
    tensors with offsets at the window starts computes K2's function. ->
    (a call returning [N, h, d], its output)."""
    import torch
    import torch.nn.functional as F
    from u2mkd_tpu_torch.ops import wattn

    n = rank.shape[0]
    offsets = torch.cat([torch.nonzero(wattn.window_starts(rank))[:, 0],
                         torch.tensor([n], device=rank.device)])
    nts = [torch.nested.nested_tensor_from_jagged(x.contiguous(), offsets).transpose(1, 2)
           for x in (qs, ks, vs)]

    def call():
        return F.scaled_dot_product_attention(*nts, scale=1.0).transpose(1, 2).values()

    return call, call()


def _flex_windows(qs, ks, vs, sw):
    """The second library yardstick of K2: ``flex_attention``, compiled, with
    a document mask (key j counts for query i where rank_i == rank_j) over
    the window-sorted, padded rows of ``sw`` (a ``SortedWindows``). Its
    block mask lists, for each 128-query block, the key blocks of the tile's
    key range [kmin, kmax), so no N x N mask is built. -> (a call returning
    [N, h, d], its output). The compiler's caches go under the build
    directory."""
    import torch
    from torch.nn.attention.flex_attention import BlockMask, flex_attention
    from u2mkd_tpu_torch.ops.kernels import build

    cache = build.BUILD_DIR / "inductor"
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(cache))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    import torch._inductor.config as inductor_config

    inductor_config.compile_threads = 1   # no pool of compile workers
    rank, n = sw.rank, sw.rank.shape[0]
    blk = 128
    lo, hi = sw.kmin.long() // blk, (sw.kmax.long() + blk - 1) // blk
    idx = lo[:, None] + torch.arange(n // blk, device=rank.device)
    idx = torch.where(idx < hi[:, None], idx, 0).int()

    def same_window(b, h, q_idx, kv_idx):
        return rank[q_idx] == rank[kv_idx]

    mask = BlockMask.from_kv_blocks((hi - lo).int()[None, None], idx[None, None],
                                    BLOCK_SIZE=blk, mask_mod=same_window, seq_lengths=(n, n))
    fn = torch.compile(flex_attention)
    q4, k4, v4 = (x.transpose(0, 1)[None].contiguous() for x in (qs, ks, vs))

    def call():
        return fn(q4, k4, v4, block_mask=mask, scale=1.0)[0].transpose(0, 1)

    return call, call()


def window_cases(xyz, valid):
    """K2 through its entry point against the plain version, f32 and bf16:
    a small random case and the main-path shape (the teacher's level-1
    voxels, ``WINDOW_HEADS`` heads of d=16) on cubic and on sphere windows.
    The times are of the kernel alone, its plain version and two library
    calls (the jagged SDPA and the compiled ``flex_attention``), on the
    window-sorted rows; beside them the walk counts and the kernel's
    resident warps."""
    import torch
    from u2mkd_tpu_torch.ops import wattn
    from u2mkd_tpu_torch.ops.kernels import wattn_kernel as K

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(2)
    d = 16
    small_xyz = torch.rand(4096, 3, device=dev, generator=gen) * 16 - 8
    small_valid = torch.rand(4096, device=dev, generator=gen) < 0.9
    cases = (("small", "cubic", small_xyz, small_valid, (2.0, 2.0, 2.0), 2),
             ("main_path", "cubic", xyz, valid, WINDOW_CUBIC, WINDOW_HEADS),
             ("main_path", "sphere", wattn.cart2sphere(xyz), valid, WINDOW_SPHERE,
              WINDOW_HEADS))
    rows = []
    for case, branch, pos, ok, ws, h in cases:
        sw = K.sort_by_window(pos, ok, ws)
        n, vcap = sw.rank.shape[0], pos.shape[0]
        pairs = _pairs(sw.rank)
        windows = int(wattn.window_starts(sw.rank[:vcap]).sum())
        for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            q, k, v = (torch.randn(vcap, h, d, device=dev, generator=gen)
                       .mul(s).to(dtype) for s in (d ** -0.5, 1.0, 1.0))
            qs, ks, vs = (torch.cat([x[sw.order], x.new_zeros(n - vcap, h, d)]).contiguous()
                          for x in (q, k, v))
            es = q.element_size()
            row = _compare(
                "flash_window_sorted", tag, case,
                lambda: K.sparse_window_attention_flash(q, k, v, pos, ok, ws),
                lambda: K.sparse_window_attention_flash(q, k, v, pos, ok, ws, plain=True),
                dict(_bound(es * 3 * n * h * d + 4 * n * h * d + 4 * n,
                            4.0 * pairs * h * d, F32_PEAK),
                     **K.walk_counts(sw.rank, sw.kmin, sw.kmax),
                     **K.window_attention_occupancy("wattn_fwd", dtype, d, 0, False)),
                timed=(lambda: K.flash_window_sorted(qs, ks, vs, sw.rank, sw.kmin, sw.kmax),
                       lambda: K.flash_window_sorted_plain(qs, ks, vs, sw.rank)))
            row.update(branch=branch, heads=h, windows=windows,
                       largest_window=int(torch.bincount(sw.rank[:vcap]).max()))
            if case == "main_path":
                call, lib = _jagged_sdpa(qs[:vcap], ks[:vcap], vs[:vcap], sw.rank[:vcap])
                ref = K.flash_window_sorted_plain(qs[:vcap], ks[:vcap], vs[:vcap],
                                                  sw.rank[:vcap])
                row.update(library_ms=cuda_ms(call), library_dtype=tag,
                           library_max_rel_err=_errors((lib,), (ref,))[1])
                # a yardstick, not a check: where flex_attention does not
                # compile on this card, its error stands in the row instead
                try:
                    call, lib = _flex_windows(qs, ks, vs, sw)
                    row.update(library_flex_ms=cuda_ms(call), library_flex_max_rel_err=_errors(
                        (lib[:vcap],), (ref,))[1])
                except Exception as e:  # noqa: BLE001
                    row.update(library_flex_ms=None,
                               library_flex_error=f"{type(e).__name__}: {e}"[:300])
            rows.append(row)
    return rows


def level1_voxels(raw):
    """The level-1 voxel centres [V, 3] and mask [V] of one request's host
    plumbing, on the card: K2's main-path rows."""
    import torch

    pl = raw["plumbing"]
    return (torch.as_tensor(pl["voxxyz"][1][0], device=DEVICE),
            torch.as_tensor(pl["vmask"][1][0], device=DEVICE).bool())


def phase_kernels(model):
    import torch
    from u2mkd_tpu_torch.models.plumbing import from_precomputed

    raw, _ = host_batch(SEEDS[0], model)
    pl = from_precomputed(raw["plumbing"], raw["pmask"], DEVICE)
    rows = conv_cases(pl.levels[0])
    rows += attention_cases({b: pl.wgeom[b] for b in ("cubic", "sphere")})
    rows += window_cases(*level1_voxels(raw))
    for row in rows:
        emit(dict(phase="kernels", **row))
    torch.cuda.synchronize()
    return rows, raw


def phase_window_entry(raw):
    """K2's main path, its own entry point: ``sparse_window_attention_flash``
    once on the level-1 voxels' cubic windows and once on their sphere
    windows, f32; outputs finite, zero on invalid rows."""
    import torch
    from u2mkd_tpu_torch.ops import wattn
    from u2mkd_tpu_torch.ops.kernels import wattn_kernel as K

    xyz, valid = level1_voxels(raw)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    d = 16
    q, k, v = (torch.randn(xyz.shape[0], WINDOW_HEADS, d, device=DEVICE, generator=gen)
               .mul(s) for s in (d ** -0.5, 1.0, 1.0))
    K.flash_window_sorted.launches = 0
    for pos, ws in ((xyz, WINDOW_CUBIC), (wattn.cart2sphere(xyz), WINDOW_SPHERE)):
        out = K.sparse_window_attention_flash(q, k, v, pos, valid, ws)
        if not (bool(torch.isfinite(out).all()) and bool((out[~valid] == 0).all())):
            raise AssertionError(f"K2's entry point gave non-finite or non-zero invalid rows "
                                 f"on windows {ws}")
    torch.cuda.synchronize()
    launches = K.flash_window_sorted.launches
    emit({"phase": "window_entry", "rows": int(xyz.shape[0]), "valid": int(valid.sum()),
          "heads": WINDOW_HEADS, "launches": launches})
    if launches != 2:
        raise AssertionError(f"expected 2 K2 launches through its entry point: {launches}")
    return launches


def phase_main_path(model):
    import torch
    from u2mkd_tpu_torch.ops.kernels import spconv_kernel, wattn_kernel
    from u2mkd_tpu_torch.train import metrics, state

    eval_fn = state.make_eval_step(model, CAPS, NUM_CLASSES)
    batches = []
    for seed in SEEDS:
        raw, host_ms = host_batch(seed, model)
        batches.append((seed, raw, host_ms))
    torch.cuda.synchronize()

    counters = (spconv_kernel.rulebook_conv, wattn_kernel.flash_rpe_fwd)
    for c in counters:
        c.launches = 0
    per_request, outs = [], []
    for seed, raw, host_ms in batches:
        before = [c.launches for c in counters]
        out, device_ms, wall_ms = _timed(eval_fn, raw)
        logits = out["logits"]
        row = {"phase": "request", "seed": seed, "points": P,
               "valid_points": int(raw["pmask"].sum()), "host_ms": host_ms,
               "device_ms": device_ms, "wall_ms": wall_ms,
               "logits_shape": list(logits.shape),
               "finite": bool(torch.isfinite(logits).all().item()),
               "launches": {c.__name__: c.launches - b for c, b in zip(counters, before)},
               "miou_random_weights": metrics.compute_miou(
                   {k: v.cpu().numpy() for k, v in out["counts"].items()})[0]}
        emit(row)
        if not row["finite"] or row["logits_shape"] != [1, P, NUM_CLASSES]:
            raise AssertionError(f"bad logits: {row}")
        if row["launches"] != {"rulebook_conv": 34, "flash_rpe_fwd": 8}:
            raise AssertionError(f"expected 34 K1 and 8 K3 launches per forward: {row}")
        per_request.append(row)
        outs.append(out)
    launches = {c.__name__: c.launches for c in counters}
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    warm_ms = float(np.median([r["device_ms"] for r in per_request[1:]]))
    groups, busy_ms, profiled_ms = profile_by_kernel(eval_fn, batches[0][1],
                                                     PROFILED_REQUESTS, "profile.txt")
    emit({"phase": "profile", "requests": PROFILED_REQUESTS,
          "device_busy_ms": busy_ms, "request_device_ms_unprofiled": warm_ms,
          "device_busy_share": busy_ms / warm_ms,
          "request_wall_ms_profiled": profiled_ms, "by_kernel": groups})

    # the same first request through the plain versions, on the card
    seed, raw, _ = batches[0]
    plain, plain_s = _plain_request(model, eval_fn, raw)
    _held_to_plain({"phase": "plain_check", "seed": seed, "points": P, "plain_wall_s": plain_s},
                   outs[0], plain, (("vox", "logits", torch.as_tensor(raw["pmask"],
                                                                      device=DEVICE)),))
    emit({"phase": "main_path", "requests": len(per_request), "launches": launches,
          "device_ms": [r["device_ms"] for r in per_request],
          "host_ms": [r["host_ms"] for r in per_request]})
    return launches


def _plain_request(model, eval_fn, raw):
    """``eval_fn(raw)`` through the plain versions on the card -> (its
    output, wall s)."""
    import torch

    model.set_plain(True)
    try:
        start = time.perf_counter()
        plain = eval_fn(raw)
        torch.cuda.synchronize()
        return plain, time.perf_counter() - start
    finally:
        model.set_plain(False)


def _held_to_plain(check, out, plain, heads):
    """Each head's argmax agreement, largest logit difference and largest
    plain logit on its rows (``heads``: (name, logits key, bool rows))
    between a request through the kernels, ``out``, and the same request
    through the plain versions, ``plain``, added to ``check`` and emitted;
    raises unless every head holds to REQUEST_RTOL and ARGMAX_AGREEMENT."""
    for head, key, rows in heads:
        got, want = out[key][rows], plain[key][rows]
        check[f"argmax_agreement_{head}"] = (
            got.argmax(-1) == want.argmax(-1)).float().mean().item()
        check[f"max_logit_abs_diff_{head}"] = (got - want).abs().max().item()
        check[f"max_abs_logit_{head}"] = want.abs().max().item()
    emit(check)
    for head, _, _ in heads:
        if not (check[f"argmax_agreement_{head}"] >= ARGMAX_AGREEMENT
                and check[f"max_logit_abs_diff_{head}"]
                <= REQUEST_RTOL * check[f"max_abs_logit_{head}"]):
            raise AssertionError(f"the kernel path disagrees with the plain path on the "
                                 f"{head} head: {check}")


def profile_by_kernel(fn, raw, reps, out_name):
    """Device time per call of ``fn(raw)`` by kernel under
    ``torch.profiler`` (the 15 largest groups, every group of
    PROFILE_GROUPS that ran, and the named ranges of
    PROFILE_ANNOTATIONS), the kernels' sum, and the profiled
    host wall ms per call; the profiler's table goes to ``OUT_DIR``. A
    busy share divides the device time by the median CUDA-event time of
    unprofiled calls, so that no host cost of the profiler can count as
    device idle time."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(raw)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / reps
    groups, annotated = {}, {}
    for e in prof.key_averages():
        on_device = getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
        if e.key in PROFILE_ANNOTATIONS:
            # the range's own event: the device time of the kernels it
            # launched, apart from the kernels' groups (not added twice)
            if not on_device:
                annotated[PROFILE_ANNOTATIONS[e.key]] = {
                    "ms": e.device_time_total / 1e3 / reps, "calls": e.count // reps}
            continue
        if not on_device:
            continue
        name = next((v for k, v in PROFILE_GROUPS.items() if k in e.key), e.key)
        g = groups.setdefault(name, {"ms": 0.0, "calls": 0})
        g["ms"] += e.self_device_time_total / 1e3 / reps
        g["calls"] += e.count // reps
    busy_ms = sum(g["ms"] for g in groups.values())
    if busy_ms <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    with open(os.path.join(OUT_DIR, out_name), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))
    ranked = sorted(groups.items(), key=lambda kv: -kv[1]["ms"])
    named = set(PROFILE_GROUPS.values())
    shown = [kv for i, kv in enumerate(ranked) if i < 15 or kv[0] in named]
    return dict(shown, **annotated), busy_ms, profiled_ms


def _train_setup(seed, generator_seed):
    """A teacher in train mode with ``sgd_spformer`` at LR, its step
    function and its device generator."""
    import torch
    from u2mkd_tpu_torch.models.spvcnn import teacher_model
    from u2mkd_tpu_torch.train import optim, state

    model = teacher_model(num_classes=NUM_CLASSES, cr=1.0, voxel_size=VOXEL, head_dim=16,
                          seed=seed, device=DEVICE)
    opt, _ = optim.make_optimizer(model.named_parameters(), "sgd_spformer", LR)
    gen = torch.Generator(device=DEVICE).manual_seed(generator_seed)
    return model, state.make_train_step(model, opt, CAPS, generator=gen)


def phase_train():
    """The main path of training: three steps on three scans, each step's
    launches held to TRAIN_LAUNCHES; then the profile of two more."""
    import torch
    from u2mkd_tpu_torch.ops.kernels import spconv_kernel as S, wattn_kernel as W

    model, step_fn = _train_setup(seed=0, generator_seed=0)
    batches = [(seed, *host_batch(seed, model)) for seed in TRAIN_SEEDS]
    torch.cuda.synchronize()
    counters = (S.rulebook_conv, S.rulebook_conv_dx, S.rulebook_conv_dw,
                W.flash_rpe_fwd, W.flash_rpe_bwd_q, W.flash_rpe_bwd_k)
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for seed, raw, host_ms in batches:
        before = [c.launches for c in counters]
        out, device_ms, wall_ms = _timed(step_fn, raw)
        loss = out["loss"]
        row = {"phase": "train_step", "seed": seed, "points": P,
               "valid_points": int(raw["pmask"].sum()), "host_ms": host_ms,
               "device_ms": device_ms, "wall_ms": wall_ms,
               "loss": loss.item(), "finite": bool(torch.isfinite(loss).item()),
               "launches": {c.__name__: c.launches - b for c, b in zip(counters, before)}}
        emit(row)
        if not row["finite"]:
            raise AssertionError(f"non-finite loss: {row}")
        if row["launches"] != TRAIN_LAUNCHES:
            raise AssertionError(f"expected {TRAIN_LAUNCHES} launches per step: {row}")
        steps.append(row)
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()
    warm_ms = float(np.median([r["device_ms"] for r in steps[1:]]))
    emit({"phase": "train", "steps": len(steps), "launches": launches,
          "device_ms": [r["device_ms"] for r in steps], "host_ms": [r["host_ms"] for r in steps],
          "loss": [r["loss"] for r in steps], "max_memory_allocated_bytes": peak})
    groups, busy_ms, profiled_ms = profile_by_kernel(step_fn, batches[0][1], PROFILED_STEPS,
                                                     "profile_train.txt")
    emit({"phase": "train_profile", "steps": PROFILED_STEPS, "device_busy_ms": busy_ms,
          "step_device_ms_unprofiled": warm_ms, "device_busy_share": busy_ms / warm_ms,
          "step_wall_ms_profiled": profiled_ms, "by_kernel": groups})
    return launches


def _grad_diff(model, ref):
    """(largest per-parameter gradient difference from ``ref`` {name:
    grad}, relative as GRAD_FLOOR says; the parameter's name)."""
    floor = GRAD_FLOOR * max(g.abs().max().item() for g in ref.values())
    worst, worst_name = 0.0, None
    for name, p in model.named_parameters():
        err = (p.grad - ref[name]).abs().max().item() / max(ref[name].abs().max().item(), floor)
        if not err <= worst:
            worst, worst_name = err, name
    return worst, worst_name


def _plain_of_launch():
    """{wrapper name: (its module, its plain version taking the wrapper's
    own arguments)} for the six counted wrappers."""
    from u2mkd_tpu_torch.ops.kernels import spconv_kernel as S, wattn_kernel as W

    def bwd(args, picks):
        # the wrappers take (12 inputs, kmin, kmax, G, a); the plain version
        # walks every pair and takes no key ranges
        out = W.flash_rpe_bwd_plain(*args[:12], *args[14:])
        return tuple(out[i] for i in picks)

    # the conv wrappers' last argument, the plan, is no input of the plain
    # versions
    return {"rulebook_conv": (S, lambda x, w, nbr, plan=None: S.rulebook_conv_plain(x, w, nbr)),
            "rulebook_conv_dx": (S, lambda g, w, nbr, plan=None: S.rulebook_conv_plain(
                g, S.reversed_weights(w), nbr)),
            "rulebook_conv_dw": (S, lambda x, g, nbr, plan=None: S.rulebook_conv_dw_plain(
                x, g, nbr)),
            "flash_rpe_fwd": (W, lambda *a: W.flash_rpe_fwd_plain(*a[:9], *a[11:])),
            "flash_rpe_bwd_q": (W, lambda *a: bwd(a, (0, 3, 5))),
            "flash_rpe_bwd_k": (W, lambda *a: bwd(a, (1, 2, 4)))}


@contextlib.contextmanager
def each_launch_held_to_plain(worst):
    """Inside, every call of the six counted wrappers also runs its plain
    version on the same arguments; ``worst[name]`` collects the calls and
    the largest error of any output relative to the plain output's largest
    entry (:func:`_errors`)."""
    import torch

    saved = []
    for name, (mod, plain) in _plain_of_launch().items():
        kernel = getattr(mod, name)

        def checked(*args, _kernel=kernel, _plain=plain, _name=name):
            outs = _kernel(*args)
            refs = _plain(*args)
            if torch.is_tensor(outs):
                outs, refs = (outs,), (refs,)
            row = worst.setdefault(_name, {"calls": 0, "max_rel_err": 0.0})
            row["calls"] += 1
            row["max_rel_err"] = max(row["max_rel_err"], _errors(outs, refs)[1])
            return outs[0] if len(outs) == 1 else outs

        # the wrapper counts its launches on the function its module's name
        # holds, which is now ``checked``: carry the count there and back
        checked.launches = kernel.launches
        saved.append((mod, name, kernel))
        setattr(mod, name, checked)
    try:
        yield worst
    finally:
        for mod, name, kernel in saved:
            kernel.launches = getattr(mod, name).launches
            setattr(mod, name, kernel)


def phase_grad_check():
    """Two checks of one train step on the card.

    Per launch: the step through the kernels runs every launch of the six
    kernel wrappers (34 + 33 + 34 + 8 + 8 + 8, every level, width and head
    count of the main path) also through its plain version on the same
    arguments, each output held to TOL of the plain output's largest entry.

    Whole step: one step through the kernels and one through the plain
    versions, from one copy of the weights (one seed) and one generator
    seed, so that dropout and drop path draw the same masks: the loss, and
    each parameter's gradient within the spread that one plain step from
    weights nudged by about one ulp gives (GRAD_SPREADS)."""
    import torch

    raw = None
    runs, per_launch = {}, {}
    for tag in ("kernels", "plain", "plain_nudged"):
        model, step_fn = _train_setup(seed=1, generator_seed=5)
        if tag != "kernels":
            model.set_plain(True)
        if tag == "plain_nudged":
            gen = torch.Generator(device=DEVICE).manual_seed(7)
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1 + 2.0 ** -23 * torch.randn(p.shape, device=DEVICE, generator=gen))
        if raw is None:
            raw, _ = host_batch(31, model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with (each_launch_held_to_plain(per_launch) if tag == "kernels"
              else contextlib.nullcontext()):
            loss = step_fn(raw)["loss"].item()
        torch.cuda.synchronize()
        runs[tag] = (model, loss, time.perf_counter() - t0, torch.cuda.max_memory_allocated())
    for name, row in per_launch.items():
        row["tol_rel"] = TOL[(name, "f32")]
    emit({"phase": "grad_check_per_launch", "points": P, "by_kernel": per_launch})
    bad = {n: r for n, r in per_launch.items() if not r["max_rel_err"] <= r["tol_rel"]}
    counts = {n: r["calls"] for n, r in per_launch.items()}
    if bad or counts != TRAIN_LAUNCHES:
        raise AssertionError(f"a kernel launch of the train step disagrees with its plain "
                             f"version, or the launches are not {TRAIN_LAUNCHES}: {per_launch}")
    ref = {n: p.grad for n, p in runs["plain"][0].named_parameters()}
    worst, worst_name = _grad_diff(runs["kernels"][0], ref)
    spread, spread_name = _grad_diff(runs["plain_nudged"][0], ref)
    tol = max(GRAD_RTOL, GRAD_SPREADS * spread)
    loss_k, loss_p = runs["kernels"][1], runs["plain"][1]
    row = {"phase": "grad_check", "points": P, "loss_kernels": loss_k,
           "loss_plain": loss_p, "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
           "max_grad_rel_diff": worst, "worst_param": worst_name,
           "ulp_nudge_grad_rel_diff": spread, "ulp_nudge_worst_param": spread_name,
           "grad_tol_rel": tol, "params": len(ref),
           "step_wall_s": {k: v[2] for k, v in runs.items()},
           "max_memory_allocated_bytes": {k: v[3] for k, v in runs.items()}}
    emit(row)
    if not (row["loss_rel_diff"] <= GRAD_LOSS_RTOL and worst <= tol):
        raise AssertionError(f"kernel gradients disagree with the plain path: {row}")


def student_batch(seed, model, with_teacher=False):
    """A synthetic multimodal scan (``make_multimodal_batch``: the student
    cloud with its cameras, and the teacher's multisweep cloud) with the
    student's host plumbing (and the teacher's, ``with_teacher``) built;
    -> (batch, host build ms)."""
    from u2mkd_tpu_torch.data import plumbing_host, synthetic, wgeom_host

    raw = synthetic.make_multimodal_batch(np.random.RandomState(seed), 1, STUDENT_P, P,
                                          voxel_size=STUDENT_VOXEL, num_cams=NUM_CAMS,
                                          im_hw=IM_HW)
    parts = [("student", STUDENT_CAPS, model.model_s)]
    if with_teacher:
        parts.append(("teacher", CAPS, model.model_t))
    t0 = time.perf_counter()
    for part, caps, sub in parts:
        b = raw[part]
        b["plumbing"] = plumbing_host.batch_plumbing(
            b["pcoords"], b["xyz"], b["pmask"], caps,
            wgeom_params=wgeom_host.params_from_model(sub))
    return raw, (time.perf_counter() - t0) * 1e3


def _student_heads(raw):
    """The student's heads and their rows for :func:`_held_to_plain`: the
    voxel head on the valid points, the pixel head on those in a camera's
    field of view."""
    import torch

    sb = raw["student"]
    valid = torch.as_tensor(sb["pmask"], device=DEVICE)
    return (("vox", "logits", valid),
            ("pix", "logits_pix", valid & torch.as_tensor(sb["fov_mask"], device=DEVICE)))


def phase_student(model):
    """The stage-2 student's main path: three requests without the teacher,
    each held to STUDENT_LAUNCHES; their profile; one request through the
    plain versions on the card."""
    import torch
    from u2mkd_tpu_torch.ops.kernels import spconv_kernel, wattn_kernel
    from u2mkd_tpu_torch.train import distill, metrics

    eval_fn = distill.make_distill_eval_step(model, STUDENT_CAPS, CAPS, NUM_CLASSES)
    batches = [(seed, *student_batch(seed, model)) for seed in STUDENT_SEEDS]
    torch.cuda.synchronize()
    counters = (spconv_kernel.rulebook_conv, wattn_kernel.flash_rpe_fwd)
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    per_request, outs = [], []
    for seed, raw, host_ms in batches:
        before = [c.launches for c in counters]
        out, device_ms, wall_ms = _timed(eval_fn, raw)
        sb = raw["student"]
        fov = sb["pmask"] & sb["fov_mask"]
        row = {"phase": "student_request", "seed": seed, "points": STUDENT_P,
               "valid_points": int(sb["pmask"].sum()), "fov_points": int(fov.sum()),
               "cameras": NUM_CAMS, "image_hw": list(IM_HW), "host_ms": host_ms,
               "device_ms": device_ms, "wall_ms": wall_ms,
               "logits_shape": list(out["logits"].shape),
               "logits_pix_shape": list(out["logits_pix"].shape),
               "finite": bool(torch.isfinite(out["logits"]).all().item()
                              and torch.isfinite(out["logits_pix"]).all().item()),
               "launches": {c.__name__: c.launches - b for c, b in zip(counters, before)},
               "miou_vox_random_weights": metrics.compute_miou(
                   {k: v.cpu().numpy() for k, v in out["counts_vox"].items()})[0],
               "miou_pix_random_weights": metrics.compute_miou(
                   {k: v.cpu().numpy() for k, v in out["counts_pix"].items()})[0]}
        emit(row)
        want = [1, STUDENT_P, NUM_CLASSES]
        if not row["finite"] or row["logits_shape"] != want or row["logits_pix_shape"] != want:
            raise AssertionError(f"bad student logits: {row}")
        if row["launches"] != STUDENT_LAUNCHES:
            raise AssertionError(f"expected {STUDENT_LAUNCHES} launches per request: {row}")
        per_request.append(row)
        outs.append(out)
    launches = {c.__name__: c.launches for c in counters}
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the student's path never launched: {launches}")
    peak = torch.cuda.max_memory_allocated()
    warm_ms = float(np.median([r["device_ms"] for r in per_request[1:]]))
    groups, busy_ms, profiled_ms = profile_by_kernel(eval_fn, batches[0][1],
                                                     PROFILED_REQUESTS, "profile_student.txt")
    emit({"phase": "student_profile", "requests": PROFILED_REQUESTS,
          "device_busy_ms": busy_ms, "request_device_ms_unprofiled": warm_ms,
          "device_busy_share": busy_ms / warm_ms,
          "request_wall_ms_profiled": profiled_ms, "by_kernel": groups})

    # the first request through the plain versions, on the card
    seed, raw, _ = batches[0]
    plain, plain_s = _plain_request(model, eval_fn, raw)
    _held_to_plain({"phase": "student_plain_check", "seed": seed, "points": STUDENT_P,
                    "plain_wall_s": plain_s}, outs[0], plain, _student_heads(raw))
    emit({"phase": "student", "requests": len(per_request), "launches": launches,
          "device_ms": [r["device_ms"] for r in per_request],
          "host_ms": [r["host_ms"] for r in per_request],
          "max_memory_allocated_bytes": peak})
    return launches


@contextlib.contextmanager
def recording_conv_widths(widths):
    """Inside, every K1 forward call appends its (Cin, Cout) to ``widths``
    (the teacher's widest conv output, int(cr_t * 256), is twice the
    student's).
    The wrapper counts its launches on the function its module's name
    holds, so the count is carried to the recorder and back."""
    from u2mkd_tpu_torch.ops.kernels import spconv_kernel as S

    kernel = S.rulebook_conv

    def recorded(x, w, nbr, plan=None):
        widths.append(tuple(w.shape[1:]))
        return kernel(x, w, nbr, plan)

    recorded.launches = kernel.launches
    S.rulebook_conv = recorded
    try:
        yield widths
    finally:
        kernel.launches = recorded.launches
        S.rulebook_conv = kernel


def phase_student_with_teacher(model):
    """One student request with the frozen teacher (cr_t=2.0) on its own
    multisweep cloud: both models' launches, the teacher's widths among
    them, and the points its IoU counters score (its valid keyframe points).
    Then the request twice more: once with every K1 and K3 launch also run
    through its plain version on the same arguments (the teacher's widths
    up to 512 and its doubled head counts), each output held to TOL; and
    once through the plain versions, the student's logits and the teacher's
    held to the kernel request's as :func:`_held_to_plain` says."""
    import torch
    from u2mkd_tpu_torch.ops.kernels import spconv_kernel, wattn_kernel
    from u2mkd_tpu_torch.train import distill

    eval_fn = distill.make_distill_eval_step(model, STUDENT_CAPS, CAPS, NUM_CLASSES,
                                             run_teacher=True)
    raw, host_ms = student_batch(STUDENT_SEEDS[0], model, with_teacher=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = (spconv_kernel.rulebook_conv, wattn_kernel.flash_rpe_fwd)
    for c in counters:
        c.launches = 0
    widths = []
    with recording_conv_widths(widths):
        out, device_ms, wall_ms = _timed(eval_fn, raw)
    launches = {c.__name__: c.launches for c in counters}
    tb = raw["teacher"]
    t_valid = tb["pmask"] & tb["keyframe_mask"] & (tb["labels"] != 0)
    seen = np.bincount(tb["labels"][t_valid], minlength=NUM_CLASSES)
    teacher_width = int(CR_T * 256)
    row = {"phase": "student_with_teacher", "points": STUDENT_P, "teacher_points": P,
           "teacher_valid_points": int(tb["pmask"].sum()), "host_ms": host_ms,
           "device_ms": device_ms, "wall_ms": wall_ms, "launches": launches,
           "largest_conv_out": max(w[1] for w in widths),
           "counts_teacher_seen": out["counts_teacher"]["seen"].tolist(),
           "finite": all(bool(torch.isfinite(out[k]).all().item())
                         for k in ("logits", "logits_pix", "logits_teacher")),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    emit(row)
    if launches != WITH_TEACHER_LAUNCHES or len(widths) != WITH_TEACHER_LAUNCHES["rulebook_conv"]:
        raise AssertionError(f"expected {WITH_TEACHER_LAUNCHES} launches with the teacher: "
                             f"{row}")
    if row["largest_conv_out"] != teacher_width or not row["finite"] \
            or row["counts_teacher_seen"] != seen.tolist():
        raise AssertionError(f"the teacher did not run at cr_t={CR_T} (widths up to "
                             f"{teacher_width}) or scored other points: {row}")

    per_launch = {}
    with each_launch_held_to_plain(per_launch):
        eval_fn(raw)
    for name, r in per_launch.items():
        r["tol_rel"] = TOL[(name, "f32")]
    emit({"phase": "student_with_teacher_per_launch", "by_kernel": per_launch})
    if {n: r["calls"] for n, r in per_launch.items()} != WITH_TEACHER_LAUNCHES \
            or any(not r["max_rel_err"] <= r["tol_rel"] for r in per_launch.values()):
        raise AssertionError(f"a kernel launch of the request with the teacher disagrees with "
                             f"its plain version, or the launches are not "
                             f"{WITH_TEACHER_LAUNCHES}: {per_launch}")

    plain, plain_s = _plain_request(model, eval_fn, raw)
    heads = _student_heads(raw) + (
        ("teacher", "logits_teacher", torch.as_tensor(tb["pmask"], device=DEVICE)),)
    _held_to_plain({"phase": "student_with_teacher_plain_check", "points": STUDENT_P,
                    "teacher_points": P, "plain_wall_s": plain_s}, out, plain, heads)
    return launches


def kernels_line(rows, launches):
    """One entry per port kernel. ``launches`` is its count over the main
    paths that run it, each read from its own run (``launches[path]``: the
    teacher's three requests "infer" and three train steps "train", the
    student's three requests "student" and its request with the teacher
    "student_teacher", K2's entry point "entry"; K1 counts its forward and
    input-gradient launches), split in ``launches_by_path``; the other
    numbers are from its slowest main-path-shape row in f32."""
    from u2mkd_tpu_torch.ops.kernels import spconv_kernel as S, wattn_kernel as W

    def paths(name, *which):
        return {p: launches[p][name] for p in which}

    by_path = {
        "K1": dict(paths("rulebook_conv", "infer", "train", "student", "student_teacher"),
                   train_dx=launches["train"]["rulebook_conv_dx"]),
        "K1b": paths("rulebook_conv_dw", "train"),
        "K2": paths("flash_window_sorted", "entry"),
        "K3": paths("flash_rpe_fwd", "infer", "train", "student", "student_teacher"),
        "K4": paths("flash_rpe_bwd_q", "train"),
        "K5": paths("flash_rpe_bwd_k", "train"),
    }
    table = (("K1", ("rulebook_conv", "rulebook_conv_dx"), S.SOURCE, S.REPLACES),
             ("K1b", ("rulebook_conv_dw",), S.SOURCE_DW, S.REPLACES_DW),
             ("K2", ("flash_window_sorted",), W.SOURCE_WINDOW, W.REPLACES_WINDOW),
             ("K3", ("flash_rpe_fwd",), W.SOURCE, W.REPLACES),
             ("K4", ("flash_rpe_bwd_q",), W.SOURCE_BWD_Q, W.REPLACES_BWD_Q),
             ("K5", ("flash_rpe_bwd_k",), W.SOURCE_BWD_K, W.REPLACES_BWD_K))
    out = []
    for kid, names, source, replaces in table:
        mine = [r for r in rows if r["kernel"] in names]
        main = [r for r in mine if r["case"] == "main_path" and r["dtype"] == "f32"]
        rep = max(main, key=lambda r: r["ms"])
        out.append({"name": f"{kid} {names[0]}", "route": "cuda", "source": source,
                    "replaces": replaces, "launches": sum(by_path[kid].values()),
                    "launches_by_path": by_path[kid],
                    "max_abs_err": max(r["max_abs_err"] for r in mine),
                    "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                    "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
                    "library_ms": rep.get("library_ms"),
                    **({"library_flex_ms": rep["library_flex_ms"]}
                       if "library_flex_ms" in rep else {})})
    emit({"kernels": out})


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        from u2mkd_tpu_torch.models.spvcnn import teacher_model
        from u2mkd_tpu_torch.models.tsd import tsd_model
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 1
    # the reference runs in full f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_env()
    model = teacher_model(num_classes=NUM_CLASSES, cr=1.0, voxel_size=VOXEL,
                          head_dim=16, seed=0, device=DEVICE)
    rows, raw = phase_kernels(model)
    launches = {"infer": phase_main_path(model)}
    del model
    launches["train"] = phase_train()
    phase_grad_check()
    launches["entry"] = {"flash_window_sorted": phase_window_entry(raw)}
    del raw
    student = tsd_model(num_classes=NUM_CLASSES, cr=1.0, cr_t=CR_T, voxel_size=STUDENT_VOXEL,
                        head_dim=16, seed=0, device=DEVICE)
    launches["student"] = phase_student(student)
    launches["student_teacher"] = phase_student_with_teacher(student)
    kernels_line(rows, launches)
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
