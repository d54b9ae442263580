#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``u2mkd_tpu_torch``) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and the CUDA toolkit (``nvcc``); it builds the kernels
from ``u2mkd_tpu_torch/csrc/`` on first use. Phases, one JSON line each:

  1. env: the card (``nvidia-smi``), torch and CUDA versions, kernel build time;
  2. kernels: each kernel against its plain PyTorch version on the card, f32
     and bf16, on a small random case and at the main path's real shapes,
     with errors, tolerances and CUDA-event times (and, at the real shapes,
     the bound: the least time the card could take for the same work);
  3. main path: three teacher inference requests (SPVCNN + SphereFormer,
     cr=1.0, P=131072, B=1) through ``train.state.make_eval_step``, counting
     kernel launches;
  4. profile: three more requests under ``torch.profiler``, device time by
     kernel, and the device's busy share against the unprofiled requests'
     CUDA-event time, so that no cost of the profiler counts as idle time;
  5. plain check: one request through the plain versions on the card for
     the agreement of predictions.

Then a ``{"kernels": [...]}`` line, the card's name and power limit, and as
the last line ``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero without that line. Long outputs (the compiler's register counts,
the profiler's table) go to ``chiprun_out/``.
"""

import json
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
                  "wattn_rpe_fwd_kernel": "K3 wattn_rpe_fwd"}
F32_PEAK = 67e12      # H100 SXM f32 FLOP/s outside the tensor cores
BF16_PEAK = 989e12    # H100 SXM dense bf16 FLOP/s
HBM_BYTES_S = 3.35e12
# max |kernel - plain| <= TOL * max|plain|: f32 sums in another order (K1
# over 27*Cin terms, K3 over a window's keys); bf16 K1 also rounds its
# output to bf16 (2^-9 relative) while the plain version rounds once more
# at a different point. K3 computes in f32 from the same bf16 inputs.
TOL = {("rulebook_conv", "f32"): 1e-4, ("rulebook_conv", "bf16"): 1e-2,
       ("flash_rpe_sorted", "f32"): 1e-4, ("flash_rpe_sorted", "bf16"): 1e-4}
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


def _compare(name, dtype, case, kernel, plain, bound):
    import torch

    out_k = kernel()
    out_p = plain()
    torch.cuda.synchronize()
    ref = out_p.float()
    err = (out_k.float() - ref).abs().max().item()
    scale = ref.abs().max().item()
    tol = TOL[(name, dtype)]
    row = {"kernel": name, "dtype": dtype, "case": case,
           "shape": list(out_k.shape), "max_abs_err": err,
           "max_rel_err": err / max(scale, 1e-30), "tol_rel": tol,
           "finite": bool(torch.isfinite(out_k).all().item())}
    if not row["finite"] or err > tol * max(scale, 1e-30):
        raise AssertionError(f"{name} {dtype} {case} disagrees with its plain "
                             f"version: {row}")
    row["ms"] = cuda_ms(kernel)
    row["plain_ms"] = cuda_ms(plain, reps=5, warmup=1)
    if case == "main_path":
        row.update(bound)
    return row


def _bound(nbytes, flops, peak):
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def conv_cases(level0):
    """K1 at the largest launch of the main path (level 0, Cin 128 -> Cout
    96: up3_res0's first conv) on the real rulebook, and a small case."""
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
    for dtype, tag, peak in ((torch.float32, "f32", F32_PEAK),
                             (torch.bfloat16, "bf16", BF16_PEAK)):
        for case, nbr, cin, cout, vmask in (
                ("small", small_nbr, 40, 72, None),
                ("main_path", nbr27, 128, 96, mask)):
            b, k, vv = nbr.shape
            x = torch.randn(b, vv, cin, device=dev, generator=gen)
            if vmask is not None:
                x = torch.where(vmask[..., None], x, 0.0)
            w = (torch.rand(k, cin, cout, device=dev, generator=gen) * 2 - 1) \
                * (k * cin) ** -0.5
            x, w = x.to(dtype).contiguous(), w.to(dtype).contiguous()
            es = x.element_size()
            bound = _bound(es * (x.numel() + w.numel() + b * vv * cout) + 4 * nbr.numel(),
                           2.0 * cin * cout * n_valid, peak)
            rows.append(_compare(
                "rulebook_conv", tag, case,
                lambda: K.rulebook_conv(x, w, nbr),
                lambda: K.rulebook_conv_plain(x, w, nbr), bound))
    return rows


def _pairs(rank):
    """sum over windows of occupancy^2: the (query, key) pairs K3 attends."""
    import torch

    new = torch.ones_like(rank, dtype=torch.bool)
    new[1:] = rank[1:] != rank[:-1]
    counts = torch.bincount(torch.cumsum(new.long(), 0) - 1)
    return int((counts.long() ** 2).sum())


def _small_geometry(n, g, radial, gen):
    """Random window-sorted geometry: 40 windows of random sizes, quantized
    coordinates in [-1, G] (clipping exercised), per-tile key ranges."""
    import torch
    from types import SimpleNamespace

    dev = gen.device
    rank = torch.sort(torch.randint(0, 40, (n,), device=dev, generator=gen)).values.float()
    new = torch.ones(n, dtype=torch.bool, device=dev)
    new[1:] = rank[1:] != rank[:-1]
    last = torch.ones_like(new)
    last[:-1] = new[1:]
    idx = torch.arange(n, device=dev)
    start = torch.cummax(torch.where(new, idx, 0), 0).values
    end = torch.flip(torch.cummin(torch.flip(torch.where(last, idx + 1, n), [0]), 0).values,
                     [0])
    return SimpleNamespace(
        rank=rank,
        quant=torch.randint(-1, g + 1, (n, 3), device=dev, generator=gen,
                            dtype=torch.int32),
        r=(torch.rand(n, device=dev, generator=gen) * 3) if radial else None,
        kmin=start[::128].int().contiguous(),
        kmax=torch.maximum(end[127::128], start[::128] + 1).int().contiguous())


def attention_cases(geoms):
    """K3 at level 1 of both branches on the real host geometry (h=1 per
    branch, d=16, G=24), and a small case per branch."""
    import torch
    from u2mkd_tpu_torch.ops.kernels import wattn_kernel as K

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    d, g = 16, 24
    for branch, geom in geoms.items():
        radial = geom.r is not None
        l2, a = (2 * g, 0.0125) if radial else (2 * g - 1, 0.0)
        small = _small_geometry(1024, g, radial, gen)
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            for case, gm, h in (("small", small, 2), ("main_path", geom, 1)):
                n = gm.rank.shape[0]
                q, k, v = (torch.randn(n, h, d, device=dev, generator=gen)
                           .mul(s).to(dtype).contiguous() for s in (d ** -0.5, 1.0, 1.0))
                tq, tk, tv = (0.02 * torch.randn(l2, 3, h, d, device=dev, generator=gen)
                              for _ in range(3))
                pairs = _pairs(gm.rank)
                es = q.element_size()
                nbytes = (3 * es * n * h * d + 4 * n * h * d + 4 * n * (1 + 3 + radial)
                          + 8 * (n // 128) + 3 * 4 * tq.numel())
                flops = pairs * h * (7 * d + 6) + 2 * 2 * n * h * 3 * l2 * d
                args = (gm.rank, gm.quant, gm.r)
                rows.append(_compare(
                    "flash_rpe_sorted", tag, case,
                    lambda: K.flash_rpe_sorted(q, k, v, *args, gm.kmin, gm.kmax,
                                               tq, tk, tv, g, a),
                    lambda: K.flash_rpe_sorted_plain(q, k, v, *args, tq, tk, tv, g, a),
                    dict(_bound(nbytes, flops, F32_PEAK), pairs=pairs)))
                rows[-1]["branch"] = branch
    return rows


def phase_kernels(model):
    import torch
    from u2mkd_tpu_torch.models.plumbing import from_precomputed

    raw, _ = host_batch(SEEDS[0], model)
    pl = from_precomputed(raw["plumbing"], raw["pmask"], DEVICE)
    rows = conv_cases(pl.levels[0])
    rows += attention_cases({b: pl.wgeom[b][0] for b in ("cubic", "sphere")})
    for row in rows:
        emit(dict(phase="kernels", **row))
    torch.cuda.synchronize()
    return rows


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

    counters = (spconv_kernel.rulebook_conv, wattn_kernel.flash_rpe_sorted)
    for c in counters:
        c.launches = 0
    per_request, outs = [], []
    for seed, raw, host_ms in batches:
        before = [c.launches for c in counters]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = eval_fn(raw)
        end.record()
        end.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        logits = out["logits"]
        row = {"phase": "request", "seed": seed, "points": P,
               "valid_points": int(raw["pmask"].sum()), "host_ms": host_ms,
               "device_ms": start.elapsed_time(end), "wall_ms": wall_ms,
               "logits_shape": list(logits.shape),
               "finite": bool(torch.isfinite(logits).all().item()),
               "launches": {c.__name__: c.launches - b for c, b in zip(counters, before)},
               "miou_random_weights": metrics.compute_miou(
                   {k: v.cpu().numpy() for k, v in out["counts"].items()})[0]}
        emit(row)
        if not row["finite"] or row["logits_shape"] != [1, P, NUM_CLASSES]:
            raise AssertionError(f"bad logits: {row}")
        if row["launches"] != {"rulebook_conv": 34, "flash_rpe_sorted": 8}:
            raise AssertionError(f"expected 34 K1 and 8 K3 launches per forward: {row}")
        per_request.append(row)
        outs.append(out)
    launches = {c.__name__: c.launches for c in counters}
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    warm_ms = float(np.median([r["device_ms"] for r in per_request[1:]]))
    phase_profile(eval_fn, batches[0][1], warm_ms)

    # the same first request through the plain versions, on the card
    seed, raw, _ = batches[0]
    model.set_plain(True)
    try:
        start = time.perf_counter()
        plain = eval_fn(raw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - start
    finally:
        model.set_plain(False)
    valid = torch.as_tensor(raw["pmask"], device=DEVICE)
    agree = (plain["pred"] == outs[0]["pred"])[valid].float().mean().item()
    diff = (plain["logits"] - outs[0]["logits"])[valid].abs().max().item()
    scale = plain["logits"][valid].abs().max().item()
    check = {"phase": "plain_check", "seed": seed, "points": P,
             "argmax_agreement": agree, "max_logit_abs_diff": diff,
             "max_abs_logit": scale, "plain_wall_s": plain_s}
    emit(check)
    if agree < 0.999:
        raise AssertionError(f"kernel path disagrees with the plain path: {check}")
    emit({"phase": "main_path", "requests": len(per_request), "launches": launches,
          "device_ms": [r["device_ms"] for r in per_request],
          "host_ms": [r["host_ms"] for r in per_request]})
    return launches


def phase_profile(eval_fn, raw, warm_ms):
    """Device time per request by kernel under ``torch.profiler``. The busy
    share divides it by ``warm_ms``, the median CUDA-event time of the
    unprofiled warm requests, so that no host cost of the profiler can
    count as device idle time."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_REQUESTS):
            eval_fn(raw)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / PROFILED_REQUESTS
    groups = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        name = next((v for k, v in PROFILE_GROUPS.items() if k in e.key), e.key)
        g = groups.setdefault(name, {"ms": 0.0, "calls": 0})
        g["ms"] += e.self_device_time_total / 1e3 / PROFILED_REQUESTS
        g["calls"] += e.count // PROFILED_REQUESTS
    busy_ms = sum(g["ms"] for g in groups.values())
    if busy_ms <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    with open(os.path.join(OUT_DIR, "profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))
    emit({"phase": "profile", "requests": PROFILED_REQUESTS,
          "device_busy_ms": busy_ms, "request_device_ms_unprofiled": warm_ms,
          "device_busy_share": busy_ms / warm_ms,
          "request_wall_ms_profiled": profiled_ms,
          "by_kernel": dict(sorted(groups.items(), key=lambda kv: -kv[1]["ms"])[:15])})


def kernels_line(rows, launches):
    from u2mkd_tpu_torch.ops.kernels import spconv_kernel, wattn_kernel

    out = []
    for mod, name in ((spconv_kernel, "rulebook_conv"), (wattn_kernel, "flash_rpe_sorted")):
        mine = [r for r in rows if r["kernel"] == name]
        main = [r for r in mine if r["case"] == "main_path" and r["dtype"] == "f32"]
        # the slowest main-path-shape launch stands for the kernel
        rep = max(main, key=lambda r: r["ms"])
        out.append({"name": name, "route": "cuda", "source": mod.SOURCE,
                    "replaces": mod.REPLACES, "launches": launches[name],
                    "max_abs_err": max(r["max_abs_err"] for r in mine),
                    "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                    "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
                    "library_ms": None})
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
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 1
    # the reference runs in full f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_env()
    model = teacher_model(num_classes=NUM_CLASSES, cr=1.0, voxel_size=VOXEL,
                          head_dim=16, seed=0, device=DEVICE)
    rows = phase_kernels(model)
    launches = phase_main_path(model)
    kernels_line(rows, launches)
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
