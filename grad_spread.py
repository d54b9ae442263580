#!/usr/bin/env python3
"""How far rounding alone moves the teacher's gradients on one CUDA card.

Run from the repository root: ``python3 grad_spread.py`` (one card, ~2 min).
For three losses, each with PyTorch's deterministic algorithms off and on,
it takes one forward and backward of the teacher (cr=1.0, P=131072, B=1,
f32, random weights from one seed, one scan) six times:

  K, K2   through the kernels, twice;
  P, P2   through the plain PyTorch versions, twice;
  PN, KN  plain and kernels from the weights times (1 + 2^-23 N(0, 1)),
          about one f32 ulp.

The losses: ``lovasz_ce`` in train mode with dropout and drop path at their
config rates (what ``make_train_step`` computes); a smooth one, the logits
times a fixed random tensor, in train mode (batch-stat BN) without dropout;
and the same smooth loss with BN on its running statistics (eval mode).
Each JSON line compares pairs of runs per parameter as ``chip_smoke.py``'s
grad check does (max |difference| over the parameter's largest entry, that
scale floored at 1e-3 of the model's largest entry): the worst parameter,
and the 90th percentile and median over the parameters.
"""

import json
import os
import sys

# cuBLAS is deterministic only with this set before its first call
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np

import chip_smoke as cs

LOSSES = ("lovasz_train", "smooth_train", "smooth_eval")
RUNS = (("K", False, False), ("K2", False, False), ("P", True, False),
        ("P2", True, False), ("PN", True, True), ("KN", False, True))
PAIRS = (("K", "P"), ("K2", "K"), ("P2", "P"), ("PN", "P"), ("KN", "K"))


def grads_of(raw, loss_kind, plain, nudge, deterministic):
    import torch
    from u2mkd_tpu_torch.models.plumbing import from_precomputed
    from u2mkd_tpu_torch.models.spvcnn import teacher_model
    from u2mkd_tpu_torch.ops import losses

    dev = cs.DEVICE
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    rate = 0.3 if loss_kind == "lovasz_train" else 0.0
    model = teacher_model(num_classes=cs.NUM_CLASSES, cr=1.0, voxel_size=cs.VOXEL,
                          head_dim=16, seed=1, device=dev, dropout_rate=rate,
                          drop_path_rate=rate)
    model.set_plain(plain)
    if nudge:
        gen = torch.Generator(device=dev).manual_seed(7)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + 2.0 ** -23 * torch.randn(p.shape, device=dev, generator=gen))
    pl = from_precomputed(raw["plumbing"], raw["pmask"], dev, model.point_levels)
    labels = torch.as_tensor(raw["labels"], device=dev, dtype=torch.int64)
    model.train(loss_kind != "smooth_eval")
    logits = model(torch.as_tensor(raw["feats"], device=dev, dtype=torch.float32), pl,
                   torch.Generator(device=dev).manual_seed(5))["x_vox"]
    if loss_kind == "lovasz_train":
        valid = (pl.pmask & torch.as_tensor(raw["keyframe_mask"], device=dev)
                 & (labels != 0))
        loss = losses.lovasz_ce(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                                valid.reshape(-1))
    else:
        w = torch.randn(logits.shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
        loss = (logits * w)[pl.pmask].sum() / pl.pmask.sum()
    loss.backward()
    torch.use_deterministic_algorithms(False)
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


def compare(grads, ref):
    floor = 1e-3 * max(g.abs().max().item() for g in ref.values())
    rel = {n: (grads[n] - r).abs().max().item() / max(r.abs().max().item(), floor)
           for n, r in ref.items()}
    worst = max(rel, key=rel.get)
    vals = np.array(list(rel.values()))
    return {"worst": rel[worst], "worst_param": worst,
            "p90": float(np.quantile(vals, 0.9)), "median": float(np.median(vals))}


def main():
    import torch

    if not torch.cuda.is_available():
        print("grad_spread: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from u2mkd_tpu_torch.models.spvcnn import teacher_model

    raw, _ = cs.host_batch(31, teacher_model(num_classes=cs.NUM_CLASSES, cr=1.0,
                                             voxel_size=cs.VOXEL, head_dim=16, seed=1,
                                             device="cpu"))
    for loss_kind in LOSSES:
        for deterministic in (False, True):
            runs = {tag: grads_of(raw, loss_kind, plain, nudge, deterministic)
                    for tag, plain, nudge in RUNS}
            row = {"loss": loss_kind, "deterministic": deterministic, "points": cs.P,
                   "loss_values": {tag: run[0] for tag, run in runs.items()}}
            for a, b in PAIRS:
                row[f"{a}_vs_{b}"] = compare(runs[a][1], runs[b][1])
            print(json.dumps(row), flush=True)
            del runs
            torch.cuda.empty_cache()
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
