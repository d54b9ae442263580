#!/usr/bin/env python3
"""Device time of the port's four main paths, two trees alternately, on one
card.

    python3 compare_trees.py --other DIR [--sync-check]

``DIR`` is the root of another checkout of this repository (for example the
parent commit, unpacked with ``git archive``). Each run is a fresh process
that imports ``chip_smoke`` and the port from its tree and times, with CUDA
events as ``chip_smoke.py`` does, three teacher inference requests, three
teacher train steps, three student requests and three stage-2 train steps
(P, capacities, cameras, seeds and widths of ``chip_smoke.py``). The trees run in the order other, this, this,
other, so that a drift of the card or its host during the call falls on
both. One JSON line per run; the warm numbers are the last two of each
path. ``--sync-check`` also runs one more warm teacher request of this tree
under ``torch.cuda.set_sync_debug_mode("warn")`` and counts the
synchronising calls by source line.
"""

import argparse
import json
import os
import subprocess
import sys


def run_paths(tag, sync_check):
    """Time the paths of the tree in the working directory; print one JSON
    line."""
    import warnings

    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as C
    from u2mkd_tpu_torch.models.spvcnn import teacher_model
    from u2mkd_tpu_torch.models.tsd import tsd_model
    from u2mkd_tpu_torch.ops.kernels import build
    from u2mkd_tpu_torch.train import distill, state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build()
    out = {"tree": tag, "cwd": os.getcwd(), "gpu": C.gpu_line()}
    model = teacher_model(num_classes=C.NUM_CLASSES, cr=1.0, voxel_size=C.VOXEL, head_dim=16,
                          seed=0, device="cuda")
    eval_fn = state.make_eval_step(model, C.CAPS, C.NUM_CLASSES)
    batches = [C.host_batch(s, model)[0] for s in C.SEEDS]
    torch.cuda.synchronize()
    out["teacher_request_ms"] = [C._timed(eval_fn, b)[1] for b in batches]
    if sync_check:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                eval_fn(batches[1])
            finally:
                torch.cuda.set_sync_debug_mode("default")
        sources = {}
        for w in caught:
            key = f"{os.path.relpath(w.filename)}:{w.lineno}"
            sources[key] = sources.get(key, 0) + 1
        out["sync_sources"] = sources
    del model, eval_fn, batches
    model, step_fn = C._train_setup(seed=0, generator_seed=0)
    batches = [C.host_batch(s, model)[0] for s in C.TRAIN_SEEDS]
    torch.cuda.synchronize()
    out["train_step_ms"] = [C._timed(step_fn, b)[1] for b in batches]
    del model, step_fn, batches
    student = tsd_model(num_classes=C.NUM_CLASSES, cr=1.0, cr_t=C.CR_T,
                        voxel_size=C.STUDENT_VOXEL, head_dim=16, seed=0, device="cuda")
    eval_fn = distill.make_distill_eval_step(student, C.STUDENT_CAPS, C.CAPS, C.NUM_CLASSES)
    batches = [C.student_batch(s, student)[0] for s in C.STUDENT_SEEDS]
    torch.cuda.synchronize()
    out["student_request_ms"] = [C._timed(eval_fn, b)[1] for b in batches]
    del student, eval_fn, batches
    student, step_fn = C._student_train_setup(seed=0, generator_seed=0)
    batches = [C.student_batch(s, student, with_teacher=True, num_cams=C.STUDENT_TRAIN_CAMS)[0]
               for s in C.STUDENT_TRAIN_SEEDS]
    torch.cuda.synchronize()
    out["student_train_step_ms"] = [C._timed(step_fn, b)[1] for b in batches]
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of the other tree")
    ap.add_argument("--sync-check", action="store_true")
    ap.add_argument("--tag", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tag:
        run_paths(args.tag, args.sync_check)
        return 0
    if not args.other:
        ap.error("--other DIR is needed")
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(args.other)
    for tag, root in (("other", other), ("this", here), ("this", here), ("other", other)):
        cmd = [sys.executable, os.path.abspath(__file__), "--tag", tag]
        if args.sync_check and tag == "this":
            cmd.append("--sync-check")
        subprocess.run(cmd, cwd=root, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
