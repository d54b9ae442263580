"""How the loaders' host stage scales with workers, threads against
processes (port of the JAX package's ``tools/host_pipeline_bench.py``).

Each batch is a synthetic scan (``data/synthetic.make_batch``, B=1 at
``--points``, voxel 0.1 m) through the loaders' plumbing stage
(``data/loaders.PlumbingStage``: the conv rulebooks and the teacher's
window geometry, capacities P ... P/16), first inline, then through
``data/prefetch.maybe_pipelined`` at each worker count on threads and on
spawned processes (one worker runs inline, as in the loaders).

``inline_ms`` is the stage's ms a batch, called in the consumer's thread;
``pipelined_ms`` holds, for each of ``thread_w{n}`` and ``proc_w{n}``, the
pipeline's wall ms a batch over ``--batches`` (scan generation included,
as in the JAX tool), with ``_min`` and ``_max`` of the gaps between two
batches beside them. The tool is host-only: it never touches a device,
and ``--cpu`` changes nothing. Prints one JSON line with the JAX tool's
keys, the machine's card where it has one (``bench_parts.device_record``)
and ``host_cores``. Writes no file.

Usage: ``python -m u2mkd_tpu_torch.host_pipeline_bench [--points=65536]
[--batches=6] [--workers=1,2,4]``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Iterator, Sequence

import numpy as np
import torch

from u2mkd_tpu_torch.bench_parts import device_record, put_times
from u2mkd_tpu_torch.data import synthetic, wgeom_host
from u2mkd_tpu_torch.data.loaders import PlumbingStage
from u2mkd_tpu_torch.data.prefetch import maybe_pipelined
from u2mkd_tpu_torch.models.spvcnn import teacher_model

VOXEL = 0.1
NOTE = ("host-only: the loader's plumbing stage on this machine's cores, no device work; "
        "a many-core host scales about as 1/workers until memory bandwidth, a 1-core host "
        "stays flat")


def _batches(points: int, n: int) -> Iterator[Dict]:
    for i in range(n):
        yield synthetic.make_batch(np.random.RandomState(i), 1, points, voxel_size=VOXEL)


def run(points: int = 65536, batches: int = 6, workers: Sequence[int] = (1, 2, 4)) -> Dict:
    """The tool's fields (module docstring)."""
    caps = tuple(points >> i for i in range(5))
    model = teacher_model(num_classes=17, cr=1.0, voxel_size=VOXEL, device="cpu")
    stage = PlumbingStage(caps, wgeom_host.params_from_model(model))
    del model
    res: Dict = {"metric": "host_pipeline_ms_per_batch", "P": points, "batches": batches,
                 "host_cores": os.cpu_count()}
    inline = []
    for b in _batches(points, batches):
        t0 = time.perf_counter()
        stage(b)
        inline.append((time.perf_counter() - t0) * 1e3)
    put_times(res, "inline_ms", inline)
    rows: Dict = {}
    for use_proc in (False, True):
        for w in workers:
            key = f"{'proc' if use_proc else 'thread'}_w{w}"
            last = time.perf_counter()
            gaps = []
            for _ in maybe_pipelined(stage, _batches(points, batches), w, enabled=True,
                                     use_processes=use_proc):
                now = time.perf_counter()
                gaps.append((now - last) * 1e3)
                last = now
            put_times(rows, key, gaps)  # the gaps sum to the pipeline's wall time
    res["pipelined_ms"] = rows
    res["note"] = NOTE
    res["device"] = device_record(torch.device("cuda")) if torch.cuda.is_available() else \
        {"platform": "cpu"}
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--points", type=int, default=65536)
    parser.add_argument("--batches", type=int, default=6)
    parser.add_argument("--workers", default="1,2,4", help="worker counts, comma-separated")
    parser.add_argument("--cpu", action="store_true", help="accepted; the tool is host-only")
    args = parser.parse_args(argv)
    res = run(args.points, args.batches, [int(w) for w in args.workers.split(",")])
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
