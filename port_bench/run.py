"""The benchmark of the PyTorch and CUDA port (``u2mkd_tpu_torch``).

    python3 -m port_bench.run --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout. Runs one cell of ``BENCHMARK.json`` on the
card and prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``compared``: each number that decides
``correct`` beside its limit, which the last lines of standard error repeat.
Exits non-zero, printing no result, without a CUDA device or with fewer
than the cell asks for, or when a module of JAX, flax or the JAX package
is loaded once the window has closed.
"""

from __future__ import annotations

import time

_IMPORTED_AT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

# build and kernel caches at fixed paths inside the checkout
CACHE_DIR = ".port_bench_cache"


def _args(argv: Optional[List[str]]):
    p = argparse.ArgumentParser(prog="python3 -m port_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", required=True, type=int, choices=(0, 1))
    return p.parse_args(argv)


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], check=True, capture_output=True,
                             text=True, timeout=30).stdout.strip().splitlines()
        return out[0] if out else None
    except (OSError, subprocess.SubprocessError):
        return None


def result_line(cell, out: Dict, trace: bool, device_kind: str, count: int) -> Dict:
    """The result's JSON object from a finished run."""
    from port_bench import cells

    ctx = out["ctx"]
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cells.metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_kind, "count": count,
              "memory_peak_bytes": int(out["memory_peak"])}
    res = {"correct": bool(out["correct"]), "attempted": ctx.calls, "failed": 0,
           "metrics": metrics, "device": device}
    if trace and ctx.trace is not None:
        device["busy_s"] = ctx.trace.busy_s
        device["window_s"] = ctx.trace.window_s
        res["breakdown"] = {"device_ops": ctx.trace.top_device_ops(),
                            "idle_gaps": ctx.trace.idle_gaps()}
    res["compared"] = out["compared"]
    return res


def main(argv: Optional[List[str]] = None) -> int:
    args = _args(argv)
    root = Path.cwd()
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / CACHE_DIR / sub)
    # the stage-2 step at its published batch asks for 16 GiB blocks; without
    # expandable segments the caching allocator's fragments refuse them
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"

    import torch

    from port_bench import cells, session

    bench = cells.load_benchmark(root)
    cell = cells.find(bench, args.workload, root)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"port_bench: the cell needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(device)
    print(f"port_bench: {args.workload} seed {args.seed} on {kind} "
          f"({_power_limit()}), torch {torch.__version__}", file=sys.stderr)
    t_start = session.process_start_s() or _IMPORTED_AT
    out = session.run(cell, args.seed, args.seconds, bool(args.trace), device, t_start)
    loaded = session.forbidden_modules()
    if loaded:
        print(f"port_bench: modules of JAX or the JAX package are loaded: {loaded}",
              file=sys.stderr)
        return 4
    res = result_line(cell, out, bool(args.trace), kind, cell.chips)
    ctx = out["ctx"]
    if ctx.latencies_ms:
        lat = sorted(ctx.latencies_ms)
        print(f"port_bench: latency ms median {statistics.median(lat)!r} of {len(lat)} "
              f"untraced requests, the 12 longest {lat[-12:]!r}", file=sys.stderr)
    print(f"port_bench: setup_s {ctx.setup_s!r}, window_s {ctx.window_s!r}, calls {ctx.calls}, "
          f"reference_s {out['reference_s']!r}, set-up {json.dumps(out['setup_parts'])}",
          file=sys.stderr)
    if out["detail"]:
        print(f"port_bench: readings {json.dumps(out['detail'])}", file=sys.stderr)
    print(f"port_bench: numbers {json.dumps(out['numbers'])}", file=sys.stderr)
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
