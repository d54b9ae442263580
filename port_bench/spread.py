"""Runs of one cell on several seeds, one process after another, and the
spread of each metric: how the bounds in ``BENCHMARK.json`` are measured.

    python3 -m port_bench.spread --workload CELL --seeds 11,12,13 --seconds S \
        --trace 0|1 --out FILE.jsonl

Each run's result line (or its failure) goes to ``FILE.jsonl`` with the
seed, the exit code and the end of standard error; the summary gives per
metric the values, the median and the spread: the distance between the
first and the third quartile (``statistics.quantiles(values, n=4)``) as a
share of the median, and each compared number's largest reading.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from typing import Dict, List


def spread(values: List[float]) -> float:
    if len(values) < 2:
        return float("nan")
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(statistics.median(values))


def summary(rows: List[Dict]) -> Dict:
    metrics: Dict[str, List[float]] = {}
    compared: Dict[str, List[float]] = {}
    for row in rows:
        res = row.get("result")
        if not res:
            continue
        for name, m in res["metrics"].items():
            metrics.setdefault(name, []).append(m["value"])
        for name, c in res.get("compared", {}).items():
            compared.setdefault(name, []).append(c["value"])
    return {"runs": len(rows), "correct": [r.get("result", {}).get("correct") for r in rows],
            "metrics": {k: {"values": v, "median": statistics.median(v), "spread": spread(v)}
                        for k, v in metrics.items()},
            "compared_max": {k: max(v) for k, v in compared.items()},
            "compared": compared}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m port_bench.spread")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", required=True)
    p.add_argument("--trace", default="0")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    rows = []
    for seed in args.seeds.split(","):
        t0 = time.time()
        proc = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", args.workload,
                               "--seed", seed, "--seconds", args.seconds, "--trace", args.trace],
                              capture_output=True, text=True)
        row = {"workload": args.workload, "seed": int(seed), "trace": int(args.trace),
               "rc": proc.returncode, "wall_s": time.time() - t0, "stderr": proc.stderr[-3000:]}
        lines = proc.stdout.strip().splitlines()
        if proc.returncode == 0 and lines:
            row["result"] = json.loads(lines[-1])
        rows.append(row)
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps({k: row[k] for k in ("seed", "rc", "wall_s")}
                         | {"result": row.get("result")}), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr, flush=True)
    print(json.dumps(summary(rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
