"""The control of the check that decides ``correct``, and the readings its
limits are set from: each number the cell may compare, for one of three
sides in the program's place, against the reference on the same inputs.

* ``bf16``, the control: the program with its own path one precision below
  the configuration's switched on. The configurations state float32 with
  cuDNN's convolutions in TF32, so the step below is bfloat16, and the
  program has that path of its own (``precision: bfloat16``, its compute
  policy). A limit is sound only where the control fails it.
* ``program``: the program as the configuration states it, the sound
  readings (what a run's set-up reads), many seeds in one process.
* ``nudged``: the reference itself with every weight moved one float32 ulp
  (``weights.nudge``): how far rounding alone carries each number.

    python3 -m port_bench.control --workload CELL --seeds 11,12,13 \
        [--sides bf16,program,nudged]

prints one JSON line per seed and side, on the card at the cell's own size;
``tests/test_bench_control.py`` runs it at a size a test holds.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import os
import sys
from pathlib import Path
from typing import Dict, List

import torch

from port_bench import cells, compare, session

SIDES = ("bf16", "program", "nudged")


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _program_side(cell: cells.Cell, seed: int, device: torch.device, raw: List[Dict]):
    train = cell.mix["kind"] == "train"
    program = session.Program(cell, seed, device, raw)
    if train:
        got = compare.checked_steps(program.call, program.trained, program.optimizer,
                                    int(cell.mix["checked_steps"]))
    else:
        got = {j: {k: v.cpu() for k, v in session._keep_outputs(program.call(j)).items()}
               for j in range(len(raw))}
    del program
    _free(device)
    return got


def side_numbers(cell: cells.Cell, seed: int, device: torch.device,
                 sides=("bf16",)) -> Dict[str, Dict[str, float]]:
    """The cell's numbers on ``seed`` for each of ``sides`` in the
    program's place, each against one run of the reference."""
    train = cell.mix["kind"] == "train"
    steps = int(cell.mix.get("checked_steps", 0))
    raw = session.make_pool(cell, seed, train)
    got = {}
    for side in sides:
        if side == "bf16":
            low = copy.deepcopy(cell)
            low.config["config"]["precision"] = "bfloat16"
            got[side] = _program_side(low, seed, device, raw)
        elif side == "program":
            got[side] = _program_side(cell, seed, device, raw)
        elif side == "nudged":
            nudged = compare.Reference(cell, seed, device, raw,
                                       nudge=session.derived(seed, session.SEED_NUDGE))
            got[side] = nudged.train_readings(steps) if train else {
                j: nudged.request_output(j) for j in range(len(raw))}
            del nudged
            _free(device)
        else:
            raise ValueError(f"no side {side!r}; the sides are {SIDES}")
    ref = compare.Reference(cell, seed, device, raw)
    if train:
        want = ref.train_readings(steps)
        return {side: compare.train_numbers(g, want) for side, g in got.items()}
    return {side: compare.request_numbers(g, ref) for side, g in got.items()}


def control_numbers(cell: cells.Cell, seed: int, device: torch.device) -> Dict[str, float]:
    """The cell's numbers with the program at bfloat16 in its own place."""
    return side_numbers(cell, seed, device, ("bf16",))["bf16"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m port_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sides", default="bf16")
    args = p.parse_args(argv)
    # as in port_bench.run: the stage-2 step's 16 GiB blocks need it
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    root = Path.cwd()
    cell = cells.find(cells.load_benchmark(root), args.workload, root)
    device = torch.device("cuda", 0)
    num = cell.config["numerics"]
    torch.backends.cudnn.allow_tf32 = bool(num["cudnn_allow_tf32"])
    torch.backends.cuda.matmul.allow_tf32 = bool(num["matmul_allow_tf32"])
    for seed in args.seeds.split(","):
        numbers = side_numbers(cell, int(seed), device, args.sides.split(","))
        for side, n in numbers.items():
            print(json.dumps({"workload": args.workload, "seed": int(seed), "side": side,
                              "numbers": n}), flush=True)
        _free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
