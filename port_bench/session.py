"""One run of one cell: set-up, the measured window, the check of what the
timed path produced against the plain reference, and the result.

Two kinds of traffic (the mix's ``kind``):

* ``train``: the program's train step (``train/state.make_train_step``,
  or for a stage-2 model ``train/distill.make_distill_train_step``) over a
  pool of distinct batches, one caller issuing steps back to back. Set-up
  builds the step once, drives it through its first ``checked_steps``
  steps, each on another pool batch, and hands the same step to the window.
* ``request``: the program's eval step (the deployed model's request), one
  caller issuing requests back to back, as an on-vehicle loop takes the
  newest sweep whenever it is free; each request is timed from its issue
  to its ``synchronize()``, and a sample of them, drawn from the seed as
  the window runs (a reservoir), is kept for the check.

Every call gets a fresh device copy of its pool batch, so that no program
can tell a batch it has seen. A mix with ``"scenes": "fixed"`` gives every
seed the same scenes (a library drawn from a fixed seed) in another order,
with its own point intensities and images, so that the seed changes the
inputs and the weights but not the amount of work. The program's host
plumbing runs in set-up and the pool is uploaded once. With ``trace`` a few
calls in the middle of the window run under ``torch.profiler`` with the
kernel launches counted.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench import cells, compare, gen, roofline, weights
from port_bench.trace import CALL, TRACED, LaunchLog, Trace, recording

SEED_DATA, SEED_WEIGHTS, SEED_DROPOUT, SEED_SAMPLE, SEED_NUDGE = range(5)
# the seed a "scenes": "fixed" mix draws its scene library from
SCENE_LIBRARY = 0
FORBIDDEN = ("jax", "jaxlib", "flax", "u2mkd_tpu")


def derived(seed: int, what: int) -> int:
    """A 63-bit seed for ``what`` from the run's seed."""
    state = np.random.SeedSequence([int(seed) % 2 ** 64, what]).generate_state(2, np.uint64)
    return int(state[0]) & (2 ** 63 - 1)


def rng_of(seed: int, what: int) -> np.random.RandomState:
    return np.random.RandomState(
        np.random.SeedSequence([int(seed) % 2 ** 64, what]).generate_state(8))


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def clone(tree):
    """A fresh copy of every tensor of a batch (nested dicts, lists)."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone(v) for v in tree)
    return tree


@dataclass
class RunContext:
    """What the metric readers (``metrics/<name>.py``) read."""

    kind: str
    batch_size: int
    compute_dtype: torch.dtype
    setup_s: float = 0.0
    window_s: float = 0.0
    calls: int = 0
    latencies_ms: List[float] = field(default_factory=list)
    dispatch_ms: List[float] = field(default_factory=list)
    peak_window_bytes: Optional[int] = None
    trace: Optional[Trace] = None
    launches: Optional[Dict[str, List[Dict]]] = None
    traced_calls: List[int] = field(default_factory=list)
    traced_flops: Optional[float] = None
    peaks: Optional[Dict[str, float]] = None


def _program_config(cfg: Dict):
    from u2mkd_tpu_torch.utils.config import Config

    return Config._wrap(cfg)


def _is_stage2(cfg: Dict) -> bool:
    return cfg["model"]["name"] == "spvcnn_swiftnet18_spformer_tsd_full"


def _cams_hw(cell: cells.Cell, train: bool):
    ds = cell.config["config"]["dataset"]
    cams = int(cell.mix["cams"]) - (int(ds.get("im_drop", 0)) if train else 0)
    h, w = cell.config["camera_hw"]
    return cams, (int(h * ds["im_cr"]), int(w * ds["im_cr"]))


def make_pool(cell: cells.Cell, seed: int, train: bool) -> List[Dict]:
    """The pool's raw batches (numpy), drawn from ``seed``."""
    cfg = cell.config["config"]
    ds = cfg["dataset"]
    fixed = cell.mix.get("scenes") == "fixed"
    rng = rng_of(SCENE_LIBRARY if fixed else seed, SEED_DATA)
    b = int(cell.mix["batch_size"])
    pool = []
    for _ in range(int(cell.mix["pool"])):
        if _is_stage2(cfg):
            cams, hw = _cams_hw(cell, train)
            raw = gen.make_multimodal_batch(rng, b, ds["num_points_student"], ds["num_points"],
                                            ds["voxel_size"], num_cams=cams, im_hw=hw)
            if not train:
                raw = {"student": raw["student"]}
        else:
            raw = gen.make_batch(rng, b, ds["num_points"], ds["voxel_size"])
        pool.append(raw)
    return _reordered(pool, rng_of(seed, SEED_DATA)) if fixed else pool


def _reordered(pool: List[Dict], rng: np.random.RandomState) -> List[Dict]:
    """The pool's scans shuffled over its batches' rows (every array of a
    raw batch has the batch on its first axis), each valid point's
    intensity and each camera image drawn anew from ``rng``."""
    def leaves(tree, path=()):
        for k, v in tree.items():
            yield from leaves(v, path + (k,)) if isinstance(v, dict) else [(path + (k,), v)]

    def nodes(tree):
        yield tree
        for v in tree.values():
            if isinstance(v, dict):
                yield from nodes(v)

    flat = [dict(leaves(raw)) for raw in pool]
    b = len(next(v for p, v in flat[0].items() if p[-1] == "pmask"))
    order = rng.permutation(len(pool) * b)
    out = [{} for _ in pool]
    for path in flat[0]:
        whole = np.concatenate([f[path] for f in flat])[order]
        for k, raw in enumerate(out):
            node = raw
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = whole[k * b:(k + 1) * b]
    for raw in out:
        for node in nodes(raw):
            if "feats" in node:
                node["feats"][..., 3] = np.where(node["pmask"], rng.rand(*node["pmask"].shape), 0)
            if "images" in node:
                node["images"] = rng.rand(*node["images"].shape).astype(node["images"].dtype)
    return out


def _caps(cfg: Dict):
    """(student capacities or None, the teacher's or the model's)."""
    t = cfg.get("teacher_capacities") or cfg["capacities"]
    return (cfg.get("student_capacities"), t) if _is_stage2(cfg) else (None, t)


class Program:
    """The system under test: its model, step and device pool."""

    def __init__(self, cell: cells.Cell, seed: int, device: torch.device, raw_pool: List[Dict],
                 fault: Optional[str] = None):
        from u2mkd_tpu_torch.data import loaders, plumbing_host, wgeom_host
        from u2mkd_tpu_torch.train import builder, distill, optim, state

        self.kind = cell.mix["kind"]
        self.device = device
        self.fault = fault
        cfg_d = cell.config["config"]
        cfg = _program_config(cfg_d)
        self.stage2 = _is_stage2(cfg_d)
        s_caps, t_caps = _caps(cfg_d)
        model = builder.make_model(cfg, device, seed=0)
        weights.fill(model, derived(seed, SEED_WEIGHTS))
        self.model = model
        ignore = cfg.data.ignore_label
        if self.kind == "train":
            gen_ = torch.Generator(device=device).manual_seed(derived(seed, SEED_DROPOUT))
            name, lr, kw = builder.optimizer_spec(cfg)
            if self.stage2:
                opt, sched = distill.make_frozen_teacher_optimizer(model, name, lr, **kw)
                crit = cfg.criterion
                self.fn = distill.make_distill_train_step(
                    model, opt, s_caps, t_caps, w_kl=crit.get("w_kl", 1.0),
                    w_feat=crit.get("w_feat", 1.0), ignore_label=ignore,
                    mse_norm_feat=crit.get("mse_norm_feat", False), scheduler=sched,
                    generator=gen_)
                self.trained = model.model_s
            else:
                opt, sched = optim.make_optimizer(model.named_parameters(), name, lr, **kw)
                self.fn = state.make_train_step(model, opt, t_caps, ignore_label=ignore,
                                                scheduler=sched, generator=gen_)
                self.trained = model
            self.optimizer = opt
            if fault == "unchanged_state":
                opt.step = lambda *a, **k: None
        elif self.stage2:
            self.fn = distill.make_distill_eval_step(model, s_caps, t_caps,
                                                     cfg.data.num_classes, ignore,
                                                     run_teacher=False)
        else:
            self.fn = state.make_eval_step(model, t_caps, cfg.data.num_classes, ignore)
        self.pool = []
        for raw in raw_pool:
            if self.stage2:
                batch = {k: v for k, v in raw.items()}
                parts = [("student", s_caps, model.model_s)]
                if "teacher" in raw:
                    parts.append(("teacher", t_caps, model.model_t))
                for part, caps, sub in parts:
                    p = dict(raw[part])
                    p["plumbing"] = plumbing_host.batch_plumbing(
                        p["pcoords"], p["xyz"], p["pmask"], caps,
                        wgeom_params=wgeom_host.params_from_model(sub))
                    batch[part] = p
            else:
                batch = dict(raw)
                batch["plumbing"] = plumbing_host.batch_plumbing(
                    raw["pcoords"], raw["xyz"], raw["pmask"], t_caps,
                    wgeom_params=wgeom_host.params_from_model(model))
            self.pool.append(loaders.to_device(batch, device))
        sync(device)

    def call(self, i: int):
        """Call ``i``: the step or request on a fresh copy of pool batch
        ``i mod len(pool)``."""
        batch = clone(self.pool[i % len(self.pool)])
        if self.fault == "half_batch":
            part = batch["student"] if self.stage2 else batch
            part["pmask"][part["pmask"].shape[0] // 2:] = False
        out = self.fn(batch)
        if self.fault == "altered_answer":
            out["logits"] = out["logits"].roll(1, -1)
        return out


def process_start_s() -> Optional[float]:
    """The process's start on ``time.time()``'s clock (Linux), or None."""
    try:
        import os

        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def _profile_warm(device: torch.device) -> None:
    """Start the profiler once in set-up, so its own start costs the window
    nothing."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts):
        (torch.ones(8, device=device) * 2).sum().item()


def _traced(program: Program, first: int, count: int, ctx: RunContext, timed):
    """Calls first .. first+count-1 under the profiler, launches counted ->
    the profiler, read once the window has closed."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if program.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    log = LaunchLog()
    with recording(log), profile(activities=acts) as prof:
        with record_function(TRACED):
            for i in range(first, first + count):
                with record_function(CALL):
                    timed(i)
                    sync(program.device)
    ctx.launches = log.launches
    ctx.traced_calls = list(range(first, first + count))
    return prof


def _train_window(program: Program, ctx: RunContext, first: int, seconds: float,
                  traced_at: float, n_traced: int, timed) -> int:
    """Steps back to back for ``seconds``, then a ``synchronize()``; the
    traced steps at ``traced_at``. -> the next call's index."""
    w0 = time.perf_counter()
    i = first
    while time.perf_counter() - w0 < seconds:
        if time.perf_counter() - w0 >= traced_at and ctx.trace is None:
            ctx.trace = _traced(program, i, n_traced, ctx, timed)
            i += n_traced
            continue
        timed(i)
        i += 1
    sync(program.device)
    ctx.window_s = time.perf_counter() - w0
    return i


def _request_window(program: Program, ctx: RunContext, first: int, seconds: float,
                    traced_at: float, n_traced: int, timed, rng: np.random.RandomState,
                    sampled: int, kept: Dict) -> int:
    """Requests back to back for ``seconds``, each timed from its issue to
    its ``synchronize()``; the outputs of ``sampled`` of them kept, a
    uniform sample of all the window finished, drawn from ``rng`` as it
    runs; the traced requests at ``traced_at``. -> the next call's index."""
    device = program.device
    served = 0

    def serve(j: int, traced: bool = False) -> None:
        nonlocal served
        t = time.perf_counter()
        out = timed(j)
        sync(device)
        if not traced:
            ctx.latencies_ms.append((time.perf_counter() - t) * 1e3)
        served += 1
        if len(kept) < sampled:
            kept[j] = out
        else:
            slot = rng.randint(served)
            if slot < sampled:
                del kept[sorted(kept)[slot]]
                kept[j] = out

    w0 = time.perf_counter()
    j = first
    while time.perf_counter() - w0 < seconds:
        if ctx.trace is None and time.perf_counter() - w0 >= traced_at:
            ctx.trace = _traced(program, j, n_traced, ctx, lambda i: serve(i, traced=True))
            j += n_traced
            continue
        serve(j)
        j += 1
    ctx.window_s = time.perf_counter() - w0
    return j


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, fault: Optional[str] = None) -> Dict:
    """One run -> the run's context for the metric readers, ``correct``,
    each compared number with its limit under ``compared``, the memory
    peak, and for the log the reference's seconds, the readings' detail
    and the set-up's parts."""
    cfg = cell.config["config"]
    train = cell.mix["kind"] == "train"
    dtype = torch.bfloat16 if cfg.get("precision", "float32") == "bfloat16" else torch.float32
    ctx = RunContext(cell.mix["kind"], int(cell.mix["batch_size"]), dtype)
    num = cell.config["numerics"]
    torch.backends.cudnn.allow_tf32 = bool(num["cudnn_allow_tf32"])
    torch.backends.cuda.matmul.allow_tf32 = bool(num["matmul_allow_tf32"])
    if device.type == "cuda":
        from u2mkd_tpu_torch.ops.kernels import build

        build.build()
        ctx.peaks = roofline.peaks(torch.cuda.get_device_name(device))
    parts = {"to_run_s": time.time() - t_start}
    t0 = time.time()
    raw_pool = make_pool(cell, seed, train)
    parts["raw_pool_s"] = time.time() - t0
    program = Program(cell, seed, device, raw_pool, fault)
    parts["program_s"] = time.time() - t0 - parts["raw_pool_s"]
    t0 = time.time()

    def timed(i: int):
        t = time.perf_counter()
        out = program.call(i)
        ctx.dispatch_ms.append((time.perf_counter() - t) * 1e3)
        return out

    if train:
        readings = compare.checked_steps(program.call, program.trained, program.optimizer,
                                         int(cell.mix["checked_steps"]))
        first = int(cell.mix["checked_steps"])
    else:
        for i in range(len(program.pool)):
            program.call(i)
        first = len(program.pool)
    if trace:
        _profile_warm(device)
    sync(device)
    parts["first_calls_s"] = time.time() - t0
    gc.collect()
    setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ctx.setup_s = time.time() - t_start
    ctx.dispatch_ms.clear()
    traced_at = seconds / 2 if trace else math.inf
    n_traced = int(cell.mix["traced_calls"])
    kept: Dict[int, Dict] = {}
    if train:
        last = _train_window(program, ctx, first, seconds, traced_at, n_traced, timed)
    else:
        last = _request_window(program, ctx, first, seconds, traced_at, n_traced, timed,
                               rng_of(seed, SEED_SAMPLE), int(cell.mix["sampled"]), kept)
    ctx.calls = last - first
    if ctx.trace is not None:
        ctx.trace = Trace.from_profiler(ctx.trace, len(ctx.traced_calls))
    if device.type == "cuda":
        ctx.peak_window_bytes = torch.cuda.max_memory_allocated(device)
    memory_peak = max(setup_peak, ctx.peak_window_bytes or 0)
    if ctx.launches is not None:
        ctx.launches = {fam: [dict(x, pairs=float(x["pairs"])) for x in xs]
                        for fam, xs in ctx.launches.items()}
    outputs = {j: _keep_outputs(o) for j, o in kept.items()}
    del kept, program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, once the window has closed and the program is freed
    t_ref = time.perf_counter()
    ref = compare.Reference(cell, seed, device, raw_pool, count_flops=trace)
    detail = None
    if train:
        want = ref.train_readings(int(cell.mix["checked_steps"]))
        numbers = compare.train_numbers(readings, want)
        detail = compare.worst_leaves(readings, want)
    else:
        numbers = compare.request_numbers(outputs, ref)
        detail = {j: compare.request_numbers({j: o}, ref) for j, o in outputs.items()}
    if ctx.trace is not None:
        per_batch = ref.flops_per_batch()
        counted = [per_batch[j % len(raw_pool)] for j in ctx.traced_calls]
        ctx.traced_flops = None if None in counted else sum(counted)
    compared = {k: {"value": numbers.get(k, math.nan), "limit": float(lim)}
                for k, lim in cell.limits.items()}
    correct = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
                  for v in compared.values())
    return {"ctx": ctx, "correct": correct, "compared": compared, "memory_peak": memory_peak,
            "reference_s": time.perf_counter() - t_ref, "detail": detail, "setup_parts": parts,
            "numbers": numbers}


def _keep_outputs(out: Dict) -> Dict:
    return {k: out[k] for k in ("logits", "logits_pix") if k in out}
