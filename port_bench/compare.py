"""The check that decides ``correct``: what the timed path produced,
against the plain reference (``port_bench/reference``, plain PyTorch in
IEEE float32, which imports nothing of the program).

Training: the reference follows the program's first steps from the same
weights, batches and dropout seed, building its plumbing itself. Read: the
first step's loss and each step's; the first gradient as the optimizer
took it (from its state after one step); each parameter's change after the
first step and over the checked steps; each BN running statistic's change
after the first step and over the checked steps; the last five by the worst
leaf and by the median leaf. A leaf's gap is the gap between the two
norms over the reference's norm of that leaf or of the median leaf,
whichever is larger. Parameters whose reference gradient is under a
thousandth of the median leaf's move by round-off alone and are left out of
the change. A cell's limits file names the numbers it compares: those its
control or a planted fault separates from sound runs.

Requests: a sample, drawn from the seed, of the requests the window finished;
each one's point logits (and pixel-head logits) against the reference's on
the same scan: each valid point's (for the pixel head, each point in a
camera's view) largest logit gap over the reference's largest logit, by
the median point and the widest.
"""

from __future__ import annotations

import contextlib
import math
import statistics
from typing import Dict, List, Optional

import torch

from port_bench import weights

# leaves whose reference gradient is under this share of the median leaf's
# move by round-off alone
QUIET_LEAF = 1e-3


def optimizer_gradients(opt: torch.optim.Optimizer, named_params) -> Dict[str, float]:
    """Each leaf's norm of the gradient as the optimizer took it, worked out
    from its state after one step: SGD's momentum buffer (the gradient with
    weight decay added), Adam's first moment over (1 - beta1); NaN for a
    leaf without state."""
    out = {}
    for name, p in named_params:
        st = opt.state.get(p, {})
        if st.get("momentum_buffer") is not None:
            out[name] = float(st["momentum_buffer"].double().norm())
        elif "exp_avg" in st:
            beta1 = next(g["betas"][0] for g in opt.param_groups
                         if any(q is p for q in g["params"]))
            out[name] = float(st["exp_avg"].double().norm()) / (1.0 - beta1)
        else:
            out[name] = math.nan
    return out


def checked_steps(step_of, trained: torch.nn.Module, optimizer, steps: int) -> Dict:
    """Drive ``step_of(i)`` through its first ``steps`` steps and read what
    the check compares: each step's loss, each leaf's first gradient as the
    optimizer took it, and each leaf's and each BN running statistic's
    change after the first step and over the steps."""
    params = list(trained.named_parameters())
    theta0 = {n: p.detach().clone() for n, p in params}
    stats0 = {n: b.detach().clone() for n, b in trained.named_buffers() if "running_" in n}

    def change():
        return {n: float((p.detach() - theta0[n]).double().norm()) for n, p in params}

    def stats_change():
        return {n: float((b.detach() - stats0[n]).double().norm())
                for n, b in trained.named_buffers() if n in stats0}

    losses, grads, update1, bn1 = [], None, None, None
    for i in range(steps):
        losses.append(step_of(i)["loss"])
        if i == 0:
            grads = optimizer_gradients(optimizer, params)
            update1, bn1 = change(), stats_change()
    return {"loss": [float(x) for x in losses], "grad": grads, "update1": update1,
            "update": change(), "bn1": bn1, "bn": stats_change()}


def worst_leaf(got: Dict[str, float], ref: Dict[str, float], names: List[str]) -> float:
    """max over ``names`` of |got - ref| / max(ref, the median leaf's ref)."""
    if not names:
        return math.nan
    med = statistics.median(ref[n] for n in names)
    worst = 0.0
    for n in names:
        g = got.get(n, math.nan)
        gap = abs(g - ref[n]) / max(ref[n], med, 1e-30)
        if not math.isfinite(gap):
            return math.inf
        worst = max(worst, gap)
    return worst


def worst_leaves(got: Dict, ref: Dict, n: int = 3) -> Dict[str, List]:
    """For the log: each step's losses, and per leaf family the ``n`` worst
    leaves with their gap, the program's and the reference's norm."""
    out: Dict[str, List] = {"loss": list(zip(got["loss"], ref["loss"]))}
    for key in ("grad", "update1", "update", "bn1", "bn"):
        names = sorted(ref[key])
        med = statistics.median(ref[key][k] for k in names) if names else 0.0
        gaps = [(abs(got[key].get(k, math.nan) - ref[key][k]) / max(ref[key][k], med, 1e-30),
                 k, got[key].get(k), ref[key][k]) for k in names]
        out[key] = sorted(gaps, key=lambda g: -g[0] if math.isfinite(g[0]) else -math.inf)[:n]
    return out


def median_leaf(got: Dict[str, float], ref: Dict[str, float], names: List[str]) -> float:
    """The median over ``names`` of the leaves' gaps (as in
    :func:`worst_leaf`): steady where one leaf's gap swings."""
    if not names:
        return math.nan
    med = statistics.median(ref[n] for n in names)
    gaps = [abs(got.get(n, math.nan) - ref[n]) / max(ref[n], med, 1e-30) for n in names]
    return statistics.median(gaps) if all(map(math.isfinite, gaps)) else math.inf


def train_numbers(got: Dict, ref: Dict) -> Dict[str, float]:
    """Every number a train cell may compare; its limits file says which
    it does."""
    losses = [abs(g - r) / max(abs(r), 1e-30) for g, r in zip(got["loss"], ref["loss"])]
    complete = len(losses) == len(ref["loss"]) and all(map(math.isfinite, losses))
    grad_names = sorted(ref["grad"])
    med = statistics.median(ref["grad"][n] for n in grad_names)
    moving = [n for n in grad_names if ref["grad"][n] >= QUIET_LEAF * med]
    bn_names = sorted(ref["bn"])
    return {"loss1_gap": losses[0] if complete else math.inf,
            "loss_gap": max(losses) if complete else math.inf,
            "grad_gap": worst_leaf(got["grad"], ref["grad"], grad_names),
            "grad_median_gap": median_leaf(got["grad"], ref["grad"], grad_names),
            "update1_gap": worst_leaf(got["update1"], ref["update1"], moving),
            "update_gap": worst_leaf(got["update"], ref["update"], moving),
            "update_median_gap": median_leaf(got["update"], ref["update"], moving),
            "bn1_gap": worst_leaf(got["bn1"], ref["bn1"], bn_names),
            "bn_gap": worst_leaf(got["bn"], ref["bn"], bn_names),
            "bn_median_gap": median_leaf(got["bn"], ref["bn"], bn_names)}


def point_gaps(got: torch.Tensor, ref: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Each row of ``mask``'s largest logit gap over the reference's largest
    logit there."""
    g, r = got.double()[mask], ref.double()[mask]
    return (g - r).abs().max(-1).values / r.abs().max().clamp(min=1e-30)


# (output, rows, statistic over the rows' gaps) -> the number's name. The
# median row: a few rows whose attention windows differ between the host
# geometry (numpy) and the reference's own (torch) by a last bit at a window
# or bin edge read up to ~1e-2 on some scans, so the widest row cannot tell
# bfloat16 from float32: it is read for the log, and no limit compares it.
OUTPUT_NUMBERS = {("logits", "points", "median"): "point_logit_median_gap",
                  ("logits", "points", "max"): "point_logit_gap",
                  ("logits_pix", "view", "median"): "pixel_logit_median_gap"}


def request_numbers(outputs: Dict[int, Dict], ref: "Reference") -> Dict[str, float]:
    """The largest of each number over the sampled requests."""
    numbers: Dict[str, float] = {}
    for j, out in sorted(outputs.items()):
        want = ref.request_output(j % len(ref.raw_pool))
        for (key, rows, stat), name in OUTPUT_NUMBERS.items():
            if key not in out:
                continue
            gaps = point_gaps(out[key].to(want[key].device), want[key], ref.mask_of(j, rows))
            value = float(gaps.median() if stat == "median" else gaps.max()) \
                if gaps.numel() else math.inf
            numbers[name] = max(numbers.get(name, 0.0),
                                value if math.isfinite(value) else math.inf)
    return numbers


@contextlib.contextmanager
def numerics(cudnn_tf32: bool, matmul_tf32: bool):
    """cuDNN's and cuBLAS's TF32 switches set inside, restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        cudnn_tf32, matmul_tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class Reference:
    """The plain reference of one cell on the run's inputs: the same
    weights (``weights.fill`` from the run's seed), the raw pool batches
    (its plumbing built by itself on the device), the same dropout seed.
    It computes in the configuration's stated numerics (its ``numerics``:
    cuDNN's convolutions in TF32 where the configuration says so, every
    other product in IEEE f32).
    ``nudge`` (a seed) moves every weight by one float32 ulp, up or down
    (``weights.nudge``): a witness of what rounding alone does.
    ``count_flops`` counts each call's useful FLOPs: every product torch
    runs in it (``FlopCounterMode``: the sparse convs over valid pairs only,
    the dense layers, the image convolutions) and the window attention's
    (query, key) pairs (``roofline.attn_useful_flops``)."""

    def __init__(self, cell, seed: int, device: torch.device, raw_pool: List[Dict],
                 count_flops: bool = False, nudge: Optional[int] = None):
        from port_bench import session
        from port_bench.reference import build

        self.cell, self.seed, self.device = cell, seed, device
        self.raw_pool = raw_pool
        self.count_flops = count_flops
        self.cfg = cell.config["config"]
        self.stage2 = session._is_stage2(self.cfg)
        self.flops: Dict[int, float] = {}
        self._outputs: Dict[int, Dict] = {}
        num = cell.config["numerics"]
        self.numerics = (bool(num["cudnn_allow_tf32"]), bool(num["matmul_allow_tf32"]))
        self.model = build.make_model(self.cfg, device)
        weights.fill(self.model, session.derived(seed, session.SEED_WEIGHTS))
        if nudge is not None:
            weights.nudge(self.model, nudge)
        self._session = session

    @contextlib.contextmanager
    def _counted(self, key: int):
        if not self.count_flops:
            with numerics(*self.numerics):
                yield
            return
        from torch.utils.flop_counter import FlopCounterMode

        from port_bench import roofline
        from port_bench.reference.ops.kernels import wattn_kernel

        pairs: List = []
        token = wattn_kernel.PAIR_LOG.set(pairs)
        counter = FlopCounterMode(display=False)
        try:
            with numerics(*self.numerics), counter:
                yield
        finally:
            wattn_kernel.PAIR_LOG.reset(token)
        attn = sum(roofline.attn_useful_flops(float(p), h, d, train) for p, h, d, train in pairs)
        self.flops[key] = float(counter.get_total_flops()) + attn

    def train_readings(self, steps: int) -> Dict:
        from port_bench.reference.train import distill, optim, state

        s, cfg, model = self._session, self.cfg, self.model
        gen_ = torch.Generator(device=self.device).manual_seed(
            s.derived(self.seed, s.SEED_DROPOUT))
        from port_bench.reference import build

        name, lr, kw = build.optimizer_spec(cfg)
        s_caps, t_caps = s._caps(cfg)
        ignore = cfg["data"]["ignore_label"]
        if self.stage2:
            opt, sched = distill.make_frozen_teacher_optimizer(model, name, lr, **kw)
            crit = cfg["criterion"]
            fn = distill.make_distill_train_step(
                model, opt, s_caps, t_caps, w_kl=crit.get("w_kl", 1.0),
                w_feat=crit.get("w_feat", 1.0), ignore_label=ignore,
                mse_norm_feat=crit.get("mse_norm_feat", False), scheduler=sched, generator=gen_)
            trained = model.model_s
        else:
            opt, sched = optim.make_optimizer(model.named_parameters(), name, lr, **kw)
            fn = state.make_train_step(model, opt, t_caps, ignore_label=ignore, scheduler=sched,
                                       generator=gen_)
            trained = model

        def step_of(i):
            with self._counted(i):
                out = fn(self.raw_pool[i % len(self.raw_pool)])
                s.sync(self.device)
            return out

        return checked_steps(step_of, trained, opt, steps)

    def request_output(self, scan: int) -> Dict:
        """The reference's outputs on pool scan ``scan``."""
        if scan not in self._outputs:
            from port_bench.reference.train import distill, state

            cfg = self.cfg
            s_caps, t_caps = self._session._caps(cfg)
            nc, ignore = cfg["data"]["num_classes"], cfg["data"]["ignore_label"]
            if self.stage2:
                fn = distill.make_distill_eval_step(self.model, s_caps, t_caps, nc, ignore,
                                                    run_teacher=False)
            else:
                fn = state.make_eval_step(self.model, t_caps, nc, ignore)
            with self._counted(scan):
                out = fn(self.raw_pool[scan])
                self._session.sync(self.device)
            self._outputs[scan] = {k: out[k] for k in ("logits", "logits_pix") if k in out}
        return self._outputs[scan]

    def mask_of(self, j: int, rows: str) -> torch.Tensor:
        """Call ``j``'s valid ``points``, or those in a camera's ``view``."""
        raw = self.raw_pool[j % len(self.raw_pool)]
        part = raw["student"] if self.stage2 else raw
        mask = torch.as_tensor(part["pmask"])
        if rows == "view":
            mask = mask & torch.as_tensor(part["fov_mask"])
        return mask.to(self.device)

    def flops_per_batch(self) -> List[Optional[float]]:
        """Each pool batch's counted FLOPs (every scan of a request pool is
        evaluated now where the sample left it out)."""
        if self.cell.mix["kind"] == "request":
            for scan in range(len(self.raw_pool)):
                self.request_output(scan)
        return [self.flops.get(k) for k in range(len(self.raw_pool))]
