"""The reference's models and optimizers from a configuration dict: a
frozen copy of the program's ``train/builder.py`` (``window_geometry``,
``make_model``, ``optimizer_spec``) over the reference's own modules. The
weights are the benchmark's (``port_bench/weights.py``), so the models'
own initialisation is overwritten."""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from port_bench.reference.models.spvcnn import SPVCNN
from port_bench.reference.models.tsd import TSDFull
from port_bench.reference.ops.precision import set_compute_dtype
from port_bench.reference.train import schedulers


def _get(d: Dict, dotted: str, default=None):
    cur = d
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return default
        cur = cur[part]
    return cur


def window_geometry(cfg: Dict):
    """-> (window_size, window_size_sphere, quant_size, quant_size_sphere)
    of the first attention level."""
    voxel_size = cfg["dataset"]["voxel_size"]
    vs = [voxel_size] * 3 if not isinstance(voxel_size, list) else voxel_size
    m = cfg["model"]
    patch = np.asarray([v * m["patch_size"] for v in vs], np.float32)
    window_size = tuple(float(x) for x in patch * m["window_size"])
    wss = tuple(float(x) for x in m["window_size_sphere"])
    scale = m["quant_size_scale"]
    return (window_size, wss, tuple(w / scale for w in window_size),
            tuple(w / scale for w in wss))


def make_model(cfg: Dict, device) -> torch.nn.Module:
    """The model ``cfg['model']['name']`` names, on ``device``."""
    set_compute_dtype(_get(cfg, "precision", "float32"))
    m = cfg["model"]
    ws, wss, qs, qss = window_geometry(cfg)
    common = dict(
        num_classes=cfg["data"]["num_classes"], window_size=ws, window_size_sphere=wss,
        quant_size=qs, quant_size_sphere=qss, window_size_scale=tuple(m["window_size_scale"]),
        drop_path_rate=m["drop_path_rate"], sphere_a=m["a"], head_dim=m.get("head_dim", 16),
        pallas_attention=m.get("pallas_attention", False),
        pallas_cubic=m.get("pallas_cubic", True), generator=torch.Generator().manual_seed(0))
    if m["name"] == "spvcnn_spformer":
        model = SPVCNN(cr=m["cr"], in_channel=m["in_channel"], **common)
    elif m["name"] == "spvcnn_swiftnet18_spformer_tsd_full":
        model = TSDFull(cr=m["cr"], cr_t=m["cr_t"], in_channel=m["in_channel"],
                        in_channel_t=m.get("in_channel_t", 4),
                        run_pix_decoder=_get(cfg, "eval.run_pix_decoder", True), **common)
    else:
        raise NotImplementedError(f"the reference has no model {m['name']}")
    return model.to(device)


def optimizer_spec(cfg: Dict) -> Tuple[str, Callable[[int], float], Dict]:
    """-> (optimizer name, lr(step), keyword arguments of
    ``train/optim.make_optimizer``), one process."""
    o = cfg["optimizer"]
    name = cfg["scheduler"]["name"]
    if name == "cosine_warmup":
        sched = schedulers.cosine_schedule_with_warmup(
            cfg["num_epochs"], cfg["batch_size"], cfg["data"]["training_size"], 1)
    elif name == "poly":
        sched = schedulers.poly_lr(cfg["num_epochs"] * cfg["data"]["training_size"],
                                   cfg["scheduler"].get("power", 0.9))
    elif name == "none":
        def sched(step):
            return 1.0
    else:
        raise NotImplementedError(name)

    def lr(step: int) -> float:
        return o["lr"] * sched(step)

    kw = dict(weight_decay=o["weight_decay"], momentum=o.get("momentum", 0.9),
              nesterov=o.get("nesterov", True),
              transformer_lr_scale=o.get("transformer_lr_scale", 0.1))
    return o["name"], lr, kw
