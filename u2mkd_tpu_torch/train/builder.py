"""Config -> model, optimizer and loader factories (port of
``u2mkd_tpu/train/builder.py``).

The window geometry follows the reference's ``make_model``: window_size =
voxel_size * patch_size * window_cfg, quantized in window / quant_size_scale
steps. The port has models for the conv-only SPVCNN (``spvcnn``), the
SphereFormer teacher (``spvcnn_spformer``) and the stage-2 TSD student
(``spvcnn_swiftnet18_spformer_tsd_full``), with the JAX builder's
attention flags (``model.pallas_attention``, default off: the banded
attention; ``model.pallas_cubic``, default on), and the loaders: the
synthetic dataset's here, the real datasets' in ``data/loaders.py``; each
batch comes with its host plumbing and window geometry (under
``host_plumbing``, on by default), or without, and the steps build it on the
device. ``precision`` (``float32`` or ``bfloat16``) sets the compute policy
(``ops/precision.py``) whenever a model is built.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from u2mkd_tpu_torch.core.device import resolve_device
from u2mkd_tpu_torch.data import loaders, synthetic
from u2mkd_tpu_torch.train import optim, schedulers
from u2mkd_tpu_torch.utils.config import Config

Loader = loaders.Loader


def window_geometry(cfg: Config):
    """-> (window_size, window_size_sphere, quant_size, quant_size_sphere)
    of the first attention level."""
    voxel_size = cfg.dataset.voxel_size
    vs = [voxel_size] * 3 if not isinstance(voxel_size, list) else voxel_size
    patch = np.asarray([v * cfg.model.patch_size for v in vs], np.float32)
    window_size = tuple(float(x) for x in patch * cfg.model.window_size)
    wss = tuple(float(x) for x in cfg.model.window_size_sphere)
    scale = cfg.model.quant_size_scale
    quant = tuple(w / scale for w in window_size)
    quant_sphere = tuple(w / scale for w in wss)
    return window_size, wss, quant, quant_sphere


def make_model(cfg: Config, device: Optional[Union[str, torch.device]] = None,
               seed: int = 0, process_group=None) -> torch.nn.Module:
    """The model ``cfg.model.name`` names, with random weights from
    ``seed``, on ``device`` (CUDA unless asked otherwise); with
    ``process_group`` its BN statistics (a TSD model's student's) are synced
    over the group's ranks (``parallel/mesh.py``)."""
    from u2mkd_tpu_torch.models.spvcnn import SPVCNN
    from u2mkd_tpu_torch.models.tsd import TSDFull
    from u2mkd_tpu_torch.ops.precision import set_compute_dtype

    # both directions, unlike the JAX builder (which sets it only away from
    # float32): a float32 build after a bfloat16 one in a process runs f32
    set_compute_dtype(cfg.get_path("precision", "float32"))
    dev = resolve_device(device)
    name = cfg.model.name
    if name == "spvcnn":
        # the conv-only U-Net takes no window options (JAX builder.py:51-56)
        return SPVCNN(num_classes=cfg.data.num_classes, cr=cfg.model.cr,
                      in_channel=cfg.model.in_channel, sphereformer=False,
                      generator=torch.Generator().manual_seed(seed),
                      process_group=process_group).to(dev)
    ws, wss, qs, qss = window_geometry(cfg)
    common = dict(
        num_classes=cfg.data.num_classes, window_size=ws, window_size_sphere=wss,
        quant_size=qs, quant_size_sphere=qss,
        window_size_scale=tuple(cfg.model.window_size_scale),
        drop_path_rate=cfg.model.drop_path_rate, sphere_a=cfg.model.a,
        head_dim=cfg.model.get("head_dim", 16),
        pallas_attention=cfg.model.get("pallas_attention", False),
        pallas_cubic=cfg.model.get("pallas_cubic", True),
        generator=torch.Generator().manual_seed(seed), process_group=process_group)
    if name == "spvcnn_spformer":
        model = SPVCNN(cr=cfg.model.cr, in_channel=cfg.model.in_channel, **common)
    elif name == "spvcnn_swiftnet18_spformer_tsd_full":
        model = TSDFull(cr=cfg.model.cr, cr_t=cfg.model.cr_t, in_channel=cfg.model.in_channel,
                        in_channel_t=cfg.model.get("in_channel_t", 4),
                        run_pix_decoder=cfg.get_path("eval.run_pix_decoder", True), **common)
    else:
        raise NotImplementedError(f"model {name}: the port has no such model (the JAX "
                                  f"package's builder has none either)")
    return model.to(dev)


def optimizer_spec(cfg: Config, world_size: int = 1) -> Tuple[str, Callable[[int], float], Dict]:
    """-> (optimizer name, lr(step) = cfg.optimizer.lr times the schedule's
    factor, keyword arguments of :func:`optim.make_optimizer`).
    ``world_size`` is the data-parallel world size (1 without data
    parallelism): the cosine schedule's warm-up and iterations per epoch
    follow the global batch, ``batch_size * world_size`` (JAX
    ``builder.py:78-83``)."""
    o = cfg.optimizer
    name = cfg.scheduler.name
    if name == "cosine_warmup":
        sched = schedulers.cosine_schedule_with_warmup(
            cfg.num_epochs, cfg.batch_size, cfg.data.training_size, world_size)
    elif name == "poly":
        # max_iter counts samples, not steps, as the reference builds it
        # (builder.py:740-743): a very shallow decay per step
        sched = schedulers.poly_lr(cfg.num_epochs * cfg.data.training_size,
                                   cfg.scheduler.get("power", 0.9))
    elif name == "none":
        def sched(step):
            return 1.0
    else:
        raise NotImplementedError(name)

    def lr(step: int) -> float:
        return o.lr * sched(step)

    kw = dict(weight_decay=o.weight_decay, momentum=o.get("momentum", 0.9),
              nesterov=o.get("nesterov", True),
              transformer_lr_scale=o.get("transformer_lr_scale", 0.1))
    return o.name, lr, kw


def make_optimizer_and_schedule(cfg: Config, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                                world_size: int = 1):
    """-> (optimizer over ``named_params``, its ``LambdaLR``): the optimizer
    and schedule of ``cfg``."""
    name, lr, kw = optimizer_spec(cfg, world_size)
    return optim.make_optimizer(named_params, name, lr, **kw)


def _check_synthetic(cfg: Config) -> None:
    if cfg.dataset.name != "synthetic":
        raise ValueError(f"dataset {cfg.dataset.name}: the synthetic loaders serve "
                         f"dataset.name=synthetic; make_loaders and make_distill_loaders "
                         f"dispatch on dataset.name")


def _rank_batches(cfg: Config) -> Callable[[int, int], bool]:
    """-> keep(i, n): whether this rank takes batch ``i`` of a synthetic
    stream of ``n``. Every rank draws the whole stream from the same seed;
    under ``train.multihost`` rank r keeps batches r, r + world, ..., n //
    world of them (the real loaders' ``order[rank::world]`` in whole
    batches), else every batch."""
    if not loaders.process_shard(cfg):
        return lambda i, n: True
    from u2mkd_tpu_torch.parallel import mesh

    rank, world = mesh.process_index(), mesh.world_size()
    return lambda i, n: i % world == rank and i < n - n % world


def make_synthetic_loaders(cfg: Config, model: torch.nn.Module,
                           seed: int = 0) -> Tuple[Loader, Loader]:
    """Synthetic train and val loaders of the teacher: callables returning
    iterators over batches (``data/synthetic.make_batch``) on ``model``'s
    device, each with its host plumbing and ``model``'s window geometry
    (without them under ``host_plumbing: false``: the step builds them on
    the device), through the real loaders' pipeline (``data/loaders.py``: the plumbing on
    ``workers`` threads, a prefetch thread that uploads). Val draws from
    ``seed + 1``; n_val = max(2, n_train // 4). Under ``train.multihost``
    each rank keeps every world-th batch of both streams
    (:func:`_rank_batches`)."""
    _check_synthetic(cfg)
    b, p = cfg.batch_size, cfg.dataset.num_points
    n_train = cfg.data.training_size // b
    n_val = max(2, n_train // 4)
    workers, wproc, depth = loaders.pipeline_options(cfg)
    stage, _ = loaders.plumbing_stages(cfg, model)
    keep = _rank_batches(cfg)

    def loader(rng_seed: int, n: int) -> Loader:
        def raw() -> Iterator[Dict]:
            rng = np.random.RandomState(rng_seed)
            for i in range(n):
                batch = synthetic.make_batch(rng, b, p, cfg.dataset.voxel_size)
                if keep(i, n):
                    yield batch

        return lambda: loaders.host_pipeline(stage, raw(), workers, wproc)

    device = next(model.parameters()).device
    return (loaders.device_loader(loader(seed, n_train), device, depth),
            loaders.device_loader(loader(seed + 1, n_val), device, depth))


def make_synthetic_distill_loaders(cfg: Config, model: torch.nn.Module) -> Tuple[Loader, Loader]:
    """Synthetic paired student/teacher loaders of the TSD stage
    (``data/synthetic.make_multimodal_batch``), seeded from
    ``cfg.train.seed``, through the real loaders' pipeline as
    :func:`make_synthetic_loaders`, with ``model``'s plumbing stages
    (``data/loaders.plumbing_stages``: both parts in train, the student's
    in val unless ``debug.debug_val``), each rank's batches as
    :func:`_rank_batches` keeps them."""
    _check_synthetic(cfg)
    b, p, tp = cfg.batch_size, cfg.dataset.num_points, cfg.dataset.teacher_points
    n_train = cfg.data.training_size // b
    n_val = max(2, n_train // 4)
    seed = cfg.train.seed % (2 ** 31)
    workers, wproc, depth = loaders.pipeline_options(cfg)
    train_stage, val_stage = loaders.plumbing_stages(cfg, model)
    keep = _rank_batches(cfg)

    def loader(seed_off: int, n: int, stage) -> Loader:
        def raw() -> Iterator[Dict]:
            rng = np.random.RandomState(seed + seed_off)
            for i in range(n):
                batch = synthetic.make_multimodal_batch(
                    rng, b, p, tp, cfg.dataset.voxel_size, num_cams=cfg.dataset.num_cams,
                    im_hw=tuple(cfg.dataset.image_size))
                if keep(i, n):
                    yield batch

        return lambda: loaders.host_pipeline(stage, raw(), workers, wproc)

    device = next(model.parameters()).device
    return (loaders.device_loader(loader(0, n_train, train_stage), device, depth),
            loaders.device_loader(loader(1, n_val, val_stage), device, depth))


def make_loaders(cfg: Config, model: torch.nn.Module,
                 tta_val: bool = False) -> Tuple[Loader, Loader]:
    """The teacher's train and val loaders, as the JAX package's stage-1
    CLI picks them: the synthetic ones (seeded from ``cfg.train.seed``) for
    ``dataset.name=synthetic``, else ``data/loaders.make_loaders`` (seed 0;
    ``tta_val``: a val set that augments each pass, for TTA votes; the
    synthetic sets have no augmentation)."""
    if cfg.dataset.name == "synthetic":
        return make_synthetic_loaders(cfg, model, seed=cfg.train.seed % (2 ** 31))
    return loaders.make_loaders(cfg, model, tta_val=tta_val)


def make_distill_loaders(cfg: Config, model: torch.nn.Module,
                         tta_val: bool = False) -> Tuple[Loader, Loader]:
    """The stage-2 train and val loaders, as the JAX package's stage-2 CLI
    picks them: the synthetic ones for ``dataset.name=synthetic``, else
    ``data/loaders.make_distill_loaders`` (seed 0; ``tta_val`` as in
    :func:`make_loaders`)."""
    if cfg.dataset.name == "synthetic":
        return make_synthetic_distill_loaders(cfg, model)
    return loaders.make_distill_loaders(cfg, model, tta_val=tta_val)
