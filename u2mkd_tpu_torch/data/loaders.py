"""Dataset -> batched loader glue for the training CLIs.

Port of ``u2mkd_tpu/data/loaders.py``: plain Python iteration with
per-epoch shuffling (one ``RandomState`` per factory, shared by its train
and val loaders, as the JAX package draws it), host-side collation into
padded numpy batches, the host plumbing and window geometry built on a
thread pool (``prefetch.maybe_pipelined``; spawned processes with
``worker_processes``), and a prefetch thread that also uploads each batch to
the model's device (:func:`device_loader`). The window geometry is the
model's (``wgeom_host.params_from_model``), so the factories take the model.

Under ``train.multihost`` (data parallelism, ``parallel/mesh.py``) every
rank draws the same shuffled order and keeps its own slice of it
(:func:`process_shard`), and feeds its own device: one shard a process
(:func:`dp_shard_count`).

torch is imported only inside the upload, so that a spawned plumbing worker,
which imports this module to unpickle :class:`PlumbingStage`, loads no torch.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, Iterator

import numpy as np

from u2mkd_tpu_torch.data import plumbing_host, wgeom_host
from u2mkd_tpu_torch.data.prefetch import maybe_pipelined, prefetched_loader

# batch keys that stay on the host: per-sample metadata (ragged devoxelize
# info, string tokens) that only the host-side raw-point scoring reads
HOST_LOCAL_KEYS = ("infos", "lidar_tokens")

Loader = Callable[[], Iterator[Dict]]


def _maybe_inst_augmenter(cfg, dataset_kind: str):
    d = cfg.dataset
    if not d.get("inst_aug"):
        return None
    from u2mkd_tpu_torch.data.instaug import InstAugmentation

    if dataset_kind == "nusc":
        return InstAugmentation(
            instance_pkl_path=d.inst_pkl_path,
            thing_list=list(range(1, 11)), ground_list=[11, 12, 13],
            pair_list=[[11]] * 6 + [[11, 12, 13], [11, 12, 13], [11], [11]],
            add_num=d.inst_add_num, num_classes=cfg.data.num_classes,
            class_name=["barrier", "bicycle", "bus", "car",
                        "construction_vehicle", "motorcycle", "pedestrian",
                        "traffic_cone", "trailer", "truck"],
            class_weight=[0, 60272, 2561, 8091, 156414, 6908, 3036, 35011,
                          13188, 14186, 41250],
            class_min_num=[10, 10, 100, 100, 100, 10, 10, 10, 100, 100],
            feat_dim=4, feat_dim_s=5,
        )
    from u2mkd_tpu_torch.data.semantic_kitti import (
        KITTI_CLASS_NAME, KITTI_GROUND_LIST, KITTI_PAIR_LIST, KITTI_THING_LIST,
    )

    return InstAugmentation(
        instance_pkl_path=d.inst_pkl_path, thing_list=KITTI_THING_LIST,
        ground_list=KITTI_GROUND_LIST, pair_list=KITTI_PAIR_LIST,
        add_num=d.inst_add_num, num_classes=cfg.data.num_classes,
        class_name=KITTI_CLASS_NAME,
        class_weight=[0, 115689, 2979, 2315, 2402, 5988, 4545, 916, 479],
        class_min_num=[300, 50, 50, 300, 300, 25, 25, 25],
        feat_dim=4, feat_dim_s=4,
    )


class PlumbingStage:
    """Picklable plumbing stage of the loaders (thread or process pool
    workers, ``prefetch.maybe_pipelined``): the conv rulebooks, point maps
    and window geometry of one padded feed, or, for TSD, of each part
    (``tsd_caps``: {part: caps}; ``wgeom_params``: {part: params}), the
    parts built concurrently. Its state is plain config data, so spawned
    workers reconstruct it cheaply; it returns numpy arrays only."""

    def __init__(self, caps, wgeom_params=None, tsd_caps=None, concurrent_feeds=True):
        self.caps = caps                  # uni-modal: one cap tuple
        self.tsd_caps = tsd_caps          # TSD: {"student": caps, "teacher": caps}
        self.wgeom_params = wgeom_params  # uni-modal: one spec; TSD: {part: spec}
        self.concurrent_feeds = concurrent_feeds

    def _one(self, sub, caps, wgeom_params):
        return plumbing_host.batch_plumbing(sub["pcoords"], sub["xyz"], sub["pmask"], caps,
                                            wgeom_params=wgeom_params)

    def __call__(self, batch):
        if self.tsd_caps is None:
            batch["plumbing"] = self._one(batch, self.caps, self.wgeom_params)
            return batch
        params = self.wgeom_params or {}
        items = [(k, c, params.get(k)) for k, c in self.tsd_caps.items()]
        if self.concurrent_feeds and len(items) > 1:
            # the student/teacher builds are independent; overlap them
            # (the native builders release the GIL)
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=len(items)) as ex:
                futs = {k: ex.submit(self._one, batch[k], c, p) for k, c, p in items}
            for k, f in futs.items():
                batch[k]["plumbing"] = f.result()
        else:
            for k, c, p in items:
                batch[k]["plumbing"] = self._one(batch[k], c, p)
        return batch


def _epoch_iter(ds, batch_size, collate_fn, shuffle, rng, stage=None, workers=0,
                worker_processes=False, shard=False) -> Iterator[Dict]:
    """One epoch of host batches: the order (shuffled from ``rng``), with
    ``shard`` this rank's slice of it (``mesh.local_batch_indices``), each
    batch fetched and collated serially (the datasets' augmentation shares
    one RandomState per dataset), then ``stage`` (the plumbing) on the
    loaders' pipeline."""
    order = np.arange(len(ds))
    if shuffle:
        rng.shuffle(order)
    if shard:
        from u2mkd_tpu_torch.parallel import mesh

        order = mesh.local_batch_indices(len(order), order)
    n_batches = len(order) // batch_size

    def raw_batches():
        for bi in range(n_batches):
            idxs = order[bi * batch_size:(bi + 1) * batch_size]
            yield collate_fn([ds[int(i)] for i in idxs])

    yield from host_pipeline(stage, raw_batches(), workers, worker_processes)


def _identity(batch):
    return batch


def host_pipeline(stage, raw: Iterable[Dict], workers: int,
                  worker_processes: bool = False) -> Iterator[Dict]:
    """``stage`` (a :class:`PlumbingStage`, or None for none) over the host
    batches ``raw``, in order: on ``workers`` threads, or spawned processes
    with ``worker_processes``, when there is a stage and ``workers > 1``,
    else inline (``prefetch.maybe_pipelined``, the one policy of every
    loader family)."""
    return maybe_pipelined(stage if stage is not None else _identity, raw, workers,
                           enabled=stage is not None, use_processes=worker_processes)


def to_device(batch, device):
    """The counterpart of the JAX package's ``parallel.mesh.to_local_device``:
    every numpy array of ``batch`` (nested dicts, lists and tuples) as a
    tensor on ``device``, except the ``HOST_LOCAL_KEYS`` subtrees, which stay
    numpy and Python. On the CPU the tensors share the arrays' memory. A
    copy to the card is queued on the caller's current stream."""
    import torch

    def walk(x):
        if isinstance(x, dict):
            return {k: v if k in HOST_LOCAL_KEYS else walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        if isinstance(x, np.ndarray):
            return torch.as_tensor(np.ascontiguousarray(x)).to(device, non_blocking=True)
        return x

    return walk(batch)


def _tensors(x) -> Iterator:
    if isinstance(x, dict):
        for k, v in x.items():
            if k not in HOST_LOCAL_KEYS:
                yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif hasattr(x, "record_stream"):
        yield x


class _Upload:
    """:func:`to_device` on a stream of its own, called where the batch is
    built (the prefetch thread), and the hand-over to the thread that runs
    the step (:meth:`ready`): that thread's stream waits for the copies'
    event, and each tensor is recorded as used on it, so that the caching
    allocator does not hand its memory to the next upload while the step may
    still read it."""

    def __init__(self, device):
        import torch

        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def __call__(self, batch):
        if self.stream is None:
            return to_device(batch, self.device), None
        import torch

        with torch.cuda.stream(self.stream):
            out = to_device(batch, self.device)
            done = torch.cuda.Event()
            done.record(self.stream)
        return out, done

    def ready(self, item):
        batch, done = item
        if done is not None:
            import torch

            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in _tensors(batch):
                t.record_stream(stream)
        return batch


def device_loader(loader_fn: Callable[[], Iterable[Dict]], device, depth: int = 2) -> Loader:
    """Wrap a host-batch loader factory: each epoch's batches are built and
    uploaded to ``device`` on a prefetch thread, ``depth`` of them ready
    ahead of the consumer (``prefetch.prefetched_loader``). ``depth`` 0
    builds and uploads each batch in the consumer's thread, serially.
    Closing the returned iterator stops the prefetch thread and the plumbing
    pool behind it."""
    upload = _Upload(device)

    def uploaded():
        it = iter(loader_fn())
        try:
            for batch in it:
                yield upload(batch)
        finally:
            close = getattr(it, "close", None)  # a generator's; a plain iterator has none
            if close is not None:
                close()

    source = prefetched_loader(uploaded, depth) if depth > 0 else uploaded

    def wrapped():
        with contextlib.closing(source()) as it:
            for item in it:
                yield upload.ready(item)

    return wrapped


def _model_device(model):
    return next(model.parameters()).device


def dp_shard_count(cfg) -> int:
    """The data-parallel shards one process's batch is split into: 1, since
    each rank feeds its own device, so the window geometry's leading shard
    dimension is the rank's own (in JAX one process may feed several local
    devices). A multi-process run that is not data parallel
    (``mesh.use_data_parallel`` false: the batch does not divide by the
    world size) raises: JAX runs it through GSPMD, which has no counterpart
    here, and the port does not run it unsynced."""
    from u2mkd_tpu_torch.parallel import mesh

    n = mesh.world_size()
    if n > 1 and not mesh.use_data_parallel(cfg):
        raise ValueError(f"{n} processes, batch_size {cfg.batch_size}: not data parallel "
                         f"(the batch must divide by the world size); set batch_size to a "
                         f"multiple of {n} or run one process")
    return 1


def process_shard(cfg) -> bool:
    """Whether each rank keeps its own slice of every epoch
    (``train.multihost``, which the CLIs' ``--multihost`` sets), after
    checking that the run is data parallel (:func:`dp_shard_count`)."""
    if not cfg.get_path("train.multihost", False):
        return False
    dp_shard_count(cfg)
    return True


def pipeline_options(cfg):
    """(workers, worker_processes, prefetch depth) of ``cfg``."""
    return (int(cfg.get_path("workers", 4)), bool(cfg.get_path("worker_processes", False)),
            int(cfg.get_path("prefetch_depth", 2)))


def plumbing_stages(cfg, model):
    """-> (train stage, val stage): the :class:`PlumbingStage`s of
    ``model``'s batches (None for both without ``host_plumbing``, whose
    steps then build the plumbing themselves). A TSD model's train batches
    carry both parts' plumbing and window geometry (``model.model_s``'s and
    ``model.model_t``'s); its val batches the student's, and the teacher's
    only with ``debug.debug_val``, as the eval step reads the teacher only
    then (reference ``train_lc_nusc_tsd_full.py:96-121``)."""
    if not cfg.get_path("host_plumbing", True):
        return None, None
    if not hasattr(model, "model_t"):
        stage = PlumbingStage(tuple(cfg.capacities), wgeom_host.params_from_model(model))
        return stage, stage
    caps = {"student": tuple(cfg.get_path("student_capacities") or cfg.capacities),
            "teacher": tuple(cfg.get_path("teacher_capacities") or cfg.capacities)}
    params = {"student": wgeom_host.params_from_model(model.model_s),
              "teacher": wgeom_host.params_from_model(model.model_t)}
    train = PlumbingStage(None, params, tsd_caps=caps)
    if cfg.get_path("debug.debug_val", False):
        return train, train
    return train, PlumbingStage(None, params, tsd_caps={"student": caps["student"]})


def make_loaders(cfg, model, seed: int = 0, tta_val: bool = False):
    """Uni-modal loaders (``semantic_nusc`` / ``semantic_kitti`` /
    ``semantic_waymo``) of the teacher ``model``: callables returning an
    iterator over batches on the model's device, each with its host
    plumbing and the model's window geometry (``host_plumbing``, on by
    default).

    ``tta_val=True`` builds the val dataset with per-pass augmentation so
    each vote of a multi-vote evaluation sees a freshly augmented copy with
    a fixed sample order (reference ``nusc_trainers.py:441-550``)."""
    name = cfg.dataset.name
    d = cfg.dataset
    cap = int(cfg.capacities[0])
    if name == "semantic_nusc":
        from u2mkd_tpu_torch.data.semantic_nusc import SemanticNusc

        def build(split):
            return SemanticNusc(
                d.root, d.voxel_size, cap, d.get("version", "v1.0-trainval"),
                split, num_sweeps=d.multisweeps.num_sweeps,
                only_past=d.multisweeps.only_past, flip_aug=d.flip_aug,
                rotate_aug=d.rotate_aug, translate_std=d.get("translate_std"),
                inst_augmenter=_maybe_inst_augmenter(cfg, "nusc") if split == "train" else None,
                seed=seed,
                allow_unofficial_split=d.get("allow_unofficial_split", False),
                tta=tta_val and split == "val",
            )
    elif name == "semantic_kitti":
        from u2mkd_tpu_torch.data.semantic_kitti import SemanticKITTI

        def build(split):
            return SemanticKITTI(
                d.root, d.voxel_size, cap, split,
                num_sweeps=d.multisweeps.num_sweeps, flip_aug=d.flip_aug,
                rotate_aug=d.rotate_aug, translate_std=d.get("translate_std"),
                inst_augmenter=_maybe_inst_augmenter(cfg, "kitti") if split == "train" else None,
                seed=seed,
                tta=tta_val and split == "val",
            )
    elif name == "semantic_waymo":
        from u2mkd_tpu_torch.data.waymo import WaymoSeg

        if d.get("inst_aug"):
            # the reference never shipped Waymo InstAugmentation parameters
            # (its waymo dataset variants are commented out, builder.py:140-157)
            raise NotImplementedError(
                "dataset.inst_aug has no reference parameterization for "
                "Waymo; build a DB with prepare_inst_database.py waymo and "
                "wire class weights explicitly before enabling it"
            )

        def build(split):
            return WaymoSeg(
                d.root, d.voxel_size, cap, split, flip_aug=d.flip_aug,
                rotate_aug=d.rotate_aug, translate_std=d.get("translate_std"),
                seed=seed,
                val_fraction=d.get("val_fraction", 0.15),
                tta=tta_val and split == "val",
            )
    else:
        raise NotImplementedError(f"dataset {name}: no such uni-modal dataset")
    from u2mkd_tpu_torch.data.semantic_nusc import collate

    workers, wproc, depth = pipeline_options(cfg)
    shard = process_shard(cfg)
    train_ds, val_ds = build("train"), build("val")
    rng = np.random.RandomState(seed)
    train_stage, val_stage = plumbing_stages(cfg, model)

    def loader(ds, shuffle, stage):
        return lambda: _epoch_iter(ds, cfg.batch_size, collate, shuffle, rng, stage, workers,
                                   wproc, shard)

    device = _model_device(model)
    return (device_loader(loader(train_ds, True, train_stage), device, depth),
            device_loader(loader(val_ds, False, val_stage), device, depth))


def make_distill_loaders(cfg, model, seed: int = 0, tta_val: bool = False):
    """Paired student/teacher loaders (``lc_semantic_nusc_tsd_full``) of the
    TSD ``model``, their plumbing as :func:`plumbing_stages` gives it (the
    two parts built concurrently); ``tta_val`` as in :func:`make_loaders`."""
    from u2mkd_tpu_torch.data.lc_semantic_nusc import LCSemanticNuscTSD, collate_tsd

    d = cfg.dataset
    if d.name != "lc_semantic_nusc_tsd_full":
        raise NotImplementedError(f"dataset {d.name}: no such paired dataset")
    s_cap = int((cfg.get_path("student_capacities") or cfg.capacities)[0])
    t_cap = int((cfg.get_path("teacher_capacities") or cfg.capacities)[0])

    def build(split):
        return LCSemanticNuscTSD(
            d.root, d.voxel_size, s_cap, t_cap,
            d.get("version", "v1.0-trainval"), split,
            num_sweeps=d.multisweeps.num_sweeps,
            only_past=d.multisweeps.only_past,
            im_drop=d.im_drop, im_cr=d.im_cr,
            inst_augmenter=_maybe_inst_augmenter(cfg, "nusc") if split == "train" else None,
            seed=seed,
            allow_unofficial_split=d.get("allow_unofficial_split", False),
            tta=tta_val and split == "val",
            label_drop_p=d.get("label_drop_p", 0.0) if split == "train" else 0.0,
            label_drop_classes=d.get("label_drop_classes", ()) if split == "train" else (),
        )

    workers, wproc, depth = pipeline_options(cfg)
    shard = process_shard(cfg)
    train_ds, val_ds = build("train"), build("val")
    rng = np.random.RandomState(seed)
    train_stage, val_stage = plumbing_stages(cfg, model)

    def loader(ds, shuffle, stage):
        return lambda: _epoch_iter(ds, cfg.batch_size, collate_tsd, shuffle, rng, stage,
                                   workers, wproc, shard)

    device = _model_device(model)
    return (device_loader(loader(train_ds, True, train_stage), device, depth),
            device_loader(loader(val_ds, False, val_stage), device, depth))
