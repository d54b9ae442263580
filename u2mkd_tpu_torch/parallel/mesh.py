"""Data parallelism over ``torch.distributed`` (port of
``u2mkd_tpu/parallel/mesh.py``).

The JAX package shards one jitted step over a 1-D ``data`` mesh axis and
reduces gradients, BN statistics and metric counters with ``psum`` /
``pmean`` inside it. Here the axis is a process group with one process per
device: every rank runs the whole step on its own shard of the batch, the
synced BN layers (``models/blocks.MaskedBatchNorm``,
``models/swiftnet.BatchNorm2d``) sum their statistics across the group, and
the steps (``train/state.py``, ``train/distill.py``) reduce gradients,
losses and counters with one coalesced ``all_reduce`` each. There is no
``shard_map`` and no ``Mesh`` object: ``make_mesh`` / ``make_global_mesh``
become :func:`data_group`, the group of every process, as JAX's
``--multihost`` path with one local device a process.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from u2mkd_tpu_torch.core.device import resolve_device
from u2mkd_tpu_torch.data.loaders import HOST_LOCAL_KEYS, to_device as to_local_device

DATA_AXIS = "data"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> dist.ProcessGroup:
    """Join the data group: ``init_process_group`` over
    ``tcp://coordinator`` (``host:port``) with ``num_processes`` ranks, this
    one ``process_id``. With no arguments the launcher's environment gives
    them (torchrun's ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``). ``backend`` defaults to ``nccl`` where CUDA is available and
    ``gloo`` elsewhere; two ranks that share one card need ``gloo`` (NCCL
    refuses a device twice). Raises when no coordinator can be found: a
    multi-process run never goes on unsynced. A second call returns the
    group already joined. -> :func:`data_group`."""
    if dist.is_initialized():
        return data_group()
    env = os.environ
    if coordinator is None and num_processes is None and process_id is None:
        if not all(k in env for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK")):
            raise RuntimeError(
                "initialize_distributed: no coordinator. Pass coordinator, num_processes "
                "and process_id (--coordinator HOST:PORT --num-processes N --process-id I), "
                "or launch under torchrun")
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
    if coordinator is None or num_processes is None or process_id is None:
        raise RuntimeError(
            f"initialize_distributed: coordinator {coordinator!r}, num_processes "
            f"{num_processes!r} and process_id {process_id!r} must all be given")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes), rank=int(process_id))
    return data_group()


def shutdown() -> None:
    """Leave the data group, where this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def local_device(device=None) -> torch.device:
    """The device this process runs on (``core/device.resolve_device``: the
    card unless asked otherwise). On a host with several cards, rank r takes
    card ``LOCAL_RANK`` (torchrun's), else r, modulo the count, and makes it
    the current one; ranks that outnumber the cards share them."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", process_index())) % torch.cuda.device_count()
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    return dev


def data_group() -> Optional[dist.ProcessGroup]:
    """The group the data axis reduces over (every process), or None in a
    process that joined none."""
    return dist.group.WORLD if dist.is_initialized() else None


def world_size(group: Optional[dist.ProcessGroup] = None) -> int:
    """Ranks of ``group`` (default :func:`data_group`); 1 without one."""
    group = group or data_group()
    return dist.get_world_size(group) if group is not None else 1


def process_index(group: Optional[dist.ProcessGroup] = None) -> int:
    """This process's rank in ``group`` (default :func:`data_group`); 0
    without one."""
    group = group or data_group()
    return dist.get_rank(group) if group is not None else 0


def use_data_parallel(cfg) -> bool:
    """THE data-parallel decision, JAX's predicate with its device count
    the world size (one device a process): more than one rank, and the
    config's batch divisible by the world size. The loaders, the steps and
    the schedule all follow it. As in JAX the test is on ``batch_size``,
    which is each process's own batch: batch 3 on two ranks is not data
    parallel though each rank could take its 3 scans alone, and such a run
    is refused (:func:`data.loaders.dp_shard_count`)."""
    n = world_size()
    return n > 1 and cfg.batch_size % n == 0


def device_batch(batch):
    """A loader batch without its top-level host-local metadata (``infos``,
    ``lidar_tokens``): what the steps read."""
    if isinstance(batch, dict):
        return {k: v for k, v in batch.items() if k not in HOST_LOCAL_KEYS}
    return batch


def shard_host_batch(batch, device):
    """This rank's share of the global batch on ``device``. Each rank's
    loader already yields only its own samples (:func:`local_batch_indices`),
    so this is the rank's upload (:func:`to_local_device`)."""
    return to_local_device(batch, device)


def local_data(x) -> np.ndarray:
    """This rank's block of a batch-sharded output, as numpy: in torch each
    rank holds exactly its own."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def local_batch_indices(n: int, seed_order: np.ndarray,
                        group: Optional[dist.ProcessGroup] = None) -> np.ndarray:
    """This rank's slice of the shuffled global order of ``n`` samples that
    every rank draws alike: ``seed_order[rank::world]``, cut to ``n //
    world`` so that every rank takes the same number of lockstep steps (the
    reference's ``DistributedSampler``, JAX ``loaders.py:105-114``)."""
    world = world_size(group)
    return seed_order[process_index(group)::world][: n // world]


class _AllReduceSum(torch.autograd.Function):
    """``all_reduce(SUM)`` whose backward is ``all_reduce(SUM)`` of the
    cotangent: the transpose of JAX's ``psum`` under ``shard_map``, so that
    the gradient of a rank's loss reaches every rank's inputs of the sum."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The sums over ``group`` of ``tensors`` (one dtype), differentiable,
    in one collective: a synced BN's count and moments."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    out = _AllReduceSum.apply(flat, group)
    return [o.view_as(t) for o, t in zip(out.split([t.numel() for t in tensors]), tensors)]


def all_reduce_coalesced(tensors: Iterable[torch.Tensor], group, op: str = "sum") -> None:
    """Reduce ``tensors`` in place over ``group``, one collective per dtype:
    ``op`` "sum", "mean" or "max". Not differentiable: for gradients after
    the backward, losses and counters."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    reduce_op = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    n = world_size(group)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        dist.all_reduce(flat, op=reduce_op, group=group)
        if op == "mean":
            flat /= n
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def broadcast_state(model: torch.nn.Module, group, src: int = 0) -> None:
    """Every parameter and buffer of ``model`` from rank ``src`` to the
    group, one collective per dtype (the DDP idiom at wrap time)."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in model.state_dict().values():
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.broadcast(flat, src, group=group)
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t))


def state_digest(model: torch.nn.Module) -> str:
    """sha256 of every parameter and buffer of ``model``, bytes in
    ``state_dict`` order: equal on every rank of a data-parallel run."""
    h = hashlib.sha256()
    for k, t in model.state_dict().items():
        h.update(k.encode())
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _wrap(fn: Callable, model: torch.nn.Module, group) -> Callable:
    if group is not None:
        broadcast_state(model, group)
    return fn


def add_multihost_args(parser) -> None:
    """The training CLIs' multi-process flags (JAX ``train_spformer.py:28-35``,
    and ``--backend``)."""
    parser.add_argument("--multihost", action="store_true",
                        help="multi-process data parallelism: join the group of "
                             "--num-processes ranks at --coordinator (or torchrun's), "
                             "each process on its own shard and device")
    parser.add_argument("--coordinator", default=None, help="HOST:PORT of rank 0")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                        help="collectives' backend: nccl on the card, gloo with --cpu by "
                             "default; ranks that share one card need gloo")


def setup_multihost(args, cfg):
    """A training CLI's group: with ``--multihost`` join it
    (:func:`initialize_distributed`) and set ``train.multihost``; then the
    data-parallel decision (:func:`use_data_parallel`). -> (the group, or
    None without data parallelism; the world size the schedule follows)."""
    if args.multihost:
        from u2mkd_tpu_torch.utils import config as config_lib

        initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                               args.backend or ("gloo" if args.cpu else None))
        config_lib.update_dotted(cfg, ["train.multihost=true"])
        print(f"multihost: process {process_index()}/{world_size()}")
    use_dp = use_data_parallel(cfg)
    print(f"devices: {world_size()} ({'data-parallel' if use_dp else 'single'})")
    return (data_group(), world_size()) if use_dp else (None, 1)


def finish_multihost(args, model: torch.nn.Module) -> None:
    """After a ``--multihost`` run: print this rank's :func:`state_digest`
    (equal on every rank) and leave the group."""
    if args.multihost:
        print(f"multihost: process {process_index()}/{world_size()} state sha256 "
              f"{state_digest(model)}", flush=True)
        shutdown()


def data_parallel_step(step_fn: Callable, model: torch.nn.Module,
                       group: Optional[dist.ProcessGroup] = None) -> Callable:
    """A train step built with ``process_group=group``
    (``state.make_train_step``, ``distill.make_distill_train_step``), each
    rank on its own shard: ``model``'s parameters and buffers are broadcast
    from rank 0 once, here; the step then keeps them equal on every rank
    (gradients averaged, BN statistics synced). Its loss and aux are the
    ranks' means (overflow counters: their max)."""
    return _wrap(step_fn, model, group)


def data_parallel_eval(eval_fn: Callable, model: torch.nn.Module,
                       group: Optional[dist.ProcessGroup] = None) -> Callable:
    """A teacher eval step built with ``process_group=group``
    (``state.make_eval_step``), ``model`` broadcast from rank 0 here. Its
    ``pred`` and ``logits`` are the rank's own points; its ``counts`` the
    sums over the group."""
    return _wrap(eval_fn, model, group)


def data_parallel_distill_eval(eval_fn: Callable, model: torch.nn.Module,
                               group: Optional[dist.ProcessGroup] = None) -> Callable:
    """The stage-2 eval step's wrapper (``distill.make_distill_eval_step``
    with ``process_group=group``): per-point outputs the rank's own,
    ``counts_vox``, ``counts_pix`` and ``counts_teacher`` summed."""
    return _wrap(eval_fn, model, group)
