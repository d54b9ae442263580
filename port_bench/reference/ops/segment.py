"""Sums of rows by segment in a fixed order: the repeatable scatter-adds.

A float ``index_add_``, the ``scatter_add`` behind the backward of
``torch.gather`` and the backward of ``F.grid_sample`` add on the card with
atomics, so their bits change from run to run. Here every such sum goes
through :func:`segment_sum`: on the card an accumulating ``index_put_``,
which sorts the rows by segment (a stable radix sort) and adds each
segment's rows one after another, in index order; on the CPU
``index_add_``, which adds them in that order too. So one input gives one
result on the card, and on the CPU the sums are bitwise the ones they
replace. A dropped row (an id outside [0, num)) adds a zero to a row of
its own position, so that no row collects a long run of them, which the
card would add one after another.

A :class:`SegmentPlan` holds the rows; where the ids are fixed per batch
(a point-to-voxel map, the trilinear neighbours)
``models/plumbing.batch_plan`` keeps it for the batch. :func:`take` is the
gather whose backward is such a sum.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SegmentPlan(NamedTuple):
    rows: torch.Tensor   # [N] int64: each row's segment (a dropped row: its position mod num)
    keep: torch.Tensor   # [N] bool: False for a dropped row, whose value is zeroed
    num: int


def plan(ids: torch.Tensor, num: int) -> SegmentPlan:
    """The plan of ``ids`` (any shape, read flattened) into ``num``
    segments; ids outside [0, num) are dropped."""
    ids = ids.reshape(-1).long()
    keep = (ids >= 0) & (ids < num)
    spread = torch.arange(ids.shape[0], device=ids.device) % max(int(num), 1)
    return SegmentPlan(rows=torch.where(keep, ids, spread), keep=keep, num=int(num))


def counts(p: SegmentPlan) -> torch.Tensor:
    """The rows [num] of each segment."""
    return torch.zeros(p.num, dtype=torch.int64, device=p.rows.device).index_add_(
        0, p.rows, p.keep.long())


def _kept(x: torch.Tensor, p: SegmentPlan) -> torch.Tensor:
    keep = p.keep.view((-1,) + (1,) * (x.dim() - 1))
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))


def _sum_rows(x: torch.Tensor, p: SegmentPlan) -> torch.Tensor:
    """Per-segment sums [num, *] of rows x [N, *], each segment's rows added
    in index order."""
    out = x.new_zeros((p.num,) + tuple(x.shape[1:]))
    if p.num == 0 or x.shape[0] == 0:
        return out
    if x.is_cuda:
        return out.index_put_((p.rows,), _kept(x, p), accumulate=True)
    return out.index_add_(0, p.rows, _kept(x, p))


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, p):
        ctx.p = p
        return _sum_rows(x, p)

    @staticmethod
    def backward(ctx, g):
        return _kept(g[ctx.p.rows], ctx.p), None


class _Take(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, p):
        ctx.p = p
        if p.num == 0:
            return x.new_zeros((p.rows.shape[0],) + tuple(x.shape[1:]))
        return _kept(x[p.rows], p)

    @staticmethod
    def backward(ctx, g):
        return _sum_rows(g, ctx.p), None


def segment_sum(x: torch.Tensor, p: SegmentPlan) -> torch.Tensor:
    """Sums [num, *] of the rows of x [N, *] by ``p``'s segments (zero for
    an empty one): ``zeros(num).index_add_(0, ids, x)`` in the CPU's order.
    Its backward is :func:`take`."""
    return _SegmentSum.apply(x, p)


def take(x: torch.Tensor, ids: torch.Tensor, p: Optional[SegmentPlan] = None) -> torch.Tensor:
    """Rows [*ids.shape, *] of x [num, *] at ``ids`` (zero where an id is
    outside [0, num)), through ``p``, the plan of ``ids`` into num
    segments, where given. Its backward sums the gradient rows by id as
    :func:`segment_sum` does."""
    p = p if p is not None else plan(ids, x.shape[0])
    return _Take.apply(x, p).view(tuple(ids.shape) + tuple(x.shape[1:]))


def index_add(base: torch.Tensor, ids: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``base.index_add(0, ids, src)`` with the sum in a fixed order (ids in
    [0, len(base)))."""
    return base + segment_sum(src, plan(ids, base.shape[0])).to(base.dtype)
