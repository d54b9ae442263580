"""Point <-> voxel transfer: voxelize, scatter-mean, and the point and
trilinear queries.

Port of ``u2mkd_tpu/ops/voxelize.py``. Per sample, in the JAX package's
layout: points ``[P, *]``, voxel tables ``[V, *]`` sorted by packed key.
Segment id ``capacity`` is the drop bucket. The queries build the plumbing
on the device (``models/plumbing.build_plumbing``); the host pipeline
(``data/plumbing_host.py``) resolves the same lookups on the CPU. The
batched point-to-voxel mean and trilinear devoxelize of a forward are
``models/plumbing.point_to_voxel`` and ``voxel_to_point``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from u2mkd_tpu_torch.ops import hashing, segment
from u2mkd_tpu_torch.ops.spconv import kernel_offsets


def segment_mean(feats: torch.Tensor, seg_ids: torch.Tensor, capacity: int,
                 plan: Optional[segment.SegmentPlan] = None) -> torch.Tensor:
    """Mean of ``feats`` [N, C] rows grouped by ``seg_ids`` [N] into
    ``capacity`` buckets; ids outside [0, capacity) are dropped. The sums
    run in a fixed order (``ops/segment.py``), through ``plan`` where the
    caller has the ids' plan already."""
    p = plan if plan is not None else segment.plan(seg_ids, capacity)
    sums = segment.segment_sum(feats, p)
    return sums / segment.counts(p).clamp(min=1)[:, None].to(feats.dtype)


def voxelize_initial(pcoords: torch.Tensor, pfeats: torch.Tensor, pmask: torch.Tensor,
                     capacity: int) -> Dict[str, torch.Tensor]:
    """The first voxelization of a scan: pcoords [P, 3] float in voxel
    units, pfeats [P, C], pmask [P] -> {vcoords [V, 3] int32 (0 on dead
    rows), vfeats [V, C] the mean point features, vmask [V], key [V] the
    sorted table, p2v [P] (``capacity`` for a dropped point), counts [V],
    num []}."""
    ic = torch.floor(pcoords).to(torch.int32)
    key = hashing.pack_coords(ic, pmask)
    table, inverse, counts, num = hashing.unique_keys(key, capacity)
    vfeats = segment_mean(pfeats, inverse, capacity)
    vmask = table != hashing.PACKED_INVALID
    vcoords = torch.where(vmask[:, None], hashing.unpack_coords(table), 0)
    return dict(vcoords=vcoords, vfeats=vfeats, vmask=vmask, key=table, p2v=inverse,
                counts=counts, num=num)


def point_voxel_query(pcoords: torch.Tensor, pmask: torch.Tensor, stride: int,
                      table: torch.Tensor) -> torch.Tensor:
    """Row [P] of each point's voxel at ``stride`` in the sorted key table
    (-1 if none): floor(c / s) * s, then a lookup."""
    qc = torch.floor(pcoords / stride).to(torch.int32) * stride
    return hashing.lookup(hashing.pack_coords(qc, pmask), table)


def trilinear_weights(pcoords: torch.Tensor, stride: int) -> torch.Tensor:
    """Raw trilinear weights [P, 8] of the 8 neighbours: with p = c / s and
    frac = p - floor(p), the product over the axes of frac where the offset
    is 1, else 1 - frac."""
    p = pcoords / stride
    frac = p - torch.floor(p)
    offs = torch.as_tensor(kernel_offsets(2), device=pcoords.device)
    w = torch.where(offs[None] > 0, frac[:, None, :], 1.0 - frac[:, None, :])
    return w[..., 0] * w[..., 1] * w[..., 2]


def voxel_to_point_query(pcoords: torch.Tensor, pmask: torch.Tensor, stride: int,
                         table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 8 neighbour rows [P, 8] (-1 absent, in ``spconv.kernel_offsets(2)``
    order) and trilinear weights [P, 8] of each point at ``stride``: the
    weights of absent neighbours zeroed, then renormalized over the present
    ones (+1e-8)."""
    base = torch.floor(pcoords / stride).to(torch.int32) * stride
    offs = torch.as_tensor(kernel_offsets(2), device=pcoords.device)
    qc = base[:, None, :] + offs[None] * stride
    qvalid = pmask[:, None].expand(qc.shape[:2])
    idx8 = hashing.lookup_coords(qc, qvalid, table)
    w8 = trilinear_weights(pcoords, stride).float()
    w8 = torch.where(idx8 >= 0, w8, 0.0)
    return idx8, w8 / (w8.sum(dim=-1, keepdim=True) + 1e-8)
