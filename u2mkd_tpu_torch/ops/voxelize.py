"""Point <-> voxel transfer: scatter-mean voxelize, trilinear devoxelize.

Port of the device half of ``u2mkd_tpu/ops/voxelize.py`` (the lookups run on
the host, ``data/plumbing_host.py``). Per sample, in the JAX package's
layout: points ``[P, *]``, voxel tables ``[V, *]``. Segment id ``capacity``
is the drop bucket.
"""

from __future__ import annotations

import torch

from u2mkd_tpu_torch.ops.spconv import gather_rows


def segment_mean(feats: torch.Tensor, seg_ids: torch.Tensor, capacity: int) -> torch.Tensor:
    """Mean of ``feats`` [P, C] rows grouped by ``seg_ids`` [P] into
    ``capacity`` buckets; ids outside [0, capacity) are dropped."""
    valid = (seg_ids >= 0) & (seg_ids < capacity)
    seg = torch.where(valid, seg_ids, capacity).long()
    sums = feats.new_zeros(capacity + 1, feats.shape[-1]).index_add_(
        0, seg, torch.where(valid[:, None], feats, 0.0))[:capacity]
    counts = torch.zeros(capacity + 1, dtype=torch.int32, device=feats.device).index_add_(
        0, seg, valid.to(torch.int32))[:capacity]
    return sums / counts.clamp(min=1)[:, None].to(feats.dtype)


def point_to_voxel_mean(pfeats: torch.Tensor, p2v: torch.Tensor,
                        capacity: int) -> torch.Tensor:
    """Scatter-mean point features [P, C] onto voxel rows (``p2v`` [P], -1 or
    ``capacity`` drop)."""
    seg = torch.where((p2v >= 0) & (p2v < capacity), p2v, capacity)
    return segment_mean(pfeats, seg, capacity)


def trilinear_devoxelize(vfeats: torch.Tensor, idx8: torch.Tensor,
                         w8: torch.Tensor) -> torch.Tensor:
    """Blend the 8 neighbour voxel rows of each point: vfeats [V, C],
    idx8 [P, 8] (-1 absent), w8 [P, 8] -> [P, C]."""
    g = gather_rows(vfeats, idx8)                              # [P, 8, C]
    w = torch.where(idx8 >= 0, w8, 0.0).to(vfeats.dtype)
    return torch.einsum("pkc,pk->pc", g, w)
