"""Per-forward index plumbing of the point-voxel U-Net, on the device.

Port of the host-precomputed half of ``u2mkd_tpu/models/plumbing.py``: the
arrays of ``data/plumbing_host.py`` are moved to the device once per
request and assembled into :class:`UNetPlumbing`; the point <-> voxel
transfers are batched over the leading axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from u2mkd_tpu_torch.core.device import resolve_device
from u2mkd_tpu_torch.core.structures import LevelContext, VoxelGrid, WindowGeom
from u2mkd_tpu_torch.ops import voxelize


@dataclass
class UNetPlumbing:
    levels: Tuple[LevelContext, ...]      # grids + rulebooks per level
    # [L] x [B, P] point -> voxel row (-1 none), [B, P, 8] trilinear rows and
    # weights; None at the levels the model does not read
    # (``point_levels`` of :func:`from_precomputed`)
    p2v: Tuple[Optional[torch.Tensor], ...]
    devox_idx: Tuple[Optional[torch.Tensor], ...]
    devox_w: Tuple[Optional[torch.Tensor], ...]
    pmask: torch.Tensor                   # [B, P] bool
    p2v0_feats_seg: torch.Tensor          # [B, P] segment ids of the first voxelize
    # window geometry of the attention levels, from level ``wgeom_first``
    # down to the deepest: {"cubic": (WindowGeom, ...), "sphere": (...)}
    # (levels 1..4 for a SPVCNN encoder, 0..4 for the SphereFormer U-Net)
    wgeom: Optional[Dict[str, Tuple[WindowGeom, ...]]] = None
    wgeom_first: int = 1
    # [2, L] int32: the largest window occupancy of each attention level's
    # cubic (row 0) and sphere (row 1) windows, from the host geometry; read
    # by the capacity counters (``train/overflow.py``) only
    window_occ: Optional[torch.Tensor] = None


def _tensor(x, device, dtype=None) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    return t.to(device=device, dtype=dtype).contiguous()


def _window_geom_from_arrays(g: dict, device) -> WindowGeom:
    """WindowGeom from one branch's host arrays at one level."""
    return WindowGeom(
        order=_tensor(g["order"], device, torch.int64),
        inv=_tensor(g["inv"], device, torch.int64),
        rank=_tensor(g["rank"], device, torch.float32),
        quant=_tensor(g["quant"], device, torch.int32),
        kmin=_tensor(g["kmin"], device, torch.int32),
        kmax=_tensor(g["kmax"], device, torch.int32),
        r=_tensor(g["r"], device, torch.float32) if "r" in g else None)


def from_precomputed(arrays: Dict, pmask,
                     device: Optional[Union[str, torch.device]] = None,
                     point_levels: Optional[Sequence[int]] = None) -> UNetPlumbing:
    """Assemble a UNetPlumbing on ``device`` (CUDA unless asked otherwise)
    from host arrays (``data/plumbing_host.batch_plumbing``): each entry is a
    list over levels of [B, ...] arrays. Only what the forward reads is
    copied to the device: the point maps of ``point_levels`` (a model's
    ``point_levels``; every level by default). Arrays the loaders uploaded
    already (tensors on ``device`` in the dtype each one needs) are used
    without a copy."""
    dev = resolve_device(device)
    n_levels = len(arrays["vmask"])
    if point_levels is None:
        point_levels = range(n_levels)
    levels = []
    for li in range(n_levels):
        last = li == n_levels - 1
        levels.append(LevelContext(
            grid=VoxelGrid(mask=_tensor(arrays["vmask"][li], dev, torch.bool),
                           stride=1 << li),
            nbr27=_tensor(arrays["nbr27"][li], dev, torch.int32),
            down_nbr8=_tensor(arrays["down8"][li], dev, torch.int32) if li else None,
            up_parent=None if last else _tensor(arrays["parent"][li], dev, torch.int32),
            up_koff=None if last else _tensor(arrays["koff"][li], dev, torch.int32)))

    def point_maps(key, dtype):
        return tuple(_tensor(x, dev, dtype) if li in point_levels else None
                     for li, x in enumerate(arrays[key]))

    p2v = point_maps("p2v", torch.int32)
    cap0 = levels[0].grid.capacity
    wgeom = window_occ = None
    first = 1
    if "wgeom" in arrays:
        wgeom = {branch: tuple(_window_geom_from_arrays(g, dev) for g in geoms)
                 for branch, geoms in arrays["wgeom"].items()}
        # the geometry covers the deepest levels, down from its first
        first = n_levels - len(wgeom["cubic"])
        window_occ = torch.stack([
            torch.cat([_tensor(g["occ"], dev, torch.int32) for g in arrays["wgeom"][branch]])
            for branch in ("cubic", "sphere")])
    return UNetPlumbing(
        levels=tuple(levels), p2v=p2v,
        devox_idx=point_maps("dvi", torch.int32),
        devox_w=point_maps("dvw", torch.float32),
        pmask=_tensor(pmask, dev, torch.bool),
        p2v0_feats_seg=torch.where(p2v[0] >= 0, p2v[0], cap0),
        wgeom=wgeom, wgeom_first=first, window_occ=window_occ)


def level_geom(pl: UNetPlumbing, level: int):
    """Window geometry of U-Net level ``level`` (None without host
    geometry)."""
    if pl.wgeom is None:
        return None
    if level < pl.wgeom_first:
        raise ValueError(f"the plumbing's window geometry starts at level {pl.wgeom_first}, "
                         f"not {level}")
    return {branch: pl.wgeom[branch][level - pl.wgeom_first] for branch in pl.wgeom}


def recursive_vox_xyz(xyz0: torch.Tensor,
                      levels: Sequence[LevelContext]) -> Tuple[torch.Tensor, ...]:
    """Per-level voxel xyz [B, V_L, 3] by recursive mean-of-means through the
    downsample rulebooks (port of ``u2mkd_tpu/models/plumbing.py:
    recursive_vox_xyz``, the SphereFormer U-Net's coordinate tracking):
    level 0 is ``xyz0``, the level-0 voxel means; each coarser voxel is the
    mean of its live ``down_nbr8`` rows at the finer level, summed over the
    8 offsets in offset order and divided once by max(count, 1), as the JAX
    package and the host twin (``data/plumbing_host.recursive_vox_xyz``)
    do; dead voxels get 0."""
    out = [xyz0.float()]
    for lv in levels[1:]:
        prev, nbr = out[-1], lv.down_nbr8.long()            # [B, Vp, 3], [B, 8, V]
        ok = nbr >= 0
        rows = nbr.clamp(0, prev.shape[1] - 1)
        s = prev.new_zeros(nbr.shape[0], nbr.shape[2], 3)
        for k in range(nbr.shape[1]):
            vals = torch.gather(prev, 1, rows[:, k, :, None].expand(-1, -1, 3))
            s = s + torch.where(ok[:, k, :, None], vals, 0.0)
        c = ok.sum(dim=1).to(s.dtype).clamp(min=1.0)[..., None]
        out.append(torch.where(lv.grid.mask[..., None], s / c, 0.0))
    return tuple(out)


def point_to_voxel(pfeats: torch.Tensor, p2v: torch.Tensor,
                   capacity: int) -> torch.Tensor:
    """Batched scatter-mean of point features [B, P, C] onto voxel rows."""
    return torch.stack([voxelize.point_to_voxel_mean(f, m, capacity)
                        for f, m in zip(pfeats, p2v)])


def voxel_to_point(vfeats: torch.Tensor, idx8: torch.Tensor,
                   w8: torch.Tensor) -> torch.Tensor:
    """Batched trilinear devoxelize [B, V, C] -> [B, P, C]."""
    return torch.stack([voxelize.trilinear_devoxelize(f, i, w)
                        for f, i, w in zip(vfeats, idx8, w8)])
