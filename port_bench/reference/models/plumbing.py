"""Per-forward index plumbing of the point-voxel U-Net, on the device.

Port of ``u2mkd_tpu/models/plumbing.py``. Two sources, as in the JAX
package's ``get_plumbing``: :func:`from_precomputed` moves the arrays of
``data/plumbing_host.py`` to the device once per request and assembles them
into :class:`UNetPlumbing`; :func:`build_plumbing` builds the same
structures on the device from the points, without window geometry (the
attention then sorts its windows in the step), its rows in packed-key
order as the JAX package's in-program build keeps them, not in the host's
Morton order. The point <-> voxel transfers are batched over the leading
axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from port_bench.reference.core.device import resolve_device
from port_bench.reference.core.structures import LevelContext, VoxelGrid, WindowGeom
from port_bench.reference.ops import hashing, segment, spconv, voxelize


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
    # [L] x [B, V_L, 3] f32 mean metric xyz of each level's voxels (over the
    # level-0 voxel means): what the attention's windows are taken on where
    # no host geometry serves (the banded route and the in-program flash
    # route); None where the plumbing does not carry them
    vox_xyz: Optional[Tuple[torch.Tensor, ...]] = None


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
                     point_levels: Optional[Sequence[int]] = None,
                     vox_xyz: bool = False) -> UNetPlumbing:
    """Assemble a UNetPlumbing on ``device`` (CUDA unless asked otherwise)
    from host arrays (``data/plumbing_host.batch_plumbing``): each entry is a
    list over levels of [B, ...] arrays. Only what the forward reads is
    copied to the device: the point maps of ``point_levels`` (a model's
    ``point_levels``; every level by default), and the voxel means
    ``vox_xyz`` only where asked (an attention that takes its windows in the
    step, :func:`reads_vox_xyz`). Arrays the loaders uploaded already
    (tensors on ``device`` in the dtype each one needs) are used without a
    copy."""
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
        wgeom=wgeom, wgeom_first=first, window_occ=window_occ,
        vox_xyz=tuple(_tensor(x, dev, torch.float32) for x in arrays["voxxyz"])
        if vox_xyz else None)


def reads_vox_xyz(model, has_geom: bool) -> bool:
    """Whether ``model``'s attention reads the plumbing's voxel means: a
    model with SphereFormer blocks does where some branch runs banded
    (``pallas_attention`` off, or ``pallas_cubic`` off for the cubic
    branch) or where the plumbing carries no window geometry."""
    if not getattr(model, "sphereformer", True):
        return False
    exact = getattr(model, "pallas_attention", False) and getattr(model, "pallas_cubic", True)
    return not (exact and has_geom)


def _stack(xs):
    return torch.stack(list(xs)).contiguous()


def _build_single(pcoords, metric_xyz, pmask, capacities, point_levels):
    """One sample's plumbing (the JAX package's ``_build_single``): pcoords
    [P, 3] in voxel units, metric_xyz [P, 3], pmask [P]. The voxel means
    are summed and divided in f64 and rounded to f32 once, as the host
    builder (``native/pointcore.cpp``) takes them: the windows and their
    quantization, which a last-bit change of a mean can move, are the host
    geometry's. The JAX package's in-program build sums in f32 (to a few
    f32 ulps of these)."""
    v0 = voxelize.voxelize_initial(pcoords, metric_xyz.double(), pmask, capacities[0])
    grid0 = VoxelGrid(mask=v0["vmask"], stride=1, coords=v0["vcoords"], key=v0["key"],
                      num=v0["num"])
    levels = spconv.build_levels(grid0, capacities, v0["appear"])
    xyz0 = v0["vfeats"]
    p2v, dvi, dvw, vox_xyz = [], [], [], []
    for li, lv in enumerate(levels):
        s = lv.grid.stride
        if li in point_levels:
            p2v.append(voxelize.point_voxel_query(pcoords, pmask, s, lv.grid.key)
                       .to(torch.int32))
            idx8, w8 = voxelize.voxel_to_point_query(pcoords, pmask, s, lv.grid.key)
            dvi.append(idx8.to(torch.int32))
            dvw.append(w8)
        else:
            p2v.append(None)
            dvi.append(None)
            dvw.append(None)
        if li == 0:
            vox_xyz.append(xyz0.float())
        else:
            qc = torch.div(grid0.coords, s, rounding_mode="floor") * s
            rows = hashing.lookup_coords(qc, grid0.mask, lv.grid.key)
            seg = torch.where((rows >= 0) & grid0.mask, rows, lv.grid.capacity)
            vox_xyz.append(voxelize.segment_mean(xyz0, seg, lv.grid.capacity).float())
    p2v0 = _morton_permute(levels, p2v, dvi, vox_xyz, v0["p2v"])
    return levels, p2v, dvi, dvw, vox_xyz, p2v0


def _morton_code(coords: torch.Tensor) -> torch.Tensor:
    """Interleaved-bit z-order key [n] int64 from int coords [n, 3], over
    coords less their minimum (the host builder's ``_morton_code``)."""
    c = (coords - coords.min(dim=0, keepdim=True).values).long()
    out = torch.zeros(c.shape[0], dtype=torch.int64, device=c.device)
    for b in range(16):
        for a in range(3):
            out |= ((c[:, a] >> b) & 1) << (3 * b + a)
    return out


def _remap(values: torch.Tensor, newpos: torch.Tensor, n: int) -> torch.Tensor:
    """Row-valued ``values`` through ``newpos``, anything outside [0, n)
    kept (-1 and the capacity's drop rows)."""
    ok = (values >= 0) & (values < n)
    return torch.where(ok, newpos[values.long().clamp(0, max(n - 1, 0))].to(values.dtype),
                       values)


def _morton_permute(levels, p2v, dvi, vox_xyz, p2v0):
    """One sample's rows of every level put in Morton order of their
    coords over the stride, every row-valued map remapped (the host
    builder's ``_morton_permute_sample``): the rows the host plumbing has,
    so that a draw over rows (dropout) falls on the same voxels. Returns
    the remapped level-0 point map."""
    perms, newposes, ns = [], [], []
    for li, lv in enumerate(levels):
        n = int(lv.grid.num)
        coords = torch.div(lv.grid.coords[:n], 1 << li, rounding_mode="floor")
        perm = torch.argsort(_morton_code(coords), stable=True) if n else coords[:, 0].long()
        newpos = torch.empty(n, dtype=torch.int64, device=perm.device)
        newpos[perm] = torch.arange(n, device=perm.device)
        perms.append(perm)
        newposes.append(newpos)
        ns.append(n)
    for li, lv in enumerate(levels):
        perm, n = perms[li], ns[li]
        lv.grid.coords[:n] = lv.grid.coords[perm]
        lv.grid.key[:n] = lv.grid.key[perm]
        vox_xyz[li][:n] = vox_xyz[li][perm]
        lv.nbr27[:, :n] = lv.nbr27[:, perm]
        lv.nbr27.copy_(_remap(lv.nbr27, newposes[li], n))
        if li >= 1:
            lv.down_nbr8[:, :n] = lv.down_nbr8[:, perm]
            lv.down_nbr8.copy_(_remap(lv.down_nbr8, newposes[li - 1], ns[li - 1]))
        if li < len(levels) - 1:
            lv.up_parent[:n] = lv.up_parent[perm]
            lv.up_parent.copy_(_remap(lv.up_parent, newposes[li + 1], ns[li + 1]))
            lv.up_koff[:n] = lv.up_koff[perm]
        if p2v[li] is not None:
            p2v[li] = _remap(p2v[li], newposes[li], n)
            dvi[li] = _remap(dvi[li], newposes[li], n)
    return _remap(p2v0, newposes[0], ns[0])


def build_plumbing(pcoords: torch.Tensor, metric_xyz: torch.Tensor, pmask: torch.Tensor,
                   capacities: Sequence[int],
                   point_levels: Optional[Sequence[int]] = None) -> UNetPlumbing:
    """Plumbing of a batch built on the tensors' device (the JAX package's
    ``build_plumbing``): pcoords [B, P, 3] f32 point coords in voxel units,
    metric_xyz [B, P, 3] f32, pmask [B, P] bool. Every lookup is a sort and
    a binary search on the device, one sample after another; nothing goes
    through the host. The point maps are built at ``point_levels`` (every
    level by default) and None elsewhere; the window geometry is left to the
    attention (``wgeom`` None). Named ``build_plumbing`` in a
    ``torch.profiler`` trace."""
    caps = tuple(int(c) for c in capacities)
    if point_levels is None:
        point_levels = range(len(caps))
    pcoords, metric_xyz = pcoords.float(), metric_xyz.float()
    pmask = pmask.bool()
    with torch.profiler.record_function("build_plumbing"):
        samples = [_build_single(pcoords[i], metric_xyz[i], pmask[i], caps,
                                 tuple(point_levels)) for i in range(pcoords.shape[0])]
    levels = []
    for li in range(len(caps)):
        per = [s[0][li] for s in samples]
        last = li == len(caps) - 1
        grid = VoxelGrid(mask=_stack(lv.grid.mask for lv in per), stride=1 << li,
                         coords=_stack(lv.grid.coords for lv in per),
                         key=_stack(lv.grid.key for lv in per),
                         num=_stack(lv.grid.num for lv in per))
        levels.append(LevelContext(
            grid=grid, nbr27=_stack(lv.nbr27 for lv in per),
            down_nbr8=_stack(lv.down_nbr8 for lv in per) if li else None,
            up_parent=None if last else _stack(lv.up_parent for lv in per),
            up_koff=None if last else _stack(lv.up_koff for lv in per)))

    def per_level(j):
        return tuple(None if samples[0][j][li] is None else _stack(s[j][li] for s in samples)
                     for li in range(len(caps)))

    p2v0 = _stack(s[5] for s in samples).to(torch.int32)
    return UNetPlumbing(
        levels=tuple(levels), p2v=per_level(1), devox_idx=per_level(2),
        devox_w=per_level(3), pmask=pmask, p2v0_feats_seg=p2v0,
        vox_xyz=per_level(4))


def level_geom(pl: UNetPlumbing, level: int):
    """Window geometry of U-Net level ``level`` (None without host
    geometry: the attention then takes its windows in the step)."""
    if pl.wgeom is None:
        return None
    if level < pl.wgeom_first:
        raise ValueError(f"the plumbing's window geometry starts at level {pl.wgeom_first}, "
                         f"not {level}")
    return {branch: pl.wgeom[branch][level - pl.wgeom_first] for branch in pl.wgeom}


def level_xyz(pl: UNetPlumbing, level: int) -> Optional[torch.Tensor]:
    """The voxel means [B, V, 3] of U-Net level ``level``, or None where the
    plumbing carries none (host geometry serves the attention)."""
    return None if pl.vox_xyz is None else pl.vox_xyz[level]


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


def batch_plan(ids: torch.Tensor, rows: int, negative_reads_row0: bool = False
               ) -> segment.SegmentPlan:
    """The segment plan (``ops/segment.py``) of a batch's row map ``ids``
    [B, ...] into ``rows`` rows a sample, over the batch's B * rows rows
    (sample b's row r is b * rows + r; ids outside [0, rows) dropped, or a
    negative id read as row 0 with ``negative_reads_row0``). The maps are
    fixed per batch, so the plan is made once and kept on ``ids`` for
    every later call of the batch's forward and backward."""
    memo = getattr(ids, "_batch_plans", None)
    if memo is None:
        memo = {}
        ids._batch_plans = memo
    key = (rows, negative_reads_row0)
    if key not in memo:
        b = ids.shape[0]
        base = torch.arange(b, device=ids.device).view((b,) + (1,) * (ids.dim() - 1)) * rows
        ids = ids.long().clamp(min=0) if negative_reads_row0 else ids.long()
        ok = (ids >= 0) & (ids < rows)
        memo[key] = segment.plan(torch.where(ok, ids + base, -1), b * rows)
    return memo[key]


def batch_rows(x: torch.Tensor, ids: torch.Tensor,
               negative_reads_row0: bool = False) -> torch.Tensor:
    """Rows [B, ..., C] of each sample's x [B, R, C] at its ``ids`` [B, ...]
    (zero where an id is outside [0, R), or row 0 for a negative id with
    ``negative_reads_row0``); the backward sums each row's gradients
    through the batch's plan of ``ids`` (:func:`batch_plan`)."""
    plan = batch_plan(ids, x.shape[1], negative_reads_row0)
    rows = segment.take(x.reshape(-1, x.shape[-1]), plan.rows, plan)
    return rows.view(tuple(ids.shape) + (x.shape[-1],))


def point_to_voxel(pfeats: torch.Tensor, p2v: torch.Tensor,
                   capacity: int) -> torch.Tensor:
    """Batched scatter-mean of point features [B, P, C] onto voxel rows
    [B, capacity, C] (``p2v`` [B, P], -1 or ``capacity`` drop), the sums in
    a fixed order through the batch's plan of ``p2v``."""
    b, _, c = pfeats.shape
    out = voxelize.segment_mean(pfeats.reshape(-1, c), None, b * capacity,
                                plan=batch_plan(p2v, capacity))
    return out.view(b, capacity, c)


def voxel_to_point(vfeats: torch.Tensor, idx8: torch.Tensor,
                   w8: torch.Tensor) -> torch.Tensor:
    """Batched trilinear devoxelize [B, V, C] -> [B, P, C]: the 8 neighbour
    rows ``idx8`` [B, P, 8] (-1 absent) blended by ``w8``; the gather's
    backward sums in a fixed order (:func:`batch_rows`)."""
    g = batch_rows(vfeats, idx8)
    w = torch.where(idx8 >= 0, w8, 0.0).to(vfeats.dtype)
    return torch.einsum("bpkc,bpk->bpc", g, w)
