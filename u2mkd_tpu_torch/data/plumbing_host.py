"""Host-side plumbing: every index structure of one forward, built on the CPU.

Port of ``u2mkd_tpu/data/plumbing_host.py`` (native builder only). Per
sample the native ``build_plumbing_host`` resolves the voxel grids, the conv
rulebooks, the point <-> voxel maps and the per-voxel mean xyz; the rows of
every level are then put in Morton (z-order) order, which keeps the 27
neighbours of nearby rows close together in memory: the CUDA rulebook conv's
gathers owe their locality to it. The TPU conv tiling arrays
(``cr27jl/jn/kr``) are not built.
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence

import numpy as np

from u2mkd_tpu_torch.data import native

KEYS = ("coords", "vmask", "nums", "nbr27", "down8", "parent", "koff",
        "voxxyz", "p2v", "dvi", "dvw")


def _morton_code(coords: np.ndarray) -> np.ndarray:
    """Interleaved-bit z-order key [n] uint64 from int coords [n, 3]."""
    c = coords - coords.min(axis=0, keepdims=True)
    out = np.zeros(len(c), np.uint64)
    for b in range(16):
        for a in range(3):
            out |= ((c[:, a].astype(np.uint64) >> np.uint64(b)) & np.uint64(1)) << np.uint64(3 * b + a)
    return out


def _remap_vals(arr: np.ndarray, newpos: np.ndarray, n: int) -> np.ndarray:
    """Remap row-index VALUES through newpos, keeping anything outside
    [0, n) (-1 sentinels and capacity-drop indices)."""
    ok = (arr >= 0) & (arr < n)
    out = arr.copy()
    out[ok] = newpos[arr[ok]]
    return out


def _morton_permute_sample(buf: Dict[str, list], capacities) -> None:
    """In place: re-order every level's voxel rows into Morton order and remap
    every row-valued index array consistently."""
    nlev = len(capacities)
    perms, newposes, ns = [], [], []
    for li in range(nlev):
        n = int(buf["nums"][li][0])
        coords = buf["coords"][li][:n] // (1 << li)
        perm = np.argsort(_morton_code(coords), kind="stable")
        newpos = np.empty(n, np.int64)
        newpos[perm] = np.arange(n)
        perms.append(perm)
        newposes.append(newpos)
        ns.append(n)
    for li in range(nlev):
        perm, n = perms[li], ns[li]
        for key in ("coords", "voxxyz"):
            buf[key][li][:n] = buf[key][li][perm]
        nbr = buf["nbr27"][li]
        nbr[:, :n] = nbr[:, perm]
        nbr[:] = _remap_vals(nbr, newposes[li], n)
        if li >= 1:
            dn = buf["down8"][li]
            dn[:, :n] = dn[:, perm]
            dn[:] = _remap_vals(dn, newposes[li - 1], ns[li - 1])
        if li < nlev - 1:
            par = buf["parent"][li]
            par[:n] = par[perm]
            par[:] = _remap_vals(par, newposes[li + 1], ns[li + 1])
            kof = buf["koff"][li]
            kof[:n] = kof[perm]
        buf["p2v"][li][:] = _remap_vals(buf["p2v"][li], newposes[li], n)
        buf["dvi"][li][:] = _remap_vals(buf["dvi"][li], newposes[li], n)


def _alloc(b: int, p: int, capacities: Sequence[int]) -> Dict[str, list]:
    """Batch output buffers, one [B, ...] array per (key, level); each
    sample's build writes straight into its slice."""
    return dict(
        coords=[np.zeros((b, c, 3), np.int32) for c in capacities],
        vmask=[np.zeros((b, c), np.uint8) for c in capacities],
        nums=[np.zeros((b, 1), np.int32) for _ in capacities],
        nbr27=[np.zeros((b, 27, c), np.int32) for c in capacities],
        down8=[np.zeros((b, 8, c), np.int32) for c in capacities],
        parent=[np.zeros((b, c), np.int32) for c in capacities],
        koff=[np.zeros((b, c), np.int32) for c in capacities],
        voxxyz=[np.zeros((b, c, 3), np.float32) for c in capacities],
        p2v=[np.zeros((b, p), np.int32) for _ in capacities],
        dvi=[np.zeros((b, p, 8), np.int32) for _ in capacities],
        dvw=[np.zeros((b, p, 8), np.float32) for _ in capacities],
    )


def _build_sample(pcoords: np.ndarray, pxyz: np.ndarray, pmask: np.ndarray,
                  capacities: Sequence[int], buf: Dict[str, list]) -> None:
    """Plumbing of one sample, written into ``buf``: per key, one
    C-contiguous output view per level (see :func:`batch_plumbing`)."""
    lib = native.load()
    caps = np.asarray(capacities, np.int64)
    pc = np.ascontiguousarray(pcoords, np.float32)
    px = np.ascontiguousarray(pxyz, np.float32)
    pm = np.ascontiguousarray(pmask, np.uint8)
    tables = []
    for k in KEYS:
        for a in buf[k]:
            if not a.flags.c_contiguous:
                raise ValueError(f"plumbing buffer {k} is not C-contiguous")
        tables.append((ctypes.c_void_p * len(buf[k]))(*[a.ctypes.data for a in buf[k]]))
    lib.build_plumbing_host(pc.ctypes.data, px.ctypes.data, pm.ctypes.data, len(pc),
                            caps.ctypes.data, len(capacities),
                            *[ctypes.addressof(t) for t in tables])
    _morton_permute_sample(buf, capacities)


def batch_plumbing(pcoords: np.ndarray, pxyz: np.ndarray, pmask: np.ndarray,
                   capacities: Sequence[int], wgeom_params: Dict = None) -> Dict[str, list]:
    """Plumbing of a [B, P, ...] batch, per-level arrays with a leading B.

    ``wgeom_params`` (``wgeom_host.params_from_model``) adds the window
    geometry of the attention branches over the whole batch (the JAX
    package's arrays with its leading shard axis dropped: the port has no
    data-parallel shards yet), over the flat voxel means ``voxxyz`` or, for
    a spec with ``recursive_xyz`` (the SphereFormer U-Net's), over
    :func:`recursive_vox_xyz`."""
    b = len(pcoords)
    out = _alloc(b, pcoords.shape[1], capacities)

    def _build(i):
        _build_sample(pcoords[i], pxyz[i], pmask[i], capacities,
                      {k: [lv[i] for lv in out[k]] for k in out})

    # the native builder releases the GIL, so samples build in parallel
    workers = min(b, os.cpu_count() or 1)
    if workers > 1:
        with ThreadPoolExecutor(max_workers=workers) as ex:
            list(ex.map(_build, range(b)))
    else:
        for i in range(b):
            _build(i)
    if wgeom_params is not None:
        from u2mkd_tpu_torch.data import wgeom_host

        xyz = out["voxxyz"]
        if wgeom_params.get("recursive_xyz"):
            xyz = recursive_vox_xyz(out["voxxyz"][0], out["down8"], out["vmask"])
        out["wgeom"] = wgeom_host.batch_window_geometry(xyz, out["vmask"], wgeom_params)
    return out


def recursive_vox_xyz(xyz0: np.ndarray, down8: Sequence[np.ndarray],
                      vmask: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Per-level voxel xyz [B, V_L, 3] f32 by recursive mean-of-means: level
    0 is ``xyz0`` (the plumbing's ``voxxyz[0]``); each coarser voxel is the
    mean of its live ``down8`` rows at the finer level (the SphereFormer
    U-Net's coordinate tracking). The host twin of
    ``models/plumbing.recursive_vox_xyz`` and of the JAX package's, in its
    order of f32 operations: a masked sum over the 8 offsets in offset order
    from 0, then one division by max(count, 1); dead voxels get 0. The
    window keys and in-window quantization depend on the last bit."""
    out = [np.asarray(xyz0, np.float32)]
    for li in range(1, len(vmask)):
        prev, nbr = out[-1], np.asarray(down8[li])          # [B, Vp, 3], [B, 8, V]
        ok = nbr >= 0
        rows = np.clip(nbr, 0, prev.shape[1] - 1)
        s = np.zeros(nbr.shape[:1] + nbr.shape[2:] + (3,), np.float32)
        for k in range(nbr.shape[1]):
            vals = np.take_along_axis(prev, rows[:, k, :, None], axis=1)
            s += np.where(ok[:, k, :, None], vals, np.float32(0.0))
        c = np.maximum(ok.sum(axis=1).astype(np.float32), np.float32(1.0))[..., None]
        live = np.asarray(vmask[li]).astype(bool)[..., None]
        out.append(np.where(live, s / c, np.float32(0.0)))
    return out
