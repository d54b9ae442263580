"""Host-side window geometry for the attention kernel.

Port of ``u2mkd_tpu/data/wgeom_host.py`` (native builder only). Per
attention level and branch, the flattened [B*V] voxel batch is window-sorted
on the host; the device gathers by ``order``, runs the kernel over each
128-row query tile's key range [kmin, kmax), and gathers back by ``inv``.
Arrays per level and branch (see ``core.structures.WindowGeom``): order,
inv, rank, quant, kmin, kmax, occ, and r on the sphere branch.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from u2mkd_tpu_torch.data import native

_BASE_LEVEL_CHANNELS = (32, 64, 128, 256)  # SPVCNN cs[1..4]
_VMEM_BUDGET = 15 << 20
_VMEM_BYTES_PER_UNIT = 45


def branch_tile(h: int, d: int, g: int, radial: bool) -> int:
    """Query tile of one attention branch: the JAX package's choice
    (``wattn_kernel.branch_tile``, a TPU VMEM bound) copied here so that the
    host geometry matches the JAX package's. At every width of the models it
    is 128, the tile the CUDA kernel takes."""
    def pad128(w):
        return max(128, -(-w // 128) * 128)

    n_diff = 2 if radial else 3
    lr = 2 * g if radial else 0
    sk = pad128(d + 2 * n_diff * g + 2 * lr)
    sv = pad128(d + n_diff * g + lr)
    t = 128
    while t > 32 and _VMEM_BYTES_PER_UNIT * t * (sk + sv) > _VMEM_BUDGET:
        t //= 2
    return t


def cart2sphere(xyz: np.ndarray) -> np.ndarray:
    """float32 (x, y, z) -> (theta_deg, beta_deg, r)."""
    xyz = xyz.astype(np.float32)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    theta = (np.arctan2(y, x) + np.float32(math.pi)) * np.float32(180.0 / math.pi)
    beta = np.arctan2(np.sqrt(x * x + y * y), z) * np.float32(180.0 / math.pi)
    r = np.sqrt(x * x + y * y + z * z)
    return np.stack([theta, beta, r], axis=-1).astype(np.float32)


def heads_for_levels(cr: float, head_dim: int) -> List[Tuple[int, int, int]]:
    """Per-level (h_cubic, h_sphere, head_dim) of a SPVCNN encoder."""
    out = []
    for c in _BASE_LEVEL_CHANNELS:
        h = max(2, int(cr * c) // head_dim)
        out.append((h // 2, h - h // 2, head_dim))
    return out


def level_window_params(window_size, window_size_sphere, quant_size,
                        quant_size_sphere, window_size_scale, n_levels: int = 4,
                        heads=None) -> List[Dict]:
    """Per-attention-level (cubic, sphere) window and quantization sizes,
    doubling per level as both models do; entry i is the i-th attention
    level (U-Net level i+1 of a SPVCNN encoder, level i of the SphereFormer
    U-Net). With ``heads`` each entry also carries the branch tiles."""
    ws = [float(w) for w in window_size]
    qs = [float(q) for q in quant_size]
    wss = [float(w) for w in window_size_sphere]
    qss = [float(q) for q in quant_size_sphere]
    wsc, wss_scale = float(window_size_scale[0]), float(window_size_scale[1])
    out = []
    for li in range(n_levels):
        entry = dict(ws=tuple(ws), qs=tuple(qs), wss=tuple(wss), qss=tuple(qss))
        if heads is not None:
            h1, h2, d = heads[li]
            entry["tile_cubic"] = branch_tile(h1, d, int((ws[0] + 1e-4) / qs[0]), False)
            entry["tile_sphere"] = branch_tile(h2, d, int((wss[0] + 1e-4) / qss[0]), True)
        out.append(entry)
        ws = [w * wsc for w in ws]
        qs = [q * wsc for q in qs]
        wss = [wss[0] * wss_scale, wss[1] * wss_scale, wss[2]]
        qss = [qss[0] * wss_scale, qss[1] * wss_scale, qss[2]]
    return out


def unet_heads(n_planes: Sequence[int], head_dim: int) -> List[Tuple[int, int, int]]:
    """Per-level (h_cubic, h_sphere, head_dim) of the SphereFormer U-Net:
    ``n_planes[i] // head_dim`` heads at level i, split h // 2 and
    h - h // 2 (``models/sphereformer_unet.py``)."""
    out = []
    for c in n_planes:
        h = int(c) // head_dim
        out.append((h // 2, h - h // 2, head_dim))
    return out


def params_from_model(model) -> Optional[Dict]:
    """Geometry spec from a model's window attributes; None for a model
    without SphereFormer blocks (the conv-only SPVCNN), which reads no
    window geometry, and for one whose branches all run banded
    (``pallas_attention`` off), which takes its windows in the step (the
    JAX package builds none then either). A SPVCNN encoder's spec covers levels 1..4 over the
    flat voxel means; the SphereFormer U-Net's (a model with ``n_planes``)
    covers levels 0..4 (``first_level`` 0) over the recursive means
    (``recursive_xyz``), its windows starting at the model's own and
    doubling per level by ``window_size_scale``."""
    if not getattr(model, "sphereformer", True) or not getattr(model, "pallas_attention",
                                                                 False):
        return None
    spec = dict(tile=128, branch_workers=min(8, os.cpu_count() or 1))
    if hasattr(model, "n_planes"):
        heads = unet_heads(model.n_planes, int(model.head_dim))
        spec.update(first_level=0, recursive_xyz=True)
    else:
        heads = heads_for_levels(float(model.cr), int(model.head_dim))
    spec["levels"] = level_window_params(
        model.window_size, model.window_size_sphere, model.quant_size,
        model.quant_size_sphere, model.window_size_scale, n_levels=len(heads),
        heads=heads)
    return spec


def branch_geometry(coords: np.ndarray, valid: np.ndarray, ws, qs, tile: int,
                    radial: bool) -> Dict[str, np.ndarray]:
    """Geometry of one branch over one [B, V] voxel batch (native
    ``build_wgeom_branch``)."""
    lib = native.load()
    b, v = valid.shape
    n = b * v
    pad_to = -(-n // tile) * tile
    c = np.ascontiguousarray(coords, np.float32)
    m = np.ascontiguousarray(valid, np.uint8)
    ws_ = np.ascontiguousarray(ws, np.float32)
    qs_ = np.ascontiguousarray(qs, np.float32)
    out = dict(
        order=np.empty(pad_to, np.int32), inv=np.empty(n, np.int32),
        rank=np.empty(pad_to, np.float32), quant=np.empty((pad_to, 3), np.int32),
        kmin=np.empty(pad_to // tile, np.int32),
        kmax=np.empty(pad_to // tile, np.int32), occ=np.empty(1, np.int32))
    if radial:
        out["r"] = np.empty(pad_to, np.float32)
    lib.build_wgeom_branch(
        c.ctypes.data, m.ctypes.data, b, v, ws_.ctypes.data, qs_.ctypes.data,
        tile, out["order"].ctypes.data, out["inv"].ctypes.data,
        out["rank"].ctypes.data, out["quant"].ctypes.data,
        out["kmin"].ctypes.data, out["kmax"].ctypes.data, out["occ"].ctypes.data,
        out["r"].ctypes.data if radial else None)
    return out


def batch_window_geometry(voxxyz: Sequence[np.ndarray],
                          vmask: Sequence[np.ndarray],
                          params: Dict) -> Dict[str, list]:
    """Geometry of the attention levels of one batch: {"cubic": [...],
    "sphere": [...]}, one dict per level from ``params["first_level"]``
    (1, a SPVCNN encoder's, unless the spec says otherwise) on. voxxyz/vmask
    are the per-level [B, V_L, 3] / [B, V_L] plumbing arrays."""
    tile = int(params["tile"])
    jobs = []
    for li, p in enumerate(params["levels"], start=int(params.get("first_level", 1))):
        xyz = np.asarray(voxxyz[li], np.float32)
        mask = np.asarray(vmask[li]).astype(bool)
        t_cub = min(tile, int(p.get("tile_cubic", tile)))
        t_sph = min(tile, int(p.get("tile_sphere", tile)))
        jobs.append(("cubic", xyz, mask, p["ws"], p["qs"], t_cub, False))
        jobs.append(("sphere", cart2sphere(xyz), mask, p["wss"], p["qss"],
                     t_sph, True))

    def run(j):
        return branch_geometry(*j[1:])

    # the native builder releases the GIL: the 8 branch builds run in parallel
    workers = min(int(params.get("branch_workers", 0) or 0), len(jobs))
    if workers > 1:
        with ThreadPoolExecutor(max_workers=workers) as ex:
            results = list(ex.map(run, jobs))
    else:
        results = [run(j) for j in jobs]
    out = {"cubic": [], "sphere": []}
    for j, res in zip(jobs, results):
        out[j[0]].append(res)
    return out
