"""Capacity observability (port of ``u2mkd_tpu/train/overflow.py``).

The fixed-capacity design drops data silently when a capacity is too small:
a voxel grid that saturates drops the voxels past its capacity, and the
banded attention (``ops/wattn.sparse_window_attention``) drops the pairs of
a window that holds more than ``band * tile`` rows; no loss or metric shows
either. :func:`stats_for_model` gives a step's counters as device tensors,
so a step that carries them waits for nothing; the loop fetches them every
``log_every`` steps, logs them and, with ``train.strict_capacity``,
:func:`check_aux` fails the run.

The violation policy is the JAX package's: a full grid always counts; a
window occupancy counts only on a branch that runs banded
(``pallas_attention`` off, or ``pallas_cubic`` off for the cubic branch),
as kernel K3 is exact at any occupancy. The occupancies come from the host
window geometry where the plumbing carries it (``UNetPlumbing.window_occ``,
the model's own windows at the levels its geometry covers), and are
computed in the step otherwise (:func:`max_window_occupancy` over the
plumbing's voxel means, SPVCNN's windows of levels 1-4, as the JAX counters
take them for any model). So for the SphereFormer U-Net on host geometry
(levels 0-4, the recursive means) the two packages' occupancies differ.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import torch

from u2mkd_tpu_torch.models.plumbing import UNetPlumbing
from u2mkd_tpu_torch.ops import hashing, wattn


def max_window_occupancy(xyz: torch.Tensor, valid: torch.Tensor,
                         window_size: Sequence[float]) -> torch.Tensor:
    """The largest window occupancy [] int64 of one sample's rows xyz
    [V, 3] (valid [V]), on the device, without a host sync."""
    key_s = torch.sort(wattn.window_keys(xyz, valid, window_size)).values
    start, end = wattn.window_bounds_from_sorted(key_s)
    run = torch.where(key_s != hashing.PACKED_INVALID, end - start, 0)
    return run.max().to(torch.int64)


def _level_windows(model) -> List[Tuple[Tuple[float, ...], Tuple[float, ...]]]:
    """Per attention level 1-4 the (cubic, sphere) window sizes, doubling as
    SPVCNN's encoder doubles them."""
    ws, wss = list(model.window_size), list(model.window_size_sphere)
    wsc, wss_scale = model.window_size_scale
    out = []
    for _ in range(4):
        out.append((tuple(ws), tuple(wss)))
        ws = [w * wsc for w in ws]
        wss = [wss[0] * wss_scale, wss[1] * wss_scale, wss[2]]
    return out


def _occupancies(model, pl: UNetPlumbing) -> Dict[int, Tuple[torch.Tensor, torch.Tensor]]:
    """{level: (cubic, sphere) largest occupancy over the batch}."""
    if pl.window_occ is not None:
        return {pl.wgeom_first + j: (pl.window_occ[0, j], pl.window_occ[1, j])
                for j in range(pl.window_occ.shape[1])}
    out = {}
    for li, (ws, wss) in enumerate(_level_windows(model), start=1):
        if li >= len(pl.levels):
            break
        xyz, mask = pl.vox_xyz[li], pl.levels[li].grid.mask
        occ_c = torch.stack([max_window_occupancy(x, m, ws) for x, m in zip(xyz, mask)]).max()
        occ_s = torch.stack([max_window_occupancy(wattn.cart2sphere(x), m, wss)
                             for x, m in zip(xyz, mask)]).max()
        out[li] = (occ_c.to(torch.int32), occ_s.to(torch.int32))
    return out


def stats_for_model(model, pl: UNetPlumbing) -> Dict[str, torch.Tensor]:
    """Flat counters of one batch's plumbing for ``model``: per level the
    fill of its voxel grid (the fullest sample's valid voxels over the
    capacity, ``overflow/vox_fill_l{i}``); for a model with SphereFormer
    blocks, per attention level the largest window occupancy of either
    branch (``overflow/occ_cubic_l{i}``, ``overflow/occ_sphere_l{i}``); and
    ``overflow/violations``: the grids that are full, where voxels may have
    been dropped, and the banded branches' levels whose occupancy passes
    ``band * tile`` (``model.band_cubic``, ``band_sphere`` and ``tile``,
    the JAX model's defaults 1, 4 and 128), where pairs were dropped."""
    out = {}
    violations = torch.zeros((), dtype=torch.int32, device=pl.pmask.device)
    for li, lv in enumerate(pl.levels):
        cap = lv.grid.capacity
        count = lv.grid.mask.sum(dim=-1, dtype=torch.int32).max()
        out[f"overflow/vox_fill_l{li}"] = count.to(torch.float32) / cap
        violations = violations + (count >= cap).to(torch.int32)
    if getattr(model, "sphereformer", True):
        tile = int(getattr(model, "tile", 128))
        band_cubic = int(getattr(model, "band_cubic", 1))
        band_sphere = int(getattr(model, "band_sphere", 4))
        flash = bool(getattr(model, "pallas_attention", False))
        flash_cubic = flash and bool(getattr(model, "pallas_cubic", True))
        for li, (occ_c, occ_s) in _occupancies(model, pl).items():
            out[f"overflow/occ_cubic_l{li}"] = occ_c
            out[f"overflow/occ_sphere_l{li}"] = occ_s
            if not flash_cubic:
                violations = violations + (occ_c > band_cubic * tile).to(torch.int32)
            if not flash:
                violations = violations + (occ_s > band_sphere * tile).to(torch.int32)
    out["overflow/violations"] = violations
    return out


def check_aux(aux: Mapping, strict: bool) -> None:
    """Host-side guard on fetched aux values (numbers or tensors): with
    ``strict``, raise when any clipping condition was active."""
    v = aux.get("overflow/violations")
    if v is None:
        return
    if strict and int(v) > 0:
        details = {k: float(x) for k, x in aux.items() if k.startswith("overflow/")}
        raise RuntimeError(f"capacity overflow: {int(v)} clipping condition(s) active: data is "
                           f"being silently dropped (undersized capacities). Counters: {details}")
