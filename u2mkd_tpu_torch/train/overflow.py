"""Capacity observability (port of ``u2mkd_tpu/train/overflow.py``).

The fixed-capacity design drops data silently when a capacity is too small:
a voxel grid that saturates drops the voxels past its capacity, which no
loss or metric shows. :func:`stats_for_model` gives a step's counters as
device tensors, so a step that carries them waits for nothing; the loop
fetches them every ``log_every`` steps, logs them and, with
``train.strict_capacity``, :func:`check_aux` fails the run.

The port's attention kernels are exact at any window occupancy, as the JAX
package's flash path is (``overflow.py:83-88``): the occupancies are
recorded, and only grid saturation counts as a violation. They come from the
host window geometry (``UNetPlumbing.window_occ``), which the plumbing stage
builds; the JAX package's device-side ``max_window_occupancy``, for plumbing
built in the step, has no counterpart, as the port has only host geometry.
The occupancies are the model's own windows, at the levels its geometry
covers; the JAX counters measure SPVCNN's windows of levels 1-4 on the flat
voxel means for any model, so for the SphereFormer U-Net (levels 0-4, the
recursive means) the two packages' occupancies differ.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from u2mkd_tpu_torch.models.plumbing import UNetPlumbing


def stats_for_model(pl: UNetPlumbing) -> Dict[str, torch.Tensor]:
    """Flat counters of one batch's plumbing: per level the fill of its
    voxel grid (the fullest sample's valid voxels over the capacity,
    ``overflow/vox_fill_l{i}``), per attention level the largest window
    occupancy of either branch (``overflow/occ_cubic_l{i}``,
    ``overflow/occ_sphere_l{i}``, named by the level the windows belong
    to: 1-4 for a SPVCNN encoder, 0-4 for the SphereFormer U-Net, when the
    plumbing carries window geometry), and ``overflow/violations``: the number of grids that
    are full, where voxels may have been dropped."""
    out = {}
    violations = torch.zeros((), dtype=torch.int32, device=pl.pmask.device)
    for li, lv in enumerate(pl.levels):
        cap = lv.grid.capacity
        count = lv.grid.mask.sum(dim=-1, dtype=torch.int32).max()
        out[f"overflow/vox_fill_l{li}"] = count.to(torch.float32) / cap
        violations = violations + (count >= cap).to(torch.int32)
    if pl.window_occ is not None:
        for j in range(pl.window_occ.shape[1]):
            li = pl.wgeom_first + j
            out[f"overflow/occ_cubic_l{li}"] = pl.window_occ[0, j]
            out[f"overflow/occ_sphere_l{li}"] = pl.window_occ[1, j]
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
