"""Sparse 3D convolution over cached rulebooks, in plain PyTorch.

Port of ``u2mkd_tpu/ops/spconv.py``: the rulebooks come from the host
pipeline or from :func:`build_levels` on the device; the other functions
apply them. Per sample, in the JAX package's layout; weights are
``[K, Cin, Cout]``. The ks=3 stride-1 conv of the models runs through the
CUDA kernel (``ops/kernels/spconv_kernel.py``), for which
:func:`sparse_conv` is the plain version.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from u2mkd_tpu_torch.core.structures import LevelContext, VoxelGrid
from u2mkd_tpu_torch.ops import hashing, segment
from u2mkd_tpu_torch.ops.precision import cast_compute


def kernel_offsets(ks: int) -> np.ndarray:
    """Integer kernel offsets [K, 3]: ks=3 -> {-1,0,1}^3 (27), ks=2 ->
    {0,1}^3 (8), ks=1 -> {0}; (0,0,0) first, then z-fastest. The host
    rulebooks and the weights' K axis share this order."""
    rng = {1: [0], 2: [0, 1], 3: [-1, 0, 1]}[ks]
    offs = [(dx, dy, dz) for dz in rng for dy in rng for dx in rng]
    offs.sort(key=lambda o: o != (0, 0, 0))
    return np.asarray(offs, np.int32)


def rev_perm_27() -> np.ndarray:
    """rev[k] = index of -offset[k] in the ks=3 offset order. (0,0,0) comes
    first, so this is not ``26 - k``. The host rulebook is symmetric under
    it: ``nbr[rev[k], nbr[k, v]] == v`` wherever ``nbr[k, v]`` is valid."""
    offs = kernel_offsets(3)
    lut = {tuple(o): i for i, o in enumerate(offs)}
    return np.asarray([lut[tuple(-o)] for o in offs], np.int32)


def gather_rows(feats: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``feats[rows]`` with zero rows where ``rows`` is -1 or >= len(feats).
    The backward sums each row's gradients in a fixed order
    (``ops/segment.take``)."""
    return segment.take(feats, rows)


def sparse_conv(feats: torch.Tensor, nbr: torch.Tensor,
                weight: torch.Tensor) -> torch.Tensor:
    """feats [Vin, Cin], nbr [K, Vout] rows into feats, weight [K, Cin, Cout]
    -> [Vout, Cout]: sum over k of gather(feats, nbr[k]) @ weight[k], each
    product in f32 from compute-dtype inputs (the JAX 'scan' strategy)."""
    acc = torch.zeros(nbr.shape[1], weight.shape[-1], dtype=torch.float32,
                      device=feats.device)
    for k in range(weight.shape[0]):
        g, w = cast_compute(gather_rows(feats, nbr[k]), weight[k])
        acc += g.float() @ w.float()
    return acc.to(feats.dtype)


def down_conv(feats: torch.Tensor, down_nbr8: torch.Tensor,
              weight: torch.Tensor) -> torch.Tensor:
    """ks=2/s=2 downsample: gather the 8 finer rows of each coarse voxel
    (``down_nbr8`` [8, Vc]) into one [Vc, 8*Cin] matrix and multiply by the
    flattened [8*Cin, Cout] weight."""
    k, cin, cout = weight.shape
    g = gather_rows(feats, down_nbr8).permute(1, 0, 2).reshape(-1, k * cin)
    g, w = cast_compute(g, weight.reshape(k * cin, cout))
    return (g.float() @ w.float()).to(feats.dtype)


def sparse_conv_transposed_2x2(feats: torch.Tensor, up_parent: torch.Tensor,
                               up_koff: torch.Tensor,
                               weight: torch.Tensor) -> torch.Tensor:
    """Transposed ks=2/s=2 conv onto the cached finer coords: each fine voxel
    gets its parent's row (``up_parent`` [Vf] into feats [Vc, Cin]) times
    ``weight[up_koff]``. One matmul against all 8 slices, then each row picks
    its own slice."""
    k, cin, cout = weight.shape
    g, w = cast_compute(gather_rows(feats, up_parent), weight)
    y = g.float() @ w.float().permute(1, 0, 2).reshape(cin, k * cout)
    y = y.view(-1, k, cout)
    # each row's own slice: rows v * k + koff of the [V * k, Cout] products
    sel = torch.arange(y.shape[0], device=y.device) * k + up_koff.long().clamp(0, k - 1)
    return segment.take(y.view(-1, cout), sel).to(feats.dtype)


def build_nbr(grid: VoxelGrid, ks: int) -> torch.Tensor:
    """Neighbour rulebook [K, V] int32 of one sample's grid: the row of each
    kernel-offset neighbour (offsets times the stride), -1 where absent."""
    offs = torch.as_tensor(kernel_offsets(ks) * grid.stride, device=grid.coords.device)
    qc = grid.coords[None] + offs[:, None, :]                       # [K, V, 3]
    qvalid = grid.mask[None].expand(qc.shape[:2])
    return hashing.lookup_coords(qc, qvalid, grid.key).to(torch.int32)


def downsample_grid(grid: VoxelGrid, capacity: int) -> Tuple[VoxelGrid, torch.Tensor,
                                                               torch.Tensor]:
    """The 2x coarser grid of one sample's grid: unique(floor(c / 2s) * 2s)
    over the live voxels, the active set of the ks=2/s=2 conv. -> (coarse
    grid, child2parent [V] int32 row of each voxel's parent or -1,
    child_koff [V] int32 its offset in ``kernel_offsets(2)`` order)."""
    s2 = grid.stride * 2
    parent = torch.div(grid.coords, s2, rounding_mode="floor") * s2
    table, inverse, _, num = hashing.unique_keys(hashing.pack_coords(parent, grid.mask),
                                                 capacity)
    vmask = table != hashing.PACKED_INVALID
    vcoords = torch.where(vmask[:, None], hashing.unpack_coords(table), 0)
    coarse = VoxelGrid(mask=vmask, stride=s2, coords=vcoords, key=table, num=num)
    child2parent = torch.where(inverse < capacity, inverse, -1).to(torch.int32)
    d = torch.div(grid.coords - parent, grid.stride, rounding_mode="floor").clamp(0, 1)
    lut = np.zeros((2, 2, 2), np.int32)
    for k, (dx, dy, dz) in enumerate(kernel_offsets(2)):
        lut[dx, dy, dz] = k
    lut = torch.as_tensor(lut.reshape(-1), device=d.device)
    child_koff = lut[(d[:, 0] * 4 + d[:, 1] * 2 + d[:, 2]).long()]
    return coarse, child2parent, child_koff


def build_down_nbr8(coarse: VoxelGrid, fine: VoxelGrid) -> torch.Tensor:
    """Rulebook [8, Vcoarse] int32 of the finer rows feeding each coarse
    voxel through the ks=2/s=2 conv (-1 absent)."""
    offs = torch.as_tensor(kernel_offsets(2) * fine.stride, device=coarse.coords.device)
    qc = coarse.coords[None] + offs[:, None, :]                     # [8, Vc, 3]
    qvalid = coarse.mask[None].expand(qc.shape[:2])
    return hashing.lookup_coords(qc, qvalid, fine.key).to(torch.int32)


def build_levels(grid0: VoxelGrid, capacities: Sequence[int]) -> List[LevelContext]:
    """One sample's U-Net levels from its level-0 grid: per level the grid
    (``capacities[i]`` rows), the 27-neighbour rulebook, the down rulebook
    from the finer level and the up maps (parent row and offset) into the
    coarser one, unbatched."""
    levels = [LevelContext(grid=grid0, nbr27=build_nbr(grid0, 3))]
    for cap in capacities[1:]:
        fine = levels[-1]
        coarse, fine.up_parent, fine.up_koff = downsample_grid(fine.grid, int(cap))
        levels.append(LevelContext(grid=coarse, nbr27=build_nbr(coarse, 3),
                                   down_nbr8=build_down_nbr8(coarse, fine.grid)))
    return levels
