"""Fixed-capacity sparse structures, as plain dataclasses of tensors.

Port of ``u2mkd_tpu/core/structures.py``. Every tensor of a model's
plumbing carries a leading batch axis ``B`` (the device build,
``models/plumbing.build_plumbing``, works on one sample's, without it). The
grids come from the host pipeline (``data/plumbing_host.py``), which
resolves every voxel lookup and keeps no key tables, or from the device
build, which keeps them; the TPU conv tiling (``conv_jl/jn/kr``) has no
counterpart, because the CUDA rulebook conv reads the rulebook directly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class VoxelGrid:
    """The active voxels of one U-Net level, ``stride`` in finest-grid units.
    The forward reads only the mask. The device build also keeps what its
    lookups need, the coordinates (multiples of ``stride``, 0 on dead rows),
    the sorted packed-key table (``ops/hashing.py``) and the number of live
    rows; a grid from the host pipeline leaves them on the host (None)."""

    mask: torch.Tensor    # [B, V] bool
    stride: int
    coords: Optional[torch.Tensor] = None  # [B, V, 3] int32
    key: Optional[torch.Tensor] = None     # [B, V] int64, ascending, PACKED_INVALID pads
    num: Optional[torch.Tensor] = None     # [B] int32

    @property
    def capacity(self) -> int:
        return self.mask.shape[-1]


@dataclass
class WindowGeom:
    """Host-built window geometry of one attention branch at one level
    (``data/wgeom_host.py``) over the flattened ``[B*V]`` voxel batch."""

    order: torch.Tensor  # [pad_to] int64 gather order (pads -> row 0, own window)
    inv: torch.Tensor    # [B*V] int64 inverse permutation
    rank: torch.Tensor   # [pad_to] f32 dense window id in sorted order
    quant: torch.Tensor  # [pad_to, 3] int32 quantized in-window coords (sorted)
    kmin: torch.Tensor   # [pad_to / tile] int32 first key row of each query tile
    kmax: torch.Tensor   # [pad_to / tile] int32 end of the tile's key rows
    r: Optional[torch.Tensor] = None  # [pad_to] f32 range (sphere branch)


@dataclass
class LevelContext:
    """Per-level rulebooks shared by every conv of the level.

      nbr27:     [B, 27, V] int32 rows of the 3x3x3 neighbours (-1 absent),
                 as the host pipeline builds them and the CUDA conv reads them;
      down_nbr8: [B, 8, V] rows of the finer level feeding each voxel through
                 the ks=2/s=2 conv (None at level 0);
      up_parent: [B, V] row of the coarser level each voxel receives from in
                 the transposed conv, with ``up_koff`` [B, V] its offset in
                 [0, 8) (None at the deepest level);
      conv_plan: what the CUDA conv kernels read of ``nbr27``
                 (``ops/kernels/spconv_kernel.ConvPlan``), built on the
                 device at the level's first kernel conv and kept for the
                 level's other convs and their gradients.
    """

    grid: VoxelGrid
    nbr27: torch.Tensor
    down_nbr8: Optional[torch.Tensor] = None
    up_parent: Optional[torch.Tensor] = None
    up_koff: Optional[torch.Tensor] = None
    conv_plan: Optional[object] = None
