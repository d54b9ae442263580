"""Exact packed coordinate keys (port of ``pack_coords`` of
``u2mkd_tpu/ops/hashing.py``).

The JAX package packs int32 coords [N, 3] into a pair of uint32 keys:
hi = x + BIAS, lo = (y + BIAS) << 16 | (z + BIAS), with invalid rows (and
rows outside [-BIAS, BIAS - 1]) set to (INVALID_KEY, INVALID_KEY), which
compares greater than every valid key. PyTorch has poor uint32 support, so
the port carries the pair as one int64, ``hi << 32 | lo``: valid keys stay
below 2^48, and the invalid pair becomes :data:`PACKED_INVALID`, the largest
int64, so one int64 comparison orders rows as the JAX two-key sort does.
"""

from __future__ import annotations

from typing import Tuple

import torch

COORD_BIAS = 1 << 15         # coords valid in [-32768, 32767]
INVALID_KEY = 0xFFFFFFFF     # the JAX package's uint32 invalid key half
PACKED_INVALID = torch.iinfo(torch.int64).max  # (INVALID_KEY, INVALID_KEY), packed


def pack_coords(coords: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """int coords [N, 3], valid [N] -> packed int64 keys [N]; invalid and
    out-of-range rows get :data:`PACKED_INVALID`."""
    ci = coords.to(torch.int64)
    valid = valid & ((ci >= -COORD_BIAS) & (ci < COORD_BIAS)).all(dim=-1)
    c = ci + COORD_BIAS
    key = (c[:, 0] << 32) | (c[:, 1] << 16) | (c[:, 2] & 0xFFFF)
    return torch.where(valid, key, PACKED_INVALID)


def unpack_key(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed keys -> the JAX package's (hi, lo) uint32 values, as int64."""
    invalid = key == PACKED_INVALID
    hi = torch.where(invalid, INVALID_KEY, key >> 32)
    lo = torch.where(invalid, INVALID_KEY, key & 0xFFFFFFFF)
    return hi, lo
