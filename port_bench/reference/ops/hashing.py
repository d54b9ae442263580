"""Exact packed coordinate keys, sort-based unique and sorted-table lookup
(port of ``u2mkd_tpu/ops/hashing.py``).

The JAX package packs int32 coords [N, 3] into a pair of uint32 keys:
hi = x + BIAS, lo = (y + BIAS) << 16 | (z + BIAS), with invalid rows (and
rows outside [-BIAS, BIAS - 1]) set to (INVALID_KEY, INVALID_KEY), which
compares greater than every valid key. PyTorch has poor uint32 support, so
the port carries the pair as one int64, ``hi << 32 | lo``: valid keys stay
below 2^48, and the invalid pair becomes :data:`PACKED_INVALID`, the largest
int64, so one int64 comparison orders rows as the JAX two-key sort does.

Per sample, as in the JAX package; the tables are sorted by key, padded with
:data:`PACKED_INVALID`, and index math only (no gradients).
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


def unpack_coords(key: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_coords` for valid keys -> int32 [N, 3]."""
    x = (key >> 32) & 0xFFFFFFFF
    y = (key >> 16) & 0xFFFF
    z = key & 0xFFFF
    return (torch.stack([x, y, z], dim=-1) - COORD_BIAS).to(torch.int32)


def unique_keys(key: torch.Tensor, capacity: int):
    """Compact the distinct valid keys [N] into a sorted table of
    ``capacity`` rows, keeping the ``capacity`` smallest on overflow.

    Returns (table [capacity] int64 padded with PACKED_INVALID, inverse [N]
    int64 row of each key in the table, ``capacity`` for an invalid or
    dropped key, counts [capacity] int32 inputs per row, num [] int32 rows
    filled), the JAX package's tables exactly."""
    n = key.shape[0]
    dev = key.device
    key_s, sidx = torch.sort(key, stable=True)
    valid_s = key_s != PACKED_INVALID
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = key_s[1:] != key_s[:-1]
    first &= valid_s
    uid = torch.cumsum(first, 0) - 1
    in_table = valid_s & (uid < capacity) & (uid >= 0)
    uid = torch.where(in_table, uid, capacity)
    inverse = torch.empty(n, dtype=torch.int64, device=dev)
    inverse[sidx] = uid
    table = torch.full((capacity + 1,), PACKED_INVALID, dtype=torch.int64, device=dev)
    table.scatter_(0, uid, torch.where(in_table, key_s, PACKED_INVALID))
    counts = torch.zeros(capacity + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, uid, valid_s.to(torch.int32))
    num = (first & in_table).sum(dtype=torch.int32)
    return table[:capacity], inverse, counts[:capacity], num


def unique_keys_first(key: torch.Tensor, appear: torch.Tensor, capacity: int):
    """:func:`unique_keys` with the host builder's rule on overflow: the
    distinct keys are admitted in order of their first appearance (the
    least ``appear`` [N] among their rows), and the first ``capacity`` of
    them are kept, as ``native/pointcore.cpp`` admits voxels in the order it
    meets them. The table stays sorted by key. Returns (table, inverse,
    counts, num) as :func:`unique_keys` and each table row's appearance
    [capacity] (the int64 maximum on empty rows)."""
    n = key.shape[0]
    dev = key.device
    by_appear = torch.argsort(appear, stable=True)
    key_s, o2 = torch.sort(key[by_appear], stable=True)
    sidx = by_appear[o2]                    # by key, each key's rows by appearance
    ap_s = appear[sidx]
    valid_s = key_s != PACKED_INVALID
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = key_s[1:] != key_s[:-1]
    first &= valid_s
    gid = (torch.cumsum(first, 0) - 1).clamp(min=0)
    d_ap = ap_s[first]                      # each distinct key's first appearance
    rank = torch.empty_like(d_ap)
    rank[torch.argsort(d_ap, stable=True)] = torch.arange(d_ap.shape[0], device=dev)
    kept = rank < capacity
    trow = torch.cumsum(kept, 0) - 1
    if d_ap.shape[0]:
        uid = torch.where(valid_s & kept[gid], trow[gid], capacity)
    else:
        uid = torch.full((n,), capacity, dtype=torch.int64, device=dev)
    inverse = torch.empty(n, dtype=torch.int64, device=dev)
    inverse[sidx] = uid
    in_table = uid < capacity
    table = torch.full((capacity + 1,), PACKED_INVALID, dtype=torch.int64, device=dev)
    table.scatter_(0, uid, torch.where(in_table, key_s, PACKED_INVALID))
    counts = torch.zeros(capacity + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, uid, valid_s.to(torch.int32))
    table_ap = torch.full((capacity + 1,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                          device=dev)
    table_ap.scatter_(0, torch.where(first & in_table, uid, capacity),
                      torch.where(first & in_table, ap_s, torch.iinfo(torch.int64).max))
    num = kept.sum(dtype=torch.int32)
    return table[:capacity], inverse, counts[:capacity], num, table_ap[:capacity]


def lookup(qkey: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Row of each query key [...] in a sorted table [T], or -1 (int64);
    an invalid query finds nothing."""
    pos = torch.searchsorted(table, qkey.contiguous()).clamp(max=table.shape[0] - 1)
    found = (table[pos] == qkey) & (qkey != PACKED_INVALID)
    return torch.where(found, pos, -1)


def lookup_coords(query_coords: torch.Tensor, query_valid: torch.Tensor,
                  table: torch.Tensor) -> torch.Tensor:
    """:func:`pack_coords` then :func:`lookup`: coords [..., 3], valid [...]
    -> rows [...]."""
    key = pack_coords(query_coords.reshape(-1, 3), query_valid.reshape(-1))
    return lookup(key, table).reshape(query_coords.shape[:-1])
