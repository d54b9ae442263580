"""Window attention with contextual relative position encoding, in plain
PyTorch: the plain version of kernel K3 (``ops/kernels/wattn_kernel.py``).

Port of the semantics of ``u2mkd_tpu/ops/wattn.py`` (``_rel_indices``,
``_tile_attention``) over host-built window geometry
(``data/wgeom_host.py``): the rows arrive window-sorted, each window a
contiguous run of equal ``rank``. For query i and key j of one window:

  * difference axes: bin = clip(q_i, 0, G-1) - clip(q_j, 0, G-1) + G - 1;
  * radial axis (sphere branch, ``r`` given): bin =
    clip(exponential_split_index(r_i - r_j), 0, 2G - 1);
  * score = q_i.k_j + sum_a q_i.Tq[bin_a, a] + sum_a k_j.Tk[bin_a, a], the
    sum running over all three axes;
  * out_i = sum_j softmax_j(score) (v_j + sum_a Tv[bin_a, a]).

This version enumerates every (query, key) pair of every window, which is
exact and independent of the kernel's tiling.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

# pairs per chunk, times heads: bounds the plain version's transient memory
_PAIR_BUDGET = 1 << 22


def exponential_split_index(rel_r: torch.Tensor, a: float) -> torch.Tensor:
    """Radial relative position -> RPE bin (reference ``exponential_split``):
    bins start at width ``a`` around 0 and double every two bins; the sign
    mirrors; +24 offset. Unclipped."""
    rel_abs = rel_r.abs()
    flag = (rel_r >= 0).to(rel_r.dtype)
    idx = 2.0 * torch.floor(torch.log((rel_abs + 2 * a) / a) / math.log(2.0)) - 2.0
    idx = idx + ((3.0 * torch.pow(2.0, torch.floor(idx / 2.0)) - 2.0) * a
                 <= rel_abs).to(rel_r.dtype)
    idx = idx * (2.0 * flag - 1.0) + (flag - 1.0)
    return idx.to(torch.int32) + 24


def table_projections(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x [N, h, d], table [L2, 3, h, d] -> [N, h, 3, L2] f32: x_i . T[l, a]."""
    return torch.einsum("nhd,lahd->nhal", x.float(), table.float()).contiguous()


def window_attention_rpe(qs: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
                         rank: torch.Tensor, quant: torch.Tensor,
                         r: Optional[torch.Tensor], table_q: torch.Tensor,
                         table_k: torch.Tensor, table_v: torch.Tensor,
                         grid_len: int, a: float) -> torch.Tensor:
    """Window-sorted qs/ks/vs [N, h, d] (q pre-scaled), rank [N], quant
    [N, 3], r [N] or None -> f32 [N, h, d]."""
    n, h, d = qs.shape
    g = int(grid_len)
    dev = qs.device
    q, k, v = qs.float(), ks.float(), vs.float()
    tv = table_v.float()
    qT = table_projections(q, table_q)
    kT = table_projections(k, table_k)
    cq = quant.long().clamp(0, g - 1)

    # each row's window: the run of equal rank that holds it
    new = torch.ones(n, dtype=torch.bool, device=dev)
    new[1:] = rank[1:] != rank[:-1]
    run = torch.cumsum(new.long(), 0) - 1
    starts = torch.nonzero(new)[:, 0]
    counts = torch.bincount(run)
    start_i, cnt_i = starts[run], counts[run]
    cum = torch.cumsum(cnt_i, 0)

    out = torch.empty(n, h, d, dtype=torch.float32, device=dev)
    budget = max(_PAIR_BUDGET // h, int(cnt_i.max()))
    lo = 0
    while lo < n:
        base = int(cum[lo - 1]) if lo else 0
        hi = int(torch.searchsorted(cum, base + budget, right=True))
        hi = max(hi, lo + 1)
        qi = torch.repeat_interleave(torch.arange(lo, hi, device=dev),
                                     cnt_i[lo:hi])
        first = torch.repeat_interleave(cum[lo:hi] - cnt_i[lo:hi] - base,
                                        cnt_i[lo:hi])
        kj = start_i[qi] + torch.arange(len(qi), device=dev) - first

        idx = cq[qi] - cq[kj] + g - 1                               # [M, 3]
        if r is not None:
            rb = exponential_split_index(r[qi] - r[kj], a).long()
            idx[:, 2] = rb.clamp(0, 2 * g - 1)
        s = (q[qi] * k[kj]).sum(-1)                                 # [M, h]
        for ax in range(3):
            sel = idx[:, ax][:, None, None].expand(-1, h, 1)
            s = s + qT[qi, :, ax].gather(2, sel)[..., 0] \
                + kT[kj, :, ax].gather(2, sel)[..., 0]
        seg = qi - lo
        smax = torch.full((hi - lo, h), -math.inf, device=dev).scatter_reduce(
            0, seg[:, None].expand(-1, h), s, "amax")
        e = torch.exp(s - smax[seg])
        den = torch.zeros(hi - lo, h, device=dev).index_add_(0, seg, e)
        p = e / den[seg]
        val = (v[kj] + tv[idx[:, 0], 0] + tv[idx[:, 1], 1]
               + tv[idx[:, 2], 2])                                  # [M, h, d]
        out[lo:hi] = torch.zeros(hi - lo, h, d, device=dev).index_add_(
            0, seg, p[..., None] * val)
        lo = hi
    return out
