"""Window attention with contextual relative position encoding, in plain
PyTorch: the plain versions of kernels K3 (forward), K4 and K5 (backward),
``ops/kernels/wattn_kernel.py``.

Port of the semantics of ``u2mkd_tpu/ops/wattn.py`` (``_rel_indices``,
``_tile_attention``) over host-built window geometry
(``data/wgeom_host.py``): the rows arrive window-sorted, each window a
contiguous run of equal ``rank``. For query i and key j of one window:

  * difference axes: bin = clip(q_i, 0, G-1) - clip(q_j, 0, G-1) + G - 1;
  * radial axis (sphere branch, ``r`` given): bin =
    clip(exponential_split_index(r_i - r_j), 0, 2G - 1);
  * score = q_i.k_j + sum_a qT[i, a, bin_a] + sum_a kT[j, a, bin_a], the sum
    running over all three axes, with qT = q . Tq and kT = k . Tk the table
    projections (:func:`table_projections`);
  * out_i = sum_j softmax_j(score) (v_j + sum_a Tv[bin_a, a]).

These versions enumerate every (query, key) pair of every window, which is
exact and independent of the kernels' tiling.

Also the RPE-free pieces of ``u2mkd_tpu/ops/wattn.py`` and
``u2mkd_tpu/ops/pallas/wattn_kernel.py`` behind kernel K2 (the window sort of
``sparse_window_attention_pallas``): :func:`cart2sphere`,
:func:`window_keys`, :func:`window_bounds_from_sorted`, and
:func:`window_attention_plain`, the plain version of K2.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Sequence, Tuple

import torch
import torch.utils.checkpoint

from u2mkd_tpu_torch.ops import hashing

# pairs per chunk, times heads: bounds the plain versions' transient memory
_PAIR_BUDGET = 1 << 22


def cart2sphere(xyz: torch.Tensor) -> torch.Tensor:
    """(x, y, z) -> (theta_deg in [0, 360], beta_deg, r), as the JAX
    package's ``wattn.cart2sphere``."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    theta = (torch.atan2(y, x) + math.pi) * (180.0 / math.pi)
    beta = torch.atan2(torch.sqrt(x * x + y * y), z) * (180.0 / math.pi)
    r = torch.sqrt(x * x + y * y + z * z)
    return torch.stack([theta, beta, r], dim=-1)


def window_keys(xyz: torch.Tensor, valid: torch.Tensor,
                window_size: Sequence[float]) -> torch.Tensor:
    """Packed window key [V] int64 of each row of xyz [V, 3] (unshifted
    windows): cell = floor((pos - start) / ws) in f32 with start the
    minimum over the valid rows (0 where there is none), packed by
    :func:`hashing.pack_coords`; invalid rows, and cells outside the packable
    range, get ``hashing.PACKED_INVALID``."""
    ws = torch.as_tensor(window_size, dtype=xyz.dtype, device=xyz.device)
    big = torch.where(valid[:, None], xyz, math.inf)
    start = big.min(dim=0).values
    start = torch.where(torch.isfinite(start), start, 0.0)
    cell = torch.floor((xyz - start) / ws).to(torch.int32)
    return hashing.pack_coords(cell, valid)


def window_starts(key_s: torch.Tensor) -> torch.Tensor:
    """Sorted window keys [N] -> bool [N]: True where a run of equal keys
    begins."""
    new = torch.ones(key_s.shape[0], dtype=torch.bool, device=key_s.device)
    new[1:] = key_s[1:] != key_s[:-1]
    return new


def window_bounds_from_sorted(key_s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted window keys [N] -> (seg_start, seg_end) int32 [N]: the first
    index and one past the last index of each row's run of equal keys."""
    return run_bounds(window_starts(key_s))


def run_bounds(new: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run starts [N] bool -> (seg_start, seg_end) int32 [N] of each row's
    run."""
    n = new.shape[0]
    idx = torch.arange(n, device=new.device)
    last = torch.ones_like(new)
    last[:-1] = new[1:]
    start = torch.cummax(torch.where(new, idx, 0), 0).values
    end = torch.flip(torch.cummin(torch.flip(torch.where(last, idx + 1, n), [0]), 0).values,
                     [0])
    return start.to(torch.int32), end.to(torch.int32)


def window_attention_plain(qs: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
                           rank: torch.Tensor) -> torch.Tensor:
    """Plain K2. Window-sorted qs/ks/vs [N, h, d] (q pre-scaled), rank [N]
    (equal within a window, windows contiguous) -> f32 [N, h, d]: the exact
    softmax of q_i . k_j over the keys of each row's own window."""
    n, h, d = qs.shape
    dev = qs.device
    q, k, v = qs.float(), ks.float(), vs.float()
    outs = []
    for lo, hi, qi, kj in _pair_chunks(rank, h):
        s = (q[qi] * k[kj]).sum(-1)                                   # [M, h]
        seg = qi - lo
        smax = torch.full((hi - lo, h), -math.inf, device=dev).scatter_reduce(
            0, seg[:, None].expand(-1, h), s, "amax")
        e = torch.exp(s - smax[seg])
        den = torch.zeros(hi - lo, h, device=dev).index_add(0, seg, e)
        num = torch.zeros(hi - lo, h, d, device=dev).index_add(0, seg, e[..., None] * v[kj])
        outs.append(num / den[..., None])
    return torch.cat(outs)


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


def _pair_chunks(rank: torch.Tensor, h: int) -> Iterator[Tuple[int, int, torch.Tensor,
                                                               torch.Tensor]]:
    """Every (query, key) pair of every window, in chunks of whole query
    rows: yields (lo, hi, qi, kj) with queries lo..hi-1 and their pairs."""
    n = rank.shape[0]
    dev = rank.device
    new = torch.ones(n, dtype=torch.bool, device=dev)
    new[1:] = rank[1:] != rank[:-1]
    run = torch.cumsum(new.long(), 0) - 1
    starts = torch.nonzero(new)[:, 0]
    counts = torch.bincount(run)
    start_i, cnt_i = starts[run], counts[run]
    cum = torch.cumsum(cnt_i, 0)
    budget = max(_PAIR_BUDGET // h, int(cnt_i.max()))
    lo = 0
    while lo < n:
        base = int(cum[lo - 1]) if lo else 0
        hi = max(int(torch.searchsorted(cum, base + budget, right=True)), lo + 1)
        qi = torch.repeat_interleave(torch.arange(lo, hi, device=dev), cnt_i[lo:hi])
        first = torch.repeat_interleave(cum[lo:hi] - cnt_i[lo:hi] - base, cnt_i[lo:hi])
        kj = start_i[qi] + torch.arange(len(qi), device=dev) - first
        yield lo, hi, qi, kj
        lo = hi


def _bins(cq: torch.Tensor, r: Optional[torch.Tensor], qi: torch.Tensor,
          kj: torch.Tensor, g: int, a: float) -> torch.Tensor:
    """The three RPE bins [M, 3] of the pairs (qi, kj)."""
    idx = cq[qi] - cq[kj] + g - 1
    if r is not None:
        idx[:, 2] = exponential_split_index(r[qi] - r[kj], a).long().clamp(0, 2 * g - 1)
    return idx


def _lookup(t: torch.Tensor, rows: torch.Tensor, idx: torch.Tensor, ax: int) -> torch.Tensor:
    """t [N, h, 3, L2] at (rows, :, ax, idx[:, ax]) -> [M, h]."""
    h = t.shape[1]
    sel = idx[:, ax][:, None, None].expand(-1, h, 1)
    return t[rows, :, ax].gather(2, sel)[..., 0]


def _scores(q, k, qT, kT, qi, kj, idx):
    s = (q[qi] * k[kj]).sum(-1)                                       # [M, h]
    for ax in range(3):
        s = s + _lookup(qT, qi, idx, ax) + _lookup(kT, kj, idx, ax)
    return s


def _rpe_chunk(q, k, v, qT, kT, tv, cq, r, qi, kj, lo: int, hi: int, g: int,
               a: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K3 over the pairs (qi, kj) of queries lo..hi-1 -> (out [hi-lo,
    h, d], lse [hi-lo, h])."""
    h, d = q.shape[1], q.shape[2]
    dev = q.device
    idx = _bins(cq, r, qi, kj, g, a)
    s = _scores(q, k, qT, kT, qi, kj, idx)
    seg = qi - lo
    with torch.no_grad():
        smax = torch.full((hi - lo, h), -math.inf, device=dev).scatter_reduce(
            0, seg[:, None].expand(-1, h), s.detach(), "amax")
    e = torch.exp(s - smax[seg])
    den = torch.zeros(hi - lo, h, device=dev).index_add(0, seg, e)
    p = e / den[seg]
    val = (v[kj] + tv[idx[:, 0], 0] + tv[idx[:, 1], 1]
           + tv[idx[:, 2], 2])                                        # [M, h, d]
    out = torch.zeros(hi - lo, h, d, device=dev).index_add(0, seg, p[..., None] * val)
    return out, smax + torch.log(den)


def window_attention_rpe_fwd(qs: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
                             qT: torch.Tensor, kT: torch.Tensor, table_v: torch.Tensor,
                             rank: torch.Tensor, quant: torch.Tensor,
                             r: Optional[torch.Tensor], grid_len: int,
                             a: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K3. Window-sorted qs/ks/vs [N, h, d] (q pre-scaled), their
    projections qT/kT [N, h, 3, L2], table_v [L2, 3, h, d], rank [N], quant
    [N, 3], r [N] or None -> (out f32 [N, h, d], lse f32 [N, h]).
    Differentiable: the softmax max is taken without gradient, so autograd
    through this function stays exact and cheap. Under autograd each chunk
    of pairs is checkpointed (``torch.utils.checkpoint``): the backward
    recomputes the chunk's per-pair tensors instead of keeping them, so the
    memory held between forward and backward is that of the pair lists,
    not of every per-pair intermediate (some kilobytes a pair)."""
    g = int(grid_len)
    q, k, v = qs.float(), ks.float(), vs.float()
    tv = table_v.float()
    cq = quant.long().clamp(0, g - 1)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v, qT, kT, tv))
    outs, lses = [], []
    for lo, hi, qi, kj in _pair_chunks(rank, q.shape[1]):
        args = (q, k, v, qT, kT, tv, cq, r, qi, kj, lo, hi, g, a)
        if grad:
            out, lse = torch.utils.checkpoint.checkpoint(_rpe_chunk, *args,
                                                         use_reentrant=False)
        else:
            out, lse = _rpe_chunk(*args)
        outs.append(out)
        lses.append(lse)
    return torch.cat(outs), torch.cat(lses)


def window_attention_rpe(qs: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
                         rank: torch.Tensor, quant: torch.Tensor,
                         r: Optional[torch.Tensor], table_q: torch.Tensor,
                         table_k: torch.Tensor, table_v: torch.Tensor,
                         grid_len: int, a: float) -> torch.Tensor:
    """Window-sorted qs/ks/vs [N, h, d] (q pre-scaled), rank [N], quant
    [N, 3], r [N] or None, tables [L2, 3, h, d] -> f32 [N, h, d]."""
    qT = table_projections(qs, table_q)
    kT = table_projections(ks, table_k)
    return window_attention_rpe_fwd(qs, ks, vs, qT, kT, table_v, rank, quant, r,
                                    grid_len, a)[0]


def window_attention_rpe_bwd(qs: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
                             qT: torch.Tensor, kT: torch.Tensor, edo: torch.Tensor,
                             rank: torch.Tensor, quant: torch.Tensor,
                             r: Optional[torch.Tensor], lse: torch.Tensor,
                             do: torch.Tensor, dfac: torch.Tensor, grid_len: int,
                             a: float) -> Tuple[torch.Tensor, ...]:
    """Plain K4 and K5. With p = exp(s - lse_i), dp = do_i.v_j + sum_a
    edo[i, a, bin_a] (edo = do . Tv), ds = p (dp - dfac_i) over every pair,
    returns f32 (dq [N, h, d], dk, dv, mq [N, h, 3, L2], mk, pm):

      dq[i] = sum_j ds k_j, dk[j] = sum_i ds q_i, dv[j] = sum_i p do_i,
      mq[i, a, l] = sum_j ds [bin_a = l], mk[j, a, l] = sum_i ds [bin_a = l],
      pm[i, a, l] = sum_j p [bin_a = l].
    """
    n, h, d = qs.shape
    g = int(grid_len)
    l2 = qT.shape[-1]
    dev = qs.device
    q, k, v = qs.float(), ks.float(), vs.float()
    do, lse, dfac = do.float(), lse.float(), dfac.float()
    cq = quant.long().clamp(0, g - 1)
    dq = torch.zeros(n, h, d, device=dev)
    dk = torch.zeros(n, h, d, device=dev)
    dv = torch.zeros(n, h, d, device=dev)
    mq = torch.zeros(n * h * 3 * l2, device=dev)
    mk = torch.zeros(n * h * 3 * l2, device=dev)
    pm = torch.zeros(n * h * 3 * l2, device=dev)
    heads = torch.arange(h, device=dev)
    for _, _, qi, kj in _pair_chunks(rank, h):
        idx = _bins(cq, r, qi, kj, g, a)
        p = torch.exp(_scores(q, k, qT, kT, qi, kj, idx) - lse[qi])  # [M, h]
        dp = (do[qi] * v[kj]).sum(-1)
        for ax in range(3):
            dp = dp + _lookup(edo, qi, idx, ax)
        ds = p * (dp - dfac[qi])
        dq.index_add_(0, qi, ds[..., None] * k[kj])
        dk.index_add_(0, kj, ds[..., None] * q[qi])
        dv.index_add_(0, kj, p[..., None] * do[qi])
        for ax in range(3):
            col = ax * l2 + idx[:, ax][:, None]                          # [M, 1]
            fq = (qi[:, None] * h + heads) * 3 * l2 + col                # [M, h]
            fk = (kj[:, None] * h + heads) * 3 * l2 + col
            mq.index_add_(0, fq.reshape(-1), ds.reshape(-1))
            mk.index_add_(0, fk.reshape(-1), ds.reshape(-1))
            pm.index_add_(0, fq.reshape(-1), p.reshape(-1))
    shape = (n, h, 3, l2)
    return dq, dk, dv, mq.view(shape), mk.view(shape), pm.view(shape)
