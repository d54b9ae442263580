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

And the JAX package's banded attention, :func:`sparse_window_attention`
(``u2mkd_tpu/ops/wattn.py``, left to XLA there and written in plain torch
here): the route of a branch whose ``pallas_attention`` (or
``pallas_cubic``) flag is off. It drops the pairs of a window that lie
further apart in the sorted order than its band of key tiles reaches, the
same pairs the JAX function drops.

Under the bf16 compute policy (``ops/precision.py``) both routes cast where
the JAX package casts: K3's q, k, v and its table projections
(:func:`rpe_inputs`), and the banded attention's products (its softmax and
sums stay f32).
"""

from __future__ import annotations

import math
from typing import Iterator, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.utils.checkpoint

from u2mkd_tpu_torch.ops import hashing, segment
from u2mkd_tpu_torch.ops.precision import cast_compute, compute_dtype, round_compute

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
        rows = segment.plan(seg, hi - lo)
        den = segment.segment_sum(e, rows)
        num = segment.segment_sum(e[..., None] * v[kj], rows)
        outs.append(num / den[..., None])
    return torch.cat(outs)


def quantize_in_window(xyz: torch.Tensor, valid: torch.Tensor,
                       window_size: Sequence[float],
                       quant_size: Sequence[float]) -> torch.Tensor:
    """Per-axis quantized position [V, 3] int32 of each row of xyz [V, 3]
    within its (unshifted) window: floor(((xyz - min) mod window) / quant),
    the minimum over the valid rows (0 where there is none)."""
    ws = torch.as_tensor(window_size, dtype=xyz.dtype, device=xyz.device)
    qs = torch.as_tensor(quant_size, dtype=xyz.dtype, device=xyz.device)
    mn = torch.where(valid[:, None], xyz, math.inf).min(dim=0).values
    mn = torch.where(torch.isfinite(mn), mn, 0.0)
    rel = torch.remainder(xyz - mn, ws)
    return torch.floor(rel / qs).to(torch.int32)


class RPEParams(NamedTuple):
    """Contextual RPE inputs of one attention branch (the JAX package's):
    tables [L2, 3, h, d]; quant [V, 3] int32 in-window coords; r [V] the
    range (sphere branch only, binned by the exponential split); grid_len G;
    a, the split's parameter."""

    table_q: torch.Tensor
    table_k: torch.Tensor
    table_v: torch.Tensor
    quant: torch.Tensor
    grid_len: int
    r: Optional[torch.Tensor] = None
    a: float = 0.0125


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


def compute_projections(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """:func:`table_projections` under the compute-precision policy, held in
    f32: x and the table in the compute dtype, the projection rounded to it,
    as the JAX package's compute-dtype products (no f32 accumulation type)
    round them. Under f32 it is :func:`table_projections`. Gradients reach x
    and the table through the casts."""
    x, table = cast_compute(x, table)
    return table_projections(x, table).to(compute_dtype()).float()


def rpe_inputs(qs: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor, table_q: torch.Tensor,
               table_k: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(qs, ks, vs) in the compute dtype and their projections qT, kT
    (:func:`compute_projections`): what K3 and its plain version take, as
    the JAX package's ``_build_cats`` casts them."""
    qs, ks, vs = cast_compute(qs, ks, vs)
    return qs, ks, vs, compute_projections(qs, table_q), compute_projections(ks, table_k)


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
    rows = segment.plan(seg, hi - lo)
    den = segment.segment_sum(e, rows)
    p = e / den[seg]
    val = (v[kj] + tv[idx[:, 0], 0] + tv[idx[:, 1], 1]
           + tv[idx[:, 2], 2])                                        # [M, h, d]
    out = segment.segment_sum(p[..., None] * val, rows)
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
    [N, 3], r [N] or None, tables [L2, 3, h, d] -> f32 [N, h, d]; the
    inputs cast as :func:`rpe_inputs` casts them."""
    qs, ks, vs, qT, kT = rpe_inputs(qs, ks, vs, table_q, table_k)
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
        dq = segment.index_add(dq, qi, ds[..., None] * k[kj])
        dk = segment.index_add(dk, kj, ds[..., None] * q[qi])
        dv = segment.index_add(dv, kj, p[..., None] * do[qi])
        for ax in range(3):
            col = ax * l2 + idx[:, ax][:, None]                          # [M, 1]
            fq = (qi[:, None] * h + heads) * 3 * l2 + col                # [M, h]
            fk = (kj[:, None] * h + heads) * 3 * l2 + col
            mq = segment.index_add(mq, fq.reshape(-1), ds.reshape(-1))
            mk = segment.index_add(mk, fk.reshape(-1), ds.reshape(-1))
            pm = segment.index_add(pm, fq.reshape(-1), p.reshape(-1))
    shape = (n, h, 3, l2)
    return dq, dk, dv, mq.view(shape), mk.view(shape), pm.view(shape)


def _banded_chunk(q, k, v, key, qT, kT, tv, uq, cq, r, t0: int, t1: int, tile: int,
                  band: int, g: int, a: float, radial: bool) -> torch.Tensor:
    """Query tiles t0..t1-1 of :func:`sparse_window_attention` over the
    padded sorted rows -> [(t1 - t0) * tile, h, d]. The key band of tile t
    is padded rows t * tile .. t * tile + (2 band + 1) tile, its queries
    those from ``band * tile`` on. Each difference axis adds qT at bin
    uq_i - cq_j + G - 1 and kT at cq_i - uq_j + G - 1 (zero outside the
    table), with cq the clipped and uq the raw quantized coords, as the JAX
    package's shifted one-hots do; the radial axis bins the range
    difference."""
    n_t = t1 - t0
    width = (2 * band + 1) * tile
    margin = band * tile
    h = q.shape[1]
    l2 = qT.shape[-1]
    dev = q.device
    qrows = (margin + torch.arange(t0, t1, device=dev)[:, None] * tile
             + torch.arange(tile, device=dev)).reshape(-1)                 # [T]
    krows = (torch.arange(t0, t1, device=dev)[:, None] * tile
             + torch.arange(width, device=dev))                           # [nt, W]
    same = key[qrows].view(n_t, tile, 1) == key[krows][:, None, :]        # [nt, tile, W]
    kflat = krows.reshape(-1)
    qv, kv = q[qrows].view(n_t, tile, h, -1), k[kflat].view(n_t, width, h, -1)
    attn = torch.einsum("ntha,nwha->ntwh", qv, kv)                         # [nt, tile, W, h]
    qT_t = qT[qrows].view(n_t, tile, h, 3, l2)
    kT_w = kT[kflat].view(n_t, width, h, 3, l2)
    vbins = []
    n_diff = 2 if radial else 3
    for ax in range(n_diff):
        uq_i = uq[qrows, ax].view(n_t, tile, 1)
        cq_i = cq[qrows, ax].view(n_t, tile, 1)
        bq = uq_i - cq[kflat, ax].view(n_t, 1, width) + g - 1               # [nt, tile, W]
        bk = cq_i - uq[kflat, ax].view(n_t, 1, width) + g - 1
        attn = attn + _table_term(qT_t[..., ax, :], bq, l2, query_side=True)
        attn = attn + _table_term(kT_w[..., ax, :], bk, l2, query_side=False)
        vbins.append(bq)
    if radial:
        rb = exponential_split_index(r[qrows].view(n_t, tile, 1) - r[kflat].view(n_t, 1, width),
                                     a).long().clamp(0, 2 * g - 1)
        attn = attn + _table_term(qT_t[..., 2, :], rb, l2, query_side=True)
        attn = attn + _table_term(kT_w[..., 2, :], rb, l2, query_side=False)
        vbins.append(rb)
    attn = torch.where(same[..., None], attn, -math.inf)
    with torch.no_grad():
        mx = attn.detach().amax(dim=2, keepdim=True)
    attn = attn - mx
    attn = torch.where(torch.isfinite(attn), attn, -math.inf)
    e = torch.exp(attn)
    # the f32 softmax's p in the compute dtype for the value products
    p = round_compute(e / e.sum(dim=2, keepdim=True).clamp(min=1e-20))    # [nt, tile, W, h]
    out = torch.einsum("ntwh,nwhd->nthd", p, v[kflat].view(n_t, width, h, -1))
    for ax, b in enumerate(vbins):
        # m[i, h, l] = sum_j p_ij [bin_ij = l], bins outside the table dropped
        # as a sum over the rows (query, bin, head) of the flattened m
        ok = (b >= 0) & (b < l2)
        qrow = torch.arange(n_t * tile, device=dev).view(n_t, tile, 1, 1)
        flat = ((qrow * l2 + b[..., None]) * h + torch.arange(h, device=dev))
        flat = torch.where(ok[..., None], flat, -1)
        m = segment.segment_sum(p.reshape(-1), segment.plan(flat, n_t * tile * l2 * h))
        m = m.view(n_t, tile, l2, h)
        out = out + torch.einsum("ntlh,lhd->nthd", round_compute(m), tv[:, ax])
    return out.reshape(n_t * tile, h, -1)


def _table_term(proj: torch.Tensor, bins: torch.Tensor, l2: int,
                query_side: bool) -> torch.Tensor:
    """proj [nt, R, h, L2] (R the tile's queries or its band's keys) read
    at bins [nt, tile, W] -> [nt, tile, W, h], zero where a bin falls
    outside [0, L2). One gather from the flat projections, whose backward
    accumulates into a tensor of proj's size."""
    n_t, rows, h, _ = proj.shape
    dev = proj.device
    ok = (bins >= 0) & (bins < l2)
    base = torch.arange(n_t, device=dev)[:, None, None] * rows
    if query_side:                                   # row i of the tile
        row = base + torch.arange(bins.shape[1], device=dev)[None, :, None]
    else:                                            # key j of the band
        row = base + torch.arange(bins.shape[2], device=dev)[None, None, :]
    idx = ((row[..., None] * h + torch.arange(h, device=dev)) * l2
           + bins.clamp(0, l2 - 1)[..., None])
    return torch.where(ok[..., None], proj.reshape(-1)[idx], 0.0)


def sparse_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            xyz: torch.Tensor, valid: torch.Tensor,
                            window_size: Sequence[float], rpe: RPEParams,
                            band: int = 2, tile: int = 128) -> torch.Tensor:
    """The JAX package's banded window attention over one sample: q/k/v
    [V, h, d] (q pre-scaled), xyz [V, 3] the window coordinates, valid [V]
    -> f32 [V, h, d], zero on invalid rows. Stable sort by window key
    (invalid rows last, all with the invalid key), pad to the tile with
    ``band * tile`` invalid-key rows on each side, and let each 128-row
    query tile attend the key tiles within ``band`` of it, masked to its own
    window: exact where every window holds at most ``band * tile`` rows;
    beyond that the pairs outside the band are dropped, as in JAX.
    Differentiable; under autograd each chunk of tiles is checkpointed, so
    the memory held for the backward is that of the inputs."""
    vcap, h, d = q.shape
    dev = q.device
    g = int(rpe.grid_len)
    radial = rpe.r is not None
    key_s, order = torch.sort(window_keys(xyz, valid, window_size), stable=True)
    pad_to = -(-vcap // tile) * tile
    margin = band * tile
    total = pad_to + 2 * margin

    def pad(x, fill=0):
        out = x.new_full((total,) + x.shape[1:], fill)
        out[margin:margin + vcap] = x
        return out

    key = pad(key_s, hashing.PACKED_INVALID)
    qp, kp, vp = (pad(round_compute(x[order])) for x in (q, k, v))
    uq = pad(rpe.quant[order].long())
    cq = uq.clamp(0, g - 1)
    r = pad(rpe.r[order].float()) if radial else None
    qT = compute_projections(qp, rpe.table_q)
    kT = compute_projections(kp, rpe.table_k)
    tv = round_compute(rpe.table_v)
    width = (2 * band + 1) * tile
    n_tiles = pad_to // tile
    per_tile = tile * width * h
    chunk = max(1, _PAIR_BUDGET // per_tile)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (qp, kp, vp, qT, kT, tv))
    outs = []
    for t0 in range(0, n_tiles, chunk):
        args = (qp, kp, vp, key, qT, kT, tv, uq, cq, r, t0, min(n_tiles, t0 + chunk), tile,
                band, g, float(rpe.a), radial)
        if grad:
            outs.append(torch.utils.checkpoint.checkpoint(_banded_chunk, *args,
                                                          use_reentrant=False))
        else:
            outs.append(_banded_chunk(*args))
    out_s = torch.cat(outs)[:vcap]
    out = torch.zeros_like(out_s).index_copy(0, order, out_s)
    return torch.where(valid[:, None, None], out, 0.0)
