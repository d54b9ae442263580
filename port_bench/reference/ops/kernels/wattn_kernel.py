"""The reference's window attention with contextual RPE: plain PyTorch
(``ops/wattn.py``'s pair-list forward and backward) in place of the
program's kernels K3, K4 and K5, over windows sorted in the step (the
reference builds its plumbing on the device, with no host geometry).

:class:`FlashRPE` keeps the sorted inputs, the output and each row's
log-sum-exp for the backward, which runs the plain backward once for dq,
dk, dv and the bin masses.
"""

from __future__ import annotations

import contextvars
from typing import NamedTuple, Optional, Sequence

import torch

from port_bench.reference.ops import hashing, wattn

TILE = 128  # rows are padded to a multiple of this, as the program pads them
PAD_RANK = -7  # the window rank of the pad rows
# where set, a list that each window attention call appends its useful
# (query, key) pairs, heads, head dim and whether it takes a gradient to
PAIR_LOG: contextvars.ContextVar = contextvars.ContextVar("pair_log", default=None)

class SortedWindows(NamedTuple):
    """A sequence sorted by window and padded to the tile (the arrays
    ``sparse_window_attention_pallas`` builds): ``order`` [V] sorted row ->
    input row; ``rank`` [pad_to] int32 dense window id (pads ``PAD_RANK``);
    per-tile key ranges ``kmin``/``kmax`` [pad_to / 128] int32, which no
    kernel reads (:func:`walk_counts` does)."""

    order: torch.Tensor
    rank: torch.Tensor
    kmin: torch.Tensor
    kmax: torch.Tensor


def sort_by_window(xyz: torch.Tensor, valid: torch.Tensor,
                   window_size: Sequence[float]) -> SortedWindows:
    """Stable sort of the rows of xyz [V, 3] by window key (invalid rows
    last), padded to a multiple of the tile: :func:`sort_window_keys` of
    the rows' window keys.

    Each invalid row is a window of its own. The JAX package gives them one
    shared key, so they attend each other, quadratic work whose output the
    caller zeroes; here each attends itself only, which leaves every valid
    row's output as it was."""
    return sort_window_keys(wattn.window_keys(xyz, valid, window_size))


def sort_window_keys(key: torch.Tensor) -> SortedWindows:
    """Stable sort of packed window keys [V] (``hashing.PACKED_INVALID`` for
    a dead row), padded to a multiple of the tile: each dead row is a
    window of its own (the JAX package's ``_sorted_setup``); pads get rank
    ``PAD_RANK``, window start 0 and window end ``pad_to``; each tile's key
    range runs from the start of its first row's window to the end of its
    last row's."""
    vcap = key.shape[0]
    key_s, order = torch.sort(key, stable=True)
    pad_to = -(-vcap // TILE) * TILE
    padn = pad_to - vcap
    new = wattn.window_starts(key_s) | (key_s == hashing.PACKED_INVALID)
    seg_start, seg_end = wattn.run_bounds(new)
    rank = torch.cumsum(new, 0, dtype=torch.int32) - 1

    def pad(x, fill):
        return torch.cat([x, x.new_full((padn,), fill)])

    kmin = pad(seg_start, 0)[::TILE].contiguous()
    kmax = torch.maximum(pad(seg_end, pad_to)[TILE - 1::TILE], kmin + 1).contiguous()
    return SortedWindows(order, pad(rank, PAD_RANK), kmin, kmax)


class FlashRPE(torch.autograd.Function):
    """Window attention over sorted rows with gradients for q, k, v, the
    projections qT and kT, and the value table; dTv = sum_i pm[i] (x) do_i."""

    @staticmethod
    def forward(ctx, qs, ks, vs, qT, kT, table_v, rank, quant, r, grid_len: int, a: float):
        geo = (rank, quant, r)
        out, lse = wattn.window_attention_rpe_fwd(qs, ks, vs, qT, kT, table_v, *geo,
                                                  grid_len, a)
        ctx.save_for_backward(qs, ks, vs, qT, kT, table_v, out, lse)
        ctx.geo, ctx.grid_len, ctx.a = geo, grid_len, a
        return out

    @staticmethod
    def backward(ctx, g):
        qs, ks, vs, qT, kT, tv, out, lse = ctx.saved_tensors
        rank, quant, r = ctx.geo
        do = g.float().contiguous()
        dq, dk, dv, mq, mk, pm = wattn.window_attention_rpe_bwd(
            qs, ks, vs, qT, kT, wattn.table_projections(do, tv), rank, quant, r, lse, do,
            (do * out).sum(-1), ctx.grid_len, ctx.a)
        dtv = torch.einsum("nhal,nhd->lahd", pm, do)
        return (dq.to(qs.dtype), dk.to(ks.dtype), dv.to(vs.dtype), mq, mk,
                dtv.to(tv.dtype)) + (None,) * 5


def flash_rpe_sorted(qs, ks, vs, rank, quant, r, table_q, table_k, table_v, grid_len: int,
                     a: float) -> torch.Tensor:
    """Window-sorted qs/ks/vs [N, h, d] (q pre-scaled), the geometry's
    arrays, tables [L2, 3, h, d] -> f32 [N, h, d], differentiable."""
    qs, ks, vs, qT, kT = wattn.rpe_inputs(qs, ks, vs, table_q, table_k)
    return FlashRPE.apply(qs, ks, vs, qT, kT, table_v, rank, quant, r, grid_len, a)


def flash_pregeom_batched(*args, **kwargs):
    raise NotImplementedError("the reference builds its plumbing without host geometry")


def window_sort_batched(xyz: torch.Tensor, valid: torch.Tensor,
                        window_size: Sequence[float]) -> SortedWindows:
    """The window sort of :func:`sparse_window_attention_flash_batched`:
    each sample's window keys of xyz [B, V, 3], valid [B, V], tagged with
    its batch index above the key's 48 bits (the JAX package adds it to the
    high half), sorted in one sequence (:func:`sort_window_keys`: a dead
    row is a window of its own). Named ``window_sort`` in a
    ``torch.profiler`` trace."""
    b = xyz.shape[0]
    if b >= 1 << 15:
        raise ValueError(f"the batch tag takes 15 bits of the window key; B={b}")
    with torch.profiler.record_function("window_sort"):
        keys = torch.stack([wattn.window_keys(xyz[i], valid[i], window_size)
                            for i in range(b)])
        tag = torch.arange(b, device=xyz.device, dtype=torch.int64)[:, None] << 48
        keys = torch.where(valid & (keys != hashing.PACKED_INVALID), keys + tag,
                           hashing.PACKED_INVALID)
        return sort_window_keys(keys.reshape(-1))


def sparse_window_attention_flash_batched(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                          xyz: torch.Tensor, valid: torch.Tensor,
                                          window_size: Sequence[float], rpe: wattn.RPEParams,
                                          plain: bool = False,
                                          sw: Optional[SortedWindows] = None) -> torch.Tensor:
    """Window attention with contextual RPE over geometry taken in the step
    (the JAX package's ``sparse_window_attention_flash_batched``): q/k/v
    [B, V, h, d] (q pre-scaled), xyz [B, V, 3] the window coordinates,
    valid [B, V], ``rpe`` with quant [B, V, 3] and r [B, V] or None ->
    [B, V, h, d] in q's dtype, zero on invalid rows. The flattened batch
    is sorted by window (``sw``, or :func:`window_sort_batched` of xyz,
    valid and window_size when it is not given); the sorted, padded rows go
    through :class:`FlashRPE` (K3, and K4 and K5 in the backward) as the
    host geometry's do, or through the plain version with ``plain``."""
    b, vcap, h, d = q.shape
    n = b * vcap
    if sw is None:
        sw = window_sort_batched(xyz, valid, window_size)
    padn = sw.rank.shape[0] - n

    def sorted_padded(x):
        x = x.reshape((n,) + x.shape[2:])[sw.order]
        return torch.cat([x, x.new_zeros((padn,) + x.shape[1:])]).contiguous()

    qs, ks, vs = sorted_padded(q), sorted_padded(k), sorted_padded(v)
    quant = sorted_padded(rpe.quant.to(torch.int32))
    r = None if rpe.r is None else sorted_padded(rpe.r.float())
    rank = sw.rank.float()
    out_s = flash_rpe_sorted(qs, ks, vs, rank, quant, r, rpe.table_q, rpe.table_k, rpe.table_v,
               int(rpe.grid_len), float(rpe.a))
    log = PAIR_LOG.get()
    if log is not None:
        live = valid.reshape(n)[sw.order]
        runs = torch.unique_consecutive(sw.rank[:n][live], return_counts=True)[1]
        log.append((int((runs.long() ** 2).sum()), h, d, q.requires_grad))
    out = torch.zeros_like(out_s[:n]).index_copy(0, sw.order, out_s[:n])
    out = torch.where(valid.reshape(n)[:, None, None], out, 0.0).to(q.dtype)
    return out.reshape(b, vcap, h, d)
