"""Kernels K2, K3, K4 and K5: window attention on the H100; K2 without
position encoding (forward), K3, K4 and K5 with contextual RPE (forward and
backward).

  * K2, ``csrc/wattn_fwd.cu`` (:func:`flash_window_sorted`): RPE-free
    attention within windows over a window-sorted sequence; it replaces the
    TPU kernel of ``u2mkd_tpu/ops/pallas/wattn_kernel.py:
    flash_window_attention_sorted``. :func:`sparse_window_attention_flash`,
    the counterpart of ``sparse_window_attention_pallas``, is its entry: sort
    by window, pad to the tile, attend, unsort, zero invalid rows. No model
    path of the JAX package reaches it; in the port
    ``models/position_embedding.WindowMultiheadSA`` calls it.
  * K3, ``csrc/wattn_rpe_fwd.cu`` (:func:`flash_rpe_fwd`): the forward and
    each row's log-sum-exp; it replaces the TPU kernel
    ``u2mkd_tpu/ops/pallas/wattn_kernel.py:_call_fwd`` with its XLA prologue
    and V-table epilogue.
  * K4, ``csrc/wattn_rpe_bwd_q.cu`` (:func:`flash_rpe_bwd_q`): dq and the
    query-side bin masses; it replaces ``_call_bwd_q``.
  * K5, ``csrc/wattn_rpe_bwd_k.cu`` (:func:`flash_rpe_bwd_k`): dk, dv and the
    key-side bin masses; it replaces ``_call_bwd_k``.

All four run one warp of 32 rows per block, one row per lane, and each lane
walks the keys of its own window only, found by one rule
(:func:`warp_run_bounds` is its torch twin). Each wrapper launches its
kernel for CUDA tensors and takes the plain version (``ops/wattn.py``) only
for tensors on the CPU. :class:`FlashRPE` is
the autograd function over them. Its inputs are the window-sorted q, k, v,
the table projections qT = q . Tq and kT = k . Tk, and the value table; the
projections are computed outside it, so autograd's einsum backward turns the
masses (the gradients of qT and kT) into dq, dk, dTq and dTk, as the JAX
package's XLA epilogue does. :func:`flash_pregeom_batched` is the model's
entry over host geometry: gather by the host geometry's ``order``, attend,
gather back by ``inv``, zero invalid rows; autograd scatter-adds the gathers
back. :func:`sparse_window_attention_flash_batched` is its entry over
geometry taken in the step, for plumbing built on the device: the window
sort runs on the card, then the same kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from u2mkd_tpu_torch.core.structures import WindowGeom
from u2mkd_tpu_torch.ops import hashing, wattn
from u2mkd_tpu_torch.ops.kernels import build

SOURCE_WINDOW = "u2mkd_tpu_torch/csrc/wattn_fwd.cu"
REPLACES_WINDOW = "u2mkd_tpu/ops/pallas/wattn_kernel.py:171"
SOURCE = "u2mkd_tpu_torch/csrc/wattn_rpe_fwd.cu"
REPLACES = "u2mkd_tpu/ops/pallas/wattn_kernel.py:909"
SOURCE_BWD_Q = "u2mkd_tpu_torch/csrc/wattn_rpe_bwd_q.cu"
REPLACES_BWD_Q = "u2mkd_tpu/ops/pallas/wattn_kernel.py:948"
SOURCE_BWD_K = "u2mkd_tpu_torch/csrc/wattn_rpe_bwd_k.cu"
REPLACES_BWD_K = "u2mkd_tpu/ops/pallas/wattn_kernel.py:988"
TILE = 128  # the host geometry's tile: its padding and its kmin/kmax ranges
WARP = 32  # rows per block of K2-K5: one warp
HEAD_DIMS = (4, 8, 16, 32)

_P = ctypes.c_void_p
_I = ctypes.c_int

flash_rpe_fwd_plain = wattn.window_attention_rpe_fwd
flash_rpe_bwd_plain = wattn.window_attention_rpe_bwd
flash_rpe_sorted_plain = wattn.window_attention_rpe
flash_window_sorted_plain = wattn.window_attention_plain
PAD_RANK = -7  # the window rank of the pad rows, as the JAX package sets it


def flash_window_sorted(qs: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
                        rank: torch.Tensor) -> torch.Tensor:
    """K2. Window-sorted qs/ks/vs [N, h, d] (N a multiple of 32, q
    pre-scaled; f32 or bf16), rank [N] int32 -> f32 [N, h, d]: each row's
    softmax attention over the keys of its own window, found from the rank
    alone. The arithmetic and the output are f32 for both input dtypes."""
    if qs.device.type == "cpu":
        return flash_window_sorted_plain(qs, ks, vs, rank)
    n, h, d = qs.shape
    if qs.dtype not in (torch.float32, torch.bfloat16) or ks.dtype != qs.dtype \
            or vs.dtype != qs.dtype:
        raise TypeError(f"flash_window_sorted takes f32 or bf16 q/k/v of one dtype, "
                        f"got {qs.dtype}, {ks.dtype}, {vs.dtype}")
    if rank.dtype != torch.int32:
        raise TypeError(f"flash_window_sorted: rank is int32, got {rank.dtype}")
    if d not in HEAD_DIMS or n % WARP or ks.shape != qs.shape or vs.shape != qs.shape \
            or tuple(rank.shape) != (n,):
        raise ValueError(f"flash_window_sorted: q {tuple(qs.shape)} (head dim in "
                         f"{HEAD_DIMS}, N a multiple of {WARP}), rank {tuple(rank.shape)}")
    build.check_tensors("flash_window_sorted", qs, ks, vs, rank)
    suffix = {torch.float32: "f32", torch.bfloat16: "bf16"}[qs.dtype]
    fn = getattr(build.load("wattn_fwd"), f"wattn_fwd_{suffix}")
    fn.argtypes = [_P] * 5 + [_I] * 3 + [_P]
    fn.restype = _I
    out = torch.empty(n, h, d, dtype=torch.float32, device=qs.device)
    rc = fn(qs.data_ptr(), ks.data_ptr(), vs.data_ptr(), rank.data_ptr(), out.data_ptr(),
            n, h, d, build.stream_of(qs))
    build.check_rc(rc, "flash_window_sorted")
    flash_window_sorted.launches += 1
    return out


flash_window_sorted.launches = 0


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


def sparse_window_attention_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  xyz: torch.Tensor, valid: torch.Tensor,
                                  window_size: Sequence[float],
                                  plain: bool = False) -> torch.Tensor:
    """RPE-free window attention over one sample: q/k/v [V, h, d] (q
    pre-scaled), xyz [V, 3] window coordinates, valid [V] -> f32 [V, h, d],
    zero on invalid rows. Sorts by window (:func:`sort_by_window`), runs K2
    (its plain version with ``plain``, or for CPU tensors), unsorts. The
    JAX function returns q's dtype; this one returns the kernel's f32, so
    that a bf16 caller rounds once, where it chooses."""
    vcap = q.shape[0]
    sw = sort_by_window(xyz, valid, window_size)
    padn = sw.rank.shape[0] - vcap

    def sorted_padded(x):
        x = x[sw.order]
        return torch.cat([x, x.new_zeros((padn,) + x.shape[1:])]).contiguous()

    qs, ks, vs = sorted_padded(q), sorted_padded(k), sorted_padded(v)
    if plain:
        out_s = flash_window_sorted_plain(qs, ks, vs, sw.rank)
    else:
        out_s = flash_window_sorted(qs, ks, vs, sw.rank)
    out = torch.empty_like(out_s[:vcap])
    out[sw.order] = out_s[:vcap]
    return torch.where(valid[:, None, None], out, 0.0)


def _kernel_fn(source: str, dtype: torch.dtype, n_ptrs: int):
    suffix = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
    fn = getattr(build.load(source), f"{source}_{suffix}")
    fn.argtypes = [_P] * n_ptrs + [_I] * 5 + [ctypes.c_float, _P]
    fn.restype = _I
    return fn


def _check(what: str, qs, ks, vs, rank, quant, r, f32s) -> None:
    """Raise unless the inputs are what the kernels take; ``f32s`` are the
    further f32 inputs."""
    n, h, d = qs.shape
    if qs.dtype not in (torch.float32, torch.bfloat16) or ks.dtype != qs.dtype \
            or vs.dtype != qs.dtype:
        raise TypeError(f"{what} takes f32 or bf16 q/k/v of one dtype, "
                        f"got {qs.dtype}, {ks.dtype}, {vs.dtype}")
    if d not in HEAD_DIMS or n % WARP or ks.shape != qs.shape or vs.shape != qs.shape:
        raise ValueError(f"{what}: head dim {d} (takes {HEAD_DIMS}), N={n} (a "
                         f"multiple of {WARP})")
    if (rank.dtype != torch.float32 or quant.dtype != torch.int32
            or (r is not None and r.dtype != torch.float32)
            or any(t.dtype != torch.float32 for t in f32s)):
        raise TypeError(f"{what}: rank/r and the projections and gradients are "
                        f"f32, quant int32")
    if tuple(quant.shape) != (n, 3) or tuple(rank.shape) != (n,):
        raise ValueError(f"{what}: quant {tuple(quant.shape)}, rank "
                         f"{tuple(rank.shape)} for N={n}")
    extra = () if r is None else (r,)
    build.check_tensors(what, qs, ks, vs, rank, quant, *f32s, *extra)


def flash_rpe_fwd(qs: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
                  qT: torch.Tensor, kT: torch.Tensor, table_v: torch.Tensor,
                  rank: torch.Tensor, quant: torch.Tensor, r: Optional[torch.Tensor],
                  grid_len: int, a: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3. Window-sorted qs/ks/vs [N, h, d] (N a multiple of 32, as the host
    geometry's pad_to is; q pre-scaled; f32 or bf16), projections qT/kT [N,
    h, 3, L2] f32, table_v [L2, 3, h, d], rank [N] f32, quant [N, 3] int32,
    r [N] f32 or None -> (out f32 [N, h, d], lse f32 [N, h]). K3, K4 and K5
    find each row's window from the rank alone."""
    if qs.device.type == "cpu":
        return flash_rpe_fwd_plain(qs, ks, vs, qT, kT, table_v, rank, quant, r,
                                   grid_len, a)
    n, h, d = qs.shape
    l2 = qT.shape[-1]
    tv = table_v.float().contiguous()
    if tuple(qT.shape) != (n, h, 3, l2) or kT.shape != qT.shape \
            or tuple(tv.shape) != (l2, 3, h, d):
        raise ValueError(f"flash_rpe_fwd: qT {tuple(qT.shape)}, kT {tuple(kT.shape)}, "
                         f"table_v {tuple(tv.shape)} for N={n}, h={h}, d={d}")
    _check("flash_rpe_fwd", qs, ks, vs, rank, quant, r, (qT, kT, tv))
    out = torch.empty(n, h, d, dtype=torch.float32, device=qs.device)
    lse = torch.empty(n, h, dtype=torch.float32, device=qs.device)
    rc = _kernel_fn("wattn_rpe_fwd", qs.dtype, 11)(
        qs.data_ptr(), ks.data_ptr(), vs.data_ptr(), rank.data_ptr(),
        quant.data_ptr(), None if r is None else r.data_ptr(), qT.data_ptr(),
        kT.data_ptr(), tv.data_ptr(), out.data_ptr(), lse.data_ptr(), n, h, d,
        int(grid_len), l2, float(a), build.stream_of(qs))
    build.check_rc(rc, "flash_rpe_fwd")
    flash_rpe_fwd.launches += 1
    return out, lse


flash_rpe_fwd.launches = 0


def _bwd_launch(source: str, what: str, qs, ks, vs, qT, kT, edo, rank, quant, r,
                lse, do, dfac, grid_len, a, out_shapes):
    n, h, d = qs.shape
    l2 = qT.shape[-1]
    if (tuple(qT.shape) != (n, h, 3, l2) or kT.shape != qT.shape or edo.shape != qT.shape
            or do.shape != qs.shape or tuple(lse.shape) != (n, h)
            or dfac.shape != lse.shape):
        raise ValueError(f"{what}: qT {tuple(qT.shape)}, kT {tuple(kT.shape)}, edo "
                         f"{tuple(edo.shape)}, do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)}, dfac {tuple(dfac.shape)} for N={n}, h={h}")
    _check(what, qs, ks, vs, rank, quant, r, (qT, kT, edo, do, lse, dfac))
    outs = [torch.empty(s, dtype=torch.float32, device=qs.device) for s in out_shapes]
    rc = _kernel_fn(source, qs.dtype, 15)(
        qs.data_ptr(), ks.data_ptr(), vs.data_ptr(), rank.data_ptr(), quant.data_ptr(),
        None if r is None else r.data_ptr(),
        qT.data_ptr(), kT.data_ptr(), edo.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dfac.data_ptr(), *(o.data_ptr() for o in outs), n, h, d, int(grid_len), l2,
        float(a), build.stream_of(qs))
    build.check_rc(rc, what)
    return outs


def flash_rpe_bwd_q(qs, ks, vs, qT, kT, edo, rank, quant, r, lse, do, dfac,
                    grid_len: int, a: float):
    """K4: the inputs of :func:`flash_rpe_fwd` (projections f32), edo = do .
    Tv [N, h, 3, L2], lse and dfac = sum_d do * out [N, h], do [N, h, d], all
    f32 -> f32 (dq [N, h, d], mq [N, h, 3, L2], pm [N, h, 3, L2]); see
    :func:`wattn.window_attention_rpe_bwd`."""
    if qs.device.type == "cpu":
        dq, _, _, mq, _, pm = flash_rpe_bwd_plain(qs, ks, vs, qT, kT, edo, rank, quant, r, lse,
                                                  do, dfac, grid_len, a)
        return dq, mq, pm
    n, h, d = qs.shape
    m = (n, h, 3, qT.shape[-1])
    dq, mq, pm = _bwd_launch("wattn_rpe_bwd_q", "flash_rpe_bwd_q", qs, ks, vs, qT, kT, edo,
                             rank, quant, r, lse, do, dfac, grid_len, a, ((n, h, d), m, m))
    flash_rpe_bwd_q.launches += 1
    return dq, mq, pm


flash_rpe_bwd_q.launches = 0


def flash_rpe_bwd_k(qs, ks, vs, qT, kT, edo, rank, quant, r, lse, do, dfac,
                    grid_len: int, a: float):
    """K5: the inputs of :func:`flash_rpe_bwd_q` -> f32 (dk [N, h, d], dv
    [N, h, d], mk [N, h, 3, L2])."""
    if qs.device.type == "cpu":
        _, dk, dv, _, mk, _ = flash_rpe_bwd_plain(qs, ks, vs, qT, kT, edo, rank, quant, r, lse,
                                                  do, dfac, grid_len, a)
        return dk, dv, mk
    n, h, d = qs.shape
    dk, dv, mk = _bwd_launch("wattn_rpe_bwd_k", "flash_rpe_bwd_k", qs, ks, vs, qT, kT, edo,
                             rank, quant, r, lse, do, dfac, grid_len, a,
                             ((n, h, d), (n, h, d), (n, h, 3, qT.shape[-1])))
    flash_rpe_bwd_k.launches += 1
    return dk, dv, mk


flash_rpe_bwd_k.launches = 0


def window_attention_occupancy(source: str, dtype: torch.dtype, head_dim: int,
                               grid_len: int, radial: bool) -> Dict[str, int]:
    """The launch of K2 (``source`` "wattn_fwd"), K3 ("wattn_rpe_fwd"), K4
    ("wattn_rpe_bwd_q") or K5 ("wattn_rpe_bwd_k") on the current card for
    q/k/v of ``dtype`` and ``head_dim`` at G = ``grid_len`` (K2 reads
    neither G nor ``radial``): its dynamic shared bytes per block, and the
    blocks and warps per SM that
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` lets be resident at
    once."""
    suffix = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    fn = getattr(build.load(source), f"{source}_occupancy")
    fn.argtypes = [_I] * 4 + [ctypes.POINTER(_I)]
    fn.restype = _I
    out = (_I * 3)()
    build.check_rc(fn(suffix, int(head_dim), int(grid_len), int(radial), out),
                   f"{source}_occupancy")
    return {"smem_bytes": out[0], "blocks_per_sm": out[1], "warps_per_sm": out[2]}


def _highest_bit(x: torch.Tensor) -> torch.Tensor:
    """Index of the highest set bit of each positive int64 below 2^53."""
    return torch.frexp(x.double()).exponent.long() - 1


def warp_run_bounds(rank: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The rule by which K2-K5 find each row's window
    (``wattn::warp_run_bounds``, ``csrc/wattn_rpe_common.cuh``), step for
    step in torch: rank [N] of window-sorted rows (f32 as the host geometry
    gives it to K3-K5, or int32 as :func:`sort_by_window` gives it to K2), N
    a multiple of ``WARP`` -> (start, end) int64 [N] of each row's run of
    equal rank, and
    the ballots [N / WARP] int64 each warp takes. A warp's ballot holds its
    rows' run-start flags as bits; a lane's start is the highest flag at or
    below it, its end the lowest above it; lanes with none take the start of
    the warp's first row's run (the highest flag of the first non-zero
    ballot going back, taken only when that row starts no run) or the end of
    its last row's run (the lowest flag of the first non-zero ballot going
    forward; row N counts as a start)."""
    n = rank.shape[0]
    if n % WARP:
        raise ValueError(f"warp_run_bounds: N={n} is no multiple of {WARP}")
    dev = rank.device
    flags = torch.ones(n + WARP, dtype=torch.bool, device=dev)
    flags[1:n] = rank[1:] != rank[:-1]
    lane = torch.arange(WARP, device=dev)
    words = (flags.view(-1, WARP).long() << lane).sum(1)        # [n / WARP + 1]
    nw = n // WARP
    idx = torch.arange(nw + 1, device=dev)
    nonzero = words != 0
    # the last non-zero word before each warp, the first after it
    prev = torch.cummax(torch.where(nonzero, idx, -1), 0).values
    nxt = torch.flip(torch.cummin(torch.flip(torch.where(nonzero, idx, nw), [0]), 0).values,
                     [0])
    w = idx[:nw]
    own = words[:nw, None]
    back = torch.where((own[:, 0] & 1) != 0, w,
                       prev[(w - 1).clamp(min=0)])              # word holding the start
    first = torch.where(back == w, w * WARP,
                        back * WARP + _highest_bit(words[back].clamp(min=1)))
    fwd = nxt[w + 1]
    low = words[fwd] & -words[fwd]
    last = fwd * WARP + _highest_bit(low)
    upto = (2 << lane) - 1
    below, above = own & upto, own & ~upto
    base = (w * WARP)[:, None]
    start = torch.where(below != 0, base + _highest_bit(below.clamp(min=1)), first[:, None])
    end = torch.where(above != 0, base + _highest_bit((above & -above).clamp(min=1)),
                      last[:, None])
    ballots = 1 + (w - back) + (fwd - w)
    return start.reshape(n), end.reshape(n), ballots


def walk_counts(rank: torch.Tensor, kmin: torch.Tensor, kmax: torch.Tensor) -> Dict[str, float]:
    """How much walking the attention kernels do on one geometry (rank [N]
    window-sorted, N a multiple of 128; per-tile key ranges kmin/kmax):

      * ``occupancy_mean``, ``_p99``, ``_max``: rows per window (a run of
        equal rank; each invalid or pad row of the host geometry is a window
        of one);
      * ``pairs``: the (query, key) pairs of the windows, sum of occupancy^2;
      * ``lane_steps_per_pair_tile``: steps of a walk over each 128-row
        tile's whole key range, one lane per row (the walk of K2 and K3
        before they took the window walk, kept as the record of that
        design), 128 * sum(kmax - kmin) over pairs;
      * ``lane_steps_per_pair_window``: steps of a walk over each row's own
        window (K2-K5): 1 by construction, counted from
        :func:`warp_run_bounds`;
      * ``warp_slots_per_pair_window``: lane slots a warp of 32 rows spends
        there, 32 * its longest window, over pairs (lanes of shorter
        windows idle);
      * ``ballots_per_warp``: the ballots :func:`warp_run_bounds` takes."""
    start, end, ballots = warp_run_bounds(rank)
    length = end - start
    new = wattn.window_starts(rank)
    occ = torch.diff(torch.cat([torch.nonzero(new)[:, 0],
                                torch.tensor([rank.shape[0]], device=rank.device)]))
    pairs = int((occ * occ).sum())
    tile_steps = TILE * int((kmax.long() - kmin.long()).sum())
    warp_slots = WARP * int(length.view(-1, WARP).max(1).values.sum())
    return {"occupancy_mean": float(occ.double().mean()),
            "occupancy_p99": float(torch.quantile(occ.double(), 0.99)),
            "occupancy_max": int(occ.max()), "pairs": pairs,
            "lane_steps_per_pair_tile": tile_steps / pairs,
            "lane_steps_per_pair_window": int(length.sum()) / pairs,
            "warp_slots_per_pair_window": warp_slots / pairs,
            "ballots_per_warp": float(ballots.double().mean())}


class FlashRPE(torch.autograd.Function):
    """Window attention over sorted rows with gradients for q, k, v, the
    projections qT and kT, and the value table. Forward K3, backward K4 and
    K5 (their plain versions on the CPU); dTv = sum_i pm[i] (x) do_i."""

    @staticmethod
    def forward(ctx, qs, ks, vs, qT, kT, table_v, rank, quant, r, grid_len: int, a: float):
        geo = (rank, quant, r)
        out, lse = flash_rpe_fwd(qs, ks, vs, qT, kT, table_v, *geo, grid_len, a)
        ctx.save_for_backward(qs, ks, vs, qT, kT, table_v, out, lse)
        ctx.geo, ctx.grid_len, ctx.a = geo, grid_len, a
        return out

    @staticmethod
    def backward(ctx, g):
        qs, ks, vs, qT, kT, tv, out, lse = ctx.saved_tensors
        rank, quant, r = ctx.geo
        do = g.float().contiguous()
        args = (qs, ks, vs, qT, kT, wattn.table_projections(do, tv), rank, quant, r, lse,
                do, (do * out).sum(-1), ctx.grid_len, ctx.a)
        dq, mq, pm = flash_rpe_bwd_q(*args)
        dk, dv, mk = flash_rpe_bwd_k(*args)
        dtv = torch.einsum("nhal,nhd->lahd", pm, do)
        return (dq.to(qs.dtype), dk.to(ks.dtype), dv.to(vs.dtype), mq, mk,
                dtv.to(tv.dtype)) + (None,) * 5


def flash_rpe_sorted(qs: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
                     rank: torch.Tensor, quant: torch.Tensor,
                     r: Optional[torch.Tensor], table_q: torch.Tensor,
                     table_k: torch.Tensor, table_v: torch.Tensor,
                     grid_len: int, a: float) -> torch.Tensor:
    """Window-sorted qs/ks/vs [N, h, d] (q pre-scaled), the geometry's
    arrays, tables [L2, 3, h, d] -> f32 [N, h, d], differentiable: q, k, v
    in the compute dtype and their projections (``wattn.rpe_inputs``), then
    :class:`FlashRPE`."""
    qs, ks, vs, qT, kT = wattn.rpe_inputs(qs, ks, vs, table_q, table_k)
    return FlashRPE.apply(qs, ks, vs, qT, kT, table_v, rank, quant, r, grid_len, a)


def flash_pregeom_batched(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          valid: torch.Tensor, geom: WindowGeom,
                          table_q: torch.Tensor, table_k: torch.Tensor,
                          table_v: torch.Tensor, grid_len: int, a: float,
                          plain: bool = False) -> torch.Tensor:
    """Window attention over host geometry: q/k/v [B, V, h, d], valid
    [B, V] -> [B, V, h, d] in q's dtype, zero on invalid rows. ``plain``
    runs the plain forward on any device, differentiated by autograd (the
    reference a card run is held against); otherwise K3 (and K4, K5 in the
    backward) run on CUDA tensors."""
    b, vcap, h, d = q.shape
    n = b * vcap
    order = geom.order
    qs = q.reshape(n, h, d)[order].contiguous()
    ks = k.reshape(n, h, d)[order].contiguous()
    vs = v.reshape(n, h, d)[order].contiguous()
    if plain:
        out_s = flash_rpe_sorted_plain(qs, ks, vs, geom.rank, geom.quant, geom.r,
                                       table_q, table_k, table_v, grid_len, a)
    else:
        out_s = flash_rpe_sorted(qs, ks, vs, geom.rank, geom.quant, geom.r,
                                 table_q, table_k, table_v, grid_len, a)
    res = out_s[geom.inv]
    res = torch.where(valid.reshape(n)[:, None, None], res, 0.0).to(q.dtype)
    return res.reshape(b, vcap, h, d)


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
    fn = flash_rpe_sorted_plain if plain else flash_rpe_sorted
    out_s = fn(qs, ks, vs, rank, quant, r, rpe.table_q, rpe.table_k, rpe.table_v,
               int(rpe.grid_len), float(rpe.a))
    out = torch.zeros_like(out_s[:n]).index_copy(0, sw.order, out_s[:n])
    out = torch.where(valid.reshape(n)[:, None, None], out, 0.0).to(q.dtype)
    return out.reshape(b, vcap, h, d)
