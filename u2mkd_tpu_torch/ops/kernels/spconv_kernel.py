"""Kernels K1 and K1b: the rulebook sparse conv (ks=3, stride 1) on the H100's
tensor cores, forward and backward.

``out[b, v] = sum_k x[b, nbr[b, k, v]] @ w[k]``, invalid rows (-1 or >= V)
contributing zero; ``nbr`` is the host pipeline's rulebook ``[B, K, V]``.

  * K1, ``csrc/rulebook_conv.cu``, replaces the TPU kernel
    ``u2mkd_tpu/ops/pallas/spconv_kernel.py:_call``. It computes the forward
    (:func:`rulebook_conv`) and, with the weights ``W[rev(k)]^T``, the input
    gradient (:func:`rulebook_conv_dx`): the host rulebook is symmetric,
    ``P_k^T = P_rev(k)``. Each of the two wrappers counts its own launches.
  * K1b, ``csrc/rulebook_conv_bwd.cu``, computes the weight gradient
    ``gw[k] = sum_v x[nbr[k, v]]^T g[v]`` (:func:`rulebook_conv_dw`), which the
    TPU's VJP took from the forward kernel's gathered concat.

Both multiply only what the rulebook's real pairs need, read from a
:class:`ConvPlan` that :func:`conv_plan` builds once per rulebook on the
device (rows sorted by neighbour mask with each tile's offsets for K1, per
offset compacted pair lists for K1b); every wrapper takes it as its last
argument, ``plan``, and builds it when it is not given. The products run on
the tensor cores with ``mma.sync``: bf16 natively, f32 in 3xTF32 (three
TF32 products per f32 product, f32 accuracy), f32 accumulation.

:class:`RulebookConv` ties them into one autograd function on one plan. The
wrappers launch the kernels for CUDA tensors at every width (the JAX
``supported()`` gate is a TPU VMEM limit and has no counterpart here) and
take the plain versions, :func:`rulebook_conv_plain` and
:func:`rulebook_conv_dw_plain`, only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from u2mkd_tpu_torch.ops import spconv
from u2mkd_tpu_torch.ops.kernels import build

SOURCE = "u2mkd_tpu_torch/csrc/rulebook_conv.cu"
REPLACES = "u2mkd_tpu/ops/pallas/spconv_kernel.py:178"
SOURCE_DW = "u2mkd_tpu_torch/csrc/rulebook_conv_bwd.cu"
REPLACES_DW = "u2mkd_tpu/ops/pallas/spconv_kernel.py:240"  # _rc_bwd's dW

_FNS = {torch.float32: "rulebook_conv_f32", torch.bfloat16: "rulebook_conv_bf16"}
_FNS_DW = {torch.float32: "rulebook_conv_dw_f32", torch.bfloat16: "rulebook_conv_dw_bf16"}
_P = ctypes.c_void_p
_I = ctypes.c_int
# rows per output tile of K1, as ``csrc/rulebook_conv.cu`` has them
PLAN_TILE = 64


def _kernel_fn(dtype: torch.dtype):
    fn = getattr(build.load("rulebook_conv"), _FNS[dtype])
    fn.argtypes = [_P] * 6 + [_I] * 7 + [_P]
    fn.restype = _I
    return fn


def _dw_fn(dtype: torch.dtype):
    fn = getattr(build.load("rulebook_conv_bwd"), _FNS_DW[dtype])
    fn.argtypes = [_P] * 7 + [_I] * 6 + [_P]
    fn.restype = _I
    return fn


@dataclass
class ConvPlan:
    """What the kernels read of one rulebook ``nbr [B, K, V]``, built once
    per level on its device by :func:`conv_plan` and shared by every conv of
    the level, its input gradient and its weight gradient.

    For K1 (output-stationary): each row's K-bit neighbour mask, rows sorted
    stably by it (``perm``; the key's bits in order of the offsets' counts),
    so that rows that share offsets share a tile of :data:`PLAN_TILE` rows;
    each tile's union of offsets (``tile_mask``, bit k for offset k); and
    the rulebook in that row order (``nbr_sorted``, -1 where absent).
    For K1b: per offset its valid pairs in row order, compacted to the front
    of ``pair_src`` (x row ``b*V + nbr``) and ``pair_dst`` (output row
    ``b*V + v``), and ``seg``, where offset k's pairs lie in the 27 lists
    laid end to end: ``seg[k] .. seg[k+1]``, counts kept on the device.
    """

    perm: torch.Tensor        # [B, V] int32
    nbr_sorted: torch.Tensor  # [B, K, V] int32
    tile_mask: torch.Tensor   # [B, ceil(V / PLAN_TILE)] int32
    pair_src: torch.Tensor    # [K, B*V] int32
    pair_dst: torch.Tensor    # [K, B*V] int32
    seg: torch.Tensor         # [K + 1] int64


def conv_plan(nbr: torch.Tensor) -> ConvPlan:
    """The :class:`ConvPlan` of ``nbr [B, K, V]`` int32 (entries -1 or >= V
    absent), on nbr's device, with no host synchronisation. Named
    ``conv_plan`` in a ``torch.profiler`` trace."""
    b, k, v = nbr.shape
    if k > 31:
        raise ValueError(f"a neighbour mask holds at most 31 offsets, got {k}")
    dev = nbr.device
    with torch.profiler.record_function("conv_plan"):
        valid = (nbr >= 0) & (nbr < v)
        bits = torch.arange(k, device=dev, dtype=torch.int32)[:, None]
        # the sort key is the mask with the offsets' bits in order of their
        # count, the commonest lowest: rows then differ first in the bits
        # most of them have, and a tile's union gains fewer rare offsets
        by_count = torch.argsort(valid.sum((0, 2)), descending=True, stable=True)
        rank = torch.empty_like(bits).scatter_(0, by_count[:, None], bits)
        perm = torch.sort((valid.int() << rank).sum(1, dtype=torch.int32), dim=-1,
                          stable=True).indices
        by_perm = perm[:, None, :].expand(b, k, v)
        nbr_sorted = torch.where(valid, nbr, -1).gather(2, by_perm)
        tiles = -(-v // PLAN_TILE)
        sorted_valid = torch.cat([valid.gather(2, by_perm),
                                  valid.new_zeros(b, k, tiles * PLAN_TILE - v)], 2)
        union = sorted_valid.view(b, k, tiles, PLAN_TILE).any(-1)
        tile_mask = (union.int() << bits).sum(1, dtype=torch.int32)
        flat = valid.transpose(0, 1).reshape(k, b * v)
        order = torch.sort((~flat).to(torch.uint8), dim=-1, stable=True).indices
        base = (torch.arange(b, device=dev, dtype=torch.int32) * v)[:, None, None]
        src = torch.where(valid, nbr + base, -1).transpose(0, 1).reshape(k, b * v)
        seg = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         flat.sum(1).cumsum(0)])
        return ConvPlan(perm=perm.int(), nbr_sorted=nbr_sorted, tile_mask=tile_mask,
                        pair_src=src.gather(1, order).int(), pair_dst=order.int(), seg=seg)


def level_plan(level) -> ConvPlan:
    """The plan of ``level.nbr27`` (a :class:`LevelContext`), built at the
    first call and kept on the level for its other convs."""
    if level.conv_plan is None:
        level.conv_plan = conv_plan(level.nbr27)
    return level.conv_plan


def rulebook_conv_plain(x: torch.Tensor, w: torch.Tensor,
                        nbr: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: :func:`spconv.sparse_conv` per sample."""
    return torch.stack([spconv.sparse_conv(x[b], nbr[b], w)
                        for b in range(x.shape[0])])


def rulebook_conv_dw_plain(x: torch.Tensor, g: torch.Tensor,
                           nbr: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1b: per offset, gather the rows and
    contract them with g. -> f32 [K, Cin, Cout]."""
    k = nbr.shape[1]
    gw = torch.zeros(k, x.shape[-1], g.shape[-1], dtype=torch.float32, device=x.device)
    for b in range(x.shape[0]):
        for kk in range(k):
            xg = spconv.gather_rows(x[b], nbr[b, kk]).float()
            gw[kk] += torch.einsum("vc,vn->cn", xg, g[b].float())
    return gw


def _plan_for(what: str, nbr: torch.Tensor, plan: Optional[ConvPlan]) -> ConvPlan:
    """``plan``, checked against ``nbr``, or nbr's plan built now."""
    if plan is None:
        return conv_plan(nbr)
    b, k, v = nbr.shape
    if (tuple(plan.nbr_sorted.shape) != (b, k, v) or tuple(plan.pair_src.shape) != (k, b * v)
            or plan.seg.shape[0] != k + 1):
        raise ValueError(f"{what}: the plan is of another rulebook than nbr {tuple(nbr.shape)}")
    return plan


def _plan_tensors(plan: ConvPlan):
    return (plan.perm, plan.nbr_sorted, plan.tile_mask, plan.pair_src, plan.pair_dst, plan.seg)


def _aligned(width: int, *tensors: torch.Tensor) -> int:
    """1 when every row of ``width`` elements of each tensor starts on 16
    bytes, so the kernels may stage rows by 16-byte copies."""
    return int(all(width * t.element_size() % 16 == 0 and t.data_ptr() % 16 == 0
                   for t in tensors))


def _launch_conv(what: str, x: torch.Tensor, wt: torch.Tensor, nbr: torch.Tensor,
                 plan: Optional[ConvPlan]) -> torch.Tensor:
    """K1 on x [B, V, Cin] with the transposed weights wt [K, Cout, Cin]."""
    B, V, cin = x.shape
    K, cout, wcin = wt.shape
    if x.dtype not in _FNS or wt.dtype != x.dtype:
        raise TypeError(f"{what} takes f32 or bf16 x and w of one dtype, "
                        f"got {x.dtype} and {wt.dtype}")
    if nbr.dtype != torch.int32 or tuple(nbr.shape) != (B, K, V) or wcin != cin:
        raise ValueError(f"{what} shapes: x {tuple(x.shape)}, w (transposed) "
                         f"{tuple(wt.shape)}, nbr {tuple(nbr.shape)} {nbr.dtype}")
    build.check_tensors(what, x, wt, nbr)
    plan = _plan_for(what, nbr, plan)
    build.check_tensors(what, x, *_plan_tensors(plan))
    out = torch.empty(B, V, cout, dtype=x.dtype, device=x.device)
    rc = _kernel_fn(x.dtype)(x.data_ptr(), wt.data_ptr(), plan.nbr_sorted.data_ptr(),
                             plan.perm.data_ptr(), plan.tile_mask.data_ptr(), out.data_ptr(),
                             B, V, cin, cout, K, PLAN_TILE, _aligned(cin, x, wt),
                             build.stream_of(x))
    build.check_rc(rc, what)
    return out


def rulebook_conv(x: torch.Tensor, w: torch.Tensor, nbr: torch.Tensor,
                  plan: Optional[ConvPlan] = None) -> torch.Tensor:
    """x [B, V, Cin], w [K, Cin, Cout] (x's dtype, f32 or bf16), nbr
    [B, K, V] int32 -> [B, V, Cout] in x's dtype, accumulated in f32.
    ``plan``: nbr's :class:`ConvPlan`, built here when not given."""
    if x.device.type == "cpu":
        return rulebook_conv_plain(x, w, nbr)
    out = _launch_conv("rulebook_conv", x, w.transpose(1, 2).contiguous(), nbr, plan)
    rulebook_conv.launches += 1
    return out


rulebook_conv.launches = 0


@functools.lru_cache(maxsize=None)
def _rev_index(device: torch.device) -> torch.Tensor:
    """:func:`spconv.rev_perm_27` on ``device``, copied there once, so that a
    backward makes no host-to-device copy (a pageable copy waits for the
    stream)."""
    return torch.as_tensor(spconv.rev_perm_27(), device=device, dtype=torch.long)


def _rev(w: torch.Tensor) -> torch.Tensor:
    if w.shape[0] != 27:
        raise ValueError(f"the transposed rulebook needs the 27 ks=3 offsets, got {w.shape[0]}")
    return w[_rev_index(w.device)]


def reversed_weights(w: torch.Tensor) -> torch.Tensor:
    """W2[k] = W[rev(k)]^T, [27, Cout, Cin]: the weights of the input
    gradient's conv over the same (symmetric) rulebook."""
    return _rev(w).transpose(1, 2).contiguous()


def rulebook_conv_dx(g: torch.Tensor, w: torch.Tensor, nbr: torch.Tensor,
                     plan: Optional[ConvPlan] = None) -> torch.Tensor:
    """Input gradient of :func:`rulebook_conv`: g [B, V, Cout], the forward's
    w [27, Cin, Cout] -> [B, V, Cin], through K1 with the reversed weights
    on the forward's plan."""
    if g.device.type == "cpu":
        return rulebook_conv_plain(g, reversed_weights(w), nbr)
    # K1 takes its weights transposed: W2^T[k] = W[rev(k)]
    out = _launch_conv("rulebook_conv_dx", g, _rev(w).contiguous(), nbr, plan)
    rulebook_conv_dx.launches += 1
    return out


rulebook_conv_dx.launches = 0


def dw_tile(cin: int, cout: int):
    """K1b's block tile (Cin, Cout): as wide as the layer, at most 128, in
    steps of 32 (one warp per 32 x 32)."""
    return tuple(min(128, -(-c // 32) * 32) for c in (cin, cout))


def dw_splits(rows: int, cin: int, cout: int, sms: int) -> int:
    """Ranges of K1b's pair lists: about two waves of 16 warps per SM, each
    range at least 64 of the B*V rows."""
    bm, bn = dw_tile(cin, cout)
    tiles = -(-cin // bm) * -(-cout // bn)
    want = -(-2 * sms * 16 // (bm // 32 * bn // 32 * tiles))
    return max(1, min(want, rows // 64))


def rulebook_conv_dw(x: torch.Tensor, g: torch.Tensor, nbr: torch.Tensor,
                     plan: Optional[ConvPlan] = None) -> torch.Tensor:
    """Weight gradient of :func:`rulebook_conv`: x [B, V, Cin] and g
    [B, V, Cout] of one dtype (f32 or bf16), nbr [B, K, V] int32 -> f32
    [K, Cin, Cout]. ``plan``: nbr's :class:`ConvPlan`, built here when not
    given."""
    if x.device.type == "cpu":
        return rulebook_conv_dw_plain(x, g, nbr)
    B, V, cin = x.shape
    K = nbr.shape[1]
    cout = g.shape[-1]
    if x.dtype not in _FNS_DW or g.dtype != x.dtype:
        raise TypeError(f"rulebook_conv_dw takes f32 or bf16 x and g of one dtype, "
                        f"got {x.dtype} and {g.dtype}")
    if (nbr.dtype != torch.int32 or nbr.ndim != 3 or tuple(nbr.shape) != (B, K, V)
            or tuple(g.shape[:2]) != (B, V)):
        raise ValueError(f"rulebook_conv_dw shapes: x {tuple(x.shape)}, g "
                         f"{tuple(g.shape)}, nbr {tuple(nbr.shape)} {nbr.dtype}")
    build.check_tensors("rulebook_conv_dw", x, g, nbr)
    plan = _plan_for("rulebook_conv_dw", nbr, plan)
    build.check_tensors("rulebook_conv_dw", x, *_plan_tensors(plan))
    S = dw_splits(B * V, cin, cout,
                  torch.cuda.get_device_properties(x.device).multi_processor_count)
    gw = torch.empty(K, cin, cout, dtype=torch.float32, device=x.device)
    part = torch.empty(S + K, cin, cout, dtype=torch.float32, device=x.device)
    rc = _dw_fn(x.dtype)(x.data_ptr(), g.data_ptr(), plan.pair_src.data_ptr(),
                         plan.pair_dst.data_ptr(), plan.seg.data_ptr(), part.data_ptr(),
                         gw.data_ptr(), B * V, cin, cout, K, S,
                         _aligned(cin, x) & _aligned(cout, g), build.stream_of(x))
    build.check_rc(rc, "rulebook_conv_dw")
    rulebook_conv_dw.launches += 1
    return gw


rulebook_conv_dw.launches = 0


class RulebookConv(torch.autograd.Function):
    """:func:`rulebook_conv` with its gradients: dX through K1 with the
    reversed weights (skipped when x needs none, as for the stem's first
    conv, whose input is the point features), dW through K1b; all three on
    one plan (``plan``, or one built here for a CUDA input)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, nbr: torch.Tensor,
                plan: Optional[ConvPlan] = None) -> torch.Tensor:
        if plan is None and x.device.type != "cpu":
            plan = conv_plan(nbr)
        ctx.save_for_backward(x, w, nbr)
        ctx.plan = plan
        return rulebook_conv(x, w, nbr, plan)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w, nbr = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        gx = rulebook_conv_dx(g, w, nbr, ctx.plan) if ctx.needs_input_grad[0] else None
        gw = (rulebook_conv_dw(x, g, nbr, ctx.plan).to(w.dtype)
              if ctx.needs_input_grad[1] else None)
        return gx, gw, None, None
