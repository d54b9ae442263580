"""Kernel K3: window attention with contextual RPE, forward, on the H100.

The CUDA source is ``csrc/wattn_rpe_fwd.cu``; it replaces the TPU kernel
``u2mkd_tpu/ops/pallas/wattn_kernel.py:_call_fwd`` with its XLA prologue and
V-table epilogue. :func:`flash_rpe_sorted` launches it for CUDA tensors and
takes the plain version, :func:`flash_rpe_sorted_plain`
(``ops/wattn.window_attention_rpe``), only for tensors on the CPU.
:func:`flash_pregeom_batched` is the model's entry: gather by the host
geometry's ``order``, attend, gather back by ``inv``, zero invalid rows.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from u2mkd_tpu_torch.core.structures import WindowGeom
from u2mkd_tpu_torch.ops import wattn
from u2mkd_tpu_torch.ops.kernels import build

SOURCE = "u2mkd_tpu_torch/csrc/wattn_rpe_fwd.cu"
REPLACES = "u2mkd_tpu/ops/pallas/wattn_kernel.py:909"
TILE = 128  # query rows per block; the host geometry's kmin/kmax tile
HEAD_DIMS = (4, 8, 16, 32)

_FNS = {torch.float32: "wattn_rpe_fwd_f32", torch.bfloat16: "wattn_rpe_fwd_bf16"}
_P = ctypes.c_void_p
_I = ctypes.c_int

flash_rpe_sorted_plain = wattn.window_attention_rpe


def _kernel_fn(dtype: torch.dtype):
    fn = getattr(build.load("wattn_rpe_fwd"), _FNS[dtype])
    fn.argtypes = [_P] * 12 + [_I] * 5 + [ctypes.c_float, _P]
    fn.restype = _I
    return fn


def flash_rpe_sorted(qs: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
                     rank: torch.Tensor, quant: torch.Tensor,
                     r: Optional[torch.Tensor], kmin: torch.Tensor,
                     kmax: torch.Tensor, table_q: torch.Tensor,
                     table_k: torch.Tensor, table_v: torch.Tensor,
                     grid_len: int, a: float) -> torch.Tensor:
    """Window-sorted qs/ks/vs [N, h, d] (N = pad_to, q pre-scaled; f32 or
    bf16), rank [N] f32, quant [N, 3] int32, r [N] f32 or None, per-tile key
    ranges kmin/kmax [N / 128] int32, tables [L2, 3, h, d] -> f32 [N, h, d].
    """
    if qs.device.type == "cpu":
        return flash_rpe_sorted_plain(qs, ks, vs, rank, quant, r, table_q,
                                      table_k, table_v, grid_len, a)
    n, h, d = qs.shape
    l2 = table_q.shape[0]
    if qs.dtype not in _FNS or ks.dtype != qs.dtype or vs.dtype != qs.dtype:
        raise TypeError(f"flash_rpe_sorted takes f32 or bf16 q/k/v of one dtype, "
                        f"got {qs.dtype}, {ks.dtype}, {vs.dtype}")
    if d not in HEAD_DIMS or n % TILE or tuple(kmin.shape) != (n // TILE,):
        raise ValueError(f"flash_rpe_sorted: head dim {d} (takes {HEAD_DIMS}), "
                         f"N={n} (a multiple of {TILE}), kmin {tuple(kmin.shape)}")
    if (rank.dtype != torch.float32 or quant.dtype != torch.int32
            or kmin.dtype != torch.int32 or kmax.dtype != torch.int32
            or (r is not None and r.dtype != torch.float32)):
        raise TypeError("flash_rpe_sorted: rank/r are f32, quant/kmin/kmax int32")
    if tuple(quant.shape) != (n, 3) or tuple(table_v.shape) != (l2, 3, h, d):
        raise ValueError(f"flash_rpe_sorted: quant {tuple(quant.shape)}, "
                         f"table_v {tuple(table_v.shape)} for N={n}, h={h}, d={d}")
    qT = wattn.table_projections(qs, table_q)
    kT = wattn.table_projections(ks, table_k)
    tv = table_v.float().contiguous()
    extra = () if r is None else (r,)
    build.check_tensors("flash_rpe_sorted", qs, ks, vs, rank, quant, kmin, kmax,
                        qT, kT, tv, *extra)
    out = torch.empty(n, h, d, dtype=torch.float32, device=qs.device)
    rc = _kernel_fn(qs.dtype)(
        qs.data_ptr(), ks.data_ptr(), vs.data_ptr(), rank.data_ptr(),
        quant.data_ptr(), None if r is None else r.data_ptr(), kmin.data_ptr(),
        kmax.data_ptr(), qT.data_ptr(), kT.data_ptr(), tv.data_ptr(),
        out.data_ptr(), n, h, d, int(grid_len), l2, float(a),
        build.stream_of(qs))
    build.check_rc(rc, "flash_rpe_sorted")
    flash_rpe_sorted.launches += 1
    return out


flash_rpe_sorted.launches = 0


def flash_pregeom_batched(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          valid: torch.Tensor, geom: WindowGeom,
                          table_q: torch.Tensor, table_k: torch.Tensor,
                          table_v: torch.Tensor, grid_len: int, a: float,
                          plain: bool = False) -> torch.Tensor:
    """Window attention over host geometry: q/k/v [B, V, h, d], valid
    [B, V] -> [B, V, h, d] in q's dtype, zero on invalid rows. ``plain``
    runs the plain version on any device (the reference a card run is held
    against); otherwise K3 runs on CUDA tensors."""
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
                                 geom.kmin, geom.kmax, table_q, table_k, table_v,
                                 grid_len, a)
    res = out_s[geom.inv]
    res = torch.where(valid.reshape(n)[:, None, None], res, 0.0).to(q.dtype)
    return res.reshape(b, vcap, h, d)
