"""Kernels K1 and K1b: the rulebook sparse conv (ks=3, stride 1) on the H100,
forward and backward.

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

:class:`RulebookConv` ties them into one autograd function. The wrappers
launch the kernels for CUDA tensors at every width (the JAX ``supported()``
gate is a TPU VMEM limit and has no counterpart here) and take the plain
versions, :func:`rulebook_conv_plain` and :func:`rulebook_conv_dw_plain`,
only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

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


def _kernel_fn(dtype: torch.dtype):
    fn = getattr(build.load("rulebook_conv"), _FNS[dtype])
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def _dw_fn(dtype: torch.dtype):
    fn = getattr(build.load("rulebook_conv_bwd"), _FNS_DW[dtype])
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


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


def _check(what: str, x: torch.Tensor, w: torch.Tensor, nbr: torch.Tensor) -> None:
    B, V, cin = x.shape
    K, wcin, _ = w.shape
    if x.dtype not in _FNS or w.dtype != x.dtype:
        raise TypeError(f"{what} takes f32 or bf16 x and w of one dtype, "
                        f"got {x.dtype} and {w.dtype}")
    if nbr.dtype != torch.int32 or tuple(nbr.shape) != (B, K, V) or wcin != cin:
        raise ValueError(f"{what} shapes: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, nbr {tuple(nbr.shape)} {nbr.dtype}")
    build.check_tensors(what, x, w, nbr)


def _launch_conv(x: torch.Tensor, w: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    B, V, _ = x.shape
    K, cin, cout = w.shape
    out = torch.empty(B, V, cout, dtype=x.dtype, device=x.device)
    rc = _kernel_fn(x.dtype)(x.data_ptr(), w.data_ptr(), nbr.data_ptr(),
                             out.data_ptr(), B, V, cin, cout, K,
                             build.stream_of(x))
    build.check_rc(rc, "rulebook_conv")
    return out


def rulebook_conv(x: torch.Tensor, w: torch.Tensor,
                  nbr: torch.Tensor) -> torch.Tensor:
    """x [B, V, Cin], w [K, Cin, Cout] (x's dtype, f32 or bf16), nbr
    [B, K, V] int32 -> [B, V, Cout] in x's dtype, accumulated in f32."""
    if x.device.type == "cpu":
        return rulebook_conv_plain(x, w, nbr)
    _check("rulebook_conv", x, w, nbr)
    out = _launch_conv(x, w, nbr)
    rulebook_conv.launches += 1
    return out


rulebook_conv.launches = 0


@functools.lru_cache(maxsize=None)
def _rev_index(device: torch.device) -> torch.Tensor:
    """:func:`spconv.rev_perm_27` on ``device``, copied there once, so that a
    backward makes no host-to-device copy (a pageable copy waits for the
    stream)."""
    return torch.as_tensor(spconv.rev_perm_27(), device=device, dtype=torch.long)


def reversed_weights(w: torch.Tensor) -> torch.Tensor:
    """W2[k] = W[rev(k)]^T, [27, Cout, Cin]: the weights of the input
    gradient's conv over the same (symmetric) rulebook."""
    if w.shape[0] != 27:
        raise ValueError(f"the transposed rulebook needs the 27 ks=3 offsets, got {w.shape[0]}")
    return w[_rev_index(w.device)].transpose(1, 2).contiguous()


def rulebook_conv_dx(g: torch.Tensor, w: torch.Tensor,
                     nbr: torch.Tensor) -> torch.Tensor:
    """Input gradient of :func:`rulebook_conv`: g [B, V, Cout], the forward's
    w [27, Cin, Cout] -> [B, V, Cin], through K1 with the reversed weights."""
    w2 = reversed_weights(w)
    if g.device.type == "cpu":
        return rulebook_conv_plain(g, w2, nbr)
    _check("rulebook_conv_dx", g, w2, nbr)
    out = _launch_conv(g, w2, nbr)
    rulebook_conv_dx.launches += 1
    return out


rulebook_conv_dx.launches = 0


def _dw_splits(rows: int, cin: int, cout: int, k: int, sms: int) -> int:
    """Row ranges for K1b: enough blocks for ~4 per SM, each range at least
    512 rows."""
    tiles = -(-cin // 64) * -(-cout // 64)
    want = -(-4 * sms // (tiles * k))
    return max(1, min(want, rows // 512))


def rulebook_conv_dw(x: torch.Tensor, g: torch.Tensor,
                     nbr: torch.Tensor) -> torch.Tensor:
    """Weight gradient of :func:`rulebook_conv`: x [B, V, Cin] and g
    [B, V, Cout] of one dtype (f32 or bf16), nbr [B, K, V] int32 -> f32
    [K, Cin, Cout]."""
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
    S = _dw_splits(B * V, cin, cout, K,
                   torch.cuda.get_device_properties(x.device).multi_processor_count)
    gw = torch.empty(K, cin, cout, dtype=torch.float32, device=x.device)
    part = (torch.empty(S, K, cin, cout, dtype=torch.float32, device=x.device)
            if S > 1 else None)
    rc = _dw_fn(x.dtype)(x.data_ptr(), g.data_ptr(), nbr.data_ptr(),
                         None if part is None else part.data_ptr(), gw.data_ptr(),
                         B, V, cin, cout, K, S, build.stream_of(x))
    build.check_rc(rc, "rulebook_conv_dw")
    rulebook_conv_dw.launches += 1
    return gw


rulebook_conv_dw.launches = 0


class RulebookConv(torch.autograd.Function):
    """:func:`rulebook_conv` with its gradients: dX through K1 with the
    reversed weights (skipped when x needs none, as for the stem's first
    conv, whose input is the point features), dW through K1b."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w, nbr)
        return rulebook_conv(x, w, nbr)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w, nbr = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        gx = rulebook_conv_dx(g, w, nbr) if ctx.needs_input_grad[0] else None
        gw = rulebook_conv_dw(x, g, nbr).to(w.dtype) if ctx.needs_input_grad[1] else None
        return gx, gw, None
