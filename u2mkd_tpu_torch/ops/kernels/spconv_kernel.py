"""Kernel K1: the rulebook sparse conv (ks=3, stride 1) on the H100.

``out[b, v] = sum_k x[b, nbr[b, k, v]] @ w[k]``, invalid rows (-1 or >= V)
contributing zero; ``nbr`` is the host pipeline's rulebook ``[B, K, V]``. The CUDA source is ``csrc/rulebook_conv.cu``; it replaces
the TPU kernel ``u2mkd_tpu/ops/pallas/spconv_kernel.py:_call``. The wrapper
launches it for CUDA tensors at every width (the JAX ``supported()`` gate is a
TPU VMEM limit and has no counterpart here) and takes the plain version,
:func:`rulebook_conv_plain`, only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from u2mkd_tpu_torch.ops import spconv
from u2mkd_tpu_torch.ops.kernels import build

SOURCE = "u2mkd_tpu_torch/csrc/rulebook_conv.cu"
REPLACES = "u2mkd_tpu/ops/pallas/spconv_kernel.py:178"

_FNS = {torch.float32: "rulebook_conv_f32", torch.bfloat16: "rulebook_conv_bf16"}
_P = ctypes.c_void_p
_I = ctypes.c_int


def _kernel_fn(dtype: torch.dtype):
    fn = getattr(build.load("rulebook_conv"), _FNS[dtype])
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def rulebook_conv_plain(x: torch.Tensor, w: torch.Tensor,
                        nbr: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: :func:`spconv.sparse_conv` per sample."""
    return torch.stack([spconv.sparse_conv(x[b], nbr[b], w)
                        for b in range(x.shape[0])])


def rulebook_conv(x: torch.Tensor, w: torch.Tensor,
                  nbr: torch.Tensor) -> torch.Tensor:
    """x [B, V, Cin], w [K, Cin, Cout] (x's dtype, f32 or bf16), nbr
    [B, K, V] int32 -> [B, V, Cout] in x's dtype, accumulated in f32."""
    if x.device.type == "cpu":
        return rulebook_conv_plain(x, w, nbr)
    B, V, cin = x.shape
    K, wcin, cout = w.shape
    if x.dtype not in _FNS or w.dtype != x.dtype:
        raise TypeError(f"rulebook_conv takes f32 or bf16 x and w of one dtype, "
                        f"got {x.dtype} and {w.dtype}")
    if nbr.dtype != torch.int32 or tuple(nbr.shape) != (B, K, V) or wcin != cin:
        raise ValueError(f"rulebook_conv shapes: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, nbr {tuple(nbr.shape)} {nbr.dtype}")
    build.check_tensors("rulebook_conv", x, w, nbr)
    out = torch.empty(B, V, cout, dtype=x.dtype, device=x.device)
    rc = _kernel_fn(x.dtype)(x.data_ptr(), w.data_ptr(), nbr.data_ptr(),
                             out.data_ptr(), B, V, cin, cout, K,
                             build.stream_of(x))
    build.check_rc(rc, "rulebook_conv")
    rulebook_conv.launches += 1
    return out


rulebook_conv.launches = 0
