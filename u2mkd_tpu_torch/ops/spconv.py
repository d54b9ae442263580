"""Sparse 3D convolution over cached rulebooks, in plain PyTorch.

Port of ``u2mkd_tpu/ops/spconv.py``: the rulebooks come from the host
pipeline; these functions apply them. Per sample, in the JAX package's
layout; weights are ``[K, Cin, Cout]``. The ks=3 stride-1 conv of the models
runs through the CUDA kernel (``ops/kernels/spconv_kernel.py``), for which
:func:`sparse_conv` is the plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from u2mkd_tpu_torch.ops.precision import cast_compute


def kernel_offsets(ks: int) -> np.ndarray:
    """Integer kernel offsets [K, 3]: ks=3 -> {-1,0,1}^3 (27), ks=2 ->
    {0,1}^3 (8), ks=1 -> {0}; (0,0,0) first, then z-fastest. The host
    rulebooks and the weights' K axis share this order."""
    rng = {1: [0], 2: [0, 1], 3: [-1, 0, 1]}[ks]
    offs = [(dx, dy, dz) for dz in rng for dy in rng for dx in rng]
    offs.sort(key=lambda o: o != (0, 0, 0))
    return np.asarray(offs, np.int32)


def rev_perm_27() -> np.ndarray:
    """rev[k] = index of -offset[k] in the ks=3 offset order. (0,0,0) comes
    first, so this is not ``26 - k``. The host rulebook is symmetric under
    it: ``nbr[rev[k], nbr[k, v]] == v`` wherever ``nbr[k, v]`` is valid."""
    offs = kernel_offsets(3)
    lut = {tuple(o): i for i, o in enumerate(offs)}
    return np.asarray([lut[tuple(-o)] for o in offs], np.int32)


def gather_rows(feats: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``feats[rows]`` with zero rows where ``rows`` is -1 or >= len(feats).

    An absent entry reads row (its position mod V), not row 0: the value is
    masked to zero either way, but the gather's backward (an accumulating
    ``index_put``, which sums each run of one repeated row serially) then
    meets no run of tens of thousands of entries on one row. Only zeros
    land on those rows, so the gradient is unchanged."""
    v = feats.shape[0]
    ok = (rows >= 0) & (rows < v)
    spread = torch.arange(rows.numel(), device=rows.device).view(rows.shape) % v
    g = feats[torch.where(ok, rows.long(), spread)]
    return torch.where(ok[..., None], g, torch.zeros((), dtype=g.dtype,
                                                     device=g.device))


def sparse_conv(feats: torch.Tensor, nbr: torch.Tensor,
                weight: torch.Tensor) -> torch.Tensor:
    """feats [Vin, Cin], nbr [K, Vout] rows into feats, weight [K, Cin, Cout]
    -> [Vout, Cout]: sum over k of gather(feats, nbr[k]) @ weight[k], each
    product in f32 from compute-dtype inputs (the JAX 'scan' strategy)."""
    acc = torch.zeros(nbr.shape[1], weight.shape[-1], dtype=torch.float32,
                      device=feats.device)
    for k in range(weight.shape[0]):
        g, w = cast_compute(gather_rows(feats, nbr[k]), weight[k])
        acc += g.float() @ w.float()
    return acc.to(feats.dtype)


def down_conv(feats: torch.Tensor, down_nbr8: torch.Tensor,
              weight: torch.Tensor) -> torch.Tensor:
    """ks=2/s=2 downsample: gather the 8 finer rows of each coarse voxel
    (``down_nbr8`` [8, Vc]) into one [Vc, 8*Cin] matrix and multiply by the
    flattened [8*Cin, Cout] weight."""
    k, cin, cout = weight.shape
    g = gather_rows(feats, down_nbr8).permute(1, 0, 2).reshape(-1, k * cin)
    g, w = cast_compute(g, weight.reshape(k * cin, cout))
    return (g.float() @ w.float()).to(feats.dtype)


def sparse_conv_transposed_2x2(feats: torch.Tensor, up_parent: torch.Tensor,
                               up_koff: torch.Tensor,
                               weight: torch.Tensor) -> torch.Tensor:
    """Transposed ks=2/s=2 conv onto the cached finer coords: each fine voxel
    gets its parent's row (``up_parent`` [Vf] into feats [Vc, Cin]) times
    ``weight[up_koff]``. One matmul against all 8 slices, then each row picks
    its own slice."""
    k, cin, cout = weight.shape
    g, w = cast_compute(gather_rows(feats, up_parent), weight)
    y = g.float() @ w.float().permute(1, 0, 2).reshape(cin, k * cout)
    y = y.view(-1, k, cout)
    sel = up_koff.long().clamp(0, k - 1)[:, None, None].expand(-1, 1, cout)
    return y.gather(1, sel)[:, 0].to(feats.dtype)
