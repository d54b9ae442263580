"""Sine / Fourier coordinate position embeddings, and the generic windowed
attention module that adds them.

Port of ``u2mkd_tpu/models/position_embedding.py``. The attribute names
mirror the flax module names (``pos_enc``, ``qkv``, ``proj``, ``gauss_B``),
so ``models/convert_weights.from_flax`` carries a flax tree across.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from u2mkd_tpu_torch.models.blocks import dense
from u2mkd_tpu_torch.ops.kernels import wattn_kernel


def shift_scale_points(xyz: torch.Tensor, src_range, dst_range=None) -> torch.Tensor:
    """Map coords from the src_range box to dst_range (default the unit
    cube)."""
    src_min, src_max = src_range
    if dst_range is None:
        dst_min, dst_max = torch.zeros_like(src_min), torch.ones_like(src_min)
    else:
        dst_min, dst_max = dst_range
    return ((xyz - src_min) / torch.clamp(src_max - src_min, min=1e-12)
            * (dst_max - dst_min) + dst_min)


class _ZeroGradient(torch.autograd.Function):
    """The identity, with a gradient of zeros: flax's ``stop_gradient`` as
    optax sees it. A parameter behind it gets a zero gradient, not none, so
    that ``torch.optim`` still applies its weight decay, as optax's
    ``add_decayed_weights`` does."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return torch.zeros_like(grad)


class PositionEmbeddingCoordsSine(nn.Module):
    """pos_type 'sine' or 'fourier'; xyz [N, d_in] -> [N, d_pos].

    'sine': per axis a ladder of frequencies temperature^(2i / cd), sin and
    cos interleaved per frequency; the channels split over the axes in even
    budgets, the remainder to the first axes. 'fourier': sin and cos of
    2 pi xyz @ ``gauss_B`` [d_in, d_pos // 2], a parameter drawn from
    N(0, gauss_scale^2) that learns nothing (flax's ``stop_gradient``) but
    is still a parameter with a zero gradient, so that weight decay moves it
    as optax's does."""

    def __init__(self, d_pos: int, pos_type: str = "sine", normalize: bool = True,
                 gauss_scale: float = 1.0, temperature: float = 10000.0, d_in: int = 3,
                 generator=None):
        super().__init__()
        if pos_type not in ("sine", "fourier"):
            raise NotImplementedError(pos_type)
        self.d_pos, self.pos_type, self.normalize = d_pos, pos_type, normalize
        self.temperature = temperature
        if pos_type == "fourier":
            self.gauss_B = nn.Parameter(
                gauss_scale * torch.randn(d_in, d_pos // 2, generator=generator))

    def forward(self, xyz: torch.Tensor, input_range=None) -> torch.Tensor:
        n, d = xyz.shape
        if self.normalize and input_range is not None:
            xyz = shift_scale_points(xyz, input_range)
        if self.pos_type == "fourier":
            raw = (2 * math.pi * xyz) @ _ZeroGradient.apply(self.gauss_B)
            return torch.cat([torch.sin(raw), torch.cos(raw)], dim=-1)
        cdim = 2 * int(math.floor(self.d_pos / (d * 2)))
        rems = self.d_pos - cdim * d
        embeds = []
        for ax in range(d):
            cd = cdim + (2 if rems > 0 else 0)
            rems -= 2
            dim_t = torch.pow(torch.tensor(self.temperature, dtype=torch.float32),
                              2 * torch.arange(cd // 2, dtype=torch.float32) / cd)
            raw = xyz[:, ax:ax + 1] * 2 * math.pi / dim_t.to(xyz.device)[None, :]
            embeds.append(torch.stack([torch.sin(raw), torch.cos(raw)], dim=-1).reshape(n, cd))
        return torch.cat(embeds, dim=-1)[:, :self.d_pos]


class WindowMultiheadSA(nn.Module):
    """Single-geometry windowed attention (the reference's
    ``VarLengthMultiheadSA`` shape): an optional sine/fourier absolute PE
    added to the inputs, qkv, RPE-free attention within each window of
    ``window_size`` over ``xyz``, and a projection. The attention runs
    kernel K2 per sample through its entry point
    (``wattn_kernel.sparse_window_attention_flash``), exact at any window
    occupancy; the JAX module's banded XLA attention agrees wherever every
    window fits ``band`` tiles of 128 sorted rows. K2 has no backward, so
    wherever a gradient is needed the module runs K2's plain version, which
    is exact and differentiable on any device; under ``torch.no_grad()``
    (or with inputs that need none) it launches K2 on the card.
    ``plain`` takes the plain version always."""

    def __init__(self, dim: int, num_heads: int, window_size: Sequence[float],
                 pe_type: str = "none", qkv_bias: bool = True, generator=None):
        super().__init__()
        self.num_heads, self.window_size = num_heads, tuple(window_size)
        self.plain = False
        if pe_type in ("sine", "fourier"):
            self.pos_enc = PositionEmbeddingCoordsSine(dim, pe_type, generator=generator)
        self.qkv = dense(dim, 3 * dim, generator, bias=qkv_bias)
        self.proj = dense(dim, dim, generator)

    def forward(self, feats: torch.Tensor, xyz: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """feats [B, V, C], xyz [B, V, 3], mask [B, V] -> [B, V, C], zero on
        masked rows."""
        b, vcap, c = feats.shape
        h = self.num_heads
        dd = c // h
        if hasattr(self, "pos_enc"):
            feats = feats + torch.stack([self.pos_enc(x) for x in xyz])
        qkv = self.qkv(feats).reshape(b, vcap, 3, h, dd)
        q, k, v = qkv[:, :, 0] * dd ** -0.5, qkv[:, :, 1], qkv[:, :, 2]
        plain = self.plain or (torch.is_grad_enabled() and q.requires_grad)
        out = torch.stack([
            wattn_kernel.sparse_window_attention_flash(
                q[i], k[i], v[i], xyz[i], mask[i], self.window_size, plain=plain)
            for i in range(b)])
        out = self.proj(out.reshape(b, vcap, c).to(feats.dtype))
        return torch.where(mask[..., None], out, 0.0)
