"""SphereFormer block: dual cubic + radial window attention.

Port of ``u2mkd_tpu/models/sphereformer.py`` on its host-geometry path
(``pregeom``): the heads split into a cubic-window branch over xyz (the first
``h // 2``) and a radial-window branch over (theta, beta, r), each with
contextual RPE, both run in f32 through kernels K3, K4 and K5
(``ops/kernels/wattn_kernel.flash_pregeom_batched``), concatenated on the head
axis and projected; then an MLP(4x) residual. Flax defaults are kept:
LayerNorm eps 1e-6 and the tanh approximation of GELU.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from u2mkd_tpu_torch.core.structures import WindowGeom
from u2mkd_tpu_torch.models.blocks import DropPath, dense
from u2mkd_tpu_torch.ops.kernels.wattn_kernel import flash_pregeom_batched


def _table(shape, generator) -> nn.Parameter:
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04, generator=generator)
    return nn.Parameter(t)


def grid_length(window: float, quant: float) -> int:
    return int((window + 1e-4) / quant)


class SphereAttention(nn.Module):
    """``SparseMultiheadSASphereConcat`` over host-built window geometry."""

    def __init__(self, dim: int, num_heads: int,
                 window_size: Tuple[float, float, float],
                 window_size_sphere: Tuple[float, float, float],
                 quant_size: Tuple[float, float, float],
                 quant_size_sphere: Tuple[float, float, float],
                 a: float = 0.0125, qkv_bias: bool = True, generator=None):
        super().__init__()
        self.num_heads = num_heads
        self.a = a
        self.plain = False
        h1 = num_heads // 2
        h2 = num_heads - h1
        d = dim // num_heads
        self.g_cub = grid_length(window_size[0], quant_size[0])
        self.g_sph = grid_length(window_size_sphere[0], quant_size_sphere[0])
        self.qkv = dense(dim, 3 * dim, generator, bias=qkv_bias)
        lc, ls = 2 * self.g_cub - 1, 2 * self.g_sph
        for name in ("q", "k", "v"):
            setattr(self, f"rel_{name}_cubic", _table((lc, 3, h1, d), generator))
            setattr(self, f"rel_{name}_sphere", _table((ls, 3, h2, d), generator))
        self.proj = dense(dim, dim, generator)

    def forward(self, feats: torch.Tensor, mask: torch.Tensor,
                geom: Dict[str, WindowGeom]) -> torch.Tensor:
        b, vcap, c = feats.shape
        h = self.num_heads
        d = c // h
        h1 = h // 2
        qkv = self.qkv(feats).reshape(b, vcap, 3, h, d)
        q, k, v = qkv[:, :, 0] * d ** -0.5, qkv[:, :, 1], qkv[:, :, 2]
        q, k, v = q.float(), k.float(), v.float()
        out1 = flash_pregeom_batched(
            q[:, :, :h1], k[:, :, :h1], v[:, :, :h1], mask, geom["cubic"],
            self.rel_q_cubic, self.rel_k_cubic, self.rel_v_cubic,
            self.g_cub, 0.0, plain=self.plain)
        out2 = flash_pregeom_batched(
            q[:, :, h1:], k[:, :, h1:], v[:, :, h1:], mask, geom["sphere"],
            self.rel_q_sphere, self.rel_k_sphere, self.rel_v_sphere,
            self.g_sph, self.a, plain=self.plain)
        out = torch.cat([out1, out2], dim=2).reshape(b, vcap, c).to(feats.dtype)
        out = self.proj(out)
        return torch.where(mask[..., None], out, 0.0)


class SphereFormerBlock(nn.Module):
    """Pre-LN transformer block (reference ``SphereFormer``)."""

    def __init__(self, dim: int, num_heads: int,
                 window_size: Tuple[float, float, float],
                 window_size_sphere: Tuple[float, float, float],
                 quant_size: Tuple[float, float, float],
                 quant_size_sphere: Tuple[float, float, float],
                 drop_path: float = 0.0, mlp_ratio: float = 4.0,
                 a: float = 0.0125, generator=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = SphereAttention(dim, num_heads, window_size,
                                    window_size_sphere, quant_size,
                                    quant_size_sphere, a=a, generator=generator)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        hidden = int(dim * mlp_ratio)
        self.mlp_fc1 = dense(dim, hidden, generator)
        self.mlp_fc2 = dense(hidden, dim, generator)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, feats: torch.Tensor, mask: torch.Tensor,
                geom: Dict[str, WindowGeom],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the drop-path masks in training."""
        x = feats + self.drop_path1(self.attn(self.norm1(feats), mask, geom), generator)
        y = self.mlp_fc2(nn.functional.gelu(self.mlp_fc1(self.norm2(x)),
                                            approximate="tanh"))
        x = x + self.drop_path2(y, generator)
        return torch.where(mask[..., None], x, 0.0)
