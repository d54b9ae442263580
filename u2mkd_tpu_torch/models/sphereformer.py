"""SphereFormer block: dual cubic + radial window attention.

Port of ``u2mkd_tpu/models/sphereformer.py``: the heads split into a
cubic-window branch over xyz (the first ``h // 2``) and a radial-window
branch over (theta, beta, r), each with contextual RPE, run in f32,
concatenated on the head axis and projected; then an MLP(4x) residual. Flax
defaults are kept: LayerNorm eps 1e-6 and the tanh approximation of GELU.

Each branch takes the JAX module's route:

  * ``pallas_attention`` (and, for the cubic branch, ``pallas_cubic``) on:
    kernels K3, K4 and K5, exact at any window occupancy, over the host
    geometry where the plumbing carries it
    (``ops/kernels/wattn_kernel.flash_pregeom_batched``), else over windows
    sorted in the step (``sparse_window_attention_flash_batched``);
  * off: the banded attention (``ops/wattn.sparse_window_attention``), in
    plain torch as JAX leaves it to XLA, which drops the pairs of a window
    further apart than ``band * tile`` sorted rows (``band_cubic`` and
    ``band_sphere`` tiles).

Under remat (``blocks.Remat``) the block is part of its encoder stage's
segment: the recompute runs K3 again over the same geometry (a window sort
taken in the step is the forward's, ``blocks.reused``; the banded
attention sorts again, stably, to the same order) and draws the forward's
drop-path masks, and ``FlashRPE``'s backward (K4, K5) reads the
recompute's output and lse.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from u2mkd_tpu_torch.core.structures import WindowGeom
from u2mkd_tpu_torch.models.blocks import DropPath, dense, reused, trunc_normal_
from u2mkd_tpu_torch.ops import wattn
from u2mkd_tpu_torch.ops.kernels.wattn_kernel import (flash_pregeom_batched,
                                                      sparse_window_attention_flash_batched,
                                                      window_sort_batched)


def _table(shape, generator) -> nn.Parameter:
    t = torch.empty(shape)
    trunc_normal_(t, 0.02, -0.04, 0.04, generator)
    return nn.Parameter(t)


def grid_length(window: float, quant: float) -> int:
    return int((window + 1e-4) / quant)


class SphereAttention(nn.Module):
    """``SparseMultiheadSASphereConcat``; ``plain`` runs the kernels' plain
    versions on any device (the reference a card run is held against)."""

    def __init__(self, dim: int, num_heads: int,
                 window_size: Tuple[float, float, float],
                 window_size_sphere: Tuple[float, float, float],
                 quant_size: Tuple[float, float, float],
                 quant_size_sphere: Tuple[float, float, float],
                 a: float = 0.0125, qkv_bias: bool = True, band_cubic: int = 1,
                 band_sphere: int = 4, tile: int = 128, pallas_attention: bool = False,
                 pallas_cubic: bool = True, generator=None):
        super().__init__()
        self.num_heads = num_heads
        self.a = a
        self.plain = False
        self.window_size, self.window_size_sphere = tuple(window_size), tuple(window_size_sphere)
        self.quant_size, self.quant_size_sphere = tuple(quant_size), tuple(quant_size_sphere)
        self.band_cubic, self.band_sphere, self.tile = band_cubic, band_sphere, tile
        self.pallas_attention, self.pallas_cubic = pallas_attention, pallas_cubic
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

    def forward(self, feats: torch.Tensor, xyz: Optional[torch.Tensor], mask: torch.Tensor,
                geom: Optional[Dict[str, WindowGeom]] = None) -> torch.Tensor:
        """feats [B, V, C], xyz [B, V, 3] metric (read only by a branch
        that takes its windows in the step), mask [B, V]; ``geom``: the
        host geometry {"cubic", "sphere"} of this level, or None."""
        b, vcap, c = feats.shape
        h = self.num_heads
        d = c // h
        h1 = h // 2
        qkv = self.qkv(feats).reshape(b, vcap, 3, h, d)
        q, k, v = qkv[:, :, 0] * d ** -0.5, qkv[:, :, 1], qkv[:, :, 2]
        q, k, v = q.float(), k.float(), v.float()
        flash = self.pallas_attention
        sph = None if (flash and geom is not None) else wattn.cart2sphere(xyz)
        out1 = self._branch(q[:, :, :h1], k[:, :, :h1], v[:, :, :h1], xyz, mask, geom, "cubic",
                            flash and self.pallas_cubic)
        out2 = self._branch(q[:, :, h1:], k[:, :, h1:], v[:, :, h1:], sph, mask, geom,
                            "sphere", flash)
        out = torch.cat([out1, out2], dim=2).reshape(b, vcap, c).to(feats.dtype)
        out = self.proj(out)
        return torch.where(mask[..., None], out, 0.0)

    def _branch(self, q, k, v, coords, mask, geom, branch: str, flash: bool):
        """One branch's heads [B, V, h, d] over its window coordinates
        (xyz, or (theta, beta, r) for the sphere branch)."""
        if q.shape[2] == 0:  # a branch with no heads (one head in all)
            return q
        sphere = branch == "sphere"
        tables = [getattr(self, f"rel_{n}_{branch}") for n in ("q", "k", "v")]
        g = self.g_sph if sphere else self.g_cub
        a = self.a if sphere else 0.0
        if flash and geom is not None:
            return flash_pregeom_batched(q, k, v, mask, geom[branch], *tables, g, a,
                                         plain=self.plain)
        ws = self.window_size_sphere if sphere else self.window_size
        qs = self.quant_size_sphere if sphere else self.quant_size
        quant = torch.stack([wattn.quantize_in_window(x, m, ws, qs)
                             for x, m in zip(coords, mask)])
        r = coords[..., 2] if sphere else None
        if flash:
            rpe = wattn.RPEParams(*tables, quant, g, r, self.a)
            # a remat segment's recompute takes the forward's sort
            sw = reused(window_sort_batched, coords, mask, ws)
            return sparse_window_attention_flash_batched(q, k, v, coords, mask, ws, rpe,
                                                         plain=self.plain, sw=sw)
        band = self.band_sphere if sphere else self.band_cubic
        return torch.stack([
            wattn.sparse_window_attention(
                q[i], k[i], v[i], coords[i], mask[i], ws,
                wattn.RPEParams(*tables, quant[i], g, None if r is None else r[i], self.a),
                band=band, tile=self.tile)
            for i in range(q.shape[0])]).to(q.dtype)


class SphereFormerBlock(nn.Module):
    """Pre-LN transformer block (reference ``SphereFormer``)."""

    def __init__(self, dim: int, num_heads: int,
                 window_size: Tuple[float, float, float],
                 window_size_sphere: Tuple[float, float, float],
                 quant_size: Tuple[float, float, float],
                 quant_size_sphere: Tuple[float, float, float],
                 drop_path: float = 0.0, mlp_ratio: float = 4.0,
                 a: float = 0.0125, band_cubic: int = 1, band_sphere: int = 4,
                 tile: int = 128, pallas_attention: bool = False, pallas_cubic: bool = True,
                 generator=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = SphereAttention(dim, num_heads, window_size,
                                    window_size_sphere, quant_size,
                                    quant_size_sphere, a=a, band_cubic=band_cubic,
                                    band_sphere=band_sphere, tile=tile,
                                    pallas_attention=pallas_attention,
                                    pallas_cubic=pallas_cubic, generator=generator)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        hidden = int(dim * mlp_ratio)
        self.mlp_fc1 = dense(dim, hidden, generator)
        self.mlp_fc2 = dense(hidden, dim, generator)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, feats: torch.Tensor, xyz: Optional[torch.Tensor], mask: torch.Tensor,
                geom: Optional[Dict[str, WindowGeom]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """As :meth:`SphereAttention.forward`; ``generator`` draws the
        drop-path masks in training."""
        x = feats + self.drop_path1(self.attn(self.norm1(feats), xyz, mask, geom), generator)
        y = self.mlp_fc2(nn.functional.gelu(self.mlp_fc1(self.norm2(x)),
                                            approximate="tanh"))
        x = x + self.drop_path2(y, generator)
        return torch.where(mask[..., None], x, 0.0)
