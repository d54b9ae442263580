"""CamLiFlow-style bidirectional camera-LiDAR fusion (CLFM).

Port of ``u2mkd_tpu/models/clfm.py``: :class:`FusionAwareInterp` splats
point features onto the pixel grid through the kNN in uv space with a
learned offset-score gate, :class:`SKFusion` gates two aligned feature maps
channel-wise, and :class:`CLFM` joins them both ways (2D <- interp(3D),
3D <- sample(2D)). Channel-last, as the JAX modules: maps [H, W, C], point
sets [N, C]. The attribute names mirror the flax module names.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from u2mkd_tpu_torch.models.blocks import dense
from u2mkd_tpu_torch.models.fusion import feature_gather
from u2mkd_tpu_torch.ops.pointops import knn


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return nn.functional.leaky_relu(x, 0.1)


class FusionAwareInterp(nn.Module):
    """Point features to the pixel grid through the uv-space kNN."""

    def __init__(self, n_channels_3d: int, k: int = 1, generator=None):
        super().__init__()
        self.n_channels_3d, self.k = n_channels_3d, k
        self.score_fc1 = dense(3, 16, generator)
        self.score_fc2 = dense(16, n_channels_3d, generator)
        self.out_conv = dense(n_channels_3d, n_channels_3d, generator)

    def forward(self, uv: torch.Tensor, feat_3d: torch.Tensor, grid_hw: Tuple[int, int],
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """uv [N, 2] pixel coords, feat_3d [N, C3] -> [H, W, C3]. ``mask`` [N]
        bool keeps padded points out of the kNN (fixed-capacity buffers park
        them at uv (0, 0), where they would win the pixels near the
        origin)."""
        h, w = grid_hw
        dev = uv.device
        gx = torch.arange(w, dtype=torch.float32, device=dev).repeat(h)
        gy = torch.arange(h, dtype=torch.float32, device=dev).repeat_interleave(w)
        grid = torch.stack([gx, gy], dim=-1)                             # [HW, 2]
        idx = knn(grid, uv, self.k, points_valid=mask).long()            # [HW, k]
        off = uv[idx] - grid[:, None, :]
        score_in = torch.cat([off, torch.linalg.vector_norm(off, dim=-1, keepdim=True)], -1)
        s = torch.sigmoid(self.score_fc2(_leaky(self.score_fc1(score_in))))
        out = (s * feat_3d[idx]).sum(dim=1).reshape(h, w, self.n_channels_3d)
        return _leaky(self.out_conv(out))


class SKFusion(nn.Module):
    """Selective-kernel gate between two aligned feature maps [..., C_a] and
    [..., C_b] -> [..., out_channels]."""

    def __init__(self, in_a: int, in_b: int, out_channels: int, reduction: int = 1,
                 generator=None):
        super().__init__()
        self.out_channels = out_channels
        self.align1 = dense(in_a, out_channels, generator)
        self.align2 = dense(in_b, out_channels, generator)
        self.fc_mid = dense(out_channels, out_channels // reduction, generator, bias=False)
        self.fc_out = dense(out_channels // reduction, 2 * out_channels, generator, bias=False)

    def forward(self, feat_a: torch.Tensor, feat_b: torch.Tensor) -> torch.Tensor:
        a = _leaky(self.align1(feat_a))
        b = _leaky(self.align2(feat_b))
        pooled = (a + b).reshape(-1, self.out_channels).mean(dim=0)
        wgt = torch.sigmoid(self.fc_out(torch.relu(self.fc_mid(pooled))))
        wgt = torch.softmax(wgt.reshape(self.out_channels, 2), dim=-1)
        return a * wgt[:, 0] + b * wgt[:, 1]


class CLFM(nn.Module):
    """Bidirectional camera-LiDAR fusion (the reference's ``CLFM``)."""

    def __init__(self, in_channels_2d: int, in_channels_3d: int, generator=None):
        super().__init__()
        gen = generator
        self.interp = FusionAwareInterp(in_channels_3d, generator=gen)
        self.fuse2d = SKFusion(in_channels_2d, in_channels_3d, in_channels_2d, 2, gen)
        self.mlps3d = dense(in_channels_2d, in_channels_2d, gen)
        self.fuse3d = SKFusion(in_channels_2d, in_channels_3d, in_channels_3d, 2, gen)

    def forward(self, uv: torch.Tensor, feat_2d: torch.Tensor, feat_3d: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """uv [N, 2] pixel coords, feat_2d [H, W, C2], feat_3d [N, C3], mask
        [N] bool (live points) -> (out2d [H, W, C2], out3d [N, C3]). Neither
        direction's gradient flows into the other modality's input."""
        h, w, _ = feat_2d.shape
        interp = self.interp(uv, feat_3d.detach(), (h, w), mask=mask)
        out2d = self.fuse2d(feat_2d, interp)
        # the 2D features at uv: bilinear over pixel coords, align corners
        norm_uv = torch.stack([uv[:, 0] / (w - 1.0) * 2 - 1, uv[:, 1] / (h - 1.0) * 2 - 1], -1)
        sampled = feature_gather(feat_2d.detach().permute(2, 0, 1)[None], norm_uv[None])[0]
        sampled = _leaky(self.mlps3d(sampled))
        out3d = self.fuse3d(sampled, feat_3d)
        return out2d, out3d
