"""LiDAR <-> camera fusion: projection ops and fusion blocks.

Port of ``u2mkd_tpu/models/fusion.py``. Camera maps are NCHW here (the JAX
package's are NHWC); point features are [B, P, C] with a validity mask.

  * :func:`feature_gather`: bilinear sampling at normalized point
    projections, ``F.grid_sample(align_corners=True, padding_mode="zeros")``;
    x indexes the width and y the height.
  * :func:`point_to_grid`: scatter-mean of point features into each camera's
    pixel grid, with a drop bucket for points outside it. It scatters from
    the [B, P, C] features by a flattened (camera, pixel) id, one camera at a
    time, so the features are never broadcast over the cameras.
  * :func:`feature_fetch`: multi-camera gather, later cameras win, zeros
    outside every field of view.
  * :class:`AttenFusionConv` (camera -> LiDAR), :class:`L2CFusion`
    (LiDAR -> camera, its 1x1 convs carry biases) and :class:`LearnerMLP`.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference.models.blocks import MaskedBatchNorm, dense
from port_bench.reference.models.swiftnet import BatchNorm2d, conv1x1
from port_bench.reference.ops import segment, voxelize


def _bilinear_corners(coords: torch.Tensor, h: int, w: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The four bilinear corners of ``F.grid_sample(align_corners=True,
    padding_mode="zeros")`` at coords [N, P, 2]: pixel rows [N, P, 4] into
    each map's h * w pixels (-1 outside it) and weights [N, P, 4], in torch's
    order (nw, ne, sw, se) and with its formulas."""
    ix = (coords[..., 0] + 1) / 2 * (w - 1)
    iy = (coords[..., 1] + 1) / 2 * (h - 1)
    ix_nw, iy_nw = torch.floor(ix), torch.floor(iy)
    ix_se, iy_se = ix_nw + 1, iy_nw + 1
    corners = ((ix_nw, iy_nw, (ix_se - ix) * (iy_se - iy)),
               (ix_se, iy_nw, (ix - ix_nw) * (iy_se - iy)),
               (ix_nw, iy_se, (ix_se - ix) * (iy - iy_nw)),
               (ix_se, iy_se, (ix - ix_nw) * (iy - iy_nw)))
    rows, weights = [], []
    for cx, cy, wt in corners:
        inside = (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)
        rows.append(torch.where(inside, cy.long() * w + cx.long(), -1))
        weights.append(wt)
    return torch.stack(rows, -1), torch.stack(weights, -1)


class _GridSample(torch.autograd.Function):
    """``F.grid_sample`` (bilinear, zeros, align corners) whose backward
    to the map adds each pixel's corner terms in a fixed order (point by
    point, nw, ne, sw, se within a point: the CPU kernel's order) through a
    sorted segment sum (``ops/segment.py``), where torch's card kernel adds
    them with atomics. The coordinates get no gradient."""

    @staticmethod
    def forward(ctx, fmap, coords):
        ctx.save_for_backward(coords)
        ctx.map_shape = fmap.shape
        return F.grid_sample(fmap, coords[:, None], mode="bilinear", padding_mode="zeros",
                             align_corners=True)

    @staticmethod
    def backward(ctx, g):
        (coords,) = ctx.saved_tensors
        n, c, h, w = ctx.map_shape
        rows, wts = _bilinear_corners(coords, h, w)                 # [N, P, 4]
        base = torch.arange(n, device=rows.device)[:, None, None] * (h * w)
        ids = torch.where(rows >= 0, rows + base, -1)
        terms = g[:, :, 0].transpose(1, 2)[:, :, None, :] * wts[..., None]   # [N, P, 4, C]
        grad = segment.segment_sum(terms.reshape(-1, c), segment.plan(ids, n * h * w))
        return grad.view(n, h, w, c).permute(0, 3, 1, 2), None


def feature_gather(fmap: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of fmap [N, C, H, W] at coords [N, P, 2] ((x, y) in
    [-1, 1], align corners, zeros outside) -> [N, P, C]. The coordinates
    carry no gradient."""
    out = _GridSample.apply(fmap, coords.detach())             # [N, C, 1, P]
    return out[:, :, 0].transpose(1, 2)


def point_to_grid(pfeats: torch.Tensor, coords: torch.Tensor, masks: torch.Tensor,
                  size: Tuple[int, int]) -> torch.Tensor:
    """Scatter-mean of point features pfeats [B, P, C] into each camera's
    [h, w] grid: coords [B, NCAM, P, 2], masks [B, NCAM, P] -> [B*NCAM, C, h,
    w]. Pixel uv = floor((coord + 1) / 2 * (dim - 1)); points sharing a
    pixel average; masked points and points off the grid go to the drop
    bucket. Each pixel's sum adds its points in index order (a sorted
    segment sum, ``ops/segment.py``)."""
    b, ncam, _, _ = coords.shape
    h, w = size
    u = torch.floor((coords[..., 0] + 1.0) * 0.5 * (w - 1)).long()
    v = torch.floor((coords[..., 1] + 1.0) * 0.5 * (h - 1)).long()
    ok = masks & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    seg = torch.where(ok, v * w + u, h * w)                    # [B, NCAM, P]
    grids = []
    for bi in range(b):
        for ci in range(ncam):
            grids.append(voxelize.segment_mean(pfeats[bi], seg[bi, ci], h * w))
    grid = torch.stack(grids)                                   # [B*NCAM, h*w, C]
    return grid.reshape(b * ncam, h, w, -1).permute(0, 3, 1, 2)


def feature_fetch(fmaps: torch.Tensor, coords: torch.Tensor,
                  cam_masks: torch.Tensor) -> torch.Tensor:
    """Per-point features from the camera maps fmaps [B, NCAM, C, H, W] at
    coords [B, NCAM, P, 2]: camera after camera overwrites where its mask
    [B, NCAM, P] holds (later cameras win); zeros outside every field of
    view -> [B, P, C]."""
    out = None
    for i in range(fmaps.shape[1]):
        g = feature_gather(fmaps[:, i], coords[:, i])          # [B, P, C]
        out = torch.where(cam_masks[:, i, :, None], g, 0.0 if out is None else out)
    return out


class AttenFusionConv(nn.Module):
    """Camera -> LiDAR gated attention fusion on per-point features [B, P,
    C] (``IA_Layer`` + ``Atten_Fusion_Conv``); BatchNorms over valid points."""

    def __init__(self, point_ch: int, img_ch: int, out_ch: int, generator=None,
                 process_group=None):
        super().__init__()
        rc = point_ch // 4
        self.ia_fc1_bn = MaskedBatchNorm(img_ch, process_group=process_group)
        self.ia_fc1 = dense(img_ch, rc, generator)
        self.ia_fc2 = dense(point_ch, rc, generator)
        self.ia_fc3 = dense(rc, 1, generator)
        self.ia_conv1 = dense(img_ch, point_ch, generator)
        self.ia_conv1_bn = MaskedBatchNorm(point_ch, process_group=process_group)
        self.fuse_conv = dense(2 * point_ch, out_ch, generator)
        self.fuse_bn = MaskedBatchNorm(out_ch, process_group=process_group)

    def forward(self, point_feats: torch.Tensor, img_feats: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        ri = self.ia_fc1(torch.relu(self.ia_fc1_bn(img_feats, mask)))
        rp = self.ia_fc2(point_feats)
        att = torch.sigmoid(self.ia_fc3(torch.tanh(ri + rp)))
        img_new = torch.relu(self.ia_conv1_bn(self.ia_conv1(img_feats), mask)) * att
        fused = self.fuse_conv(torch.cat([point_feats, img_new], dim=-1))
        return torch.relu(self.fuse_bn(fused, mask))


class L2CFusion(nn.Module):
    """LiDAR -> camera gated fusion on maps [N, C, H, W] (``L2CAILayer`` +
    ``L2CFusion``). Returns (relu(fused), fused): the reference feeds the
    ReLU forward and keeps the pre-activation as the stage skip."""

    def __init__(self, point_ch: int, img_ch: int, out_ch: int, generator=None,
                 process_group=None):
        super().__init__()
        rc = img_ch // 4
        self.ai_fc1 = conv1x1(img_ch, rc, generator)
        self.ai_fc2 = conv1x1(point_ch, rc, generator)
        self.ai_fc3 = conv1x1(rc, 1, generator)
        self.ai_conv1 = conv1x1(point_ch, img_ch, generator)
        self.ai_conv1_bn = BatchNorm2d(img_ch, process_group=process_group)
        self.fuse_conv = conv1x1(2 * img_ch, out_ch, generator)
        self.fuse_bn = BatchNorm2d(out_ch, process_group=process_group)

    def forward(self, point_grid: torch.Tensor, img_feats: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        ri = self.ai_fc1(img_feats)
        rp = self.ai_fc2(point_grid)
        att = torch.sigmoid(self.ai_fc3(torch.tanh(ri + rp)))
        p_new = torch.relu(self.ai_conv1_bn(self.ai_conv1(point_grid))) * att
        fused = self.fuse_bn(self.fuse_conv(torch.cat([img_feats, p_new], dim=1)))
        return torch.relu(fused), fused


class LearnerMLP(nn.Module):
    """Pseudo-image-feature learner: Linear-BN-ReLU-Linear-BN."""

    def __init__(self, in_ch: int, out_ch: int, generator=None,
                 process_group=None):
        super().__init__()
        self.fc1 = dense(in_ch, out_ch, generator)
        self.bn1 = MaskedBatchNorm(out_ch, process_group=process_group)
        self.fc2 = dense(out_ch, out_ch, generator)
        self.bn2 = MaskedBatchNorm(out_ch, process_group=process_group)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.fc1(x), mask))
        return self.bn2(self.fc2(x), mask)
