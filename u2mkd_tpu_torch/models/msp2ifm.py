"""The cross-modal student: an SPVCNN + SphereFormer LiDAR branch fused both
ways with a SwiftNet-18 image branch (MSP2IFM).

Port of ``u2mkd_tpu/models/msp2ifm.py``. Per encoder stage:

  * sparse down conv, two residual blocks and a SphereFormer block (K1, and
    K3 or the banded attention as ``pallas_attention`` and ``pallas_cubic``
    say; K3 over the host geometry, ``level_geom``, or over windows sorted
    in the step), then the stage's point features (trilinear devoxelize);
  * the image ResNet stage (and the SPP at stage 4);
  * L2C: the point features scattered into each camera grid at 4 - idx
    scales, averaged, then :class:`~fusion.L2CFusion`;
  * C2L: image features gathered at the point projections, the learner's
    pseudo-image features outside every field of view, then
    :class:`~fusion.AttenFusionConv`;
  * back into the voxel stream.

The decoder is SPVCNN's; the pixel head decodes the image skips up to the
image size and fetches per-point logits. ``lidar_only`` is the camera-free
path: it skips the SphereFormer blocks, as the reference does, and fuses the
learner's features. Attribute names mirror the flax module names.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from u2mkd_tpu_torch.models import blocks, fusion
from u2mkd_tpu_torch.models.plumbing import UNetPlumbing, point_to_voxel, voxel_to_point
from u2mkd_tpu_torch.models.sphereformer import SphereAttention, SphereFormerBlock
from u2mkd_tpu_torch.models.spvcnn import decoder_stage, encoder_stage, stem
from u2mkd_tpu_torch.models.swiftnet import (BNReluConv, SwiftNetResNet,
                                             resize_bilinear_align_corners)
from u2mkd_tpu_torch.ops import losses


class SPVCNNSwiftNetMSP2IFM(nn.Module):
    # the camera path meets the points at every level (L2C and C2L)
    point_levels = (0, 1, 2, 3, 4)

    def __init__(self, num_classes: int = 17, cr: float = 1.0, in_channel: int = 4,
                 base_channels: Tuple[int, ...] = (32, 32, 64, 128, 256, 256, 128, 96, 96),
                 dropout_rate: float = 0.3,
                 window_size=(0.3, 0.3, 0.3), window_size_sphere=(2.0, 2.0, 120.0),
                 quant_size=(0.3 / 24,) * 3, quant_size_sphere=(2.0 / 24, 2.0 / 24, 5.0),
                 window_size_scale=(2.0, 2.0), drop_path_rate: float = 0.3,
                 sphere_a: float = 0.0125, head_dim: int = 16,
                 adapt_out_ch: Optional[int] = None, run_pix_decoder: bool = True,
                 pallas_attention: bool = False, pallas_cubic: bool = True, generator=None,
                 process_group=None):
        super().__init__()
        self.cr, self.head_dim = cr, head_dim
        self.base_channels = tuple(base_channels)
        self.pallas_attention, self.pallas_cubic = pallas_attention, pallas_cubic
        self.num_classes = num_classes
        self.window_size, self.window_size_sphere = tuple(window_size), tuple(window_size_sphere)
        self.quant_size, self.quant_size_sphere = tuple(quant_size), tuple(quant_size_sphere)
        self.window_size_scale = tuple(window_size_scale)
        self.adapt_out_ch, self.run_pix_decoder = adapt_out_ch, run_pix_decoder
        cs = [int(cr * x) for x in base_channels]
        gen = generator
        kw = dict(generator=gen, process_group=process_group)  # the blocks with a BN

        self.pix_branch = SwiftNetResNet(**kw)
        img_cs = self.pix_branch.img_cs
        self.stem0 = blocks.SparseConvBlock(in_channel, cs[0], ks=3, **kw)
        self.stem1 = blocks.SparseConvBlock(cs[0], cs[0], ks=3, **kw)
        dpr = [float(x) for x in np.linspace(0, drop_path_rate, 7)]
        ws, qs = list(window_size), list(quant_size)
        wss, qss = list(window_size_sphere), list(quant_size_sphere)
        wsc, wss_scale = window_size_scale
        for idx in range(4):
            c = cs[idx + 1]
            setattr(self, f"down{idx}_conv",
                    blocks.SparseConvBlock(cs[idx], cs[idx], stride=2, **kw))
            setattr(self, f"down{idx}_res0", blocks.SparseResBlock(cs[idx], c, **kw))
            setattr(self, f"down{idx}_res1", blocks.SparseResBlock(c, c, **kw))
            setattr(self, f"sphereformer{idx + 1}", SphereFormerBlock(
                dim=c, num_heads=c // head_dim, window_size=tuple(ws),
                window_size_sphere=tuple(wss), quant_size=tuple(qs),
                quant_size_sphere=tuple(qss), drop_path=dpr[idx + 1], a=sphere_a,
                pallas_attention=pallas_attention, pallas_cubic=pallas_cubic, generator=gen))
            ws = [w * wsc for w in ws]
            qs = [q * wsc for q in qs]
            wss = [wss[0] * wss_scale, wss[1] * wss_scale, wss[2]]
            qss = [qss[0] * wss_scale, qss[1] * wss_scale, qss[2]]
            setattr(self, f"l2c{idx}",
                    fusion.L2CFusion(c, img_cs[idx + 1], img_cs[idx + 1], **kw))
            setattr(self, f"learner{idx}", fusion.LearnerMLP(c, img_cs[idx + 1], **kw))
            setattr(self, f"c2l{idx}",
                    fusion.AttenFusionConv(c, img_cs[idx + 1], c, **kw))
        if adapt_out_ch is not None:
            self.adapt_fc = blocks.dense(cs[4], adapt_out_ch, gen)
            self.adapt_bn = blocks.MaskedBatchNorm(adapt_out_ch, process_group=process_group)

        self.point_transform0 = blocks.PointMLP(cs[0], cs[4], **kw)
        self.point_transform1 = blocks.PointMLP(cs[4], cs[6], **kw)
        self.point_transform2 = blocks.PointMLP(cs[6], cs[8], **kw)
        skips = (cs[3], cs[2], cs[1], cs[0])
        for i in range(4):
            cin, cout = cs[4 + i], cs[5 + i]
            setattr(self, f"up{i}_deconv", blocks.SparseDeconvBlock(cin, cout, **kw))
            setattr(self, f"up{i}_res0",
                    blocks.SparseResBlock(cout + skips[i], cout, **kw))
            setattr(self, f"up{i}_res1", blocks.SparseResBlock(cout, cout, **kw))
        self.dropout = blocks.Dropout(dropout_rate)
        self.classifier_vox = blocks.dense(cs[8], num_classes, gen)
        if run_pix_decoder:
            self.classifier_pix = BNReluConv(self.pix_branch.img_cs[4], num_classes, k=1,
                                             **kw)

    def set_plain(self, plain: bool) -> None:
        """Run the kernels' plain versions (True) or the kernels (False) on
        any device: the reference mode a card run is checked against."""
        for m in self.modules():
            if isinstance(m, (blocks.SparseConv, SphereAttention)):
                m.plain = plain

    def _l2c_map(self, pts_feat: torch.Tensor, pix_coords: torch.Tensor,
                 cam_masks: torch.Tensor, size: Tuple[int, int], n_scales: int) -> torch.Tensor:
        """The point features scattered into every camera grid at
        ``n_scales`` scales (grid size halving), each resized to ``size``,
        averaged: [B*NCAM, C, h, w]."""
        ifh, ifw = size
        l2c_map, cnt = 0.0, 1
        for _ in range(n_scales):
            c_ih = int(round(ifh / cnt + 0.01))
            c_iw = int(round(ifw / cnt + 0.01))
            grid = fusion.point_to_grid(pts_feat, pix_coords, cam_masks, (c_ih, c_iw))
            l2c_map = l2c_map + resize_bilinear_align_corners(grid, (ifh, ifw))
            cnt *= 2
        return l2c_map / n_scales

    def forward(self, pfeats: torch.Tensor, plumbing: UNetPlumbing,
                images: Optional[torch.Tensor], pix_coords: Optional[torch.Tensor],
                cam_masks: Optional[torch.Tensor], fov_mask: Optional[torch.Tensor],
                lidar_only: bool = False,
                generator: Optional[torch.Generator] = None, remat: bool = False) -> Dict:
        """pfeats [B, P, Cin]; images [B, NCAM, H, W, 3] (the JAX package's
        NHWC); pix_coords [B, NCAM, P, 2] in [-1, 1]; cam_masks [B, NCAM, P];
        fov_mask [B, P]; the last four None with ``lidar_only``. The plumbing
        carries the point maps of every level, and the window geometry of
        every encoder level or the voxel means the attention sorts its
        windows on. Returns {"x_vox" [B, P, classes]} and, on the
        camera path, "x_pix" [B, P, classes] (zero outside every field of
        view), "mse_loss" (one per stage) and "pts_feats" (the adapted
        stage-4 features, with ``adapt_out_ch``). ``remat`` runs as
        checkpointed segments (``blocks.Remat``), when gradients are on: the
        LiDAR stem, encoder and decoder stages and point MLPs (as SPVCNN's),
        the image stem, each ResNet layer, the SPP, each stage's L2C and C2L
        fusion, each upsample block and the pixel head."""
        run = blocks.Remat(remat, generator)
        lv = plumbing.levels
        pmask = plumbing.pmask
        caps = [l.grid.capacity for l in lv]
        pb = self.pix_branch

        x0 = point_to_voxel(pfeats, plumbing.p2v0_feats_seg, caps[0])
        x0 = run(stem, self, x0, lv[0])
        z0 = voxel_to_point(x0, plumbing.devox_idx[0], plumbing.devox_w[0])
        if not lidar_only:
            b, ncam, ih, iw, _ = images.shape
            x_im = run(pb.forward_stem, images.reshape(b * ncam, ih, iw, 3).permute(0, 3, 1, 2))

        vox_feats = [point_to_voxel(z0, plumbing.p2v[0], caps[0])]
        img_skips, mse_losses = [], []
        kd_feats = None
        pts_feat = None
        for idx in range(4):
            f = run(encoder_stage, self, idx, vox_feats[idx], plumbing, generator, not lidar_only)
            pts_feat = voxel_to_point(f, plumbing.devox_idx[idx + 1],
                                      plumbing.devox_w[idx + 1])
            if idx == 3 and self.adapt_out_ch is not None:
                kd_feats = torch.relu(self.adapt_bn(self.adapt_fc(pts_feat), pmask))

            if lidar_only:
                learner = getattr(self, f"learner{idx}")
                pts_feat = getattr(self, f"c2l{idx}")(pts_feat, learner(pts_feat, pmask), pmask)
            else:
                x_im, skip = run(pb.forward_resblock, x_im, idx)
                if idx == 3:
                    skip = run(pb.forward_spp, skip)
                x_im, skip = run(self._l2c, idx, pts_feat, skip, pix_coords, cam_masks)
                img_skips.append(skip)
                pts_feat, mse = run(self._c2l, idx, pts_feat, skip, pix_coords, cam_masks,
                                    fov_mask, pmask)
                mse_losses.append(mse)
            vox_feats.append(point_to_voxel(pts_feat, plumbing.p2v[idx + 1], caps[idx + 1]))

        x1, x2, x3 = vox_feats[1:4]
        # the stage-4 fused point features (reference :511)
        z1 = pts_feat + run(self.point_transform0, z0, pmask)
        y1 = run(decoder_stage, self, 0, z1, x3, plumbing, generator)
        y2 = run(decoder_stage, self, 1, y1, x2, plumbing, generator)
        z2 = voxel_to_point(y2, plumbing.devox_idx[2], plumbing.devox_w[2])
        z2 = z2 + run(self.point_transform1, z1, pmask)
        y3 = run(decoder_stage, self, 2, z2, x1, plumbing, generator)
        y4 = run(decoder_stage, self, 3, y3, x0, plumbing, generator)
        z3 = voxel_to_point(y4, plumbing.devox_idx[0], plumbing.devox_w[0])
        z3 = z3 + run(self.point_transform2, z2, pmask)

        out = {"x_vox": self.classifier_vox(z3)}
        if not lidar_only:
            out["mse_loss"] = mse_losses
            if kd_feats is not None:
                out["pts_feats"] = kd_feats
            if self.run_pix_decoder:
                up = pb.forward_up(img_skips, run=run)
                out["x_pix"] = run(self._pix_head, up, (ih, iw), pix_coords, cam_masks)
        return out

    def _l2c(self, idx: int, pts_feat: torch.Tensor, skip: torch.Tensor,
             pix_coords: torch.Tensor, cam_masks: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stage ``idx``'s LiDAR -> camera fusion: the point features
        scattered into the camera grids at 4 - idx scales, then
        ``l2c{idx}`` -> (image features, the stage's skip)."""
        size = tuple(skip.shape[-2:])
        l2c_map = self._l2c_map(pts_feat, pix_coords, cam_masks, size, 4 - idx)
        return getattr(self, f"l2c{idx}")(l2c_map, skip)

    def _c2l(self, idx: int, pts_feat: torch.Tensor, skip: torch.Tensor,
             pix_coords: torch.Tensor, cam_masks: torch.Tensor, fov_mask: torch.Tensor,
             pmask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stage ``idx``'s camera -> LiDAR fusion: the skip's features at the
        point projections, the learner's pseudo-image features outside every
        field of view, then ``c2l{idx}`` -> (fused point features, the
        learner's MSE against the camera features)."""
        b, ncam = pix_coords.shape[:2]
        ifc, size = skip.shape[1], tuple(skip.shape[-2:])
        imf = fusion.feature_fetch(skip.reshape(b, ncam, ifc, *size), pix_coords, cam_masks)
        pseudo = getattr(self, f"learner{idx}")(pts_feat, pmask)
        imf = torch.where(fov_mask[..., None], imf, pseudo)
        mse = losses.masked_mse(pseudo.reshape(-1, ifc), imf.detach().reshape(-1, ifc),
                                (fov_mask & pmask).reshape(-1))
        return getattr(self, f"c2l{idx}")(pts_feat, imf, pmask), mse

    def _pix_head(self, x: torch.Tensor, im_size: Tuple[int, int], pix_coords: torch.Tensor,
                  cam_masks: torch.Tensor) -> torch.Tensor:
        """The decoded image features resized to the image, the pixel
        classifier, and its logits at the point projections."""
        b, ncam = pix_coords.shape[:2]
        fmap = self.classifier_pix(resize_bilinear_align_corners(x, im_size))
        return fusion.feature_fetch(fmap.reshape(b, ncam, self.num_classes, *im_size),
                                    pix_coords, cam_masks)
