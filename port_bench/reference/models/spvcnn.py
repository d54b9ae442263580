"""SPVCNN + SphereFormer: the sparse point-voxel U-Net teacher.

Port of ``u2mkd_tpu/models/spvcnn.py``: stem (2x ks3 conv) -> 4 encoder stages (ks2/s2 down conv + 2 residual
blocks + a SphereFormer block) -> 4 decoder stages (transposed conv + skip
concat + 2 residual blocks), three point-stream MLP fusions, dropout before
decoder stages 1 and 3, and a per-point classifier. ``sphereformer=False``
is the conv-only SPVCNN (reference ``core/models/semantickitti/spvcnn.py``),
without the SphereFormer blocks; unlike the flax module's, the port's
default is the SphereFormer teacher. ``pallas_attention`` and
``pallas_cubic`` route each attention branch as the flax module's do
(``models/sphereformer.py``): kernel K3 over the host geometry or over
windows sorted in the step, or the banded attention. The attribute names
mirror the flax module names. ``remat`` runs the stem, each encoder stage
(with its SphereFormer block), each decoder stage and each point MLP as a
checkpointed segment (``blocks.Remat``); :func:`stem`,
:func:`encoder_stage` and :func:`decoder_stage` are shared with the
student's LiDAR branch.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from port_bench.reference.core.device import resolve_device
from port_bench.reference.models import blocks
from port_bench.reference.models import plumbing as P
from port_bench.reference.models.plumbing import UNetPlumbing, point_to_voxel, voxel_to_point
from port_bench.reference.models.sphereformer import SphereAttention, SphereFormerBlock


class SPVCNN(nn.Module):
    # levels at which the point branch meets the voxels (voxelize and
    # devoxelize); the point maps of the other levels stay on the host
    point_levels = (0, 2, 4)

    def __init__(self, num_classes: int = 17, cr: float = 1.0, in_channel: int = 4,
                 base_channels: Tuple[int, ...] = (32, 32, 64, 128, 256, 256, 128, 96, 96),
                 dropout_rate: float = 0.3,
                 window_size=(0.3, 0.3, 0.3), window_size_sphere=(2.0, 2.0, 120.0),
                 quant_size=(0.3 / 24,) * 3, quant_size_sphere=(2.0 / 24, 2.0 / 24, 5.0),
                 window_size_scale=(2.0, 1.5), drop_path_rate: float = 0.3,
                 sphere_a: float = 0.0125, head_dim: int = 16,
                 return_point_feats: bool = False, sphereformer: bool = True,
                 pallas_attention: bool = False, pallas_cubic: bool = True, generator=None,
                 process_group=None):
        super().__init__()
        self.cr, self.head_dim = cr, head_dim
        self.pallas_attention, self.pallas_cubic = pallas_attention, pallas_cubic
        self.base_channels, self.sphereformer = tuple(base_channels), sphereformer
        self.window_size, self.window_size_sphere = tuple(window_size), tuple(window_size_sphere)
        self.quant_size, self.quant_size_sphere = tuple(quant_size), tuple(quant_size_sphere)
        self.window_size_scale = tuple(window_size_scale)
        self.return_point_feats = return_point_feats
        cs = [int(cr * x) for x in base_channels]
        gen = generator
        kw = dict(generator=gen, process_group=process_group)  # the blocks with a BN

        self.stem0 = blocks.SparseConvBlock(in_channel, cs[0], ks=3, **kw)
        self.stem1 = blocks.SparseConvBlock(cs[0], cs[0], ks=3, **kw)
        dpr = [float(x) for x in np.linspace(0, drop_path_rate, 7)]
        ws, qs = list(window_size), list(quant_size)
        wss, qss = list(window_size_sphere), list(quant_size_sphere)
        wsc, wss_scale = window_size_scale
        for idx in range(4):
            setattr(self, f"down{idx}_conv",
                    blocks.SparseConvBlock(cs[idx], cs[idx], stride=2, **kw))
            setattr(self, f"down{idx}_res0",
                    blocks.SparseResBlock(cs[idx], cs[idx + 1], **kw))
            setattr(self, f"down{idx}_res1",
                    blocks.SparseResBlock(cs[idx + 1], cs[idx + 1], **kw))
            if sphereformer:
                setattr(self, f"sphereformer{idx + 1}", SphereFormerBlock(
                    dim=cs[idx + 1], num_heads=cs[idx + 1] // head_dim,
                    window_size=tuple(ws), window_size_sphere=tuple(wss),
                    quant_size=tuple(qs), quant_size_sphere=tuple(qss),
                    drop_path=dpr[idx + 1], a=sphere_a, pallas_attention=pallas_attention,
                    pallas_cubic=pallas_cubic, generator=gen))
            ws = [w * wsc for w in ws]
            qs = [q * wsc for q in qs]
            wss = [wss[0] * wss_scale, wss[1] * wss_scale, wss[2]]
            qss = [qss[0] * wss_scale, qss[1] * wss_scale, qss[2]]

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

    def set_plain(self, plain: bool) -> None:
        """Run the kernels' plain versions (True) or the kernels (False) on
        any device: the reference mode a card run is checked against."""
        for m in self.modules():
            if isinstance(m, (blocks.SparseConv, SphereAttention)):
                m.plain = plain

    def forward(self, pfeats: torch.Tensor, plumbing: UNetPlumbing,
                generator: Optional[torch.Generator] = None, remat: bool = False):
        """pfeats [B, P, Cin] -> {"x_vox": [B, P, num_classes]} (and
        "pts_feats", the stage-4 features at the points, when
        ``return_point_feats``). In training, ``generator`` (on the model's
        device) draws the dropout and drop-path masks. ``remat`` runs the
        stem, each encoder and decoder stage and each point MLP as a
        checkpointed segment (``blocks.Remat``) when gradients are on."""
        run = blocks.Remat(remat, generator)
        lv = plumbing.levels
        pmask = plumbing.pmask
        caps = [l.grid.capacity for l in lv]

        x0 = point_to_voxel(pfeats, plumbing.p2v0_feats_seg, caps[0])
        x0 = run(stem, self, x0, lv[0])
        z0 = voxel_to_point(x0, plumbing.devox_idx[0], plumbing.devox_w[0])

        vox_feats = [point_to_voxel(z0, plumbing.p2v[0], caps[0])]
        for idx in range(4):
            vox_feats.append(run(encoder_stage, self, idx, vox_feats[idx], plumbing, generator,
                                 self.sphereformer))
        x1, x2, x3, x4 = vox_feats[1:]

        x4_pts = voxel_to_point(x4, plumbing.devox_idx[4], plumbing.devox_w[4])
        z1 = x4_pts + run(self.point_transform0, z0, pmask)
        y1 = run(decoder_stage, self, 0, z1, x3, plumbing, generator)
        y2 = run(decoder_stage, self, 1, y1, x2, plumbing, generator)
        z2 = voxel_to_point(y2, plumbing.devox_idx[2], plumbing.devox_w[2])
        z2 = z2 + run(self.point_transform1, z1, pmask)
        y3 = run(decoder_stage, self, 2, z2, x1, plumbing, generator)
        y4 = run(decoder_stage, self, 3, y3, x0, plumbing, generator)
        z3 = voxel_to_point(y4, plumbing.devox_idx[0], plumbing.devox_w[0])
        z3 = z3 + run(self.point_transform2, z2, pmask)

        out = {"x_vox": self.classifier_vox(z3)}
        if self.return_point_feats:
            # the stage-4 encoder output at the points: the tensor the decoder
            # takes as z1's base, exported for knowledge distillation
            out["pts_feats"] = x4_pts
        return out


def stem(model: nn.Module, x: torch.Tensor, level) -> torch.Tensor:
    """The two ks=3 conv blocks at level 0 (``stem0``, ``stem1``)."""
    return model.stem1(model.stem0(x, level), level)


def encoder_stage(model: nn.Module, idx: int, feats: torch.Tensor, plumbing: UNetPlumbing,
                  generator: Optional[torch.Generator], attention: bool) -> torch.Tensor:
    """Encoder stage ``idx`` of ``model`` (an SPVCNN or the student's LiDAR
    branch, by their shared names): the ks2/s2 down conv from level idx to
    idx + 1, two residual blocks and, with ``attention``, the SphereFormer
    block (its drop path drawn from ``generator``)."""
    lv = plumbing.levels
    f = getattr(model, f"down{idx}_conv")(feats, lv[idx], down_nbr8=lv[idx + 1].down_nbr8,
                                         out_mask=lv[idx + 1].grid.mask)
    f = getattr(model, f"down{idx}_res0")(f, lv[idx + 1])
    f = getattr(model, f"down{idx}_res1")(f, lv[idx + 1])
    if attention:
        f = getattr(model, f"sphereformer{idx + 1}")(
            f, P.level_xyz(plumbing, idx + 1), lv[idx + 1].grid.mask,
            P.level_geom(plumbing, idx + 1), generator)
    return f


def decoder_stage(model: nn.Module, i: int, y: torch.Tensor, skip: torch.Tensor,
                  plumbing: UNetPlumbing, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Decoder stage ``i`` of ``model``, from level 4 - i to 3 - i: stages
    0 and 2 take the point stream ``y``, pool it to the voxels of level
    4 - i and drop (``generator``); then the transposed conv, the
    concatenation of ``skip`` and two residual blocks."""
    lv = plumbing.levels
    if i % 2 == 0:
        y = model.dropout(point_to_voxel(y, plumbing.p2v[4 - i], lv[4 - i].grid.capacity),
                          generator)
    out = lv[3 - i]
    y = getattr(model, f"up{i}_deconv")(y, out.up_parent, out.up_koff, out.grid.mask)
    y = torch.cat([y, skip], dim=-1)
    return getattr(model, f"up{i}_res1")(getattr(model, f"up{i}_res0")(y, out), out)


def teacher_model(num_classes: int = 17, cr: float = 1.0, voxel_size: float = 0.1,
                  head_dim: int = 16, seed: int = 0,
                  device: Optional[Union[str, torch.device]] = None,
                  return_point_feats: bool = False, dropout_rate: float = 0.3,
                  drop_path_rate: float = 0.3, pallas_attention: bool = True,
                  pallas_cubic: bool = True, process_group=None) -> SPVCNN:
    """The flagship teacher (``__graft_entry__._teacher_model``): windows of
    6 voxels quantized in 24 steps, sphere windows [2 deg, 2 deg, 120 m],
    both doubling per level; dropout 0.3 and drop path up to 0.3 in
    training (the tests set them to 0). Its attention runs kernel K3 unless
    ``pallas_attention`` is off, as ``configs/nuscenes/train/spformer.yaml``
    sets it (the flax module's default is off: the banded attention).
    Random weights from ``seed``, in eval mode, on ``device`` (CUDA unless
    asked otherwise); BN synced over ``process_group`` where one is given."""
    dev = resolve_device(device)
    ws = voxel_size * 6
    gen = torch.Generator().manual_seed(seed)
    model = SPVCNN(
        num_classes=num_classes, cr=cr, window_size=(ws, ws, ws),
        quant_size=(ws / 24, ws / 24, ws / 24), window_size_sphere=(2.0, 2.0, 120.0),
        quant_size_sphere=(2.0 / 24, 2.0 / 24, 5.0), window_size_scale=(2.0, 2.0),
        dropout_rate=dropout_rate, drop_path_rate=drop_path_rate, sphere_a=0.0125,
        head_dim=head_dim, return_point_feats=return_point_feats,
        pallas_attention=pallas_attention, pallas_cubic=pallas_cubic, generator=gen,
        process_group=process_group)
    return model.to(dev).eval()
