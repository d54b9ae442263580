"""The official SphereFormer U-Net (the alternative teacher architecture).

Port of ``u2mkd_tpu/models/sphereformer_unet.py``: a recursive ``UBlock``
U-Net of pre-activation residual blocks (or VGG blocks), a SphereFormer
block at every level named in ``sphere_layers``, ks2/s2 down and up convs,
skip concatenation, and the ``Semantic`` wrapper (stem conv, the
devoxelize and re-pool round trip, the U-Net, norm-relu and a linear head
read through each point's own level-0 voxel row). The attribute names
mirror the flax module names, so ``models/convert_weights.from_flax``
carries a flax tree across.

The attention reuses :class:`~u2mkd_tpu_torch.models.sphereformer.
SphereFormerBlock` over host window geometry of levels 0..4
(``data/wgeom_host.params_from_model`` gives this model's spec), built on
the recursive mean-of-means voxel xyz (``data/plumbing_host.
recursive_vox_xyz``), or, on plumbing built on the device, over windows
sorted in the step on the same recursive means (``models/plumbing.
recursive_vox_xyz``); either way it runs kernel K3 (and K4 and K5 in
training) and is exact at any window occupancy. The JAX module runs the banded XLA
attention, which drops the pairs of a window that lie more than band x
tile rows apart (1 x 128 cubic, 4 x 128 radial): the two agree wherever
every window fits its band. Every 3x3x3 conv runs kernel K1 (K1b in
training); the 1x1 ``i_branch`` is a dense product, as in JAX. Every level
takes the same drop-path rate, ``drop_path_rate`` itself, as the JAX
module does.

No builder name or config reaches this model in either package; it is
driven through the generic steps (``train/state.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from u2mkd_tpu_torch.models import blocks
from u2mkd_tpu_torch.models import plumbing as P
from u2mkd_tpu_torch.models.plumbing import UNetPlumbing, point_to_voxel, voxel_to_point
from u2mkd_tpu_torch.models.sphereformer import SphereAttention, SphereFormerBlock


class PreActResBlock(nn.Module):
    """norm-relu-conv3-norm-relu-conv3 plus the input, through a 1x1 conv
    (``i_branch``) where the widths differ."""

    def __init__(self, in_ch: int, out_ch: int, generator=None, process_group=None):
        super().__init__()
        self.bn1 = blocks.MaskedBatchNorm(in_ch, process_group=process_group)
        self.conv1 = blocks.SparseConv(in_ch, out_ch, 3, generator)
        self.bn2 = blocks.MaskedBatchNorm(out_ch, process_group=process_group)
        self.conv2 = blocks.SparseConv(out_ch, out_ch, 3, generator)
        if in_ch != out_ch:
            self.i_branch = blocks.SparseConv(in_ch, out_ch, 1, generator)

    def forward(self, feats: torch.Tensor, level) -> torch.Tensor:
        mask = level.grid.mask
        x = self.conv1(torch.relu(self.bn1(feats, mask)), level)
        x = self.conv2(torch.relu(self.bn2(x, mask)), level)
        ident = self.i_branch(feats, None) if hasattr(self, "i_branch") else feats
        return x + ident


class VGGBlock(nn.Module):
    """norm-relu-conv3, no residual (the reference's ``VGGBlock``)."""

    def __init__(self, in_ch: int, out_ch: int, generator=None, process_group=None):
        super().__init__()
        self.bn1 = blocks.MaskedBatchNorm(in_ch, process_group=process_group)
        self.conv1 = blocks.SparseConv(in_ch, out_ch, 3, generator)

    def forward(self, feats: torch.Tensor, level) -> torch.Tensor:
        return self.conv1(torch.relu(self.bn1(feats, level.grid.mask)), level)


_BLOCK_TYPES = {"residual": PreActResBlock, "vgg": VGGBlock}


class UBlock(nn.Module):
    """One U-Net level, holding the deeper levels as ``u``."""

    def __init__(self, n_planes: Sequence[int], level_idx: int,
                 window_size: Tuple[float, float, float],
                 window_size_sphere: Tuple[float, float, float],
                 quant_size: Tuple[float, float, float],
                 quant_size_sphere: Tuple[float, float, float],
                 window_size_scale: Tuple[float, float] = (2.0, 2.0),
                 block_reps: int = 2, head_dim: int = 16, drop_path: float = 0.0,
                 sphere_layers: Sequence[int] = (1, 2, 3, 4, 5), a: float = 0.0125,
                 block_type: str = "residual", generator=None, process_group=None):
        super().__init__()
        gen = generator
        self.level_idx = level_idx
        self.block_reps = block_reps
        block_cls = _BLOCK_TYPES[block_type]
        c0 = n_planes[0]
        for i in range(block_reps):
            setattr(self, f"block{i}", block_cls(c0, c0, gen, process_group))
        self.has_attention = level_idx + 1 in tuple(sphere_layers)
        if self.has_attention:
            self.transformer_block = SphereFormerBlock(
                dim=c0, num_heads=c0 // head_dim, window_size=tuple(window_size),
                window_size_sphere=tuple(window_size_sphere), quant_size=tuple(quant_size),
                quant_size_sphere=tuple(quant_size_sphere), drop_path=drop_path, a=a,
                pallas_attention=True, generator=gen)
        self.has_child = len(n_planes) > 1
        if self.has_child:
            c1 = n_planes[1]
            wsc, wss = window_size_scale
            self.down_bn = blocks.MaskedBatchNorm(c0, process_group=process_group)
            self.down_conv = blocks.SparseDownConv(c0, c1, gen)
            self.u = UBlock(
                n_planes=tuple(n_planes[1:]), level_idx=level_idx + 1,
                window_size=tuple(w * wsc for w in window_size),
                quant_size=tuple(q * wsc for q in quant_size),
                window_size_sphere=(window_size_sphere[0] * wss,
                                    window_size_sphere[1] * wss, window_size_sphere[2]),
                quant_size_sphere=(quant_size_sphere[0] * wss,
                                   quant_size_sphere[1] * wss, quant_size_sphere[2]),
                window_size_scale=window_size_scale, block_reps=block_reps,
                head_dim=head_dim, drop_path=drop_path, sphere_layers=sphere_layers,
                a=a, block_type=block_type, generator=gen, process_group=process_group)
            self.up_bn = blocks.MaskedBatchNorm(c1, process_group=process_group)
            self.up_conv = blocks.SparseDeconv(c1, c0, gen)
            for i in range(block_reps):
                setattr(self, f"tail{i}", block_cls(2 * c0 if i == 0 else c0, c0, gen,
                                                    process_group))

    def forward(self, feats: torch.Tensor, plumbing: UNetPlumbing,
                generator: Optional[torch.Generator] = None,
                xyz: Optional[Sequence[torch.Tensor]] = None,
                run: Optional[blocks.Remat] = None) -> torch.Tensor:
        """``xyz``: the recursive voxel means of every level, where the
        plumbing carries no window geometry. ``run`` (a
        :class:`blocks.Remat`) runs this level's work before the child and
        its work after it as two segments; the recursion into the child
        stays outside both, so no segment holds a deeper level."""
        run = run if run is not None else blocks.Remat()
        if not self.has_child:
            return run(self.before_child, feats, plumbing, generator, xyz)
        feats, d = run(self.before_child, feats, plumbing, generator, xyz)
        child = self.u(d, plumbing, generator, xyz, run)
        return run(self.after_child, feats, child, plumbing)

    def before_child(self, feats: torch.Tensor, plumbing: UNetPlumbing,
                     generator: Optional[torch.Generator],
                     xyz: Optional[Sequence[torch.Tensor]]):
        """The blocks, the attention and, above the deepest level, the down
        BN and conv -> feats (and the child's input)."""
        lv = plumbing.levels[self.level_idx]
        for i in range(self.block_reps):
            feats = getattr(self, f"block{i}")(feats, lv)
        if self.has_attention:
            feats = self.transformer_block(
                feats, None if xyz is None else xyz[self.level_idx], lv.grid.mask,
                P.level_geom(plumbing, self.level_idx), generator)
        if not self.has_child:
            return feats
        nxt = plumbing.levels[self.level_idx + 1]
        d = torch.relu(self.down_bn(feats, lv.grid.mask))
        return feats, self.down_conv(d, nxt.down_nbr8)

    def after_child(self, feats: torch.Tensor, child: torch.Tensor,
                    plumbing: UNetPlumbing) -> torch.Tensor:
        """The up BN and conv of the child's output, the skip concat and the
        tail blocks."""
        lv = plumbing.levels[self.level_idx]
        nxt = plumbing.levels[self.level_idx + 1]
        up = torch.relu(self.up_bn(child, nxt.grid.mask))
        up = self.up_conv(up, lv.up_parent, lv.up_koff)
        feats = torch.cat([feats, up], dim=-1)
        for i in range(self.block_reps):
            feats = getattr(self, f"tail{i}")(feats, lv)
        return feats


class SphereFormerSemantic(nn.Module):
    """The ``Semantic`` wrapper: pfeats [B, P, in_channel] -> {"x_vox":
    [B, P, num_classes]}."""

    # the levels whose point maps the forward reads (the stem's voxelize,
    # its round trip and the head)
    point_levels = (0,)
    # every attention branch runs kernel K3 (the model stays exact)
    pallas_attention = pallas_cubic = True

    def __init__(self, num_classes: int = 17, in_channel: int = 4,
                 n_planes: Tuple[int, ...] = (32, 64, 128, 256, 256),
                 window_size=(0.3, 0.3, 0.3), window_size_sphere=(2.0, 2.0, 120.0),
                 quant_size=(0.3 / 24,) * 3, quant_size_sphere=(2.0 / 24, 2.0 / 24, 5.0),
                 window_size_scale=(2.0, 2.0), head_dim: int = 16,
                 drop_path_rate: float = 0.3, sphere_layers: Sequence[int] = (1, 2, 3, 4, 5),
                 a: float = 0.0125, block_type: str = "residual", block_reps: int = 2,
                 generator=None, process_group=None):
        super().__init__()
        self.n_planes, self.head_dim = tuple(n_planes), head_dim
        self.window_size, self.window_size_sphere = tuple(window_size), tuple(window_size_sphere)
        self.quant_size, self.quant_size_sphere = tuple(quant_size), tuple(quant_size_sphere)
        self.window_size_scale = tuple(window_size_scale)
        gen = generator
        self.input_conv = blocks.SparseConv(in_channel, n_planes[0], 3, gen)
        self.unet = UBlock(
            n_planes=self.n_planes, level_idx=0, window_size=self.window_size,
            window_size_sphere=self.window_size_sphere, quant_size=self.quant_size,
            quant_size_sphere=self.quant_size_sphere, window_size_scale=self.window_size_scale,
            block_reps=block_reps, head_dim=head_dim, drop_path=drop_path_rate,
            sphere_layers=sphere_layers, a=a, block_type=block_type, generator=gen,
            process_group=process_group)
        self.output_bn = blocks.MaskedBatchNorm(n_planes[0], process_group=process_group)
        self.classifier = blocks.dense(n_planes[0], num_classes, gen)

    def set_plain(self, plain: bool) -> None:
        """Run the kernels' plain versions (True) or the kernels (False) on
        any device: the reference mode a card run is checked against."""
        for m in self.modules():
            if isinstance(m, (blocks.SparseConv, SphereAttention)):
                m.plain = plain

    def forward(self, pfeats: torch.Tensor, plumbing: UNetPlumbing,
                generator: Optional[torch.Generator] = None, remat: bool = False):
        """In training, ``generator`` (on the model's device) draws the
        drop-path masks. ``remat`` runs, when gradients are on, the stem
        with its round trip, each level's work before its child and after
        it, and the output BN with the head as checkpointed segments
        (``blocks.Remat``), as JAX's ``make_train_step(remat=True)``
        recomputes the forward in the backward."""
        run = blocks.Remat(remat, generator)
        xyz = None
        if plumbing.wgeom is None:
            xyz = P.recursive_vox_xyz(plumbing.vox_xyz[0], plumbing.levels)
        x = run(self.stem, pfeats, plumbing)
        x = self.unet(x, plumbing, generator, xyz, run)
        return {"x_vox": run(self.head, x, plumbing)}

    def stem(self, pfeats: torch.Tensor, plumbing: UNetPlumbing) -> torch.Tensor:
        """The first voxelize, the stem conv and the reference's round trip
        after it: devoxelize to the points, then pool again per voxel."""
        lv0 = plumbing.levels[0]
        cap0 = lv0.grid.capacity
        x = point_to_voxel(pfeats, plumbing.p2v0_feats_seg, cap0)
        x = self.input_conv(x, lv0)
        z0 = voxel_to_point(x, plumbing.devox_idx[0], plumbing.devox_w[0])
        return point_to_voxel(z0, plumbing.p2v0_feats_seg, cap0)

    def head(self, x: torch.Tensor, plumbing: UNetPlumbing) -> torch.Tensor:
        """norm-relu, then each point reads its own level-0 voxel row (zero
        for a dead point) through the linear classifier."""
        x = torch.relu(self.output_bn(x, plumbing.levels[0].grid.mask))
        return self.classifier(P.batch_rows(x, plumbing.p2v[0]))
