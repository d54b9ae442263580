"""SwiftNet-ResNet-18 image branch.

Port of ``u2mkd_tpu/models/swiftnet.py``: a ResNet-18 backbone with a
stride-1 7x7 stem conv and a 3x3 stride-2 max-pool, BasicBlocks that return
their post-ReLU sum as the skip (the reference's executed behaviour), a
3-level spatial pyramid pooling bottleneck, and a light decoder (skip
bottleneck + bilinear align-corners upsample + blend conv). The staged API
(``forward_stem`` / ``forward_resblock`` / ``forward_spp`` / ``forward_up``)
lets the fusion student interleave its LiDAR stages.

The JAX package keeps images NHWC; the port keeps them NCHW, PyTorch's
layout, and the fusion layers permute at the point boundaries. The
convolutions are ``torch.nn.functional.conv2d`` (cuDNN on the card), as they
were XLA convolutions outside any Pallas kernel; those the JAX package builds
through ``swiftnet.conv`` run in the compute dtype (``ops/precision.py``).
Attribute names mirror the flax module names, so
``models/convert_weights.py`` is a rename.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from u2mkd_tpu_torch.models import blocks
from u2mkd_tpu_torch.models.blocks import trunc_normal_
from u2mkd_tpu_torch.ops.precision import cast_compute
from u2mkd_tpu_torch.parallel import mesh


def repeatable_convolutions() -> None:
    """cuDNN takes only its deterministic convolution algorithms, chosen
    without the autotuner, so that an image convolution's gradients repeat
    bitwise on the card; every model with an image branch sets it when it
    is built."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _interp_matrix(n_out: int, n_in: int, device, dtype) -> torch.Tensor:
    """[n_out, n_in] weights of a 1-D align-corners linear resize, torch's
    source index and lambdas (in f64 for f64 maps, else f32)."""
    scale = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
    src = torch.arange(n_out, device=device, dtype=dtype) * scale
    i0 = torch.floor(src).long().clamp(max=n_in - 1)
    i1 = torch.where(i0 < n_in - 1, i0 + 1, i0)
    l1 = src - i0
    m = torch.zeros(n_out, n_in, device=device, dtype=dtype)
    rows = torch.arange(n_out, device=device)
    m[rows, i0] = 1.0 - l1
    m[rows, i1] += l1
    return m


def _pool_matrix(n_out: int, n_in: int, device, dtype) -> torch.Tensor:
    """[n_out, n_in] weights of a 1-D adaptive average pool: row i averages
    inputs floor(i n_in / n_out) .. ceil((i + 1) n_in / n_out) - 1."""
    m = torch.zeros(n_out, n_in, device=device, dtype=dtype)
    for i in range(n_out):
        lo, hi = (i * n_in) // n_out, -((-(i + 1) * n_in) // n_out)
        m[i, lo:hi] = 1.0 / (hi - lo)
    return m


class _Separable(torch.autograd.Function):
    """``op(x)`` for a map x [N, C, H, W] whose op is linear and separable,
    out = A_h x A_w^T, with the backward A_h^T g A_w as two matrix
    products, where torch's card kernels for the bilinear resize and the
    adaptive pool add the gradient with atomics."""

    @staticmethod
    def forward(ctx, x, op, a_h_fn, a_w_fn):
        out = op(x)
        dt = torch.float64 if x.dtype == torch.float64 else torch.float32
        ctx.mats = (a_h_fn(out.shape[-2], x.shape[-2], x.device, dt),
                    a_w_fn(out.shape[-1], x.shape[-1], x.device, dt))
        return out

    @staticmethod
    def backward(ctx, g):
        a_h, a_w = ctx.mats
        return a_h.t().to(g.dtype) @ (g @ a_w.to(g.dtype)), None, None, None


def resize_bilinear_align_corners(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of x [N, C, H, W] to ``size`` with
    ``align_corners=True`` (sample grid linspace(0, H-1, h); an output size
    of 1 samples index 0), as the JAX package's resize. Its backward is two
    matrix products, repeatable on the card."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    size = tuple(int(d) for d in size)
    return _Separable.apply(
        x, lambda t: F.interpolate(t, size=size, mode="bilinear", align_corners=True),
        _interp_matrix, _interp_matrix)


def adaptive_avg_pool(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``F.adaptive_avg_pool2d`` whose backward is two matrix products,
    repeatable on the card."""
    size = tuple(int(d) for d in size)
    return _Separable.apply(x, lambda t: F.adaptive_avg_pool2d(t, size), _pool_matrix,
                            _pool_matrix)


def _trunc_normal_(w: torch.Tensor, std: float, generator) -> torch.Tensor:
    """Truncated normal at +-2 std, scaled so that its std is ``std`` (flax's
    ``variance_scaling(..., "truncated_normal")``)."""
    s = std / 0.87962566103423978
    return trunc_normal_(w, s, -2 * s, 2 * s, generator)


class ComputeConv2d(nn.Conv2d):
    """``nn.Conv2d`` under the compute-precision policy, as flax's
    ``nn.Conv(dtype=compute_dtype())``: the input and the (f32) weight in
    the compute dtype, the output, in that dtype, handed on as f32, where
    the JAX package's BN and sums promote it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = cast_compute(x, self.weight)
        return self._conv_forward(x, w, self.bias).float()


def conv(in_ch: int, out_ch: int, k: int, stride: int = 1, generator=None) -> nn.Conv2d:
    """k x k conv with symmetric padding k // 2 and no bias, in the compute
    dtype (:class:`ComputeConv2d`), initialized variance_scaling(2, fan_out,
    truncated normal) as the JAX package's."""
    c = ComputeConv2d(in_ch, out_ch, k, stride=stride, padding=k // 2, bias=False)
    _trunc_normal_(c.weight, (2.0 / (k * k * out_ch)) ** 0.5, generator)
    return c


def conv1x1(in_ch: int, out_ch: int, generator=None) -> nn.Conv2d:
    """1x1 conv with a bias, initialized as flax's ``nn.Conv`` default
    (lecun normal, zero bias)."""
    c = nn.Conv2d(in_ch, out_ch, 1, bias=True)
    _trunc_normal_(c.weight, (1.0 / in_ch) ** 0.5, generator)
    with torch.no_grad():
        c.bias.zero_()
    return c


class BatchNorm2d(nn.Module):
    """BatchNorm over NCHW maps with torch semantics: batch statistics in
    training (biased variance to normalize, unbiased for the running
    estimate), running statistics in eval. With a ``process_group`` the
    training statistics are those of every rank's maps (JAX's ``axis_name``,
    ``swiftnet.py:67-100``), in two passes as one process takes them: the
    count and the sum of x over the group give the mean, then the sum of
    squares about it over the group the variance (each sum
    ``parallel/mesh.all_reduce_sum``, whose backward sums the cotangents).
    In a remat segment's recompute (``blocks.recomputing``) the running
    statistics stay as the forward left them."""

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5,
                 process_group=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.process_group = process_group
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.process_group is None:
            mean, var = self.running_mean, self.running_var
            if self.training and blocks.recomputing():
                # the recompute's update lands on copies, through the kernel
                # of the forward, so that it saves the same tensors
                mean, var = mean.clone(), var.clone()
            return F.batch_norm(x, mean, var, self.weight, self.bias, self.training,
                                self.momentum, self.eps)
        xf = x.float()
        cnt = xf.new_tensor(float(x.numel() // x.shape[1]))
        cnt, s1 = mesh.all_reduce_sum((cnt, xf.sum((0, 2, 3))), self.process_group)
        mean = s1 / cnt
        (m2,) = mesh.all_reduce_sum((((xf - mean[:, None, None]) ** 2).sum((0, 2, 3)),),
                                    self.process_group)
        var = m2 / cnt
        if not blocks.recomputing():
            with torch.no_grad():
                unbiased = var * cnt / (cnt - 1.0).clamp(min=1.0)
                self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]


class BasicBlock(nn.Module):
    """ResNet BasicBlock returning (relu(out), skip) with skip the same
    post-ReLU tensor: the reference's in-place ReLU mutates the sum before
    the pair is returned, and the JAX package follows what it executes."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1, generator=None,
                 process_group=None):
        super().__init__()
        self.conv1 = conv(in_ch, planes, 3, stride, generator)
        self.bn1 = BatchNorm2d(planes, process_group=process_group)
        self.conv2 = conv(planes, planes, 3, 1, generator)
        self.bn2 = BatchNorm2d(planes, process_group=process_group)
        if stride != 1 or in_ch != planes:
            self.down_conv = conv(in_ch, planes, 1, stride, generator)
            self.down_bn = BatchNorm2d(planes, process_group=process_group)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = self.down_bn(self.down_conv(x)) if hasattr(self, "down_conv") else x
        act = torch.relu(out + residual)
        return act, act


class BNReluConv(nn.Module):
    """BN -> ReLU -> conv (reference ``_BNReluConv``)."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 3, bn_momentum: float = 0.1,
                 generator=None, process_group=None):
        super().__init__()
        self.norm = BatchNorm2d(in_ch, momentum=bn_momentum, process_group=process_group)
        self.conv = conv(in_ch, out_ch, k, 1, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.relu(self.norm(x)))


class SpatialPyramidPooling(nn.Module):
    """3-level SPP (reference ``SpatialPyramidPooling``): a bottleneck, three
    adaptive average pools to grids (g, max(1, round(aspect * g))), each
    projected and resized back, and a fuse conv over the concatenation."""

    def __init__(self, in_ch: int, bt_size: int = 128, level_size: int = 42,
                 out_size: int = 128, grids: Sequence[int] = (8, 4, 2, 1),
                 num_levels: int = 3, generator=None, process_group=None):
        super().__init__()
        self.grids, self.num_levels = tuple(grids), num_levels
        self.spp_bn = BNReluConv(in_ch, bt_size, 1, 0.012, generator, process_group)
        for i in range(num_levels):
            setattr(self, f"spp{i}", BNReluConv(bt_size, level_size, 1, 0.012, generator,
                                                process_group))
        self.spp_fuse = BNReluConv(bt_size + num_levels * level_size, out_size, 1, 0.012,
                                   generator, process_group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        ar = w / h
        x = self.spp_bn(x)
        levels = [x]
        for i in range(self.num_levels):
            g = self.grids[i]
            # Python's round, as the JAX package (and the reference) take it
            pooled = adaptive_avg_pool(x, (g, max(1, round(ar * g))))
            lvl = getattr(self, f"spp{i}")(pooled)
            levels.append(resize_bilinear_align_corners(lvl, (h, w)))
        return self.spp_fuse(torch.cat(levels, dim=1))


class Upsample(nn.Module):
    """Skip bottleneck + align-corners upsample + blend (reference
    ``_Upsample``)."""

    def __init__(self, skip_ch: int, num_maps_in: int, num_maps_out: int, generator=None,
                 process_group=None):
        super().__init__()
        self.bottleneck = BNReluConv(skip_ch, num_maps_in, 1, generator=generator,
                                     process_group=process_group)
        self.blend_conv = BNReluConv(num_maps_in, num_maps_out, 3, generator=generator,
                                     process_group=process_group)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        skip = self.bottleneck(skip)
        x = resize_bilinear_align_corners(x, skip.shape[-2:])
        return self.blend_conv(x + skip)


class SwiftNetResNet(nn.Module):
    """ResNet-18 SwiftNet with the staged API; stage channels (stem and SPP
    included) ``img_cs`` = [64, 64, 128, 256, 128]."""

    PLANES = (64, 128, 256, 512)

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2),
                 num_features: Sequence[int] = (128, 128, 128), generator=None,
                 process_group=None):
        super().__init__()
        repeatable_convolutions()
        self.layers = tuple(layers)
        nf = num_features[0]
        self.img_cs = [64, 64, 128, 256, nf]
        in_ch = 64
        for li, n in enumerate(self.layers):
            for bi in range(n):
                stride = 2 if (li > 0 and bi == 0) else 1
                setattr(self, f"layer{li + 1}_{bi}",
                        BasicBlock(in_ch, self.PLANES[li], stride, generator, process_group))
                in_ch = self.PLANES[li]
        self.conv1 = conv(3, 64, 7, 1, generator)
        self.bn1 = BatchNorm2d(64, process_group=process_group)
        self.spp = SpatialPyramidPooling(in_ch, bt_size=nf, level_size=nf // 3, out_size=nf,
                                         generator=generator, process_group=process_group)
        for i, skip_ch in enumerate((256, 128, 64)):
            setattr(self, f"up{i}", Upsample(skip_ch, nf, nf, generator, process_group))

    def forward_stem(self, image: torch.Tensor) -> torch.Tensor:
        """7x7/s1 conv + BN + ReLU + 3x3/s2 max-pool (padded with -inf);
        image [N, 3, H, W]."""
        x = torch.relu(self.bn1(self.conv1(image)))
        return F.max_pool2d(x, 3, stride=2, padding=1)

    def forward_resblock(self, x: torch.Tensor, stage_idx: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        skip = None
        for bi in range(self.layers[stage_idx]):
            x, skip = getattr(self, f"layer{stage_idx + 1}_{bi}")(x)
        return x, skip

    def forward_spp(self, skip: torch.Tensor) -> torch.Tensor:
        return self.spp(skip)

    def forward_down(self, image: torch.Tensor) -> List[torch.Tensor]:
        x = self.forward_stem(image)
        feats = []
        for i in range(4):
            x, skip = self.forward_resblock(x, i)
            feats.append(skip if i < 3 else self.forward_spp(skip))
        return feats

    def forward_up(self, features: Sequence[torch.Tensor],
                   im_size: Optional[Tuple[int, int]] = None,
                   run: Optional[blocks.Remat] = None) -> torch.Tensor:
        """The decoder; ``run`` (a :class:`blocks.Remat`) runs each
        upsample block as a segment."""
        run = run or blocks.Remat()
        features = list(features)[::-1]
        x = features[0]
        for i, skip in enumerate(features[1:]):
            x = run(getattr(self, f"up{i}"), x, skip)
        if im_size is not None:
            x = resize_bilinear_align_corners(x, im_size)
        return x

    def forward(self, image: torch.Tensor,
                im_size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        return self.forward_up(self.forward_down(image), im_size)
