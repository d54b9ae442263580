"""Building blocks of the sparse U-Net models.

Port of ``u2mkd_tpu/models/blocks.py``. Feature tensors are ``[B, V, C]``
with a validity mask ``[B, V]``. Submodules are named after the flax tree
they mirror (``SparseConv_i`` -> ``conv{i}``, ``MaskedBatchNorm_i`` ->
``bn{i}``, ``Dense_i`` -> ``fc{i}``), so ``models/convert_weights.py`` is a
plain rename.

Every ks=3 stride-1 conv runs through kernels K1 and K1b
(``spconv_kernel.RulebookConv``: forward, input gradient, weight gradient) at
every width, on the plan of the level's rulebook (built at the level's first
conv on the card and kept on its :class:`LevelContext`); ``plain = True`` on
a :class:`SparseConv` runs its plain forward instead, differentiated by
autograd, on any device (the reference a card run is held against).

The random draws of training (:class:`DropPath`, :class:`Dropout`) take an
explicit ``torch.Generator`` on the features' device, handed in by the
caller (the train step); they never draw from the global generator.

:class:`Remat` runs a model's segments under ``torch.utils.checkpoint``
(the JAX steps' ``remat``): the backward recomputes each segment's forward
instead of keeping its activations, and the recompute draws the masks the
forward drew and leaves the BN running statistics as the forward left
them (:func:`recomputing`).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable, List, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from u2mkd_tpu_torch.core.structures import LevelContext
from u2mkd_tpu_torch.ops import spconv
from u2mkd_tpu_torch.ops.kernels import spconv_kernel
from u2mkd_tpu_torch.ops.precision import cast_compute
from u2mkd_tpu_torch.parallel import mesh


def _uniform_(t: torch.Tensor, bound: float, generator) -> torch.Tensor:
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def trunc_normal_(t: torch.Tensor, std: float, a: float, b: float, generator) -> torch.Tensor:
    """``t`` filled from N(0, std) truncated to [a, b] by the inverse CDF of
    one ``uniform_`` draw: a function of ``generator``'s seed alone. torch's
    ``nn.init.trunc_normal_`` draws so up to 2.12 and by rejection since
    2.13, so the same seed gave two inits on two machines."""
    def cdf(x: float) -> float:
        return (1.0 + math.erf(x / std / math.sqrt(2.0))) / 2.0

    with torch.no_grad():
        t.uniform_(2 * cdf(a) - 1, 2 * cdf(b) - 1, generator=generator)
        t.erfinv_().mul_(std * math.sqrt(2.0))
        return t.clamp_(min=a, max=b)


class _Segment:
    """One run of a :class:`Remat` segment: its first run records what
    :func:`reused` computes, the recompute replays it in call order."""

    def __init__(self, memo: List, replay: bool):
        self.memo, self.replay, self.next = memo, replay, 0


_SEGMENT: contextvars.ContextVar = contextvars.ContextVar("remat_segment", default=None)


def recomputing() -> bool:
    """True inside the backward's recompute of a :class:`Remat` segment.
    The BN layers then leave their running statistics as the forward left
    them: updated once a step, as flax's mutable ``batch_stats`` are."""
    seg = _SEGMENT.get()
    return seg is not None and seg.replay


def reused(fn: Callable, *args):
    """``fn(*args)``. Inside a :class:`Remat` segment it is computed in the
    segment's first run and handed back as it was in the recompute (a
    window sort, which the recompute must see unchanged and not redo)."""
    seg = _SEGMENT.get()
    if seg is None:
        return fn(*args)
    if seg.replay:
        seg.next += 1
        return seg.memo[seg.next - 1]
    out = fn(*args)
    seg.memo.append(out)
    return out


@contextlib.contextmanager
def _rewound(generator: Optional[torch.Generator], state: Optional[torch.Tensor]):
    """``generator`` at ``state`` inside; after, at the state it had on
    entry."""
    if generator is None:
        yield
        return
    after = generator.get_state()
    generator.set_state(state)
    try:
        yield
    finally:
        generator.set_state(after)


@contextlib.contextmanager
def _in_segment(seg: _Segment):
    token = _SEGMENT.set(seg)
    try:
        yield
    finally:
        _SEGMENT.reset(token)


class Remat:
    """The segments of one forward. ``run = Remat(enabled, generator)``;
    ``run(fn, *args)`` is ``fn(*args)``, and with ``enabled`` and
    gradients on, a segment under ``torch.utils.checkpoint`` (non-reentrant):
    the backward runs ``fn`` again to recompute the activations it saved,
    and keeps only the segment's inputs from the forward. In the recompute
    ``generator`` (the one the segment's dropout and drop path draw from)
    is set back to its state at the segment's start and afterwards put back
    where it was, so that the recompute draws the forward's masks and later
    draws are those of a step without remat; :func:`recomputing` is true,
    so that the BN layers do not update their running statistics again;
    and :func:`reused` hands back what the first run computed."""

    def __init__(self, enabled: bool = False, generator: Optional[torch.Generator] = None):
        self.enabled, self.generator = enabled, generator

    def __call__(self, fn: Callable, *args):
        if not (self.enabled and torch.is_grad_enabled()):
            return fn(*args)
        gen = self.generator
        start = None if gen is None else gen.get_state()
        memo: List = []
        runs: List[bool] = []

        def segment(*a):
            if not runs:
                runs.append(True)
                with _in_segment(_Segment(memo, False)):
                    return fn(*a)
            with _rewound(gen, start), _in_segment(_Segment(memo, True)):
                return fn(*a)

        # the segment draws only from ``generator``: torch's global ones
        # need no stash
        return torch.utils.checkpoint.checkpoint(segment, *args, use_reentrant=False,
                                                 preserve_rng_state=False)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid rows of [B, V, C]: momentum 0.1, eps 1e-5,
    biased batch variance to normalize, unbiased for the running estimate.
    Masked rows come out zero. With a ``process_group`` the count and both
    moments are summed over its ranks before the count is clamped (JAX's
    ``axis_name``): the statistics of the global batch, whose gradient
    reaches every rank (``parallel/mesh.all_reduce_sum``). In a
    :class:`Remat` segment's recompute the sums run again (on every rank,
    in the forward's order) and the running statistics stay as they are."""

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5,
                 process_group=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.process_group = process_group
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            m = mask[..., None].to(x.dtype)
            cnt, s1, s2 = m.sum(), (x * m).sum((0, 1)), (x * x * m).sum((0, 1))
            if self.process_group is not None:
                cnt, s1, s2 = mesh.all_reduce_sum((cnt, s1, s2), self.process_group)
            cnt = cnt.clamp(min=1.0)
            mean = s1 / cnt
            var = (s2 / cnt - mean * mean).clamp(min=0.0)
            if not recomputing():
                with torch.no_grad():
                    unbiased = var * cnt / (cnt - 1.0).clamp(min=1.0)
                    self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                    self.running_var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return torch.where(mask[..., None], y, 0.0)


class SparseConv(nn.Module):
    """Stride-1 sparse conv, ks in {1, 3}; kernel [K, Cin, Cout] initialized
    uniform(+-1/sqrt(K*Cin)) as torchsparse does."""

    def __init__(self, in_ch: int, out_ch: int, ks: int = 3, generator=None):
        super().__init__()
        k = spconv.kernel_offsets(ks).shape[0]
        self.ks = ks
        self.plain = False
        self.kernel = nn.Parameter(torch.empty(k, in_ch, out_ch))
        _uniform_(self.kernel, (k * in_ch) ** -0.5, generator)

    def forward(self, feats: torch.Tensor, level: Optional[LevelContext]) -> torch.Tensor:
        w = self.kernel
        if self.ks == 1:
            return torch.einsum("bvc,cd->bvd", feats, w[0])
        f, wc = cast_compute(feats, w)
        if self.plain:
            out = spconv_kernel.rulebook_conv_plain(f, wc, level.nbr27)
        else:
            plan = spconv_kernel.level_plan(level) if f.is_cuda else None
            out = spconv_kernel.RulebookConv.apply(f, wc, level.nbr27, plan)
        return out.to(feats.dtype)


class SparseDownConv(nn.Module):
    """ks=2 / stride=2 downsample conv: finer level -> this level."""

    def __init__(self, in_ch: int, out_ch: int, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(8, in_ch, out_ch))
        _uniform_(self.kernel, (8 * in_ch) ** -0.5, generator)

    def forward(self, feats: torch.Tensor, down_nbr8: torch.Tensor) -> torch.Tensor:
        return torch.stack([spconv.down_conv(f, n, self.kernel)
                            for f, n in zip(feats, down_nbr8)])


class SparseDeconv(nn.Module):
    """ks=2 / stride=2 transposed conv onto the cached finer coords; the init
    bound uses the out channels, as torchsparse's transposed conv does."""

    def __init__(self, in_ch: int, out_ch: int, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(8, in_ch, out_ch))
        _uniform_(self.kernel, (8 * out_ch) ** -0.5, generator)

    def forward(self, feats, up_parent, up_koff) -> torch.Tensor:
        return torch.stack([
            spconv.sparse_conv_transposed_2x2(f, p, k, self.kernel)
            for f, p, k in zip(feats, up_parent, up_koff)])


class SparseConvBlock(nn.Module):
    """conv-BN-ReLU; stride 2 uses the down rulebook of the next level."""

    def __init__(self, in_ch: int, out_ch: int, ks: int = 3, stride: int = 1,
                 generator=None, process_group=None):
        super().__init__()
        self.stride = stride
        if stride == 1:
            self.conv0 = SparseConv(in_ch, out_ch, ks, generator)
        else:
            self.conv0 = SparseDownConv(in_ch, out_ch, generator)
        self.bn0 = MaskedBatchNorm(out_ch, process_group=process_group)

    def forward(self, feats, level: LevelContext, down_nbr8=None, out_mask=None):
        if self.stride == 1:
            x, mask = self.conv0(feats, level), level.grid.mask
        else:
            x, mask = self.conv0(feats, down_nbr8), out_mask
        return torch.relu(self.bn0(x, mask))


class SparseDeconvBlock(nn.Module):
    """deconv-BN-ReLU."""

    def __init__(self, in_ch: int, out_ch: int, generator=None, process_group=None):
        super().__init__()
        self.conv0 = SparseDeconv(in_ch, out_ch, generator)
        self.bn0 = MaskedBatchNorm(out_ch, process_group=process_group)

    def forward(self, feats, up_parent, up_koff, out_mask):
        return torch.relu(self.bn0(self.conv0(feats, up_parent, up_koff), out_mask))


class SparseResBlock(nn.Module):
    """conv-BN-ReLU-conv-BN plus a shortcut, then ReLU. The shortcut is the
    identity when the widths agree, else a 1x1 conv-BN (``conv2``/``bn2``,
    the third conv and norm in flax's numbering)."""

    def __init__(self, in_ch: int, out_ch: int, ks: int = 3, generator=None,
                 process_group=None):
        super().__init__()
        self.conv0 = SparseConv(in_ch, out_ch, ks, generator)
        self.bn0 = MaskedBatchNorm(out_ch, process_group=process_group)
        self.conv1 = SparseConv(out_ch, out_ch, ks, generator)
        self.bn1 = MaskedBatchNorm(out_ch, process_group=process_group)
        if in_ch != out_ch:
            self.conv2 = SparseConv(in_ch, out_ch, 1, generator)
            self.bn2 = MaskedBatchNorm(out_ch, process_group=process_group)

    def forward(self, feats, level: LevelContext):
        mask = level.grid.mask
        x = torch.relu(self.bn0(self.conv0(feats, level), mask))
        x = self.bn1(self.conv1(x, level), mask)
        short = self.bn2(self.conv2(feats, None), mask) if hasattr(self, "conv2") else feats
        return torch.relu(x + short)


def dense(in_ch: int, out_ch: int, generator=None, bias: bool = True) -> nn.Linear:
    """A linear layer initialized as flax ``nn.Dense``: lecun-normal weight
    (truncated normal, std 1/sqrt(in) over its truncation), zero bias."""
    lin = nn.Linear(in_ch, out_ch, bias=bias)
    with torch.no_grad():
        std = (1.0 / in_ch) ** 0.5 / 0.87962566103423978
        trunc_normal_(lin.weight, std, -2 * std, 2 * std, generator)
        if bias:
            lin.bias.zero_()
    return lin


class PointMLP(nn.Module):
    """Linear-BN-ReLU on per-point features."""

    def __init__(self, in_ch: int, out_ch: int, generator=None, process_group=None):
        super().__init__()
        self.fc0 = dense(in_ch, out_ch, generator)
        self.bn0 = MaskedBatchNorm(out_ch, process_group=process_group)

    def forward(self, feats, mask):
        return torch.relu(self.bn0(self.fc0(feats), mask))


def _keep_mask(shape, rate: float, x: torch.Tensor, generator) -> torch.Tensor:
    if generator is None:
        raise ValueError("a training draw needs an explicit torch.Generator "
                         "on the features' device")
    return torch.rand(shape, generator=generator, device=x.device) < 1.0 - rate


class DropPath(nn.Module):
    """Per-sample stochastic depth (timm ``DropPath``); identity in eval."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = _keep_mask((x.shape[0],) + (1,) * (x.ndim - 1), self.rate, x, generator)
        return torch.where(keep, x / (1.0 - self.rate), 0.0)


class Dropout(nn.Module):
    """Elementwise dropout (flax ``nn.Dropout``): keep with probability
    1 - rate and scale by 1 / (1 - rate); identity in eval."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = _keep_mask(x.shape, self.rate, x, generator)
        return torch.where(keep, x / (1.0 - self.rate), 0.0)
