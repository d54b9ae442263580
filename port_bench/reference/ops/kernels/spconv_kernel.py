"""The reference's sparse conv (ks=3, stride 1): plain PyTorch in place of
the program's kernels K1 and K1b.

``out[b, v] = sum_k x[b, nbr[b, k, v]] @ w[k]`` over the rulebook's valid
pairs only (``0 <= nbr < V``). :func:`level_plan` lists each offset's pairs
once per level, as rows of the flattened batch; each product then gathers
its pairs compactly, so a FLOP counter over this code counts
``2 * pairs * Cin * Cout`` a product, the work these inputs need.
:class:`RulebookConv` keeps only its inputs for the backward, which runs the
transposed gathers: within one offset each output row and each input row
occurs once, so every sum is in a fixed order.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

Pairs = List[Tuple[torch.Tensor, torch.Tensor]]


def pairs_of(nbr: torch.Tensor) -> Pairs:
    """Per offset k, (output rows, input rows) of its valid pairs in the
    flattened [B * V] batch."""
    b, k_n, v = nbr.shape
    base = torch.arange(b, device=nbr.device)[:, None] * v
    out = []
    for k in range(k_n):
        nk = nbr[:, k].long()
        bi, vi = torch.nonzero((nk >= 0) & (nk < v), as_tuple=True)
        out.append((base[bi, 0] + vi, base[bi, 0] + nk[bi, vi]))
    return out


def level_plan(level) -> Pairs:
    """The pairs of ``level.nbr27``, listed at the first call and kept on
    the level for its other convs."""
    if level.conv_plan is None:
        level.conv_plan = pairs_of(level.nbr27)
    return level.conv_plan


def rulebook_conv_plain(x: torch.Tensor, w: torch.Tensor, nbr: torch.Tensor,
                        plan: Optional[Pairs] = None) -> torch.Tensor:
    """x [B, V, Cin], w [K, Cin, Cout], nbr [B, K, V] -> [B, V, Cout] in x's
    dtype, accumulated in f32."""
    b, v, cin = x.shape
    plan = plan if plan is not None else pairs_of(nbr)
    xf = x.reshape(b * v, cin)
    out = torch.zeros(b * v, w.shape[-1], dtype=torch.float32, device=x.device)
    for k, (dst, src) in enumerate(plan):
        out.index_add_(0, dst, xf[src].float() @ w[k].float())
    return out.view(b, v, -1).to(x.dtype)


class RulebookConv(torch.autograd.Function):
    """:func:`rulebook_conv_plain` with its gradients, keeping only x, w and
    the pairs between the forward and the backward."""

    @staticmethod
    def forward(ctx, x, w, nbr, plan=None):
        plan = plan if plan is not None else pairs_of(nbr)
        ctx.save_for_backward(x, w)
        ctx.plan = plan
        return rulebook_conv_plain(x, w, nbr, plan)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        b, v, cin = x.shape
        gf = g.reshape(b * v, -1).float()
        xf = x.reshape(b * v, cin).float()
        gx = torch.zeros(b * v, cin, dtype=torch.float32, device=x.device) \
            if ctx.needs_input_grad[0] else None
        gw = torch.zeros(w.shape, dtype=torch.float32, device=x.device) \
            if ctx.needs_input_grad[1] else None
        for k, (dst, src) in enumerate(ctx.plan):
            gk = gf[dst]
            if gx is not None:
                gx.index_add_(0, src, gk @ w[k].float().t())
            if gw is not None:
                gw[k] = xf[src].t() @ gk
        return (None if gx is None else gx.view(b, v, cin).to(x.dtype),
                None if gw is None else gw.to(w.dtype), None, None)
