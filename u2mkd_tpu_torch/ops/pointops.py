"""Point-cloud utility ops: kNN, farthest point sampling, 2D correlation.

Port of ``u2mkd_tpu/ops/pointops.py``, which computes these outside any
Pallas kernel: plain torch here too. The orders the JAX functions promise
are kept where torch promises none: :func:`knn` returns each query's
neighbours by distance and, among equal distances, by lowest index
(``lax.top_k``'s order; ``torch.topk`` gives ties in no set order), and
:func:`farthest_point_sampling` takes the first of equal maxima (``argmax``).
Each distance is computed with the JAX function's formula in the same
order of f32 operations.
"""

from __future__ import annotations

from typing import Optional

import torch


def _topk_smallest_stable(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Column indices [T, k] of the k smallest entries of each row of d2
    [T, N], ascending by value and, among equal values, by index."""
    kth = torch.topk(d2, k, dim=1, largest=False).values[:, -1:]      # [T, 1]
    less = d2 < kth
    eq = d2 == kth
    n_eq_taken = k - less.sum(dim=1, keepdim=True)
    take = less | (eq & (torch.cumsum(eq, dim=1) <= n_eq_taken))
    cols = take.nonzero()[:, 1].reshape(d2.shape[0], k)                # ascending index
    order = torch.sort(torch.gather(d2, 1, cols), dim=1, stable=True).indices
    return torch.gather(cols, 1, order)


def knn(query: torch.Tensor, points: torch.Tensor, k: int,
        points_valid: Optional[torch.Tensor] = None, tile: int = 2048) -> torch.Tensor:
    """Indices [Q, k] int32 of the k nearest ``points`` rows of each query
    row: query [Q, D], points [N, D] (D = 2 or 3). Invalid points get an
    infinite distance. Squared distances |q|^2 + |p|^2 - 2 q.p, in tiles of
    ``tile`` queries to bound memory."""
    n = points.shape[0]
    if points_valid is None:
        points_valid = torch.ones(n, dtype=torch.bool, device=points.device)
    pn2 = torch.where(points_valid, (points * points).sum(-1), torch.inf)
    outs = []
    for lo in range(0, query.shape[0], tile):
        qt = query[lo:lo + tile]
        qn2 = (qt * qt).sum(-1, keepdim=True)
        d2 = qn2 + pn2[None, :] - (2.0 * qt) @ points.T
        d2 = torch.where(points_valid[None, :], d2, torch.inf)
        outs.append(_topk_smallest_stable(d2, k))
    return torch.cat(outs).to(torch.int32)


def farthest_point_sampling(points: torch.Tensor, num_samples: int,
                            valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FPS indices [num_samples] int32 of points [N, 3]: the first valid row,
    then each time the valid row farthest from those taken (first of equal
    maxima)."""
    n = points.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=points.device)
    idxs = torch.zeros(num_samples, dtype=torch.int64, device=points.device)
    idxs[0] = torch.argmax(valid.to(torch.int32))
    mind2 = torch.where(valid, torch.inf, -torch.inf)
    for i in range(1, num_samples):
        diff = points - points.index_select(0, idxs[i - 1:i])     # no host sync
        d2 = diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1] + diff[:, 2] * diff[:, 2]
        mind2 = torch.where(valid, torch.minimum(mind2, d2), -torch.inf)
        idxs[i] = torch.argmax(mind2)
    return idxs.to(torch.int32)


def correlation2d(a: torch.Tensor, b: torch.Tensor, max_displacement: int) -> torch.Tensor:
    """Cost volume of two channel-last maps a, b [..., H, W, C] -> [..., H,
    W, (2d+1)^2]: out[..., y, x, k] = <a[y, x], b[y + dy, x + dx]> / C for
    each displacement (dy, dx) in [-d, d]^2, dy outer, zero outside b."""
    d = max_displacement
    c = a.shape[-1]
    h, w = a.shape[-3], a.shape[-2]
    bp = torch.nn.functional.pad(b, (0, 0, d, d, d, d))
    outs = []
    for dy in range(2 * d + 1):
        for dx in range(2 * d + 1):
            shifted = bp[..., dy:dy + h, dx:dx + w, :]
            outs.append((a * shifted).sum(-1) / c)
    return torch.stack(outs, dim=-1)
