"""Matmul FLOPs of the window attention, counted from the host window
geometry (port of ``u2mkd_tpu/utils/flops.py``).

A profiler cannot tell the work of the model from the work of an
implementation: a kernel that pads its tiles executes more. The useful
counters (:func:`flash_attention_useful_flops`) give the work every
implementation of the attention must do, the (query, key) pairs within each
window, so that a model-FLOPs share reads the same whatever runs the
attention. Per pair and head they count the matmul terms of the JAX
package's flash kernels at their segment widths ``sk``/``sv`` (the
forward's two passes, and with ``train`` the two backward kernels); the
radial lookups are selects, not matmuls, and are left out, so the count is
a floor.

:func:`flash_attention_flops` is the JAX module's executed count: the trips
of the TPU kernels' loop over 128-row (query tile, key tile) pairs
(:func:`geom_tile`, :func:`_tile_pairs`), each tile pair charged in full.
It is a schedule of the TPU kernels, not the work K3-K5 do on the card,
whose lanes each walk their own window; ``ops/kernels/wattn_kernel.walk_counts``
counts those lane steps. It is kept so that a step split reports the
number the JAX tool reports (``bench_parts.py``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from u2mkd_tpu_torch.data.wgeom_host import level_window_params


def _pad128(w: int) -> int:
    return max(128, -(-w // 128) * 128)


def _branch_spec(d: int, g: int, radial: bool) -> Tuple[int, int]:
    """(sk, sv): the q/k and v segment widths of one attention branch, as
    the JAX package's ``FlashRPEConfig`` lays them out: the head dim, the
    one-hot in-window offsets of 3 (cubic) or 2 (sphere) axes of G bins
    each, and on the sphere branch 2G radial bins."""
    wd = (2 if radial else 3) * g
    lr = 2 * g if radial else 0
    return _pad128(d + 2 * wd + 2 * lr), _pad128(d + wd + lr)


def geom_tile(geom: Dict[str, np.ndarray]) -> int:
    """The query tile a geometry was laid out with, as the kernels derive
    it: the sorted rows over the tiles' key ranges (``len(rank) //
    len(kmin)``)."""
    return int(geom["rank"].shape[-1]) // int(geom["kmin"].shape[-1])


def _tile_pairs(geom: Dict[str, np.ndarray], tile: int) -> int:
    """The (query tile, key tile) trips of the TPU kernels' loop over every
    tile's key range [kmin, kmax)."""
    kmin = np.asarray(geom["kmin"]).astype(np.int64)
    kmax = np.asarray(geom["kmax"]).astype(np.int64)
    return int(((kmax - 1) // tile + 1 - kmin // tile).sum())


def level_attn_specs(model) -> List[Tuple[int, int, int, int, int]]:
    """Per encoder level (1..4): (heads_cubic, heads_sphere, head_dim,
    g_cubic, g_sphere), with heads cs[l] // head_dim split h//2 and
    h - h//2 as the model splits them, and the windows doubling as in
    ``wgeom_host.level_window_params``."""
    cs = [int(model.cr * x) for x in model.base_channels]
    d = int(model.head_dim)
    lw = level_window_params(model.window_size, model.window_size_sphere, model.quant_size,
                             model.quant_size_sphere, model.window_size_scale)
    out = []
    for idx in range(4):
        h = cs[idx + 1] // d
        h1 = h // 2
        e = lw[idx]
        g_cub = int((e["ws"][0] + 1e-4) / e["qs"][0])
        g_sph = int((e["wss"][0] + 1e-4) / e["qss"][0])
        out.append((h1, h - h1, d, g_cub, g_sph))
    return out


def useful_pair_counts(plumbing: Dict) -> Dict[str, List[int]]:
    """Per branch and level, the useful (query, key) pairs: the sum of c^2
    over the live windows' occupancies c, the pairs the reference's
    ``precompute_all`` materializes (``sptr/functional.py:146-167``). From
    a host plumbing dict (``plumbing_host.batch_plumbing`` with window
    geometry): ``order`` maps a sorted position to its row of the flattened
    [B*V] batch, the level's ``vmask`` says which rows are live, and
    ``rank`` is each sorted position's window (pads sit in windows of their
    own, which the live mask drops)."""
    wg = plumbing["wgeom"]
    vmask = plumbing["vmask"]
    out = {branch: [] for branch in wg}
    for branch in wg:
        for li, geom in enumerate(wg[branch]):
            flat = np.asarray(vmask[li + 1]).astype(bool).reshape(-1)
            rank = np.asarray(geom["rank"])
            order = np.asarray(geom["order"]).astype(np.int64)
            live = flat[order] & (np.arange(len(order)) < flat.size)
            c = np.bincount(rank[live].astype(np.int64))
            out[branch].append(int((c.astype(np.int64) ** 2).sum()))
    return out


def _per_pair_flops(sk: int, sv: int, train: bool) -> int:
    """Matmul FLOPs per (query, key) pair and head: the forward's two
    passes, and with ``train`` the two backward kernels."""
    per = 2 * (2 * sk + sv)
    if train:
        per += 2 * (2 * sk + sv) + 2 * (2 * sk + 2 * sv)
    return per


def flash_attention_useful_flops(model, plumbing: Dict, train: bool = True) -> float:
    """Useful matmul FLOPs of one forward (and with ``train`` its backward)
    of ``model``'s window attention over ``plumbing``: only the live
    within-window pairs count. 0.0 without window geometry."""
    if plumbing.get("wgeom") is None:
        return 0.0
    counts = useful_pair_counts(plumbing)
    total = 0.0
    for li, (h1, h2, d, g_cub, g_sph) in enumerate(level_attn_specs(model)):
        for branch, hh, g, radial in (("cubic", h1, g_cub, False), ("sphere", h2, g_sph, True)):
            sk, sv = _branch_spec(d, g, radial)
            total += float(counts[branch][li]) * hh * _per_pair_flops(sk, sv, train)
    return total


def flash_attention_flops(model, plumbing: Dict, train: bool = True) -> float:
    """Executed matmul FLOPs of the JAX package's flash kernels in one
    forward (and with ``train`` its backward) of ``model``'s window
    attention over ``plumbing`` (module docstring): per tile pair and head
    the forward's two passes 2 T^2 (2 sk + sv), with ``train`` the q-side
    backward as much again and the k-side 2 T^2 (2 sk + 2 sv). 0.0 without
    window geometry."""
    wg = plumbing.get("wgeom")
    if wg is None:
        return 0.0
    total = 0.0
    for li, (h1, h2, d, g_cub, g_sph) in enumerate(level_attn_specs(model)):
        for branch, hh, g, radial in (("cubic", h1, g_cub, False), ("sphere", h2, g_sph, True)):
            geom = wg[branch][li]
            tile = geom_tile(geom)
            sk, sv = _branch_spec(d, g, radial)
            per_pair = 2 * tile * tile * (2 * sk + sv)
            if train:
                per_pair += 2 * tile * tile * (2 * sk + sv) + 2 * tile * tile * (2 * sk + 2 * sv)
            total += float(_tile_pairs(geom, tile)) * hh * per_pair
    return total
