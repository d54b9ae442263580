"""The rulebook plan of K1 and K1b (``spconv_kernel.conv_plan``), on the CPU.

(a) On real host rulebooks, with rows -1, rows >= V and an empty level, the
plan holds every valid (b, k, v) pair exactly once and no invalid one: the
row order and its tiles' offset unions (K1), the per-offset pair lists and
their counts (K1b). (b) The conv and its weight gradient computed from the
plan alone, by gather, matmul and ``index_add_`` per offset, equal the plain
versions to 1e-6 and the JAX package's kernel to the tolerance of
``test_torch_spconv.py``. (c) A numpy emulation of the 3xTF32 products the
kernels run on the tensor cores for f32 stays within 1e-6 of an f64 product
at the conv's widths, where one pass of TF32 does not: why the kernels meet
the 1e-4 tolerance of the card checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2mkd_tpu.data import plumbing_host as jax_plumbing_host
from u2mkd_tpu.ops.pallas import spconv_kernel as jax_spk

from u2mkd_tpu_torch.data import synthetic
from u2mkd_tpu_torch.ops.kernels import spconv_kernel

CAPS = (512, 256, 128, 64, 32)


def _plumbing(b=2, seed=0):
    raw = synthetic.make_batch(np.random.RandomState(seed), b, 512, voxel_size=0.25)
    return jax_plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"], CAPS)


def _rulebook(case):
    """[B, 27, V] int32: a level of the host rulebook; level 0 with entries
    set to -1 and to >= V; or a level where every row is absent."""
    if case == "empty":
        return np.full((2, 27, 96), -1, np.int32)
    pl = _plumbing()
    if case == "edited":
        nbr = pl["nbr27"][0].copy()
        v = nbr.shape[-1]
        rng = np.random.RandomState(3)
        for fill in (-1, v, v + 7):
            nbr[tuple(rng.randint(0, s, 40) for s in nbr.shape)] = fill
        return nbr
    return pl["nbr27"][int(case[-1])]


def _masks(valid):
    return (valid.astype(np.int64) << np.arange(valid.shape[1])[None, :, None]).sum(1)


@pytest.mark.parametrize("case", ["level0", "level1", "level2", "level3", "level4", "edited",
                                  "empty"])
def test_plan_holds_every_valid_pair_once(case):
    nbr = _rulebook(case)
    b, k, v = nbr.shape
    plan = spconv_kernel.conv_plan(torch.from_numpy(nbr))
    valid = (nbr >= 0) & (nbr < v)
    masks = _masks(valid)
    # the sort key: the mask with the offsets' bits by descending count
    rank = np.empty(k, np.int64)
    rank[np.argsort(-valid.sum((0, 2)), kind="stable")] = np.arange(k)
    keys = (valid.astype(np.int64) << rank[None, :, None]).sum(1)
    tile = spconv_kernel.PLAN_TILE
    perm = plan.perm.numpy()
    nbr_s = plan.nbr_sorted.numpy()
    for bi in range(b):
        # K1: a stable sort by key, the rulebook in that order, tile unions
        np.testing.assert_array_equal(perm[bi], np.argsort(keys[bi], kind="stable"))
        np.testing.assert_array_equal(nbr_s[bi], np.where(valid[bi], nbr[bi], -1)[:, perm[bi]])
        sm = np.concatenate([masks[bi][perm[bi]], np.zeros(-v % tile, np.int64)])
        unions = np.bitwise_or.reduce(sm.reshape(-1, tile), axis=1)
        np.testing.assert_array_equal(plan.tile_mask[bi].numpy(), unions)
    # every valid pair lies in a tile whose union holds its offset, and the
    # sorted rulebook has exactly the valid pairs
    bits = (plan.tile_mask.numpy()[:, :, None] >> np.arange(k)) & 1          # [B, T, K]
    in_union = np.repeat(bits, tile, axis=1)[:, :v].transpose(0, 2, 1)       # [B, K, V]
    assert (in_union[nbr_s >= 0] == 1).all()
    assert (nbr_s >= 0).sum() == valid.sum()

    # K1b: per offset the valid pairs once each, in row order, then padding
    seg = plan.seg.numpy()
    counts = valid.sum((0, 2))
    np.testing.assert_array_equal(np.diff(seg), counts)
    assert seg[0] == 0 and seg[-1] == valid.sum()
    src, dst = plan.pair_src.numpy(), plan.pair_dst.numpy()
    for kk in range(k):
        bb, vv = np.nonzero(valid[:, kk])
        n = counts[kk]
        np.testing.assert_array_equal(dst[kk, :n], bb * v + vv)
        np.testing.assert_array_equal(src[kk, :n], bb * v + nbr[bb, kk, vv])
        assert (src[kk, n:] == -1).all()


def conv_from_plan(x, w, plan):
    """The conv from the plan alone: per offset, the rows of the tiles whose
    union holds it, gathered through the sorted rulebook, multiplied and
    added at their rows in the original order."""
    b, v, _ = x.shape
    k = w.shape[0]
    tile = spconv_kernel.PLAN_TILE
    out = torch.zeros(b, v, w.shape[-1], dtype=torch.float64)
    bits = (plan.tile_mask[..., None] >> torch.arange(k, dtype=torch.int32)) & 1
    for bi in range(b):
        for kk in range(k):
            rows = torch.nonzero(bits[bi, :, kk].repeat_interleave(tile)[:v])[:, 0]
            src = plan.nbr_sorted[bi, kk, rows].long()
            xg = torch.where((src >= 0)[:, None], x[bi, src.clamp(min=0)].double(), 0.0)
            out[bi].index_add_(0, plan.perm[bi, rows].long(), xg @ w[kk].double())
    return out


def dw_from_plan(x, g, plan):
    """The weight gradient from the plan's pair lists alone."""
    k = plan.seg.shape[0] - 1
    xf, gf = x.reshape(-1, x.shape[-1]).double(), g.reshape(-1, g.shape[-1]).double()
    gw = torch.zeros(k, x.shape[-1], g.shape[-1], dtype=torch.float64)
    for kk in range(k):
        n = int(plan.seg[kk + 1] - plan.seg[kk])
        gw[kk] = xf[plan.pair_src[kk, :n].long()].T @ gf[plan.pair_dst[kk, :n].long()]
    return gw


@pytest.mark.parametrize("case,cin,cout", [("level0", 8, 16), ("level1", 32, 24),
                                           ("edited", 40, 72), ("empty", 16, 8)])
def test_conv_from_plan_matches_plain(rng, case, cin, cout):
    nbr = _rulebook(case)
    b, k, v = nbr.shape
    plan = spconv_kernel.conv_plan(torch.from_numpy(nbr))
    x = torch.from_numpy(rng.randn(b, v, cin).astype(np.float32))
    g = torch.from_numpy(rng.randn(b, v, cout).astype(np.float32))
    w = torch.from_numpy((rng.randn(k, cin, cout) * 0.1).astype(np.float32))
    nbr_t = torch.from_numpy(nbr)
    out = conv_from_plan(x, w, plan)
    ref = spconv_kernel.rulebook_conv_plain(x, w, nbr_t).double()
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0,
                               atol=1e-6 * max(ref.abs().max().item(), 1.0))
    gw = dw_from_plan(x, g, plan)
    ref = spconv_kernel.rulebook_conv_dw_plain(x, g, nbr_t).double()
    np.testing.assert_allclose(gw.numpy(), ref.numpy(), rtol=0,
                               atol=1e-6 * max(ref.abs().max().item(), 1.0))


@pytest.mark.parametrize("cin,cout,level", [(8, 16, 0), (32, 24, 1)])
def test_conv_from_plan_matches_pallas(rng, cin, cout, level):
    """The same shapes and tolerance as ``test_rulebook_conv_matches_pallas``."""
    pl = _plumbing()
    nbr = pl["nbr27"][level]
    vm = pl["vmask"][level].astype(bool)
    x = np.where(vm[..., None], rng.randn(*vm.shape, cin), 0.0).astype(np.float32)
    w = (rng.randn(27, cin, cout) * 0.1).astype(np.float32)
    t = x.shape[1] // pl["cr27jn"][level].shape[-1]
    ref = jax_spk.rulebook_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.swapaxes(jnp.asarray(nbr), 1, 2),
        jnp.asarray(pl["cr27jl"][level]), jnp.asarray(pl["cr27jn"][level]),
        jnp.asarray(pl["cr27kr"][level]), t)
    out = conv_from_plan(torch.from_numpy(x), torch.from_numpy(w),
                         spconv_kernel.conv_plan(torch.from_numpy(nbr)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def tf32(a):
    """f32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), as ``cvt.rna.tf32.f32`` rounds."""
    u = np.asarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def products_3xtf32(a, b):
    """a @ b as the kernels take it for f32: hi = tf32(x), lo = tf32(x -
    hi) for each operand, hi*hi + hi*lo + lo*hi, each product exact and
    the sums in f32."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    f64 = np.float64
    return ((al.astype(f64) @ bh.astype(f64)).astype(np.float32)
            + (ah.astype(f64) @ bl.astype(f64)).astype(np.float32)
            + (ah.astype(f64) @ bh.astype(f64)).astype(np.float32))


@pytest.mark.parametrize("cin,cout", [(128, 96), (96, 128), (384, 256)])
def test_3xtf32_keeps_f32_accuracy(rng, cin, cout):
    """At a conv's widths (a row of the forward: 27 offsets of Cin terms)
    3xTF32 stays within 1e-6 of the f64 product, relative to its largest
    entry; one pass of TF32 misses that by two orders of magnitude, and
    would miss the card checks' 1e-4 on sums of rounded terms."""
    a = rng.randn(256, 27 * cin).astype(np.float32)
    b = (rng.randn(27 * cin, cout) * (27 * cin) ** -0.5).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(ref).max()
    err3 = np.abs(products_3xtf32(a, b) - ref).max() / scale
    err1 = np.abs(tf32(a).astype(np.float64) @ tf32(b).astype(np.float64) - ref).max() / scale
    assert err3 <= 1e-6, err3
    assert err1 > 1e-4, err1
