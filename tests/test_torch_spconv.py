"""The PyTorch port's sparse convs and point <-> voxel ops against the JAX
package, on the CPU (K1 on the card: ``tests/test_torch_cuda.py``).

f32 on both sides. The rulebook conv's reference is the JAX package's Pallas
kernel (``spconv_kernel.rulebook_conv``, interpret mode on the CPU, as
``tests/test_pallas_spconv.py`` runs it) where its TPU gate takes the width,
and its XLA ``spconv.sparse_conv`` where it does not (Cin 384).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2mkd_tpu.data import plumbing_host as jax_plumbing_host
from u2mkd_tpu.ops import spconv as jax_spconv
from u2mkd_tpu.ops import voxelize as jax_voxelize
from u2mkd_tpu.ops.pallas import spconv_kernel as jax_spk

from u2mkd_tpu_torch.data import plumbing_host, synthetic
from u2mkd_tpu_torch.models import plumbing
from u2mkd_tpu_torch.ops import spconv, voxelize
from u2mkd_tpu_torch.ops.kernels import spconv_kernel

# f32 sums over 27*Cin products in another order: a few ulps of the output
RTOL, ATOL = 1e-5, 1e-5


def _level(p=512, b=2, level=0, seed=0):
    caps = (p, p // 2, p // 4, p // 8, p // 16)
    raw = synthetic.make_batch(np.random.RandomState(seed), b, p, voxel_size=0.25)
    return jax_plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"],
                                            caps), caps


def _feats(rng, pl, level, cin):
    vm = pl["vmask"][level].astype(bool)
    x = rng.randn(*vm.shape, cin).astype(np.float32)
    return np.where(vm[..., None], x, 0.0).astype(np.float32)


@pytest.mark.parametrize("cin,cout,level", [(8, 16, 0), (32, 24, 1)])
def test_rulebook_conv_matches_pallas(rng, cin, cout, level):
    pl, _ = _level()
    nbr = pl["nbr27"][level]
    x = _feats(rng, pl, level, cin)
    w = (rng.randn(27, cin, cout) * 0.1).astype(np.float32)
    t = x.shape[1] // pl["cr27jn"][level].shape[-1]
    ref = jax_spk.rulebook_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.swapaxes(jnp.asarray(nbr), 1, 2),
        jnp.asarray(pl["cr27jl"][level]), jnp.asarray(pl["cr27jn"][level]),
        jnp.asarray(pl["cr27kr"][level]), t)
    out = spconv_kernel.rulebook_conv(torch.from_numpy(x), torch.from_numpy(w),
                                      torch.from_numpy(nbr))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_sparse_conv_wide_input(rng):
    """Cin 384 (``up0_res0``): a width the JAX kernel's TPU gate refuses; the
    port's conv takes every width."""
    assert not jax_spk.supported(384, 256)
    pl, _ = _level(p=256, b=1)
    nbr = pl["nbr27"][1][0]
    x = _feats(rng, pl, 1, 384)[0]
    w = (rng.randn(27, 384, 32) * 0.05).astype(np.float32)
    ref = jax_spconv.sparse_conv(jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(w))
    out = spconv.sparse_conv(torch.from_numpy(x), torch.from_numpy(nbr), torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_gather_rows_drops_both_conventions():
    """-1 rows and rows >= V both give zero rows (a clip-only guard would
    leak the last row)."""
    feats = np.arange(12, dtype=np.float32).reshape(4, 3) + 1
    rows = np.array([[0, -1, 3, 4, 9]], np.int32)
    ref = jax_spconv.gather_rows(jnp.asarray(feats), jnp.asarray(rows))
    out = spconv.gather_rows(torch.from_numpy(feats), torch.from_numpy(rows))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert (out[0, 1:2] == 0).all() and (out[0, 3:] == 0).all()


def test_down_conv_matches_jax(rng):
    pl, _ = _level(p=512, b=1)
    nbr8 = pl["down8"][1][0]                       # [8, V1] rows of level 0
    x = _feats(rng, pl, 0, 16)[0]
    w = (rng.randn(8, 16, 24) * 0.1).astype(np.float32)
    ref = jax_spconv.sparse_conv(jnp.asarray(x), jnp.asarray(nbr8), jnp.asarray(w))
    out = spconv.down_conv(torch.from_numpy(x), torch.from_numpy(nbr8), torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_transposed_conv_matches_jax(rng):
    pl, _ = _level(p=512, b=1)
    parent, koff = pl["parent"][0][0], pl["koff"][0][0]   # level 0 -> its level-1 parent
    x = _feats(rng, pl, 1, 12)[0]
    w = (rng.randn(8, 12, 20) * 0.1).astype(np.float32)
    ref = jax_spconv.sparse_conv_transposed_2x2(
        jnp.asarray(x), jnp.asarray(parent), jnp.asarray(koff), jnp.asarray(w))
    out = spconv.sparse_conv_transposed_2x2(
        torch.from_numpy(x), torch.from_numpy(parent), torch.from_numpy(koff),
        torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_point_voxel_transfer_matches_jax(rng):
    """segment_mean (with the ``capacity`` drop bucket), and the plumbing's
    point_to_voxel (-1 drops) and voxel_to_point against JAX's
    point_to_voxel_mean and trilinear_devoxelize on the host plumbing's
    maps."""
    pl, caps = _level(p=512, b=1)
    p2v, dvi, dvw = pl["p2v"][1][0], pl["dvi"][1][0], pl["dvw"][1][0]
    pf = rng.randn(len(p2v), 5).astype(np.float32)
    seg = np.where(p2v >= 0, p2v, caps[1]).astype(np.int32)
    ref = jax_voxelize.segment_mean(jnp.asarray(pf), jnp.asarray(seg), caps[1])
    out = voxelize.segment_mean(torch.from_numpy(pf), torch.from_numpy(seg), caps[1])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    ref = jax_voxelize.point_to_voxel_mean(jnp.asarray(pf), jnp.asarray(p2v), caps[1])
    out = plumbing.point_to_voxel(torch.from_numpy(pf)[None], torch.from_numpy(p2v)[None],
                                  caps[1])[0]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    vf = rng.randn(caps[1], 7).astype(np.float32)
    ref = jax_voxelize.trilinear_devoxelize(jnp.asarray(vf), jnp.asarray(dvi), jnp.asarray(dvw))
    out = plumbing.voxel_to_point(torch.from_numpy(vf)[None], torch.from_numpy(dvi)[None],
                                  torch.from_numpy(dvw)[None])[0]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)



def test_rev_perm_27_is_the_negating_involution():
    rev = spconv.rev_perm_27()
    offs = spconv.kernel_offsets(3)
    np.testing.assert_array_equal(rev[rev], np.arange(27))
    np.testing.assert_array_equal(offs[rev], -offs)
    np.testing.assert_array_equal(rev, jax_spk.rev_perm_27())
    assert rev[0] == 0 and not np.array_equal(rev, 26 - np.arange(27))


def test_host_rulebook_is_symmetric():
    """``nbr[rev k, nbr[k, v]] == v`` on every valid entry of every level:
    what lets the input gradient run through the forward kernel."""
    raw = synthetic.make_batch(np.random.RandomState(5), 2, 512, voxel_size=0.25)
    pl = plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"],
                                      (512, 256, 128, 64, 32))
    rev = spconv.rev_perm_27()
    n_checked = 0
    for nbr in pl["nbr27"]:
        b, k, v = nbr.shape
        for bi in range(b):
            for kk in range(k):
                cols = np.nonzero((nbr[bi, kk] >= 0) & (nbr[bi, kk] < v))[0]
                back = nbr[bi, rev[kk], nbr[bi, kk, cols]]
                np.testing.assert_array_equal(back, cols)
                n_checked += len(cols)
    assert n_checked > 1000


@pytest.mark.parametrize("cin,cout,level", [(8, 16, 0), (384, 32, 1)])
def test_rulebook_conv_grads_match_jax(rng, monkeypatch, cin, cout, level):
    """RulebookConv on the CPU (dX: the plain conv with the reversed,
    transposed weights; dW: the plain gather-einsum) against jax.grad of the
    JAX package's ``spconv.sparse_conv`` per sample, B=2, including Cin 384,
    a width the JAX kernel's TPU gate refuses. f32 sums over V rows (dW) or
    27*Cout terms (dX) in another order."""
    import jax

    pl, _ = _level(p=256 if level else 512, b=2)
    nbr = pl["nbr27"][level]
    x = _feats(rng, pl, level, cin)
    w = (rng.randn(27, cin, cout) * (27 * cin) ** -0.5).astype(np.float32)
    gout = rng.randn(*x.shape[:2], cout).astype(np.float32)

    def loss(x_, w_):
        out = jax.vmap(lambda f, n: jax_spconv.sparse_conv(f, n, w_))(x_, jnp.asarray(nbr))
        return jnp.sum(out * gout)

    gx_ref, gw_ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = spconv_kernel.RulebookConv.apply(xt, wt, torch.from_numpy(nbr))
    (out * torch.from_numpy(gout)).sum().backward()
    for got, ref in ((xt.grad, gx_ref), (wt.grad, gw_ref)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())

    # no dX for an input that needs none (the stem's first conv)
    wt.grad = None
    monkeypatch.setattr(spconv_kernel, "rulebook_conv_dx",
                        lambda *a: pytest.fail("dX computed for an input without grad"))
    out = spconv_kernel.RulebookConv.apply(torch.from_numpy(x), wt, torch.from_numpy(nbr))
    out.sum().backward()
    assert wt.grad is not None
