"""The port's image branch, fusion layers and multimodal batch against the
JAX package, on the CPU.

The same numpy inputs and the same (bridged) weights go through both; f32
on both sides. Images are NHWC in the JAX package and NCHW in the port: the
tests permute. BatchNorm statistics are drawn away from their identity
values, so that eval-mode BN is exercised.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2mkd_tpu.data import synthetic as jax_synthetic
from u2mkd_tpu.models import fusion as jax_fusion
from u2mkd_tpu.models import swiftnet as jax_swiftnet

from u2mkd_tpu_torch.data import synthetic
from u2mkd_tpu_torch.models import convert_weights, fusion, swiftnet

from test_torch_model import _random_variables

# f32 convolutions and sums in another order (XLA against oneDNN / ATen):
# through the ~20 layers of the SwiftNet, a few ulps of the largest output
RTOL = 1e-4


def _flax(module, *args, seed=0, method=None):
    """Random variables of a flax module initialized on ``args``."""
    abstract = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args,
                                                  method=method))
    return _random_variables(abstract, seed)


def _port(module, variables):
    module.load_state_dict(convert_weights.from_flax(variables["params"],
                                                     variables.get("batch_stats", {})))
    return module.eval()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def assert_close(got, want, rtol=RTOL):
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 1e-3, "degenerate outputs make the comparison vacuous"
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("size", [(32, 48), (45, 80), (23, 40), (1, 1), (1, 7)])
def test_resize_matches_jax(rng, size):
    """The sample positions are linspace(0, n-1) in the JAX package and
    i * (n-1)/(m-1) in PyTorch: they differ by f32 ulps, which move an
    output by ulps of the input's scale."""
    x = rng.randn(2, 23, 40, 5).astype(np.float32)
    ref = jax_swiftnet.resize_bilinear_align_corners(jnp.asarray(x), size)
    out = swiftnet.resize_bilinear_align_corners(nchw(x), size)
    assert_close(nhwc(out), ref, rtol=1e-5)


@pytest.mark.parametrize("n_in,n_out", [(23, 8), (40, 14), (40, 7), (23, 2), (45, 3), (5, 5)])
def test_adaptive_pool_matches_jax(rng, n_in, n_out):
    """``F.adaptive_avg_pool2d`` has the windows of the JAX package's
    averaging matrices."""
    x = rng.randn(1, 3, n_in, n_in + 3).astype(np.float32)
    ah = jax_swiftnet.adaptive_avg_pool_matrices(n_in, n_out)
    aw = jax_swiftnet.adaptive_avg_pool_matrices(n_in + 3, n_out + 1)
    ref = np.einsum("ph,nchw,qw->ncpq", ah, x, aw)
    out = torch.nn.functional.adaptive_avg_pool2d(torch.from_numpy(x), (n_out, n_out + 1))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("in_ch,planes,stride", [(16, 16, 1), (16, 32, 2)])
def test_basic_block_matches_flax(rng, in_ch, planes, stride):
    x = rng.randn(2, 32, 48, in_ch).astype(np.float32)
    ref_mod = jax_swiftnet.BasicBlock(planes, stride)
    variables = _flax(ref_mod, x, False)
    act, skip = ref_mod.apply(variables, x, False)
    port = _port(swiftnet.BasicBlock(in_ch, planes, stride), variables)
    with torch.no_grad():
        p_act, p_skip = port(nchw(x))
    assert p_act is p_skip  # the skip is the post-ReLU sum
    assert_close(nhwc(p_act), act)
    np.testing.assert_array_equal(np.asarray(act), np.asarray(skip))


def test_spp_matches_flax(rng):
    """SPP on the stage-4 map size of a 360x640 image (23x40)."""
    x = rng.randn(2, 23, 40, 64).astype(np.float32)
    ref_mod = jax_swiftnet.SpatialPyramidPooling(bt_size=32, level_size=10, out_size=32)
    variables = _flax(ref_mod, x, False)
    ref = ref_mod.apply(variables, x, False)
    port = _port(swiftnet.SpatialPyramidPooling(64, bt_size=32, level_size=10, out_size=32),
                 variables)
    with torch.no_grad():
        assert_close(nhwc(port(nchw(x))), ref)


def test_swiftnet_matches_flax(rng):
    """The full SwiftNet-18 in eval at 32x48, through its staged API: the
    stem, every stage's skip, the SPP and the decoder up to the image."""
    x = rng.rand(2, 32, 48, 3).astype(np.float32)
    ref_mod = jax_swiftnet.SwiftNetResNet()
    variables = _flax(ref_mod, x, False)
    feats = ref_mod.apply(variables, x, False, method=jax_swiftnet.SwiftNetResNet.forward_down)
    ref = ref_mod.apply(variables, x, False, im_size=(32, 48))
    port = _port(swiftnet.SwiftNetResNet(), variables)
    with torch.no_grad():
        p_feats = port.forward_down(nchw(x))
        out = port(nchw(x), im_size=(32, 48))
    assert [tuple(f.shape[-2:]) for f in p_feats] == [(16, 24), (8, 12), (4, 6), (2, 3)]
    for p, r in zip(p_feats, feats):
        assert_close(nhwc(p), r)
    assert out.shape == (2, 128, 32, 48)
    assert_close(nhwc(out), ref)


def _projections(rng, b=2, ncam=3, p=300):
    coords = rng.uniform(-1.05, 1.05, (b, ncam, p, 2)).astype(np.float32)
    coords[:, :, :5] = [[-1.0, -1.0], [1.0, 1.0], [-1.0, 1.0], [1.0, -1.0], [0.0, 0.0]]
    masks = rng.rand(b, ncam, p) < 0.6
    return coords, masks


def test_feature_gather_and_fetch_match_jax(rng):
    """x indexes the width and y the height; corners, coordinates just
    outside [-1, 1] (zero padding) and camera overwrite order."""
    coords, masks = _projections(rng)
    fmaps = rng.randn(2, 3, 7, 11, 5).astype(np.float32)          # [B, NCAM, H, W, C]
    t = torch.from_numpy
    port_maps = t(np.ascontiguousarray(np.moveaxis(fmaps, -1, 2)))  # [B, NCAM, C, H, W]
    for cam in range(3):
        ref = jax_fusion.feature_gather(jnp.asarray(fmaps[0, cam]), jnp.asarray(coords[0, cam]))
        out = fusion.feature_gather(port_maps[0, cam][None], t(coords[0, cam])[None])[0]
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=2e-6)
    ref = jax.vmap(jax_fusion.feature_fetch)(jnp.asarray(fmaps), jnp.asarray(coords),
                                             jnp.asarray(masks))
    out = fusion.feature_fetch(port_maps, t(coords), t(masks))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=2e-6)
    assert (out.numpy()[~masks.any(1)] == 0).all()


@pytest.mark.parametrize("size", [(6, 10), (3, 5), (1, 1)])
def test_point_to_grid_matches_jax(rng, size):
    """The segment mean per camera pixel with its drop bucket, on grids
    where many points share a pixel."""
    coords, masks = _projections(rng)
    feats = rng.randn(2, 300, 4).astype(np.float32)
    ref = jax.vmap(lambda f, co, ma: jax.vmap(
        lambda c, m: jax_fusion.point_to_grid(f, c, m, size))(co, ma))(
        jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(masks))   # [B, NCAM, h, w, C]
    out = fusion.point_to_grid(torch.from_numpy(feats), torch.from_numpy(coords),
                               torch.from_numpy(masks), size)
    assert out.shape == (6, 4) + size
    np.testing.assert_allclose(nhwc(out), np.asarray(ref).reshape(6, *size, 4),
                               rtol=0, atol=2e-6)


def test_fusion_blocks_match_flax(rng):
    """AttenFusionConv and LearnerMLP on masked points, L2CFusion on maps
    (with its biased 1x1 convs), in eval and, for the point blocks, in
    training (batch statistics over the valid points)."""
    b, p, pc, ic = 2, 200, 16, 32
    pts = rng.randn(b, p, pc).astype(np.float32)
    img = rng.randn(b, p, ic).astype(np.float32)
    mask = rng.rand(b, p) < 0.8
    t = torch.from_numpy

    ref_mod = jax_fusion.AttenFusionConv(pc)
    variables = _flax(ref_mod, pts, img, mask, False)
    port = _port(fusion.AttenFusionConv(pc, ic, pc), variables)
    ref_mod_l = jax_fusion.LearnerMLP(ic)
    variables_l = _flax(ref_mod_l, pts, mask, False, seed=1)
    port_l = _port(fusion.LearnerMLP(pc, ic), variables_l)
    for train in (False, True):
        ref = ref_mod.apply(variables, pts, img, mask, train, mutable=["batch_stats"])[0]
        ref_l = ref_mod_l.apply(variables_l, pts, mask, train, mutable=["batch_stats"])[0]
        port.train(train)
        port_l.train(train)
        with torch.no_grad():
            assert_close(port(t(pts), t(img), t(mask)).numpy(), ref)
            assert_close(port_l(t(pts), t(mask)).numpy(), ref_l)

    grid = rng.randn(3, 9, 13, pc).astype(np.float32)
    fmap = rng.randn(3, 9, 13, ic).astype(np.float32)
    ref_mod = jax_fusion.L2CFusion(ic)
    variables = _flax(ref_mod, grid, fmap, False, seed=2)
    act, fused = ref_mod.apply(variables, grid, fmap, False)
    port = _port(fusion.L2CFusion(pc, ic, ic), variables)
    with torch.no_grad():
        p_act, p_fused = port(nchw(grid), nchw(fmap))
    assert_close(nhwc(p_fused), fused)
    assert_close(nhwc(p_act), act)


def test_multimodal_batch_matches_jax():
    """One seed gives the same arrays as the JAX package's."""
    for seed in (0, 5):
        ref = jax_synthetic.make_multimodal_batch(np.random.RandomState(seed), 2, 300, 420,
                                                  voxel_size=0.3, num_cams=3, im_hw=(8, 12))
        got = synthetic.make_multimodal_batch(np.random.RandomState(seed), 2, 300, 420,
                                              voxel_size=0.3, num_cams=3, im_hw=(8, 12))
        assert sorted(got) == sorted(ref)
        np.testing.assert_array_equal(got["t2s"], ref["t2s"])
        for part in ("student", "teacher"):
            assert sorted(got[part]) == sorted(ref[part])
            for k, v in ref[part].items():
                assert got[part][k].dtype == v.dtype, (part, k)
                np.testing.assert_array_equal(got[part][k], v, err_msg=f"{part}.{k}")
