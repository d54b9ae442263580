"""The port's point ops (kNN, farthest point sampling, 2D correlation) and
CLFM fusion modules against the JAX package's, on the CPU.

Indices are integers and must agree exactly, ties included: ``lax.top_k``
puts equal distances in index order and ``argmax`` takes the first maximum,
which the port keeps where ``torch.topk`` promises no order. The tie cases
put points on a lattice of eighths, where every squared distance is exact
in f32 whatever the order of the sums. Features agree to 1e-5 (f32 sums in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2mkd_tpu.models import clfm as jax_clfm
from u2mkd_tpu.ops import pointops as jax_pointops

from u2mkd_tpu_torch.models import convert_weights
from u2mkd_tpu_torch.models.clfm import CLFM, FusionAwareInterp, SKFusion
from u2mkd_tpu_torch.ops import pointops

FEAT_ATOL = 1e-5


def _lattice(rng, n, d, extent):
    """n points of d coordinates on a lattice of eighths in [0, extent)."""
    return (rng.randint(0, extent * 8, (n, d)) / 8.0).astype(np.float32)


def _perturbed(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x + 0.1 * rng.randn(*x.shape), np.float32), params)


@pytest.mark.parametrize("case", ["random3d", "lattice2d_ties", "lattice3d_masked",
                                  "fewer_valid_than_k"])
def test_knn_indices_match_jax(rng, case):
    """kNN indices equal to JAX's: random 3D points; integer-lattice 2D
    queries into eighth-lattice points with repeated points and equal
    distances; a validity mask; fewer valid points than k (the rest come
    from the invalid rows, in index order)."""
    valid = None
    k = 8
    if case == "random3d":
        q, p = rng.randn(200, 3).astype(np.float32), rng.randn(500, 3).astype(np.float32)
    elif case == "lattice2d_ties":
        q = _lattice(rng, 300, 2, 6).round().astype(np.float32)
        p = _lattice(rng, 400, 2, 6)
        p[200:260] = p[:60]                              # repeated points: equal distances
    else:
        q, p = _lattice(rng, 250, 3, 4), _lattice(rng, 600, 3, 4)
        valid = rng.rand(600) < (0.5 if case == "lattice3d_masked" else 0.008)
        if case == "fewer_valid_than_k":
            assert 0 < valid.sum() < k
    got = pointops.knn(torch.from_numpy(q), torch.from_numpy(p), k,
                       None if valid is None else torch.from_numpy(valid), tile=96)
    want = jax_pointops.knn(jnp.asarray(q), jnp.asarray(p), k,
                            None if valid is None else jnp.asarray(valid), tile=64)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if case == "lattice2d_ties":  # the case has ties inside the k nearest
        d2 = ((q[:, None] - p[got.numpy()]) ** 2).sum(-1)
        assert (np.diff(d2, axis=1) == 0).any()


@pytest.mark.parametrize("case", ["random", "lattice_ties", "masked"])
def test_fps_matches_jax(rng, case):
    """FPS indices equal to JAX's: random points; an eighth lattice with
    duplicated points, where equal farthest distances pick the first; a
    validity mask whose first rows are invalid."""
    valid = None
    if case == "random":
        pts = rng.randn(300, 3).astype(np.float32)
    else:
        pts = _lattice(rng, 300, 3, 2)
        pts[150:] = pts[:150]
        if case == "masked":
            valid = rng.rand(300) < 0.7
            valid[:3] = False
    got = pointops.farthest_point_sampling(
        torch.from_numpy(pts), 40, None if valid is None else torch.from_numpy(valid))
    want = jax_pointops.farthest_point_sampling(
        jnp.asarray(pts), 40, None if valid is None else jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if valid is not None:
        assert valid[got.numpy()].all() and int(got[0]) == int(np.argmax(valid))


@pytest.mark.parametrize("shape,d", [((6, 8, 4), 2), ((2, 9, 12, 16), 3)])
def test_correlation2d_matches_jax(rng, shape, d):
    a = rng.randn(*shape).astype(np.float32)
    b = rng.randn(*shape).astype(np.float32)
    got = pointops.correlation2d(torch.from_numpy(a), torch.from_numpy(b), d)
    want = np.asarray(jax_pointops.correlation2d(jnp.asarray(a), jnp.asarray(b), d))
    assert got.shape == want.shape == shape[:-1] + ((2 * d + 1) ** 2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _clfm_inputs(rng, n=120, h=12, w=20, c2=16, c3=24):
    uv = (rng.rand(n, 2) * [w - 1, h - 1]).astype(np.float32)
    mask = rng.rand(n) < 0.8
    uv[~mask] = 0.0  # padded rows parked at the origin, as the buffers park them
    return (uv, rng.randn(h, w, c2).astype(np.float32), rng.randn(n, c3).astype(np.float32),
            mask)


@pytest.mark.parametrize("k", [1, 3])
def test_fusion_aware_interp_matches_jax(rng, k):
    uv, _, f3d, mask = _clfm_inputs(rng)
    ref_mod = jax_clfm.FusionAwareInterp(24, k=k)
    params = _perturbed(ref_mod.init(jax.random.PRNGKey(0), uv, f3d, (12, 20), mask)["params"],
                        1)
    want = np.asarray(ref_mod.apply({"params": params}, uv, f3d, (12, 20), mask))
    port = FusionAwareInterp(24, k=k)
    port.load_state_dict(convert_weights.from_flax(params, {}))
    with torch.no_grad():
        got = port(torch.from_numpy(uv), torch.from_numpy(f3d), (12, 20),
                   torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FEAT_ATOL)


def test_skfusion_matches_jax(rng):
    a = rng.randn(10, 14, 16).astype(np.float32)
    b = rng.randn(10, 14, 24).astype(np.float32)
    ref_mod = jax_clfm.SKFusion(16, reduction=2)
    params = _perturbed(ref_mod.init(jax.random.PRNGKey(0), a, b)["params"], 2)
    want = np.asarray(ref_mod.apply({"params": params}, a, b))
    port = SKFusion(16, 24, 16, reduction=2)
    port.load_state_dict(convert_weights.from_flax(params, {}))
    with torch.no_grad():
        got = port(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FEAT_ATOL)


def test_clfm_matches_jax(rng):
    """Both directions, padded points masked out of the kNN; and the
    gradients: neither output reaches the other modality's input."""
    uv, f2d, f3d, mask = _clfm_inputs(rng)
    ref_mod = jax_clfm.CLFM(16, 24)
    params = _perturbed(ref_mod.init(jax.random.PRNGKey(0), uv, f2d, f3d, mask)["params"], 3)
    want2d, want3d = ref_mod.apply({"params": params}, uv, f2d, f3d, mask)
    port = CLFM(16, 24)
    port.load_state_dict(convert_weights.from_flax(params, {}))
    t2d = torch.from_numpy(f2d).requires_grad_(True)
    t3d = torch.from_numpy(f3d).requires_grad_(True)
    got2d, got3d = port(torch.from_numpy(uv), t2d, t3d, torch.from_numpy(mask))
    np.testing.assert_allclose(got2d.detach().numpy(), np.asarray(want2d), rtol=0,
                               atol=FEAT_ATOL)
    np.testing.assert_allclose(got3d.detach().numpy(), np.asarray(want3d), rtol=0,
                               atol=FEAT_ATOL)

    def jloss(f2, f3):
        o2, o3 = ref_mod.apply({"params": params}, uv, f2, f3, mask)
        return jnp.sum(o2 ** 2) + jnp.sum(jnp.sin(o3))

    g2, g3 = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(f2d), jnp.asarray(f3d))
    ((got2d ** 2).sum() + torch.sin(got3d).sum()).backward()
    np.testing.assert_allclose(t2d.grad.numpy(), np.asarray(g2), rtol=0,
                               atol=FEAT_ATOL * np.abs(np.asarray(g2)).max())
    np.testing.assert_allclose(t3d.grad.numpy(), np.asarray(g3), rtol=0,
                               atol=FEAT_ATOL * np.abs(np.asarray(g3)).max())
