"""The PyTorch port's window attention with contextual RPE against the JAX
package's flash path, on the CPU (K3 on the card: ``tests/test_torch_cuda.py``).

The JAX reference is ``flash_pregeom_batched`` in interpret mode over the
same host geometry, at the sizes of
``tests/test_wgeom.py::test_pregeom_matches_injit``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2mkd_tpu.core.structures import WindowGeom as JaxWindowGeom
from u2mkd_tpu.ops import wattn as jax_wattn
from u2mkd_tpu.ops.pallas import wattn_kernel as jax_pk

from u2mkd_tpu_torch.data import wgeom_host
from u2mkd_tpu_torch.models.plumbing import _window_geom_from_arrays
from u2mkd_tpu_torch.ops import wattn
from u2mkd_tpu_torch.ops.kernels import wattn_kernel

# f32; softmax and the RPE sums accumulate in another order (the flash
# kernel's packed segment matmul against per-pair sums): a few ulps
RTOL, ATOL = 2e-5, 2e-6


def _inputs(rng, b=2, v=384, h=2, d=16, g=6, radial=False):
    xyz = rng.uniform(-8, 8, (b, v, 3)).astype(np.float32)
    valid = rng.rand(b, v) < 0.9
    q, k, vv = (rng.randn(b, v, h, d).astype(np.float32) * 0.3 for _ in range(3))
    l2 = 2 * g if radial else 2 * g - 1
    tables = [rng.randn(l2, 3, h, d).astype(np.float32) * 0.05 for _ in range(3)]
    coords = np.stack([wgeom_host.cart2sphere(x) for x in xyz]) if radial else xyz
    return coords, valid, q, k, vv, tables


def _geoms(coords, valid, ws, qs, radial):
    g = wgeom_host.branch_geometry(coords, valid, ws, qs, 128, radial)
    jax_geom = JaxWindowGeom(**{k: jnp.asarray(g.get(k)) if k in g else None
                                for k in ("order", "inv", "rank", "quant", "kmin",
                                          "kmax", "occ", "r")})
    return jax_geom, _window_geom_from_arrays(g, "cpu")


@pytest.mark.parametrize("radial", [False, True])
def test_pregeom_matches_jax_flash(rng, radial):
    g = 6
    ws = (4.0, 4.0, 4.0)
    qs = tuple(w / g for w in ws)
    coords, valid, q, k, v, (tq, tk, tv) = _inputs(rng, radial=radial)
    jax_geom, port_geom = _geoms(coords, valid, ws, qs, radial)
    ref = jax_pk.flash_pregeom_batched(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid), jax_geom,
        jnp.asarray(tq), jnp.asarray(tk), jnp.asarray(tv), grid_len=g, a=0.5,
        interpret=True)
    t = torch.from_numpy
    out = wattn_kernel.flash_pregeom_batched(
        t(q), t(k), t(v), t(valid), port_geom, t(tq), t(tk), t(tv), g, 0.5)
    assert out.dtype == torch.float32 and out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    assert (out.numpy()[~valid] == 0).all()


def test_exponential_split_index_matches_jax():
    rel = np.concatenate([
        np.linspace(-130, 130, 4001), [0.0, 0.0125, -0.0125, 0.025, 0.0375, 1e-7],
        np.random.RandomState(0).randn(2000) * 5]).astype(np.float32)
    for a in (0.0125, 0.5):
        ref = np.asarray(jax_wattn.exponential_split_index(jnp.asarray(rel), a))
        out = wattn.exponential_split_index(torch.from_numpy(rel), a).numpy()
        np.testing.assert_array_equal(out, ref)

