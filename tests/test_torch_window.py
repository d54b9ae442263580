"""The port's RPE-free window attention (kernel K2's entry) and its window
sort against the JAX package, on the CPU (K2 on the card:
``tests/test_torch_cuda.py``).

The keys, the sort order and the window bounds are integers and must agree
exactly. The attention is held against the JAX package's banded XLA path
with a band wide enough to be exact, against the dense numpy oracle of
``tests/test_wattn.py``, and (``slow``) against the Pallas kernel in
interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2mkd_tpu.ops import hashing as jax_hashing
from u2mkd_tpu.ops import wattn as jax_wattn
from u2mkd_tpu.ops.pallas import wattn_kernel as jax_pk

from u2mkd_tpu_torch.ops import hashing, wattn
from u2mkd_tpu_torch.ops.kernels import wattn_kernel

from test_wattn import np_window_attention

# f32: the softmax sums in another order (pair lists against [tile, band]
# score blocks): a few ulps of outputs of order 1
ATOL = 3e-6


def _unpacked(key):
    hi, lo = hashing.unpack_key(key)
    return hi.numpy(), lo.numpy()


def test_pack_coords_matches_jax(rng):
    """Every key half equal to the JAX uint32 pair, invalid and out-of-range
    rows (both ends of +-32768) included; one int64 sort gives the JAX
    two-key stable order."""
    n = 400
    coords = rng.randint(-40, 40, (n, 3)).astype(np.int32)
    coords[:20] = rng.randint(-5, 5, (20, 3))          # repeated keys
    coords[20:30, 1] = 32767
    coords[30:40, 2] = -32768
    coords[40:45, 0] = 32768                            # out of range
    coords[45:50, 2] = -32769
    valid = rng.rand(n) < 0.85
    hi_j, lo_j = jax_hashing.pack_coords(jnp.asarray(coords), jnp.asarray(valid))
    key = hashing.pack_coords(torch.from_numpy(coords), torch.from_numpy(valid))
    hi, lo = _unpacked(key)
    np.testing.assert_array_equal(hi, np.asarray(hi_j).astype(np.int64))
    np.testing.assert_array_equal(lo, np.asarray(lo_j).astype(np.int64))
    assert (key[40:50] == hashing.PACKED_INVALID).all()
    order_j = jax.lax.sort((hi_j, lo_j, jnp.arange(n, dtype=jnp.int32)), num_keys=2,
                           is_stable=True)[2]
    np.testing.assert_array_equal(torch.sort(key, stable=True).indices.numpy(),
                                  np.asarray(order_j))


@pytest.mark.parametrize("sphere", [False, True])
def test_window_keys_and_bounds_match_jax(rng, sphere):
    """``window_keys`` (start over the valid rows, f32 cells), the stable
    sort and ``window_bounds_from_sorted``, exactly; on cartesian windows
    with a far-out valid row (its cell is out of range) and on the radial
    windows over ``cart2sphere`` coordinates."""
    n = 500
    xyz = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    valid = rng.rand(n) < 0.9
    if sphere:
        coords = np.asarray(jax_wattn.cart2sphere(jnp.asarray(xyz)))
        port_coords = wattn.cart2sphere(torch.from_numpy(xyz)).numpy()
        np.testing.assert_allclose(port_coords, coords, rtol=1e-6, atol=1e-4)
        coords = port_coords  # the keys are compared on identical inputs
        ws = (2.0, 2.0, 120.0)
    else:
        xyz[7] = (1e6, 0.0, 0.0)
        valid[7] = True
        coords, ws = xyz, (0.6, 0.6, 0.6)
    hi_j, lo_j = jax_wattn.window_keys(jnp.asarray(coords), jnp.asarray(valid), ws,
                                       shift=False)
    key = wattn.window_keys(torch.from_numpy(coords), torch.from_numpy(valid), ws)
    hi, lo = _unpacked(key)
    np.testing.assert_array_equal(hi, np.asarray(hi_j).astype(np.int64))
    np.testing.assert_array_equal(lo, np.asarray(lo_j).astype(np.int64))
    if not sphere:
        assert key[7] == hashing.PACKED_INVALID

    order_j = jax.lax.sort((hi_j, lo_j, jnp.arange(n, dtype=jnp.int32)), num_keys=2,
                           is_stable=True)[2]
    key_s, order = torch.sort(key, stable=True)
    np.testing.assert_array_equal(order.numpy(), np.asarray(order_j))
    start_j, end_j = jax_pk.window_bounds_from_sorted(hi_j[order_j], lo_j[order_j])
    start, end = wattn.window_bounds_from_sorted(key_s)
    np.testing.assert_array_equal(start.numpy(), np.asarray(start_j))
    np.testing.assert_array_equal(end.numpy(), np.asarray(end_j))


def test_window_bounds_of_runs():
    """The JAX package's own case (``tests/test_pallas_wattn.py``)."""
    key = torch.tensor([1, 1, 2, 2, 2, 5]) << 32
    start, end = wattn.window_bounds_from_sorted(key)
    assert start.tolist() == [0, 0, 2, 2, 2, 5]
    assert end.tolist() == [2, 2, 5, 5, 5, 6]


def _attn_inputs(rng, vcap, h=2, d=8):
    q = rng.randn(vcap, h, d).astype(np.float32) * 0.5
    k = rng.randn(vcap, h, d).astype(np.float32)
    v = rng.randn(vcap, h, d).astype(np.float32)
    valid = rng.rand(vcap) < 0.85
    return q, k, v, valid


def _skewed_xyz(vcap):
    """One window of half the rows, then single-row windows (the radial
    windows' skew): tiles whose key range spans many chunks."""
    xyz = np.zeros((vcap, 3), np.float32)
    xyz[: vcap // 2] = 0.1
    xyz[vcap // 2:] = np.arange(vcap - vcap // 2)[:, None] * [2.0, 0, 0] + 10
    return xyz


@pytest.mark.parametrize("case", ["cubic", "sphere", "skewed"])
def test_sparse_window_attention_matches_jax(rng, case):
    """``sparse_window_attention_flash`` (plain K2 on the CPU) against the
    JAX banded XLA path (``rpe=None``), with a band covering every window,
    and against the dense numpy oracle."""
    vcap = 300
    q, k, v, valid = _attn_inputs(rng, vcap)
    if case == "skewed":
        xyz, ws = _skewed_xyz(vcap), (1.0, 1.0, 1.0)
    else:
        xyz = rng.uniform(-6, 6, (vcap, 3)).astype(np.float32)
        ws = (1.5, 1.5, 1.5)
        if case == "sphere":
            xyz = wattn.cart2sphere(torch.from_numpy(xyz)).numpy()
            ws = (30.0, 30.0, 120.0)
    t = torch.from_numpy
    out = wattn_kernel.sparse_window_attention_flash(t(q), t(k), t(v), t(xyz), t(valid), ws)
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert (out.numpy()[~valid] == 0).all()
    ref = np.asarray(jax_wattn.sparse_window_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(xyz),
        jnp.asarray(valid), ws, band=3, tile=128))
    np.testing.assert_allclose(out.numpy()[valid], ref[valid], rtol=0, atol=ATOL)
    oracle = np_window_attention(q, k, v, xyz, valid, ws)
    np.testing.assert_allclose(out.numpy()[valid], oracle[valid], rtol=0, atol=ATOL)


def test_sorted_windows_layout(rng):
    """Pads get rank -7; every tile's key range covers the windows of its
    rows and nothing it need not; the wrapper on CPU tensors is the plain
    version and counts no launch."""
    vcap = 300
    xyz = _skewed_xyz(vcap)
    valid = np.ones(vcap, bool)
    sw = wattn_kernel.sort_by_window(torch.from_numpy(xyz), torch.from_numpy(valid),
                                     (1.0, 1.0, 1.0))
    assert sw.rank.dtype == torch.int32 and sw.rank.shape == (384,)
    assert (sw.rank[vcap:] == wattn_kernel.PAD_RANK).all()
    assert sw.kmin.tolist() == [0, 0, 256]
    assert sw.kmax.tolist() == [150, 256, 384]
    # invalid rows sort last, each a window of its own
    valid[::3] = False
    sw = wattn_kernel.sort_by_window(torch.from_numpy(xyz), torch.from_numpy(valid),
                                     (1.0, 1.0, 1.0))
    n_bad = int((~valid).sum())
    assert not valid[sw.order[-n_bad:].numpy()].any()
    bad = sw.rank[vcap - n_bad:vcap]
    assert torch.equal(bad, torch.arange(n_bad, dtype=torch.int32) + bad[0])
    assert (sw.rank[:vcap - n_bad] < bad[0]).all()
    before = wattn_kernel.flash_window_sorted.launches
    q = torch.randn(384, 2, 8)
    out = wattn_kernel.flash_window_sorted(q, q, q, sw.rank)
    assert wattn_kernel.flash_window_sorted.launches == before
    torch.testing.assert_close(out, wattn_kernel.flash_window_sorted_plain(q, q, q, sw.rank))


@pytest.mark.slow
def test_sparse_window_attention_matches_jax_pallas(rng):
    """The Pallas twin: ``sparse_window_attention_pallas`` in interpret
    mode on the skewed layout."""
    vcap = 300
    q, k, v, valid = _attn_inputs(rng, vcap)
    xyz = _skewed_xyz(vcap)
    ref = np.asarray(jax_pk.sparse_window_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(xyz),
        jnp.asarray(valid), (1.0, 1.0, 1.0), tile=128, interpret=True))
    t = torch.from_numpy
    out = wattn_kernel.sparse_window_attention_flash(t(q), t(k), t(v), t(xyz), t(valid),
                                                     (1.0, 1.0, 1.0))
    np.testing.assert_allclose(out.numpy()[valid], ref[valid], rtol=0, atol=ATOL)
