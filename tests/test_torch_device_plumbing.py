"""The port's plumbing built on the device (``ops/hashing.py``,
``ops/voxelize.py``, ``ops/spconv.build_levels``,
``models/plumbing.build_plumbing``) against the JAX package's in-program
build, on the CPU (the card's build against this one:
``tests/test_torch_cuda.py``).

Every integer array must agree exactly: the key tables (the ``capacity``
smallest keys kept when a grid saturates), the inverse maps, the counts, the
rulebooks and the point maps. The f32 arrays are sums and products in
another order (the trilinear weights), or in f64 where JAX sums in f32 (the
port's device build takes the voxel means as its host builder does): within
1e-6 of their scale. Both packages keep the rows in packed-key order, so
the rows line up. Against the port's host plumbing (Morton order) the voxel
sets, the rulebooks and the voxel means are compared by key, the means
bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2mkd_tpu.data import synthetic as jax_synthetic
from u2mkd_tpu.models import plumbing as jax_plumbing
from u2mkd_tpu.ops import hashing as jax_hashing
from u2mkd_tpu.ops import voxelize as jax_voxelize

from u2mkd_tpu_torch.data import plumbing_host, wgeom_host
from u2mkd_tpu_torch.models import plumbing as P
from u2mkd_tpu_torch.models.spvcnn import teacher_model
from u2mkd_tpu_torch.ops import hashing, voxelize
from u2mkd_tpu_torch.train import state

torch.set_num_threads(2)

F32_RTOL = 1e-6
# the synthetic scans at 0.3 m: ~420-450 level-0 voxels of 512 points, ~300
# at level 2, ~80 at level 4; GENEROUS holds every level, SATURATED fills all
GENEROUS = (512, 512, 384, 256, 128)
SATURATED = (256, 128, 64, 32, 16)


def _unpacked(key):
    hi, lo = hashing.unpack_key(key)
    return hi.numpy(), lo.numpy()


def _coords(rng, n):
    c = rng.randint(-30, 30, (n, 3)).astype(np.int32)
    c[: n // 4] = rng.randint(-3, 3, (n // 4, 3))          # repeated keys
    c[n // 4:n // 4 + 5, 0] = 32768                       # out of range: invalid
    c[n // 4 + 5:n // 4 + 10, 2] = -32769
    c[n // 4 + 10:n // 4 + 15, 1] = 32767                 # the range's ends: valid
    c[n // 4 + 15:n // 4 + 20, 1] = -32768
    return c


@pytest.mark.parametrize("capacity", [512, 160, 100, 37],
                         ids=["unsaturated", "saturated", "not128", "small"])
def test_unique_and_lookup_match_jax(rng, capacity):
    """``pack_coords``, ``unique_keys`` (table, inverse, counts, num),
    ``lookup`` and ``lookup_coords`` equal the JAX package's exactly, with
    out-of-range coordinates invalid rather than wrapped."""
    n = 600
    coords = _coords(rng, n)
    valid = rng.rand(n) < 0.9
    hi_j, lo_j = jax_hashing.pack_coords(jnp.asarray(coords), jnp.asarray(valid))
    key = hashing.pack_coords(torch.from_numpy(coords), torch.from_numpy(valid))
    hi, lo = _unpacked(key)
    np.testing.assert_array_equal(hi, np.asarray(hi_j).astype(np.int64))
    np.testing.assert_array_equal(lo, np.asarray(lo_j).astype(np.int64))
    assert (key[n // 4:n // 4 + 10] == hashing.PACKED_INVALID).all()

    uhi, ulo, inv_j, counts_j, num_j = jax_hashing.unique_keys(hi_j, lo_j, capacity)
    table, inverse, counts, num = hashing.unique_keys(key, capacity)
    thi, tlo = _unpacked(table)
    np.testing.assert_array_equal(thi, np.asarray(uhi).astype(np.int64))
    np.testing.assert_array_equal(tlo, np.asarray(ulo).astype(np.int64))
    np.testing.assert_array_equal(inverse.numpy(), np.asarray(inv_j))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j))
    assert int(num) == int(num_j)
    n_unique = len(np.unique(key.numpy()[key.numpy() != hashing.PACKED_INVALID]))
    assert int(num) == min(n_unique, capacity)
    if capacity < n_unique:  # the capacity smallest keys kept, the rest dropped
        assert (inverse == capacity).sum() > (~torch.from_numpy(valid)).sum()
    np.testing.assert_array_equal(hashing.unpack_coords(table[:int(num)]).numpy(),
                                  np.asarray(jax_hashing.unpack_coords(uhi, ulo))[:int(num)])

    q = np.concatenate([coords, rng.randint(-40, 40, (200, 3)).astype(np.int32)])
    q = q.reshape(-1, 4, 3)
    qv = rng.rand(*q.shape[:2]) < 0.9
    ref = jax_hashing.lookup_coords(jnp.asarray(q), jnp.asarray(qv), uhi, ulo)
    got = hashing.lookup_coords(torch.from_numpy(q), torch.from_numpy(qv), table)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got >= 0).any() and (got < 0).any()
    qkey = hashing.pack_coords(torch.from_numpy(q.reshape(-1, 3)), torch.from_numpy(qv.ravel()))
    np.testing.assert_array_equal(hashing.lookup(qkey, table).numpy(),
                                  np.asarray(ref).ravel())


@pytest.mark.parametrize("capacity", [512, 200], ids=["unsaturated", "saturated"])
def test_voxelize_and_queries_match_jax(capacity):
    """``voxelize_initial``, ``point_voxel_query`` and
    ``voxel_to_point_query`` at strides 1-8: the integers exactly, the
    voxel means and weights to F32_RTOL."""
    raw = jax_synthetic.make_batch(np.random.RandomState(1), 1, 512, voxel_size=0.3)
    pc, xyz, pm = raw["pcoords"][0], raw["xyz"][0], raw["pmask"][0]
    ref = jax_voxelize.voxelize_initial(jnp.asarray(pc), jnp.asarray(xyz), jnp.asarray(pm),
                                        capacity)
    got = voxelize.voxelize_initial(torch.from_numpy(pc), torch.from_numpy(xyz),
                                    torch.from_numpy(pm), capacity)
    for k in ("vcoords", "vmask", "p2v", "counts", "num"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    hi, lo = _unpacked(got["key"])
    np.testing.assert_array_equal(hi, np.asarray(ref["key_hi"]).astype(np.int64))
    np.testing.assert_array_equal(lo, np.asarray(ref["key_lo"]).astype(np.int64))
    np.testing.assert_allclose(got["vfeats"].numpy(), np.asarray(ref["vfeats"]), rtol=0,
                               atol=F32_RTOL * np.abs(np.asarray(ref["vfeats"])).max())
    for stride in (1, 2, 4, 8):
        p2v_j = jax_voxelize.point_voxel_query(jnp.asarray(pc), jnp.asarray(pm), stride,
                                               ref["key_hi"], ref["key_lo"])
        p2v = voxelize.point_voxel_query(torch.from_numpy(pc), torch.from_numpy(pm), stride,
                                         got["key"])
        np.testing.assert_array_equal(p2v.numpy(), np.asarray(p2v_j))
        idx_j, w_j = jax_voxelize.voxel_to_point_query(
            jnp.asarray(pc), jnp.asarray(pm), stride, ref["key_hi"], ref["key_lo"])
        idx, w = voxelize.voxel_to_point_query(torch.from_numpy(pc), torch.from_numpy(pm),
                                               stride, got["key"])
        np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
        np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=0, atol=F32_RTOL)
        if stride == 1:  # the table is the stride-1 grid: most points find their voxel
            assert (p2v >= 0).any()


def _build_both(caps, b=2, seed=0):
    raw = jax_synthetic.make_batch(np.random.RandomState(seed), b, 512, voxel_size=0.3)
    ref = jax.jit(lambda a, x, m: jax_plumbing.build_plumbing(a, x, m, caps))(
        raw["pcoords"], raw["xyz"], raw["pmask"])
    got = P.build_plumbing(torch.from_numpy(raw["pcoords"]), torch.from_numpy(raw["xyz"]),
                           torch.from_numpy(raw["pmask"]), caps)
    return raw, ref, got


@pytest.mark.parametrize("caps", [GENEROUS, SATURATED], ids=["generous", "saturated"])
def test_build_plumbing_matches_jax(caps):
    """``build_plumbing`` on a batch of two scans against JAX
    ``build_plumbing``: per level the grid (mask, coords, keys, num), the
    27-neighbour, down and up rulebooks, the point maps and the point
    voxelize segments exactly; the voxel means and devoxelize weights to
    F32_RTOL."""
    _, ref, got = _build_both(caps)
    for li, (a, b) in enumerate(zip(ref.levels, got.levels)):
        for k in ("mask", "coords", "num"):
            np.testing.assert_array_equal(getattr(b.grid, k).numpy(),
                                          np.asarray(getattr(a.grid, k)), err_msg=f"{k}{li}")
        hi, lo = _unpacked(b.grid.key)
        np.testing.assert_array_equal(hi, np.asarray(a.grid.key_hi).astype(np.int64))
        np.testing.assert_array_equal(lo, np.asarray(a.grid.key_lo).astype(np.int64))
        assert b.grid.stride == a.grid.stride == 1 << li
        np.testing.assert_array_equal(b.nbr27.numpy(), np.asarray(a.nbr27))
        for k in ("down_nbr8", "up_parent", "up_koff"):
            x, y = getattr(a, k), getattr(b, k)
            assert (x is None) == (y is None), f"{k}{li}"
            if x is not None:
                np.testing.assert_array_equal(y.numpy(), np.asarray(x), err_msg=f"{k}{li}")
        np.testing.assert_array_equal(got.p2v[li].numpy(), np.asarray(ref.p2v[li]))
        np.testing.assert_array_equal(got.devox_idx[li].numpy(), np.asarray(ref.devox_idx[li]))
        for k in ("devox_w", "vox_xyz"):
            want = np.asarray(getattr(ref, k)[li])
            np.testing.assert_allclose(getattr(got, k)[li].numpy(), want, rtol=0,
                                       atol=F32_RTOL * np.abs(want).max(), err_msg=f"{k}{li}")
    np.testing.assert_array_equal(got.p2v0_feats_seg.numpy(), np.asarray(ref.p2v0_feats_seg))
    full = [int(lv.grid.num.max()) == lv.grid.capacity for lv in got.levels]
    assert (not any(full)) if caps == GENEROUS else full[0]
    assert got.wgeom is None


def test_build_plumbing_point_levels():
    """The point maps only at the levels asked for; the rest as built for
    every level."""
    raw = jax_synthetic.make_batch(np.random.RandomState(2), 1, 512, voxel_size=0.3)
    args = [torch.from_numpy(raw[k]) for k in ("pcoords", "xyz", "pmask")]
    full = P.build_plumbing(*args, GENEROUS)
    part = P.build_plumbing(*args, GENEROUS, point_levels=(0, 2, 4))
    for li in range(5):
        if li in (0, 2, 4):
            assert torch.equal(part.devox_idx[li], full.devox_idx[li])
            assert torch.equal(part.p2v[li], full.p2v[li])
        else:
            assert part.p2v[li] is None and part.devox_w[li] is None
        assert torch.equal(part.levels[li].nbr27, full.levels[li].nbr27)


def _key_rows(coords, mask, stride):
    """{packed key of a live voxel at ``stride``: its row}."""
    key = hashing.pack_coords(torch.as_tensor(coords), torch.as_tensor(mask).bool())
    return {int(k): r for r, k in enumerate(key.tolist()) if k != hashing.PACKED_INVALID}


def test_device_build_equals_host_by_key():
    """Where no grid is full, the device build and the port's host plumbing
    (Morton order) hold the same voxel set per level, the same 27-neighbour,
    down and parent maps once each row is read by its key, and the same
    voxel means to the last bit (the windows are taken on them)."""
    raw, _, got = _build_both(GENEROUS, b=1, seed=3)
    host = plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"], GENEROUS)
    keys_d, keys_h = [], []
    for li, lv in enumerate(got.levels):
        assert int(lv.grid.num.max()) < lv.grid.capacity
        kd = _key_rows(lv.grid.coords[0], lv.grid.mask[0], 1 << li)
        kh = _key_rows(host["coords"][li][0], host["vmask"][li][0], 1 << li)
        assert sorted(kd) == sorted(kh) and len(kd) > 0
        keys_d.append({r: k for k, r in kd.items()})
        keys_h.append({r: k for k, r in kh.items()})

    def by_key(rows, keys):
        return [keys[r] if r >= 0 else -1 for r in rows]

    for li, lv in enumerate(got.levels):
        for k_d, r_d in ((k, r) for r, k in keys_d[li].items()):
            r_h = {k: r for r, k in keys_h[li].items()}[k_d]
            assert by_key(lv.nbr27[0, :, r_d].tolist(), keys_d[li]) == by_key(
                host["nbr27"][li][0, :, r_h].tolist(), keys_h[li])
            if li:
                assert by_key(lv.down_nbr8[0, :, r_d].tolist(), keys_d[li - 1]) == by_key(
                    host["down8"][li][0, :, r_h].tolist(), keys_h[li - 1])
            assert torch.equal(got.vox_xyz[li][0, r_d],
                               torch.from_numpy(host["voxxyz"][li][0, r_h]))
            if li < len(got.levels) - 1:
                assert by_key([int(lv.up_parent[0, r_d])], keys_d[li + 1]) == by_key(
                    [int(host["parent"][li][0, r_h])], keys_h[li + 1])
                assert int(lv.up_koff[0, r_d]) == int(host["koff"][li][0, r_h])


def test_batch_reader_builds_on_the_device(monkeypatch):
    """A batch without ``plumbing`` is built by ``build_plumbing`` on the
    model's device, never by the host builder; a batch with one is
    assembled from it; both give the same logits."""
    raw = jax_synthetic.make_batch(np.random.RandomState(4), 1, 512, voxel_size=0.3)
    model = teacher_model(num_classes=5, cr=0.25, voxel_size=0.3, head_dim=4, device="cpu")
    arrays = plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"], GENEROUS,
                                          wgeom_params=wgeom_host.params_from_model(model))

    def refuse(*a, **k):
        raise AssertionError("the host builder ran")

    monkeypatch.setattr(plumbing_host, "batch_plumbing", refuse)
    _, plumbing_of, _ = state.batch_reader(model, GENEROUS)
    pl = plumbing_of(raw)
    assert pl.wgeom is None and pl.vox_xyz is not None
    assert pl.levels[0].grid.key is not None
    assert [x is not None for x in pl.p2v] == [li in model.point_levels for li in range(5)]
    host = plumbing_of(dict(raw, plumbing=arrays))
    assert host.levels[0].grid.key is None and host.wgeom is not None and host.vox_xyz is None
    eval_fn = state.make_eval_step(model, GENEROUS, 5)
    out = eval_fn(raw)["logits"]
    ref = eval_fn(dict(raw, plumbing=arrays))["logits"]
    valid = torch.from_numpy(raw["pmask"])
    scale = ref[valid].abs().max().item()
    assert scale > 1e-2
    assert (out[valid] - ref[valid]).abs().max().item() <= 1e-4 * scale
