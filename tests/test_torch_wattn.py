"""The PyTorch port's window attention with contextual RPE against the JAX
package's flash path, on the CPU (K3 on the card: ``tests/test_torch_cuda.py``).

The JAX reference is ``flash_pregeom_batched`` in interpret mode over the
same host geometry, at the sizes of
``tests/test_wgeom.py::test_pregeom_matches_injit``.
"""

import math

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



def _grad_case(rng, radial, v=256):
    """The sizes of ``tests/test_wgeom.py::test_pregeom_grads_match``: one
    sample of 256 rows, h=2, d=16, G=4, windows of 5 units, a=0.5."""
    g = 4
    ws = (5.0, 5.0, 5.0)
    qs = tuple(w / g for w in ws)
    coords, valid, q, k, v, tables = _inputs(rng, b=1, v=v, g=g, radial=radial)
    w_out = rng.randn(*q.shape).astype(np.float32)
    jax_geom, port_geom = _geoms(coords, valid, ws, qs, radial)
    return g, valid, (q, k, v, *tables), w_out, jax_geom, port_geom


def _port_grads(args, valid, w_out, geom, g, plain=False):
    leaves = [torch.from_numpy(x).requires_grad_() for x in args]
    q, k, v, tq, tk, tv = leaves
    out = wattn_kernel.flash_pregeom_batched(q, k, v, torch.from_numpy(valid), geom,
                                             tq, tk, tv, g, 0.5, plain=plain)
    (out * torch.from_numpy(w_out)).sum().backward()
    return [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("radial", [False, True])
def test_flash_rpe_grads_match_jax(rng, radial):
    """FlashRPE's dq, dk, dv, dTq, dTk and dTv through flash_pregeom_batched
    (plain K4/K5 on the CPU, the projections' einsum backward, the
    order/inv gathers scatter-added back) against jax.grad of the JAX
    flash path in interpret mode. f32; the JAX backward sums masses and
    pairs in another order (packed MXU segments), so a few ulps of each
    gradient's scale."""
    import jax

    g, valid, args, w_out, jax_geom, port_geom = _grad_case(rng, radial)

    def loss(q, k, v, tq, tk, tv):
        o = jax_pk.flash_pregeom_batched(q, k, v, jnp.asarray(valid), jax_geom, tq, tk, tv,
                                         grid_len=g, a=0.5, interpret=True)
        return jnp.sum(o * w_out)

    ref = jax.grad(loss, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    got = _port_grads(args, valid, w_out, port_geom, g)
    for name, a_, b_ in zip(("q", "k", "v", "tq", "tk", "tv"), got, ref):
        b_ = np.asarray(b_)
        scale = np.abs(b_).max()
        assert scale > 0, name
        np.testing.assert_allclose(a_, b_, rtol=0, atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize("radial", [False, True])
def test_flash_rpe_backward_matches_autograd(rng, radial):
    """The Function's backward (plain K4 and K5 plus the epilogue) equals
    autograd through the plain forward: the same pairs, summed in another
    order. A table gradient's bin sums ds over many pairs, and sum_j ds_ij
    is 0 for every query, so a bin that collects most of a query's pairs
    cancels: its f32 error is ulps of the terms, ~1e-6 of the gradient's
    scale, not of the bin's value."""
    g, valid, args, w_out, _, port_geom = _grad_case(rng, radial)
    got = _port_grads(args, valid, w_out, port_geom, g)
    ref = _port_grads(args, valid, w_out, port_geom, g, plain=True)
    for name, a_, b_ in zip(("q", "k", "v", "tq", "tk", "tv"), got, ref):
        np.testing.assert_allclose(a_, b_, rtol=0, atol=1e-5 * np.abs(b_).max(),
                                   err_msg=name)


def test_pad_rows_get_zero_gradient(rng):
    """Pads in the host geometry's ``order`` point at row 0. Their do is 0
    (``inv`` never reads them back), so their dq, dk and dv must be exactly
    0, or the scatter-add through ``order`` would corrupt row 0's gradient."""
    n, h, d = 250, 2, 16  # pad_to 256: six pad rows
    g, valid, args, w_out, _, geom = _grad_case(rng, radial=True, v=n)
    pad = torch.ones(geom.order.shape[0], dtype=torch.bool)
    pad[geom.inv] = False
    assert pad.any(), "the case has no pad rows"
    sorted_ = [torch.from_numpy(x).reshape(n, h, d)[geom.order].contiguous().requires_grad_()
               for x in args[:3]]
    tables = [torch.from_numpy(x) for x in args[3:]]
    out_s = wattn_kernel.flash_rpe_sorted(*sorted_, geom.rank, geom.quant, geom.r, *tables,
                                          g, 0.5)
    (out_s[geom.inv] * torch.from_numpy(w_out).reshape(n, h, d)).sum().backward()
    for x in sorted_:
        assert torch.count_nonzero(x.grad[pad]) == 0
        assert torch.count_nonzero(x.grad[~pad]) > 0


def test_plain_forward_lse(rng):
    """The plain K3 returns each row's log-sum-exp with its output:
    lse_i = log sum_j exp(s_ij), checked against a dense softmax over the
    window mask."""
    g, valid, args, _, _, geom = _grad_case(rng, radial=False)
    n, h, d = 256, 2, 16
    qs, ks, vs = (torch.from_numpy(x).reshape(n, h, d)[geom.order] for x in args[:3])
    tq, tk, tv = (torch.from_numpy(x) for x in args[3:])
    qT, kT = wattn.table_projections(qs, tq), wattn.table_projections(ks, tk)
    out, lse = wattn.window_attention_rpe_fwd(qs, ks, vs, qT, kT, tv, geom.rank, geom.quant,
                                              None, g, 0.5)
    cq = geom.quant.long().clamp(0, g - 1)
    idx = cq[:, None] - cq[None, :] + g - 1                              # [N, N, 3]
    s = torch.einsum("ihd,jhd->ijh", qs, ks)                             # [N, N, h]
    rows, cols = torch.arange(len(cq))[:, None], torch.arange(len(cq))[None, :]
    for ax in range(3):
        s = s + qT[:, :, ax][rows, :, idx[..., ax]] + kT[:, :, ax][cols, :, idx[..., ax]]
    same = geom.rank[:, None] == geom.rank[None, :]
    ref = torch.logsumexp(torch.where(same[..., None], s, -torch.inf), dim=1)
    np.testing.assert_allclose(lse.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    assert out.shape == (len(cq), h, d)


def test_plain_forward_keeps_no_per_pair_tensors(rng):
    """Under autograd the plain K3 holds between forward and backward only
    its inputs and the pair lists, not the per-pair intermediates (gathered
    projections, scores, values: some kilobytes a pair), which made a
    plain train step of the SphereFormer U-Net (attention at level 0 of
    P=131072) exhaust a card's 80 GB; its gradients stay autograd's."""
    n, h, d, g = 512, 2, 16, 24
    qs, ks, vs = (torch.from_numpy(rng.randn(n, h, d).astype(np.float32) * 0.3)
                  .requires_grad_(True) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(rng.randn(2 * g, 3, h, d).astype(np.float32) * 0.05)
                  .requires_grad_(True) for _ in range(3))
    rank = torch.zeros(n)                                  # one window of 512 rows
    quant = torch.from_numpy(rng.randint(0, g, (n, 3)).astype(np.int32))
    r = torch.from_numpy(rng.uniform(0, 50, n).astype(np.float32))
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        qT, kT = wattn.table_projections(qs, tq), wattn.table_projections(ks, tk)
        out, lse = wattn.window_attention_rpe_fwd(qs, ks, vs, qT, kT, tv, rank, quant, r,
                                                  g, 0.0125)
    pairs = n * n
    assert sum(saved) < 64 * pairs, sum(saved) / pairs    # kept: ~18 bytes a pair
    (out.square().sum() + lse.sum()).backward()
    grads = [x.grad.clone() for x in (qs, ks, vs, tq, tk, tv)]
    for x in (qs, ks, vs, tq, tk, tv):
        x.grad = None
    qT, kT = wattn.table_projections(qs, tq), wattn.table_projections(ks, tk)
    out2, lse2 = wattn._rpe_chunk(qs.float(), ks.float(), vs.float(), qT, kT, tv.float(),
                                  quant.long().clamp(0, g - 1), r,
                                  torch.arange(n).repeat_interleave(n),
                                  torch.arange(n).repeat(n), 0, n, g, 0.0125)
    (out2.square().sum() + lse2.sum()).backward()
    for got, x in zip(grads, (qs, ks, vs, tq, tk, tv)):
        np.testing.assert_allclose(got.numpy(), x.grad.numpy(), rtol=1e-5, atol=1e-6)


def _lane_walk_fwd(qs, ks, vs, qT, kT, tv, rank, quant, r, g, a, nk=2):
    """K3's walk (``csrc/wattn_rpe_fwd.cu``) in torch: each row steps through
    its own run [start, end) from ``wattn_kernel.warp_run_bounds`` in key
    order, ``nk`` keys per step, and joins a step's keys to its online
    softmax as ``wattn::softmax_join`` does: one rescale to the largest of
    the running max and the step's live scores, then the keys' terms in key
    order; keys past the run's end take no part. A key's value row is v_j
    plus the three value-table rows. -> (out [N, h, d], lse [N, h])."""
    start, end, _ = wattn_kernel.warp_run_bounds(rank)
    n, h, d = qs.shape
    cq = quant.long().clamp(0, g - 1)
    rows = torch.arange(n)
    m = torch.full((n, h), -math.inf)
    l, acc = torch.zeros(n, h), torch.zeros(n, h, d)
    for t0 in range(0, int((end - start).max()), nk):
        live, s, val = [], [], []
        for u in range(nk):
            ok = start + t0 + u < end
            j = torch.where(ok, start + t0 + u, rows)
            idx = wattn._bins(cq, r, rows, j, g, a)
            live.append(ok[:, None])
            s.append(wattn._scores(qs, ks, qT, kT, rows, j, idx))
            val.append(vs[j] + tv[idx[:, 0], 0] + tv[idx[:, 1], 1] + tv[idx[:, 2], 2])
        mx = m
        for ok, su in zip(live, s):
            mx = torch.where(ok, torch.maximum(mx, su), mx)
        sc = torch.exp(m - mx)
        p = [torch.where(ok, torch.exp(su - mx), 0.0) for ok, su in zip(live, s)]
        l = l * sc
        acc = acc * sc[..., None]
        for pu, vu in zip(p, val):
            l = l + pu
            acc = acc + pu[..., None] * vu
        m = mx
    return acc / l[..., None], m + torch.log(l)


@pytest.mark.parametrize("radial", [False, True])
def test_lane_walk_matches_plain_and_jax(rng, radial):
    """K3's per-lane walk over each row's own window, written in torch,
    against the plain forward (out and lse, f32, a few ulps: sums in another
    order) and, gathered back by ``inv`` with invalid rows zeroed, against
    the JAX flash path in interpret mode (RTOL, ATOL as above), on the host
    geometry of ``test_pregeom_matches_jax_flash``."""
    g = 6
    ws = (4.0, 4.0, 4.0)
    coords, valid, q, k, v, (tq, tk, tv) = _inputs(rng, radial=radial)
    jax_geom, geom = _geoms(coords, valid, ws, tuple(w / g for w in ws), radial)
    b, vcap, h, d = q.shape
    sq, sk, sv = (torch.from_numpy(x).reshape(b * vcap, h, d)[geom.order] for x in (q, k, v))
    tq_, tk_, tv_ = map(torch.from_numpy, (tq, tk, tv))
    qT, kT = wattn.table_projections(sq, tq_), wattn.table_projections(sk, tk_)
    args = (sq, sk, sv, qT, kT, tv_, geom.rank, geom.quant, geom.r)
    out_s, lse = _lane_walk_fwd(*args, g, 0.5)
    ref_s, lse_ref = wattn.window_attention_rpe_fwd(*args, g, 0.5)
    torch.testing.assert_close(out_s, ref_s, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-6, atol=1e-6)
    ref = jax_pk.flash_pregeom_batched(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid), jax_geom,
        jnp.asarray(tq), jnp.asarray(tk), jnp.asarray(tv), grid_len=g, a=0.5,
        interpret=True)
    out = torch.where(torch.from_numpy(valid).reshape(-1)[:, None, None], out_s[geom.inv], 0.0)
    np.testing.assert_allclose(out.reshape(q.shape).numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
