"""The port's repeatable sums, on the CPU: each replaces an op that adds on
the card in a run-dependent order, and must equal it within rounding.

* ``ops/segment.segment_sum`` equals ``index_add_`` bitwise (the CPU's
  order is the sorted one), ``take`` equals indexing and its backward
  ``index_add_`` of the gradient rows, both pass ``gradcheck`` in f64;
* the plumbing's batched point-to-voxel mean and trilinear devoxelize
  (with the batch's plan kept on the map) equal the per-sample ops they
  replace, the U-Net's head and the stage-2 step's teacher-to-student
  gather equal ``torch.gather``, the transposed conv's slice pick equals
  ``gather``;
* the bilinear sampling's backward (``models/fusion._GridSample``) equals
  autograd's through ``F.grid_sample`` at 1e-6 and passes ``gradcheck`` in
  f64; the scatter-mean onto the image grids equals the ``index_add_``
  version; the SwiftNet's resize and adaptive pool take their gradients as
  torch's kernels do;
* the plain attention's sums (K2's and K3's plain forward, the plain
  backward's masses, the banded attention's bin masses) equal the
  ``index_add_`` / ``scatter_add_`` forms;
* building an image branch turns cuDNN's deterministic algorithms on and
  its autotuner off.
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from u2mkd_tpu_torch.data import synthetic
from u2mkd_tpu_torch.models import fusion, plumbing, swiftnet
from u2mkd_tpu_torch.ops import segment, spconv, voxelize, wattn
from u2mkd_tpu_torch.train import distill

# f32 sums in another order, relative to the largest entry
ROUNDING = 1e-6


def _close(got, want, tol=ROUNDING):
    got, want = got.detach(), want.detach()
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.fixture(autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def gen():
    return torch.Generator().manual_seed(0)


def _ids(gen, shape, lo, hi):
    return torch.randint(lo, hi, shape, generator=gen)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segment_sum_is_index_add(gen, dtype):
    """Sums by segment (ids out of range dropped, empty segments zero) and
    the counts: bitwise ``index_add_`` and ``bincount``."""
    x = torch.randn(2000, 7, generator=gen, dtype=dtype)
    ids = _ids(gen, (2000,), -5, 130)
    ok = (ids >= 0) & (ids < 120)
    want = torch.zeros(121, 7, dtype=dtype).index_add_(0, torch.where(ok, ids, 120), x)[:120]
    p = segment.plan(ids, 120)
    assert torch.equal(segment.segment_sum(x, p), want)
    assert torch.equal(segment.counts(p), torch.bincount(ids[ok], minlength=120))
    base = torch.randn(120, 7, generator=gen, dtype=dtype)
    _close(segment.index_add(base, ids.clamp(0, 119), x), base.index_add(0, ids.clamp(0, 119), x))


def test_take_and_its_backward(gen):
    """``take`` reads rows (zeros where an id is out of range) and its
    backward is ``index_add_`` of the gradient rows, with and without a
    plan sorted ahead; both directions pass ``gradcheck`` in f64."""
    x = torch.randn(50, 3, generator=gen, requires_grad=True)
    ids = _ids(gen, (40, 8), -3, 60)
    g = torch.randn(40, 8, 3, generator=gen)
    ok = (ids >= 0) & (ids < 50)
    want = torch.where(ok[..., None], x.detach()[ids.clamp(0, 49)], 0.0)
    want_grad = torch.zeros(51, 3).index_add_(0, torch.where(ok, ids, 50).reshape(-1),
                                              g.reshape(-1, 3))[:50]
    for p in (None, segment.plan(ids, 50)):
        out = segment.take(x, ids, p)
        assert torch.equal(out, want)
        (grad,) = torch.autograd.grad(out, x, g)
        assert torch.equal(grad, want_grad)
    x64 = torch.randn(50, 3, generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda t: segment.take(t, ids), (x64,))
    rows = torch.randn(40 * 8, 3, generator=gen, dtype=torch.float64, requires_grad=True)
    p = segment.plan(ids, 50)
    assert torch.autograd.gradcheck(lambda t: segment.segment_sum(t, p), (rows,))


def test_plumbing_point_maps_equal_the_per_sample_ops(gen):
    """The batched point-to-voxel mean and trilinear devoxelize, their plans
    kept on the maps: forward and gradients equal the per-sample
    ``index_add_`` mean and ``gather_rows``, and the plan is sorted once a
    batch."""
    b, pts, cap, c = 2, 300, 100, 5
    feats = torch.randn(b, pts, c, generator=gen, requires_grad=True)
    p2v = _ids(gen, (b, pts), -1, cap + 1).int()
    idx8 = _ids(gen, (b, pts, 8), -1, cap).int()
    w8 = torch.rand(b, pts, 8, generator=gen)
    vox = torch.randn(b, cap, c, generator=gen, requires_grad=True)

    def old_mean(f, m):
        seg = torch.where((m >= 0) & (m < cap), m, cap).long()
        sums = torch.zeros(cap + 1, c).index_add_(0, seg, f)[:cap]
        cnt = torch.zeros(cap + 1).index_add_(0, seg, torch.ones(len(seg)))[:cap]
        return sums / cnt.clamp(min=1)[:, None]

    def old_devox(v, i, w):
        g = torch.where((i >= 0)[..., None], v[i.long().clamp(min=0)], 0.0)
        return torch.einsum("pkc,pk->pc", g, torch.where(i >= 0, w, 0.0))

    got_m = plumbing.point_to_voxel(feats, p2v, cap)
    want_m = torch.stack([old_mean(f, m) for f, m in zip(feats, p2v)])
    got_d = plumbing.voxel_to_point(vox, idx8, w8)
    want_d = torch.stack([old_devox(v, i, w) for v, i, w in zip(vox, idx8, w8)])
    assert torch.equal(got_m, want_m)
    _close(got_d, want_d)
    gm, gd = torch.randn_like(want_m), torch.randn_like(want_d)
    for got, want, g in ((got_m, want_m, gm), (got_d, want_d, gd)):
        a = torch.autograd.grad(got, (feats, vox), g, allow_unused=True)
        r = torch.autograd.grad(want, (feats, vox), g, allow_unused=True)
        for x, y in zip(a, r):
            if y is not None:
                _close(x, y)
    assert plumbing.batch_plan(p2v, cap) is plumbing.batch_plan(p2v, cap)
    assert set(p2v._batch_plans) == {(cap, False)}


def test_row_gathers_equal_torch_gather(gen):
    """The gathers whose backward ``torch.gather`` took through
    ``scatter_add``: the stage-2 step's teacher-to-student rows (a missing
    teacher point reads row 0), the transposed conv's slice pick, and
    ``spconv.gather_rows``: values and gradients."""
    x = torch.randn(2, 30, 4, generator=gen, requires_grad=True)
    t2s = _ids(gen, (2, 50), -1, 30)
    want = torch.gather(x, 1, t2s.clamp(min=0)[..., None].expand(-1, -1, 4))
    got = distill._gather_t2s(x, t2s)
    assert torch.equal(got, want)
    g = torch.randn_like(want)
    _close(torch.autograd.grad(got, x, g)[0], torch.autograd.grad(want, x, g)[0])

    feats = torch.randn(20, 3, generator=gen, requires_grad=True)
    parent = _ids(gen, (60,), -1, 20).int()
    koff = _ids(gen, (60,), 0, 8).int()
    weight = torch.randn(8, 3, 5, generator=gen)
    got = spconv.sparse_conv_transposed_2x2(feats, parent, koff, weight)
    g8 = spconv.gather_rows(feats, parent) @ weight.permute(1, 0, 2).reshape(3, 40)
    want = g8.view(-1, 8, 5).gather(1, koff.long()[:, None, None].expand(-1, 1, 5))[:, 0]
    assert torch.equal(got, want)
    g = torch.randn_like(want)
    _close(torch.autograd.grad(got, feats, g)[0], torch.autograd.grad(want, feats, g)[0])


def test_grid_sample_backward_equals_autograd(gen):
    """``feature_gather``'s map gradient against autograd's through
    ``F.grid_sample`` (points inside, on and outside the map) at 1e-6 of
    its largest entry, the forward bitwise; ``gradcheck`` in f64."""
    fmap = torch.randn(2, 16, 36, 64, generator=gen, requires_grad=True)
    coords = torch.rand(2, 5000, 2, generator=gen) * 2.4 - 1.2
    coords[:, :10] = torch.tensor([-1.0, 1.0])[torch.randint(0, 2, (2, 10, 2), generator=gen)]
    g = torch.randn(2, 5000, 16, generator=gen)
    got = fusion.feature_gather(fmap, coords)
    want = F.grid_sample(fmap, coords[:, None], mode="bilinear", padding_mode="zeros",
                         align_corners=True)[:, :, 0].transpose(1, 2)
    assert torch.equal(got, want)
    a, = torch.autograd.grad(got, fmap, g)
    b, = torch.autograd.grad(want, fmap, g)
    assert float((a - b).abs().max() / b.abs().max()) <= 1e-6
    fm64 = torch.randn(2, 3, 7, 9, generator=gen, dtype=torch.float64, requires_grad=True)
    co64 = torch.rand(2, 30, 2, generator=gen, dtype=torch.float64) * 2.4 - 1.2
    assert torch.autograd.gradcheck(lambda t: fusion.feature_gather(t, co64), (fm64,))


def test_point_to_grid_equals_index_add(gen):
    """The scatter-mean onto each camera's pixel grid: bitwise the
    ``index_add_`` version it replaces, gradients included."""
    b, ncam, pts, c, h, w = 2, 3, 400, 6, 9, 16
    pfeats = torch.randn(b, pts, c, generator=gen, requires_grad=True)
    coords = torch.rand(b, ncam, pts, 2, generator=gen) * 2.2 - 1.1
    masks = torch.rand(b, ncam, pts, generator=gen) < 0.8

    def old(pf):
        u = torch.floor((coords[..., 0] + 1.0) * 0.5 * (w - 1)).long()
        v = torch.floor((coords[..., 1] + 1.0) * 0.5 * (h - 1)).long()
        ok = masks & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        drop = b * ncam * h * w
        base = torch.arange(b * ncam).reshape(b, ncam, 1) * (h * w)
        seg = torch.where(ok, base + v * w + u, drop)
        sums = pf.new_zeros(drop + 1, c)
        for bi in range(b):
            for ci in range(ncam):
                sums = sums.index_add(0, seg[bi, ci], pf[bi])
        counts = torch.bincount(seg.reshape(-1), minlength=drop + 1)
        grid = sums[:drop] / counts[:drop].clamp(min=1)[:, None].to(pf.dtype)
        return grid.reshape(b * ncam, h, w, c).permute(0, 3, 1, 2)

    got, want = fusion.point_to_grid(pfeats, coords, masks, (h, w)), old(pfeats)
    assert torch.equal(got, want)
    g = torch.randn_like(want)
    assert torch.equal(torch.autograd.grad(got, pfeats, g)[0],
                       torch.autograd.grad(want, pfeats, g)[0])


@pytest.mark.parametrize("op", ["resize", "pool"])
def test_swiftnet_resize_and_pool_gradients(gen, op):
    """The SwiftNet's align-corners resize and adaptive average pool: the
    forward bitwise torch's, the input gradient (two matrix products)
    within rounding of torch's kernels' at several sizes."""
    for (hi, wi), (ho, wo) in (((5, 7), (11, 16)), ((12, 20), (3, 5)), ((45, 80), (90, 160)),
                               ((6, 6), (1, 1))):
        x = torch.randn(2, 3, hi, wi, generator=gen, requires_grad=True)
        if op == "resize":
            got = swiftnet.resize_bilinear_align_corners(x, (ho, wo))
            want = F.interpolate(x, size=(ho, wo), mode="bilinear", align_corners=True)
        else:
            got = swiftnet.adaptive_avg_pool(x, (ho, wo))
            want = F.adaptive_avg_pool2d(x, (ho, wo))
        assert torch.equal(got, want)
        g = torch.randn_like(want)
        a, = torch.autograd.grad(got, x, g)
        b, = torch.autograd.grad(want, x, g)
        assert float((a - b).abs().max() / b.abs().max()) <= ROUNDING


@contextlib.contextmanager
def index_add_sums():
    """Inside, ``ops/segment``'s sums are ``index_add`` (the ops they
    replace)."""
    saved = segment.plan, segment.segment_sum, segment.index_add
    segment.plan = lambda ids, num: (ids.reshape(-1).long(), num)
    segment.segment_sum = lambda x, p: x.new_zeros((p[1],) + tuple(x.shape[1:])).index_add(
        0, p[0], x)
    segment.index_add = lambda base, ids, src: base.index_add(0, ids, src)
    try:
        yield
    finally:
        segment.plan, segment.segment_sum, segment.index_add = saved


def test_plain_attention_sums_equal_index_add(gen):
    """K2's and K3's plain forward and the plain backward (K4, K5) sum each
    window in a fixed order: against the same code with ``index_add`` sums
    they agree within rounding, on windows of 1 to 40 rows."""
    n, h, d, g_len, a = 96, 2, 4, 5, 0.0125
    l2 = 2 * g_len  # the radial axis bins up to 2 g - 1
    rank = torch.repeat_interleave(torch.arange(6), torch.tensor([1, 7, 30, 2, 40, 16]))
    q, k, v = (torch.randn(n, h, d, generator=gen) for _ in range(3))
    qT, kT = (torch.randn(n, h, 3, l2, generator=gen) for _ in range(2))
    tv = torch.randn(l2, 3, h, d, generator=gen)
    quant = _ids(gen, (n, 3), 0, g_len)
    r = torch.rand(n, generator=gen) * 10
    do = torch.randn(n, h, d, generator=gen)
    edo = torch.einsum("nhd,lahd->nhal", do, tv)

    def run():
        k2 = wattn.window_attention_plain(q, k, v, rank)
        out, lse = wattn.window_attention_rpe_fwd(q, k, v, qT, kT, tv, rank, quant, r, g_len, a)
        dfac = (do * out).sum(-1)
        bwd = wattn.window_attention_rpe_bwd(q, k, v, qT, kT, edo, rank, quant, r, lse, do,
                                             dfac, g_len, a)
        return (k2, out, lse, *bwd)

    got = run()
    with index_add_sums():
        want = run()
    for x, y in zip(got, want):
        _close(x, y)


def test_banded_bin_masses_equal_scatter_add(gen):
    """The banded attention's per-query bin masses m[i, l, h] = sum_j
    p_ij [bin_ij = l] (bins outside the table dropped): the sorted segment
    sum equals ``scatter_add_`` along the band."""
    n_t, tile, width, h, l2 = 2, 4, 12, 3, 7
    p = torch.rand(n_t, tile, width, h, generator=gen)
    b = _ids(gen, (n_t, tile, width), -2, l2 + 2)
    ok = (b >= 0) & (b < l2)
    idx = torch.where(ok, b, l2)[..., None].expand(-1, -1, -1, h)
    want = p.new_zeros(n_t, tile, l2 + 1, h).scatter_add_(2, idx, p)[:, :, :l2]
    qrow = torch.arange(n_t * tile).view(n_t, tile, 1, 1)
    flat = torch.where(ok[..., None], (qrow * l2 + b[..., None]) * h + torch.arange(h), -1)
    got = segment.segment_sum(p.reshape(-1), segment.plan(flat, n_t * tile * l2 * h))
    assert torch.equal(got.view(n_t, tile, l2, h), want)


def test_image_branch_build_sets_repeatable_convolutions():
    """Building an image branch asks cuDNN for its deterministic
    algorithms, without the autotuner."""
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    try:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, True
        swiftnet.SwiftNetResNet(generator=torch.Generator().manual_seed(0))
        assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def test_voxelize_mean_equals_index_add(gen):
    """The first voxelize's mean point features (f64, as the device build
    sums them): bitwise the ``index_add_`` mean."""
    raw = synthetic.make_batch(np.random.RandomState(3), 1, 512, voxel_size=0.3)
    pc = torch.as_tensor(raw["pcoords"][0])
    xyz = torch.as_tensor(raw["xyz"][0]).double()
    pm = torch.as_tensor(raw["pmask"][0])
    v0 = voxelize.voxelize_initial(pc, xyz, pm, 256)
    seg = torch.where(v0["p2v"] < 256, v0["p2v"], 256).long()
    sums = torch.zeros(257, 3, dtype=torch.float64).index_add_(0, seg, xyz)[:256]
    cnt = torch.zeros(257, dtype=torch.int32).index_add_(0, seg, torch.ones_like(seg).int())
    assert torch.equal(v0["vfeats"], sums / cnt[:256].clamp(min=1)[:, None].double())
