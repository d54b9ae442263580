"""The port's CUDA kernels against their plain versions, on a card.

Every test here is marked ``cuda`` and skips without a card. The file
imports nothing of JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` sets up JAX.) Tolerances are
relative to the largest plain output: f32 sums in another order; K1's bf16
output is rounded to bf16 after an f32 sum, so its two sides may land one
bf16 step apart. K1b, K4 and K5 return f32 computed in f32 from the same
inputs as their plain versions, so 1e-4 holds for bf16 inputs too.
"""

import numpy as np
import pytest
import torch

from u2mkd_tpu_torch.data import plumbing_host, synthetic, wgeom_host
from u2mkd_tpu_torch.models.plumbing import _window_geom_from_arrays
from u2mkd_tpu_torch.models.spvcnn import teacher_model
from u2mkd_tpu_torch.models.tsd import tsd_model
from u2mkd_tpu_torch.ops import wattn
from u2mkd_tpu_torch.ops.kernels import spconv_kernel, wattn_kernel
from u2mkd_tpu_torch.train import distill, optim, state


@pytest.fixture
def rng():
    return np.random.RandomState(0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(out, ref):
    ref = ref.float()
    return (out.float() - ref).abs().max().item() / ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_rulebook_conv_kernel_matches_plain(cuda_device, dtype, tol):
    """K1: every width class, a tail (V not a multiple of 64) and -1 / >= V
    rows."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for cin, cout in ((4, 32), (96, 96), (384, 256)):
        nbr = torch.randint(-1, 1010, (1, 27, 1000), device=cuda_device, generator=gen,
                            dtype=torch.int32)
        x = torch.randn(1, 1000, cin, device=cuda_device, generator=gen).to(dtype)
        w = (torch.randn(27, cin, cout, device=cuda_device, generator=gen)
             * (27 * cin) ** -0.5).to(dtype)
        before = spconv_kernel.rulebook_conv.launches
        out = spconv_kernel.rulebook_conv(x, w, nbr)
        assert spconv_kernel.rulebook_conv.launches == before + 1
        ref = spconv_kernel.rulebook_conv_plain(x, w, nbr)
        assert _rel_err(out, ref) <= tol, (cin, cout)
    with pytest.raises(ValueError):
        spconv_kernel.rulebook_conv(x, w, nbr[:, :9])
    with pytest.raises(TypeError):
        spconv_kernel.rulebook_conv(x.half(), w.half(), nbr)


@pytest.mark.cuda
@pytest.mark.parametrize("radial", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_matches_plain(rng, cuda_device, radial, dtype):
    """K3 on real host geometry, windows of up to hundreds of keys. Both
    sides compute in f32 from the same (bf16 or f32) window-sorted q/k/v and
    return f32, so they differ only in summation order. The model's entry
    gathers back by ``inv`` and zeroes invalid rows."""
    b, v, h, d, g = 2, 700, 4, 16, 6
    ws = (30.0, 30.0, 120.0) if radial else (4.0, 4.0, 4.0)
    qs = tuple(w / g for w in ws)
    xyz = rng.uniform(-8, 8, (b, v, 3)).astype(np.float32)
    valid = rng.rand(b, v) < 0.9
    coords = np.stack([wgeom_host.cart2sphere(x) for x in xyz]) if radial else xyz
    geom = _window_geom_from_arrays(
        wgeom_host.branch_geometry(coords, valid, ws, qs, 128, radial), cuda_device)
    q, k, vv = (torch.from_numpy(rng.randn(b, v, h, d).astype(np.float32) * 0.3)
                .to(cuda_device, dtype) for _ in range(3))
    l2 = 2 * g if radial else 2 * g - 1
    tq, tk, tv = (torch.from_numpy(rng.randn(l2, 3, h, d).astype(np.float32) * 0.05)
                  .to(cuda_device) for _ in range(3))
    sq, sk, sv = (t.reshape(b * v, h, d)[geom.order].contiguous() for t in (q, k, vv))
    k3 = wattn_kernel.flash_rpe_fwd
    before = k3.launches
    out_s = wattn_kernel.flash_rpe_sorted(sq, sk, sv, geom.rank, geom.quant, geom.r,
                                          geom.kmin, geom.kmax, tq, tk, tv, g, 0.5)
    assert k3.launches == before + 1
    assert out_s.dtype == torch.float32
    ref = wattn_kernel.flash_rpe_sorted_plain(sq, sk, sv, geom.rank, geom.quant, geom.r,
                                              tq, tk, tv, g, 0.5)
    assert _rel_err(out_s, ref) <= 1e-4
    # the log-sum-exp K3 writes for the backward
    qT, kT = wattn.table_projections(sq, tq), wattn.table_projections(sk, tk)
    _, lse = k3(sq, sk, sv, qT, kT, tv, geom.rank, geom.quant, geom.r, geom.kmin, geom.kmax,
                g, 0.5)
    _, lse_ref = wattn_kernel.flash_rpe_fwd_plain(sq, sk, sv, qT, kT, tv, geom.rank,
                                                  geom.quant, geom.r, g, 0.5)
    assert (lse - lse_ref).abs().max().item() <= 1e-5 * lse_ref.abs().max().item()

    mask = torch.from_numpy(valid).to(cuda_device)
    out = wattn_kernel.flash_pregeom_batched(q, k, vv, mask, geom, tq, tk, tv, g, 0.5)
    assert k3.launches == before + 3
    assert out.dtype == dtype
    assert (out[~mask] == 0).all()
    back = out_s[geom.inv].to(dtype).reshape(b, v, h, d)
    assert torch.equal(out[mask], back[mask])


@pytest.mark.cuda
def test_eval_step_kernels_match_plain(cuda_device):
    """The teacher's eval step at a small size: 34 K1 and 8 K3 launches per
    forward, and the same logits as the plain versions on the card."""
    caps = (2048, 1024, 512, 256, 128)
    model = teacher_model(num_classes=17, cr=1.0, voxel_size=0.2, head_dim=16,
                          device=cuda_device)
    raw = synthetic.make_batch(np.random.RandomState(4), 1, 4096, voxel_size=0.2)
    raw["plumbing"] = plumbing_host.batch_plumbing(
        raw["pcoords"], raw["xyz"], raw["pmask"], caps,
        wgeom_params=wgeom_host.params_from_model(model))
    eval_fn = state.make_eval_step(model, caps, 17)
    k1, k3 = spconv_kernel.rulebook_conv, wattn_kernel.flash_rpe_fwd
    before = (k1.launches, k3.launches)
    out = eval_fn(raw)
    assert (k1.launches - before[0], k3.launches - before[1]) == (34, 8)
    model.set_plain(True)
    try:
        ref = eval_fn(raw)
    finally:
        model.set_plain(False)
    assert (k1.launches - before[0], k3.launches - before[1]) == (34, 8)
    valid = torch.from_numpy(raw["pmask"]).to(cuda_device)
    assert torch.isfinite(out["logits"]).all()
    assert _rel_err(out["logits"][valid], ref["logits"][valid]) <= 1e-4
    assert (out["pred"] == ref["pred"])[valid].float().mean().item() >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_kernel_matches_plain(rng, cuda_device, dtype):
    """K2 through its entry ``sparse_window_attention_flash`` against the
    plain version on the same inputs: a skewed layout (one window of 3000
    rows, so its tiles' key ranges span ~50 chunks, then single-row
    windows) and random cubic and radial windows, every head dim. Both sides
    compute in f32 from the same inputs and return f32: 1e-4 of the largest
    output."""
    v = 6000
    skew = np.zeros((v, 3), np.float32)
    skew[:3000] = 0.1
    skew[3000:] = np.arange(3000)[:, None] * [2.0, 0, 0] + 10
    rand = rng.uniform(-8, 8, (v, 3)).astype(np.float32)
    cases = [(skew, (1.0, 1.0, 1.0), 16), (rand, (2.0, 2.0, 2.0), 4), (rand, (2.0, 2.0, 2.0), 8),
             (wattn.cart2sphere(torch.from_numpy(rand)).numpy(), (20.0, 20.0, 120.0), 32)]
    k2 = wattn_kernel.flash_window_sorted
    for xyz, ws, d in cases:
        q, k, vv = (torch.from_numpy(rng.randn(v, 2, d).astype(np.float32))
                    .to(cuda_device, dtype) for _ in range(3))
        valid = torch.from_numpy(rng.rand(v) < 0.9).to(cuda_device)
        pos = torch.from_numpy(xyz).to(cuda_device)
        before = k2.launches
        out = wattn_kernel.sparse_window_attention_flash(q, k, vv, pos, valid, ws)
        assert k2.launches == before + 1
        ref = wattn_kernel.sparse_window_attention_flash(q, k, vv, pos, valid, ws, plain=True)
        assert k2.launches == before + 1
        assert out.dtype == torch.float32 and out.shape == (v, 2, d)
        assert (out[~valid] == 0).all()
        assert _rel_err(out, ref) <= 1e-4, (ws, d)
    with pytest.raises(ValueError):
        k2(q[:100], k[:100], vv[:100], valid.int()[:100], valid.int()[:1], valid.int()[:1])


@pytest.mark.cuda
def test_student_eval_step_kernels_match_plain(cuda_device):
    """The stage-2 student's eval step at a small size (P=4096, 2 cameras at
    72x128), without and with the cr_t=2.0 teacher: 34 K1 and 8 K3 launches
    per student forward (68 and 16 with the teacher), and the same logits
    and predictions as the plain versions on the card, the teacher's too.
    The L2C scatter sums
    with atomics in no fixed order, so predictions agree to 99.9%, logits
    to 1e-4 of the largest."""
    s_caps = (4096, 2048, 1024, 512, 256)
    t_caps = (8192, 4096, 2048, 1024, 512)
    model = tsd_model(num_classes=17, cr=1.0, cr_t=2.0, voxel_size=0.05, device=cuda_device)
    raw = synthetic.make_multimodal_batch(np.random.RandomState(4), 1, 4096, 8192,
                                          voxel_size=0.05, num_cams=2, im_hw=(72, 128))
    valid = torch.from_numpy(raw["student"]["pmask"]).to(cuda_device)
    fov = valid & torch.from_numpy(raw["student"]["fov_mask"]).to(cuda_device)
    t_valid = torch.from_numpy(raw["teacher"]["pmask"]).to(cuda_device)
    k1, k3 = spconv_kernel.rulebook_conv, wattn_kernel.flash_rpe_fwd
    for run_teacher, want in ((False, (34, 8)), (True, (68, 16))):
        eval_fn = distill.make_distill_eval_step(model, s_caps, t_caps, 17,
                                                 run_teacher=run_teacher)
        before = (k1.launches, k3.launches)
        out = eval_fn(raw)
        assert (k1.launches - before[0], k3.launches - before[1]) == want
        model.set_plain(True)
        try:
            ref = eval_fn(raw)
        finally:
            model.set_plain(False)
        assert (k1.launches - before[0], k3.launches - before[1]) == want
        heads = [("logits", valid), ("logits_pix", fov)]
        if run_teacher:
            heads.append(("logits_teacher", t_valid))
        for key, rows in heads:
            assert torch.isfinite(out[key]).all()
            assert _rel_err(out[key][rows], ref[key][rows]) <= 1e-4, key
            agree = (out[key].argmax(-1) == ref[key].argmax(-1))[rows].float().mean().item()
            assert agree >= 0.999, key
        assert ("counts_teacher" in out) == run_teacher
        assert ("logits_teacher" in out) == run_teacher


def _small_case(rng, cuda_device, radial, dtype, b=2, v=700, h=4, d=16, g=6):
    """Real host geometry with windows of up to hundreds of keys, some pad
    rows (b * v is not a multiple of 128), q/k/v in ``dtype``."""
    ws = (30.0, 30.0, 120.0) if radial else (4.0, 4.0, 4.0)
    qs = tuple(w / g for w in ws)
    xyz = rng.uniform(-8, 8, (b, v, 3)).astype(np.float32)
    valid = rng.rand(b, v) < 0.9
    coords = np.stack([wgeom_host.cart2sphere(x) for x in xyz]) if radial else xyz
    geom = _window_geom_from_arrays(
        wgeom_host.branch_geometry(coords, valid, ws, qs, 128, radial), cuda_device)
    q, k, vv = (torch.from_numpy(rng.randn(b, v, h, d).astype(np.float32) * 0.3)
                .to(cuda_device, dtype) for _ in range(3))
    l2 = 2 * g if radial else 2 * g - 1
    tables = [torch.from_numpy(rng.randn(l2, 3, h, d).astype(np.float32) * 0.05)
              .to(cuda_device) for _ in range(3)]
    mask = torch.from_numpy(valid).to(cuda_device)
    return geom, mask, (q, k, vv), tables, g


@pytest.mark.cuda
@pytest.mark.parametrize("radial", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_kernels_match_plain(rng, cuda_device, radial, dtype):
    """K4 and K5 against the plain backward on the same sorted inputs, the
    forward's lse and a random output gradient: every output to 1e-4 of its
    largest entry."""
    geom, _, (q, k, vv), (tq, tk, tv), g = _small_case(rng, cuda_device, radial, dtype)
    n = geom.order.shape[0]
    h, d = q.shape[2:]
    sq, sk, sv = (t.reshape(-1, h, d)[geom.order].contiguous() for t in (q, k, vv))
    qT, kT = wattn.table_projections(sq, tq), wattn.table_projections(sk, tk)
    geo = (geom.rank, geom.quant, geom.r)
    out, lse = wattn_kernel.flash_rpe_fwd(sq, sk, sv, qT, kT, tv, *geo, geom.kmin, geom.kmax,
                                          g, 0.5)
    do = torch.randn(n, h, d, device=cuda_device,
                     generator=torch.Generator(device=cuda_device).manual_seed(3))
    args = (sq, sk, sv, qT, kT, wattn.table_projections(do, tv), *geo, lse, do,
            (do * out).sum(-1))
    k4, k5 = wattn_kernel.flash_rpe_bwd_q, wattn_kernel.flash_rpe_bwd_k
    before = (k4.launches, k5.launches)
    dq, mq, pm = k4(*args, geom.kmin, geom.kmax, g, 0.5)
    dk, dv, mk = k5(*args, geom.kmin, geom.kmax, g, 0.5)
    assert (k4.launches, k5.launches) == (before[0] + 1, before[1] + 1)
    ref = wattn_kernel.flash_rpe_bwd_plain(*args, g, 0.5)
    for name, got, want in zip(("dq", "dk", "dv", "mq", "mk", "pm"),
                               (dq, dk, dv, mq, mk, pm), ref):
        assert got.dtype == torch.float32 and got.shape == want.shape, name
        assert _rel_err(got, want) <= 1e-4, name


@pytest.mark.cuda
@pytest.mark.parametrize("radial", [False, True])
def test_flash_rpe_grads_match_autograd(rng, cuda_device, radial):
    """FlashRPE through the model's entry on the card (K3, K4, K5) against
    autograd through the plain forward: the gradients of q, k, v and the
    three tables, and exact zeros on the pad rows of the sorted inputs."""
    geom, mask, qkv, tables, g = _small_case(rng, cuda_device, radial, torch.float32)
    w_out = torch.randn_like(qkv[0])

    def grads(plain):
        leaves = [t.detach().clone().requires_grad_() for t in (*qkv, *tables)]
        out = wattn_kernel.flash_pregeom_batched(*leaves[:3], mask, geom, *leaves[3:], g, 0.5,
                                                 plain=plain)
        (out * w_out).sum().backward()
        return [t.grad for t in leaves]

    before = (wattn_kernel.flash_rpe_bwd_q.launches, wattn_kernel.flash_rpe_bwd_k.launches)
    got = grads(False)
    assert (wattn_kernel.flash_rpe_bwd_q.launches, wattn_kernel.flash_rpe_bwd_k.launches) == \
        (before[0] + 1, before[1] + 1)
    for name, a_, b_ in zip(("q", "k", "v", "tq", "tk", "tv"), got, grads(True)):
        # mass bins cancel (sum_j ds_ij = 0): 1e-4 of each gradient's scale
        assert _rel_err(a_, b_) <= 1e-4, name

    # pads of the sorted order (they point at row 0) get exactly zero
    h, d = qkv[0].shape[2:]
    pad = torch.ones(geom.order.shape[0], dtype=torch.bool, device=cuda_device)
    pad[geom.inv] = False
    assert pad.any()
    sorted_ = [t.reshape(-1, h, d)[geom.order].contiguous().requires_grad_() for t in qkv]
    out_s = wattn_kernel.flash_rpe_sorted(*sorted_, geom.rank, geom.quant, geom.r, geom.kmin,
                                          geom.kmax, *tables, g, 0.5)
    (out_s[geom.inv] * w_out.reshape(-1, h, d)).sum().backward()
    for t in sorted_:
        assert torch.count_nonzero(t.grad[pad]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rulebook_conv_backward_kernels_match_plain(cuda_device, dtype):
    """K1b (every width class, B=2, rows -1 and >= V) against the plain
    gather-einsum, and K1 as the input gradient against the plain conv with
    the reversed weights; each counts its own launches."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    dx_tol = 1e-4 if dtype == torch.float32 else 1e-2
    for cin, cout in ((4, 32), (96, 96), (384, 256)):
        nbr = torch.randint(-1, 1010, (2, 27, 1000), device=cuda_device, generator=gen,
                            dtype=torch.int32)
        x = torch.randn(2, 1000, cin, device=cuda_device, generator=gen).to(dtype)
        g = torch.randn(2, 1000, cout, device=cuda_device, generator=gen).to(dtype)
        w = (torch.randn(27, cin, cout, device=cuda_device, generator=gen)
             * (27 * cin) ** -0.5).to(dtype)
        dw, dx = spconv_kernel.rulebook_conv_dw, spconv_kernel.rulebook_conv_dx
        before = (dw.launches, dx.launches)
        gw = dw(x, g, nbr)
        gx = dx(g, w, nbr)
        assert (dw.launches, dx.launches) == (before[0] + 1, before[1] + 1)
        assert gw.dtype == torch.float32 and gw.shape == (27, cin, cout)
        assert _rel_err(gw, spconv_kernel.rulebook_conv_dw_plain(x, g, nbr)) <= 1e-4, (cin, cout)
        ref = spconv_kernel.rulebook_conv_plain(g, spconv_kernel.reversed_weights(w), nbr)
        assert _rel_err(gx, ref) <= dx_tol, (cin, cout)


def _conv_case(case, dtype, device):
    """(x, g, w, nbr) of one edge case of K1 and K1b: widths that are no
    multiple of a tile (Cin 40, Cout 72) with V = 1000 (no multiple of 64
    rows) and B=2; a rulebook with every row absent; Cout 512 (two K1
    tiles, four K1b tiles); and a real host rulebook (B=2, mask-sorted
    tiles of many offsets)."""
    gen = torch.Generator(device=device).manual_seed(5)
    b, v, cin, cout = {"narrow": (2, 1000, 40, 72), "absent": (1, 300, 32, 64),
                       "wide": (1, 700, 64, 512), "host": (2, 2048, 96, 64)}[case]
    if case == "host":
        raw = synthetic.make_batch(np.random.RandomState(7), b, 4096, voxel_size=0.2)
        pl = plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"],
                                          (2048, 1024, 512, 256, 128))
        nbr = torch.from_numpy(pl["nbr27"][0]).to(device)
    else:
        nbr = torch.randint(-1, v + 10, (b, 27, v), device=device, generator=gen,
                            dtype=torch.int32)
        if case == "absent":
            nbr.fill_(-1)
    x = torch.randn(b, v, cin, device=device, generator=gen).to(dtype)
    g = torch.randn(b, v, cout, device=device, generator=gen).to(dtype)
    w = (torch.randn(27, cin, cout, device=device, generator=gen) * (27 * cin) ** -0.5).to(dtype)
    return x, g, w, nbr


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["narrow", "absent", "wide", "host"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rulebook_conv_kernel_edge_cases(cuda_device, dtype, case):
    """K1, K1 as dX and K1b on one plan against their plain versions; an
    absent rulebook gives exact zeros."""
    x, g, w, nbr = _conv_case(case, dtype, cuda_device)
    plan = spconv_kernel.conv_plan(nbr)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    out = spconv_kernel.rulebook_conv(x, w, nbr, plan)
    gx = spconv_kernel.rulebook_conv_dx(g, w, nbr, plan)
    gw = spconv_kernel.rulebook_conv_dw(x, g, nbr, plan)
    if case == "absent":
        assert not out.any() and not gx.any() and not gw.any()
        return
    assert _rel_err(out, spconv_kernel.rulebook_conv_plain(x, w, nbr)) <= tol
    ref = spconv_kernel.rulebook_conv_plain(g, spconv_kernel.reversed_weights(w), nbr)
    assert _rel_err(gx, ref) <= tol
    assert _rel_err(gw, spconv_kernel.rulebook_conv_dw_plain(x, g, nbr)) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rulebook_conv_kernels_deterministic(cuda_device, dtype):
    """Two launches of K1 and two of K1b give bitwise the same result: K1
    writes each row once, K1b sums its row ranges in a fixed order."""
    x, g, w, nbr = _conv_case("host", dtype, cuda_device)
    for fn, args in ((spconv_kernel.rulebook_conv, (x, w, nbr)),
                     (spconv_kernel.rulebook_conv_dw, (x, g, nbr))):
        assert torch.equal(fn(*args), fn(*args)), fn.__name__


@pytest.mark.cuda
def test_rulebook_conv_grads_match_autograd(cuda_device):
    """RulebookConv on the card, on a real (symmetric) host rulebook, against
    autograd through the plain forward."""
    raw = synthetic.make_batch(np.random.RandomState(6), 2, 4096, voxel_size=0.2)
    pl = plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"],
                                      (4096, 2048, 1024, 512, 256))
    nbr = torch.from_numpy(pl["nbr27"][0]).to(cuda_device)
    vmask = torch.from_numpy(pl["vmask"][0]).to(cuda_device, torch.bool)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.where(vmask[..., None], torch.randn(2, 4096, 64, device=cuda_device,
                                                  generator=gen), 0.0)
    w = torch.randn(27, 64, 48, device=cuda_device, generator=gen) * (27 * 64) ** -0.5
    g = torch.randn(2, 4096, 48, device=cuda_device, generator=gen)

    def grads(fn):
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        (fn(xl, wl, nbr) * g).sum().backward()
        return xl.grad, wl.grad

    got = grads(spconv_kernel.RulebookConv.apply)
    ref = grads(spconv_kernel.rulebook_conv_plain)
    for a_, b_ in zip(got, ref):
        assert _rel_err(a_, b_) <= 1e-4


@pytest.mark.cuda
def test_train_step_kernels_match_plain(cuda_device):
    """The teacher's train step at a small size: the launches of every
    kernel per step, and a finite loss equal to that of one step through
    the plain versions (same weights, same generator seed, so the same
    dropout masks). The kernels' gradients are held to their plain versions
    by the tests above, and per launch of a full-size step by
    ``chip_smoke.py``."""
    caps = (2048, 1024, 512, 256, 128)
    raw = synthetic.make_batch(np.random.RandomState(4), 1, 4096, voxel_size=0.2)
    losses = []
    for plain in (False, True):
        model = teacher_model(num_classes=17, cr=1.0, voxel_size=0.2, head_dim=16, seed=3,
                              device=cuda_device)
        model.set_plain(plain)
        opt, _ = optim.make_optimizer(model.named_parameters(), "sgd_spformer", 0.02)
        gen = torch.Generator(device=cuda_device).manual_seed(9)
        step_fn = state.make_train_step(model, opt, caps, generator=gen)
        if "plumbing" not in raw:
            raw["plumbing"] = plumbing_host.batch_plumbing(
                raw["pcoords"], raw["xyz"], raw["pmask"], caps,
                wgeom_params=wgeom_host.params_from_model(model))
        counters = (spconv_kernel.rulebook_conv, spconv_kernel.rulebook_conv_dx,
                    spconv_kernel.rulebook_conv_dw, wattn_kernel.flash_rpe_fwd,
                    wattn_kernel.flash_rpe_bwd_q, wattn_kernel.flash_rpe_bwd_k)
        before = [c.launches for c in counters]
        losses.append(step_fn(raw)["loss"].item())
        launched = [c.launches - b for c, b in zip(counters, before)]
        assert launched == ([0] * 6 if plain else [34, 33, 34, 8, 8, 8])
    assert np.isfinite(losses[0])
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1])


def _bwd_inputs(rank, quant, r, h, d, g, dtype, device, seed=0):
    """The twelve inputs K4 and K5 take (as ``FlashRPE.backward`` builds
    them: K3's lse, a random output gradient) over window-sorted rows with
    geometry rank, quant, r."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n = rank.shape[0]
    l2 = 2 * g if r is not None else 2 * g - 1
    q, k, v = (torch.randn(n, h, d, device=device, generator=gen).mul(s).to(dtype)
               for s in (d ** -0.5, 1.0, 1.0))
    tq, tk, tv = (0.02 * torch.randn(l2, 3, h, d, device=device, generator=gen)
                  for _ in range(3))
    qT, kT = wattn.table_projections(q, tq), wattn.table_projections(k, tk)
    out, lse = wattn_kernel.flash_rpe_fwd_plain(q, k, v, qT, kT, tv, rank, quant, r, g, 0.0125)
    do = torch.randn(n, h, d, device=device, generator=gen)
    return (q, k, v, qT, kT, wattn.table_projections(do, tv), rank, quant, r, lse, do,
            (do * out).sum(-1))


def _bwd_matches_plain(args, kmin, kmax, g, a=0.0125):
    k4, k5 = wattn_kernel.flash_rpe_bwd_q, wattn_kernel.flash_rpe_bwd_k
    before = (k4.launches, k5.launches)
    got = k4(*args, kmin, kmax, g, a) + k5(*args, kmin, kmax, g, a)
    assert (k4.launches, k5.launches) == (before[0] + 1, before[1] + 1)
    dq, mq, pm, dk, dv, mk = got
    ref = wattn_kernel.flash_rpe_bwd_plain(*args, g, a)
    for name, out, want in zip(("dq", "dk", "dv", "mq", "mk", "pm"),
                               (dq, dk, dv, mq, mk, pm), ref):
        assert out.dtype == torch.float32 and out.shape == want.shape, name
        assert torch.isfinite(out).all(), name
        assert _rel_err(out, want) <= 1e-4, name


def _host_level1(device, radial):
    """Level 1 of a teacher's host geometry (cr=1.0, G=24) on a synthetic
    scan of 131072 points: windows of up to hundreds of rows on the sphere
    branch, windows across tile bounds, pad rows."""
    model = teacher_model(num_classes=17, cr=1.0, voxel_size=0.1, head_dim=16, device="cpu")
    raw = synthetic.make_batch(np.random.RandomState(11), 1, 131072, voxel_size=0.1)
    pl = plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"],
                                      (131072, 65536, 32768, 16384, 8192),
                                      wgeom_params=wgeom_host.params_from_model(model))
    geo = pl["wgeom"]["sphere" if radial else "cubic"][0]
    return (_window_geom_from_arrays(geo, device),
            int(np.asarray(pl["vmask"][1]).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("radial", [False, True])
def test_attention_backward_kernels_host_geometry(cuda_device, radial):
    """K4 and K5 against the plain backward on the teacher's level-1 host
    geometry at G=24 (h=2, d=16): every output to 1e-4 of its largest
    entry."""
    geom, n_valid = _host_level1(cuda_device, radial)
    n = geom.rank.shape[0]
    counts = wattn_kernel.walk_counts(geom.rank, geom.kmin, geom.kmax)
    start, end, _ = wattn_kernel.warp_run_bounds(geom.rank)
    assert n > n_valid                                  # pad and invalid rows
    assert bool(((start // 128) != ((end - 1) // 128)).any())  # windows across tiles
    if radial:
        assert counts["occupancy_max"] > 128
    args = _bwd_inputs(geom.rank, geom.quant, geom.r, 2, 16, 24, torch.float32, cuda_device)
    _bwd_matches_plain(args, geom.kmin, geom.kmax, 24)


def _edge_geometry(case, radial, device, g=24):
    """(rank, quant, r, kmin, kmax, h, d, dtype) of one edge case: one window
    of all N rows; windows of 1-300 rows at D = 4, at D = 32, at h = 8, and
    with bf16 q/k/v."""
    rng = np.random.RandomState(9)
    n = 512 if case == "one_window" else 2048
    if case == "one_window":
        ids = np.zeros(n)
    else:
        ids = np.repeat(np.arange(n), rng.choice([1, 2, 5, 40, 150, 300], n))[:n]
    rank = torch.from_numpy(ids.astype(np.float32)).to(device)
    quant = torch.from_numpy(rng.randint(-1, g + 1, (n, 3)).astype(np.int32)).to(device)
    r = torch.from_numpy(rng.rand(n).astype(np.float32) * 3).to(device) if radial else None
    start, end = wattn.run_bounds(wattn.window_starts(rank))
    kmin = start[::128].contiguous()
    kmax = torch.maximum(end[127::128], kmin + 1).contiguous()
    h, d, dtype = {"one_window": (2, 16, torch.float32), "d4": (2, 4, torch.float32),
                   "d32": (2, 32, torch.float32), "h8": (8, 16, torch.float32),
                   "bf16": (2, 16, torch.bfloat16)}[case]
    return rank, quant, r, kmin, kmax, h, d, dtype


@pytest.mark.cuda
@pytest.mark.parametrize("radial", [False, True])
@pytest.mark.parametrize("case", ["one_window", "d4", "d32", "h8", "bf16"])
def test_attention_backward_kernels_edge_cases(cuda_device, case, radial):
    """K4 and K5 against the plain backward: a window of all N rows (every
    warp scans back to row 0 and on to row N), head dims 4 and 32, 8 heads,
    bf16 inputs; coordinates outside [0, G) exercise the clipping."""
    rank, quant, r, kmin, kmax, h, d, dtype = _edge_geometry(case, radial, cuda_device)
    args = _bwd_inputs(rank, quant, r, h, d, 24, dtype, cuda_device)
    _bwd_matches_plain(args, kmin, kmax, 24)


@pytest.mark.cuda
@pytest.mark.parametrize("radial", [False, True])
def test_attention_backward_kernels_deterministic(cuda_device, radial):
    """Two launches of K4, and two of K5, on the same inputs give bitwise the
    same outputs: each sum is taken by the lane that owns its row, in key
    order, with no atomics."""
    geom, _ = _host_level1(cuda_device, radial)
    args = _bwd_inputs(geom.rank, geom.quant, geom.r, 1, 16, 24, torch.float32, cuda_device)
    for fn in (wattn_kernel.flash_rpe_bwd_q, wattn_kernel.flash_rpe_bwd_k):
        first = fn(*args, geom.kmin, geom.kmax, 24, 0.0125)
        second = fn(*args, geom.kmin, geom.kmax, 24, 0.0125)
        for a_, b_ in zip(first, second):
            assert torch.equal(a_, b_), fn.__name__


@pytest.mark.cuda
def test_attention_backward_occupancy(cuda_device):
    """The launch's shared bytes and resident warps per SM at G=24, d=16,
    beside the L1 its carveout leaves: at least 6 warps for K4 and 12 for K5
    on both branches, f32 and bf16."""
    for radial in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            q = wattn_kernel.window_attention_occupancy("wattn_rpe_bwd_q", dtype, 16, 24, radial)
            k = wattn_kernel.window_attention_occupancy("wattn_rpe_bwd_k", dtype, 16, 24, radial)
            assert q["warps_per_sm"] >= 6 and k["warps_per_sm"] >= 12, (radial, dtype, q, k)
            assert 0 < k["smem_bytes"] < q["smem_bytes"] < 48 * 1024


# K3 and K2 walk each row's own window (one warp per block, one row per
# lane): layouts of window sizes that put runs across warp and tile bounds
FWD_EDGE_CASES = {
    "warp_cross": (256, [20, 30, 17, 45, 9]),   # runs across 32-row warps
    "long": (1024, [40, 150, 300, 1, 2]),      # longer than 32 and than 128
    "one_window": (512, None),                 # one window of all N rows
    "singletons": (256, [1]),
    "n32": (32, [1, 3, 7, 9]),
    "n160": (160, [5, 37, 70, 2]),             # N a multiple of 32, not of 128
}


def _fwd_edge_rank(case, device):
    """Window-sorted rank [N] (float32) of one of FWD_EDGE_CASES, with the
    per-128-row key ranges of its tiles (the last tile may be short)."""
    n, sizes = FWD_EDGE_CASES[case]
    if sizes is None:
        ids = np.zeros(n)
    else:
        ids = np.repeat(np.arange(n), np.resize(sizes, n))[:n]
    rank = torch.from_numpy(ids.astype(np.float32)).to(device)
    start, end = wattn.run_bounds(wattn.window_starts(rank))
    first = torch.arange(0, n, 128, device=device)
    kmin = start[first].contiguous()
    kmax = torch.maximum(end[(first + 127).clamp(max=n - 1)], kmin + 1).contiguous()
    return rank, kmin, kmax


def _fwd_inputs(rank, radial, h, d, g, dtype, device, seed=0):
    """K3's inputs over window-sorted rows of rank: q, k, v, qT, kT, tv,
    rank, quant (coordinates in [-1, G], so clipping counts), r."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n = rank.shape[0]
    l2 = 2 * g if radial else 2 * g - 1
    q, k, v = (torch.randn(n, h, d, device=device, generator=gen).mul(s).to(dtype)
               for s in (d ** -0.5, 1.0, 1.0))
    tq, tk, tv = (0.02 * torch.randn(l2, 3, h, d, device=device, generator=gen)
                  for _ in range(3))
    quant = torch.randint(-1, g + 1, (n, 3), device=device, generator=gen, dtype=torch.int32)
    r = torch.rand(n, device=device, generator=gen) * 3 if radial else None
    return (q, k, v, wattn.table_projections(q, tq), wattn.table_projections(k, tk), tv,
            rank, quant, r)


@pytest.mark.cuda
@pytest.mark.parametrize("radial", [False, True])
@pytest.mark.parametrize("case", sorted(FWD_EDGE_CASES))
def test_attention_forward_kernel_edge_cases(cuda_device, case, radial):
    """K3 against its plain version (out and lse, f32 and bf16 q/k/v) on
    windows across warp bounds, longer than a warp and a tile, one window of
    all N rows, all windows of one row, and N = 32 and 160."""
    rank, kmin, kmax = _fwd_edge_rank(case, cuda_device)
    k3 = wattn_kernel.flash_rpe_fwd
    for dtype in (torch.float32, torch.bfloat16):
        args = _fwd_inputs(rank, radial, 2, 16, 24, dtype, cuda_device)
        before = k3.launches
        out, lse = k3(*args, kmin, kmax, 24, 0.0125)
        assert k3.launches == before + 1
        ref, lse_ref = wattn_kernel.flash_rpe_fwd_plain(*args, 24, 0.0125)
        assert out.dtype == torch.float32 and out.shape == ref.shape
        assert torch.isfinite(out).all() and torch.isfinite(lse).all()
        assert _rel_err(out, ref) <= 1e-4, dtype
        assert (lse - lse_ref).abs().max().item() <= 1e-5 * lse_ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FWD_EDGE_CASES))
def test_window_kernel_edge_cases(cuda_device, case):
    """K2 on int32 ranks against its plain version, f32 and bf16, every head
    dim, on the layouts of the K3 edge cases; a pad run at PAD_RANK closes
    the long case."""
    rank, kmin, kmax = _fwd_edge_rank(case, cuda_device)
    rank = rank.int()
    if case == "long":
        rank[-100:] = wattn_kernel.PAD_RANK
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    k2 = wattn_kernel.flash_window_sorted
    for d in wattn_kernel.HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(rank.shape[0], 3, d, device=cuda_device, generator=gen)
                       .to(dtype) for _ in range(3))
            before = k2.launches
            out = k2(q, k, v, rank, kmin, kmax)
            assert k2.launches == before + 1
            ref = wattn_kernel.flash_window_sorted_plain(q, k, v, rank)
            assert out.dtype == torch.float32 and torch.isfinite(out).all()
            assert _rel_err(out, ref) <= 1e-4, (d, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("radial", [False, True])
def test_forward_kernels_deterministic(cuda_device, radial):
    """Two launches of K3 on the teacher's level-1 host geometry, and two of
    K2 on its long-window layout, give bitwise the same outputs: each row's
    sums are taken by its own lane, in key order, with no atomics."""
    geom, _ = _host_level1(cuda_device, radial)
    args = _fwd_inputs(geom.rank, radial, 1, 16, 24, torch.float32, cuda_device)
    k3 = wattn_kernel.flash_rpe_fwd
    first = k3(*args, geom.kmin, geom.kmax, 24, 0.0125)
    second = k3(*args, geom.kmin, geom.kmax, 24, 0.0125)
    assert all(torch.equal(a_, b_) for a_, b_ in zip(first, second))
    rank, kmin, kmax = _fwd_edge_rank("long", cuda_device)
    q, k, v = args[0][:1024], args[1][:1024], args[2][:1024]
    k2 = wattn_kernel.flash_window_sorted
    assert torch.equal(k2(q, k, v, rank.int(), kmin, kmax), k2(q, k, v, rank.int(), kmin, kmax))


@pytest.mark.cuda
def test_forward_kernels_occupancy(cuda_device):
    """K3 holds only the head's value table in shared memory, its rows at an
    odd stride, and leaves half of the SM's unified memory to L1; K2 uses
    none. The launch's shared bytes and resident warps per SM at G=24,
    d=16."""
    for radial in (False, True):
        l2 = 48 if radial else 47
        for dtype in (torch.float32, torch.bfloat16):
            k3 = wattn_kernel.window_attention_occupancy("wattn_rpe_fwd", dtype, 16, 24, radial)
            assert k3["smem_bytes"] == 4 * 3 * l2 * 17, k3
            assert k3["warps_per_sm"] >= 8, (radial, dtype, k3)
            k2 = wattn_kernel.window_attention_occupancy("wattn_fwd", dtype, 16, 0, False)
            assert k2["smem_bytes"] == 0 and k2["warps_per_sm"] >= 16, (dtype, k2)
