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

import os
import sys

import numpy as np
import pytest
import torch

from u2mkd_tpu_torch.data import plumbing_host, synthetic, wgeom_host
from u2mkd_tpu_torch.models.plumbing import _window_geom_from_arrays
from u2mkd_tpu_torch.models.spvcnn import SPVCNN, teacher_model
from u2mkd_tpu_torch.models.tsd import tsd_model
from u2mkd_tpu_torch.ops import wattn
from u2mkd_tpu_torch.ops.kernels import spconv_kernel, wattn_kernel
from u2mkd_tpu_torch.train import checkpoints, distill, optim, state

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


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
                                          tq, tk, tv, g, 0.5)
    assert k3.launches == before + 1
    assert out_s.dtype == torch.float32
    ref = wattn_kernel.flash_rpe_sorted_plain(sq, sk, sv, geom.rank, geom.quant, geom.r,
                                              tq, tk, tv, g, 0.5)
    assert _rel_err(out_s, ref) <= 1e-4
    # the log-sum-exp K3 writes for the backward
    qT, kT = wattn.table_projections(sq, tq), wattn.table_projections(sk, tk)
    _, lse = k3(sq, sk, sv, qT, kT, tv, geom.rank, geom.quant, geom.r, g, 0.5)
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
        k2(q[:100], k[:100], vv[:100], valid.int()[:100])


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


@pytest.mark.cuda
def test_conv_only_request_matches_plain(cuda_device):
    """The conv-only SPVCNN's eval step at a small size: 34 K1 launches and
    no K3 per forward, and the plain versions' logits on the card."""
    caps = (2048, 1024, 512, 256, 128)
    model = SPVCNN(num_classes=17, cr=1.0, sphereformer=False,
                   generator=torch.Generator().manual_seed(0)).to(cuda_device).eval()
    raw = synthetic.make_batch(np.random.RandomState(5), 1, 4096, voxel_size=0.2)
    raw["plumbing"] = plumbing_host.batch_plumbing(
        raw["pcoords"], raw["xyz"], raw["pmask"], caps,
        wgeom_params=wgeom_host.params_from_model(model))
    assert "wgeom" not in raw["plumbing"]
    eval_fn = state.make_eval_step(model, caps, 17)
    k1, k3 = spconv_kernel.rulebook_conv, wattn_kernel.flash_rpe_fwd
    before = (k1.launches, k3.launches)
    out = eval_fn(raw)
    assert (k1.launches - before[0], k3.launches - before[1]) == (34, 0)
    model.set_plain(True)
    try:
        ref = eval_fn(raw)
    finally:
        model.set_plain(False)
    valid = torch.from_numpy(raw["pmask"]).to(cuda_device)
    assert torch.isfinite(out["logits"]).all()
    assert _rel_err(out["logits"][valid], ref["logits"][valid]) <= 1e-4
    assert (out["pred"] == ref["pred"])[valid].float().mean().item() >= 0.999


@pytest.mark.cuda
def test_imported_reference_teacher_on_card(cuda_device, tmp_path):
    """A reference-schema ``SPVCNN_SPFORMER`` file at cr_t=2.0
    (``chip_smoke.reference_teacher_state_dict``) imported into the stage-2
    wrapper's teacher (``checkpoints.load_teacher_any``), then a student
    request with it (P=4096, 2 cameras at 72x128): 68 K1 and 16 K3
    launches, and the plain versions' logits, the teacher's too."""
    s_caps = (4096, 2048, 1024, 512, 256)
    t_caps = (8192, 4096, 2048, 1024, 512)
    path = str(tmp_path / "teacher.pt")
    sd = chip_smoke.reference_teacher_state_dict(2.0, 17, seed=3)
    torch.save({"model": sd}, path)
    model = tsd_model(num_classes=17, cr=1.0, cr_t=2.0, voxel_size=0.05, device=cuda_device)
    info = checkpoints.load_teacher_any(path, model)
    assert info["leftover"] == [] and len(info["loaded"]) == len(model.model_t.state_dict())
    assert torch.equal(model.model_t.classifier_vox.weight.cpu(), sd["classifier_vox.0.weight"])
    raw = synthetic.make_multimodal_batch(np.random.RandomState(6), 1, 4096, 8192,
                                          voxel_size=0.05, num_cams=2, im_hw=(72, 128))
    eval_fn = distill.make_distill_eval_step(model, s_caps, t_caps, 17, run_teacher=True)
    k1, k3 = spconv_kernel.rulebook_conv, wattn_kernel.flash_rpe_fwd
    before = (k1.launches, k3.launches)
    out = eval_fn(raw)
    assert (k1.launches - before[0], k3.launches - before[1]) == (68, 16)
    model.set_plain(True)
    try:
        ref = eval_fn(raw)
    finally:
        model.set_plain(False)
    t_valid = torch.from_numpy(raw["teacher"]["pmask"]).to(cuda_device)
    valid = torch.from_numpy(raw["student"]["pmask"]).to(cuda_device)
    for key, rows in (("logits_teacher", t_valid), ("logits", valid)):
        assert torch.isfinite(out[key]).all()
        assert _rel_err(out[key][rows], ref[key][rows]) <= 1e-4, key
        agree = (out[key].argmax(-1) == ref[key].argmax(-1))[rows].float().mean().item()
        assert agree >= 0.999, key


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
    out, lse = wattn_kernel.flash_rpe_fwd(sq, sk, sv, qT, kT, tv, *geo, g, 0.5)
    do = torch.randn(n, h, d, device=cuda_device,
                     generator=torch.Generator(device=cuda_device).manual_seed(3))
    args = (sq, sk, sv, qT, kT, wattn.table_projections(do, tv), *geo, lse, do,
            (do * out).sum(-1))
    k4, k5 = wattn_kernel.flash_rpe_bwd_q, wattn_kernel.flash_rpe_bwd_k
    before = (k4.launches, k5.launches)
    dq, mq, pm = k4(*args, g, 0.5)
    dk, dv, mk = k5(*args, g, 0.5)
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
    out_s = wattn_kernel.flash_rpe_sorted(*sorted_, geom.rank, geom.quant, geom.r, *tables,
                                          g, 0.5)
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


@pytest.mark.cuda
def test_student_train_step_kernels_match_plain(cuda_device):
    """The stage-2 distillation train step at a small size (student P=4096
    with 2 cameras at 72x128, the cr_t=2.0 teacher on 8192 points): 68 K1
    launches (student and teacher), 33 as dX, 34 K1b, 16 K3, 8 each of K4
    and K5 per step; each loss term finite and equal to that of a step
    through the plain versions (same weights, same generator seed); the
    teacher's parameters and BN statistics bitwise as they were, with no
    gradient. The gradients are held per launch of a full-size step by
    ``chip_smoke.py``."""
    s_caps = (4096, 2048, 1024, 512, 256)
    t_caps = (8192, 4096, 2048, 1024, 512)
    raw = synthetic.make_multimodal_batch(np.random.RandomState(4), 1, 4096, 8192,
                                          voxel_size=0.05, num_cams=2, im_hw=(72, 128))
    counters = (spconv_kernel.rulebook_conv, spconv_kernel.rulebook_conv_dx,
                spconv_kernel.rulebook_conv_dw, wattn_kernel.flash_rpe_fwd,
                wattn_kernel.flash_rpe_bwd_q, wattn_kernel.flash_rpe_bwd_k)
    terms = []
    for plain in (False, True):
        model = tsd_model(num_classes=17, cr=1.0, cr_t=2.0, voxel_size=0.05, seed=3,
                          device=cuda_device)
        model.set_plain(plain)
        teacher0 = {k: v.clone() for k, v in model.model_t.state_dict().items()}
        opt, _ = distill.make_frozen_teacher_optimizer(model, "sgd_spformer", 0.02)
        gen = torch.Generator(device=cuda_device).manual_seed(9)
        step_fn = distill.make_distill_train_step(model, opt, s_caps, t_caps, generator=gen)
        before = [c.launches for c in counters]
        aux = step_fn(raw)
        launched = [c.launches - b for c, b in zip(counters, before)]
        assert launched == ([0] * 6 if plain else [68, 33, 34, 16, 8, 8])
        assert all(torch.isfinite(v) for v in aux.values())
        assert all(p.grad is None for p in model.model_t.parameters())
        for k, v in model.model_t.state_dict().items():
            assert torch.equal(v, teacher0[k]), k
        terms.append({k: v.item() for k, v in aux.items()})
    # the loss to 1e-5 as the teacher's step; each term, a smaller sum of
    # the same f32 rounding, to 1e-4 of itself
    for k, v in terms[0].items():
        assert abs(v - terms[1][k]) <= (1e-5 if k == "loss" else 1e-4) * abs(terms[1][k]), k


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


def _bwd_matches_plain(args, g, a=0.0125):
    k4, k5 = wattn_kernel.flash_rpe_bwd_q, wattn_kernel.flash_rpe_bwd_k
    before = (k4.launches, k5.launches)
    got = k4(*args, g, a) + k5(*args, g, a)
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
    _bwd_matches_plain(args, 24)


def _edge_geometry(case, radial, device, g=24):
    """(rank, quant, r, h, d, dtype) of one edge case: one window
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
    h, d, dtype = {"one_window": (2, 16, torch.float32), "d4": (2, 4, torch.float32),
                   "d32": (2, 32, torch.float32), "h8": (8, 16, torch.float32),
                   "bf16": (2, 16, torch.bfloat16)}[case]
    return rank, quant, r, h, d, dtype


@pytest.mark.cuda
@pytest.mark.parametrize("radial", [False, True])
@pytest.mark.parametrize("case", ["one_window", "d4", "d32", "h8", "bf16"])
def test_attention_backward_kernels_edge_cases(cuda_device, case, radial):
    """K4 and K5 against the plain backward: a window of all N rows (every
    warp scans back to row 0 and on to row N), head dims 4 and 32, 8 heads,
    bf16 inputs; coordinates outside [0, G) exercise the clipping."""
    rank, quant, r, h, d, dtype = _edge_geometry(case, radial, cuda_device)
    args = _bwd_inputs(rank, quant, r, h, d, 24, dtype, cuda_device)
    _bwd_matches_plain(args, 24)


@pytest.mark.cuda
@pytest.mark.parametrize("radial", [False, True])
def test_attention_backward_kernels_deterministic(cuda_device, radial):
    """Two launches of K4, and two of K5, on the same inputs give bitwise the
    same outputs: each sum is taken by the lane that owns its row, in key
    order, with no atomics."""
    geom, _ = _host_level1(cuda_device, radial)
    args = _bwd_inputs(geom.rank, geom.quant, geom.r, 1, 16, 24, torch.float32, cuda_device)
    for fn in (wattn_kernel.flash_rpe_bwd_q, wattn_kernel.flash_rpe_bwd_k):
        first = fn(*args, 24, 0.0125)
        second = fn(*args, 24, 0.0125)
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
    """Window-sorted rank [N] (float32) of one of FWD_EDGE_CASES."""
    n, sizes = FWD_EDGE_CASES[case]
    if sizes is None:
        ids = np.zeros(n)
    else:
        ids = np.repeat(np.arange(n), np.resize(sizes, n))[:n]
    return torch.from_numpy(ids.astype(np.float32)).to(device)


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
    rank = _fwd_edge_rank(case, cuda_device)
    k3 = wattn_kernel.flash_rpe_fwd
    for dtype in (torch.float32, torch.bfloat16):
        args = _fwd_inputs(rank, radial, 2, 16, 24, dtype, cuda_device)
        before = k3.launches
        out, lse = k3(*args, 24, 0.0125)
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
    rank = _fwd_edge_rank(case, cuda_device).int()
    if case == "long":
        rank[-100:] = wattn_kernel.PAD_RANK
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    k2 = wattn_kernel.flash_window_sorted
    for d in wattn_kernel.HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(rank.shape[0], 3, d, device=cuda_device, generator=gen)
                       .to(dtype) for _ in range(3))
            before = k2.launches
            out = k2(q, k, v, rank)
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
    first = k3(*args, 24, 0.0125)
    second = k3(*args, 24, 0.0125)
    assert all(torch.equal(a_, b_) for a_, b_ in zip(first, second))
    rank = _fwd_edge_rank("long", cuda_device)
    q, k, v = args[0][:1024], args[1][:1024], args[2][:1024]
    k2 = wattn_kernel.flash_window_sorted
    assert torch.equal(k2(q, k, v, rank.int()), k2(q, k, v, rank.int()))


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


@pytest.mark.cuda
def test_device_loader_uploads_on_a_side_stream(cuda_device):
    """``loaders.device_loader``: batches uploaded in the prefetch thread on
    a side stream arrive equal to their host arrays (host-local keys left
    as they are), in order, with no prefetch thread too; a step that reads
    them on the default stream while later uploads run sees its own data."""
    from u2mkd_tpu_torch.data import loaders

    batches = [dict(synthetic.make_batch(np.random.RandomState(i), 1, 4096, voxel_size=0.2),
                    infos=[{"i": i}], lidar_tokens=[f"t{i}"]) for i in range(6)]
    for depth in (2, 0):
        got = []
        for b in loaders.device_loader(lambda: iter(batches), cuda_device, depth)():
            assert b["feats"].is_cuda and b["infos"] == [{"i": len(got)}]
            # read on the default stream after the next uploads were queued
            got.append({k: v.cpu() for k, v in b.items() if torch.is_tensor(v)})
        assert len(got) == len(batches)
        for g, b in zip(got, batches):
            assert sorted(g) == sorted(k for k in b if k not in loaders.HOST_LOCAL_KEYS)
            for k, v in g.items():
                assert torch.equal(v, torch.from_numpy(b[k])), k


@pytest.mark.cuda
def test_unet_request_and_step_match_plain(cuda_device):
    """The SphereFormer U-Net (``chip_smoke.unet_model``: full width,
    attention at all five levels) at a small size: 37 K1 and 10 K3 launches
    a request with the plain versions' logits; a train step's 37 / 36 / 37
    / 10 / 10 / 10 launches and its loss equal to a plain step's (same
    weights and generator seed, so the same drop-path masks)."""
    caps = (2048, 1024, 512, 256, 128)
    raw = synthetic.make_batch(np.random.RandomState(8), 1, 4096, voxel_size=0.1)
    model = chip_smoke.unet_model(seed=2).to(cuda_device).eval()
    raw["plumbing"] = plumbing_host.batch_plumbing(
        raw["pcoords"], raw["xyz"], raw["pmask"], caps,
        wgeom_params=wgeom_host.params_from_model(model))
    assert len(raw["plumbing"]["wgeom"]["sphere"]) == 5
    eval_fn = state.make_eval_step(model, caps, 17)
    k1, k3 = spconv_kernel.rulebook_conv, wattn_kernel.flash_rpe_fwd
    before = (k1.launches, k3.launches)
    out = eval_fn(raw)
    assert (k1.launches - before[0], k3.launches - before[1]) == (37, 10)
    model.set_plain(True)
    try:
        ref = eval_fn(raw)
    finally:
        model.set_plain(False)
    valid = torch.from_numpy(raw["pmask"]).to(cuda_device)
    assert torch.isfinite(out["logits"]).all()
    assert _rel_err(out["logits"][valid], ref["logits"][valid]) <= 1e-4
    assert (out["pred"] == ref["pred"])[valid].float().mean().item() >= 0.999

    counters = (spconv_kernel.rulebook_conv, spconv_kernel.rulebook_conv_dx,
                spconv_kernel.rulebook_conv_dw, wattn_kernel.flash_rpe_fwd,
                wattn_kernel.flash_rpe_bwd_q, wattn_kernel.flash_rpe_bwd_k)
    losses = []
    for plain in (False, True):
        model = chip_smoke.unet_model(seed=3).to(cuda_device)
        model.set_plain(plain)
        opt, _ = optim.make_optimizer(model.named_parameters(), "sgd_spformer", 0.02)
        gen = torch.Generator(device=cuda_device).manual_seed(9)
        step_fn = state.make_train_step(model, opt, caps, generator=gen)
        before = [c.launches for c in counters]
        losses.append(step_fn(raw)["loss"].item())
        launched = [c.launches - b for c, b in zip(counters, before)]
        assert launched == ([0] * 6 if plain else [37, 36, 37, 10, 10, 10])
    assert np.isfinite(losses[0])
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1])


@pytest.mark.cuda
def test_window_msa_launches_k2(cuda_device, rng):
    """``WindowMultiheadSA`` on the card: one K2 launch a sample and the
    plain path's output; under autograd it takes K2's plain version (K2 has
    no backward) and launches nothing."""
    from u2mkd_tpu_torch.models.position_embedding import WindowMultiheadSA

    b, v, dim = 2, 1000, 64
    xyz = torch.from_numpy(rng.uniform(0, 6, (b, v, 3)).astype(np.float32)).to(cuda_device)
    mask = torch.from_numpy(rng.rand(b, v) < 0.9).to(cuda_device)
    feats = torch.from_numpy(rng.randn(b, v, dim).astype(np.float32)).to(cuda_device)
    module = WindowMultiheadSA(dim, 4, (0.6, 0.6, 0.6), pe_type="sine",
                               generator=torch.Generator().manual_seed(1)).to(cuda_device)
    k2 = wattn_kernel.flash_window_sorted
    with torch.no_grad():
        before = k2.launches
        out = module(feats, xyz, mask)
        assert k2.launches - before == b
        module.plain = True
        ref = module(feats, xyz, mask)
        module.plain = False
    assert _rel_err(out, ref) <= 1e-4
    assert (out[~mask] == 0).all()
    before = k2.launches
    grad_out = module(feats, xyz, mask)
    assert k2.launches == before and grad_out.requires_grad
    assert _rel_err(grad_out.detach(), ref) <= 1e-5


@pytest.mark.cuda
def test_window_msa_trains_on_card(cuda_device, rng):
    """One optimizer step of ``WindowMultiheadSA`` under autograd on the
    card, held to the same step on the CPU: the loss and every parameter
    after the step."""
    from u2mkd_tpu_torch.models.position_embedding import WindowMultiheadSA

    b, v, dim = 1, 2000, 64
    xyz = rng.uniform(0, 6, (b, v, 3)).astype(np.float32)
    mask = rng.rand(b, v) < 0.9
    feats = rng.randn(b, v, dim).astype(np.float32)
    results = []
    for dev in ("cpu", cuda_device):
        module = WindowMultiheadSA(dim, 4, (0.6, 0.6, 0.6), pe_type="sine",
                                   generator=torch.Generator().manual_seed(2)).to(dev)
        opt = torch.optim.SGD(module.parameters(), lr=0.1)
        out = module(*(torch.from_numpy(x).to(dev) for x in (feats, xyz, mask)))
        loss = (out ** 2).mean()
        loss.backward()
        opt.step()
        results.append((loss.item(), {k: p.detach().cpu() for k, p in
                                      module.named_parameters()}))
    (loss_c, params_c), (loss_g, params_g) = results
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    for k, p in params_c.items():
        assert _rel_err(params_g[k], p) <= 1e-5, k


@pytest.mark.cuda
def test_device_build_on_card_equals_cpu(cuda_device):
    """``build_plumbing`` on the card against the same build on the CPU:
    every integer array (keys, rulebooks, point maps) equal, saturated
    levels included; the voxel means and weights (sums whose order the
    card's atomics choose) within 1e-6 of their scale."""
    from u2mkd_tpu_torch.models import plumbing as P

    raw = synthetic.make_batch(np.random.RandomState(4), 2, 20000, voxel_size=0.1)
    caps = (16384, 8192, 4096, 2048, 1024)
    args = [torch.from_numpy(raw[k]) for k in ("pcoords", "xyz", "pmask")]
    cpu = P.build_plumbing(*args, caps)
    gpu = P.build_plumbing(*(a.to(cuda_device) for a in args), caps)
    assert gpu.levels[0].grid.key.is_cuda
    for lc, lg in zip(cpu.levels, gpu.levels):
        for k in ("mask", "coords", "key", "num"):
            assert torch.equal(getattr(lg.grid, k).cpu(), getattr(lc.grid, k)), k
        for k in ("nbr27", "down_nbr8", "up_parent", "up_koff"):
            if getattr(lc, k) is not None:
                assert torch.equal(getattr(lg, k).cpu(), getattr(lc, k)), k
    assert int(cpu.levels[0].grid.num.max()) == caps[0]
    for li in range(len(caps)):
        assert torch.equal(gpu.p2v[li].cpu(), cpu.p2v[li])
        assert torch.equal(gpu.devox_idx[li].cpu(), cpu.devox_idx[li])
        assert _rel_err(gpu.devox_w[li].cpu(), cpu.devox_w[li]) <= 1e-6
        assert _rel_err(gpu.vox_xyz[li].cpu(), cpu.vox_xyz[li]) <= 1e-6
    assert torch.equal(gpu.p2v0_feats_seg.cpu(), cpu.p2v0_feats_seg)


@pytest.mark.cuda
@pytest.mark.parametrize("pallas", [True, False], ids=["flash", "banded"])
def test_request_on_device_plumbing(cuda_device, pallas):
    """A teacher request from a scan without plumbing builds it on the card
    and launches 34 K1 and 8 K3 (flash) or no K3 (banded), with logits
    within 1e-4 of the same request on its host plumbing."""
    raw = synthetic.make_batch(np.random.RandomState(6), 1, 8192, voxel_size=0.1)
    caps = (8192, 8192, 8192, 4096, 2048)  # no grid full: host and card hold one voxel set
    model = teacher_model(num_classes=17, cr=1.0, voxel_size=0.1, head_dim=16, seed=3,
                          device=cuda_device, pallas_attention=pallas)
    eval_fn = state.make_eval_step(model, caps, 17)
    counters = (spconv_kernel.rulebook_conv, wattn_kernel.flash_rpe_fwd)
    before = [c.launches for c in counters]
    out = eval_fn(raw)["logits"]
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [34, 8 if pallas else 0]
    arrays = plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"], caps,
                                          wgeom_params=wgeom_host.params_from_model(model))
    ref = eval_fn(dict(raw, plumbing=arrays))["logits"]
    valid = torch.from_numpy(raw["pmask"]).to(cuda_device)
    assert _rel_err(out[valid], ref[valid]) <= 1e-4


@pytest.mark.cuda
def test_pointops_and_clfm_on_card_match_cpu(cuda_device, rng):
    """kNN (points on a lattice of eighths, ties included), FPS,
    correlation2d and CLFM on the card against the same calls on the CPU:
    indices equal, features within 1e-4 of the largest."""
    from u2mkd_tpu_torch.models.clfm import CLFM
    from u2mkd_tpu_torch.ops import pointops

    h, w, n = 24, 40, 3000
    uv = (np.stack([rng.randint(0, (w - 1) * 8 + 1, n), rng.randint(0, (h - 1) * 8 + 1, n)],
                   -1) / 8).astype(np.float32)
    uv[1000:1200] = uv[:200]
    mask = rng.rand(n) < 0.9
    grid = np.stack([np.tile(np.arange(w), h), np.repeat(np.arange(h), w)], -1).astype(np.float32)
    pts = rng.randn(n, 3).astype(np.float32)
    fa = rng.randn(h, w, 16).astype(np.float32)
    fb = rng.randn(h, w, 16).astype(np.float32)
    f3d = rng.randn(n, 16).astype(np.float32)

    def both(fn):
        return fn(torch.from_numpy), fn(lambda x: torch.from_numpy(x).to(cuda_device))

    for fn in (lambda t: pointops.knn(t(grid), t(uv), 4, t(mask), tile=256),
               lambda t: pointops.farthest_point_sampling(t(pts), 200, t(mask))):
        cpu, gpu = both(fn)
        assert torch.equal(gpu.cpu(), cpu)
    cpu, gpu = both(lambda t: pointops.correlation2d(t(fa), t(fb), 3))
    assert _rel_err(gpu.cpu(), cpu) <= 1e-4
    clfm = CLFM(16, 16, generator=torch.Generator().manual_seed(2))
    clfm_gpu = CLFM(16, 16).to(cuda_device)
    clfm_gpu.load_state_dict(clfm.state_dict())
    with torch.no_grad():
        want = clfm(torch.from_numpy(uv), torch.from_numpy(fa), torch.from_numpy(f3d),
                    torch.from_numpy(mask))
        got = clfm_gpu(*(torch.from_numpy(x).to(cuda_device) for x in (uv, fa, f3d, mask)))
    for g, c in zip(got, want):
        assert _rel_err(g.cpu(), c) <= 1e-4


@pytest.mark.cuda
def test_bf16_request_through_kernels_matches_plain(cuda_device):
    """Under the bf16 policy a teacher request (P=8192, cr=1.0) launches
    34 K1 and 8 K3, all with bf16 inputs, each within the bf16 TOL of its
    plain version on the same arguments; its logits stay f32 and within the
    JAX criterion (mean |bf16 - f32| over mean |f32| < 0.1) of the f32
    request's on the same scan and weights."""
    from u2mkd_tpu_torch.ops import precision

    raw = synthetic.make_batch(np.random.RandomState(6), 1, 8192, voxel_size=0.1)
    caps = (8192, 4096, 2048, 1024, 512)
    model = teacher_model(num_classes=17, cr=1.0, voxel_size=0.1, head_dim=16, seed=3,
                          device=cuda_device)
    raw["plumbing"] = plumbing_host.batch_plumbing(
        raw["pcoords"], raw["xyz"], raw["pmask"], caps,
        wgeom_params=wgeom_host.params_from_model(model))
    eval_fn = state.make_eval_step(model, caps, 17)
    ref = eval_fn(raw)["logits"]
    worst = {}
    try:
        precision.set_compute_dtype("bfloat16")
        with chip_smoke.each_launch_held_to_plain(worst):
            out = eval_fn(raw)["logits"]
    finally:
        precision.set_compute_dtype("float32")
    torch.cuda.synchronize()
    assert {n: r["by_dtype"] for n, r in worst.items()} == {
        "rulebook_conv": {"bfloat16": 34}, "flash_rpe_fwd": {"bfloat16": 8}}
    for name, r in worst.items():
        assert r["max_rel_err"] <= chip_smoke.TOL[(name, "bf16")], (name, r)
    valid = torch.from_numpy(raw["pmask"]).to(cuda_device)
    got, want = out[valid], ref[valid]
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    assert 0 < ((got - want).abs().mean() / want.abs().mean()).item() < 0.1


@pytest.mark.cuda
@pytest.mark.slow
def test_distill_ablation_bounds_on_card(cuda_device, tmp_path):
    """The distillation-efficacy ablation on the card with the protocol of
    ``tests/test_distill_ablation.py`` (no random drop, classes 4, 7 and 10
    held out, 12 teacher and 12 student epochs) on a ``make_nusc_mini``
    set: its five bounds in f32, and again for bf16 arms from the f32
    run's teacher."""
    from u2mkd_tpu_torch import distill_ablation

    sys.path.insert(0, os.path.join(distill_ablation.REPO, "tools"))
    from make_nusc_mini import generate

    generate(str(tmp_path / "set"))
    r32 = distill_ablation.run_ablation(root=str(tmp_path / "set"),
                                        workdir=str(tmp_path / "f32"), **chip_smoke.ABLATION)
    r16 = distill_ablation.run_ablation(
        root=str(tmp_path / "set"), workdir=str(tmp_path / "bf16"), precision="bfloat16",
        teacher_ckpt=str(tmp_path / "f32" / "teacher" / "checkpoints" / "max-iou-val-vox.pt"),
        teacher_miou=r32["teacher_miou"], **chip_smoke.ABLATION)
    for r in (r32, r16):
        for name, ok in chip_smoke.ABLATION_BOUNDS.items():
            assert ok(r), (name, r)


def _card_dp_setup(tmp_path, world):
    """The small teacher of the data-parallel card tests (cr 0.5, K1-K5,
    dropout and drop path off), its weights, one scan a rank and the batch
    of all of them, each with its host plumbing."""
    import torch_dp_worker

    spec = dict(num_classes=5, cr=0.5, voxel_size=0.3, head_dim=8, seed=3, dropout_rate=0.0,
                drop_path_rate=0.0)
    caps = (4096, 2048, 1024, 512, 256)
    model = teacher_model(device="cuda", **spec)
    start = {k: v.cpu().numpy() for k, v in model.state_dict().items()}
    raws = [synthetic.make_batch(np.random.RandomState(s), 1, 4096, voxel_size=0.3)
            for s in range(world)]

    def with_plumbing(raw):
        return dict(raw, plumbing=plumbing_host.batch_plumbing(
            raw["pcoords"], raw["xyz"], raw["pmask"], caps,
            wgeom_params=wgeom_host.params_from_model(model)))

    spec.pop("seed")
    got = torch_dp_worker.spawn(
        "card_teacher", {"model": spec, "state": start, "lr": 0.02, "caps": caps,
                         "batches": [with_plumbing(r) for r in raws]},
        tmp_path, world, backend="gloo" if world > 1 else "nccl", timeout=300)
    return spec, caps, start, with_plumbing(chip_smoke.concat_scans(raws)), got


def _card_ref_state(spec, caps, start, batch, nudge=None, mean_of_scans=True):
    model = teacher_model(device="cuda", **spec)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in start.items()})
    if nudge is not None:
        gen = torch.Generator(device="cuda").manual_seed(nudge)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + 2.0 ** -23 * torch.randn(p.shape, device="cuda", generator=gen))
    opt, _ = optim.make_optimizer(model.named_parameters(), "sgd_spformer", 0.02)
    step = (chip_smoke.mean_of_scans_teacher_step(model, opt, caps) if mean_of_scans
            else state.make_train_step(model, opt, caps))
    step(batch)
    return {k: v.cpu().numpy() for k, v in model.state_dict().items()}


def _card_update_diff(got, ref, start):
    def one(n):
        change = float(np.abs(ref[n] - start[n]).max())
        return float(np.abs(got[n] - ref[n]).max()) / (
            change + 2 * float(np.spacing(np.abs(ref[n]).max().astype(np.float32))))

    return max((one(n), n) for n in ref if "running_" not in n and "num_batches" not in n)


@pytest.mark.cuda
def test_two_rank_gloo_step_on_card_is_the_mean_of_scans_step(cuda_device, tmp_path):
    """Two gloo ranks on the one card, a scan each (BN synced, gradients
    averaged), against the single-process step on both scans whose
    objective is the mean of the two scans' losses: every parameter's update
    within GRAD_SPREADS (4) times the median of three one-ulp-nudged
    reference steps' distances (and at least 1e-2 of its change); both
    ranks bitwise equal."""
    spec, caps, start, batch, got = _card_dp_setup(tmp_path, 2)
    ref = _card_ref_state(spec, caps, start, batch)
    spreads = [_card_update_diff(_card_ref_state(spec, caps, start, batch, nudge=s), ref,
                                 start)[0] for s in (7, 8, 9)]
    tol = max(1e-2, 4.0 * float(np.median(spreads)))
    worst, name = _card_update_diff(got[0]["state"], ref, start)
    assert worst <= tol, (name, worst, tol)
    for k, v in got[0]["state"].items():
        np.testing.assert_array_equal(got[1]["state"][k], v, k)


@pytest.mark.cuda
def test_nccl_world_one_step_equals_single_device_step(cuda_device, tmp_path):
    """One NCCL rank: the data-parallel step (a BN sum and a gradient mean
    over one rank) against the single-device step, held as the two-rank
    step is (the card's scatter-adds do not repeat bitwise, so 0 is not
    what two runs of one step give)."""
    spec, caps, start, batch, got = _card_dp_setup(tmp_path, 1)
    ref = _card_ref_state(spec, caps, start, batch, mean_of_scans=False)
    spreads = [_card_update_diff(_card_ref_state(spec, caps, start, batch, nudge=s,
                                                 mean_of_scans=False), ref, start)[0]
               for s in (7, 8, 9)]
    tol = max(1e-2, 4.0 * float(np.median(spreads)))
    worst, name = _card_update_diff(got[0]["state"], ref, start)
    assert worst <= tol, (name, worst, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("part", ["teacher", "student", "unet"])
def test_remat_step_on_card_within_the_whole_step_rule(cuda_device, part):
    """A small teacher step, a small stage-2 step and a small step of the
    full-width U-Net (the sizes of the train step tests above; dropout and
    drop path at 0.3 from one generator seed)
    with ``remat=True`` against ``remat=False`` on the card, by the
    whole-step rule (``chip_smoke.remat_rule``: the loss, every update and
    BN statistic within 4x the median of three one-ulp-nudged steps); each
    planted remat fault (``chip_smoke.planted_remat_fault``) misses it by
    2x. The remat step launches K1 and K3 again in its recomputes and dX,
    K1b, K4 and K5 as often as the step without."""
    if part in ("teacher", "unet"):
        caps = (2048, 1024, 512, 256, 128)
        model = (teacher_model(num_classes=17, cr=1.0, voxel_size=0.2, head_dim=16, seed=3,
                               device=cuda_device) if part == "teacher"
                 else chip_smoke.unet_model(3))
        voxel = 0.2 if part == "teacher" else chip_smoke.VOXEL
        raw = synthetic.make_batch(np.random.RandomState(4), 1, 4096, voxel_size=voxel)
        raw["plumbing"] = plumbing_host.batch_plumbing(
            raw["pcoords"], raw["xyz"], raw["pmask"], caps,
            wgeom_params=wgeom_host.params_from_model(model))
        spec = {"model": model, "stage2": False, "optimizer": "sgd_spformer", "caps": caps}
    else:
        s_caps = (4096, 2048, 1024, 512, 256)
        caps = (8192, 4096, 2048, 1024, 512)
        model = tsd_model(num_classes=17, cr=1.0, cr_t=2.0, voxel_size=0.05, seed=3,
                          device=cuda_device)
        raw = synthetic.make_multimodal_batch(np.random.RandomState(4), 1, 4096, 8192,
                                              voxel_size=0.05, num_cams=2, im_hw=(72, 128))
        for key, c, sub in (("student", s_caps, model.model_s), ("teacher", caps, model.model_t)):
            b = raw[key]
            b["plumbing"] = plumbing_host.batch_plumbing(
                b["pcoords"], b["xyz"], b["pmask"], c,
                wgeom_params=wgeom_host.params_from_model(sub))
        spec = {"model": model, "stage2": True, "optimizer": "sgd_spformer", "caps": caps,
                "student_caps": s_caps, "w_kl": 1.0, "w_feat": 1.0}
    spec["start"] = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    ref = chip_smoke.published_run(spec, raw, False, 1)
    got = chip_smoke.published_run(spec, raw, True, 1)
    nudged = [chip_smoke.published_run(spec, raw, False, 1, nudge=s) for s in (7, 8, 9)]
    faults = {f: chip_smoke.published_run(spec, raw, True, 1, fault=f)
              for f in chip_smoke.REMAT_FAULTS}
    row = chip_smoke.remat_rule(ref, got, nudged, faults)
    assert row["worst_over_tol"] <= 1.0, row
    for f in chip_smoke.REMAT_FAULTS:
        assert row[f"planted_{f}_margin"] >= 2.0, row
    with_remat, without = got["launches"][0], ref["launches"][0]
    for name in ("rulebook_conv_dx", "rulebook_conv_dw", "flash_rpe_bwd_q", "flash_rpe_bwd_k"):
        assert with_remat[name] == without[name], (with_remat, without)
    # the recomputes: the student's segments, or every segment of the U-Net
    k1, k3 = (37, 10) if part == "unet" else (34, 8)
    assert with_remat["rulebook_conv"] == without["rulebook_conv"] + k1
    assert with_remat["flash_rpe_fwd"] == without["flash_rpe_fwd"] + k3


def _repeatable_sites():
    """Each site that sums in a fixed order on the card (``ops/segment.py``
    and its callers): a function of a generator and the device -> the
    tensors it computes, forward and backward, at a main path's scale (many
    rows to one voxel, pixel or bin)."""
    import torch.nn.functional as F

    from u2mkd_tpu_torch.models import fusion, plumbing, swiftnet
    from u2mkd_tpu_torch.ops import segment

    def grads(out, *inputs):
        g = torch.randn(out.shape, device=out.device,
                        generator=torch.Generator(out.device).manual_seed(1))
        return [out, *torch.autograd.grad(out, inputs, g)]

    def rand(gen, dev, *shape, grad=False):
        return torch.randn(*shape, device=dev, generator=gen).requires_grad_(grad)

    def ids(gen, dev, shape, lo, hi):
        return torch.randint(lo, hi, shape, device=dev, generator=gen)

    def segment_sum(gen, dev):
        x = rand(gen, dev, 131072, 32, grad=True)
        return grads(segment.segment_sum(x, segment.plan(ids(gen, dev, (131072,), -1, 4096),
                                                         4096)), x)

    def point_maps(gen, dev):
        feats = rand(gen, dev, 1, 131072, 32, grad=True)
        vox = rand(gen, dev, 1, 65536, 32, grad=True)
        p2v = ids(gen, dev, (1, 131072), -1, 65536)
        idx8 = ids(gen, dev, (1, 131072, 8), -1, 65536)
        w8 = torch.rand(1, 131072, 8, device=dev, generator=gen)
        return (grads(plumbing.point_to_voxel(feats, p2v, 65536), feats)
                + grads(plumbing.voxel_to_point(vox, idx8, w8), vox))

    def gathers(gen, dev):
        x = rand(gen, dev, 1, 65536, 32, grad=True)
        t2s = ids(gen, dev, (1, 131072), -1, 65536)
        feats = rand(gen, dev, 16384, 64, grad=True)
        parent = ids(gen, dev, (131072,), -1, 16384).int()
        koff = ids(gen, dev, (131072,), 0, 8).int()
        weight = rand(gen, dev, 8, 64, 32)
        from u2mkd_tpu_torch.ops import spconv
        from u2mkd_tpu_torch.train import distill as d
        return (grads(d._gather_t2s(x, t2s), x)
                + grads(spconv.sparse_conv_transposed_2x2(feats, parent, koff, weight), feats))

    def image_ops(gen, dev):
        fmap = rand(gen, dev, 3, 64, 90, 160, grad=True)
        coords = torch.rand(3, 65536, 2, device=dev, generator=gen) * 2.2 - 1.1
        pfeats = rand(gen, dev, 1, 65536, 64, grad=True)
        masks = torch.rand(1, 3, 65536, device=dev, generator=gen) < 0.8
        small = rand(gen, dev, 3, 128, 12, 20, grad=True)
        return (grads(fusion.feature_gather(fmap, coords), fmap)
                + grads(fusion.point_to_grid(pfeats, coords[None], masks, (90, 160)), pfeats)
                + grads(swiftnet.resize_bilinear_align_corners(small, (90, 160)), small)
                + grads(swiftnet.adaptive_avg_pool(small, (4, 7)), small))

    def image_conv(gen, dev):
        swiftnet.repeatable_convolutions()
        x = rand(gen, dev, 3, 64, 90, 160, grad=True)
        w = rand(gen, dev, 64, 64, 3, 3, grad=True)
        return grads(F.conv2d(x, w, padding=1), x, w)

    def plain_attention(gen, dev):
        from u2mkd_tpu_torch.ops import wattn
        n, h, d, g_len = 4096, 2, 16, 24
        rank = torch.sort(ids(gen, dev, (n,), 0, 64)).values
        q, k, v = (rand(gen, dev, n, h, d, grad=True) for _ in range(3))
        qT, kT = (rand(gen, dev, n, h, 3, 2 * g_len) for _ in range(2))
        tv = rand(gen, dev, 2 * g_len, 3, h, d)
        quant = ids(gen, dev, (n, 3), 0, g_len)
        r = torch.rand(n, device=dev, generator=gen) * 50
        out, lse = wattn.window_attention_rpe_fwd(q, k, v, qT, kT, tv, rank, quant, r, g_len,
                                                  0.0125)
        do = rand(gen, dev, n, h, d)
        edo = torch.einsum("nhd,lahd->nhal", do, tv)
        bwd = wattn.window_attention_rpe_bwd(q, k, v, qT, kT, edo, rank, quant, r, lse, do,
                                             (do * out).sum(-1), g_len, 0.0125)
        return [wattn.window_attention_plain(q, k, v, rank), out, lse, *bwd]

    return {"segment_sum": segment_sum, "point_maps": point_maps, "gathers": gathers,
            "image_ops": image_ops, "image_conv": image_conv,
            "plain_attention": plain_attention}


@pytest.mark.cuda
@pytest.mark.parametrize("site", ["segment_sum", "point_maps", "gathers", "image_ops",
                                  "image_conv", "plain_attention"])
def test_repeatable_sums_on_card(cuda_device, site):
    """Each site that sums in a fixed order, run twice on the card from one
    input: every output and gradient bitwise equal (torch's atomic
    scatter-adds, ``grid_sample``'s, the resize's and the pool's backward and
    cuDNN's autotuned convolutions did not repeat)."""
    fn = _repeatable_sites()[site]
    first, second = (fn(torch.Generator(cuda_device).manual_seed(0), cuda_device)
                     for _ in range(2))
    assert len(first) == len(second)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
