"""The port's CUDA kernels against their plain versions, on a card.

Every test here is marked ``cuda`` and skips without a card. The file
imports nothing of JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` sets up JAX.) Tolerances are
relative to the largest plain output: f32 sums in another order; K1's bf16
output is rounded to bf16 after an f32 sum, so its two sides may land one
bf16 step apart.
"""

import numpy as np
import pytest
import torch

from u2mkd_tpu_torch.data import plumbing_host, synthetic, wgeom_host
from u2mkd_tpu_torch.models.plumbing import _window_geom_from_arrays
from u2mkd_tpu_torch.models.spvcnn import teacher_model
from u2mkd_tpu_torch.ops.kernels import spconv_kernel, wattn_kernel
from u2mkd_tpu_torch.train import state


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
    before = wattn_kernel.flash_rpe_sorted.launches
    out_s = wattn_kernel.flash_rpe_sorted(sq, sk, sv, geom.rank, geom.quant, geom.r,
                                          geom.kmin, geom.kmax, tq, tk, tv, g, 0.5)
    assert wattn_kernel.flash_rpe_sorted.launches == before + 1
    assert out_s.dtype == torch.float32
    ref = wattn_kernel.flash_rpe_sorted_plain(sq, sk, sv, geom.rank, geom.quant, geom.r,
                                              tq, tk, tv, g, 0.5)
    assert _rel_err(out_s, ref) <= 1e-4

    mask = torch.from_numpy(valid).to(cuda_device)
    out = wattn_kernel.flash_pregeom_batched(q, k, vv, mask, geom, tq, tk, tv, g, 0.5)
    assert wattn_kernel.flash_rpe_sorted.launches == before + 2
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
    k1, k3 = spconv_kernel.rulebook_conv, wattn_kernel.flash_rpe_sorted
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
