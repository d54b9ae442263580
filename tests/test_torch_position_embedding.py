"""The port's position embeddings and ``WindowMultiheadSA`` against the JAX
package's, on the CPU.

Sine and Fourier embeddings to 1e-6 (f32 sin and cos of the same
arguments); the Fourier matrix ``gauss_B`` learns nothing but is decayed by
SGD as optax decays it. ``WindowMultiheadSA`` runs kernel K2's plain
version here (K2 on the card: ``tests/test_torch_cuda.py``), the JAX module
its banded XLA attention with ``band=2``, exact while every window holds at
most 2 x 128 sorted rows, which the test asserts: outputs to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2mkd_tpu.models import position_embedding as jax_pe
from u2mkd_tpu.train import optim as jax_optim

from u2mkd_tpu_torch.models import convert_weights
from u2mkd_tpu_torch.models.position_embedding import (
    PositionEmbeddingCoordsSine, WindowMultiheadSA, shift_scale_points)
from u2mkd_tpu_torch.ops.kernels import wattn_kernel
from u2mkd_tpu_torch.train import optim

PE_ATOL = 1e-6


def _perturbed(params, seed):
    """Flax init values plus noise (biases off zero)."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x + 0.1 * rng.randn(*x.shape), np.float32), params)


@pytest.mark.parametrize("d_pos", [48, 20, 7])
def test_sine_embedding_matches_jax(rng, d_pos):
    """Per-axis channel budgets (remainders to the first axes, an odd
    d_pos cut), sin and cos interleaved, normalized by an input range."""
    xyz = rng.uniform(-30, 30, (200, 3)).astype(np.float32)
    lo, hi = xyz.min(0), xyz.max(0)
    ref_mod = jax_pe.PositionEmbeddingCoordsSine(d_pos=d_pos, pos_type="sine")
    ref = np.asarray(ref_mod.apply({}, jnp.asarray(xyz), (jnp.asarray(lo), jnp.asarray(hi))))
    port = PositionEmbeddingCoordsSine(d_pos, "sine")
    out = port(torch.from_numpy(xyz), (torch.from_numpy(lo), torch.from_numpy(hi)))
    assert out.shape == (200, d_pos)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=PE_ATOL)
    np.testing.assert_allclose(
        shift_scale_points(torch.from_numpy(xyz), (torch.from_numpy(lo),
                                                   torch.from_numpy(hi))).numpy(),
        np.asarray(jax_pe.shift_scale_points(jnp.asarray(xyz), (jnp.asarray(lo),
                                                                jnp.asarray(hi)))),
        rtol=0, atol=1e-7)
    # interleaved per frequency: channel 0 is sin, 1 cos of the same argument
    np.testing.assert_allclose(out[:, 0] ** 2 + out[:, 1] ** 2, 1.0, atol=1e-6)


def test_fourier_embedding_matches_jax_and_decays(rng):
    """Fourier features from the bridged ``gauss_B`` to 1e-6; its gradient
    is zero, not absent, so one SGD step with weight decay moves it as the
    JAX package's optax chain does, while an input gradient still flows."""
    xyz = rng.uniform(0, 1, (150, 3)).astype(np.float32)
    ref_mod = jax_pe.PositionEmbeddingCoordsSine(d_pos=32, pos_type="fourier")
    params = jax.tree_util.tree_map(np.asarray, ref_mod.init(jax.random.PRNGKey(3),
                                                             jnp.asarray(xyz))["params"])
    ref = np.asarray(ref_mod.apply({"params": params}, jnp.asarray(xyz)))
    port = PositionEmbeddingCoordsSine(32, "fourier")
    port.load_state_dict(convert_weights.from_flax(params, {}))
    x = torch.from_numpy(xyz).requires_grad_(True)
    out = port(x)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=PE_ATOL)

    lr, wd = 0.1, 0.5
    out.sum().backward()
    assert x.grad is not None and float(x.grad.abs().max()) > 0
    assert port.gauss_B.grad is not None and float(port.gauss_B.grad.abs().max()) == 0.0
    opt, _ = optim.make_optimizer(port.named_parameters(), "sgd", lr, weight_decay=wd)
    opt.step()

    def loss(p):
        return jnp.sum(ref_mod.apply({"params": p}, jnp.asarray(xyz)))

    tx = jax_optim.make_optimizer("sgd", lr, weight_decay=wd)
    grads = jax.grad(loss)(params)
    upd, _ = tx.update(grads, tx.init(params), params)
    want = params["gauss_B"] + np.asarray(upd["gauss_B"])
    assert not np.allclose(want, params["gauss_B"])
    np.testing.assert_allclose(port.gauss_B.detach().numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("pe_type", ["none", "sine", "fourier"])
def test_window_msa_matches_jax(rng, pe_type):
    """``WindowMultiheadSA`` (dim 16, 4 heads, two samples with padded rows)
    against the flax module with the same weights; every window within the
    JAX module's band."""
    b, v, dim, heads = 2, 300, 16, 4
    ws = (1.5, 1.5, 1.5)
    xyz = rng.uniform(0, 8, (b, v, 3)).astype(np.float32)
    mask = rng.rand(b, v) < 0.85
    feats = rng.randn(b, v, dim).astype(np.float32)
    ref_mod = jax_pe.WindowMultiheadSA(dim=dim, num_heads=heads, window_size=ws,
                                       pe_type=pe_type, band=2)
    params = _perturbed(ref_mod.init(jax.random.PRNGKey(1), feats, xyz, mask)["params"], 2)
    ref = np.asarray(ref_mod.apply({"params": params}, feats, xyz, mask))
    for bi in range(b):
        sw = wattn_kernel.sort_by_window(torch.from_numpy(xyz[bi]),
                                         torch.from_numpy(mask[bi]), ws)
        valid_rank = sw.rank[:v][torch.from_numpy(mask[bi])[sw.order]]
        counts = torch.bincount(valid_rank)
        assert int(counts.max()) <= 2 * 128 and int((counts > 0).sum()) > 10

    port = WindowMultiheadSA(dim, heads, ws, pe_type=pe_type).eval()
    port.load_state_dict(convert_weights.from_flax(params, {}))
    with torch.no_grad():
        out = port(torch.from_numpy(feats), torch.from_numpy(xyz), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    assert (out.numpy()[~mask] == 0).all()
