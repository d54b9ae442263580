"""The PyTorch port's model against the JAX package, on the CPU.

The same numpy inputs and the same (bridged) weights go through both; f32 on
both sides. The JAX side runs its XLA paths (``pallas_attention=False``, no
TPU conv tiling): the package's own oracles for the Pallas kernels. Its
banded attention is exact while every window holds at most ``band * tile``
keys, which the slice test asserts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2mkd_tpu.data import plumbing_host as jax_plumbing_host
from u2mkd_tpu.data import synthetic as jax_synthetic
from u2mkd_tpu.models import blocks as jax_blocks
from u2mkd_tpu.models import sphereformer as jax_sphereformer
from u2mkd_tpu.models.plumbing import from_precomputed as jax_from_precomputed
from u2mkd_tpu.models.spvcnn import SPVCNN as JaxSPVCNN
from u2mkd_tpu.train import state as jax_state

from u2mkd_tpu_torch.data import wgeom_host
from u2mkd_tpu_torch.models import blocks, convert_weights
from u2mkd_tpu_torch.models.plumbing import _window_geom_from_arrays
from u2mkd_tpu_torch.models.sphereformer import SphereFormerBlock
from u2mkd_tpu_torch.models.spvcnn import teacher_model
from u2mkd_tpu_torch.train import metrics, state

# f32 sums in another order (XLA's dot and scatter vs PyTorch's matmul and
# index_add) through ~40 layers: agreement to a few f32 ulps of the largest
# logit, well inside 1e-4 of it.
LOGIT_RTOL = 1e-4
CAPS = (256, 128, 64, 32, 16)


def _random_variables(abstract, seed):
    """Fill an abstract flax variable tree with random values at the scales
    the layers are initialized at (BN stats off their identity values, so
    eval-mode BN is exercised)."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel" and len(shape) == 4:       # flax nn.Conv, HWIO
            return rng.randn(*shape) * (2.0 / np.prod(shape[:3])) ** 0.5
        if name == "kernel" and len(shape) == 3:
            b = (shape[0] * shape[1]) ** -0.5
            return rng.uniform(-b, b, shape)
        if name == "kernel":
            return rng.randn(*shape) / np.sqrt(shape[0])
        if name.startswith("rel_"):
            return 0.02 * rng.randn(*shape)
        if name == "scale":
            return 1.0 + 0.1 * rng.randn(*shape)
        if name in ("bias", "mean"):
            return 0.1 * rng.randn(*shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape)
        raise KeyError(name)

    return jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(fill(p, x), np.float32), abstract)


def _jax_teacher(**kw):
    ws = 0.3 * 6
    return JaxSPVCNN(
        num_classes=5, cr=0.25, sphereformer=True, window_size=(ws, ws, ws),
        quant_size=(ws / 24,) * 3, window_size_sphere=(2.0, 2.0, 120.0),
        quant_size_sphere=(2.0 / 24, 2.0 / 24, 5.0), window_size_scale=(2.0, 2.0),
        drop_path_rate=0.3, sphere_a=0.0125, head_dim=4, **kw)


def test_masked_batchnorm_matches_flax(rng):
    x = rng.randn(2, 50, 6).astype(np.float32)
    mask = rng.rand(2, 50) < 0.7
    ref_mod = jax_blocks.MaskedBatchNorm(6)
    variables = _random_variables(
        jax.eval_shape(lambda: ref_mod.init(jax.random.PRNGKey(0), x, mask, False)), 1)
    port = blocks.MaskedBatchNorm(6)
    port.load_state_dict(convert_weights.from_flax(variables["params"],
                                                   variables["batch_stats"]))
    for train in (False, True):
        ref, new_vars = ref_mod.apply(variables, x, mask, train, mutable=["batch_stats"])
        port.train(train)
        out = port(torch.from_numpy(x), torch.from_numpy(mask))
        # f32 mean/variance sums over 100 rows: a few ulps
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(new_vars["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_heads", [2, 4])
def test_sphereformer_block_matches_flax(rng, n_heads):
    """SphereFormerBlock (LayerNorm eps 1e-6, tanh GELU, both attention
    branches over host geometry) against the flax block's banded XLA path."""
    b, v, d = 1, 300, 4
    dim = n_heads * d
    ws, qs = (3.0,) * 3, (3.0 / 8,) * 3
    wss, qss = (40.0, 40.0, 120.0), (5.0, 5.0, 5.0)
    xyz = rng.uniform(-10, 10, (b, v, 3)).astype(np.float32)
    mask = rng.rand(b, v) < 0.9
    feats = rng.randn(b, v, dim).astype(np.float32)
    ref_mod = jax_sphereformer.SphereFormerBlock(
        dim=dim, num_heads=n_heads, window_size=ws, window_size_sphere=wss,
        quant_size=qs, quant_size_sphere=qss, drop_path=0.2)
    params = _random_variables(jax.eval_shape(
        lambda: ref_mod.init(jax.random.PRNGKey(0), feats, xyz, mask, False)), 2)["params"]
    ref = ref_mod.apply({"params": params}, feats, xyz, mask, False)

    geom = {}
    for branch, coords, w_, q_ in (("cubic", xyz, ws, qs),
                                   ("sphere", wgeom_host.cart2sphere(xyz), wss, qss)):
        g = wgeom_host.branch_geometry(coords, mask, w_, q_, 128, branch == "sphere")
        assert g["occ"][0] <= 128, "banded reference would truncate"
        geom[branch] = _window_geom_from_arrays(g, "cpu")
    port = SphereFormerBlock(dim, n_heads, ws, wss, qs, qss, drop_path=0.2,
                             pallas_attention=True).eval()
    port.load_state_dict(convert_weights.from_flax(params, {}))
    with torch.no_grad():
        out = port(torch.from_numpy(feats), None, torch.from_numpy(mask), geom)
    # f32, different summation order in softmax and projections
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_weight_bridge_covers_every_leaf():
    """Every flax leaf lands on a port parameter or buffer of the same
    shape, and every port parameter and buffer is covered."""
    model = _jax_teacher()
    raw = jax_synthetic.make_batch(np.random.RandomState(0), 1, 512, voxel_size=0.3)
    pl = jax_plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"], CAPS)
    pl = {k: v for k, v in pl.items() if not k.startswith("cr27")}
    abstract = jax.eval_shape(
        lambda f, a: model.init(jax.random.PRNGKey(0), f,
                                jax_from_precomputed(a, jnp.asarray(raw["pmask"])), False),
        raw["feats"], pl)
    variables = _random_variables(abstract, 0)
    sd = convert_weights.from_flax(variables["params"], variables["batch_stats"])
    port = teacher_model(num_classes=5, cr=0.25, voxel_size=0.3, head_dim=4, device="cpu")
    want = port.state_dict()
    assert sorted(sd) == sorted(want)
    for k, t in sd.items():
        assert tuple(t.shape) == tuple(want[k].shape), k
    lin = sd["sphereformer1.attn.qkv.weight"].numpy()
    np.testing.assert_array_equal(
        lin, variables["params"]["sphereformer1"]["attn"]["qkv"]["kernel"].T)


def _eval_step_parity(pallas: bool):
    """JAX ``make_eval_step`` against the port's on one synthetic scan
    (P=512, cr=0.25, head_dim 4) with the same weights: logits, argmax
    predictions and IoU counts. The port builds its own host plumbing."""
    from u2mkd_tpu.data import wgeom_host as jax_wgeom_host
    from u2mkd_tpu_torch.data import plumbing_host

    raw = jax_synthetic.make_batch(np.random.RandomState(3), 1, 512, voxel_size=0.3)
    model = _jax_teacher(pallas_attention=pallas, pallas_cubic=pallas)
    pl = jax_plumbing_host.batch_plumbing(
        raw["pcoords"], raw["xyz"], raw["pmask"], CAPS,
        wgeom_params=jax_wgeom_host.params_from_model(model) if pallas else None)
    if not pallas:  # no TPU conv tiling: the convs take the XLA gather path
        pl = {k: v for k, v in pl.items() if not k.startswith("cr27")}
    pl_j = jax.tree_util.tree_map(jnp.asarray, pl)
    pmask_j = jnp.asarray(raw["pmask"])
    abstract = jax.eval_shape(
        lambda f, a: model.init(jax.random.PRNGKey(0), f,
                                jax_from_precomputed(a, pmask_j), False),
        raw["feats"], pl_j)
    variables = _random_variables(abstract, 7)
    st = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"], opt_state=())
    batch_j = {k: jnp.asarray(v) for k, v in raw.items()}
    batch_j["plumbing"] = pl_j
    ref = jax.jit(jax_state.make_eval_step(model, CAPS, 5))(st, batch_j)

    port = teacher_model(num_classes=5, cr=0.25, voxel_size=0.3, head_dim=4, device="cpu")
    port.load_state_dict(convert_weights.from_flax(variables["params"],
                                                   variables["batch_stats"]))
    arrays = plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"], CAPS,
                                          wgeom_params=wgeom_host.params_from_model(port))
    if not pallas:  # the banded JAX attention is exact at these occupancies
        assert max(int(g["occ"].max()) for g in arrays["wgeom"]["sphere"]) <= 4 * 128
        assert max(int(g["occ"].max()) for g in arrays["wgeom"]["cubic"]) <= 128
    out = state.make_eval_step(port, CAPS, 5)(dict(raw, plumbing=arrays))

    logits_ref = np.asarray(ref["logits"])
    logits = out["logits"].numpy()
    valid = raw["pmask"]
    scale = np.abs(logits_ref[valid]).max()
    assert scale > 1e-2, "degenerate logits make the comparison vacuous"
    np.testing.assert_allclose(logits[valid], logits_ref[valid], rtol=0,
                               atol=LOGIT_RTOL * scale)
    pred_ref = np.asarray(ref["pred"])
    np.testing.assert_array_equal(out["pred"].numpy()[valid], pred_ref[valid])
    for key in ("seen", "correct", "positive"):
        np.testing.assert_array_equal(out["counts"][key].numpy(),
                                      np.asarray(ref["counts"][key]))
    miou, _ = metrics.compute_miou({k: v.numpy() for k, v in out["counts"].items()})
    assert 0.0 <= miou <= 1.0


def test_eval_step_matches_jax():
    """The slice as a whole against the JAX package's XLA paths."""
    _eval_step_parity(pallas=False)


@pytest.mark.slow
def test_eval_step_matches_jax_pallas():
    """The slice as a whole against the JAX package's Pallas path (rulebook
    conv and flash attention, interpret mode on the CPU)."""
    _eval_step_parity(pallas=True)
