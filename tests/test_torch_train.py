"""The port's teacher train step against the JAX package's, on the CPU: the
slice as a whole.

The JAX ``make_train_step`` runs on its XLA paths (``pallas_attention=False``,
no TPU conv tiling), the port's on the plain versions of its kernels, with
the same bridged random weights, the same scans, ``sgd_spformer`` at lr 0.02,
and dropout and drop path at 0 (both frameworks draw other random bits).
Compared: the loss, every gradient, and every parameter and BN running
statistic after two steps (the second exercises the momentum). The banded
JAX attention is exact while every window holds at most ``band * tile``
keys, which the test asserts. f32 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2mkd_tpu.data import plumbing_host as jax_plumbing_host
from u2mkd_tpu.data import synthetic as jax_synthetic
from u2mkd_tpu.data import wgeom_host as jax_wgeom_host
from u2mkd_tpu.models.plumbing import from_precomputed as jax_from_precomputed
from u2mkd_tpu.models.spvcnn import SPVCNN as JaxSPVCNN
from u2mkd_tpu.ops import losses as jax_losses
from u2mkd_tpu.train import optim as jax_optim
from u2mkd_tpu.train import state as jax_state

from test_torch_model import _random_variables
from u2mkd_tpu_torch.data import plumbing_host, wgeom_host
from u2mkd_tpu_torch.models import convert_weights
from u2mkd_tpu_torch.models.spvcnn import teacher_model
from u2mkd_tpu_torch.train import optim, state

CAPS = (256, 128, 64, 32, 16)
NUM_CLASSES = 5
LR = 0.02
# f32 through ~40 layers forward and back, with batch-statistic BN and the
# Lovász sort: sums in another order (XLA's dot, scatter and segment sums
# against PyTorch's matmul and index_add). The loss agrees to 1e-5; each
# gradient to 1e-4 of its parameter's largest gradient entry. A bias
# followed by batch-statistic BN has a true gradient of 0, which both sides
# give as f32 noise (~1e-9): a gradient's scale is floored at GRAD_FLOOR of
# the model's largest gradient entry. After two steps each parameter's and
# BN statistic's change agrees to 1e-2 of its scale: the second step's
# gradients come from parameters that already differ by f32 rounding, and
# this model's gradients move far more than their inputs (ReLUs and Lovász
# sort positions flip; level 4 normalizes over at most 16 voxels). The
# change of `down0_conv.conv0.kernel` has differed by 2e-4 and by 1.2e-3 of
# its scale on one machine under two thread layouts of the CPU reductions
# (one pytest process, and six xdist workers).
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-3
UPDATE_RTOL = 1e-2


def _jax_teacher(**kw):
    ws = 0.3 * 6
    return JaxSPVCNN(
        num_classes=NUM_CLASSES, cr=0.25, sphereformer=True, window_size=(ws, ws, ws),
        quant_size=(ws / 24,) * 3, window_size_sphere=(2.0, 2.0, 120.0),
        quant_size_sphere=(2.0 / 24, 2.0 / 24, 5.0), window_size_scale=(2.0, 2.0),
        dropout_rate=0.0, drop_path_rate=0.0, sphere_a=0.0125, head_dim=4, **kw)


def _compare(name, got, ref, rtol, floor=0.0):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape, name
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * max(np.abs(ref).max(), floor),
                               err_msg=name)


def _train_parity(pallas: bool):
    model = _jax_teacher(pallas_attention=pallas, pallas_cubic=pallas)
    port = teacher_model(num_classes=NUM_CLASSES, cr=0.25, voxel_size=0.3, head_dim=4,
                         device="cpu", dropout_rate=0.0, drop_path_rate=0.0)
    batches = []
    for seed in (3, 4):
        raw = jax_synthetic.make_batch(np.random.RandomState(seed), 1, 512, voxel_size=0.3,
                                       num_sweep_factor=2)
        pl = jax_plumbing_host.batch_plumbing(
            raw["pcoords"], raw["xyz"], raw["pmask"], CAPS,
            wgeom_params=jax_wgeom_host.params_from_model(model) if pallas else None)
        if not pallas:  # no TPU conv tiling: the convs take the XLA gather path
            pl = {k: v for k, v in pl.items() if not k.startswith("cr27")}
        batch_j = {k: jnp.asarray(v) for k, v in raw.items()}
        batch_j["plumbing"] = jax.tree_util.tree_map(jnp.asarray, pl)
        arrays = plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"], CAPS,
                                              wgeom_params=wgeom_host.params_from_model(port))
        if not pallas:  # the banded JAX attention is exact at these occupancies
            assert max(int(g["occ"].max()) for g in arrays["wgeom"]["sphere"]) <= 4 * 128
            assert max(int(g["occ"].max()) for g in arrays["wgeom"]["cubic"]) <= 128
        batches.append((batch_j, dict(raw, plumbing=arrays)))

    batch_j = batches[0][0]
    abstract = jax.eval_shape(
        lambda f, a: model.init(jax.random.PRNGKey(0), f,
                                jax_from_precomputed(a, batch_j["pmask"]), False),
        batch_j["feats"], batch_j["plumbing"])
    variables = _random_variables(abstract, 7)
    tx = jax_optim.make_optimizer("sgd_spformer", LR)
    st = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]))

    def loss_fn(params, bstats, batch):
        out, _ = model.apply({"params": params, "batch_stats": bstats}, batch["feats"],
                             jax_state.get_plumbing(batch, CAPS), True,
                             rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        logits = out["x_vox"]
        valid = batch["pmask"] & batch["keyframe_mask"] & (batch["labels"] != 0)
        return jax_losses.lovasz_ce(logits.reshape(-1, NUM_CLASSES),
                                    batch["labels"].reshape(-1), valid.reshape(-1))

    loss_ref, grads_ref = jax.jit(jax.value_and_grad(loss_fn))(st.params, st.batch_stats,
                                                               batch_j)
    step_j = jax.jit(jax_state.make_train_step(model, tx, CAPS))

    start = convert_weights.from_flax(variables["params"], variables["batch_stats"])
    port.load_state_dict(start)
    opt, _ = optim.make_optimizer(port.named_parameters(), "sgd_spformer", LR)
    step_fn = state.make_train_step(port, opt, CAPS)

    for i, (bj, bp) in enumerate(batches):
        st, aux = step_j(st, bj, jax.random.PRNGKey(1))
        loss = step_fn(bp)["loss"]
        np.testing.assert_allclose(loss.item(), float(aux["loss"]), rtol=LOSS_RTOL)
        if i == 0:
            np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=LOSS_RTOL)
            ref = convert_weights.from_flax(jax.tree_util.tree_map(np.asarray, grads_ref), {})
            named = dict(port.named_parameters())
            assert sorted(ref) == sorted(named)
            floor = GRAD_FLOOR * max(float(t.abs().max()) for t in ref.values())
            assert floor > 0
            for name, g in ref.items():
                assert named[name].grad is not None, name
                _compare(f"grad {name}", named[name].grad, g, GRAD_RTOL, floor)

    ref = convert_weights.from_flax(jax.tree_util.tree_map(np.asarray, st.params),
                                    jax.tree_util.tree_map(np.asarray, st.batch_stats))
    got = port.state_dict()
    assert sorted(ref) == sorted(got)
    for name, t in ref.items():
        p0, p_ref, p_got = start[name].numpy(), t.numpy(), got[name].numpy()
        # the change over two steps to UPDATE_RTOL of its scale, plus two f32
        # ulps of the parameter itself
        atol = (UPDATE_RTOL * np.abs(p_ref - p0).max()
                + 2 * np.spacing(np.abs(p_ref).max().astype(np.float32)))
        np.testing.assert_allclose(p_got, p_ref, rtol=0, atol=atol, err_msg=name)


def test_train_step_matches_jax():
    """The slice as a whole against the JAX package's XLA paths."""
    _train_parity(pallas=False)


@pytest.mark.slow
def test_train_step_matches_jax_pallas():
    """The slice as a whole against the JAX package's Pallas path (rulebook
    conv and flash attention with their custom VJPs, interpret mode on the
    CPU)."""
    _train_parity(pallas=True)
