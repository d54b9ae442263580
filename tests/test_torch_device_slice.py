"""The slice as a whole on plumbing built in the step, against the JAX
package's in-program path, on the CPU.

Batches without ``plumbing`` go through both packages' steps: the JAX steps
build the plumbing in the program (``get_plumbing``), the port's on the
device (``train/state.batch_reader``), in the same packed-key row order.
With ``pallas_attention`` off both run the banded attention (dropping the
same pairs); with it on, the JAX flash attention sorts its windows in the
program (Pallas in interpret mode) and the port's K3 plain version sorts
them in the step. The tolerances are those of the host-plumbing twins
(``test_torch_model.py``, ``test_torch_train.py``); f32 on both sides.
The stage-2 eval step's twin is ``test_torch_device_distill.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2mkd_tpu.data import synthetic as jax_synthetic
from u2mkd_tpu.models import plumbing as jax_plumbing
from u2mkd_tpu.ops import losses as jax_losses
from u2mkd_tpu.train import overflow as jax_overflow
from u2mkd_tpu.train import state as jax_state

from u2mkd_tpu_torch.models import convert_weights
from u2mkd_tpu_torch.models import plumbing as P
from u2mkd_tpu_torch.models.spvcnn import teacher_model
from u2mkd_tpu_torch.train import optim, overflow, state

from test_torch_model import LOGIT_RTOL, _random_variables
from test_torch_train import (CAPS, GRAD_FLOOR, GRAD_RTOL, LOSS_RTOL, LR, NUM_CLASSES,
                              _compare, _jax_teacher)

torch.set_num_threads(2)


def _teacher(pallas):
    """The JAX teacher, its random variables, a scan without plumbing (numpy
    and JAX) and the port's teacher with the same weights and flags."""
    model = _jax_teacher(pallas_attention=pallas, pallas_cubic=pallas)
    raw = jax_synthetic.make_batch(np.random.RandomState(3), 1, 512, voxel_size=0.3,
                                   num_sweep_factor=2)
    batch_j = {k: jnp.asarray(v) for k, v in raw.items()}
    abstract = jax.eval_shape(
        lambda b: model.init(jax.random.PRNGKey(0), b["feats"],
                             jax_state.get_plumbing(b, CAPS), False), batch_j)
    variables = _random_variables(abstract, 7)
    port = teacher_model(num_classes=NUM_CLASSES, cr=0.25, voxel_size=0.3, head_dim=4,
                         device="cpu", dropout_rate=0.0, drop_path_rate=0.0,
                         pallas_attention=pallas)
    port.load_state_dict(convert_weights.from_flax(variables["params"],
                                                   variables["batch_stats"]))
    return model, variables, raw, batch_j, port


@pytest.mark.parametrize("pallas", [False, True], ids=["banded", "flash"])
def test_teacher_eval_step_matches_jax_in_program(pallas):
    """``make_eval_step`` on a scan without plumbing: logits to LOGIT_RTOL
    of the largest, predictions and IoU counts equal."""
    model, variables, raw, batch_j, port = _teacher(pallas)
    st = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"], opt_state=())
    ref = jax.jit(jax_state.make_eval_step(model, CAPS, NUM_CLASSES))(st, batch_j)
    assert "plumbing" not in raw
    out = state.make_eval_step(port, CAPS, NUM_CLASSES)(raw)
    valid = raw["pmask"]
    want = np.asarray(ref["logits"])[valid]
    scale = np.abs(want).max()
    assert scale > 1e-2
    np.testing.assert_allclose(out["logits"].numpy()[valid], want, rtol=0,
                               atol=LOGIT_RTOL * scale)
    np.testing.assert_array_equal(out["pred"].numpy()[valid], np.asarray(ref["pred"])[valid])
    for key in ("seen", "correct", "positive"):
        np.testing.assert_array_equal(out["counts"][key].numpy(),
                                      np.asarray(ref["counts"][key]))


def _train_parity(pallas):
    """One train step on a scan without plumbing: the loss and every
    gradient against JAX's ``value_and_grad`` of the same loss over its
    in-program plumbing."""
    model, variables, raw, batch_j, port = _teacher(pallas)

    def loss_fn(params, bstats, batch):
        out, _ = model.apply({"params": params, "batch_stats": bstats}, batch["feats"],
                             jax_state.get_plumbing(batch, CAPS), True,
                             rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        logits = out["x_vox"]
        valid = batch["pmask"] & batch["keyframe_mask"] & (batch["labels"] != 0)
        return jax_losses.lovasz_ce(logits.reshape(-1, NUM_CLASSES),
                                    batch["labels"].reshape(-1), valid.reshape(-1))

    loss_ref, grads_ref = jax.jit(jax.value_and_grad(loss_fn))(
        variables["params"], variables["batch_stats"], batch_j)
    opt, _ = optim.make_optimizer(port.named_parameters(), "sgd_spformer", LR)
    loss = state.make_train_step(port, opt, CAPS)(raw)["loss"]
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=LOSS_RTOL)
    ref = convert_weights.from_flax(jax.tree_util.tree_map(np.asarray, grads_ref), {})
    named = dict(port.named_parameters())
    assert sorted(ref) == sorted(named)
    floor = GRAD_FLOOR * max(float(t.abs().max()) for t in ref.values())
    for name, g in ref.items():
        _compare(f"grad {name}", named[name].grad, g, GRAD_RTOL, floor)


def test_teacher_train_step_matches_jax_in_program():
    """The banded model's train step on device-built plumbing."""
    _train_parity(pallas=False)


@pytest.mark.slow
def test_teacher_train_step_matches_jax_in_program_flash():
    """The flash model's train step on device-built plumbing, against the
    JAX flash attention's custom VJP in interpret mode."""
    _train_parity(pallas=True)


@pytest.mark.parametrize("pallas", [False, True], ids=["banded", "flash"])
def test_counters_on_device_plumbing_match_jax(pallas):
    """``stats_for_model`` over device-built plumbing (the occupancies
    computed in the step, SPVCNN's windows of levels 1-4) against JAX's over
    its in-program build: every counter, saturated capacities included."""
    model = _jax_teacher(pallas_attention=pallas, pallas_cubic=pallas)
    port = teacher_model(num_classes=NUM_CLASSES, cr=0.25, voxel_size=0.3, head_dim=4,
                         device="cpu", pallas_attention=pallas)
    raw = jax_synthetic.make_batch(np.random.RandomState(5), 2, 512, voxel_size=0.3)
    for caps in (CAPS, (512, 512, 384, 256, 128)):
        ref = jax.device_get(jax.jit(lambda a, x, m: jax_overflow.stats_for_model(
            model, jax_plumbing.build_plumbing(a, x, m, caps)))(
            raw["pcoords"], raw["xyz"], raw["pmask"]))
        pl = P.build_plumbing(*(torch.from_numpy(raw[k]) for k in ("pcoords", "xyz", "pmask")),
                              caps)
        got = overflow.stats_for_model(port, pl)
        assert sorted(got) == sorted(ref)
        for k, v in ref.items():
            if k.startswith("overflow/vox_fill"):
                np.testing.assert_allclose(got[k].item(), v, rtol=0, atol=1e-7, err_msg=k)
            else:
                assert got[k].item() == int(v), k
        assert len([k for k in got if k.startswith("overflow/occ_")]) == 8


def test_unet_eval_on_device_plumbing_matches_host_geometry():
    """The SphereFormer U-Net (exact at every level) on plumbing built in
    the step takes its windows on the recursive means of the device build,
    which equal the host twin's: its logits match the same request on host
    plumbing with host geometry of levels 0-4."""
    from u2mkd_tpu_torch.data import plumbing_host, wgeom_host
    from u2mkd_tpu_torch.models.sphereformer_unet import SphereFormerSemantic

    from test_torch_sphereformer_unet import GEOMETRY as UNET_GEOMETRY
    from test_torch_sphereformer_unet import N_PLANES, NUM_CLASSES as UNET_CLASSES, VOXEL

    raw = jax_synthetic.make_batch(np.random.RandomState(3), 1, 512, voxel_size=VOXEL,
                                   num_sweep_factor=2)
    port = SphereFormerSemantic(num_classes=UNET_CLASSES, n_planes=N_PLANES, head_dim=4,
                                drop_path_rate=0.0, generator=torch.Generator().manual_seed(2),
                                **UNET_GEOMETRY).eval()
    caps = (512, 512, 384, 256, 128)  # no grid full: both builds hold one voxel set
    eval_fn = state.make_eval_step(port, caps, UNET_CLASSES)
    out = eval_fn(raw)["logits"]
    arrays = plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"], caps,
                                          wgeom_params=wgeom_host.params_from_model(port))
    ref = eval_fn(dict(raw, plumbing=arrays))["logits"]
    valid = torch.from_numpy(raw["pmask"])
    scale = ref[valid].abs().max().item()
    assert scale > 1e-2
    assert (out[valid] - ref[valid]).abs().max().item() <= LOGIT_RTOL * scale
