"""The port's conv-only SPVCNN (``SPVCNN(sphereformer=False)``, the
``spvcnn`` model name) against the JAX package's, on the CPU.

The same bridged random weights and scans go through both: the eval step's
logits, and one train step's loss and gradients, held as
``tests/test_torch_train.py`` holds the SphereFormer teacher's. The JAX
side runs its XLA convs (no TPU conv tiling), the port its kernels' plain
versions. The conv-only model reads no window geometry, so its batches
carry none (``wgeom_host.params_from_model`` gives None).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from u2mkd_tpu.data import plumbing_host as jax_plumbing_host
from u2mkd_tpu.data import synthetic as jax_synthetic
from u2mkd_tpu.models.plumbing import from_precomputed as jax_from_precomputed
from u2mkd_tpu.models.spvcnn import SPVCNN as JaxSPVCNN
from u2mkd_tpu.ops import losses as jax_losses
from u2mkd_tpu.train import state as jax_state

from u2mkd_tpu_torch.data import plumbing_host, wgeom_host
from u2mkd_tpu_torch.models import convert_weights
from u2mkd_tpu_torch.models.spvcnn import SPVCNN
from u2mkd_tpu_torch.train import builder, optim, state
from u2mkd_tpu_torch.utils import config

from test_torch_model import LOGIT_RTOL, _random_variables
from test_torch_train import GRAD_FLOOR, GRAD_RTOL, LOSS_RTOL, _compare

torch.set_num_threads(2)

CAPS = (256, 128, 64, 32, 16)
NCLS = 5


def _setup(seed):
    raw = jax_synthetic.make_batch(np.random.RandomState(seed), 1, 512, voxel_size=0.3)
    pl = jax_plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"], CAPS)
    pl = {k: v for k, v in pl.items() if not k.startswith("cr27")}
    batch_j = {k: jnp.asarray(v) for k, v in raw.items()}
    batch_j["plumbing"] = jax.tree_util.tree_map(jnp.asarray, pl)
    model = JaxSPVCNN(num_classes=NCLS, cr=0.25, dropout_rate=0.0)
    abstract = jax.eval_shape(
        lambda f, a: model.init(jax.random.PRNGKey(0), f,
                                jax_from_precomputed(a, batch_j["pmask"]), False),
        batch_j["feats"], batch_j["plumbing"])
    variables = _random_variables(abstract, seed + 10)
    port = SPVCNN(num_classes=NCLS, cr=0.25, sphereformer=False, dropout_rate=0.0)
    sd = convert_weights.from_flax(variables["params"], variables["batch_stats"])
    assert sorted(sd) == sorted(port.state_dict())
    port.load_state_dict(sd)
    assert wgeom_host.params_from_model(port) is None
    arrays = plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"], CAPS,
                                          wgeom_params=wgeom_host.params_from_model(port))
    assert "wgeom" not in arrays
    return raw, model, variables, batch_j, port, dict(raw, plumbing=arrays)


def test_builder_makes_the_conv_only_model():
    """``model.name=spvcnn`` builds the conv-only U-Net: every module of the
    SphereFormer teacher but its attention blocks."""
    cfg = config.load("configs/synthetic/train/spformer_tiny.yaml")
    config.update_dotted(cfg, ["model.name=spvcnn", "model.cr=0.25"])
    model = builder.make_model(cfg, "cpu")
    assert isinstance(model, SPVCNN) and not model.sphereformer
    teacher = SPVCNN(num_classes=cfg.data.num_classes, cr=0.25, in_channel=cfg.model.in_channel,
                     head_dim=4)
    want = {k for k in teacher.state_dict() if not k.startswith("sphereformer")}
    assert set(model.state_dict()) == want


def test_conv_only_eval_step_matches_jax():
    """Logits within 1e-4 of the JAX step's largest; predictions and IoU
    counters equal."""
    raw, model, variables, batch_j, port, batch = _setup(3)
    st = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"], opt_state=())
    ref = jax.jit(jax_state.make_eval_step(model, CAPS, NCLS))(st, batch_j)
    out = state.make_eval_step(port, CAPS, NCLS)(batch)
    valid = raw["pmask"]
    want = np.asarray(ref["logits"])[valid]
    scale = np.abs(want).max()
    assert scale > 1e-2
    np.testing.assert_allclose(out["logits"].numpy()[valid], want, rtol=0,
                               atol=LOGIT_RTOL * scale)
    np.testing.assert_array_equal(out["pred"].numpy()[valid], np.asarray(ref["pred"])[valid])
    for k in ("seen", "correct", "positive"):
        np.testing.assert_array_equal(out["counts"][k].numpy(), np.asarray(ref["counts"][k]))


def test_conv_only_train_step_matches_jax():
    """One train step (dropout off): the loss to 1e-5, every gradient to
    1e-4 of its parameter's largest gradient entry, floored as the
    teacher's test floors it."""
    raw, model, variables, batch_j, port, batch = _setup(4)

    def loss_fn(params, bstats, b):
        out, _ = model.apply({"params": params, "batch_stats": bstats}, b["feats"],
                             jax_state.get_plumbing(b, CAPS), True,
                             rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        valid = b["pmask"] & b["keyframe_mask"] & (b["labels"] != 0)
        return jax_losses.lovasz_ce(out["x_vox"].reshape(-1, NCLS), b["labels"].reshape(-1),
                                    valid.reshape(-1))

    loss_ref, grads_ref = jax.jit(jax.value_and_grad(loss_fn))(
        variables["params"], variables["batch_stats"], batch_j)
    opt, _ = optim.make_optimizer(port.named_parameters(), "sgd", 0.02)
    loss = state.make_train_step(port, opt, CAPS)(batch)["loss"]
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=LOSS_RTOL)
    ref = convert_weights.from_flax(jax.tree_util.tree_map(np.asarray, grads_ref), {})
    named = dict(port.named_parameters())
    assert sorted(ref) == sorted(named)
    floor = GRAD_FLOOR * max(float(t.abs().max()) for t in ref.values())
    for name, g in ref.items():
        _compare(f"grad {name}", named[name].grad, g, GRAD_RTOL, floor)
