"""The camera-free student, ``TSDFull.lidar_only``, in training mode, on the
CPU.

The port's ``lidar_only`` took no generator, so in training mode the
student's dropout (rate 0.3) raised for want of one; JAX's
``lidar_only(..., train=True)`` draws from its dropout key. It now takes
``generator`` and ``remat`` as ``forward`` does. At the sizes of
``tests/test_torch_student_eval.py`` (one scan, P=512, ``TSDFull`` at cr=0.25
with the cr_t=0.5 teacher, head dim 4, the same bridged random weights on
both sides, f32; the JAX side on its XLA paths):

* without a generator the train-mode call still raises the ``ValueError``
  (the parent's call, which passed none), with one it runs;
* the eval output is bitwise the parent's call's, with or without a
  generator;
* ``remat=True`` gives the loss and gradients of ``remat=False`` bitwise;
* the Lovasz + CE loss of its voxel logits (``bench_parts.student_loss_grads``
  with ``lidar_only``) matches JAX ``lidar_only(train=True)`` to LOSS_RTOL,
  the port's dropout masks fed to JAX's draws; its gradients are held by the
  rule of ``tests/test_torch_distill.py`` (within GRAD_SPREADS times the
  median spread of three port runs from weights nudged by about one ulp,
  never tighter than GRAD_RTOL), and a planted fault, masks drawn from
  another seed, misses that bound by FAULT_MARGIN.
"""

import jax
import numpy as np
import pytest
import torch

from u2mkd_tpu.models.tsd import TSDFull as JaxTSDFull
from u2mkd_tpu.ops import losses as jax_losses
from u2mkd_tpu.train.state import get_plumbing

from test_torch_distill import (FAULT_MARGIN, GRAD_RTOL, GRAD_SPREADS, LOSS_RTOL, NUDGE_SEEDS,
                                _grad_diff, _nudged)
from test_torch_remat import jax_draws, recorded_masks
from test_torch_student_eval import GEOMETRY, NCLS, S_CAPS, T_CAPS, _jax_setup
from u2mkd_tpu_torch import bench_parts
from u2mkd_tpu_torch.data import plumbing_host, wgeom_host
from u2mkd_tpu_torch.models import convert_weights
from u2mkd_tpu_torch.models.tsd import TSDFull
from u2mkd_tpu_torch.ops import losses

GEN_SEED = 8


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: bitwise comparisons need one order of the sums, and
    the tier-1 run shares the cores among its workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    return _jax_setup(pallas=False)


def _port(variables):
    port = TSDFull(num_classes=NCLS, cr=0.25, cr_t=0.5, pallas_attention=True, **GEOMETRY)
    port.load_state_dict(convert_weights.from_flax(variables["params"],
                                                   variables["batch_stats"]))
    return port


def _inputs(port, raw):
    batch = {}
    for part, caps, sub in (("student", S_CAPS, port.model_s), ("teacher", T_CAPS, port.model_t)):
        b = raw[part]
        batch[part] = dict(b, plumbing=plumbing_host.batch_plumbing(
            b["pcoords"], b["xyz"], b["pmask"], caps,
            wgeom_params=wgeom_host.params_from_model(sub)))
    return bench_parts.student_inputs(port, batch, S_CAPS, T_CAPS)


def _remat_lidar_only_loss_grads(port, inputs, gen):
    """``bench_parts.student_loss_grads(..., lidar_only=True)`` with
    ``remat=True``."""
    port.train()
    x = port.lidar_only({"feats": inputs["s_in"]["feats"]}, inputs["spl"], generator=gen,
                        remat=True)["x_vox"]
    loss = losses.lovasz_ce(x.reshape(-1, x.shape[-1]), inputs["labels"], inputs["valid"])
    names, params = zip(*port.model_s.named_parameters())
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, params, allow_unused=True)))


def port_run(variables, raw, seed=GEN_SEED, masks=None, remat=False, lidar_only=True):
    """The port's train-mode student loss and gradients
    (``bench_parts.student_loss_grads``) from fresh bridged weights, its
    masks drawn from a generator of ``seed`` (appended to ``masks``) ->
    (loss, {name: numpy gradient, zeros where the loss does not reach})."""
    port = _port(variables)
    inputs = _inputs(port, raw)
    gen = torch.Generator().manual_seed(seed)
    with recorded_masks([] if masks is None else masks):
        if remat:
            loss, grads = _remat_lidar_only_loss_grads(port, inputs, gen)
        else:
            loss, grads = bench_parts.student_loss_grads(port, inputs, gen,
                                                         lidar_only=lidar_only)
    return loss.item(), {n: np.zeros(p.shape, np.float32) if grads[n] is None
                         else grads[n].numpy() for n, p in port.model_s.named_parameters()}


def held_to_jax(what, variables, raw, port, ref, lidar_only):
    """The port's first-call ``(loss, grads)`` against JAX's ``ref`` (its
    loss and flax gradient tree of the student): the loss to LOSS_RTOL,
    the gradients by the rule of the module docstring, which masks of
    another seed must miss by FAULT_MARGIN."""
    loss, grads = port
    grads_j = {k: v.numpy() for k, v in convert_weights.from_flax(
        jax.tree_util.tree_map(np.asarray, ref[1]), {}).items()}
    np.testing.assert_allclose(loss, ref[0], rtol=LOSS_RTOL)
    assert sorted(grads) == sorted(grads_j)
    spreads = [_grad_diff(port_run(_nudged(variables, s), raw, lidar_only=lidar_only)[1],
                          grads)[0] for s in NUDGE_SEEDS]
    tol = max(GRAD_RTOL, GRAD_SPREADS * float(np.median(spreads)))
    err, name = _grad_diff(grads, grads_j)
    fault, fault_name = _grad_diff(
        port_run(variables, raw, seed=GEN_SEED + 1, lidar_only=lidar_only)[1], grads_j)
    print(f"{what} gradients against JAX {err:.3g} ({name}) of tol {tol:.3g}; "
          f"masks of another seed {fault / tol:.3g}x ({fault_name})")
    assert err <= tol, (name, err, tol)
    assert fault >= FAULT_MARGIN * tol, (fault_name, fault, tol)


def test_train_mode_needs_a_generator_and_eval_is_unchanged(setup):
    """The parent's call (no generator) raises in training mode; with a
    generator it runs; in eval mode the output is bitwise the parent's
    call's with or without a generator, and training mode leaves the
    teacher in eval mode."""
    raw, _, variables, _ = setup
    port = _port(variables)
    inputs = _inputs(port, raw)
    feats = {"feats": inputs["s_in"]["feats"]}
    port.train()
    with pytest.raises(ValueError, match="torch.Generator"):
        port.lidar_only(feats, inputs["spl"])
    with pytest.raises(ValueError, match="torch.Generator"):
        port.model_s(feats["feats"], inputs["spl"], None, None, None, None, lidar_only=True)
    with torch.no_grad():
        out = port.lidar_only(feats, inputs["spl"], generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(out["x_vox"]).all() and not port.model_t.training
    port.eval()
    with torch.no_grad():
        parent = port.model_s(feats["feats"], inputs["spl"], None, None, None, None,
                              lidar_only=True)["x_vox"]
        for gen in (None, torch.Generator().manual_seed(1)):
            assert torch.equal(port.lidar_only(feats, inputs["spl"], generator=gen)["x_vox"],
                               parent)


def test_remat_equals_no_remat(setup):
    """``remat=True`` reaches the student: the same loss and gradients
    bitwise, the same masks drawn."""
    raw, _, variables, _ = setup
    masks = [[], []]
    plain = port_run(variables, raw, masks=masks[0])
    remat = port_run(variables, raw, masks=masks[1], remat=True)
    assert plain[0] == remat[0]
    assert all(np.array_equal(plain[1][n], remat[1][n]) for n in plain[1])
    assert len(masks[0]) == 2 and all(np.array_equal(a, b) for a, b in zip(*masks))


def test_lidar_only_train_matches_jax(setup):
    """The repaired path against JAX ``lidar_only(train=True)`` with the
    port's masks (module docstring)."""
    raw, model, variables, batch = setup
    masks = []
    loss, grads = port_run(variables, raw, masks=masks)
    assert len(masks) == 2  # the decoder's two dropouts; no attention on this path
    sb = batch["student"]
    labels = sb["labels"].reshape(-1)
    valid = (sb["pmask"] & (sb["labels"] != 0)).reshape(-1)

    def jax_loss(params, sb):
        out = model.apply({"params": params, "batch_stats": variables["batch_stats"]}, sb,
                          get_plumbing(sb, S_CAPS), True, method=JaxTSDFull.lidar_only,
                          rngs={"dropout": jax.random.PRNGKey(2)}, mutable=["batch_stats"])[0]
        x = out["x_vox"]
        return jax_losses.lovasz_ce(x.reshape(-1, x.shape[-1]), labels, valid)

    with jax_draws(masks) as calls:
        loss_j, g = jax.jit(jax.value_and_grad(jax_loss))(variables["params"], sb)
    assert calls[0] >= len(masks) and calls[0] % len(masks) == 0
    held_to_jax("lidar_only", variables, raw, (loss, grads), (float(loss_j), g["model_s"]),
                lidar_only=True)
