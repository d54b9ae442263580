"""The student split's parts (``u2mkd_tpu_torch/bench_parts.py --student``)
against the JAX package's, on the CPU, at the sizes of
``tests/test_torch_student_eval.py`` (one scan, P=512 student and 640
teacher points, 2 cameras at 32x48, ``TSDFull`` at cr=0.25 with the
cr_t=0.5 teacher, head dim 4, the same bridged random weights, f32; the JAX
side on its XLA paths, whose banded attention is exact at these
occupancies):

* (b) the student alone (``run_teacher=False``): Lovasz + CE of its voxel
  logits plus the learners' MSE, against JAX's ``run_teacher=False`` apply
  with the port's dropout and drop-path masks fed to JAX's draws: the loss
  to LOSS_RTOL, the gradients by the rule of
  ``tests/test_torch_lidar_only.py`` (the spread of one-ulp-nudged runs,
  masks of another seed missing it);
* (c) the frozen teacher's voxel logits against JAX's teacher forward in
  eval mode, within LOGIT_RTOL of the largest on the valid rows.
"""

import jax
import numpy as np
import pytest
import torch

from u2mkd_tpu.ops import losses as jax_losses
from u2mkd_tpu.train.state import get_plumbing

from test_torch_lidar_only import _inputs, _port, held_to_jax, port_run
from test_torch_remat import jax_draws
from test_torch_student_eval import LOGIT_RTOL, S_CAPS, T_CAPS, _jax_setup
from u2mkd_tpu_torch import bench_parts


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    return _jax_setup(pallas=False)


def test_student_alone_matches_jax(setup):
    """(b): the port's ``student_loss_grads`` against JAX's
    ``run_teacher=False`` apply (module docstring)."""
    raw, model, variables, batch = setup
    masks = []
    port = port_run(variables, raw, masks=masks, lidar_only=False)
    assert len(masks) == 10  # two dropouts, two drop paths in each of four blocks
    sb = batch["student"]
    labels = sb["labels"].reshape(-1)
    valid = (sb["pmask"] & (sb["labels"] != 0)).reshape(-1)

    def jax_loss(params, sb):
        out = model.apply({"params": params, "batch_stats": variables["batch_stats"]}, sb,
                          get_plumbing(sb, S_CAPS), None, None, True, run_teacher=False,
                          rngs={"dropout": jax.random.PRNGKey(2)},
                          mutable=["batch_stats"])[0]["stu"]
        x = out["x_vox"]
        return (jax_losses.lovasz_ce(x.reshape(-1, x.shape[-1]), labels, valid)
                + sum(out["mse_loss"]))

    with jax_draws(masks) as calls:
        loss_j, g = jax.jit(jax.value_and_grad(jax_loss))(variables["params"], sb)
    assert calls[0] >= len(masks) and calls[0] % len(masks) == 0
    held_to_jax("student (b)", variables, raw, port, (float(loss_j), g["model_s"]),
                lidar_only=False)


def test_teacher_forward_matches_jax(setup):
    """(c): ``bench_parts.teacher_forward`` against JAX's frozen teacher."""
    raw, model, variables, batch = setup
    tb = batch["teacher"]
    ref = jax.jit(lambda v, t: model.apply(
        v, t["feats"], get_plumbing(t, T_CAPS), False,
        method=lambda m, f, p, train: m.model_t(f, p, train)))(variables, tb)["x_vox"]
    port = _port(variables)
    out = bench_parts.teacher_forward(port, _inputs(port, raw))
    assert not out.requires_grad and not port.model_t.training
    rows = raw["teacher"]["pmask"]
    want = np.asarray(ref)[rows]
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(out.numpy()[rows], want, rtol=0,
                               atol=LOGIT_RTOL * np.abs(want).max())
