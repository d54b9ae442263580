"""The stage-2 eval step on plumbing built in the step, against the JAX
package's in-program path, on the CPU: both parts of a batch without
``plumbing`` (the student's and the frozen teacher's clouds) are built by
the JAX step in the program and by the port on the device. With
``pallas_attention`` off both run the banded attention; with it on, the JAX
flash attention (Pallas, interpret mode) and the port's K3 plain version
sort their windows in the step. The tolerances are
``test_torch_student_eval.py``'s; f32 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2mkd_tpu.models.tsd import TSDFull as JaxTSDFull
from u2mkd_tpu.train import distill as jax_distill
from u2mkd_tpu.train import state as jax_state

from u2mkd_tpu_torch.models import convert_weights
from u2mkd_tpu_torch.models.tsd import TSDFull
from u2mkd_tpu_torch.train import distill

from test_torch_model import _random_variables
from test_torch_student_eval import GEOMETRY, NCLS, S_CAPS, T_CAPS, _check_student, _raw

torch.set_num_threads(2)


def _distill_parity(pallas):
    """``make_distill_eval_step`` with the teacher on a batch whose two
    parts carry no plumbing: the student's heads, predictions and counts
    and the teacher's counts as the JAX step's."""
    raw = _raw()
    model = JaxTSDFull(num_classes=NCLS, cr=0.25, cr_t=0.5, pallas_attention=pallas,
                       pallas_cubic=pallas, **GEOMETRY)
    batch = {part: {k: jnp.asarray(v) for k, v in raw[part].items()}
             for part in ("student", "teacher")}

    def init(sb, tb):
        return model.init(jax.random.PRNGKey(0), sb, jax_state.get_plumbing(sb, S_CAPS), tb,
                          jax_state.get_plumbing(tb, T_CAPS), False, True)

    variables = _random_variables(jax.eval_shape(init, batch["student"], batch["teacher"]), 11)
    st = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"], opt_state=())
    ref = jax.jit(jax_distill.make_distill_eval_step(model, S_CAPS, T_CAPS, NCLS,
                                                     run_teacher=True))(st, batch)
    port = TSDFull(num_classes=NCLS, cr=0.25, cr_t=0.5, pallas_attention=pallas,
                   pallas_cubic=pallas, **GEOMETRY).eval()
    port.load_state_dict(convert_weights.from_flax(variables["params"],
                                                   variables["batch_stats"]))
    assert all("plumbing" not in raw[p] for p in ("student", "teacher"))
    out = distill.make_distill_eval_step(port, S_CAPS, T_CAPS, NCLS, run_teacher=True)(raw)
    _check_student(out, ref, raw)
    for k in ("seen", "correct", "positive"):
        np.testing.assert_array_equal(out["counts_teacher"][k].numpy(),
                                      np.asarray(ref["counts_teacher"][k]))



def test_distill_eval_step_matches_jax_in_program():
    """The banded models (the JAX builder's default)."""
    _distill_parity(pallas=False)


@pytest.mark.slow
def test_distill_eval_step_matches_jax_in_program_flash():
    """The flash models, against the JAX flash attention in interpret
    mode."""
    _distill_parity(pallas=True)
