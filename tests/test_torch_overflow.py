"""The port's capacity counters (``train/overflow.py``) against the JAX
package's ``stats_for_model``, on the CPU.

The same synthetic scan goes through each package's host plumbing with
window geometry, at capacities that hold it and at capacities planted too
small; the JAX side is its flash-attention teacher, whose attention, like
the port's kernels, is exact at any occupancy, so that only a saturated
grid violates. Then the train steps, the stage-2 step and the loop carry
and check the counters.
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
from u2mkd_tpu.train import overflow as jax_overflow

from u2mkd_tpu_torch.data import plumbing_host, synthetic, wgeom_host
from u2mkd_tpu_torch.models.plumbing import from_precomputed
from u2mkd_tpu_torch.models.spvcnn import teacher_model
from u2mkd_tpu_torch.models.tsd import TSDFull
from u2mkd_tpu_torch.train import distill, loop, optim, overflow, state

from test_torch_model import _jax_teacher
from test_torch_student_eval import GEOMETRY

torch.set_num_threads(2)

# the synthetic scans at 0.3 m hold ~420-450 of their 512 points in ~420-450
# level-0 voxels, ~300 at level 2, ~80 at level 4; the stage-2 teacher's
# 640 points ~640, ~510 and ~190
GENEROUS = (512, 512, 384, 256, 128)
TEACHER_GENEROUS = (768, 768, 640, 512, 256)
# capacities halving per level from 256: every level saturates
PLANTED = (256, 128, 64, 32, 16)


def _counters(caps):
    raw = jax_synthetic.make_batch(np.random.RandomState(5), 1, 512, voxel_size=0.3)
    model = _jax_teacher(pallas_attention=True, pallas_cubic=True)
    pl = jax_plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"], caps,
                                          wgeom_params=jax_wgeom_host.params_from_model(model))
    jpl = jax_from_precomputed(jax.tree_util.tree_map(jnp.asarray, pl), jnp.asarray(raw["pmask"]))
    ref = jax.device_get(jax_overflow.stats_for_model(model, jpl))

    port = teacher_model(num_classes=5, cr=0.25, voxel_size=0.3, head_dim=4, device="cpu")
    arrays = plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"], caps,
                                          wgeom_params=wgeom_host.params_from_model(port))
    got = overflow.stats_for_model(port, from_precomputed(arrays, raw["pmask"], "cpu"))
    return got, ref


@pytest.mark.parametrize("caps", [GENEROUS, PLANTED], ids=["generous", "planted"])
def test_counters_equal_jax(caps):
    """Every counter equals the JAX package's: the occupancies and the
    violations exactly, the grid fills to 1e-7; the generous capacities
    violate nothing, the planted ones saturate a grid, which the strict
    guard refuses and the observing one lets pass."""
    got, ref = _counters(caps)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        if k.startswith("overflow/vox_fill"):
            assert got[k].dtype == torch.float32
            np.testing.assert_allclose(got[k].item(), v, rtol=0, atol=1e-7, err_msg=k)
        else:
            assert got[k].item() == int(v), k
    assert len([k for k in got if k.startswith("overflow/occ_")]) == 8
    if caps == GENEROUS:
        assert ref["overflow/violations"] == 0
        overflow.check_aux(got, strict=True)
    else:
        assert ref["overflow/violations"] > 0 and got["overflow/vox_fill_l0"] >= 1.0
        with pytest.raises(RuntimeError, match="capacity overflow"):
            overflow.check_aux(got, strict=True)
        overflow.check_aux(got, strict=False)


def test_train_step_aux_carries_counters():
    """``make_train_step(overflow_checks=True)``: the loss and the batch's
    counters, device tensors of the plumbing's values."""
    raw = synthetic.make_batch(np.random.RandomState(2), 1, 512, voxel_size=0.3)
    model = teacher_model(num_classes=5, cr=0.25, voxel_size=0.3, head_dim=4, device="cpu")
    opt, _ = optim.make_optimizer(model.named_parameters(), "sgd", 0.01)
    arrays = plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"], PLANTED,
                                          wgeom_params=wgeom_host.params_from_model(model))
    want = overflow.stats_for_model(model, from_precomputed(arrays, raw["pmask"], "cpu"))
    aux = state.make_train_step(model, opt, PLANTED, overflow_checks=True)(
        dict(raw, plumbing=arrays))
    assert sorted(aux) == sorted(["loss", *want])
    for k, v in want.items():
        assert torch.equal(aux[k], v), k
    assert aux["overflow/violations"].item() > 0
    assert sorted(state.make_train_step(model, opt, PLANTED)(dict(raw, plumbing=arrays))) == ["loss"]


def test_distill_step_aux_carries_both_parts():
    """The stage-2 step's aux holds each part's counters under the JAX
    step's names (``_s``, ``_t``) and the violations of both summed."""
    raw = synthetic.make_multimodal_batch(np.random.RandomState(3), 1, 512, 640, voxel_size=0.3,
                                          num_cams=2, im_hw=(32, 48))
    model = TSDFull(num_classes=5, cr=0.25, cr_t=0.5, generator=torch.Generator().manual_seed(0),
                    pallas_attention=True, **GEOMETRY)
    opt, _ = distill.make_frozen_teacher_optimizer(model, "sgd", 0.01)
    s_caps, t_caps = PLANTED, TEACHER_GENEROUS
    want = {}
    for tag, part, caps, sub in (("s", "student", s_caps, model.model_s),
                                 ("t", "teacher", t_caps, model.model_t)):
        b = raw[part]
        b["plumbing"] = plumbing_host.batch_plumbing(
            b["pcoords"], b["xyz"], b["pmask"], caps,
            wgeom_params=wgeom_host.params_from_model(sub))
        stats = overflow.stats_for_model(sub, from_precomputed(b["plumbing"], b["pmask"],
                                                               "cpu"))
        want.update({f"{k}_{tag}": v for k, v in stats.items()})
    want["overflow/violations"] = want.pop("overflow/violations_s") + want.pop(
        "overflow/violations_t")
    aux = distill.make_distill_train_step(model, opt, s_caps, t_caps, overflow_checks=True)(raw)
    assert sorted(aux) == sorted([*distill.LOSS_TERMS, *want])
    for k, v in want.items():
        assert torch.equal(aux[k], v), k
    assert aux["overflow/violations"].item() > 0 and aux["overflow/vox_fill_l0_t"].item() < 1


@pytest.mark.parametrize("strict", [False, True])
def test_loop_checks_counters(tmp_path, monkeypatch, strict):
    """The loop fetches the aux every ``log_every`` steps and logs it; with
    ``strict_capacity`` a violation fails the run, without it the run goes
    on to its validation."""
    writer = loop.SummaryWriter
    monkeypatch.setattr(loop, "SummaryWriter", lambda d: writer(d, tensorboard=False))
    model = torch.nn.Linear(2, 2)
    opt, sched = optim.make_optimizer(model.named_parameters(), "sgd", 0.01)
    aux = {"loss": torch.tensor(0.5), "overflow/vox_fill_l0": torch.tensor(1.0),
           "overflow/violations": torch.tensor(1, dtype=torch.int32)}
    counts = {k: torch.zeros(3, dtype=torch.int64) for k in ("seen", "correct", "positive")}
    trainer = loop.Trainer(
        run_dir=str(tmp_path), model=model, optimizer=opt, scheduler=sched, generator=None,
        train_step=lambda batch: aux, eval_step=lambda batch: {"counts": counts},
        train_loader=lambda: iter([{}, {}]), val_loader=lambda: iter([{}]), num_epochs=1,
        num_classes=3, log_every=1, strict_capacity=strict)
    if strict:
        with pytest.raises(RuntimeError, match="capacity overflow"):
            trainer.train()
        assert trainer.global_step == 1
    else:
        trainer.train()
        assert trainer.global_step == 2
    trainer.summary.close()
