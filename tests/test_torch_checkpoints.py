"""The port's checkpoints, on the CPU: the cases of ``tests/test_checkpoints.py``
(the latest / best / epoch savers, the crash between the two renames, the
backbone pretrain without its classifier, zero-match restores that must
raise, the stage-1 teacher restored into the TSD wrapper), and a full resume
that continues a run bitwise.
"""

import os

import numpy as np
import pytest
import torch

from u2mkd_tpu_torch.data import plumbing_host, synthetic, wgeom_host
from u2mkd_tpu_torch.models.spvcnn import SPVCNN
from u2mkd_tpu_torch.models.tsd import TSDFull
from u2mkd_tpu_torch.train import checkpoints as C
from u2mkd_tpu_torch.train import optim, state

CAPS = (128, 64, 32, 16, 8)
GEOMETRY = dict(window_size=(1.8,) * 3, quant_size=(0.075,) * 3, head_dim=4,
                window_size_scale=(2.0, 2.0))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """At most two CPU threads per test process: the tier-1 run shares the
    machine's cores among several workers, and more threads each only
    contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _state(seed=0, cr=0.25):
    """A small teacher, its optimizer (with momentum buffers after one
    step), its generator, and the checkpoint dict of the three."""
    model = SPVCNN(num_classes=5, cr=cr, generator=torch.Generator().manual_seed(seed),
                   pallas_attention=True,
                   **GEOMETRY)
    opt, _ = optim.make_optimizer(model.named_parameters(), "sgd", 0.01)
    gen = torch.Generator().manual_seed(seed)
    raw = synthetic.make_batch(np.random.RandomState(3), 1, 120, voxel_size=0.5)
    raw["plumbing"] = plumbing_host.batch_plumbing(
        raw["pcoords"], raw["xyz"], raw["pmask"], CAPS,
        wgeom_params=wgeom_host.params_from_model(model))
    step = state.make_train_step(model, opt, CAPS, generator=gen)
    step(raw)
    return model, opt, gen, C.training_state(model, opt, None, gen, step=1), step, raw


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_latest_best_epoch_savers(tmp_path):
    model, opt, gen, st, _, _ = _state()
    mgr = C.CheckpointManager(str(tmp_path), epoch_to_save=2)
    mgr.save_latest(st, epoch=1)
    ckpts = os.path.join(tmp_path, "checkpoints")
    assert os.path.isfile(os.path.join(ckpts, "latest.pt"))
    assert not os.path.exists(os.path.join(ckpts, "epoch-1.pt"))
    mgr.save_latest(st, epoch=2)
    assert os.path.isfile(os.path.join(ckpts, "epoch-2.pt"))
    assert mgr.latest_epoch() == 2

    assert mgr.save_best(st, 0.5)
    assert not mgr.save_best(st, 0.4)  # no improvement
    assert mgr.save_best(st, 0.6)
    assert os.path.isfile(os.path.join(ckpts, "max-iou-val-vox.pt"))

    # MaxSaver's best survives a new manager (resume)
    mgr2 = C.CheckpointManager(str(tmp_path))
    assert not mgr2.save_best(st, 0.55)
    assert mgr2.save_best(st, 0.7)

    # full restore round-trips exactly
    restored = mgr.restore("latest")
    _equal(restored["model"], model.state_dict())
    assert restored["step"] == 1
    assert torch.equal(restored["generator"], gen.get_state())


@pytest.fixture
def one_thread():
    """One CPU thread: the backward's scatters sum in an order that depends
    on the thread count and layout, and bitwise comparisons need one order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_full_resume_continues_bitwise(tmp_path, one_thread):
    """A run resumed from its checkpoint (model, optimizer momentum, step,
    generator) takes the next step exactly as the run that never stopped."""
    model, opt, gen, st, step, raw = _state()
    mgr = C.CheckpointManager(str(tmp_path))
    mgr.save_latest(st, epoch=1)
    want = step(raw)["loss"]

    model2, opt2, gen2, _, step2, _ = _state(seed=9)
    assert C.load_training_state(mgr.restore("latest"), model2, opt2, None, gen2) == 1
    got = step2(raw)["loss"]
    assert torch.equal(got, want)
    _equal(model2.state_dict(), model.state_dict())


def test_pretrain_restore_skips_classifier(tmp_path):
    model, _, _, st, _, _ = _state(0)
    C.CheckpointManager(str(tmp_path)).save_latest(st, 1)
    model2, *_ = _state(1)  # another init
    head = model2.classifier_vox.weight.detach().clone()
    stats = C.load_pretrain_params(os.path.join(tmp_path, "checkpoints", "latest.pt"), model2)
    assert stats["matched"] > 0 and stats["unmatched"] == 0 and stats["skipped"] == 2
    # backbone entries come from the checkpoint, BN statistics included
    assert torch.equal(model2.stem0.conv0.kernel, model.stem0.conv0.kernel)
    assert torch.equal(model2.stem0.bn0.running_var, model.stem0.bn0.running_var)
    # classifier entries stay at the new init
    assert torch.equal(model2.classifier_vox.weight, head)


def test_crash_between_renames_recovers(tmp_path):
    """A save preempted between its two renames leaves the only intact
    checkpoint under ``latest.pt.old``; restore and the next save both
    promote it back instead of treating it as garbage."""
    model, _, _, st, _, _ = _state()
    mgr = C.CheckpointManager(str(tmp_path))
    mgr.save_latest(st, epoch=1)
    live = os.path.join(tmp_path, "checkpoints", "latest.pt")

    os.rename(live, live + ".old")
    assert not os.path.exists(live)
    _equal(mgr.restore("latest")["model"], model.state_dict())

    os.rename(live, live + ".old")
    mgr.save_latest(st, epoch=2)
    assert os.path.exists(live) and not os.path.exists(live + ".old")
    mgr.restore("latest")


def test_zero_match_restores_raise(tmp_path):
    """A pretrain restore that matches no parameter, or (for a model with BN
    statistics) no BN buffer, raises: eval forwards on initial running
    statistics are wrong in a way no later metric shows. A teacher restore
    from a file that is neither a checkpoint of the port nor a reference
    ``SPVCNN_SPFORMER`` state dict raises, and so does one from a directory
    (the JAX package's orbax checkpoints)."""
    _, _, _, st, _, _ = _state()
    mgr = C.CheckpointManager(str(tmp_path))
    mgr.save_latest(st, 1)
    ckpt = os.path.join(tmp_path, "checkpoints", "latest.pt")

    alien = torch.nn.Sequential(torch.nn.Linear(3, 7))
    with pytest.raises(ValueError, match="ZERO parameters"):
        C.load_pretrain_params(ckpt, alien)

    no_stats = dict(st, model={k: v for k, v in st["model"].items() if "running" not in k})
    mgr._save("no_stats", no_stats)
    model, *_ = _state(1)
    with pytest.raises(ValueError, match="ZERO batch-stats"):
        C.load_pretrain_params(mgr.path("no_stats"), model)

    ref_pt = os.path.join(tmp_path, "reference.pt")
    torch.save({"model": st["model"]}, ref_pt)
    tsd = TSDFull(num_classes=5, cr=0.25, cr_t=0.25, pallas_attention=True, **GEOMETRY)
    with pytest.raises(ValueError, match="expected keys absent"):
        C.load_teacher_any(ref_pt, tsd)
    with pytest.raises(NotImplementedError, match="no checkpoint of this port"):
        C.load_teacher_any(str(tmp_path), tsd)


def test_teacher_restore_into_tsd(tmp_path):
    """The stage-1 checkpoint's model (parameters and BN statistics) becomes
    the TSD wrapper's teacher; the student is left as it was."""
    model, _, _, st, _, _ = _state(0, cr=0.5)
    C.CheckpointManager(str(tmp_path)).save_latest(st, 1)
    tsd = TSDFull(num_classes=5, cr=0.25, cr_t=0.5, generator=torch.Generator().manual_seed(4),
                  pallas_attention=True,
                  **GEOMETRY)
    student = {k: v.clone() for k, v in tsd.model_s.state_dict().items()}
    C.load_teacher_any(os.path.join(tmp_path, "checkpoints", "latest.pt"), tsd)
    _equal(tsd.model_t.state_dict(), model.state_dict())
    _equal(tsd.model_s.state_dict(), student)
