"""The port's data-parallel training on the CPU: the stage-2 step on two
gloo ranks (processes of ``tests/torch_dp_worker.py``, as in
``tests/test_torch_parallel.py``) and the training CLI in two processes.

* The stage-2 data-parallel step against the port's own single-process step
  on the batch of both scans whose objective is the mean of the two scans'
  losses (``chip_smoke.mean_of_scans_distill_step``, the card's reference),
  held as ``tests/test_torch_distill.py`` holds the step: GRAD_SPREADS times
  the median of three one-ulp-nudged steps, and at least UPDATE_RTOL; a
  planted fault, rank 1 dropping the backward sum of its BN statistics
  (``chip_smoke.dropped_bn_backward_sum``), must miss that by FAULT_MARGIN.
  Against JAX's data-parallel step (the TSD of ``tests/test_train_dp.py``)
  with the one BN that JAX leaves unsynced left so in the port: the port's
  runs go to processes of their own while JAX traces and runs its program,
  whose compile the committed ``tests/_jax_cache`` holds.
* The SphereFormer U-Net's two-rank step (synced masked BN, one coalesced
  gradient reduction) against the port's single-process step on both scans
  (``chip_smoke.mean_of_scans_teacher_step``) by the same rule, with the
  same planted fault, and against JAX's ``data_parallel_step`` (``pmean``
  over two of conftest's virtual devices) on the same weights.
* ``python -m u2mkd_tpu_torch.train_spformer ... --multihost --cpu`` in two
  processes for one epoch.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2mkd_tpu.data import synthetic as jax_synthetic
from u2mkd_tpu.models.plumbing import from_precomputed as jax_from_precomputed
from u2mkd_tpu.parallel import mesh as jax_mesh
from u2mkd_tpu.train import distill as jax_distill
from u2mkd_tpu.train import optim as jax_optim
from u2mkd_tpu.train import state as jax_state

import chip_smoke
from test_torch_distill import (FAULT_MARGIN, GRAD_SPREADS, LOSS_RTOL, UPDATE_RTOL,
                                _batches, _JaxTSDNoDropout, _port_batch, _state_diff)
from test_torch_model import _random_variables
from test_torch_parallel import LR, RANK_TIMEOUT_S, REPO, WORLD, _ranks
import torch_dp_worker
from torch_dp_worker import free_port
from test_torch_student_eval import GEOMETRY, NCLS, S_CAPS, T_CAPS
from test_torch_sphereformer_unet import CAPS as UNET_CAPS
from test_torch_sphereformer_unet import GEOMETRY as UNET_GEOMETRY
from test_torch_sphereformer_unet import N_PLANES as UNET_PLANES
from test_torch_sphereformer_unet import NUM_CLASSES as UNET_CLASSES
from test_torch_sphereformer_unet import VOXEL as UNET_VOXEL
from u2mkd_tpu.models.sphereformer_unet import SphereFormerSemantic as JaxUNet
from u2mkd_tpu_torch.data import plumbing_host, wgeom_host
from u2mkd_tpu_torch.models import convert_weights
from u2mkd_tpu_torch.models.sphereformer_unet import SphereFormerSemantic
from u2mkd_tpu_torch.models.tsd import TSDFull
from u2mkd_tpu_torch.train import optim

NUDGE_SEEDS = (1, 2, 3)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


TSD_KW = dict(num_classes=NCLS, cr=0.25, cr_t=0.5, pallas_attention=True, dropout_rate=0.0,
              drop_path_rate=0.0, **GEOMETRY)


def _tsd_port(state=None, seed=5):
    port = TSDFull(generator=torch.Generator().manual_seed(seed), **TSD_KW)
    if state is not None:
        port.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return port, TSD_KW


def _reference_args(start, batch):
    """The inputs of ``torch_dp_worker.task_mean_of_scans``: the
    single-process mean-of-scans step from ``start`` and from three
    one-ulp-nudged copies of it (NUDGE_SEEDS)."""
    return {"model": TSD_KW, "state": start, "lr": LR, "s_caps": S_CAPS,
            "t_caps": T_CAPS, "batch": batch, "nudges": NUDGE_SEEDS}


def _distill_args(start, kw, raws, local_bn=()):
    """The inputs of ``torch_dp_worker.task_distill`` on the two scans."""
    port, _ = _tsd_port(start)
    ports = [_port_batch(raw, port) for raw in raws]
    return {"model": kw, "state": start, "lr": LR, "s_caps": S_CAPS, "t_caps": T_CAPS,
            "batches": ports, "local_bn": local_bn}


def _raws():
    return [jax_synthetic.make_multimodal_batch(np.random.RandomState(s), 1, 512, 640,
                                                voxel_size=0.3, num_cams=2, im_hw=(32, 48))
            for s in (3, 4)]


def test_distill_dp_step_is_the_mean_of_scans_step(tmp_path):
    """The port's two-rank stage-2 step against its single-process step on
    the batch of both scans with the mean of the two scans' losses: the
    loss to LOSS_RTOL, the student's state within GRAD_SPREADS times the
    median of three nudged steps (and at least UPDATE_RTOL), the teacher
    bitwise frozen, the ranks bitwise equal, the eval counters the sums of
    the ranks' own; the planted BN fault misses by FAULT_MARGIN."""
    port, kw = _tsd_port()
    start = {k: v.numpy().copy() for k, v in port.state_dict().items()}
    raws = _raws()
    got = _ranks("distill", _distill_args(start, kw, raws), tmp_path)
    ref = torch_dp_worker.task_mean_of_scans(_reference_args(
        start, _port_batch(chip_smoke.concat_scans(raws), port)))
    ref_state, ref_loss = ref["reference"]
    np.testing.assert_allclose(got[0]["dp"]["aux"]["loss"], ref_loss, rtol=LOSS_RTOL)
    spreads = [_state_diff(ref[s][0], ref_state, start)[0] for s in NUDGE_SEEDS]
    tol = max(UPDATE_RTOL, GRAD_SPREADS * float(np.median(spreads)))
    worst, name = _state_diff(got[0]["dp"]["state"], ref_state, start)
    fault, fault_name = _state_diff(got[0]["fault"]["state"], ref_state, start)
    print(f"stage-2 DP step: {worst:.3g} ({name}) of tol {tol:.3g}; planted fault "
          f"{fault / tol:.3g}x ({fault_name})")
    assert worst <= tol, (name, worst, tol)
    assert fault >= FAULT_MARGIN * tol, (fault_name, fault, tol)
    for k, v in start.items():
        if k.startswith("model_t."):
            np.testing.assert_array_equal(got[0]["dp"]["state"][k], v, k)
    for k, v in got[0]["dp"]["state"].items():
        np.testing.assert_array_equal(got[1]["dp"]["state"][k], v, k)
    for head in ("counts_vox", "counts_pix"):
        for n in ("seen", "correct", "positive"):
            total = sum(r["dp"]["local_counts"][head][n] for r in got)
            for r in got:
                np.testing.assert_array_equal(r["dp"]["counts"][head][n], total)


def test_distill_dp_step_matches_jax(tmp_path):
    """The port's two-rank stage-2 step against JAX's ``data_parallel_step``
    of ``make_distill_train_step`` on the same bridged weights. JAX builds
    the student's pixel classifier without ``axis_name``
    (``u2mkd_tpu/models/msp2ifm.py:272``), so its BN normalizes each shard
    alone, where the port syncs every BN as the reference's SyncBN does
    (ROADMAP section 3). With that one BN left unsynced the port equals JAX:
    the loss terms to LOSS_RTOL, the student's state within the nudge rule
    of :func:`test_distill_dp_step_is_the_mean_of_scans_step`, the teacher
    bitwise frozen on both sides; as shipped its pixel loss differs. The
    port's runs (both two-rank steps and the nudged single-process steps)
    run in processes of ``tests/torch_dp_worker.py`` while this one traces
    and runs the JAX program."""
    model_dp = _JaxTSDNoDropout(num_classes=NCLS, cr=0.25, cr_t=0.5, drop_path_rate=0.0,
                                pallas_attention=False, pallas_cubic=False,
                                axis_name=jax_mesh.DATA_AXIS, **GEOMETRY)
    model = model_dp.clone(axis_name=None)
    pairs = _batches(model, False)
    bj = jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs), *[b for b, _ in pairs])
    one = jax.tree_util.tree_map(lambda t: t[:1], bj)
    abstract = jax.eval_shape(
        lambda s, t: model.init(jax.random.PRNGKey(0), s, jax_from_precomputed(
            s["plumbing"], s["pmask"]), t, jax_from_precomputed(t["plumbing"], t["pmask"]),
            False), one["student"], one["teacher"])
    variables = _random_variables(abstract, 11)
    start = {k: v.numpy() for k, v in convert_weights.from_flax(
        variables["params"], variables["batch_stats"]).items()}
    kw = dict(TSD_KW, pallas_attention=False, pallas_cubic=False)
    raws = [r for _, r in pairs]
    port, _ = _tsd_port(start)
    runs = [torch_dp_worker.start("distill", _distill_args(start, kw, raws, local_bn),
                                  tmp_path, WORLD, timeout=RANK_TIMEOUT_S)
            for local_bn in (("model_s.classifier_pix.norm",), ())]
    runs.append(torch_dp_worker.start("mean_of_scans", _reference_args(
        start, _port_batch(chip_smoke.concat_scans(raws), port)), tmp_path, 1,
        timeout=RANK_TIMEOUT_S))

    tx = jax_distill.make_frozen_teacher_optimizer(jax_optim.make_optimizer("sgd_spformer", LR))
    st = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=jax.jit(tx.init)(variables["params"]))
    step = jax_mesh.data_parallel_step(jax_distill.make_distill_train_step(
        model_dp, tx, S_CAPS, T_CAPS, axis_name=jax_mesh.DATA_AXIS), jax_mesh.make_mesh(WORLD))
    st1, aux = step(st, bj, jax.random.PRNGKey(1))
    got, shipped, nudged = (torch_dp_worker.collect(r) for r in runs)
    for k in ("loss", "ce_vox", "ce_pix", "kl", "feat", "mse"):
        np.testing.assert_allclose(got[0]["dp"]["aux"][k], float(aux[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    ref_state = {k: v.numpy() for k, v in convert_weights.from_flax(
        jax.tree_util.tree_map(np.asarray, st1.params),
        jax.tree_util.tree_map(np.asarray, st1.batch_stats)).items()}
    nudged = nudged[0]
    spreads = [_state_diff(nudged[s][0], nudged["reference"][0], start)[0]
               for s in NUDGE_SEEDS]
    tol = max(UPDATE_RTOL, GRAD_SPREADS * float(np.median(spreads)))
    worst, name = _state_diff(got[0]["dp"]["state"], ref_state, start)
    assert worst <= tol, (name, worst, tol)
    for k, v in start.items():
        if k.startswith("model_t."):
            np.testing.assert_array_equal(ref_state[k], v, k)
            np.testing.assert_array_equal(got[0]["dp"]["state"][k], v, k)
    shipped = shipped[0]["dp"]["aux"]
    assert abs(shipped["ce_pix"] - float(aux["ce_pix"])) > 100 * LOSS_RTOL * abs(
        float(aux["ce_pix"]))


def _unet_port(state=None):
    kw = dict(num_classes=UNET_CLASSES, n_planes=UNET_PLANES, head_dim=4, drop_path_rate=0.0,
              **UNET_GEOMETRY)
    port = SphereFormerSemantic(generator=torch.Generator().manual_seed(5), **kw)
    if state is not None:
        port.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return port, kw


def _unet_scans(port):
    """Two scans (seeds 3, 4) -> (each with its host plumbing, both as one
    batch with its own)."""
    raws = [jax_synthetic.make_batch(np.random.RandomState(s), 1, 512, voxel_size=UNET_VOXEL,
                                     num_sweep_factor=2) for s in (3, 4)]
    params = wgeom_host.params_from_model(port)

    def with_plumbing(raw):
        arrays = plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"],
                                              UNET_CAPS, wgeom_params=params)
        # the banded JAX attention is exact at these occupancies
        assert max(int(g["occ"].max()) for g in arrays["wgeom"]["cubic"]) <= 128
        assert max(int(g["occ"].max()) for g in arrays["wgeom"]["sphere"]) <= 4 * 128
        return dict(raw, plumbing=arrays)

    return [with_plumbing(r) for r in raws], with_plumbing(chip_smoke.concat_scans(raws))


def _unet_state_diff(got, ref, start):
    """:func:`test_torch_distill._state_diff` over every parameter and BN
    statistic."""
    def one(n):
        change = float(np.abs(ref[n] - start[n]).max())
        ulps = 2 * float(np.spacing(np.abs(ref[n]).max().astype(np.float32)))
        return float(np.abs(got[n] - ref[n]).max()) / (change + ulps)

    return max((one(n), n) for n in ref)


def _unet_dp(tmp_path, start, kw, scans):
    return _ranks("unet", {"model": kw, "state": start, "lr": LR, "caps": UNET_CAPS,
                           "batches": scans}, tmp_path)


def test_unet_dp_step_is_the_mean_of_scans_step(tmp_path):
    """The U-Net's two-rank step against its single-process step on the
    batch of both scans with the mean of the scans' losses
    (``chip_smoke.mean_of_scans_teacher_step``): the loss to LOSS_RTOL, the
    state within GRAD_SPREADS times the median of three one-ulp-nudged
    steps (and at least UPDATE_RTOL), the ranks bitwise equal, the eval
    counters the sums of the ranks' own; rank 1 dropping the backward sum
    of its BN statistics misses by FAULT_MARGIN."""
    port, kw = _unet_port()
    start = {k: v.numpy().copy() for k, v in port.state_dict().items()}
    scans, both = _unet_scans(port)
    got = _unet_dp(tmp_path, start, kw, scans)
    ref = {}
    for tag in ("reference", *NUDGE_SEEDS):
        m, _ = _unet_port(start)
        if tag != "reference":
            gen = torch.Generator().manual_seed(tag)
            with torch.no_grad():
                for p in m.parameters():
                    p.mul_(1 + 2.0 ** -23 * torch.randn(p.shape, generator=gen))
        opt, _ = optim.make_optimizer(m.named_parameters(), "sgd_spformer", LR)
        loss = chip_smoke.mean_of_scans_teacher_step(m, opt, UNET_CAPS)(both)["loss"]
        ref[tag] = ({k: v.numpy().copy() for k, v in m.state_dict().items()}, loss.item())
    ref_state, ref_loss = ref["reference"]
    np.testing.assert_allclose(got[0]["dp"]["loss"], ref_loss, rtol=LOSS_RTOL)
    spreads = [_unet_state_diff(ref[s][0], ref_state, start)[0] for s in NUDGE_SEEDS]
    tol = max(UPDATE_RTOL, GRAD_SPREADS * float(np.median(spreads)))
    worst, name = _unet_state_diff(got[0]["dp"]["state"], ref_state, start)
    fault, fault_name = _unet_state_diff(got[0]["fault"]["state"], ref_state, start)
    print(f"U-Net DP step: {worst:.3g} ({name}) of tol {tol:.3g}; planted fault "
          f"{fault / tol:.3g}x ({fault_name})")
    assert worst <= tol, (name, worst, tol)
    assert fault >= FAULT_MARGIN * tol, (fault_name, fault, tol)
    for k, v in got[0]["dp"]["state"].items():
        np.testing.assert_array_equal(got[1]["dp"]["state"][k], v, k)
    for n in ("seen", "correct", "positive"):
        total = sum(r["dp"]["local_counts"][n] for r in got)
        for r in got:
            np.testing.assert_array_equal(r["dp"]["counts"][n], total)


def test_unet_dp_step_matches_jax(tmp_path):
    """The U-Net's two-rank step against JAX's ``data_parallel_step`` of
    ``make_train_step`` (``axis_name``: BN statistics and gradients
    ``pmean``-ed over two virtual devices) on the same bridged weights and
    scans: the loss to LOSS_RTOL and every parameter and BN statistic after
    the step by the rule of ``tests/test_torch_parallel.py``
    (UPDATE_RTOL of its change, plus two f32 ulps)."""
    from test_torch_sphereformer_unet import _variables as unet_variables

    port, kw = _unet_port()
    scans, _ = _unet_scans(port)
    model = JaxUNet(**kw)
    model_dp = JaxUNet(axis_name=jax_mesh.DATA_AXIS, **kw)
    bj = jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs), *[
        dict({k: jnp.asarray(v) for k, v in s.items() if k != "plumbing"},
             plumbing={k: [jnp.asarray(x) for x in v] for k, v in s["plumbing"].items()
                       if k != "wgeom"}) for s in scans])
    one = jax.tree_util.tree_map(lambda t: t[:1], bj)
    variables = unet_variables(model, one)
    tx = jax_optim.make_optimizer("sgd_spformer", LR)
    st = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]))
    step = jax_mesh.data_parallel_step(jax_state.make_train_step(
        model_dp, tx, UNET_CAPS, axis_name=jax_mesh.DATA_AXIS), jax_mesh.make_mesh(WORLD))
    st1, aux = step(st, bj, jax.random.PRNGKey(1))
    start = {k: v.numpy() for k, v in convert_weights.from_flax(
        variables["params"], variables["batch_stats"]).items()}
    got = _unet_dp(tmp_path, start, kw, scans)
    np.testing.assert_allclose(got[0]["dp"]["loss"], float(aux["loss"]), rtol=LOSS_RTOL)
    ref = convert_weights.from_flax(jax.tree_util.tree_map(np.asarray, st1.params),
                                    jax.tree_util.tree_map(np.asarray, st1.batch_stats))
    assert sorted(ref) == sorted(got[0]["dp"]["state"])
    for name, t in ref.items():
        p_ref, p_got = t.numpy(), got[0]["dp"]["state"][name]
        atol = (UPDATE_RTOL * np.abs(p_ref - start[name]).max()
                + 2 * np.spacing(np.abs(p_ref).max().astype(np.float32)))
        np.testing.assert_allclose(p_got, p_ref, rtol=0, atol=atol, err_msg=name)


def test_multihost_cli_two_processes(tmp_path):
    """``python -m u2mkd_tpu_torch.train_spformer ... --multihost --cpu`` in
    two processes for one epoch: both exit 0, rank 0 alone writes its run
    directory, both end with one state digest and print the mIoU rank 0
    logs."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="1")
    run_dirs = [tmp_path / f"rank{r}" for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "u2mkd_tpu_torch.train_spformer",
         "configs/synthetic/train/spformer_tiny.yaml", "--run-dir", str(run_dirs[r]),
         "--multihost", "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(WORLD),
         "--process-id", str(r), "--cpu", "num_epochs=1", "data.training_size=8"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
        assert f"multihost: process {r}/{WORLD}" in log
        assert "devices: 2 (data-parallel)" in log
    digests = [ln.rsplit(" ", 1)[1] for log in logs for ln in log.splitlines()
               if "state sha256" in ln]
    assert len(digests) == WORLD and len(set(digests)) == 1
    mious = [ln.split("miou=")[1].split()[0] for log in logs for ln in log.splitlines()
             if ln.startswith("epoch 1/1:")]
    assert len(mious) == WORLD and len(set(mious)) == 1
    assert not run_dirs[1].exists()
    assert {"latest.pt", "max-iou-val-vox.pt"} <= set(os.listdir(run_dirs[0] / "checkpoints"))
    logged = [m["value"] for m in map(json.loads, (run_dirs[0] / "metrics.jsonl").open())
              if m["name"] == "val/counts"]
    assert len(logged) == 1 and f"{100 * logged[0]:.2f}" == mious[0]
