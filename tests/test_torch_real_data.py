"""The slice as a whole, on the CPU: training from nuScenes-format files.

A nuScenes-format set that ``tools/make_nusc_mini.generate`` writes under
``tmp_path`` (2 train scenes and 1 val scene of 3 keyframes, 700 points a
scan, 6 cameras). The first train batch of the port's
``make_distill_loaders`` on ``configs/nuscenes/mini/tsd_mini.yaml`` (B=1,
images at ``im_cr`` 0.1 to keep the CPU step short) goes through the port's
stage-2 step and through the JAX package's ``make_distill_train_step`` from
bridged random weights (``TSDFull`` at cr=cr_t=0.25, the mini config's
window geometry, head dim 4, 17 classes, dropout and drop path 0, f32; the
JAX side on its XLA paths with the host plumbing of the same arrays): the
first step's loss terms agree to 1e-5 (printed with ``-s``), and the loss's
own gradients with respect to the student's outputs, on this batch's
masks, to 1e-4.

The step's parameter gradients are held to the JAX package's on synthetic
scans (``tests/test_torch_distill.py``), not here. On this batch rounding
alone moves them by a tenth of a parameter's largest gradient (three port
steps from one-ulp-nudged weights, in the image branch, whose maps are 3x5
at B=1 and whose camera renders are smooth), so the planted off-by-one of
that file's rule is not told apart from rounding. The JAX package's
image-branch BN also takes its variance as ``E[x^2] - E[x]^2``
(``u2mkd_tpu/models/swiftnet.py`` ``BatchNorm2d``), where the port's
``F.batch_norm`` is the reference's torch BN; with the port's BN on the JAX
formula the loss terms agree to 1e-6 and the gradients' difference lies
within the nudged spread. The slow
``test_real_batch_gradients_are_within_rounding`` shows both.

Then both port CLIs run with ``--cpu`` on the mini configs, one epoch each,
stage 2 restoring stage 1's checkpoint as its frozen teacher (both at cr
0.25, so they chain): each exits 0, writes its checkpoints and scores its
validation on the raw points. The counterpart of the slow
``tests/test_nusc_mini_workflow.py``.
"""

import math
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2mkd_tpu.models.plumbing import from_precomputed as jax_from_precomputed
from u2mkd_tpu.train import distill as jax_distill
from u2mkd_tpu.train import optim as jax_optim
from u2mkd_tpu.train import state as jax_state

from test_torch_cli import run_cli
from test_torch_distill import (
    FAULT_MARGIN, GRAD_RTOL, GRAD_SPREADS, LOSS_RTOL, NUDGE_SEEDS, TERMS, _capturing,
    _grad_diff, _JaxTSDNoDropout, _nudged,
)
from test_torch_model import _random_variables
from test_torch_student_eval import _jax_plumbing
from u2mkd_tpu_torch.data import loaders
from u2mkd_tpu_torch.models import convert_weights
from u2mkd_tpu_torch.models.tsd import TSDFull
from u2mkd_tpu_torch.train import builder, distill
from u2mkd_tpu_torch.utils import config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
STAGE1 = "configs/nuscenes/mini/spformer_mini.yaml"
STAGE2 = "configs/nuscenes/mini/tsd_mini.yaml"
LR = 0.02


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mini_root(tmp_path_factory):
    from make_nusc_mini import generate

    root = str(tmp_path_factory.mktemp("nusc_mini"))
    generate(root)
    return root


def _geometry(cfg):
    ws, wss, qs, qss = builder.window_geometry(cfg)
    return dict(window_size=ws, window_size_sphere=wss, quant_size=qs, quant_size_sphere=qss,
                window_size_scale=tuple(cfg.model.window_size_scale),
                head_dim=cfg.model.head_dim)


def _port(cfg, variables):
    port = TSDFull(num_classes=cfg.data.num_classes, cr=cfg.model.cr, cr_t=cfg.model.cr_t,
                   pallas_attention=True,
                   dropout_rate=0.0, drop_path_rate=0.0, **_geometry(cfg))
    port.load_state_dict(convert_weights.from_flax(variables["params"],
                                                   variables["batch_stats"]))
    return port


def _host(x):
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x.numpy() if torch.is_tensor(x) else x


def _port_terms(cfg, variables, batch):
    """The loss terms of one port step from the bridged ``variables``."""
    return _port_step(cfg, variables, batch)[0]


def _loss_grads_match_jax(cfg, variables, batch):
    """The loss's own gradients with respect to the student's outputs on
    this batch's masks, the port's function against the JAX package's on
    the same outputs (the port's forward), to GRAD_RTOL of each one's
    largest entry; and its terms to LOSS_RTOL."""
    port = _port(cfg, variables)
    s_caps, t_caps = tuple(cfg.student_capacities), tuple(cfg.teacher_capacities)
    opt, _ = distill.make_frozen_teacher_optimizer(port, "sgd_spformer", LR)
    step = distill.make_distill_train_step(port, opt, s_caps, t_caps)
    t_out = step.teacher_fn(batch)
    _, plumbing, tensor_of = distill.batch_reader(port.model_s, s_caps)
    sb = batch["student"]
    spl = plumbing(sb)
    s_in = {k: tensor_of(sb, k, dt) for k, dt in distill.STUDENT_KEYS.items()}
    labels = tensor_of(sb, "labels", torch.int64)
    masks = (s_in["fov_mask"] & spl.pmask, spl.pmask & (labels != 0),
             spl.pmask & (tensor_of(batch, "t2s", torch.int64) >= 0))
    port.train()
    with torch.no_grad():
        stu = port(s_in, spl, run_teacher=False, generator=torch.Generator())["stu"]
    outs = {"x_vox": stu["x_vox"], "x_pix": stu["x_pix"], "pts_feats": stu["pts_feats"],
            "mse": torch.stack([m.detach() for m in stu["mse_loss"][:2]])}
    assert masks[0].any() and masks[1].any() and masks[2].any()
    leaves = {k: v.detach().clone().requires_grad_() for k, v in outs.items()}
    loss, got = distill._distill_losses(
        dict(leaves, mse_loss=[leaves["mse"][0], leaves["mse"][1]]), t_out["x_vox_t2s"],
        t_out["feat_t2s"], labels, *masks, 1.0, 1.0, False)
    loss.backward()

    def jax_loss(o):
        return jax_distill._distill_losses(
            dict(o, mse_loss=[o["mse"][0], o["mse"][1]]),
            *(jnp.asarray(t_out[k].numpy()) for k in ("x_vox_t2s", "feat_t2s")),
            jnp.asarray(labels.numpy()), *(jnp.asarray(m.numpy()) for m in masks),
            1.0, 1.0, False)

    (_, ref), ref_grads = jax.value_and_grad(jax_loss, has_aux=True)(
        {k: jnp.asarray(v.detach().numpy()) for k, v in outs.items()})
    for k in TERMS:
        np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=LOSS_RTOL, err_msg=k)
    for k, t in leaves.items():
        want = np.asarray(ref_grads[k])
        assert np.abs(want).max() > 0, k
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=0,
                                   atol=GRAD_RTOL * np.abs(want).max(), err_msg=k)


def _real_batch_setup(root):
    """-> (cfg, the JAX model, the port's first train batch, the JAX batch
    of the same arrays, the random variables)."""
    cfg = config.update_dotted(config.load(os.path.join(REPO, STAGE2)),
                               [f"dataset.root={root}", "batch_size=1", "dataset.im_cr=0.1"])
    geometry = _geometry(cfg)
    model = _JaxTSDNoDropout(num_classes=cfg.data.num_classes, cr=cfg.model.cr,
                             cr_t=cfg.model.cr_t, drop_path_rate=0.0, pallas_attention=False,
                             pallas_cubic=False, **geometry)
    s_caps, t_caps = tuple(cfg.student_capacities), tuple(cfg.teacher_capacities)
    probe = TSDFull(num_classes=cfg.data.num_classes, cr=cfg.model.cr, cr_t=cfg.model.cr_t,
                    pallas_attention=True,
                    **geometry)
    batch = next(iter(loaders.make_distill_loaders(cfg, probe)[0]()))
    raw = _host(batch)
    assert raw["student"]["images"].shape == (1, 3, 90, 160, 3)
    for part in ("student", "teacher"):  # the banded JAX attention is exact here
        wg = raw[part]["plumbing"]["wgeom"]
        assert max(int(g["occ"].max()) for g in wg["sphere"]) <= 4 * 128
        assert max(int(g["occ"].max()) for g in wg["cubic"]) <= 128
    bj = {part: {k: jnp.asarray(v) for k, v in raw[part].items() if k != "plumbing"}
          for part in ("student", "teacher")}
    bj["student"]["plumbing"] = _jax_plumbing(raw["student"], s_caps)
    bj["teacher"]["plumbing"] = _jax_plumbing(raw["teacher"], t_caps)
    bj["t2s"] = jnp.asarray(raw["t2s"])

    def init(sb, tb):
        spl = jax_from_precomputed(sb["plumbing"], sb["pmask"])
        tpl = jax_from_precomputed(tb["plumbing"], tb["pmask"])
        return model.init(jax.random.PRNGKey(0), sb, spl, tb, tpl, False, True)

    variables = _random_variables(jax.eval_shape(init, bj["student"], bj["teacher"]), 17)
    return cfg, model, batch, bj, variables


def _jax_step(cfg, model, bj, variables, tx):
    st = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]))
    return jax.jit(jax_distill.make_distill_train_step(
        model, tx, tuple(cfg.student_capacities), tuple(cfg.teacher_capacities)))(
        st, bj, jax.random.PRNGKey(1))


def test_stage2_step_on_a_real_batch_matches_jax(mini_root):
    cfg, model, batch, bj, variables = _real_batch_setup(mini_root)
    tx = jax_distill.make_frozen_teacher_optimizer(jax_optim.make_optimizer("sgd_spformer", LR))
    _, aux = _jax_step(cfg, model, bj, variables, tx)
    terms = _port_terms(cfg, variables, batch)
    print("loss terms apart by " + ", ".join(
        f"{k} {abs(terms[k] - float(aux[k])) / abs(float(aux[k])):.3g}" for k in TERMS))
    for k in TERMS:
        assert float(aux[k]) != 0.0, k
        np.testing.assert_allclose(terms[k], float(aux[k]), rtol=LOSS_RTOL, err_msg=k)
    _loss_grads_match_jax(cfg, variables, batch)


def _fast_variance_bn(self, x):
    """The JAX package's image-branch BN in training (``E[x^2] - E[x]^2``,
    ``u2mkd_tpu/models/swiftnet.py`` ``BatchNorm2d``), for the port's
    ``swiftnet.BatchNorm2d``."""
    if not self.training:
        return torch.nn.functional.batch_norm(x, self.running_mean, self.running_var,
                                              self.weight, self.bias, False, self.momentum,
                                              self.eps)
    cnt = x.numel() // x.shape[1]
    mean = x.sum((0, 2, 3)) / cnt
    var = ((x * x).sum((0, 2, 3)) / cnt - mean * mean).clamp(min=0.0)
    with torch.no_grad():
        self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
        self.running_var.mul_(1 - self.momentum).add_(self.momentum * var * cnt / max(cnt - 1, 1))
    shape = (1, -1, 1, 1)
    return ((x - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
            * self.weight.view(shape) + self.bias.view(shape))


@pytest.mark.slow
def test_real_batch_gradients_are_within_rounding(mini_root, monkeypatch):
    """Why the real batch's parameter gradients are held on synthetic scans
    only (module docstring), printed with ``-s``: three port steps from
    one-ulp-nudged weights spread the student's gradients by
    ``spreads`` (largest over parameters, each over its parameter's
    largest entry, ``test_torch_distill._grad_diff``), and the planted
    off-by-one in the teacher's gather moves them by no more than
    GRAD_SPREADS * FAULT_MARGIN times their median, so the rule cannot
    tell it from rounding here. With the port's image BN on the JAX
    package's variance formula the loss terms agree to 1e-6 and the
    gradients' difference from the JAX step lies within GRAD_SPREADS times
    the median spread."""
    from u2mkd_tpu_torch.models import swiftnet

    cfg, model, batch, bj, variables = _real_batch_setup(mini_root)
    monkeypatch.setattr(swiftnet.BatchNorm2d, "forward", _fast_variance_bn)
    tx = _capturing(jax_distill.make_frozen_teacher_optimizer(
        jax_optim.make_optimizer("sgd_spformer", LR)))
    st, aux = _jax_step(cfg, model, bj, variables, tx)
    grads = jax.tree_util.tree_map(np.asarray, st.opt_state[1])
    grads_j = {k: v.numpy() for k, v in convert_weights.from_flax(grads["model_s"], {}).items()}
    terms, grads_p = _port_step(cfg, variables, batch)
    worst = max(abs(terms[k] - float(aux[k])) / abs(float(aux[k])) for k in TERMS)
    spreads = [_grad_diff(_port_step(cfg, _nudged(variables, s), batch)[1], grads_p)[0]
               for s in NUDGE_SEEDS]
    err, name = _grad_diff(grads_p, grads_j)
    fault = _grad_diff(_port_step(cfg, variables, batch, fault=True)[1], grads_p)[0]
    median = float(np.median(spreads))
    print(f"loss terms {worst:.3g} apart; gradients {err:.3g} ({name}) from the JAX step; "
          f"nudged spreads {', '.join(f'{x:.3g}' for x in spreads)}; the fault {fault:.3g}")
    assert worst <= 1e-6
    assert err <= GRAD_SPREADS * median
    assert fault <= GRAD_SPREADS * FAULT_MARGIN * median


def _port_step(cfg, variables, batch, fault=False):
    """One port step from the bridged ``variables`` -> (its terms, the
    student's gradients). ``fault`` gathers the teacher's rows one student
    point off."""
    port = _port(cfg, variables)
    opt, _ = distill.make_frozen_teacher_optimizer(port, "sgd_spformer", LR)
    step = distill.make_distill_train_step(port, opt, tuple(cfg.student_capacities),
                                           tuple(cfg.teacher_capacities))
    if fault:
        batch = dict(batch, t2s=torch.roll(batch["t2s"], 1, dims=1))
    terms = {k: v.item() for k, v in step(batch).items()}
    return terms, {n: p.grad.numpy().copy() for n, p in port.model_s.named_parameters()}


def _epoch(out):
    m = re.findall(r"^epoch 1/1: steps=(\d+) loss=([-0-9.naif]+) miou=([0-9.]+)", out, re.M)
    assert m, out[-3000:]
    return int(m[-1][0]), float(m[-1][1]), float(m[-1][2])


def test_cli_chain_on_files(mini_root, tmp_path):
    """Stage 1 on ``spformer_mini.yaml``, then stage 2 on ``tsd_mini.yaml``
    with stage 1's checkpoint as its teacher, from the files on disk."""
    s1 = str(tmp_path / "stage1")
    out = run_cli(["u2mkd_tpu_torch.train_spformer", STAGE1, "--run-dir", s1, "--cpu",
                   f"dataset.root={mini_root}", "num_epochs=1"])
    steps, loss, miou = _epoch(out)
    assert steps == 3 and math.isfinite(loss) and 0.0 <= miou <= 100.0
    assert "[val] scored on raw points: counts" in out
    ckpt = os.path.join(s1, "checkpoints", "latest.pt")
    assert os.path.isfile(ckpt) and os.path.isfile(os.path.join(s1, "checkpoints",
                                                                "max-iou-val-vox.pt"))
    s2 = str(tmp_path / "stage2")
    out = run_cli(["u2mkd_tpu_torch.train_lc_nusc_tsd_full", STAGE2, "--run-dir", s2, "--cpu",
                   f"dataset.root={mini_root}", "num_epochs=1", "dataset.im_cr=0.1",
                   f"model.teacher_pretrain={ckpt}"])
    assert f"loaded frozen teacher from {ckpt}" in out
    steps, loss, miou = _epoch(out)
    assert steps == 3 and math.isfinite(loss) and 0.0 <= miou <= 100.0
    assert "[val] scored on raw points: counts_pix, counts_vox" in out
    for name in ("latest.pt", "max-iou-val-vox.pt"):
        assert os.path.isfile(os.path.join(s2, "checkpoints", name)), name
