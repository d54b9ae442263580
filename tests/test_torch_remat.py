"""``remat`` in the port's train steps, on the CPU.

``remat=True`` runs the model's segments under ``torch.utils.checkpoint``
(``models/blocks.Remat``): the backward recomputes each segment's forward.
It must compute what ``remat=False`` computes. At the sizes of
``tests/test_torch_train.py`` and ``tests/test_torch_distill.py``, with
dropout and drop path on:

* the teacher step (on host plumbing, and on plumbing built in the step,
  whose window sorts the recompute takes from the forward), the stage-2
  step, the split steps and the SphereFormer U-Net's step (segments per
  level) with ``remat=True`` equal ``remat=False`` bitwise over two steps:
  every loss term, every gradient, the parameters and BN running
  statistics, and the generator's state after the step;
* two planted faults (``chip_smoke.planted_remat_fault``) break that
  equality: a recompute that draws from the generator where the forward
  left it, and one that updates the BN running statistics a second time;
* the remat steps match the JAX package's ``make_train_step(...,
  remat=True)`` (the teacher and the U-Net) and
  ``make_distill_train_step(..., remat=True)`` (XLA paths) with the masks
  the port drew fed to JAX's draws, within the tolerances of
  ``tests/test_torch_train.py``, ``tests/test_torch_sphereformer_unet.py``
  and ``tests/test_torch_distill.py``; the generator fault misses the
  stage-2 bound;
* a two-rank gloo data-parallel stage-2 step with remat equals the one
  without.
"""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2mkd_tpu.data import plumbing_host as jax_plumbing_host
from u2mkd_tpu.data import synthetic as jax_synthetic
from u2mkd_tpu.models.plumbing import from_precomputed as jax_from_precomputed
from u2mkd_tpu.models.spvcnn import SPVCNN as JaxSPVCNN
from u2mkd_tpu.models.tsd import TSDFull as JaxTSDFull
from u2mkd_tpu.train import distill as jax_distill
from u2mkd_tpu.train import optim as jax_optim
from u2mkd_tpu.train import state as jax_state

import chip_smoke
from test_torch_distill import (FAULT_MARGIN, GRAD_SPREADS, TERMS, _batches, _capturing,
                                _grad_diff, _port_batch, _port_setup)
from test_torch_model import _random_variables
import torch_dp_worker
from test_torch_parallel import LR, RANK_TIMEOUT_S, _ranks
from test_torch_sphereformer_unet import GEOMETRY as UNET_GEOMETRY
from test_torch_sphereformer_unet import _batch as _unet_batch
from test_torch_sphereformer_unet import _models as _unet_models
from test_torch_sphereformer_unet import _variables as _unet_variables
from test_torch_student_eval import GEOMETRY, NCLS, S_CAPS, T_CAPS
from test_torch_train import GRAD_FLOOR, GRAD_RTOL, LOSS_RTOL, _compare
from u2mkd_tpu_torch.data import plumbing_host, synthetic, wgeom_host
from u2mkd_tpu_torch.models import blocks, convert_weights
from u2mkd_tpu_torch.models import sphereformer as sphereformer_mod
from u2mkd_tpu_torch.models.sphereformer_unet import SphereFormerSemantic
from u2mkd_tpu_torch.models.spvcnn import teacher_model
from u2mkd_tpu_torch.models.tsd import TSDFull
from u2mkd_tpu_torch.train import distill, optim, state

CAPS = (256, 128, 64, 32, 16)
TEACHER_CLASSES = 5
GEN_SEED = 8
KINDS = ("teacher", "teacher_device_plumbing", "distill", "split", "unet")
UNET_PLANES = (8, 16, 16, 16, 16)


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: the image branch's backward sums in an order that
    depends on the thread count, and bitwise comparisons need one order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _teacher_batch(port, host_plumbing=True, seed=3):
    raw = synthetic.make_batch(np.random.RandomState(seed), 1, 512, voxel_size=0.3)
    if host_plumbing:
        raw["plumbing"] = plumbing_host.batch_plumbing(
            raw["pcoords"], raw["xyz"], raw["pmask"], CAPS,
            wgeom_params=wgeom_host.params_from_model(port))
    return raw


def _teacher():
    """The teacher of test_torch_train's size, dropout and drop path at their
    rates (0.3), random weights from one seed."""
    return teacher_model(num_classes=TEACHER_CLASSES, cr=0.25, voxel_size=0.3, head_dim=4,
                         seed=3, device="cpu")


def _unet():
    """A narrow SphereFormer U-Net, drop path at 0.3, random weights from one
    seed."""
    return SphereFormerSemantic(num_classes=TEACHER_CLASSES, n_planes=UNET_PLANES,
                                head_dim=4, drop_path_rate=0.3,
                                generator=torch.Generator().manual_seed(3), **UNET_GEOMETRY)


def _model_of(kind):
    return {"teacher": _teacher, "unet": _unet}.get(kind.split("_")[0],
                                                    lambda: _port_setup()[0])()


def _steps(kind, remat):
    """Two steps of ``kind`` from one seed's weights and generator ->
    (the steps' aux, the second step's gradients, the state dict, the
    generator's state)."""
    gen = torch.Generator().manual_seed(GEN_SEED)
    if kind.startswith("teacher") or kind == "unet":
        model = _model_of(kind)
        batch = _teacher_batch(model, host_plumbing=kind != "teacher_device_plumbing")
        opt, _ = optim.make_optimizer(model.named_parameters(), "sgd_spformer", LR)
        step = state.make_train_step(model, opt, CAPS, generator=gen, remat=remat)
    else:
        model, opt, batch = _port_setup()
        make = (distill.make_distill_split_steps if kind == "split"
                else distill.make_distill_train_step)
        step = make(model, opt, S_CAPS, T_CAPS, generator=gen, remat=remat)
    auxes = [{k: v.clone() for k, v in step(batch).items()} for _ in range(2)]
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return auxes, grads, model.state_dict(), gen.get_state()


def _differences(a, b):
    """The names of what differs between two :func:`_steps` results."""
    (aux_a, grads_a, sd_a, gen_a), (aux_b, grads_b, sd_b, gen_b) = a, b
    out = [f"step {i} {k}" for i, (x, y) in enumerate(zip(aux_a, aux_b))
           for k in x if not torch.equal(x[k], y[k])]
    out += [f"grad {n}" for n in grads_a if not torch.equal(grads_a[n], grads_b[n])]
    out += [n for n in sd_a if not torch.equal(sd_a[n], sd_b[n])]
    return out + ([] if torch.equal(gen_a, gen_b) else ["generator"])


@pytest.mark.parametrize("kind", KINDS)
def test_remat_step_equals_the_step(kind):
    """remat=True gives remat=False's two steps bitwise: terms, gradients,
    parameters, BN running statistics, the generator's state; the teacher's
    gradients and every BN statistic moved (the check sees something)."""
    ref = _steps(kind, remat=False)
    got = _steps(kind, remat=True)
    assert sorted(ref[1]) == sorted(got[1]) and len(ref[1]) > 50
    assert not _differences(ref, got)
    start = _model_of(kind).state_dict()
    moved = [k for k, v in ref[2].items() if "running_" in k and not torch.equal(v, start[k])]
    frozen = [k for k in start if k.startswith("model_t.") and "running_" in k]
    assert len(moved) == len([k for k in start if "running_" in k]) - len(frozen)


def test_recompute_takes_the_forward_window_sorts(monkeypatch):
    """On plumbing built in the step the attention sorts its windows in the
    step: a remat step sorts each branch once, as a step without remat
    does, and its recompute takes the forward's sorts."""
    calls = []
    sort = sphereformer_mod.window_sort_batched
    monkeypatch.setattr(sphereformer_mod, "window_sort_batched",
                        lambda *a: calls.append(1) or sort(*a))
    counts = []
    for remat in (False, True):
        calls.clear()
        _steps("teacher_device_plumbing", remat)
        counts.append(len(calls))
    assert counts[0] == counts[1] == 2 * 8  # two steps, two branches at four levels


@pytest.mark.parametrize("fault", chip_smoke.REMAT_FAULTS)
@pytest.mark.parametrize("kind", ["teacher", "distill", "unet"])
def test_planted_fault_breaks_the_equality(kind, fault):
    """Each planted fault makes remat=True differ from remat=False where it
    should: the generator fault in the gradients, the state and the
    generator's state; the BN fault in the running statistics."""
    ref = _steps(kind, remat=False)
    with chip_smoke.planted_remat_fault(fault):
        got = _steps(kind, remat=True)
    diff = _differences(ref, got)
    if fault == "generator":
        assert "generator" in diff and any(d.startswith("grad") for d in diff)
    else:
        stats = [d for d in diff if "running_" in d]
        assert stats and not any(d.startswith("grad") for d in diff)


def test_data_parallel_remat_step_equals_the_step(tmp_path):
    """Two gloo ranks, each on its own scan with its own generator: the
    stage-2 data-parallel step with remat (the synced BNs' sums run again in
    the recompute) equals the one without, bitwise, on each rank."""
    kw = dict(num_classes=NCLS, cr=0.25, cr_t=0.5, pallas_attention=True, **GEOMETRY)
    port = TSDFull(generator=torch.Generator().manual_seed(5), **kw)
    start = {k: v.numpy().copy() for k, v in port.state_dict().items()}
    raws = [synthetic.make_multimodal_batch(np.random.RandomState(s), 1, 512, 640,
                                            voxel_size=0.3, num_cams=2, im_hw=(32, 48))
            for s in (3, 4)]
    got = _ranks("remat", {"model": kw, "state": start, "lr": LR, "s_caps": S_CAPS,
                           "t_caps": T_CAPS, "batches": [_port_batch(r, port) for r in raws],
                           "seed": GEN_SEED}, tmp_path)
    for rank in got:
        off, on = rank[False], rank[True]
        assert off["aux"] == on["aux"]
        np.testing.assert_array_equal(off["generator"], on["generator"])
        for k, v in off["state"].items():
            np.testing.assert_array_equal(on["state"][k], v, err_msg=k)
    assert got[0][True]["aux"]["loss"] == got[1][True]["aux"]["loss"]


# ---- against the JAX package's remat steps -----------------------------------


@contextlib.contextmanager
def recorded_masks(masks):
    """Inside, the port's dropout and drop-path masks are appended to
    ``masks`` (numpy bool) as they are drawn."""
    keep = blocks._keep_mask

    def recording(*args):
        m = keep(*args)
        masks.append(m.numpy().copy())
        return m

    blocks._keep_mask = recording
    try:
        yield masks
    finally:
        blocks._keep_mask = keep


def _port_forward_masks(model, *args, **kw):
    """The masks one train-mode forward of (a copy of) ``model`` draws."""
    masks = []
    with recorded_masks(masks), torch.no_grad():
        copy.deepcopy(model).train()(*args, **kw)
    return masks


@contextlib.contextmanager
def jax_draws(masks):
    """Inside, ``jax.random.bernoulli`` (the JAX models' dropout and drop
    path) hands out ``masks`` in order, each checked against the shape
    asked for; JAX may trace the forward more than once."""
    bernoulli = jax.random.bernoulli
    calls = [0]

    def fed(key, p, shape):
        m = masks[calls[0] % len(masks)]
        calls[0] += 1
        assert tuple(shape) == m.shape, (shape, m.shape)
        return jnp.asarray(m)

    jax.random.bernoulli = fed
    try:
        yield calls
    finally:
        jax.random.bernoulli = bernoulli


def test_teacher_remat_step_matches_jax():
    """The port's teacher step with remat against JAX's
    ``make_train_step(..., remat=True)`` on its XLA paths, dropout and drop
    path at 0.3 with the port's masks: the loss to LOSS_RTOL and every
    gradient to GRAD_RTOL of its parameter's largest entry (floored at
    GRAD_FLOOR of all), test_torch_train's tolerances."""
    ws = 0.3 * 6
    model = JaxSPVCNN(
        num_classes=TEACHER_CLASSES, cr=0.25, sphereformer=True, window_size=(ws, ws, ws),
        quant_size=(ws / 24,) * 3, window_size_sphere=(2.0, 2.0, 120.0),
        quant_size_sphere=(2.0 / 24, 2.0 / 24, 5.0), window_size_scale=(2.0, 2.0),
        dropout_rate=0.3, drop_path_rate=0.3, sphere_a=0.0125, head_dim=4)
    raw = jax_synthetic.make_batch(np.random.RandomState(3), 1, 512, voxel_size=0.3,
                                   num_sweep_factor=2)
    pl = jax_plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"], CAPS)
    batch_j = {k: jnp.asarray(v) for k, v in raw.items()}
    batch_j["plumbing"] = jax.tree_util.tree_map(
        jnp.asarray, {k: v for k, v in pl.items() if not k.startswith("cr27")})
    abstract = jax.eval_shape(
        lambda f, a: model.init(jax.random.PRNGKey(0), f,
                                jax_from_precomputed(a, batch_j["pmask"]), False),
        batch_j["feats"], batch_j["plumbing"])
    variables = _random_variables(abstract, 7)

    port = _teacher()
    port.load_state_dict(convert_weights.from_flax(variables["params"],
                                                   variables["batch_stats"]))
    arrays = plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"], CAPS,
                                          wgeom_params=wgeom_host.params_from_model(port))
    # the banded JAX attention is exact at these occupancies
    assert max(int(g["occ"].max()) for g in arrays["wgeom"]["sphere"]) <= 4 * 128
    assert max(int(g["occ"].max()) for g in arrays["wgeom"]["cubic"]) <= 128
    pb = dict(raw, plumbing=arrays)
    _, plumbing_of, _ = state.batch_reader(port, CAPS)
    masks = _port_forward_masks(port, torch.as_tensor(raw["feats"]), plumbing_of(pb),
                                torch.Generator().manual_seed(GEN_SEED))
    assert len(masks) == 10  # two drop paths in each of four blocks, two dropouts

    tx = _capturing(jax_optim.make_optimizer("sgd_spformer", LR))
    st = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]))
    with jax_draws(masks) as calls:
        st, aux = jax.jit(jax_state.make_train_step(model, tx, CAPS, remat=True))(
            st, batch_j, jax.random.PRNGKey(1))
    assert calls[0] >= len(masks) and calls[0] % len(masks) == 0
    grads_j = convert_weights.from_flax(jax.tree_util.tree_map(np.asarray, st.opt_state[1]), {})

    opt, _ = optim.make_optimizer(port.named_parameters(), "sgd_spformer", LR)
    step = state.make_train_step(port, opt, CAPS, generator=torch.Generator().manual_seed(
        GEN_SEED), remat=True)
    loss = step(pb)["loss"].item()
    np.testing.assert_allclose(loss, float(aux["loss"]), rtol=LOSS_RTOL)
    named = dict(port.named_parameters())
    assert sorted(grads_j) == sorted(named)
    floor = GRAD_FLOOR * max(float(t.abs().max()) for t in grads_j.values())
    for name, g in grads_j.items():
        g = g.numpy()
        np.testing.assert_allclose(named[name].grad.numpy(), g, rtol=0,
                                   atol=GRAD_RTOL * max(np.abs(g).max(), floor), err_msg=name)


def test_unet_remat_step_matches_jax():
    """The port's U-Net step with remat (segments per level) against JAX's
    ``make_train_step(..., remat=True)`` on a U-Net whose windows fit the
    JAX band, drop path at 0.3 with the port's masks: the loss to
    LOSS_RTOL and every gradient by the rule of
    ``tests/test_torch_sphereformer_unet.py`` (GRAD_RTOL of its parameter's
    largest entry, floored at GRAD_FLOOR of all)."""
    model, port = _unet_models(drop_path_rate=0.3)
    port.train()
    batch_j, pb = _unet_batch(3, port)
    variables = _unet_variables(model, batch_j)
    port.load_state_dict(convert_weights.from_flax(variables["params"],
                                                   variables["batch_stats"]))
    _, plumbing_of, _ = state.batch_reader(port, CAPS)
    masks = _port_forward_masks(port, torch.as_tensor(pb["feats"]), plumbing_of(pb),
                                torch.Generator().manual_seed(GEN_SEED))
    assert len(masks) == 10  # two drop paths in the attention block of each level

    tx = _capturing(jax_optim.make_optimizer("sgd_spformer", LR))
    st = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]))
    with jax_draws(masks) as calls:
        st, aux = jax.jit(jax_state.make_train_step(model, tx, CAPS, remat=True))(
            st, batch_j, jax.random.PRNGKey(1))
    assert calls[0] >= len(masks) and calls[0] % len(masks) == 0
    grads_j = convert_weights.from_flax(jax.tree_util.tree_map(np.asarray, st.opt_state[1]), {})

    opt, _ = optim.make_optimizer(port.named_parameters(), "sgd_spformer", LR)
    step = state.make_train_step(port, opt, CAPS, generator=torch.Generator().manual_seed(
        GEN_SEED), remat=True)
    loss = step(pb)["loss"].item()
    np.testing.assert_allclose(loss, float(aux["loss"]), rtol=LOSS_RTOL)
    named = dict(port.named_parameters())
    assert sorted(grads_j) == sorted(named)
    floor = GRAD_FLOOR * max(float(t.abs().max()) for t in grads_j.values())
    for name, g in grads_j.items():
        _compare(f"grad {name}", named[name].grad, g, GRAD_RTOL, floor)


def _bridged(variables):
    """The flax ``variables`` as the port's state dict, numpy."""
    return {k: t.numpy() for k, t in convert_weights.from_flax(
        variables["params"], variables["batch_stats"]).items()}


def test_distill_remat_step_matches_jax(tmp_path):
    """The port's stage-2 step with remat against JAX's
    ``make_distill_train_step(..., remat=True)`` on its XLA paths, the
    student's dropout and drop path at 0.3 with the port's masks: each loss
    term to LOSS_RTOL, the student's gradients within GRAD_SPREADS times the
    median spread of three one-ulp-nudged port steps (at least GRAD_RTOL),
    test_torch_distill's rule; a remat that does not rewind the generator
    misses that by FAULT_MARGIN. The port's five steps (masks drawn from
    GEN_SEED, one thread) run in a process of ``tests/torch_dp_worker.py``
    while this one traces and runs the JAX program."""
    from test_torch_distill import _nudged

    model = JaxTSDFull(num_classes=NCLS, cr=0.25, cr_t=0.5, drop_path_rate=0.3,
                       pallas_attention=False, pallas_cubic=False, **GEOMETRY)
    bj, raw = _batches(model, pallas=False)[0]

    def init(sb, tb):
        spl = jax_from_precomputed(sb["plumbing"], sb["pmask"])
        tpl = jax_from_precomputed(tb["plumbing"], tb["pmask"])
        return model.init(jax.random.PRNGKey(0), sb, spl, tb, tpl, False, True)

    variables = _random_variables(jax.eval_shape(init, bj["student"], bj["teacher"]), 13)
    kw = dict(num_classes=NCLS, cr=0.25, cr_t=0.5, pallas_attention=True, **GEOMETRY)
    probe = TSDFull(**kw)
    probe.load_state_dict(convert_weights.from_flax(variables["params"],
                                                    variables["batch_stats"]))
    pb = _port_batch(raw, probe)
    for part in ("student", "teacher"):  # the banded JAX attention is exact here
        wg = pb[part]["plumbing"]["wgeom"]
        assert max(int(g["occ"].max()) for g in wg["sphere"]) <= 4 * 128
        assert max(int(g["occ"].max()) for g in wg["cubic"]) <= 128
    _, plumbing_of, tensor_of = state.batch_reader(probe.model_s, S_CAPS)
    s_in = {k: tensor_of(pb["student"], k, dt) for k, dt in distill.STUDENT_KEYS.items()}
    masks = _port_forward_masks(probe.model_s, s_in["feats"], plumbing_of(pb["student"]),
                                s_in["images"], s_in["pix_coords"], s_in["cam_masks"],
                                s_in["fov_mask"],
                                generator=torch.Generator().manual_seed(GEN_SEED))
    assert len(masks) == 10
    start = _bridged(variables)
    port_runs = torch_dp_worker.start("distill_grads", {
        "model": kw, "lr": LR, "s_caps": S_CAPS, "t_caps": T_CAPS, "seed": GEN_SEED,
        "remat": True, "batch": pb,
        "runs": {"reference": (start, None), "fault": (start, "generator"),
                 **{s: (_bridged(_nudged(variables, s)), None) for s in (1, 2, 3)}}},
        tmp_path, world=1, timeout=RANK_TIMEOUT_S)

    tx = _capturing(jax_distill.make_frozen_teacher_optimizer(
        jax_optim.make_optimizer("sgd_spformer", LR)))
    st = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=jax.jit(tx.init)(variables["params"]))
    with jax_draws(masks) as calls:
        st, aux = jax.jit(jax_distill.make_distill_train_step(model, tx, S_CAPS, T_CAPS,
                                                              remat=True))(
            st, bj, jax.random.PRNGKey(1))
    assert calls[0] >= len(masks) and calls[0] % len(masks) == 0
    grads_j = {k: v.numpy() for k, v in convert_weights.from_flax(
        jax.tree_util.tree_map(np.asarray, st.opt_state[1]["model_s"]), {}).items()}

    port = torch_dp_worker.collect(port_runs)[0]
    terms, grads = port["reference"]
    for k in TERMS:
        np.testing.assert_allclose(terms[k], float(aux[k]), rtol=LOSS_RTOL, err_msg=k)
    assert sorted(grads) == sorted(grads_j)
    spreads = [_grad_diff(port[s][1], grads)[0] for s in (1, 2, 3)]
    tol = max(GRAD_RTOL, GRAD_SPREADS * float(np.median(spreads)))
    err, name = _grad_diff(grads, grads_j)
    fault, fault_name = _grad_diff(port["fault"][1], grads_j)
    print(f"stage-2 remat gradients against JAX {err:.3g} ({name}) of tol {tol:.3g}; "
          f"generator fault {fault / tol:.3g}x ({fault_name})")
    assert err <= tol, (name, err, tol)
    assert fault >= FAULT_MARGIN * tol, (fault_name, fault, tol)
