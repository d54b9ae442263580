"""The port's stage-2 distillation train step against the JAX package's
``make_distill_train_step``, on the CPU: the slice as a whole.

Two synthetic multimodal scans (P=512 student points, 640 teacher points, 2
cameras at 32x48), ``TSDFull`` at cr=0.25 with the cr_t=0.5 teacher, head
dim 4, capacities (256, 128, 64, 32, 16), the same bridged random weights on
both sides, ``sgd_spformer`` at lr 0.02 over the student's parameters (the
teacher frozen), f32. The JAX side runs its XLA paths
(``pallas_attention=False``, the banded attention exact while every window
fits its band, which the test asserts); the Pallas twin is ``slow``.
Dropout and drop path are 0 on both sides (the frameworks draw other random
bits): the JAX ``TSDFull`` passes its student no dropout rate, so a
test-local subclass builds the student with ``dropout_rate=0.0``.

Compared: the loss and each of its five terms; every student gradient
(read from a test-local optax transform that keeps the gradients it is
given in its state); every student parameter and BN statistic after two
steps; and the teacher, which stays bitwise as it was.

The student's gradients cannot be held to a fixed 1e-4 of their scale. Its
ReLUs meet pre-activations that lie within the two frameworks' f32 rounding
difference of zero, each one taking the other side of its kink in one
framework, and one such row moves a gradient by its share
(``test_student_gradient_gap_is_a_relu_kink`` shows one: the learner alone
agrees, and a central difference lands between the two one-sided values).
After two steps the state differs by a tenth of its change. So gradients,
second-step terms and the two-step state are
held as ``chip_smoke.py`` holds the card's kernel step: within GRAD_SPREADS
times the median spread of three steps of the port from weights nudged by
about one ulp, and never tighter than the fixed tolerances; and a planted
wiring fault (the teacher's rows gathered one point off) must miss that
bound by at least FAULT_MARGIN, so that the bound cannot pass anything.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from u2mkd_tpu.models.msp2ifm import SPVCNNSwiftNetMSP2IFM as JaxStudent
from u2mkd_tpu.models.plumbing import from_precomputed as jax_from_precomputed
from u2mkd_tpu.models.tsd import TSDFull as JaxTSDFull
from u2mkd_tpu.train import distill as jax_distill
from u2mkd_tpu.train import optim as jax_optim
from u2mkd_tpu.train import state as jax_state

from test_torch_model import _random_variables
from test_torch_student_eval import GEOMETRY, NCLS, S_CAPS, T_CAPS, _jax_plumbing
from u2mkd_tpu.data import synthetic as jax_synthetic
from u2mkd_tpu.data import wgeom_host as jax_wgeom_host
from u2mkd_tpu_torch.data import plumbing_host, wgeom_host
from u2mkd_tpu_torch.models import convert_weights
from u2mkd_tpu_torch.models.tsd import TSDFull
from u2mkd_tpu_torch.train import distill

LR = 0.02
# The loss and its terms agree to 1e-5 (f32 sums in another order). A
# gradient's difference is taken over its parameter's largest entry, the
# scale floored at GRAD_FLOOR of the student's largest gradient entry (a
# bias before batch-statistic BN has a true gradient of 0, given as f32
# noise by both); a parameter's or BN statistic's after two steps over its
# change, plus two f32 ulps of its value. Each is held to GRAD_SPREADS times
# the median of NUDGE_SEEDS' spreads, and at least to GRAD_RTOL and
# UPDATE_RTOL (module docstring).
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-3
UPDATE_RTOL = 1e-2
GRAD_SPREADS = 4.0
NUDGE_SEEDS = (1, 2, 3)
FAULT_MARGIN = 2.0
TERMS = ("loss", "ce_vox", "ce_pix", "kl", "feat", "mse")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """At most two CPU threads per test process: the tier-1 run shares the
    machine's cores among several workers, and more threads each only
    contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


class _JaxTSDNoDropout(JaxTSDFull):
    """JAX ``TSDFull`` whose student drops nothing (the JAX wrapper passes
    its student no dropout rate, so it drops at the student's 0.3)."""

    @nn.nowrap
    def make_student(self):
        return JaxStudent(cr=self.cr, in_channel=self.in_channel,
                          adapt_out_ch=int(self.cr_t * 256),
                          run_pix_decoder=self.run_pix_decoder, dropout_rate=0.0,
                          **self._common_kwargs())


def _capturing(tx):
    """``tx`` that also keeps the gradients it was given in its state."""

    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def _batches(model, pallas):
    """Two scans as (JAX batch, port batch); both carry host plumbing."""
    wp = (lambda m: jax_wgeom_host.params_from_model(m)) if pallas else (lambda m: None)
    out = []
    for seed in (3, 4):
        raw = jax_synthetic.make_multimodal_batch(np.random.RandomState(seed), 1, 512, 640,
                                                  voxel_size=0.3, num_cams=2, im_hw=(32, 48))
        bj = {part: {k: jnp.asarray(v) for k, v in raw[part].items()}
              for part in ("student", "teacher")}
        bj["student"]["plumbing"] = _jax_plumbing(raw["student"], S_CAPS,
                                                  wp(model.make_student()))
        bj["teacher"]["plumbing"] = _jax_plumbing(raw["teacher"], T_CAPS,
                                                  wp(model.make_teacher()))
        bj["t2s"] = jnp.asarray(raw["t2s"])
        out.append((bj, raw))
    return out


def _port_batch(raw, port):
    pb = {"t2s": raw["t2s"]}
    for part, caps, sub in (("student", S_CAPS, port.model_s), ("teacher", T_CAPS, port.model_t)):
        b = raw[part]
        arrays = plumbing_host.batch_plumbing(b["pcoords"], b["xyz"], b["pmask"], caps,
                                              wgeom_params=wgeom_host.params_from_model(sub))
        pb[part] = dict(b, plumbing=arrays)
    return pb


def _port(variables, **kw):
    port = TSDFull(num_classes=NCLS, cr=0.25, cr_t=0.5, pallas_attention=True,
                   **dict(GEOMETRY, **kw))
    port.load_state_dict(convert_weights.from_flax(variables["params"],
                                                   variables["batch_stats"]))
    return port


def _grad_diff(got, ref):
    """Largest difference of a gradient from ``ref``'s over the parameter's
    largest ``ref`` entry, floored at GRAD_FLOOR of the largest of all;
    and that parameter's name."""
    floor = GRAD_FLOOR * max(float(np.abs(g).max()) for g in ref.values())
    assert floor > 0
    return max((float(np.abs(got[n] - g).max()) / max(float(np.abs(g).max()), floor), n)
               for n, g in ref.items())


def _terms_diff(got, ref):
    """Largest relative difference of a loss term from ``ref``'s; its name."""
    return max((abs(got[k] - ref[k]) / abs(ref[k]), k) for k in TERMS)


def _state_diff(got, ref, start):
    """Largest difference of a student parameter or BN statistic after two
    steps from ``ref``'s, over ``ref``'s change plus two f32 ulps of its
    value; and its name."""
    def one(n):
        change = float(np.abs(ref[n] - start[n]).max())
        ulps = 2 * float(np.spacing(np.abs(ref[n]).max().astype(np.float32)))
        return float(np.abs(got[n] - ref[n]).max()) / (change + ulps)

    return max((one(n), n) for n in ref if n.startswith("model_s."))


def _nudged(variables, seed):
    """The flax variables with every parameter times (1 + 2^-23 N(0, 1)),
    about one f32 ulp."""
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x * (1 + 2.0 ** -23 * rng.randn(*x.shape)), np.float32),
        variables["params"])
    return {"params": params, "batch_stats": variables["batch_stats"]}


def _port_run(variables, port_batches, fault=False):
    """Two port steps from the bridged ``variables`` -> (the terms of each
    step, the first step's student gradients, the state dicts before and
    after). ``fault`` gathers the teacher's rows one student point off."""
    port = _port(variables, dropout_rate=0.0, drop_path_rate=0.0)
    start = {k: v.numpy().copy() for k, v in port.state_dict().items()}
    opt, _ = distill.make_frozen_teacher_optimizer(port, "sgd_spformer", LR)
    step_fn = distill.make_distill_train_step(port, opt, S_CAPS, T_CAPS)
    terms, grads = [], None
    for pb in port_batches:
        if fault:
            pb = dict(pb, t2s=np.roll(pb["t2s"], 1, axis=1))
        terms.append({k: v.item() for k, v in step_fn(pb).items()})
        if grads is None:
            grads = {n: p.grad.numpy().copy() for n, p in port.model_s.named_parameters()}
            assert all(p.grad is None and not p.requires_grad
                       for p in port.model_t.parameters())
    return terms, grads, start, {k: v.numpy() for k, v in port.state_dict().items()}


def _distill_parity(pallas: bool):
    model = _JaxTSDNoDropout(num_classes=NCLS, cr=0.25, cr_t=0.5, drop_path_rate=0.0,
                             pallas_attention=pallas, pallas_cubic=pallas, **GEOMETRY)
    batches = _batches(model, pallas)
    bj0 = batches[0][0]

    def init(sb, tb):
        spl = jax_from_precomputed(sb["plumbing"], sb["pmask"])
        tpl = jax_from_precomputed(tb["plumbing"], tb["pmask"])
        return model.init(jax.random.PRNGKey(0), sb, spl, tb, tpl, False, True)

    variables = _random_variables(jax.eval_shape(init, bj0["student"], bj0["teacher"]), 13)
    tx = _capturing(jax_distill.make_frozen_teacher_optimizer(
        jax_optim.make_optimizer("sgd_spformer", LR)))
    st = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]))
    step_j = jax.jit(jax_distill.make_distill_train_step(model, tx, S_CAPS, T_CAPS))
    terms_j, grads_j = [], None
    for bj, _ in batches:
        st, aux = step_j(st, bj, jax.random.PRNGKey(1))
        terms_j.append({k: float(aux[k]) for k in TERMS})
        if grads_j is None:
            grads = jax.tree_util.tree_map(np.asarray, st.opt_state[1])
            assert all(float(np.abs(g).max()) == 0.0
                       for g in jax.tree_util.tree_leaves(grads["model_t"]))
            grads_j = {k: v.numpy() for k, v in convert_weights.from_flax(grads["model_s"],
                                                                           {}).items()}
    state_j = {k: v.numpy() for k, v in convert_weights.from_flax(
        jax.tree_util.tree_map(np.asarray, st.params),
        jax.tree_util.tree_map(np.asarray, st.batch_stats)).items()}

    probe = _port(variables)
    port_batches = [_port_batch(raw, probe) for _, raw in batches]
    if not pallas:  # the banded JAX attention is exact at these occupancies
        for pb in port_batches:
            for part in ("student", "teacher"):
                wg = pb[part]["plumbing"]["wgeom"]
                assert max(int(g["occ"].max()) for g in wg["sphere"]) <= 4 * 128
                assert max(int(g["occ"].max()) for g in wg["cubic"]) <= 128

    terms, grads, start, state = _port_run(variables, port_batches)
    assert sorted(terms[0]) == sorted(TERMS)
    for k in TERMS:  # the first step's, from the same weights
        assert terms_j[0][k] != 0.0, k
        np.testing.assert_allclose(terms[0][k], terms_j[0][k], rtol=LOSS_RTOL, err_msg=k)
    assert sorted(grads) == sorted(grads_j) and sorted(state) == sorted(state_j)
    for name, v in state.items():  # the frozen teacher: bitwise as it was, both sides
        if name.startswith("model_t."):
            np.testing.assert_array_equal(v, start[name], err_msg=name)
            np.testing.assert_array_equal(state_j[name], start[name], err_msg=name)

    nudged = [_port_run(_nudged(variables, s), port_batches) for s in NUDGE_SEEDS]
    grad_tol = max(GRAD_RTOL, GRAD_SPREADS * float(np.median(
        [_grad_diff(r[1], grads)[0] for r in nudged])))
    state_tol = max(UPDATE_RTOL, GRAD_SPREADS * float(np.median(
        [_state_diff(r[3], state, start)[0] for r in nudged])))
    # the second step's, from weights that already differ as the gradients do
    loss_tol = max(LOSS_RTOL, GRAD_SPREADS * float(np.median(
        [_terms_diff(r[0][1], terms[1])[0] for r in nudged])))
    loss_err, loss_name = _terms_diff(terms[1], terms_j[1])
    assert loss_err <= loss_tol, (loss_name, loss_err, loss_tol)
    grad_err, grad_name = _grad_diff(grads, grads_j)
    state_err, state_name = _state_diff(state, state_j, start)
    assert grad_err <= grad_tol, (grad_name, grad_err, grad_tol)
    assert state_err <= state_tol, (state_name, state_err, state_tol)
    f_terms, f_grads, _, f_state = _port_run(variables, port_batches, fault=True)
    print(f"second-step terms {loss_err:.3g} (tolerance {loss_tol:.3g}, fault "
          f"{_terms_diff(f_terms[1], terms_j[1])[0]:.3g}); gradients {grad_err:.3g} "
          f"{grad_name} ({grad_tol:.3g}, {_grad_diff(f_grads, grads_j)[0]:.3g}); two-step "
          f"state {state_err:.3g} {state_name} ({state_tol:.3g}, "
          f"{_state_diff(f_state, state_j, start)[0]:.3g})")
    assert _terms_diff(f_terms[1], terms_j[1])[0] >= FAULT_MARGIN * loss_tol
    assert _grad_diff(f_grads, grads_j)[0] >= FAULT_MARGIN * grad_tol
    assert _state_diff(f_state, state_j, start)[0] >= FAULT_MARGIN * state_tol


def test_distill_train_step_matches_jax():
    """The slice as a whole against the JAX package's XLA paths."""
    _distill_parity(pallas=False)


@pytest.mark.slow
def test_distill_train_step_matches_jax_pallas():
    """The Pallas twin: the JAX package's rulebook conv and flash attention
    with their custom VJPs in interpret mode, on the host geometry."""
    _distill_parity(pallas=True)


def _port_setup(seed=5, **kw):
    """A port TSDFull with random weights from ``seed`` (dropout and drop
    path at their defaults unless ``kw`` says otherwise), its optimizer, and
    one scan with its plumbing."""
    port = TSDFull(num_classes=NCLS, cr=0.25, cr_t=0.5, pallas_attention=True,
                   generator=torch.Generator().manual_seed(seed), **dict(GEOMETRY, **kw))
    opt, _ = distill.make_frozen_teacher_optimizer(port, "sgd_spformer", LR)
    raw = jax_synthetic.make_multimodal_batch(np.random.RandomState(3), 1, 512, 640,
                                              voxel_size=0.3, num_cams=2, im_hw=(32, 48))
    return port, opt, _port_batch(raw, port)


@pytest.fixture
def one_thread():
    """One CPU thread: the image branch's backward sums in an order that
    depends on the thread count and layout, and bitwise comparisons need
    one order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_split_step_equals_fused_step(one_thread):
    """``make_distill_split_steps``: the teacher's call and then the
    student's give the fused step's terms, parameters and BN statistics
    bitwise, with dropout and drop path drawn from generators of one seed;
    the teacher's outputs come back detached in student order."""
    results = []
    for split in (False, True):
        port, opt, pb = _port_setup()
        gen = torch.Generator().manual_seed(8)
        if split:
            step = distill.make_distill_split_steps(port, opt, S_CAPS, T_CAPS, generator=gen)
            t_out = step.teacher_fn(pb)
            assert t_out["x_vox_t2s"].shape == (1, 512, NCLS)
            assert t_out["feat_t2s"].shape == (1, 512, 128)
            assert not t_out["x_vox_t2s"].requires_grad
            aux = step.student_fn(pb, t_out)
        else:
            aux = distill.make_distill_train_step(port, opt, S_CAPS, T_CAPS, generator=gen)(pb)
        results.append((aux, port.state_dict()))
    (aux_f, sd_f), (aux_s, sd_s) = results
    for k in TERMS:
        assert torch.equal(aux_f[k], aux_s[k]), k
    for k in sd_f:
        assert torch.equal(sd_f[k], sd_s[k]), k


def test_step_repeats_with_one_generator_seed(one_thread):
    """Dropout and drop path draw from the step's generator only: two steps
    from the same weights and generator seed are bitwise equal (terms,
    parameters and BN statistics), another seed draws other masks; the
    teacher is frozen and in eval mode throughout."""
    losses, states = [], []
    for gen_seed in (8, 8, 9):
        port, opt, pb = _port_setup()
        t0 = {k: v.clone() for k, v in port.model_t.state_dict().items()}
        s0 = {k: v.clone() for k, v in port.model_s.state_dict().items()}
        step = distill.make_distill_train_step(
            port, opt, S_CAPS, T_CAPS, generator=torch.Generator().manual_seed(gen_seed))
        aux = step(pb)
        assert all(torch.isfinite(aux[k]) for k in TERMS)
        assert port.model_s.training and not port.model_t.training
        for k, v in port.model_t.state_dict().items():
            assert torch.equal(v, t0[k]), k
        moved = [k for k, v in port.model_s.state_dict().items() if not torch.equal(v, s0[k])]
        assert len(moved) > 0.9 * len(s0)
        losses.append(aux["loss"].item())
        states.append(port.state_dict())
    assert losses[0] == losses[1]
    assert all(torch.equal(v, states[1][k]) for k, v in states[0].items())
    assert losses[0] != losses[2]


@pytest.mark.parametrize("mse_norm_feat", [False, True])
def test_distill_losses_match_jax(mse_norm_feat):
    """``_distill_losses`` on the same random student outputs, teacher
    outputs and masks as the JAX function, with and without the min-max
    normalization of the stage-4 features: each term to LOSS_RTOL, and the
    gradient of the loss with respect to each student output (no ReLU on
    this path) to GRAD_RTOL of its largest entry."""
    rng = np.random.RandomState(6)
    b, p, c, f = 2, 300, NCLS, 24
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    stu = {"x_vox": f32(rng.randn(b, p, c)), "x_pix": f32(rng.randn(b, p, c)),
           "pts_feats": f32(rng.randn(b, p, f)), "mse": f32(rng.rand(2))}
    x_vox_t, feat_t = f32(rng.randn(b, p, c)), f32(rng.randn(b, p, f))
    labels = rng.randint(0, c, (b, p))
    pmask = rng.rand(b, p) < 0.9
    fov = pmask & (rng.rand(b, p) < 0.6)
    label_valid = pmask & (labels != 0)
    t2s_valid = pmask & (rng.rand(b, p) < 0.8)
    masks = (fov, label_valid, t2s_valid)
    weights = (0.7, 1.3, mse_norm_feat)

    def jax_loss(outs):
        s_ = dict(outs, mse_loss=[outs["mse"][0], outs["mse"][1]])
        return jax_distill._distill_losses(s_, jnp.asarray(x_vox_t), jnp.asarray(feat_t),
                                           jnp.asarray(labels), *map(jnp.asarray, masks),
                                           *weights)

    (_, ref), ref_grads = jax.value_and_grad(jax_loss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in stu.items()})
    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in stu.items()}
    loss, got = distill._distill_losses(
        dict(leaves, mse_loss=[leaves["mse"][0], leaves["mse"][1]]),
        torch.from_numpy(x_vox_t), torch.from_numpy(feat_t), torch.from_numpy(labels).long(),
        *map(torch.from_numpy, masks), *weights)
    loss.backward()
    assert torch.equal(got["loss"], loss.detach())
    for k in TERMS:
        np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=LOSS_RTOL, err_msg=k)
    for k, t in leaves.items():
        want = np.asarray(ref_grads[k])
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=0,
                                   atol=GRAD_RTOL * np.abs(want).max(), err_msg=k)


@pytest.mark.slow
def test_student_gradient_gap_is_a_relu_kink():
    """Why the step's gradients are held to a measured spread (module
    docstring), at weight seed 14, where they differ most: the gradient of
    the stage-3 learner MSE (``mse_loss[2]``) with respect to
    ``learner2.bn1.bias`` in JAX's full forward and in the port's differ
    (printed), while the loss agrees to LOSS_RTOL; the learner alone, fed
    the port's inputs, gives both frameworks the same gradients to
    GRAD_RTOL; and a central difference of JAX's loss over the most
    different channel lands between the two one-sided gradients, as it
    does across a ReLU's kink."""
    from u2mkd_tpu.models.fusion import LearnerMLP as JaxLearner
    from u2mkd_tpu.ops import losses as jax_losses
    from u2mkd_tpu.train.state import get_plumbing
    from u2mkd_tpu_torch.models import msp2ifm
    from u2mkd_tpu_torch.train.state import batch_reader

    stage, key = 2, "learner2.bn1.bias"
    model = _JaxTSDNoDropout(num_classes=NCLS, cr=0.25, cr_t=0.5, drop_path_rate=0.0,
                             pallas_attention=False, pallas_cubic=False, **GEOMETRY)
    bj, raw = _batches(model, False)[0]
    sb = bj["student"]

    def init(s, t):
        return model.init(jax.random.PRNGKey(0), s, jax_from_precomputed(s["plumbing"],
                                                                         s["pmask"]),
                          t, jax_from_precomputed(t["plumbing"], t["pmask"]), False, True)

    variables = _random_variables(jax.eval_shape(init, sb, bj["teacher"]), 14)

    def jax_mse(params):
        out, _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]}, sb,
                             get_plumbing(sb, S_CAPS), None, None, True, False,
                             rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        return out["stu"]["mse_loss"][stage]

    loss_j, grads = jax.jit(jax.value_and_grad(jax_mse))(variables["params"])
    g_j = convert_weights.from_flax(jax.tree_util.tree_map(np.asarray, grads["model_s"]),
                                    {})[key].numpy()

    port = _port(variables, dropout_rate=0.0, drop_path_rate=0.0).train()
    _, plumbing, tensor_of = batch_reader(port.model_s, S_CAPS)
    spl = plumbing(_port_batch(raw, port)["student"])
    s_in = {k: tensor_of(raw["student"], k, dt) for k, dt in distill.STUDENT_KEYS.items()}
    learner = getattr(port.model_s, f"learner{stage}")
    seen = {}
    hook = learner.register_forward_hook(
        lambda m, args, out: seen.update(x=args[0].detach(), mask=args[1]))
    calls = []
    record = msp2ifm.losses.masked_mse

    def recording(a, b, valid):
        calls.append((b.detach(), valid))
        return record(a, b, valid)

    msp2ifm.losses.masked_mse = recording
    try:
        stu = port(s_in, spl, run_teacher=False, generator=torch.Generator())["stu"]
    finally:
        msp2ifm.losses.masked_mse = record
        hook.remove()
    stu["mse_loss"][stage].backward()
    g_p = learner.bn1.bias.grad.numpy()
    np.testing.assert_allclose(stu["mse_loss"][stage].item(), float(loss_j), rtol=LOSS_RTOL)
    scale = max(np.abs(g_j).max(), 1e-30)
    print(f"{key}: JAX and port differ by {np.abs(g_p - g_j).max() / scale:.3g} of its scale")

    # the learner alone, on the port's inputs, in both frameworks
    imf, valid = calls[stage]
    x, mask = seen["x"], seen["mask"]
    jl = JaxLearner(learner.fc1.out_features)
    sub = {c: variables[c]["model_s"][f"learner{stage}"] for c in ("params", "batch_stats")}

    def jax_alone(p):
        y, _ = jl.apply({"params": p, "batch_stats": sub["batch_stats"]}, jnp.asarray(x.numpy()),
                        jnp.asarray(mask.numpy()), True, mutable=["batch_stats"])
        return jax_losses.masked_mse(y.reshape(-1, y.shape[-1]), jnp.asarray(imf.numpy()),
                                     jnp.asarray(valid.numpy()))

    alone_j = np.asarray(jax.grad(jax_alone)(sub["params"])["bn1"]["bias"])
    learner.zero_grad()
    y = learner(x, mask)
    record(y.reshape(-1, y.shape[-1]), imf, valid).backward()
    alone_p = learner.bn1.bias.grad.numpy()
    np.testing.assert_allclose(alone_p, alone_j, rtol=0,
                               atol=GRAD_RTOL * np.abs(alone_j).max())

    # a central difference of JAX's loss over the most different channel
    c = int(np.argmax(np.abs(g_p - g_j)))
    h = 1e-2
    fd = []
    f = jax.jit(jax_mse)
    for sign in (1.0, -1.0):
        params = jax.tree_util.tree_map(lambda a: a, variables["params"])
        bias = np.array(params["model_s"][f"learner{stage}"]["bn1"]["bias"])
        bias[c] += sign * h
        params["model_s"][f"learner{stage}"]["bn1"]["bias"] = jnp.asarray(bias)
        fd.append(float(f(params)))
    fd = (fd[0] - fd[1]) / (2 * h)
    lo, hi = sorted((float(g_j[c]), float(g_p[c])))
    slack = 1e-2 * (hi - lo) + 1e-6
    print(f"channel {c}: JAX {g_j[c]:.6g}, port {g_p[c]:.6g}, central difference {fd:.6g}")
    assert lo - slack <= fd <= hi + slack
