"""The port's stage-2 student eval step against the JAX package's
``make_distill_eval_step``, on the CPU.

One synthetic multimodal scan (P=512 student points, 640 teacher points, 2
cameras at 32x48), ``TSDFull`` at cr=0.25 (teacher cr_t=0.5), head_dim 4,
capacities (256, 128, 64, 32, 16), the same bridged weights on both sides,
f32. The JAX side runs its XLA paths (``pallas_attention=False``), whose
banded attention is exact while every window fits its band, which the test
asserts; the Pallas twin is ``slow``.
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
from u2mkd_tpu.models.tsd import TSDFull as JaxTSDFull
from u2mkd_tpu.train import distill as jax_distill
from u2mkd_tpu.train import state as jax_state

from u2mkd_tpu_torch.data import plumbing_host, wgeom_host
from u2mkd_tpu_torch.models import convert_weights
from u2mkd_tpu_torch.models.plumbing import from_precomputed
from u2mkd_tpu_torch.models.spvcnn import SPVCNN
from u2mkd_tpu_torch.models.tsd import TSDFull
from u2mkd_tpu_torch.train import distill

from test_torch_model import _random_variables

# f32 sums in another order (XLA against PyTorch: convolutions, scatters,
# softmax) through ~60 layers of two branches: a few ulps of the largest
# logit, well inside 1e-4 of it
LOGIT_RTOL = 1e-4
S_CAPS = (256, 128, 64, 32, 16)
T_CAPS = (256, 128, 64, 32, 16)
NCLS = 5
WS = 0.3 * 6
GEOMETRY = dict(window_size=(WS,) * 3, quant_size=(WS / 24,) * 3,
                window_size_sphere=(2.0, 2.0, 120.0), quant_size_sphere=(2.0 / 24, 2.0 / 24, 5.0),
                window_size_scale=(2.0, 2.0), head_dim=4)


def _raw():
    return jax_synthetic.make_multimodal_batch(np.random.RandomState(3), 1, 512, 640,
                                               voxel_size=0.3, num_cams=2, im_hw=(32, 48))


def _jax_plumbing(part, caps, wgeom_params=None):
    pl = jax_plumbing_host.batch_plumbing(part["pcoords"], part["xyz"], part["pmask"], caps,
                                          wgeom_params=wgeom_params)
    if wgeom_params is None:  # no TPU conv tiling: the convs take the XLA gather path
        pl = {k: v for k, v in pl.items() if not k.startswith("cr27")}
    return jax.tree_util.tree_map(jnp.asarray, pl)


def _jax_setup(pallas):
    """The JAX model, its random variables and the JAX batch (with host
    plumbing: the Pallas path takes the host window geometry)."""
    raw = _raw()
    model = JaxTSDFull(num_classes=NCLS, cr=0.25, cr_t=0.5, pallas_attention=pallas,
                       pallas_cubic=pallas, **GEOMETRY)
    wp = (lambda m: jax_wgeom_host.params_from_model(m)) if pallas else (lambda m: None)
    batch = {part: {k: jnp.asarray(v) for k, v in raw[part].items()}
             for part in ("student", "teacher")}
    batch["student"]["plumbing"] = _jax_plumbing(raw["student"], S_CAPS,
                                                 wp(model.make_student()))
    batch["teacher"]["plumbing"] = _jax_plumbing(raw["teacher"], T_CAPS,
                                                 wp(model.make_teacher()))

    def init(sb, tb):
        spl = jax_from_precomputed(sb["plumbing"], sb["pmask"])
        tpl = jax_from_precomputed(tb["plumbing"], tb["pmask"])
        return model.init(jax.random.PRNGKey(0), sb, spl, tb, tpl, False, True)

    variables = _random_variables(jax.eval_shape(init, batch["student"], batch["teacher"]), 11)
    return raw, model, variables, batch


@pytest.fixture(scope="module")
def xla_setup():
    return _jax_setup(pallas=False)


def _port(variables):
    port = TSDFull(num_classes=NCLS, cr=0.25, cr_t=0.5, pallas_attention=True, **GEOMETRY).eval()
    port.load_state_dict(convert_weights.from_flax(variables["params"],
                                                   variables["batch_stats"]))
    return port


def test_weight_bridge_covers_every_leaf(xla_setup):
    """Every leaf of the flax ``TSDFull`` tree lands on a port parameter or
    buffer of the same shape (strict loading), every port parameter and
    buffer is covered, the image convs are transposed from HWIO, and the
    teacher's subtree alone still loads into the port's SPVCNN."""
    _, _, variables, _ = xla_setup
    sd = convert_weights.from_flax(variables["params"], variables["batch_stats"])
    port = TSDFull(num_classes=NCLS, cr=0.25, cr_t=0.5, pallas_attention=True, **GEOMETRY)
    want = port.state_dict()
    assert sorted(sd) == sorted(want)
    for k, t in sd.items():
        assert tuple(t.shape) == tuple(want[k].shape), k
    port.load_state_dict(sd)
    n_leaves = sum(1 for _ in jax.tree_util.tree_leaves(variables))
    assert len(sd) == n_leaves
    stem = variables["params"]["model_s"]["pix_branch"]["conv1"]["kernel"]   # [7, 7, 3, 64]
    np.testing.assert_array_equal(sd["model_s.pix_branch.conv1.weight"].numpy(),
                                  stem.transpose(3, 2, 0, 1))
    fuse = variables["params"]["model_s"]["l2c2"]["fuse_conv"]
    np.testing.assert_array_equal(sd["model_s.l2c2.fuse_conv.bias"].numpy(), fuse["bias"])
    teacher = SPVCNN(cr=0.5, return_point_feats=True, num_classes=NCLS, pallas_attention=True,
                     **GEOMETRY)
    teacher.load_state_dict(convert_weights.from_flax(variables["params"]["model_t"],
                                                      variables["batch_stats"]["model_t"]))


@pytest.mark.parametrize("cr,head_dim", [(0.25, 4), (1.0, 16)])
def test_geometry_params_follow_the_student(cr, head_dim):
    """``wgeom_host.params_from_model`` gives the student's (and the
    teacher's) attention heads per level, and the window sizes of its
    SphereFormer blocks, doubling per level."""
    geom = dict(GEOMETRY, head_dim=head_dim)
    port = TSDFull(num_classes=NCLS, cr=cr, cr_t=2 * cr, pallas_attention=True, **geom)
    for model in (port.model_s, port.model_t):
        blocks = [getattr(model, f"sphereformer{i}").attn for i in range(1, 5)]
        heads = [(a.num_heads // 2, a.num_heads - a.num_heads // 2, head_dim) for a in blocks]
        assert wgeom_host.heads_for_levels(model.cr, model.head_dim) == heads
        levels = wgeom_host.params_from_model(model)["levels"]
        assert [lv["ws"][0] for lv in levels] == [WS * 2 ** i for i in range(4)]
        assert [lv["wss"][:2] for lv in levels] == [(2.0 * 2 ** i,) * 2 for i in range(4)]
        assert [a.g_cub for a in blocks] == [24] * 4


def _check_student(out, ref, raw):
    sb = raw["student"]
    valid = sb["pmask"]
    fov = valid & sb["fov_mask"]
    assert fov.sum() > 50, "too few points in the cameras' view"
    for key, rows in (("logits", valid), ("logits_pix", valid)):
        want = np.asarray(ref[key])[rows]
        scale = np.abs(want).max()
        assert scale > 1e-2, "degenerate logits make the comparison vacuous"
        np.testing.assert_allclose(out[key].numpy()[rows], want, rtol=0,
                                   atol=LOGIT_RTOL * scale, err_msg=key)
    assert (out["logits_pix"].numpy()[valid & ~sb["fov_mask"]] == 0).all()
    np.testing.assert_array_equal(out["pred_vox"].numpy()[valid],
                                  np.asarray(ref["pred_vox"])[valid])
    np.testing.assert_array_equal(out["pred_pix"].numpy()[fov], np.asarray(ref["pred_pix"])[fov])
    for name in ("counts_vox", "counts_pix"):
        for k in ("seen", "correct", "positive"):
            np.testing.assert_array_equal(out[name][k].numpy(), np.asarray(ref[name][k]),
                                          err_msg=f"{name}.{k}")


def _parity(setup):
    """JAX ``make_distill_eval_step`` against the port's, with run_teacher
    True and False. The port builds its own host plumbing."""
    raw, model, variables, batch = setup
    st = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"], opt_state=())
    ref = {rt: jax.jit(jax_distill.make_distill_eval_step(model, S_CAPS, T_CAPS, NCLS,
                                                          run_teacher=rt))(st, batch)
           for rt in (True, False)}

    port = _port(variables)
    s_arrays = plumbing_host.batch_plumbing(
        raw["student"]["pcoords"], raw["student"]["xyz"], raw["student"]["pmask"], S_CAPS,
        wgeom_params=wgeom_host.params_from_model(port.model_s))
    t_arrays = plumbing_host.batch_plumbing(
        raw["teacher"]["pcoords"], raw["teacher"]["xyz"], raw["teacher"]["pmask"], T_CAPS,
        wgeom_params=wgeom_host.params_from_model(port.model_t))
    if not model.pallas_attention:  # the banded JAX attention is exact at these occupancies
        for arrays in (s_arrays, t_arrays):
            assert max(int(g["occ"].max()) for g in arrays["wgeom"]["sphere"]) <= 4 * 128
            assert max(int(g["occ"].max()) for g in arrays["wgeom"]["cubic"]) <= 128
    pbatch = {"student": dict(raw["student"], plumbing=s_arrays),
              "teacher": dict(raw["teacher"], plumbing=t_arrays)}

    out = distill.make_distill_eval_step(port, S_CAPS, T_CAPS, NCLS, run_teacher=True)(pbatch)
    _check_student(out, ref[True], raw)
    for k in ("seen", "correct", "positive"):
        np.testing.assert_array_equal(out["counts_teacher"][k].numpy(),
                                      np.asarray(ref[True]["counts_teacher"][k]))
    assert out["counts_teacher"]["seen"].sum() > 0

    out = distill.make_distill_eval_step(port, S_CAPS, T_CAPS, NCLS)(
        {"student": pbatch["student"]})
    assert "counts_teacher" not in out
    _check_student(out, ref[False], raw)
    return raw, model, variables, batch, port, s_arrays


def test_student_eval_step_matches_jax(xla_setup):
    """The slice as a whole against the JAX package's XLA paths, and the
    camera-free path (which skips the SphereFormer blocks)."""
    raw, model, variables, batch, port, s_arrays = _parity(xla_setup)
    ref = jax.jit(lambda v, s: model.apply(
        v, s, jax_from_precomputed(s["plumbing"], s["pmask"]), False,
        method=JaxTSDFull.lidar_only))(variables, batch["student"])["x_vox"]
    pl = from_precomputed(s_arrays, raw["student"]["pmask"], "cpu", port.model_s.point_levels)
    with torch.no_grad():
        out = port.lidar_only({"feats": torch.from_numpy(raw["student"]["feats"])}, pl)["x_vox"]
    valid = raw["student"]["pmask"]
    want = np.asarray(ref)[valid]
    np.testing.assert_allclose(out.numpy()[valid], want, rtol=0,
                               atol=LOGIT_RTOL * np.abs(want).max())


@pytest.mark.slow
def test_student_eval_step_matches_jax_pallas():
    """The Pallas twin: the JAX package's rulebook conv and flash attention
    in interpret mode, on the host geometry."""
    _parity(_jax_setup(pallas=True))
