"""The port's importers of reference torch checkpoints against the JAX
package's, on the CPU.

The reference-schema teacher dict is ``tests/test_convert_teacher.py``'s,
built from the reference's architecture formulas, independent of either
package's key tables; the ResNet-18 dict is ``tests/test_convert_weights.py``'s
completed to torchvision's 122-entry file; the full SwiftNet dict is built
here from the reference's ``swiftnet.py`` layer formulas. Each import must
equal the JAX package's import bridged by ``from_flax``, bitwise.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2mkd_tpu.data import plumbing_host as jax_plumbing_host
from u2mkd_tpu.data import synthetic as jax_synthetic
from u2mkd_tpu.models import convert_weights as jax_cw
from u2mkd_tpu.models.plumbing import from_precomputed as jax_from_precomputed
from u2mkd_tpu.models.spvcnn import SPVCNN as JaxSPVCNN
from u2mkd_tpu.train import state as jax_state

from u2mkd_tpu_torch.data import plumbing_host, wgeom_host
from u2mkd_tpu_torch.models import convert_weights
from u2mkd_tpu_torch.models.spvcnn import SPVCNN, teacher_model
from u2mkd_tpu_torch.models.swiftnet import SwiftNetResNet
from u2mkd_tpu_torch.models.tsd import TSDFull
from u2mkd_tpu_torch.train import checkpoints, state

import test_convert_teacher as tc
from test_convert_weights import make_fake_resnet18_sd
from test_torch_model import CAPS, LOGIT_RTOL, _jax_teacher, _random_variables

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

SPHERE = dict(window_size_sphere=(30.0, 30.0, 120.0),
              quant_size_sphere=(30.0 / tc.G_SPH, 30.0 / tc.G_SPH, 5.0))


def _port_teacher():
    """The port's SPVCNN of ``tc._toy_model``'s geometry."""
    return SPVCNN(num_classes=tc.NCLS, cr=tc.CR, head_dim=tc.HEAD_DIM, pallas_attention=True,
                  window_size=(tc.WS,) * 3, quant_size=(tc.WS / tc.G_CUB,) * 3, **SPHERE)


@pytest.fixture(scope="module")
def jax_target():
    """Shapes of the flax teacher's variables (what the JAX import checks
    against), filled with random values."""
    model = tc._toy_model()
    raw = jax_synthetic.make_batch(np.random.RandomState(0), 1, 256, voxel_size=0.3)
    pl = jax_plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"], tc.CAPS)
    pl = {k: v for k, v in pl.items() if not k.startswith("cr27")}
    abstract = jax.eval_shape(
        lambda f, a: model.init(jax.random.PRNGKey(0), f,
                                jax_from_precomputed(a, jnp.asarray(raw["pmask"])), False),
        raw["feats"], pl)
    return _random_variables(abstract, 0)


def _bridged(variables):
    return convert_weights.from_flax(variables["params"], variables["batch_stats"])


def _equal(sd, ref):
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        assert torch.equal(sd[k], v), k


def test_kernel_perm_matches_jax():
    """The offset permutations (27 and 8 offsets) are the JAX package's."""
    for ks in (2, 3):
        np.testing.assert_array_equal(convert_weights._ts_offsets(ks), jax_cw._ts_offsets(ks))
        np.testing.assert_array_equal(convert_weights._ts_kernel_perm(ks),
                                      jax_cw._ts_kernel_perm(ks))


def test_teacher_import_equals_jax(jax_target, tmp_path):
    """A reference trainer's file ({'model': module.*}) imported into the
    port's SPVCNN equals the JAX import bridged by ``from_flax``, bitwise."""
    sd = tc.make_reference_state_dict()
    path = str(tmp_path / "max-iou-val-vox.pt")
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, path)
    want = _bridged(jax_cw.load_teacher_pt(path, jax_target))
    port = _port_teacher()
    info = convert_weights.load_teacher_pt(path, port)
    _equal(port.state_dict(), want)
    assert info["leftover"] == [] and info["loaded"] == sorted(want)


def test_teacher_import_into_tsd_scope(jax_target, tmp_path):
    """``scope='model_t'`` fills the TSD wrapper's teacher and leaves the
    student as it was, through ``checkpoints.load_teacher_any`` too; with
    ``sub_prefix='model_t.'`` the teacher comes out of a stage-2 dict. Both
    equal the JAX import into the same scope, bitwise."""
    sd = tc.make_reference_state_dict()
    plain, staged = str(tmp_path / "teacher.pt"), str(tmp_path / "stage2.pt")
    torch.save({"model": sd}, plain)
    stage2 = {f"model_t.{k}": v for k, v in sd.items()}
    stage2["model_s.classifier_vox.0.weight"] = torch.zeros(3, 3)
    torch.save(stage2, staged)
    scoped = {col: {"model_t": jax_target[col], "model_s": {}} for col in jax_target}
    want = _bridged(jax_cw.load_teacher_pt(plain, scoped, scope="model_t"))
    want_t = {k[len("model_t."):]: v for k, v in want.items()}
    want_staged = _bridged(jax_cw.load_teacher_pt(staged, scoped, scope="model_t",
                                                  sub_prefix="model_t."))
    _equal(want_staged, want)

    tsd = TSDFull(num_classes=tc.NCLS, cr=0.25, cr_t=tc.CR, head_dim=tc.HEAD_DIM,
                  pallas_attention=True,
                  window_size=(tc.WS,) * 3, quant_size=(tc.WS / tc.G_CUB,) * 3, **SPHERE)
    student = {k: v.clone() for k, v in tsd.model_s.state_dict().items()}
    checkpoints.load_teacher_any(plain, tsd)
    _equal(tsd.model_t.state_dict(), want_t)
    _equal(tsd.model_s.state_dict(), student)
    fresh = TSDFull(num_classes=tc.NCLS, cr=0.25, cr_t=tc.CR, head_dim=tc.HEAD_DIM,
                    pallas_attention=True,
                    window_size=(tc.WS,) * 3, quant_size=(tc.WS / tc.G_CUB,) * 3, **SPHERE)
    convert_weights.load_teacher_pt(staged, fresh, scope="model_t", sub_prefix="model_t.")
    _equal(fresh.model_t.state_dict(), want_t)


def _missing_key(sd):
    del sd["transformer_blocks.2.attn.relative_pos_key_table_sphere"]
    return sd


def _wrong_ncls(sd):
    sd["classifier_vox.0.weight"] = torch.zeros(tc.NCLS + 1, tc.CS[8])
    return sd


@pytest.mark.parametrize("corrupt,match", [
    (_missing_key, "expected keys absent"),
    (_wrong_ncls, "shape mismatch"),
    (lambda sd: {"conv1.weight": torch.zeros(64, 3, 7, 7)}, "expected keys absent"),
], ids=["missing_key", "shape_mismatch", "wrong_schema"])
def test_teacher_import_errors_as_jax(jax_target, tmp_path, corrupt, match):
    """A missing key, a tensor of another shape and another model's file
    raise as in the JAX package, and leave the port's model untouched."""
    path = str(tmp_path / "bad.pt")
    torch.save(corrupt(tc.make_reference_state_dict()), path)
    with pytest.raises(ValueError, match=match):
        jax_cw.load_teacher_pt(path, jax_target)
    port = _port_teacher()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with pytest.raises(ValueError, match=match):
        convert_weights.load_teacher_pt(path, port)
    _equal(port.state_dict(), before)


def _tame(sd):
    """The reference dict at the scales of a trained model, so that an
    eval-mode forward on its running statistics stays finite: kernels and
    linear weights over the square root of their fan-in, RPE tables at
    0.02, BN scales near 1, biases and means at 0.1; keys and shapes as
    they are."""
    out = {}
    for k, v in sd.items():
        if k.endswith("num_batches_tracked") or k.endswith("running_var"):
            out[k] = v
        elif k.endswith(".kernel"):
            out[k] = v / np.sqrt(np.prod(v.shape[:-1]))
        elif "relative_pos" in k:
            out[k] = 0.02 * v
        elif k.endswith(".weight") and v.ndim == 2:
            out[k] = v / np.sqrt(v.shape[1])
        elif k.endswith(".weight"):
            out[k] = 1.0 + 0.1 * (v - 1.0)
        else:
            out[k] = 0.1 * v
    return out


def test_imported_teacher_logits_match_jax(monkeypatch, tmp_path):
    """The eval step on an imported reference teacher (windows of 24
    quantization steps, the geometry of ``test_torch_model``'s teacher):
    the port's logits within 1e-4 of the JAX step's largest, on the same
    scan, with each package's own import of the same file."""
    monkeypatch.setattr(tc, "G_CUB", 24)
    monkeypatch.setattr(tc, "G_SPH", 24)
    path = str(tmp_path / "teacher.pt")
    torch.save(_tame(tc.make_reference_state_dict(seed=5)), path)

    raw = jax_synthetic.make_batch(np.random.RandomState(3), 1, 512, voxel_size=0.3)
    model = _jax_teacher()
    pl = jax_plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"], CAPS)
    pl = {k: v for k, v in pl.items() if not k.startswith("cr27")}
    pl_j = jax.tree_util.tree_map(jnp.asarray, pl)
    abstract = jax.eval_shape(
        lambda f, a: model.init(jax.random.PRNGKey(0), f,
                                jax_from_precomputed(a, jnp.asarray(raw["pmask"])), False),
        raw["feats"], pl_j)
    variables = jax_cw.load_teacher_pt(path, _random_variables(abstract, 1))
    st = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"], opt_state=())
    batch_j = {k: jnp.asarray(v) for k, v in raw.items()}
    batch_j["plumbing"] = pl_j
    ref = np.asarray(jax.jit(jax_state.make_eval_step(model, CAPS, tc.NCLS))(st, batch_j)["logits"])

    port = teacher_model(num_classes=tc.NCLS, cr=tc.CR, voxel_size=0.3, head_dim=tc.HEAD_DIM,
                         device="cpu")
    convert_weights.load_teacher_pt(path, port)
    arrays = plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"], CAPS,
                                          wgeom_params=wgeom_host.params_from_model(port))
    # the banded JAX attention is exact at these occupancies
    assert max(int(g["occ"].max()) for g in arrays["wgeom"]["sphere"]) <= 4 * 128
    assert max(int(g["occ"].max()) for g in arrays["wgeom"]["cubic"]) <= 128
    logits = state.make_eval_step(port, CAPS, tc.NCLS)(dict(raw, plumbing=arrays))["logits"]
    valid = raw["pmask"]
    scale = np.abs(ref[valid]).max()
    assert np.isfinite(ref[valid]).all() and scale > 1e-2
    np.testing.assert_allclose(logits.numpy()[valid], ref[valid], rtol=0,
                               atol=LOGIT_RTOL * scale)


def torchvision_resnet18_sd(rng):
    """The 122 entries of torchvision's ``resnet18-5c106cde.pth``: the
    backbone, the ``fc`` head and a ``num_batches_tracked`` per BN."""
    sd = make_fake_resnet18_sd(rng)
    sd["fc.weight"] = torch.tensor(rng.randn(1000, 512).astype(np.float32))
    sd["fc.bias"] = torch.tensor(rng.randn(1000).astype(np.float32))
    for k in [k for k in sd if k.endswith(".running_var")]:
        sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    assert len(sd) == 122
    return sd


def test_imagenet_import_equals_jax(tmp_path):
    """torchvision's ResNet-18 schema: 100 tensors land in the image branch,
    equal to the JAX import bridged by ``from_flax`` bitwise; the rest of
    the branch is left as it was; a file that matches nothing raises."""
    sd = torchvision_resnet18_sd(np.random.RandomState(0))
    path = str(tmp_path / "resnet18-5c106cde.pth")
    torch.save(sd, path)
    jax_out = jax_cw.load_imagenet_pretrain(
        path, {"params": {"pix_branch": {}}, "batch_stats": {}})
    want = convert_weights.from_flax(jax_out["params"]["pix_branch"],
                                     jax_out["batch_stats"]["pix_branch"])
    assert len(want) == 100

    model = torch.nn.Module()
    model.pix_branch = SwiftNetResNet(generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.pix_branch.state_dict().items()}
    assert convert_weights.load_imagenet_pretrain(path, model) == 100
    after = model.pix_branch.state_dict()
    for k, v in after.items():
        assert torch.equal(v, want[k] if k in want else before[k]), k

    junk = str(tmp_path / "junk.pth")
    torch.save({"encoder.w": torch.zeros(3)}, junk)
    for load in (lambda: jax_cw.load_imagenet_pretrain(junk, jax_out),
                 lambda: convert_weights.load_imagenet_pretrain(junk, model)):
        with pytest.raises(ValueError, match="no torchvision-resnet keys"):
            load()


def reference_swiftnet_sd(rng):
    """A reference ``SwiftNetResNet`` state dict from its layer formulas
    (``swiftnet.py:120-330``): the ResNet-18 backbone, the SPP
    (``spp.spp.*``: a 512->128 bottleneck, three 128->42 levels, a
    254->128 fuse) and three upsamplers (skips 256, 128, 64 -> 128,
    blended by a 3x3 conv), each ``_BNReluConv`` a BN then a conv."""
    sd = make_fake_resnet18_sd(rng)

    def brc(prefix, cin, cout, k):
        sd[f"{prefix}.norm.weight"] = torch.tensor(rng.rand(cin).astype(np.float32) + 0.5)
        sd[f"{prefix}.norm.bias"] = torch.tensor(rng.randn(cin).astype(np.float32) * 0.1)
        sd[f"{prefix}.norm.running_mean"] = torch.tensor(rng.randn(cin).astype(np.float32))
        sd[f"{prefix}.norm.running_var"] = torch.tensor(rng.rand(cin).astype(np.float32) + 0.5)
        sd[f"{prefix}.norm.num_batches_tracked"] = torch.tensor(3)
        sd[f"{prefix}.conv.weight"] = torch.tensor(
            rng.randn(cout, cin, k, k).astype(np.float32) * 0.05)

    brc("spp.spp.spp_bn", 512, 128, 1)
    for j in range(3):
        brc(f"spp.spp.spp{j}", 128, 42, 1)
    brc("spp.spp.spp_fuse", 128 + 3 * 42, 128, 1)
    for i, skip in enumerate((256, 128, 64)):
        brc(f"upsample.{i}.bottleneck", skip, 128, 1)
        brc(f"upsample.{i}.blend_conv", 128, 128, 3)
    return sd


def test_swiftnet_full_equals_jax():
    """A whole reference image branch converts to every tensor of the
    port's ``SwiftNetResNet`` (strict load), equal to the JAX conversion
    bridged by ``from_flax``, bitwise."""
    sd = {k: v.numpy() for k, v in reference_swiftnet_sd(np.random.RandomState(1)).items()}
    got = convert_weights.from_flax(*convert_weights.convert_swiftnet_full(sd))
    _equal(got, convert_weights.from_flax(*jax_cw.convert_swiftnet_full(sd)))
    net = SwiftNetResNet()
    net.load_state_dict(got)
    _equal(net.state_dict(), got)


def test_chip_smoke_reference_dicts_have_the_reference_schema():
    """The reference-schema files that ``chip_smoke.py`` writes on the card
    (no JAX there) have the keys, shapes and dtypes of this file's
    independent dicts: the teacher at the toy geometry, the ResNet-18 file
    whole."""
    def schema(sd):
        return {k: (tuple(v.shape), v.dtype) for k, v in sd.items()}

    got = chip_smoke.reference_teacher_state_dict(tc.CR, tc.NCLS, tc.IN_CH, tc.HEAD_DIM,
                                                  tc.G_CUB, tc.G_SPH)
    assert schema(got) == schema(tc.make_reference_state_dict())
    assert schema(chip_smoke.torchvision_resnet18_state_dict()) == schema(
        torchvision_resnet18_sd(np.random.RandomState(0)))
