"""The bf16 compute policy: the port against the JAX package, on the CPU.

The same seeded numpy inputs and the same (bridged) random weights go
through both packages with ``set_compute_dtype("bfloat16")`` on each side:
the teacher (``SPVCNN(sphereformer=True)``, P=512, cr=0.25, head dim 4) on
the K3 route (the JAX package's flash attention in interpret mode, on host
geometry) and on the banded route, the SwiftNet image branch, and the loss
terms of the stage-2 distillation train step. The JAX side's sparse convs
take its XLA gather path. Outputs stay f32 on both sides.

Two criteria per output, each reading printed with ``-s``:

(1) The port's bf16 output against JAX's. Both round the same inputs and
products to bf16 and sum in f32, but in another order (XLA's against
ATen's and oneDNN's), so a value that lands near a bf16 rounding boundary
rounds one ulp (2^-8) apart, and the next layer carries it on; and JAX
rounds the image decoder's sums and resizes to bf16 where the port keeps
the rounded conv outputs in f32. Measured on these inputs, the largest
difference: teacher logits 0.0118 (flash) and 0.0104 (banded) of the mean
|logit|, held to ``LOGIT_RTOL`` = 2e-2 of it; image features up to 0.0117
of their largest entry, held to ``IMAGE_RTOL`` = 2e-2 of it; the distill
loss terms up to 3.4e-3 relative, held to ``TERMS_RTOL`` = 1e-2.

(2) Each package's bf16 output against its own f32 output by the JAX
package's criterion (``tests/test_precision.py``): mean |bf16 - f32| over
mean |f32| below ``BF16_F32_RTOL`` = 0.1 (measured 1.4e-3 to 8.7e-3).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2mkd_tpu.data import plumbing_host as jax_plumbing_host
from u2mkd_tpu.data import synthetic as jax_synthetic
from u2mkd_tpu.data import wgeom_host as jax_wgeom_host
from u2mkd_tpu.models import swiftnet as jax_swiftnet
from u2mkd_tpu.models.plumbing import from_precomputed as jax_from_precomputed
from u2mkd_tpu.ops import precision as jax_precision
from u2mkd_tpu.train import builder as jax_builder
from u2mkd_tpu.train import distill as jax_distill
from u2mkd_tpu.train import optim as jax_optim
from u2mkd_tpu.train import state as jax_state
from u2mkd_tpu.utils import config as jax_config

from test_torch_config_builder import REPO
from test_torch_distill import (GRAD_SPREADS, LR, TERMS, _batches, _capturing,
                                _JaxTSDNoDropout, _port, _port_batch)
from test_torch_model import CAPS, _jax_teacher, _random_variables
from test_torch_student_eval import GEOMETRY, NCLS, S_CAPS, T_CAPS
from u2mkd_tpu_torch.data import plumbing_host, wgeom_host
from u2mkd_tpu_torch.models import convert_weights, swiftnet
from u2mkd_tpu_torch.models.spvcnn import teacher_model
from u2mkd_tpu_torch.ops import precision, wattn
from u2mkd_tpu_torch.train import builder, distill, state
from u2mkd_tpu_torch.utils import config

LOGIT_RTOL = 2e-2
IMAGE_RTOL = 2e-2
TERMS_RTOL = 1e-2
BF16_F32_RTOL = 0.1


@pytest.fixture(autouse=True)
def f32_guard():
    """Both packages back at f32 after each test, as JAX's ``f32_guard``."""
    yield
    jax_precision.set_compute_dtype("float32")
    precision.set_compute_dtype("float32")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _policy(name):
    jax_precision.set_compute_dtype(name)
    precision.set_compute_dtype(name)


def _rel_mean(got, want):
    """mean |got - want| over mean |want| (JAX's bf16 criterion)."""
    return float(np.abs(got - want).mean() / np.abs(want).mean())


def _held(what, outs, scale, rtol):
    """``outs``: {(package, dtype): output}. The port's bf16 output within
    ``rtol`` times ``scale(JAX's bf16 output)`` of JAX's at every entry;
    each package's bf16 output within BF16_F32_RTOL of its f32 (mean over
    mean), and the port's moved by the policy."""
    port_jax = float(np.abs(outs["port", "bf16"] - outs["jax", "bf16"]).max()
                     / scale(outs["jax", "bf16"]))
    own = {p: _rel_mean(outs[p, "bf16"], outs[p, "f32"]) for p in ("jax", "port")}
    print(f"{what}: port bf16 against JAX bf16 {port_jax:.3g} (tolerance {rtol}); "
          f"bf16 against f32: JAX {own['jax']:.3g}, port {own['port']:.3g}")
    assert all(o.dtype == np.float32 for o in outs.values())
    assert port_jax <= rtol, (what, port_jax)
    for p, err in own.items():
        assert err < BF16_F32_RTOL, (what, p, err)
    assert own["port"] > 0, "the port's bf16 output is its f32 output: no cast took effect"


@pytest.mark.parametrize("route", ["flash", "banded"])
def test_teacher_bf16_matches_jax(route):
    """The teacher's eval step in bf16: K1's plain version and K3's (flash)
    or the banded attention against the JAX package's interpret-mode flash
    attention or its banded XLA attention; the logits on the valid points."""
    pallas = route == "flash"
    raw = jax_synthetic.make_batch(np.random.RandomState(3), 1, 512, voxel_size=0.3)
    model = _jax_teacher(pallas_attention=pallas, pallas_cubic=pallas)
    pl = jax_plumbing_host.batch_plumbing(
        raw["pcoords"], raw["xyz"], raw["pmask"], CAPS,
        wgeom_params=jax_wgeom_host.params_from_model(model) if pallas else None)
    pl_j = jax.tree_util.tree_map(jnp.asarray, {k: v for k, v in pl.items()
                                                if not k.startswith("cr27")})
    pmask_j = jnp.asarray(raw["pmask"])
    abstract = jax.eval_shape(
        lambda f, a: model.init(jax.random.PRNGKey(0), f, jax_from_precomputed(a, pmask_j),
                                False), raw["feats"], pl_j)
    variables = _random_variables(abstract, 7)
    st = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"], opt_state=())
    batch_j = dict({k: jnp.asarray(v) for k, v in raw.items()}, plumbing=pl_j)

    port = teacher_model(num_classes=5, cr=0.25, voxel_size=0.3, head_dim=4, device="cpu",
                         pallas_attention=pallas, pallas_cubic=pallas)
    port.load_state_dict(convert_weights.from_flax(variables["params"],
                                                   variables["batch_stats"]))
    arrays = plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"], CAPS,
                                          wgeom_params=wgeom_host.params_from_model(port))
    valid = raw["pmask"]
    outs = {}
    for dtype in ("f32", "bf16"):
        _policy({"f32": "float32", "bf16": "bfloat16"}[dtype])
        # a new function per policy: the JAX package reads it while tracing
        ref = jax.jit(jax_state.make_eval_step(model, CAPS, 5))(st, batch_j)
        outs["jax", dtype] = np.asarray(ref["logits"])[valid]
        got = state.make_eval_step(port, CAPS, 5)(dict(raw, plumbing=arrays))
        outs["port", dtype] = got["logits"].numpy()[valid]
    _held(f"teacher logits, {route}", outs, lambda x: np.abs(x).mean(), LOGIT_RTOL)


def test_image_branch_bf16_matches_jax(rng):
    """SwiftNet-18 (eval, 32x48) through its staged API in bf16: the four
    downsampled features and the decoder's output."""
    x = rng.randn(1, 32, 48, 3).astype(np.float32)
    ref_mod = jax_swiftnet.SwiftNetResNet()
    abstract = jax.eval_shape(lambda: ref_mod.init(jax.random.PRNGKey(0), x, False))
    variables = _random_variables(abstract, 3)
    port = swiftnet.SwiftNetResNet()
    port.load_state_dict(convert_weights.from_flax(variables["params"],
                                                   variables["batch_stats"]))
    port.eval()
    outs = {}
    for dtype in ("f32", "bf16"):
        _policy({"f32": "float32", "bf16": "bfloat16"}[dtype])
        feats = ref_mod.apply(variables, x, False,
                              method=jax_swiftnet.SwiftNetResNet.forward_down)
        up = ref_mod.apply(variables, feats, False,
                           method=jax_swiftnet.SwiftNetResNet.forward_up)
        outs["jax", dtype] = [np.asarray(f, np.float32) for f in (*feats, up)]
        with torch.no_grad():
            pf = port.forward_down(torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))))
            pu = port.forward_up(pf)
        outs["port", dtype] = [t.permute(0, 2, 3, 1).numpy() for t in (*pf, pu)]
    for i, name in enumerate(("stage1", "stage2", "stage3", "spp", "decoder")):
        _held(f"image branch {name}", {k: v[i] for k, v in outs.items()},
              lambda x: np.abs(x).max(), IMAGE_RTOL)


def test_distill_step_bf16_loss_terms_match_jax():
    """One stage-2 train step in bf16 (the banded route, the cr_t=0.5
    teacher, 2 cameras at 32x48): its loss and five terms against the JAX
    step's, to TERMS_RTOL relative; each package's bf16 terms within
    BF16_F32_RTOL of the f32 terms; the terms f32. The JAX package traces
    this step in ~30 s, so it runs it in bf16 only: the port's f32 step
    stands for JAX's f32 step, which ``test_torch_distill.py`` holds to it
    at 1e-5 on the same scan and weights."""
    model = _JaxTSDNoDropout(num_classes=NCLS, cr=0.25, cr_t=0.5, drop_path_rate=0.0,
                             pallas_attention=False, pallas_cubic=False, **GEOMETRY)
    (bj, raw), _ = _batches(model, False)

    def init(sb, tb):
        spl = jax_from_precomputed(sb["plumbing"], sb["pmask"])
        tpl = jax_from_precomputed(tb["plumbing"], tb["pmask"])
        return model.init(jax.random.PRNGKey(0), sb, spl, tb, tpl, False, True)

    variables = _random_variables(jax.eval_shape(init, bj["student"], bj["teacher"]), 13)
    tx = _capturing(jax_distill.make_frozen_teacher_optimizer(
        jax_optim.make_optimizer("sgd_spformer", LR)))
    st = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]))
    terms = {}
    for dtype in ("f32", "bf16"):
        _policy({"f32": "float32", "bf16": "bfloat16"}[dtype])
        port = _port(variables, dropout_rate=0.0, drop_path_rate=0.0)
        opt, _ = distill.make_frozen_teacher_optimizer(port, "sgd_spformer", LR)
        aux = distill.make_distill_train_step(port, opt, S_CAPS, T_CAPS)(
            _port_batch(raw, port))
        assert all(aux[k].dtype == torch.float32 for k in TERMS)
        terms[dtype] = {k: aux[k].item() for k in TERMS}
    step_j = jax.jit(jax_distill.make_distill_train_step(model, tx, S_CAPS, T_CAPS))
    _, aux = step_j(st, bj, jax.random.PRNGKey(1))
    terms["jax"] = {k: float(aux[k]) for k in TERMS}

    def rel(a, b):
        return {k: abs(terms[a][k] - terms[b][k]) / abs(terms[b][k]) for k in TERMS}

    port_jax, own = rel("bf16", "jax"), {"jax": rel("jax", "f32"), "port": rel("bf16", "f32")}
    print(f"distill terms: port bf16 against JAX bf16 {port_jax}; bf16 against f32 {own}")
    assert max(port_jax.values()) <= TERMS_RTOL, port_jax
    for p, errs in own.items():
        assert max(errs.values()) < BF16_F32_RTOL, (p, errs)
    assert max(own["port"].values()) > 0


def test_table_gradients_reach_f32_parameters_through_the_rounding(rng):
    """A bf16 SphereFormer block on the K3 route (its plain version here):
    the relative-position tables, K3's projections rounded to bf16 and
    handed on as f32, take f32 gradients, finite and within BF16_F32_RTOL
    (mean over mean) of the f32 run's; q, k and v in bf16 reach the qkv
    projection's f32 weight likewise."""
    from u2mkd_tpu_torch.models.plumbing import _window_geom_from_arrays
    from u2mkd_tpu_torch.models.sphereformer import SphereFormerBlock

    b, v, d, heads = 1, 300, 4, 4
    ws, qs = (3.0,) * 3, (3.0 / 8,) * 3
    wss, qss = (40.0, 40.0, 120.0), (5.0, 5.0, 5.0)
    xyz = rng.uniform(-10, 10, (b, v, 3)).astype(np.float32)
    mask = rng.rand(b, v) < 0.9
    feats = torch.from_numpy(rng.randn(b, v, heads * d).astype(np.float32))
    geom = {}
    for branch, coords, w_, q_ in (("cubic", xyz, ws, qs),
                                   ("sphere", wgeom_host.cart2sphere(xyz), wss, qss)):
        g = wgeom_host.branch_geometry(coords, mask, w_, q_, 128, branch == "sphere")
        geom[branch] = _window_geom_from_arrays(g, "cpu")
    block = SphereFormerBlock(heads * d, heads, ws, wss, qs, qss, pallas_attention=True,
                              generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in block.named_parameters():
            if "rel_" in name:
                p.copy_(0.3 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    grads = {}
    for dtype in ("float32", "bfloat16"):
        precision.set_compute_dtype(dtype)
        block.zero_grad()
        block(feats, None, torch.from_numpy(mask), geom).square().sum().backward()
        grads[dtype] = {n: p.grad.clone() for n, p in block.named_parameters()
                        if "rel_q" in n or "rel_k" in n or "qkv" in n}
    for n, g in grads["bfloat16"].items():
        ref = grads["float32"][n]
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all()), n
        err = float((g - ref).abs().mean() / ref.abs().mean())
        assert 0 < err < BF16_F32_RTOL, (n, err)


def test_compute_projections_round_to_the_compute_dtype(rng):
    """``wattn.compute_projections``: under bf16 the projection of the
    bf16-rounded inputs, rounded to bf16 and held in f32; under f32 the
    f32 projection itself."""
    x = torch.from_numpy(rng.randn(64, 2, 4).astype(np.float32))
    table = torch.from_numpy(rng.randn(47, 3, 2, 4).astype(np.float32))
    f32 = wattn.compute_projections(x, table)
    assert torch.equal(f32, wattn.table_projections(x, table))
    precision.set_compute_dtype("bfloat16")
    got = wattn.compute_projections(x, table)
    want = wattn.table_projections(x.bfloat16(), table.bfloat16()).bfloat16().float()
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert not torch.equal(got, f32)


def test_set_compute_dtype_as_jax():
    """The names both packages take, the dtypes they set, a dtype object
    taken as it is, any other name a KeyError in both, and ``cast_compute``
    leaving a tensor already in the compute dtype as it is."""
    for name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        _policy(name)
        assert precision.compute_dtype() == dt
        assert jax_precision.compute_dtype() == jnp.dtype(name)
    precision.set_compute_dtype(torch.bfloat16)
    assert precision.compute_dtype() == torch.bfloat16
    t = torch.ones(3, dtype=torch.bfloat16)
    assert precision.cast_compute(t) is t
    for bad in ("float16", "bf16", "fp32"):
        with pytest.raises(KeyError):
            precision.set_compute_dtype(bad)
        with pytest.raises(KeyError):
            jax_precision.set_compute_dtype(bad)


def test_float32_build_after_bfloat16_build_runs_f32():
    """The port's builder sets the dtype in both directions: a float32
    build after a bfloat16 one in the same process computes in f32. The JAX
    builder sets it only away from float32, so there the f32 build stays
    bf16 (a reference quirk, ROADMAP section 3), pinned here."""
    path = f"{REPO}/configs/synthetic/train/spformer_tiny.yaml"
    for prec, want in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        cfg = config.update_dotted(config.load(path), [f"precision={prec}"])
        builder.make_model(cfg, "cpu")
        assert precision.compute_dtype() == want
    for prec in ("bfloat16", "float32"):
        cfg_j = jax_config.update_dotted(jax_config.load(path), [f"precision={prec}"])
        jax_builder.make_model(cfg_j)
    assert jax_precision.compute_dtype() == jnp.bfloat16


def test_unet_bf16_request_and_step_match_jax():
    """The SphereFormer U-Net (the size of ``tests/test_torch_sphereformer_unet.py``,
    drop path 0) in bf16, against JAX's bf16 on the same weights and scan.
    The U-Net stacks ~40 layers, so a value that rounds one bf16 ulp apart
    moves a few logits further than in the teacher: its largest logit
    difference (0.024-0.031 of the mean |logit| over three weight seeds)
    passes LOGIT_RTOL, but stays under what bf16 rounding itself moves
    JAX's logits from its f32 ones (0.031-0.060). So the logits are held
    by JAX's bf16 criterion at LOGIT_RTOL (mean |port - JAX| over mean
    |JAX|; measured 1.3e-3 to 1.7e-3) and, entry by entry, within JAX's own
    bf16-against-f32 difference; one ``sgd_spformer`` train step's loss to
    TERMS_RTOL relative, and each parameter's gradient within GRAD_SPREADS
    times what bf16 rounding moves JAX's own gradient of it from its f32
    one, in L2 (floored at GRAD_FLOOR of the largest entry of all, per
    entry; measured at most 1.12 times that move, the median 0.13); each
    package's bf16 within BF16_F32_RTOL of its f32 (mean over mean)."""
    from test_torch_sphereformer_unet import CAPS as UNET_CAPS
    from test_torch_sphereformer_unet import NUM_CLASSES as UNET_CLASSES
    from test_torch_sphereformer_unet import _batch, _models, _variables
    from test_torch_train import GRAD_FLOOR
    from u2mkd_tpu.ops import losses as jax_losses
    from u2mkd_tpu_torch.train import optim

    model, port = _models()
    batch_j, batch = _batch(3, port)
    variables = _variables(model, batch_j)
    st = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"], opt_state=())
    start = convert_weights.from_flax(variables["params"], variables["batch_stats"])
    valid = batch["pmask"]

    def loss_fn(params, batch):
        out, _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                             batch["feats"], jax_state.get_plumbing(batch, UNET_CAPS), True,
                             rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        ok = batch["pmask"] & batch["keyframe_mask"] & (batch["labels"] != 0)
        return jax_losses.lovasz_ce(out["x_vox"].reshape(-1, UNET_CLASSES),
                                    batch["labels"].reshape(-1), ok.reshape(-1))

    outs, loss, grads = {}, {}, {}
    for dtype in ("f32", "bf16"):
        _policy({"f32": "float32", "bf16": "bfloat16"}[dtype])
        ref = jax.jit(jax_state.make_eval_step(model, UNET_CAPS, UNET_CLASSES))(st, batch_j)
        outs["jax", dtype] = np.asarray(ref["logits"])[valid]
        port.load_state_dict(start)
        got = state.make_eval_step(port, UNET_CAPS, UNET_CLASSES)(batch)
        outs["port", dtype] = got["logits"].numpy()[valid]
        loss["jax", dtype], g = jax.jit(jax.value_and_grad(loss_fn))(st.params, batch_j)
        grads["jax", dtype] = {n: t.numpy() for n, t in convert_weights.from_flax(
            jax.tree_util.tree_map(np.asarray, g), {}).items()}
        opt, _ = optim.make_optimizer(port.named_parameters(), "sgd_spformer", LR)
        aux = state.make_train_step(port, opt, UNET_CAPS)(batch)
        assert aux["loss"].dtype == torch.float32
        loss["port", dtype] = aux["loss"].item()
        grads["port", dtype] = {n: p.grad.numpy().copy() for n, p in port.named_parameters()}

    scale = np.abs(outs["jax", "bf16"]).mean()
    port_jax_mean = _rel_mean(outs["port", "bf16"], outs["jax", "bf16"])
    port_jax = np.abs(outs["port", "bf16"] - outs["jax", "bf16"])
    jax_own = np.abs(outs["jax", "bf16"] - outs["jax", "f32"])
    own = {p: _rel_mean(outs[p, "bf16"], outs[p, "f32"]) for p in ("jax", "port")}
    loss = {k: float(v) for k, v in loss.items()}
    loss_err = abs(loss["port", "bf16"] - loss["jax", "bf16"]) / abs(loss["jax", "bf16"])
    loss_own = {p: abs(loss[p, "bf16"] - loss[p, "f32"]) / abs(loss[p, "f32"])
                for p in ("jax", "port")}
    gj, gp, gj32 = grads["jax", "bf16"], grads["port", "bf16"], grads["jax", "f32"]
    assert sorted(gj) == sorted(gp)
    floor = GRAD_FLOOR * max(float(np.abs(t).max()) for t in gj.values())
    grad_ratio = {n: float(np.linalg.norm(gp[n] - t)) / max(
        float(np.linalg.norm(t - gj32[n])), floor * np.sqrt(t.size)) for n, t in gj.items()}
    worst = max(grad_ratio, key=grad_ratio.get)
    print(f"U-Net bf16: logits port against JAX {port_jax_mean:.3g} mean over mean "
          f"(tolerance {LOGIT_RTOL}), largest {port_jax.max() / scale:.3g} against JAX's own "
          f"bf16 - f32 {jax_own.max() / scale:.3g} of the mean |logit|; bf16 against f32 "
          f"{own}; loss {loss_err:.3g} (tolerance {TERMS_RTOL}), bf16 against f32 "
          f"{loss_own}; gradients at most {grad_ratio[worst]:.3g} times JAX's own bf16 move "
          f"({worst}; tolerance {GRAD_SPREADS})")
    assert all(o.dtype == np.float32 for o in outs.values())
    assert port_jax_mean <= LOGIT_RTOL, port_jax_mean
    assert port_jax.max() <= jax_own.max(), (port_jax.max(), jax_own.max())
    assert all(err < BF16_F32_RTOL for err in own.values()) and own["port"] > 0, own
    assert loss_err <= TERMS_RTOL, loss_err
    assert all(err < BF16_F32_RTOL for err in loss_own.values()), loss_own
    assert grad_ratio[worst] <= GRAD_SPREADS, (worst, grad_ratio[worst])


def _teacher_step(gen_seed=8):
    """A narrow teacher (P=512, cr=0.25, head dim 4, K3 route) from one
    seed, its ``sgd_spformer`` step with a generator from ``gen_seed``, and
    one scan with its host plumbing."""
    from u2mkd_tpu_torch.data import synthetic
    from u2mkd_tpu_torch.train import optim

    model = teacher_model(num_classes=5, cr=0.25, voxel_size=0.3, head_dim=4, seed=3,
                          device="cpu")
    raw = synthetic.make_batch(np.random.RandomState(3), 1, 512, voxel_size=0.3)
    raw["plumbing"] = plumbing_host.batch_plumbing(
        raw["pcoords"], raw["xyz"], raw["pmask"], CAPS,
        wgeom_params=wgeom_host.params_from_model(model))
    opt, _ = optim.make_optimizer(model.named_parameters(), "sgd_spformer", LR)
    step = state.make_train_step(model, opt, CAPS,
                                 generator=torch.Generator().manual_seed(gen_seed))
    return model, step, raw


def test_plain_launch_nudge_is_one_f32_ulp_and_off_changes_nothing():
    """``chip_smoke.plain_launches``, the reference and the nudge of the
    card's bf16 whole-step check, on the CPU (one thread, so that runs
    repeat bitwise). Each of the train step's six wrappers, on the f32
    arguments the step gives it: with a nudge seed each output that is not
    all zero moves by at most 2^-22 of its L2 norm (2^-23 N(0, 1) per entry,
    whose tail passes 2^-22 in some entries) and moves; with none the
    wrapper returns its
    plain output bitwise. Then a bf16 step: under ``plain_launches()``
    every loss, gradient and parameter equals the step's without it
    bitwise, every wrapper runs there, and a nudge changes the gradients."""
    import chip_smoke

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain = chip_smoke._plain_of_launch()
        args = {}

        def recording(name, mod, fn):
            def rec(*a):
                args.setdefault(name, [x.clone() if torch.is_tensor(x) else x for x in a])
                return fn(*a)
            return rec

        saved = {n: getattr(mod, n) for n, (mod, _) in plain.items()}
        for n, (mod, _) in plain.items():
            setattr(mod, n, recording(n, mod, saved[n]))
        try:
            _, step, raw = _teacher_step()
            step(raw)
        finally:
            for n, (mod, _) in plain.items():
                setattr(mod, n, saved[n])
        assert sorted(args) == sorted(n for n in plain if n != "flash_window_sorted")
        for name, a in args.items():
            mod = plain[name][0]
            want = getattr(mod, name)(*a)
            want = (want,) if torch.is_tensor(want) else want
            for seed in (None, 7):
                with chip_smoke.plain_launches(seed):
                    got = getattr(mod, name)(*a)
                got = (got,) if torch.is_tensor(got) else got
                assert len(got) == len(want), name
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype == torch.float32, name
                    if seed is None or not w.any():  # a zero output stays zero
                        assert torch.equal(g, w), name
                    else:
                        moved = float((g - w).norm() / w.norm())
                        assert 0 < moved <= 2.0 ** -22, (name, moved)

        precision.set_compute_dtype("bfloat16")
        runs = {}
        for tag, ctx in (("step", None), ("off", None), ("nudged", 7)):
            model, step, raw = _teacher_step()
            stats = {}
            with (chip_smoke.plain_launches(ctx, stats) if tag != "step"
                  else contextlib.nullcontext()):
                aux = step(raw)
            runs[tag] = ({k: v.clone() for k, v in aux.items()},
                         {n: p.grad.clone() for n, p in model.named_parameters()},
                         {k: v.clone() for k, v in model.state_dict().items()}, stats)
        (aux, grads, sd, _), (aux_off, grads_off, sd_off, _) = runs["step"], runs["off"]
        assert all(torch.equal(aux[k], aux_off[k]) for k in aux)
        assert all(torch.equal(grads[n], grads_off[n]) for n in grads)
        assert all(torch.equal(sd[k], sd_off[k]) for k in sd)
        nudged, stats = runs["nudged"][1], runs["nudged"][3]
        assert sorted(stats) == sorted(args)
        assert all(r["entries"] > 0 for r in stats.values())
        assert any(not torch.equal(grads[n], nudged[n]) for n in grads)
    finally:
        torch.set_num_threads(threads)


def test_building_models_leaves_the_tf32_flags():
    """No module of the port sets torch's TF32 flags (``ops/precision.py``):
    building the teacher and the stage-2 student (and the conv-only SPVCNN)
    through ``train/builder.make_model``, and the SphereFormer U-Net, which
    no builder name reaches, leaves ``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` as the process had them:
    torch's defaults, and both the other way."""
    from test_torch_sphereformer_unet import GEOMETRY as UNET_GEOMETRY
    from test_torch_sphereformer_unet import N_PLANES, NUM_CLASSES
    from u2mkd_tpu_torch.models.sphereformer_unet import SphereFormerSemantic

    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
    had = tuple(f.allow_tf32 for f in flags)
    teacher = f"{REPO}/configs/synthetic/train/spformer_tiny.yaml"
    cfgs = [config.load(teacher), config.load(f"{REPO}/configs/synthetic/train/tsd_tiny.yaml"),
            config.update_dotted(config.load(teacher), ["model.name=spvcnn"])]
    try:
        for state in ((True, False), (False, True)):
            for f, on in zip(flags, state):
                f.allow_tf32 = on
            for cfg in cfgs:
                builder.make_model(cfg, "cpu")
                assert tuple(f.allow_tf32 for f in flags) == state, cfg.model.name
            SphereFormerSemantic(num_classes=NUM_CLASSES, n_planes=N_PLANES, head_dim=4,
                                 **UNET_GEOMETRY)
            assert tuple(f.allow_tf32 for f in flags) == state
        assert precision.numerics_line() == (
            "numerics: precision=float32 cudnn.allow_tf32=False cuda.matmul.allow_tf32=True")
    finally:
        for f, on in zip(flags, had):
            f.allow_tf32 = on
