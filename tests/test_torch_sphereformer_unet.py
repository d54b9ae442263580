"""The port's SphereFormer U-Net against the JAX package's, on the CPU.

Synthetic scans (P=512) at the size of ``tests/test_sphereformer_unet.py``:
``n_planes`` (8, 16, 32, 32, 32), head dim 4, capacities (256, 128, 64, 32,
16), 6-voxel windows quantized in 24 steps and sphere windows of 2 x 2 deg
x 120 m, doubling per level. Both packages take the same host plumbing
(``from_precomputed``) and the same bridged random weights (``from_flax``);
f32 on both sides. The JAX U-Net runs its banded XLA attention, exact while
every window fits its band (cubic 128 keys, sphere 512), which the tests
assert; the port runs K3's plain version over host geometry of levels 0..4
built on the recursive voxel xyz.

Compared: the recursive xyz (host twin and device port against JAX), the
window keys and in-window quantization built on them (exactly); the eval
step's logits, argmax and IoU counts in both block types; one train step's
loss, gradients and the state after two steps (the rule of
``tests/test_torch_train.py``); and the two places where the JAX U-Net
departs from the reference: (a) the banded attention drops the pairs of a
radial window of more than 512 voxels, where the port's is exact, and (b)
``sgd_spformer`` leaves the U-Net's ``transformer_block`` at the full LR in
both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2mkd_tpu.data import plumbing_host as jax_plumbing_host
from u2mkd_tpu.data import synthetic as jax_synthetic
from u2mkd_tpu.data import wgeom_host as jax_wgeom_host
from u2mkd_tpu.models import plumbing as jax_plumbing
from u2mkd_tpu.models import sphereformer as jax_sphereformer
from u2mkd_tpu.models.sphereformer_unet import SphereFormerSemantic as JaxUNet
from u2mkd_tpu.ops import losses as jax_losses
from u2mkd_tpu.ops import wattn as jax_wattn
from u2mkd_tpu.train import optim as jax_optim
from u2mkd_tpu.train import state as jax_state

from test_torch_model import _random_variables
from test_torch_train import GRAD_FLOOR, GRAD_RTOL, LOSS_RTOL, UPDATE_RTOL, _compare
from test_wattn import np_window_attention
from u2mkd_tpu_torch.data import plumbing_host, wgeom_host
from u2mkd_tpu_torch.models import convert_weights
from u2mkd_tpu_torch.models import plumbing as P
from u2mkd_tpu_torch.models.plumbing import _window_geom_from_arrays
from u2mkd_tpu_torch.models.sphereformer import SphereAttention
from u2mkd_tpu_torch.models.sphereformer_unet import SphereFormerSemantic
from u2mkd_tpu_torch.models.spvcnn import teacher_model
from u2mkd_tpu_torch.models.tsd import tsd_model
from u2mkd_tpu_torch.ops import hashing, wattn
from u2mkd_tpu_torch.train import optim, overflow, state

CAPS = (256, 128, 64, 32, 16)
N_PLANES = (8, 16, 32, 32, 32)
NUM_CLASSES = 5
VOXEL = 0.3
LR = 0.02
# f32 sums in another order through ~40 layers: a few ulps of the largest
# logit, well inside 1e-4 of it
LOGIT_RTOL = 1e-4
WS = VOXEL * 6
GEOMETRY = dict(window_size=(WS,) * 3, quant_size=(WS / 24,) * 3,
                window_size_sphere=(2.0, 2.0, 120.0),
                quant_size_sphere=(2.0 / 24, 2.0 / 24, 5.0), window_size_scale=(2.0, 2.0))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """At most two CPU threads per test process: the tier-1 run shares the
    machine's cores among several workers, and more threads each only
    contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _models(block_type="residual", drop_path_rate=0.0):
    kw = dict(num_classes=NUM_CLASSES, n_planes=N_PLANES, head_dim=4,
              drop_path_rate=drop_path_rate, block_type=block_type, **GEOMETRY)
    return JaxUNet(**kw), SphereFormerSemantic(**kw).eval()


def _batch(seed, port):
    """One synthetic scan: the JAX batch (the port's host plumbing without
    the window geometry, which the JAX U-Net builds in the program) and the
    port's batch (with its geometry)."""
    raw = jax_synthetic.make_batch(np.random.RandomState(seed), 1, 512, voxel_size=VOXEL,
                                   num_sweep_factor=2)
    arrays = plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"], CAPS,
                                          wgeom_params=wgeom_host.params_from_model(port))
    assert len(arrays["wgeom"]["cubic"]) == len(CAPS)
    # the banded JAX attention is exact at these occupancies
    assert max(int(g["occ"].max()) for g in arrays["wgeom"]["cubic"]) <= 128
    assert max(int(g["occ"].max()) for g in arrays["wgeom"]["sphere"]) <= 4 * 128
    batch_j = {k: jnp.asarray(v) for k, v in raw.items()}
    batch_j["plumbing"] = {k: [jnp.asarray(x) for x in v] for k, v in arrays.items()
                           if k != "wgeom"}
    return batch_j, dict(raw, plumbing=arrays)


def _variables(model, batch_j, seed=7):
    abstract = jax.eval_shape(
        lambda f, a: model.init(jax.random.PRNGKey(0), f,
                                jax_plumbing.from_precomputed(a, batch_j["pmask"]), False),
        batch_j["feats"], batch_j["plumbing"])
    return _random_variables(abstract, seed)


def test_recursive_vox_xyz_matches_jax():
    """The recursive mean-of-means xyz: the host twin and the device port
    against JAX ``recursive_vox_xyz`` on the same plumbing (two samples), to
    1e-6; and the window keys and in-window quantization of both branches
    at every level, exactly, on the twin's xyz (which the host geometry
    takes) against the JAX xyz."""
    raw = jax_synthetic.make_batch(np.random.RandomState(2), 2, 700, voxel_size=0.25)
    caps = (512, 256, 128, 64, 32)
    arrays = plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"], caps)
    pl_j = jax_plumbing.from_precomputed(
        {k: [jnp.asarray(x) for x in v] for k, v in arrays.items()}, jnp.asarray(raw["pmask"]))
    ref = [np.asarray(x) for x in jax.jit(jax_plumbing.recursive_vox_xyz)(pl_j)]
    twin = plumbing_host.recursive_vox_xyz(arrays["voxxyz"][0], arrays["down8"],
                                           arrays["vmask"])
    pl = P.from_precomputed(arrays, raw["pmask"], "cpu")
    dev = P.recursive_vox_xyz(torch.from_numpy(arrays["voxxyz"][0]), pl.levels)
    assert len(ref) == len(twin) == len(dev) == len(caps)
    for li in range(len(caps)):
        np.testing.assert_allclose(twin[li], ref[li], rtol=0, atol=1e-6, err_msg=f"twin l{li}")
        np.testing.assert_allclose(dev[li].numpy(), ref[li], rtol=0, atol=1e-6,
                                   err_msg=f"device l{li}")
    # beyond level 1 the recursive means are not the flat ones
    live = arrays["vmask"][2].astype(bool)
    assert not np.allclose(twin[2][live], arrays["voxxyz"][2][live], atol=1e-4)

    params = wgeom_host.level_window_params(
        GEOMETRY["window_size"], GEOMETRY["window_size_sphere"], GEOMETRY["quant_size"],
        GEOMETRY["quant_size_sphere"], GEOMETRY["window_size_scale"], n_levels=len(caps))
    for li, p in enumerate(params):
        for bi in range(2):
            valid = arrays["vmask"][li][bi].astype(bool)
            mine, theirs = twin[li][bi], ref[li][bi]
            for branch, ws, qs in (("cubic", p["ws"], p["qs"]), ("sphere", p["wss"], p["qss"])):
                if branch == "sphere":  # the host geometry's cart2sphere on both
                    mine, theirs = wgeom_host.cart2sphere(mine), wgeom_host.cart2sphere(theirs)
                key = wattn.window_keys(torch.from_numpy(mine), torch.from_numpy(valid), ws)
                hi_j, lo_j = jax_wattn.window_keys(jnp.asarray(theirs), jnp.asarray(valid), ws,
                                                    False)
                hi, lo = hashing.unpack_key(key)
                np.testing.assert_array_equal(hi.numpy(), np.asarray(hi_j).astype(np.int64))
                np.testing.assert_array_equal(lo.numpy(), np.asarray(lo_j).astype(np.int64))
                q_mine = jax_wattn.quantize_in_window(jnp.asarray(mine), jnp.asarray(valid),
                                                      ws, qs, False)
                q_ref = jax_wattn.quantize_in_window(jnp.asarray(theirs), jnp.asarray(valid),
                                                     ws, qs, False)
                np.testing.assert_array_equal(np.asarray(q_mine)[valid],
                                              np.asarray(q_ref)[valid])


def test_geometry_spec_covers_every_level():
    """The U-Net's geometry spec: levels 0..4 over the recursive xyz, heads
    ``n_planes[i] // head_dim`` split h // 2 and h - h // 2, windows from the
    model's own doubling per level; the plumbing's geometry starts at level
    0, so that block i reads level i's, and the capacity counters name each
    occupancy by its level."""
    _, port = _models()
    spec = wgeom_host.params_from_model(port)
    assert spec["first_level"] == 0 and spec["recursive_xyz"]
    assert wgeom_host.unet_heads(N_PLANES, 4) == [(1, 1, 4), (2, 2, 4), (4, 4, 4),
                                                  (4, 4, 4), (4, 4, 4)]
    assert [lv["ws"][0] for lv in spec["levels"]] == [WS * 2 ** i for i in range(5)]
    assert [lv["wss"] for lv in spec["levels"]] == [(2.0 * 2 ** i, 2.0 * 2 ** i, 120.0)
                                                    for i in range(5)]
    _, batch = _batch(3, port)
    pl = P.from_precomputed(batch["plumbing"], batch["pmask"], "cpu")
    assert pl.wgeom_first == 0
    for li in range(len(CAPS)):
        geom = P.level_geom(pl, li)
        assert geom["cubic"].order.shape[0] == -(-CAPS[li] // 128) * 128
    stats = overflow.stats_for_model(port, pl)
    occ = batch["plumbing"]["wgeom"]
    for li in range(len(CAPS)):
        assert int(stats[f"overflow/occ_cubic_l{li}"]) == int(occ["cubic"][li]["occ"][0])
        assert int(stats[f"overflow/occ_sphere_l{li}"]) == int(occ["sphere"][li]["occ"][0])


def test_spvcnn_and_tsd_geometry_bitwise_unchanged():
    """The geometry of a SPVCNN encoder (the teacher, and both of
    ``TSDFull``'s models) keeps its levels 1..4 over the flat voxel means:
    bitwise the JAX package's host geometry for the same models, read by
    level from level 1 on."""
    raw = jax_synthetic.make_batch(np.random.RandomState(6), 2, 600, voxel_size=0.25)
    tsd = tsd_model(num_classes=5, cr=0.25, cr_t=0.5, voxel_size=0.25, head_dim=4,
                    device="cpu")
    models = (teacher_model(num_classes=5, cr=0.25, voxel_size=0.25, head_dim=4,
                            device="cpu"), tsd.model_s, tsd.model_t)
    for model in models:
        spec = wgeom_host.params_from_model(model)
        assert "first_level" not in spec and "recursive_xyz" not in spec
        out = plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"], CAPS,
                                           wgeom_params=spec)
        ref = jax_plumbing_host.batch_plumbing(
            raw["pcoords"], raw["xyz"], raw["pmask"], CAPS,
            wgeom_params=jax_wgeom_host.params_from_model(model))
        for branch in ("cubic", "sphere"):
            assert len(out["wgeom"][branch]) == len(ref["wgeom"][branch]) == 4
            for g, gr in zip(out["wgeom"][branch], ref["wgeom"][branch]):
                assert sorted(g) == sorted(gr)
                for k in gr:  # the JAX arrays carry a leading shard axis of 1
                    np.testing.assert_array_equal(g[k], gr[k][0], err_msg=f"{branch}.{k}")
        pl = P.from_precomputed(out, raw["pmask"], "cpu")
        assert pl.wgeom_first == 1 and tuple(pl.window_occ.shape) == (2, 4)
        assert P.level_geom(pl, 1)["sphere"] is pl.wgeom["sphere"][0]
        with pytest.raises(ValueError):
            P.level_geom(pl, 0)
        assert sorted(k for k in overflow.stats_for_model(model, pl) if "occ_" in k) == sorted(
            f"overflow/occ_{b}_l{li}" for b in ("cubic", "sphere") for li in range(1, 5))


def test_state_dict_bridge_covers_every_leaf():
    """``from_flax`` carries the U-Net's tree (nested ``u`` scopes, five
    ``transformer_block``s) onto the port's parameters and buffers, every
    one of them, shapes equal."""
    model, port = _models()
    batch_j, _ = _batch(3, port)
    variables = _variables(model, batch_j)
    sd = convert_weights.from_flax(variables["params"], variables["batch_stats"])
    want = port.state_dict()
    assert sorted(sd) == sorted(want)
    for k, t in sd.items():
        assert tuple(t.shape) == tuple(want[k].shape), k
    assert sum("transformer_block.attn.qkv.weight" in k for k in sd) == 5
    assert "unet.u.u.u.u.transformer_block.attn.rel_q_sphere" in sd


@pytest.mark.parametrize("block_type", ["residual", "vgg"])
def test_eval_step_matches_jax(block_type):
    """JAX ``make_eval_step`` against the port's on one scan with the same
    weights: logits to 1e-4 of the largest, argmax and IoU counts equal."""
    model, port = _models(block_type)
    batch_j, batch = _batch(3, port)
    variables = _variables(model, batch_j)
    st = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"], opt_state=())
    ref = jax.jit(jax_state.make_eval_step(model, CAPS, NUM_CLASSES))(st, batch_j)
    port.load_state_dict(convert_weights.from_flax(variables["params"],
                                                   variables["batch_stats"]))
    out = state.make_eval_step(port, CAPS, NUM_CLASSES)(batch)

    logits_ref, logits = np.asarray(ref["logits"]), out["logits"].numpy()
    valid = batch["pmask"]
    scale = np.abs(logits_ref[valid]).max()
    assert scale > 1e-2, "degenerate logits make the comparison vacuous"
    np.testing.assert_allclose(logits[valid], logits_ref[valid], rtol=0,
                               atol=LOGIT_RTOL * scale)
    np.testing.assert_array_equal(out["pred"].numpy()[valid], np.asarray(ref["pred"])[valid])
    for key in ("seen", "correct", "positive"):
        np.testing.assert_array_equal(out["counts"][key].numpy(),
                                      np.asarray(ref["counts"][key]))


def test_train_step_matches_jax():
    """Two ``sgd_spformer`` train steps at lr 0.02, drop path 0 on both
    sides (the frameworks draw other random bits): the loss to 1e-5, every
    gradient of the first step and every parameter and BN statistic after
    two, by the rule of ``tests/test_torch_train.py``."""
    model, port = _models()
    batches = [_batch(seed, port) for seed in (3, 4)]
    batch_j = batches[0][0]
    variables = _variables(model, batch_j)
    tx = jax_optim.make_optimizer("sgd_spformer", LR)
    st = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]))

    def loss_fn(params, bstats, batch):
        out, _ = model.apply({"params": params, "batch_stats": bstats}, batch["feats"],
                             jax_state.get_plumbing(batch, CAPS), True,
                             rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        logits = out["x_vox"]
        valid = batch["pmask"] & batch["keyframe_mask"] & (batch["labels"] != 0)
        return jax_losses.lovasz_ce(logits.reshape(-1, NUM_CLASSES),
                                    batch["labels"].reshape(-1), valid.reshape(-1))

    loss_ref, grads_ref = jax.jit(jax.value_and_grad(loss_fn))(st.params, st.batch_stats,
                                                               batch_j)
    step_j = jax.jit(jax_state.make_train_step(model, tx, CAPS))
    start = convert_weights.from_flax(variables["params"], variables["batch_stats"])
    port.load_state_dict(start)
    opt, _ = optim.make_optimizer(port.named_parameters(), "sgd_spformer", LR)
    step_fn = state.make_train_step(port, opt, CAPS)

    for i, (bj, bp) in enumerate(batches):
        st, aux = step_j(st, bj, jax.random.PRNGKey(1))
        loss = step_fn(bp)["loss"]
        np.testing.assert_allclose(loss.item(), float(aux["loss"]), rtol=LOSS_RTOL)
        if i == 0:
            np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=LOSS_RTOL)
            ref = convert_weights.from_flax(jax.tree_util.tree_map(np.asarray, grads_ref), {})
            named = dict(port.named_parameters())
            assert sorted(ref) == sorted(named)
            floor = GRAD_FLOOR * max(float(t.abs().max()) for t in ref.values())
            for name, g in ref.items():
                assert named[name].grad is not None, name
                _compare(f"grad {name}", named[name].grad, g, GRAD_RTOL, floor)

    ref = convert_weights.from_flax(jax.tree_util.tree_map(np.asarray, st.params),
                                    jax.tree_util.tree_map(np.asarray, st.batch_stats))
    got = port.state_dict()
    assert sorted(ref) == sorted(got)
    for name, t in ref.items():
        p0, p_ref, p_got = start[name].numpy(), t.numpy(), got[name].numpy()
        atol = (UPDATE_RTOL * np.abs(p_ref - p0).max()
                + 2 * np.spacing(np.abs(p_ref).max().astype(np.float32)))
        np.testing.assert_allclose(p_got, p_ref, rtol=0, atol=atol, err_msg=name)


def test_unet_transformer_block_takes_the_full_lr_in_both_packages():
    """Deviation (b): the reference's ``sgd_spformer`` scales the LR of
    parameters named ``transformer_block`` by 0.1; both packages mask names
    holding ``sphereformer`` instead, so the U-Net's attention takes the
    full LR in both. One SGD update of unit gradients, no decay and no
    momentum history, moves every parameter by the LR in JAX, and the port
    puts every parameter in one group at the LR."""
    model, port = _models()
    batch_j, _ = _batch(3, port)
    params = _variables(model, batch_j)["params"]
    tx = jax_optim.make_optimizer("sgd_spformer", LR, weight_decay=0.0)
    grads = jax.tree_util.tree_map(jnp.ones_like, params)
    updates, _ = tx.update(grads, tx.init(params), params)
    steps = convert_weights.from_flax(jax.tree_util.tree_map(np.asarray, updates), {})
    tf = [k for k in steps if "transformer_block" in k]
    assert len(tf) == sum("transformer_block" in n for n, _ in port.named_parameters()) > 0
    for k, u in steps.items():  # nesterov: the first update is (1 + 0.9) x lr
        np.testing.assert_allclose(u.numpy(), -LR * 1.9, rtol=1e-6, err_msg=k)
    opt, _ = optim.make_optimizer(port.named_parameters(), "sgd_spformer", LR)
    assert [g["lr"] for g in opt.param_groups] == [LR]
    assert len(opt.param_groups[0]["params"]) == len(list(port.parameters()))


def test_radial_window_beyond_band_is_exact_in_the_port():
    """Deviation (a): the JAX U-Net's attention (``SphereAttention`` as
    ``UBlock`` builds it: the banded XLA path, sphere band 4 x 128 rows)
    drops the pairs of a radial window that lie more than 512 sorted rows
    apart. On 700 voxels in one radial window the JAX output differs from
    the exact one, while the port's (K3's plain version over host geometry)
    equals a dense numpy oracle on the same weights."""
    rng = np.random.RandomState(5)
    v, heads, d = 700, 2, 4
    dim = heads * d
    ws, qs = (2.0,) * 3, (2.0 / 8,) * 3
    wss, qss = (360.0, 180.0, 1000.0), (360.0 / 8, 180.0 / 8, 5.0)
    xyz = rng.uniform(-20, 20, (1, v, 3)).astype(np.float32)
    mask = np.ones((1, v), bool)
    feats = rng.randn(1, v, dim).astype(np.float32)
    ref_mod = jax_sphereformer.SphereAttention(
        dim=dim, num_heads=heads, window_size=ws, window_size_sphere=wss, quant_size=qs,
        quant_size_sphere=qss)
    params = _random_variables(jax.eval_shape(
        lambda: ref_mod.init(jax.random.PRNGKey(0), feats, xyz, mask)), 4)["params"]
    banded = np.asarray(ref_mod.apply({"params": params}, feats, xyz, mask))[0]

    geom = {}
    for branch, coords, w_, q_ in (("cubic", xyz, ws, qs),
                                   ("sphere", wgeom_host.cart2sphere(xyz), wss, qss)):
        g = wgeom_host.branch_geometry(coords, mask, w_, q_, 128, branch == "sphere")
        geom[branch] = _window_geom_from_arrays(g, "cpu")
        if branch == "sphere":
            assert g["occ"][0] == v > 4 * 128
    port = SphereAttention(dim, heads, ws, wss, qs, qss, pallas_attention=True)
    port.load_state_dict(convert_weights.from_flax(params, {}))
    with torch.no_grad():
        got = port(torch.from_numpy(feats), None, torch.from_numpy(mask), geom).numpy()[0]

    # the oracle: the same projections, exact attention per window and branch
    p = {k: np.asarray(x, np.float64) for k, x in params.items() if k.startswith("rel_")}
    qkv = (feats[0].astype(np.float64) @ np.asarray(params["qkv"]["kernel"], np.float64)
           + np.asarray(params["qkv"]["bias"], np.float64)).reshape(v, 3, heads, d)
    q, k, vv = qkv[:, 0] * d ** -0.5, qkv[:, 1], qkv[:, 2]
    sph = wgeom_host.cart2sphere(xyz[0])
    valid = mask[0]
    outs = []
    for sl, coords, w_, q_, tabs, extra in (
            (slice(0, 1), xyz[0], ws, qs, "cubic", {}),
            (slice(1, 2), sph, wss, qss, "sphere", dict(r=sph[:, 2], a=0.0125))):
        quant = np.asarray(jax_wattn.quantize_in_window(jnp.asarray(coords), jnp.asarray(valid),
                                                        w_, q_, False))
        g = int((w_[0] + 1e-4) / q_[0])
        outs.append(np_window_attention(
            q[:, sl], k[:, sl], vv[:, sl], coords, valid, w_, quant=quant,
            tables=tuple(p[f"rel_{n}_{tabs}"] for n in "qkv"), grid_len=g, **extra))
    oracle = (np.concatenate(outs, axis=1).reshape(v, dim)
              @ np.asarray(params["proj"]["kernel"], np.float64)
              + np.asarray(params["proj"]["bias"], np.float64))
    scale = np.abs(oracle).max()
    np.testing.assert_allclose(got, oracle, rtol=0, atol=1e-5 * scale)
    assert np.abs(banded - oracle).max() > 1e-2 * scale
