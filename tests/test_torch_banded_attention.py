"""The port's banded window attention (``ops/wattn.sparse_window_attention``)
and the attention flags (``pallas_attention``, ``pallas_cubic``) against the
JAX package, on the CPU.

The banded attention is the JAX package's route for a branch whose flag is
off, left to XLA there and written in plain torch in the port: it must drop
the same pairs, so it is held to the JAX function where every window fits
its band and where one does not; there it must differ from the exact
attention, and the capacity counters must count the violation. f32: the
outputs to 1e-5 and the gradients to 1e-4 of their largest entry (sums in
another order).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2mkd_tpu.models import plumbing as jax_plumbing
from u2mkd_tpu.models import sphereformer as jax_sphereformer
from u2mkd_tpu.models.spvcnn import SPVCNN as JaxSPVCNN
from u2mkd_tpu.ops import wattn as jax_wattn
from u2mkd_tpu.train import overflow as jax_overflow

from u2mkd_tpu_torch.data import wgeom_host
from u2mkd_tpu_torch.models import convert_weights
from u2mkd_tpu_torch.models import plumbing as P
from u2mkd_tpu_torch.models import sphereformer
from u2mkd_tpu_torch.models.plumbing import _window_geom_from_arrays
from u2mkd_tpu_torch.ops import wattn
from u2mkd_tpu_torch.ops.kernels import wattn_kernel
from u2mkd_tpu_torch.train import builder, overflow
from u2mkd_tpu_torch.utils import config

from test_torch_config_builder import REPO, _synthetic
from test_torch_model import _random_variables

torch.set_num_threads(2)

OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4
CUBIC = ((6.0,) * 3, (0.75,) * 3)                 # window, quant: G = 8
SPHERE = ((40.0, 40.0, 120.0), (5.0, 5.0, 5.0))   # G = 8
SPHERE_WIDE = ((120.0, 90.0, 120.0), (15.0, 11.25, 5.0))  # G = 8, six windows


def _case(rng, v, radial, spread=10.0, sphere=SPHERE):
    xyz = rng.uniform(-spread, spread, (v, 3)).astype(np.float32)
    valid = rng.rand(v) < 0.9
    ws, qs = sphere if radial else CUBIC
    if radial:
        xyz = np.asarray(jax_wattn.cart2sphere(jnp.asarray(xyz)))
    return xyz, valid, ws, qs


def _both(rng, xyz, valid, ws, qs, radial, band, tile, h=2, d=4):
    """The JAX and the port's banded attention on the same inputs, with the
    gradients of sum(out * dout) for q, k, v and the three tables; also the
    port's exact attention (K3's plain version over windows sorted in the
    step). -> (jax out, jax grads, port out, port grads, exact out)."""
    v = xyz.shape[0]
    g = int((ws[0] + 1e-4) / qs[0])
    l2 = 2 * g if radial else 2 * g - 1
    q, k, vv = (rng.randn(v, h, d).astype(np.float32) for _ in range(3))
    tabs = [(0.1 * rng.randn(l2, 3, h, d)).astype(np.float32) for _ in range(3)]
    dout = rng.randn(v, h, d).astype(np.float32)
    quant = np.asarray(jax_wattn.quantize_in_window(jnp.asarray(xyz), jnp.asarray(valid), ws,
                                                    qs, False))
    np.testing.assert_array_equal(
        wattn.quantize_in_window(torch.from_numpy(xyz), torch.from_numpy(valid), ws, qs).numpy(),
        quant)
    r = xyz[:, 2] if radial else None

    def jf(q, k, vv, tq, tk, tv):
        rpe = jax_wattn.RPEParams(tq, tk, tv, jnp.asarray(quant), g,
                                  None if r is None else jnp.asarray(r), 0.0125)
        return jax_wattn.sparse_window_attention(q, k, vv, jnp.asarray(xyz), jnp.asarray(valid),
                                                 ws, False, rpe, band, tile)

    args = (q, k, vv, *tabs)
    ref = np.asarray(jf(*args))
    gref = jax.grad(lambda *a: jnp.sum(jf(*a) * dout), argnums=tuple(range(6)))(*args)
    ts = [torch.tensor(x, requires_grad=True) for x in args]
    rpe = wattn.RPEParams(*ts[3:], torch.from_numpy(quant), g,
                          None if r is None else torch.from_numpy(r), 0.0125)
    out = wattn.sparse_window_attention(*ts[:3], torch.from_numpy(xyz), torch.from_numpy(valid),
                                        ws, rpe, band=band, tile=tile)
    (out * torch.from_numpy(dout)).sum().backward()
    with torch.no_grad():
        exact = wattn_kernel.sparse_window_attention_flash_batched(
            *(t[None] for t in ts[:3]), torch.from_numpy(xyz)[None],
            torch.from_numpy(valid)[None], ws,
            rpe._replace(quant=rpe.quant[None], r=None if r is None else rpe.r[None]),
            plain=True)[0]
    return ref, [np.asarray(x) for x in gref], out.detach().numpy(), \
        [t.grad.numpy() for t in ts], exact.numpy()


def _close(got, want, rtol, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("radial,band", [(False, 1), (True, 4)], ids=["cubic", "sphere"])
def test_banded_matches_jax(rng, radial, band):
    """Both branches at the models' bands and tile (cubic band 1, the
    sphere's 4 with the radial exponential split), every window within its
    band: the output and the gradients of q, k, v and the three tables
    equal JAX's, and the output equals the exact attention's."""
    xyz, valid, ws, qs = _case(rng, 300, radial)
    ref, gref, out, grads, exact = _both(rng, xyz, valid, ws, qs, radial, band, 128)
    _close(out, ref, OUT_RTOL, "out")
    for name, g, gr in zip(("q", "k", "v", "tq", "tk", "tv"), grads, gref):
        _close(g, gr, GRAD_RTOL, f"grad {name}")
    _close(exact, ref, OUT_RTOL, "exact")
    assert np.abs(out[~valid]).max() == 0.0


def _beyond_band_scan():
    """One scan whose points fill a 4 m cube 20 m out: level-1 voxels of
    0.6 m, dozens in each cubic window of 3.6 m and each radial window."""
    rng = np.random.RandomState(8)
    p = 2048
    xyz = (rng.rand(1, p, 3) * 4.0 + [18.0, 0.0, -2.0]).astype(np.float32)
    pmask = np.ones((1, p), bool)
    return xyz / 0.3, xyz, pmask


def test_banded_beyond_band_drops_jax_pairs_and_counts(rng):
    """A small tile and band (16 rows, band 1) with windows of more than 16
    rows: the port's banded output equals JAX's (and so do the gradients),
    and both differ from the exact attention; on device-built plumbing of a
    scan with such windows the capacity counters of a banded model count
    the violation, equal to JAX ``stats_for_model`` with the same tile and
    bands."""
    for radial in (False, True):
        xyz, valid, ws, qs = _case(rng, 200, radial, spread=4.0, sphere=SPHERE_WIDE)
        ref, gref, out, grads, exact = _both(rng, xyz, valid, ws, qs, radial, 1, 16)
        _close(out, ref, OUT_RTOL, "out")
        for name, g, gr in zip(("q", "k", "v", "tq", "tk", "tv"), grads, gref):
            _close(g, gr, GRAD_RTOL, f"grad {name}")
        assert np.abs(exact - ref).max() > 100 * OUT_RTOL * np.abs(ref).max()

    pcoords, mxyz, pmask = _beyond_band_scan()
    caps = (2048, 1024, 512, 256, 128)
    ws = 1.8
    kw = dict(window_size=(ws,) * 3, window_size_sphere=(2.0, 2.0, 120.0),
              window_size_scale=(2.0, 2.0))
    jmodel = JaxSPVCNN(num_classes=5, cr=0.25, sphereformer=True, quant_size=(ws / 24,) * 3,
                       quant_size_sphere=(2.0 / 24, 2.0 / 24, 5.0), head_dim=4, **kw)
    jpl = jax.jit(lambda a, x, m: jax_plumbing.build_plumbing(a, x, m, caps))(
        pcoords, mxyz, pmask)
    ref = jax.device_get(jax_overflow.stats_for_model(jmodel, jpl, tile=16, band_cubic=1,
                                                      band_sphere=1))
    pl = P.build_plumbing(torch.from_numpy(pcoords), torch.from_numpy(mxyz),
                          torch.from_numpy(pmask), caps)
    stub = types.SimpleNamespace(sphereformer=True, pallas_attention=False, pallas_cubic=True,
                                 tile=16, band_cubic=1, band_sphere=1, **kw)
    got = overflow.stats_for_model(stub, pl)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        if k.startswith("overflow/vox_fill"):
            np.testing.assert_allclose(got[k].item(), v, rtol=0, atol=1e-7, err_msg=k)
        else:
            assert got[k].item() == int(v), k
    assert all(float(got[f"overflow/vox_fill_l{li}"]) < 1.0 for li in range(5))
    assert got["overflow/violations"].item() > 0 and got["overflow/occ_cubic_l1"] > 16
    with pytest.raises(RuntimeError, match="capacity overflow"):
        overflow.check_aux(got, strict=True)
    # kernel K3 is exact at any occupancy: the flash models count nothing
    for pa, pc, want in ((True, True, 0), (True, False, None)):
        flagged = types.SimpleNamespace(**dict(vars(stub), pallas_attention=pa, pallas_cubic=pc))
        n = overflow.stats_for_model(flagged, pl)["overflow/violations"].item()
        jn = int(jax.device_get(jax_overflow.stats_for_model(
            jmodel.clone(pallas_attention=pa, pallas_cubic=pc), jpl, tile=16, band_cubic=1,
            band_sphere=1))["overflow/violations"])
        assert n == jn and (want is None or n == want)


ROUTES = ("flash_pregeom_batched", "sparse_window_attention_flash_batched",
          "sparse_window_attention")


@pytest.mark.parametrize("pallas_attention,pallas_cubic",
                         [(False, False), (False, True), (True, False), (True, True)])
def test_sphere_attention_routes_as_jax(rng, monkeypatch, pallas_attention, pallas_cubic):
    """``SphereAttention``'s four flag combinations take JAX's routes: the
    cubic branch runs K3 iff both flags are on, the sphere branch iff
    ``pallas_attention`` is; K3 over the host geometry where it is given,
    else over windows sorted in the step; otherwise the banded attention,
    one call per sample. Where every window fits its band, each route's
    output equals the JAX module's banded output."""
    b, v, heads, d = 2, 300, 4, 4
    dim = heads * d
    ws, qs = CUBIC
    wss, qss = SPHERE
    xyz = rng.uniform(-10, 10, (b, v, 3)).astype(np.float32)
    mask = rng.rand(b, v) < 0.9
    feats = rng.randn(b, v, dim).astype(np.float32)
    ref_mod = jax_sphereformer.SphereAttention(
        dim=dim, num_heads=heads, window_size=ws, window_size_sphere=wss, quant_size=qs,
        quant_size_sphere=qss)
    params = _random_variables(jax.eval_shape(
        lambda: ref_mod.init(jax.random.PRNGKey(0), feats, xyz, mask)), 3)["params"]
    ref = np.asarray(ref_mod.apply({"params": params}, feats, xyz, mask))

    port = sphereformer.SphereAttention(dim, heads, ws, wss, qs, qss,
                                        pallas_attention=pallas_attention,
                                        pallas_cubic=pallas_cubic)
    port.load_state_dict(convert_weights.from_flax(params, {}))
    calls = []
    for name in ROUTES:
        mod = wattn if name == "sparse_window_attention" else sphereformer
        fn = getattr(mod, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    geom = {}
    for branch, coords, w_, q_ in (("cubic", xyz, ws, qs),
                                   ("sphere", wgeom_host.cart2sphere(xyz), wss, qss)):
        g = wgeom_host.branch_geometry(coords, mask, w_, q_, 128, branch == "sphere")
        geom[branch] = _window_geom_from_arrays(g, "cpu")
    banded = {"cubic": not (pallas_attention and pallas_cubic), "sphere": not pallas_attention}
    for with_geom in (False, True):
        calls.clear()
        with torch.no_grad():
            out = port(torch.from_numpy(feats), torch.from_numpy(xyz), torch.from_numpy(mask),
                       geom if with_geom else None).numpy()
        want = []
        for branch in ("cubic", "sphere"):
            if banded[branch]:
                want += ["sparse_window_attention"] * b
            else:
                want.append(ROUTES[0] if with_geom else ROUTES[1])
        assert calls == want, (with_geom, calls)
        _close(out, ref, 1e-4, f"geom={with_geom}")


def test_config_without_the_keys_builds_a_banded_model():
    """``make_model`` reads ``model.pallas_attention`` (default off) and
    ``model.pallas_cubic`` (default on) as the JAX builder does: a config
    that sets neither builds a banded model, which gets no host window
    geometry; ``spformer.yaml``'s ``pallas_attention: true`` a K3 model."""
    cases = ((_synthetic("spformer_tiny.yaml"), False, True),
             (_synthetic("spformer_tiny.yaml", "model.pallas_cubic=false"), False, False),
             (_synthetic("spformer_tiny.yaml", "model.pallas_attention=true"), True, True),
             (config.load(f"{REPO}/configs/nuscenes/train/spformer.yaml"), True, True))
    for cfg, pa, pc in cases:
        model = builder.make_model(cfg, "cpu")
        attn = [m for m in model.modules() if isinstance(m, sphereformer.SphereAttention)]
        assert len(attn) == 4
        assert (model.pallas_attention, model.pallas_cubic) == (pa, pc)
        assert all((m.pallas_attention, m.pallas_cubic) == (pa, pc) for m in attn)
        assert (wgeom_host.params_from_model(model) is None) == (not pa)
    tsd = builder.make_model(_synthetic("tsd_tiny.yaml"), "cpu")
    for sub in (tsd.model_s, tsd.model_t):
        assert not sub.pallas_attention and wgeom_host.params_from_model(sub) is None
