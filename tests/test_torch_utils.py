"""The port's host tools against the JAX package's, on the CPU: the useful
attention FLOP counters (``utils/flops.py``), the renderings and the
confusion matrix (``utils/visualize.py``), the profiling hooks
(``utils/profiling.py``) and the instance-database builder
(``python -m u2mkd_tpu_torch.prepare_inst_database`` against the root
``prepare_inst_database.py``).
"""

import os
import pickle
import sys

import numpy as np
import pytest

from u2mkd_tpu.data import plumbing_host as jax_plumbing_host
from u2mkd_tpu.data import synthetic as jax_synthetic
from u2mkd_tpu.data import wgeom_host as jax_wgeom_host
from u2mkd_tpu.utils import flops as jax_flops
from u2mkd_tpu.utils import visualize as jax_viz

from u2mkd_tpu_torch import prepare_inst_database
from u2mkd_tpu_torch.data import plumbing_host, wgeom_host
from u2mkd_tpu_torch.models.spvcnn import SPVCNN
from u2mkd_tpu_torch.utils import flops, profiling, visualize

from test_kitti_dataset import make_fake_kitti
from test_torch_model import _jax_teacher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
sys.path.insert(0, REPO)

CAPS = (256, 128, 64, 32, 16)


@pytest.mark.parametrize("train", [False, True])
def test_useful_flops_equal_jax(train):
    """Per branch and level the useful pairs, and the useful FLOPs of the
    forward (and backward), equal the JAX package's on the same scan, each
    from its own host geometry, for a model with cubic windows of 24
    quantization steps and one of another shape."""
    raw = jax_synthetic.make_batch(np.random.RandomState(1), 1, 512, voxel_size=0.3)
    for ws, g in ((1.8, 24), (1.2, 8)):
        geom = dict(window_size=(ws,) * 3, quant_size=(ws / g,) * 3,
                    window_size_sphere=(2.0, 2.0, 120.0),
                    quant_size_sphere=(2.0 / 24, 2.0 / 24, 5.0), window_size_scale=(2.0, 2.0))
        model = _jax_teacher(pallas_attention=True).clone(**geom)
        pl = jax_plumbing_host.batch_plumbing(
            raw["pcoords"], raw["xyz"], raw["pmask"], CAPS,
            wgeom_params=jax_wgeom_host.params_from_model(model))
        port = SPVCNN(num_classes=5, cr=0.25, head_dim=4, pallas_attention=True, **geom)
        arrays = plumbing_host.batch_plumbing(
            raw["pcoords"], raw["xyz"], raw["pmask"], CAPS,
            wgeom_params=wgeom_host.params_from_model(port))
        assert flops.level_attn_specs(port) == jax_flops.level_attn_specs(model)
        counts = flops.useful_pair_counts(arrays)
        assert counts == jax_flops.useful_pair_counts(pl)
        assert min(counts["cubic"]) > 0 and min(counts["sphere"]) > 0
        got = flops.flash_attention_useful_flops(port, arrays, train)
        assert got == jax_flops.flash_attention_useful_flops(model, pl, train) > 0
    assert flops.flash_attention_useful_flops(port, {"wgeom": None}) == 0.0


@pytest.fixture
def scene():
    rng = np.random.RandomState(2)
    n = 3000
    return {"xyz": (rng.rand(n, 3) * [80, 80, 6] - [40, 40, 2]).astype(np.float32),
            "labels": rng.randint(0, 17, n), "pred": rng.randint(0, 22, n),
            "view": rng.randint(-1, 6, n), "rgb": rng.randint(0, 256, (n, 3)).astype(np.uint8),
            "uv": (rng.rand(n, 2) * 2.4 - 1.2).astype(np.float32), "mask": rng.rand(n) < 0.8,
            "image": rng.randint(0, 256, (90, 160, 3)).astype(np.uint8)}


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_renderings_equal_jax(scene, tmp_path):
    """The BEV PNG, the projection overlays (labelled and plain) and the
    HTML viewer (every colouring, subsampled, selections as indices and as
    a mask) are byte-equal to the JAX package's; the palettes and label
    maps are its own."""
    for name in ("NUSC_CLASS_COLORS", "IDX2COLOR_22", "VIEW_COLORS"):
        np.testing.assert_array_equal(getattr(visualize, name), getattr(jax_viz, name))
    assert visualize.MAP_SEMKITTI_TO_NUSC == jax_viz.MAP_SEMKITTI_TO_NUSC
    assert visualize.MAP_WAYMO_TO_NUSC == jax_viz.MAP_WAYMO_TO_NUSC
    s = scene
    calls = [
        ("bev.png", "save_bev_png", (s["xyz"], s["labels"]), {"size": 200}),
        ("overlay.png", "save_projection_overlay",
         (s["image"], s["uv"], s["mask"], s["labels"]), {}),
        ("overlay_plain.png", "save_projection_overlay", (s["image"], s["uv"], s["mask"]), {}),
        ("all.html", "export_html_viewer", (s["xyz"],),
         dict(labels=s["labels"], predict=s["pred"], view=s["view"], rgb=s["rgb"],
              select_inds=np.arange(0, 3000, 7), max_points=2000, title="scan",
              class_names=[f"k{i}" for i in range(17)])),
        ("mask.html", "export_html_viewer", (s["xyz"],),
         dict(select_inds=s["mask"], max_points=5000)),
        ("bare.html", "export_html_viewer", (s["xyz"][:50],), {}),
    ]
    for fname, fn, args, kw in calls:
        ours, ref = str(tmp_path / f"port_{fname}"), str(tmp_path / f"jax_{fname}")
        getattr(visualize, fn)(ours, *args, **kw)
        getattr(jax_viz, fn)(ref, *args, **kw)
        assert _bytes(ours) == _bytes(ref), fname


def test_bev_height_colouring(scene, tmp_path):
    """Without labels the BEV is coloured by height (the JAX package's
    ``ndarray.ptp`` call fails on numpy 2, so this is held to its formula):
    the highest point white, the lowest black."""
    from PIL import Image

    xyz = np.array([[0.0, 0.0, -1.0], [10.0, 10.0, 3.0], [-10.0, 5.0, 1.0]], np.float32)
    path = str(tmp_path / "h.png")
    visualize.save_bev_png(path, xyz, extent=20.0, size=41)
    img = np.asarray(Image.open(path))
    assert img.shape == (41, 41, 3)
    u = ((xyz[:, 0] + 20) / 40 * 40).astype(int)
    v = ((xyz[:, 1] + 20) / 40 * 40).astype(int)
    got = img[40 - v, u, 0]
    np.testing.assert_array_equal(got, [0, 255, 127])
    assert (img > 0).sum() == 2 * 3


def test_confusion_matrix_equals_jax(scene):
    cm = visualize.confusion_matrix(scene["pred"] % 17, scene["labels"], 17)
    np.testing.assert_array_equal(cm, jax_viz.confusion_matrix(scene["pred"] % 17,
                                                               scene["labels"], 17))
    assert cm.sum() == (scene["labels"] != 0).sum()


def test_profiling_hooks(tmp_path):
    """The trace lands in its directory, a falsy one traces nothing, the
    step timer trims as ``InferTime`` does, and a range is a profiler
    range."""
    import torch

    with profiling.device_trace(str(tmp_path / "trace")):
        with profiling.annotate("matmul"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    files = os.listdir(tmp_path / "trace")
    assert files and all(f.endswith(".json") for f in files)
    with open(tmp_path / "trace" / files[0]) as f:
        assert '"matmul"' in f.read()
    with profiling.device_trace(None):
        pass
    timer = profiling.StepTimer("cpu")
    for _ in range(15):
        with timer:
            pass
    timer.times[10] = timer.times[11] = 1.0  # the two kept of 15: [10:-3]
    timer.times[0] = timer.times[-1] = 9.0
    assert len(timer.times) == 15
    assert timer.mean_ms() == pytest.approx(1000.0, rel=1e-9)
    assert profiling.StepTimer("cpu").mean_ms() is None


def _database(out):
    with open(os.path.join(out, "inst_database_train_info.pkl"), "rb") as f:
        db = pickle.load(f)
    return db, {rel: _bytes(os.path.join(out, rel)) for recs in db.values() for rel in recs}


def _both(monkeypatch, tmp_path, args):
    """The port's entry point and the root script on the same arguments ->
    their databases (pickle and record files)."""
    import prepare_inst_database as ref_script

    ours, ref = str(tmp_path / "port_db"), str(tmp_path / "jax_db")
    prepare_inst_database.main([*args, "--out", ours])
    monkeypatch.setattr(sys, "argv", ["prepare_inst_database.py", *args, "--out", ref])
    ref_script.main()
    return _database(ours), _database(ref)


def test_instance_database_nusc_equals_root_script(monkeypatch, tmp_path):
    """nuScenes, on a ``tools/make_nusc_mini`` set (panoptic labels
    included): the pickle and every record file equal the root script's."""
    from make_nusc_mini import generate

    root = str(tmp_path / "nusc")
    generate(root, pts_per_scan=3000, write_images=False)
    (db, recs), (ref_db, ref_recs) = _both(
        monkeypatch, tmp_path, ["nusc", "--root", root, "--version", "v1.0-mini",
                                "--allow-unofficial-split"])
    assert db == ref_db and recs == ref_recs
    assert sum(len(v) for v in db.values()) > 0


def test_instance_database_kitti_equals_root_script(monkeypatch, tmp_path):
    """SemanticKITTI, on the JAX tests' fake set (sequence 08 linked as
    00): the pickle and every record file equal the root script's."""
    root = make_fake_kitti(tmp_path, n_pts=2000)
    os.symlink(os.path.join(root, "sequences", "08"), os.path.join(root, "sequences", "00"))
    (db, recs), (ref_db, ref_recs) = _both(monkeypatch, tmp_path, ["kitti", "--root", root])
    assert db == ref_db and recs == ref_recs
    assert db.get("car")
