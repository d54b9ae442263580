"""The port's datasets and augmentation (``u2mkd_tpu_torch/data``) against
the JAX package's, on the CPU: the same files on disk and the same seeds
give every array bitwise, since both draw each augmentation from numpy
``RandomState``s in the same order.

Fixtures: a nuScenes-format set from ``tools/make_nusc_mini.generate`` at
300 points a scan (2 train scenes and 1 val scene of 3 keyframes, 6 cameras
of 1600x900 JPEGs), ``make_fake_kitti`` (``tests/test_kitti_dataset.py``),
``_write_frame`` (``tests/test_waymo_raw.py``) and an instance database the
tests write. Each dataset is read in train, val and TTA mode, three items in
sequence from one seed.
"""

import os
import pickle
import sys

import numpy as np
import pytest

from u2mkd_tpu.data import geometry as jax_geometry
from u2mkd_tpu.data import instaug as jax_instaug
from u2mkd_tpu.data import lc_semantic_nusc as jax_lc
from u2mkd_tpu.data import mix as jax_mix
from u2mkd_tpu.data import native as jax_native
from u2mkd_tpu.data import nusc_reader as jax_reader
from u2mkd_tpu.data import nusc_splits as jax_splits
from u2mkd_tpu.data import semantic_kitti as jax_kitti
from u2mkd_tpu.data import semantic_nusc as jax_nusc
from u2mkd_tpu.data import transforms as jax_transforms
from u2mkd_tpu.data import waymo as jax_waymo

from test_kitti_dataset import make_fake_kitti
from test_waymo_raw import _write_frame
from u2mkd_tpu_torch.data import (
    geometry, instaug, lc_semantic_nusc, mix, native, nusc_reader, nusc_splits, semantic_kitti,
    semantic_nusc, transforms, waymo,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
MODES = ("train", "val", "tta")


def assert_same(a, b, path="item"):
    """``a`` equals ``b`` exactly: nested dicts, lists and tuples of numpy
    arrays (same dtype, shape and bits), scalars and strings."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in b:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(b, np.ndarray):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape,
                                                           b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


@pytest.fixture(scope="module")
def mini_root(tmp_path_factory):
    from make_nusc_mini import generate

    root = str(tmp_path_factory.mktemp("nusc_mini"))
    generate(root, pts_per_scan=300)
    return root


def _split_mode(mode):
    return ("val", True) if mode == "tta" else (mode, False)


def _items(ds, n=3):
    return [ds[i] for i in range(min(n, len(ds)))]


@pytest.mark.parametrize("mode", MODES)
def test_semantic_nusc_items(mini_root, mode):
    """``SemanticNusc`` with two sweeps (past and future) and the
    translate jitter: flip, rotate+scale and translate drawn in order."""
    split, tta = _split_mode(mode)
    kw = dict(split=split, num_sweeps=2, translate_std=[0.1, 0.1, 0.1], seed=7, tta=tta,
              allow_unofficial_split=True)
    ours = semantic_nusc.SemanticNusc(mini_root, 0.3, 2048, "v1.0-mini", **kw)
    ref = jax_nusc.SemanticNusc(mini_root, 0.3, 2048, "v1.0-mini", **kw)
    assert len(ours) == len(ref) == (6 if split == "train" else 3)
    got, want = _items(ours), _items(ref)
    assert_same(got, want)
    assert_same(semantic_nusc.collate(got), jax_nusc.collate(want))


@pytest.mark.parametrize("mode", MODES)
def test_lc_semantic_nusc_items(mini_root, mode):
    """``LCSemanticNuscTSD``: the teacher's multisweep feed, the student's
    feed with its camera projections and images, ``t2s``; in train the
    per-point label drop, the class holdout and the camera drop too."""
    split, tta = _split_mode(mode)
    kw = dict(split=split, num_sweeps=2, im_drop=3, im_cr=0.05, seed=3, tta=tta,
              allow_unofficial_split=True, label_drop_p=0.1, label_drop_classes=(4,))
    ours = lc_semantic_nusc.LCSemanticNuscTSD(mini_root, 0.3, 512, 2048, "v1.0-mini", **kw)
    ref = jax_lc.LCSemanticNuscTSD(mini_root, 0.3, 512, 2048, "v1.0-mini", **kw)
    got, want = _items(ours), _items(ref)
    assert got[0]["student"]["images"].shape[0] == (3 if split == "train" else 6)
    assert (got[0]["t2s"] >= 0).any()
    assert_same(got, want)
    assert_same(lc_semantic_nusc.collate_tsd(got), jax_lc.collate_tsd(want))


def _kitti_root(tmp_path):
    """``make_fake_kitti``'s sequence 08 (val), linked as every train
    sequence too."""
    root = make_fake_kitti(tmp_path)
    seqs = os.path.join(root, "sequences")
    for seq in semantic_kitti.TRAIN_SEQS:
        os.symlink(os.path.join(seqs, "08"), os.path.join(seqs, seq))
    return root


@pytest.mark.parametrize("mode", MODES)
def test_semantic_kitti_items(tmp_path, mode):
    split, tta = _split_mode(mode)
    root = _kitti_root(tmp_path)
    kw = dict(split=split, num_sweeps=1, translate_std=[0.1, 0.1, 0.1], seed=5, tta=tta)
    ours = semantic_kitti.SemanticKITTI(root, 0.2, 1024, **kw)
    ref = jax_kitti.SemanticKITTI(root, 0.2, 1024, **kw)
    assert len(ours) == len(ref) > 0
    assert_same(_items(ours), _items(ref))


def _waymo_root(tmp_path):
    """Raw-format keyframes (both returns, sensor blobs) and
    pre-extracted ``.npy`` frames in one ``keyframes.txt``."""
    rng = np.random.RandomState(0)
    lines = []
    for i in range(4):
        _write_frame(str(tmp_path), "seq0", f"{i:03d}", rng)
        lines.append(f"/anywhere/seq0/lidar/{i:03d}.bin")
    for i in range(4):
        arr = np.concatenate([rng.rand(200, 3) * 20, rng.rand(200, 1),
                              rng.randint(0, 23, (200, 1)), np.zeros((200, 1))], 1)
        np.save(tmp_path / f"frame_{i}.npy", arr.astype(np.float32))
        lines.append(f"frame_{i}.npy")
    (tmp_path / "keyframes.txt").write_text("\n".join(lines) + "\n")
    return str(tmp_path)


@pytest.mark.parametrize("mode", MODES)
def test_waymo_items(tmp_path, mode):
    split, tta = _split_mode(mode)
    root = _waymo_root(tmp_path)
    kw = dict(split=split, translate_std=[0.1, 0.1, 0.1], seed=2, tta=tta, val_fraction=0.5)
    ours = waymo.WaymoSeg(root, 0.2, 1024, **kw)
    ref = jax_waymo.WaymoSeg(root, 0.2, 1024, **kw)
    assert ours.frames == ref.frames and len(ours) > 0
    assert_same(_items(ours), _items(ref))


def test_geometry_and_transforms_equal():
    """Every function of ``geometry`` and ``transforms`` on the same inputs
    and the same ``RandomState``s."""
    rng = np.random.RandomState(0)
    q = rng.randn(4)
    t = rng.randn(3)
    for inverse in (False, True):
        assert_same(geometry.transform_matrix(t, q, inverse),
                    jax_geometry.transform_matrix(t, q, inverse))
    xyz = rng.randn(500, 3) * 10
    tm = geometry.transform_matrix(t, q / np.linalg.norm(q))
    assert_same(geometry.apply_transform(tm, xyz), jax_geometry.apply_transform(tm, xyz))
    intr = np.array([[800.0, 0, 800], [0, 800, 450], [0, 0, 1]])
    assert_same(geometry.project_to_image(xyz, intr), jax_geometry.project_to_image(xyz, intr))
    xyz32 = xyz.astype(np.float32)
    for seed in range(4):
        a, b = np.random.RandomState(seed), np.random.RandomState(seed)
        assert_same(transforms.random_flip(xyz32, a), jax_transforms.random_flip(xyz32, b))
        assert_same(transforms.random_rotate_scale(xyz32, a),
                    jax_transforms.random_rotate_scale(xyz32, b))
        assert_same(transforms.random_rotate_scale(xyz32, a, rotate=False),
                    jax_transforms.random_rotate_scale(xyz32, b, rotate=False))
        assert_same(transforms.random_translate(xyz32, [0.1, 0.2, 0.3], a),
                    jax_transforms.random_translate(xyz32, [0.1, 0.2, 0.3], b))
    vox = transforms.quantize(xyz32, 0.5)
    assert_same(vox, jax_transforms.quantize(xyz32, 0.5))
    assert_same(transforms.sparse_quantize_index(vox), jax_transforms.sparse_quantize_index(vox))
    arrays = {"a": xyz32, "b": np.arange(500, dtype=np.int32)}
    for cap in (256, 700):
        assert_same(transforms.pad_to_capacity(arrays, cap, {"b": -1}),
                    jax_transforms.pad_to_capacity(arrays, cap, {"b": -1}))
    labels = rng.randint(0, 17, 500).astype(np.int32)
    kf = rng.rand(500) < 0.7
    for cap in (128, 1024):
        assert_same(transforms.build_feed(xyz32, xyz32[:, 0], labels, kf, 0.5, cap),
                    jax_transforms.build_feed(xyz32, xyz32[:, 0], labels, kf, 0.5, cap))


def test_native_bindings_match_numpy(monkeypatch):
    """``dedup_first``, ``transform_points``, ``remap_labels_lut`` and
    ``box_occupancy`` through the port's library against the JAX package's
    numpy path (its library taken away): equal, transform_points within
    one f32 rounding (its products run in another order)."""
    rng = np.random.RandomState(1)
    vox = rng.randint(0, 12, (3000, 3)).astype(np.int32)
    xyz = (rng.randn(3000, 3) * 20).astype(np.float32)
    tm = jax_geometry.transform_matrix(rng.randn(3), rng.randn(4) + [2, 0, 0, 0])
    raw = rng.randint(0, 32, 3000).astype(np.uint8)
    labels = rng.randint(0, 17, 3000).astype(np.int32)
    thing = np.zeros(17, bool)
    thing[1:11] = True
    box = (np.array([-5, -5, -5], np.float32), np.array([5, 8, 5], np.float32))
    ours = (native.dedup_first(vox), native.transform_points(tm, xyz),
            native.remap_labels_lut(raw, jax_nusc._REMAP_LUT),
            native.box_occupancy(xyz, labels, thing, *box))
    monkeypatch.setattr(jax_native, "_load", lambda: None)
    ref = (jax_native.dedup_first(vox), jax_native.transform_points(tm, xyz),
           jax_native.remap_labels_lut(raw, jax_nusc._REMAP_LUT),
           jax_native.box_occupancy(xyz, labels, thing, *box))
    assert_same(tuple(np.asarray(x, np.int64) for x in ours[0]),
                tuple(np.asarray(x, np.int64) for x in ref[0]))
    assert ours[1].dtype == np.float32
    np.testing.assert_allclose(ours[1], ref[1], rtol=2 ** -23, atol=0)
    assert_same(ours[2], ref[2].astype(np.int32))
    assert ours[3] == ref[3] and sum(ours[3]) > 0
    with pytest.raises(ValueError):
        native.box_occupancy(xyz, labels + 17, thing, *box)


def test_reader_reverse_index_and_splits(mini_root):
    """The table reader's reverse index (``sample["data"]`` built from the
    keyframe rows, the non-keyframe camera rows skipped), the hash split
    behind ``allow_unofficial`` and its refusal without it, the official
    index files and the test split."""
    ours = nusc_reader.NuScenesTables(mini_root, "v1.0-mini")
    ref = jax_reader.NuScenesTables(mini_root, "v1.0-mini")
    assert ours.sample == ref.sample
    channels = {"LIDAR_TOP"} | set(semantic_nusc.CAM_CHANNELS)
    assert all(channels <= set(s["data"]) for s in ours.sample)
    assert not any(tok.endswith("_sw") for s in ours.sample for tok in s["data"].values())
    for split in ("train", "val"):
        got = ours.split_samples(split, allow_unofficial=True)
        assert got == ref.split_samples(split, allow_unofficial=True)
        assert len(got) == (6 if split == "train" else 3)
        with pytest.raises(RuntimeError):
            ours.split_samples(split)
        assert_same(nusc_splits.official_indices(split), jax_splits.official_indices(split))
    many = [{"token": f"s{i}"} for i in range(40000)]
    for split in ("train", "val", "test"):
        got = nusc_splits.select_samples(many, split, lambda s: "scene-0001")
        assert got == jax_splits.select_samples(many, split, lambda s: "scene-0001")
        assert len(got) == {"train": 28130, "val": 6019, "test": 40000}[split]


def _write_instance_db(tmp_path):
    """A database of the nuScenes thing classes: a few boxes of points per
    class, [N, 5] float32 rows, as ``prepare_inst_database.py`` writes."""
    rng = np.random.RandomState(4)
    db = {}
    names = ["barrier", "bicycle", "bus", "car", "construction_vehicle", "motorcycle",
             "pedestrian", "traffic_cone", "trailer", "truck"]
    for ci, name in enumerate(names):
        recs = []
        for j in range(2):
            pts = np.zeros((30 + 10 * ci, 5), np.float32)
            pts[:, :3] = rng.rand(len(pts), 3) * [1.5, 0.8, 1.2] + [10 + ci, 3 * j - 4, 0]
            pts[:, 3] = rng.rand(len(pts))
            path = tmp_path / "inst" / name / f"{j}.bin"
            path.parent.mkdir(parents=True, exist_ok=True)
            pts.tofile(path)
            recs.append(f"inst/{name}/{j}.bin" if j else {"path": f"inst/{name}/{j}.bin"})
        db[name] = recs
    pkl = tmp_path / "db.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(db, f)
    return str(pkl)


def _augmenters(pkl, seed, **kw):
    from u2mkd_tpu_torch.data.loaders import _maybe_inst_augmenter
    from u2mkd_tpu_torch.utils.config import Config
    from u2mkd_tpu.data.loaders import _maybe_inst_augmenter as jax_maybe

    cfg = Config({"dataset": Config({"inst_aug": True, "inst_pkl_path": pkl,
                                     "inst_add_num": 6}),
                  "data": Config({"num_classes": 17})})
    ours, ref = _maybe_inst_augmenter(cfg, "nusc"), jax_maybe(cfg, "nusc")
    for aug in (ours, ref):
        aug.rng = np.random.RandomState(seed)
        for k, v in kw.items():
            setattr(aug, k, v)
    return ours, ref


@pytest.mark.parametrize("flip_rotate", [False, True])
def test_inst_augmentation(tmp_path, flip_rotate):
    """``InstAugmentation`` as the loaders build it for nuScenes, on a scan
    with ground patches: the same instances placed at the same spots, with
    the V2 flip and rotation jitter on and off."""
    pkl = _write_instance_db(tmp_path)
    ours, ref = _augmenters(pkl, 9, random_flip=flip_rotate, random_rotate=flip_rotate)
    rng = np.random.RandomState(2)
    n = 8000
    xyz = np.concatenate([rng.rand(n, 2) * 40 - 20, rng.randn(n, 1) * 0.02], 1)
    labels = rng.choice([11, 13, 15], n, p=[0.45, 0.45, 0.1]).astype(np.int32)
    feats = rng.rand(n, 1).astype(np.float32)
    got = ours.inst_aug(xyz, labels, feats)
    want = ref.inst_aug(xyz, labels, feats)
    assert len(got[0]) > n
    assert_same(got, want)


def test_lc_dataset_with_inst_augmentation(mini_root, tmp_path):
    """``LCSemanticNuscTSD`` in train with the instance augmenter: added
    points stay out of the cameras' masks, in both packages alike."""
    pkl = _write_instance_db(tmp_path)
    ours_aug, ref_aug = _augmenters(pkl, 11)
    kw = dict(split="train", num_sweeps=1, im_drop=3, im_cr=0.05, seed=3,
              allow_unofficial_split=True)
    ours = lc_semantic_nusc.LCSemanticNuscTSD(mini_root, 0.3, 512, 2048, "v1.0-mini",
                                              inst_augmenter=ours_aug, **kw)
    ref = jax_lc.LCSemanticNuscTSD(mini_root, 0.3, 512, 2048, "v1.0-mini",
                                   inst_augmenter=ref_aug, **kw)
    got, want = _items(ours, 2), _items(ref, 2)
    assert len(got[0]["student"]["info"]["fov_full"]) > 300
    assert_same(got, want)


def test_polarmix_and_lasermix():
    rng = np.random.RandomState(5)
    p1, p2 = (rng.randn(800, 4) * [10, 10, 2, 1]).astype(np.float32), \
        (rng.randn(700, 4) * [10, 10, 2, 1]).astype(np.float32)
    l1, l2 = rng.randint(0, 17, 800), rng.randint(0, 17, 700)
    for seed in range(4):
        ours = mix.PolarMix([1, 2, 3, 4], rng=np.random.RandomState(seed))
        ref = jax_mix.PolarMix([1, 2, 3, 4], rng=np.random.RandomState(seed))
        assert_same(ours(p1, l1, p2, l2), ref(p1, l1, p2, l2))
        ours = mix.LaserMix([3, 4, 5, 6], (-30, 10), prob=0.8, rng=np.random.RandomState(seed))
        ref = jax_mix.LaserMix([3, 4, 5, 6], (-30, 10), prob=0.8,
                               rng=np.random.RandomState(seed))
        assert_same(ours(p1, l1, p2, l2), ref(p1, l1, p2, l2))
    assert_same(instaug.ground_patches(p1[:, :3], l1, [1, 2]),
                jax_instaug.ground_patches(p1[:, :3], l1, [1, 2]))
