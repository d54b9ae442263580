"""Waymo Open Dataset semantic segmentation reader (23 classes).

Port of ``u2mkd_tpu/data/waymo.py``. The reference's Waymo support is the instance-DB builder driven by
``keyframes.txt`` (``prepare_waymo_inst_database.py:53-80``; its dataset
variants are commented out of the builder, SURVEY §2.2). Two on-disk
formats are supported here:

- **raw** (the reference's exact format): ``keyframes.txt`` lines are
  ``<...>/<sequence>/lidar/<frame>.bin`` paths; each frame consists of a
  float32 ``[N, 6]`` lidar blob (x, y, z, intensity, range, elongation),
  an int32 ``[N, 2]`` label blob at ``lidar -> label`` (column 0 panoptic
  id, column 1 semantic id), a uint8 per-point sensor-id blob at
  ``lidar -> sensor`` (top lidar = 1), and second-return siblings at
  ``lidar_ri2 / label_ri2 / sensor_ri2``. Parsing follows the reference
  bit-for-bit: keep top-lidar points of both returns, intensity
  ``tanh``-squashed, range column dropped (rows become xyzie), returns
  concatenated, semantic-0 points discarded
  (``prepare_waymo_inst_database.py:87-125``).
- **pre-extracted** ``.npy`` frames with columns
  [x, y, z, intensity, sem_label, pano_label] (a convenience format for
  environments without the raw blobs).

Extraction from TFRecords happens offline, outside this package.
"""

from __future__ import annotations

import os

import numpy as np

from u2mkd_tpu_torch.data import transforms

def resolve_keyframe_path(root: str, line: str) -> str:
    """Reference path resolution (``prepare_waymo_inst_database.py:66-69``):
    a keyframes.txt line contributes only its LAST THREE path segments
    (sequence/lidar/frame.bin), joined under the data root."""
    seg = line.split("/")
    return os.path.join(root, *seg[-3:])


def keyframe_token(lidar_path: str) -> str:
    """``<sequence>_<frame-stem>`` (reference ``:76-78``, built from the
    label path whose last three segments mirror the lidar path's)."""
    seg = str(lidar_path).split("/")
    return f"{seg[-3]}_{seg[-1][:-4]}"


def _sibling(path: str, src: str, dst: str) -> str:
    """Swap the role DIRECTORY (``lidar``/``label``/``sensor``/``*_ri2``,
    always the second-to-last path segment) for a sibling role.

    The reference string-replaces over the whole absolute path
    (``prepare_waymo_inst_database.py:70-72,86-96``) — which silently
    corrupts real Waymo sequence directories such as
    ``segment-..._with_camera_labels`` (the ``label -> label_ri2``
    replacement rewrites the sequence name too). Restricting the swap to
    the role segment is behavior-identical on every layout the reference
    can actually load, and correct on the ones it cannot."""
    parts = path.rsplit(os.sep, 3)
    parts[-2] = parts[-2].replace(src, dst)
    return os.sep.join(parts)


def load_waymo_raw_keyframe(root: str, line: str):
    """Load one raw-format keyframe exactly like the reference builder
    (``prepare_waymo_inst_database.py:84-125``).

    Returns ``(pts [M, 5] float32 xyzie, sem uint8, pano int32, token)``
    with top-lidar points of both returns concatenated and semantic-0
    points removed.
    """
    lidar_path = resolve_keyframe_path(root, line)
    pts_list, sem_list, pano_list = [], [], []
    for ri in (0, 1):
        lp = lidar_path if ri == 0 else _sibling(lidar_path, "lidar",
                                                 "lidar_ri2")
        labp = _sibling(lidar_path, "lidar", "label")
        if ri == 1:
            labp = _sibling(labp, "label", "label_ri2")
        sensp = _sibling(lidar_path, "lidar", "sensor")
        if ri == 1:
            sensp = _sibling(sensp, "sensor", "sensor_ri2")
        top_m = np.fromfile(sensp, dtype=np.uint8) == 1
        raw = np.fromfile(lp, dtype=np.float32).reshape(-1, 6)
        xyz, inten, elong = raw[:, :3], np.tanh(raw[:, 3]), raw[:, 5]
        pts = np.concatenate([xyz, inten[:, None], elong[:, None]], axis=1)
        annot = np.fromfile(labp, dtype=np.int32).reshape(-1, 2)
        pts_list.append(pts[top_m])
        sem_list.append(annot[top_m, 1].astype(np.uint32))
        pano_list.append(annot[top_m, 0].astype(np.int32))
    pts = np.concatenate(pts_list, axis=0)
    sem = np.concatenate(sem_list, axis=0).astype(np.uint8)
    pano = np.concatenate(pano_list, axis=0).astype(np.int32)
    valid = sem != 0
    return pts[valid], sem[valid], pano[valid], keyframe_token(lidar_path)


WAYMO_CLASS_NAMES_23 = [
    "undefined", "car", "truck", "bus", "other_vehicle", "motorcyclist",
    "bicyclist", "pedestrian", "sign", "traffic_light", "pole",
    "construction_cone", "bicycle", "motorcycle", "building", "vegetation",
    "tree_trunk", "curb", "road", "lane_marker", "other_ground", "walkable",
    "sidewalk",
]


class WaymoSeg:
    def __init__(
        self,
        root: str,
        voxel_size: float,
        capacity: int,
        split: str = "train",
        flip_aug: bool = True,
        rotate_aug: bool = True,
        translate_std=None,
        inst_augmenter=None,
        seed: int = 0,
        val_fraction: float = 0.15,
        tta: bool = False,
    ):
        self.root = root
        self.voxel_size = voxel_size
        self.capacity = capacity
        self.train = split == "train"
        # tta: fresh flip/rotate-scale per val pass (multi-vote evaluation),
        # same semantics as the nuScenes/KITTI datasets
        self.tta = tta and not self.train
        aug_on = self.train or self.tta
        self.flip_aug = flip_aug and aug_on
        self.rotate_aug = rotate_aug and aug_on
        self.translate_std = translate_std if self.train else None
        self.inst_augmenter = inst_augmenter if self.train else None
        self.rng = np.random.RandomState(seed)
        with open(os.path.join(root, "keyframes.txt")) as f:
            frames = [l for l in f.read().splitlines() if l]
        # waymo normally ships separate train/val directories; this
        # single-dir fallback splits by NAME HASH so a frame's membership
        # is stable when keyframes.txt grows (a positional stride would
        # silently move previously-trained frames into val)
        if split in ("train", "val"):
            import hashlib

            def bucket(name):
                return int(hashlib.md5(name.encode()).hexdigest(), 16) % 100

            thr = int(round(val_fraction * 100))
            frames = [f for f in frames
                      if (bucket(f) < thr) == (split == "val")]
        self.frames = frames

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, index: int):
        line = self.frames[index]
        if line.endswith(".bin"):
            # reference raw format: xyzie rows; drop elongation for the
            # standard xyzi feed
            pts5, sem, _, _ = load_waymo_raw_keyframe(self.root, line)
            pts = pts5[:, :4].astype(np.float32)
            labels = sem.astype(np.int32)
        else:
            arr = np.load(os.path.join(self.root, line))
            pts = arr[:, :4].astype(np.float32)
            labels = arr[:, 4].astype(np.int32)
        if self.inst_augmenter is not None:
            xyz, labels, inten = self.inst_augmenter.inst_aug(
                pts[:, :3], labels, pts[:, 3]
            )
            pts = np.concatenate([xyz, inten], axis=1)
        xyz = pts[:, :3]
        if self.flip_aug:
            xyz = transforms.random_flip(xyz, self.rng)
        xyz, _, _ = transforms.random_rotate_scale(xyz, self.rng, self.rotate_aug)
        if self.translate_std:
            xyz = transforms.random_translate(xyz, self.translate_std, self.rng)
        feed, info = transforms.build_feed(
            xyz, pts[:, 3], labels, np.ones(len(pts), bool),
            self.voxel_size, self.capacity,
        )
        feed["info"] = info
        return feed
