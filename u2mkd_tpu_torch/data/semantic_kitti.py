"""SemanticKITTI dataset (sequences 00-10 train / 08 val / 11-21 test).

Port of ``u2mkd_tpu/data/semantic_kitti.py``, the reference's
``core/datasets/semantic_kitti.py``: labels from the dataset's own
``semantic-kitti.yaml`` learning_map, calib ``Tr`` + ``poses.txt``
multisweep pose-chain aggregation (unlike nuScenes, sweep points KEEP their
real labels; the keyframe mask marks the reference frame, reference
``:236-243``), instance aug with KITTI thing/ground lists, then the same
flip/rotate/scale + quantize pipeline.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import yaml

from u2mkd_tpu_torch.data import transforms

TRAIN_SEQS = ["00", "01", "02", "03", "04", "05", "06", "07", "09", "10"]
VAL_SEQS = ["08"]
TEST_SEQS = ["11", "12", "13", "14", "15", "16", "17", "18", "19", "20", "21"]

KITTI_THING_LIST = [1, 2, 3, 4, 5, 6, 7, 8]
KITTI_GROUND_LIST = [9, 10, 11, 12, 17]
KITTI_PAIR_LIST = [
    [9, 10], [9, 10, 11], [9, 10, 11], [9, 10], [9, 10],
    [9, 10, 11, 12, 17], [9, 10, 11, 12], [9, 10, 11, 12],
]
KITTI_CLASS_NAME = [
    "car", "bicycle", "motorcycle", "truck", "other-vehicle", "person",
    "bicyclist", "motorcyclist",
]


def _homo(m34: np.ndarray) -> np.ndarray:
    out = np.eye(4, dtype=np.float64)
    out[:3, :4] = m34
    return out


def _inv_rt(m: np.ndarray) -> np.ndarray:
    out = np.eye(4, dtype=np.float64)
    r, t = m[:3, :3], m[:3, 3]
    out[:3, :3] = r.T
    out[:3, 3] = -r.T @ t
    return out


class SemanticKITTI:
    def __init__(
        self,
        root: str,
        voxel_size: float,
        capacity: int,
        split: str = "train",
        num_sweeps: int = 0,
        flip_aug: bool = True,
        rotate_aug: bool = True,
        translate_std=None,
        inst_augmenter=None,
        seed: int = 0,
        tta: bool = False,
    ):
        with open(os.path.join(root, "semantic-kitti.yaml")) as f:
            cfg = yaml.safe_load(f)
        lm = cfg["learning_map"]
        self.remap = np.zeros(max(lm) + 1, np.int32)
        for k, v in lm.items():
            self.remap[k] = v
        self.root = os.path.join(root, "sequences")
        self.voxel_size = voxel_size
        self.capacity = capacity
        self.split = split
        self.train = split == "train"
        self.num_sweeps = num_sweeps
        # tta: fresh flip/rotate-scale per val pass, so multi-vote
        # evaluation sums genuinely different views (same semantics as
        # SemanticNusc; reference NuScenes_Evaluator pattern,
        # nusc_trainers.py:441-550)
        self.tta = tta and not self.train
        aug_on = self.train or self.tta
        self.flip_aug = flip_aug and aug_on
        self.rotate_aug = rotate_aug and aug_on
        self.translate_std = translate_std if self.train else None
        self.inst_augmenter = inst_augmenter if self.train else None
        self.rng = np.random.RandomState(seed)

        self.seqs = {"train": TRAIN_SEQS, "val": VAL_SEQS, "test": TEST_SEQS}[split]
        self.files: List[List[str]] = []
        self.tr: List[np.ndarray] = []
        self.poses: List[List[np.ndarray]] = []
        self.index: List[tuple] = []
        for si, seq in enumerate(self.seqs):
            vdir = os.path.join(self.root, seq, "velodyne")
            names = sorted(os.listdir(vdir))
            self.files.append([os.path.join(vdir, n) for n in names])
            # calib.txt: P0..P3 then Tr (each "Xn: 12 floats")
            with open(os.path.join(self.root, seq, "calib.txt")) as f:
                lines = [l.rstrip("\n") for l in f]
            tr_line = [l for l in lines if l.startswith("Tr")][0]
            self.tr.append(
                np.array(tr_line.split(":", 1)[1].split(), np.float64).reshape(3, 4)
            )
            pl = []
            pose_path = os.path.join(self.root, seq, "poses.txt")
            if os.path.exists(pose_path):
                with open(pose_path) as f:
                    for line in f:
                        pl.append(
                            np.array(line.split(), np.float64).reshape(3, 4)
                        )
            self.poses.append(pl)
            for pi in range(len(names)):
                self.index.append((si, pi))

    def __len__(self):
        return len(self.index)

    def _load_frame(self, si, pi):
        path = self.files[si][pi]
        pts = np.fromfile(path, np.float32).reshape(-1, 4)
        if self.split == "test":
            labels = np.zeros(len(pts), np.int32)
        else:
            lpath = path.replace("velodyne", "labels")[:-3] + "label"
            anno = np.fromfile(lpath, np.int32)
            labels = self.remap[anno & 0xFFFF]
        return pts, labels

    def _aggregate_sweeps(self, si, pi):
        """Warp neighbor frames into the reference frame via
        Tr^-1 . pose_ref^-1 . pose_i . Tr (reference ``:193-220``). Sweep
        labels are kept (not ignored)."""
        n = self.num_sweeps
        tr = _homo(self.tr[si])
        tr_inv = _inv_rt(tr)
        ref_pose_inv = _inv_rt(_homo(self.poses[si][pi]))
        start = max(pi - n, 0)
        # reference window semantics (semantic_kitti.py:196-197): when the
        # future window would run off the sequence end, ALL future sweeps
        # are dropped (end = pi), not clamped to the sequence length
        nf = len(self.files[si])
        end = pi + n if (pi + n) < nf else pi
        pts_list, lab_list = [], []
        for i in range(start, end):
            if i == pi:
                continue
            pts_i, lab_i = self._load_frame(si, i)
            tm = tr_inv @ ref_pose_inv @ _homo(self.poses[si][i]) @ tr
            xyz = pts_i[:, :3].astype(np.float64) @ tm[:3, :3].T + tm[:3, 3]
            pts_list.append(
                np.concatenate([xyz.astype(np.float32), pts_i[:, 3:4]], 1)
            )
            lab_list.append(lab_i)
        return pts_list, lab_list

    def __getitem__(self, index: int):
        si, pi = self.index[index]
        pts, labels = self._load_frame(si, pi)
        if self.inst_augmenter is not None:
            xyz, labels, inten = self.inst_augmenter.inst_aug(
                pts[:, :3], labels, pts[:, 3]
            )
            pts = np.concatenate([xyz, inten], axis=1)
        keyframe_mask = np.ones(len(pts), bool)
        if self.num_sweeps:
            sw_pts, sw_lab = self._aggregate_sweeps(si, pi)
            if sw_pts:
                sw = np.concatenate(sw_pts)
                pts = np.concatenate([pts, sw])
                labels = np.concatenate([labels] + sw_lab)
                # KITTI keeps sweep labels; keyframe mask still marks the
                # reference frame for eval filtering
                keyframe_mask = np.concatenate(
                    [keyframe_mask, np.zeros(len(sw), bool)]
                )

        xyz = pts[:, :3]
        if self.flip_aug:
            xyz = transforms.random_flip(xyz, self.rng)
        xyz, _, _ = transforms.random_rotate_scale(xyz, self.rng, self.rotate_aug)
        if self.translate_std:
            xyz = transforms.random_translate(xyz, self.translate_std, self.rng)
        feed, info = transforms.build_feed(
            xyz, pts[:, 3], labels, keyframe_mask, self.voxel_size, self.capacity
        )
        feed["info"] = info
        return feed
