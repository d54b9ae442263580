"""nuScenes-lidarseg uni-modal dataset (teacher recipe).

Port of ``u2mkd_tpu/data/semantic_nusc.py``, the reference's
``core/datasets/semantic_nusc.py`` on the self-contained table reader: 32->17
label remap, official splits, multisweep aggregation (past ``nsweeps`` then
``2n - len(prev)`` future unless ``only_past``; <1 m self-returns removed;
4-matrix pose chain; sweep labels = ignore), flip/rotate+scale/translate
augmentation drawn from one ``RandomState`` in the JAX package's order,
voxel quantization with first-occurrence dedup, emitted as fixed-capacity
padded numpy feeds.
"""

from __future__ import annotations

import os
from functools import reduce
from typing import Dict, List

import numpy as np

from u2mkd_tpu_torch.data import geometry, transforms
from u2mkd_tpu_torch.data.nusc_reader import NuScenesTables
from u2mkd_tpu_torch.data import nusc_splits

# nuScenes-lidarseg 32 raw classes -> 17 training classes
# (reference ``semantic_nusc.py:73-106``)
LABELS_MAPPING = {
    1: 0, 5: 0, 7: 0, 8: 0, 10: 0, 11: 0, 13: 0, 19: 0, 20: 0, 0: 0, 29: 0,
    31: 0, 9: 1, 14: 2, 15: 3, 16: 3, 17: 4, 18: 5, 21: 6, 2: 7, 3: 7, 4: 7,
    6: 7, 12: 8, 22: 9, 23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 30: 16,
}

CLASS_NAMES_17 = [
    "ignore", "barrier", "bicycle", "bus", "car", "construction_vehicle",
    "motorcycle", "pedestrian", "traffic_cone", "trailer", "truck",
    "driveable_surface", "other_flat", "sidewalk", "terrain", "manmade",
    "vegetation",
]

CAM_CHANNELS = [
    "CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT",
    "CAM_BACK_LEFT", "CAM_BACK", "CAM_BACK_RIGHT",
]

_REMAP_LUT = np.zeros(32, np.int32)
for k, v in LABELS_MAPPING.items():
    _REMAP_LUT[k] = v


def remap_labels(raw: np.ndarray) -> np.ndarray:
    return _REMAP_LUT[raw.astype(np.int64) % 32]


class SemanticNusc:
    """Uni-modal nuScenes dataset; ``__getitem__`` returns a padded feed."""

    def __init__(
        self,
        root: str,
        voxel_size: float,
        capacity: int,
        version: str = "v1.0-trainval",
        split: str = "train",
        num_sweeps: int = 0,
        only_past: bool = False,
        flip_aug: bool = True,
        rotate_aug: bool = True,
        translate_std=None,
        inst_augmenter=None,
        seed: int = 0,
        allow_unofficial_split: bool = False,
        tta: bool = False,
    ):
        self.nusc = NuScenesTables(root, version)
        self.root = root
        self.voxel_size = voxel_size
        self.capacity = capacity
        self.split = split
        self.num_sweeps = num_sweeps
        self.only_past = only_past
        self.train = split == "train"
        # tta: fresh flip/rotate-scale per pass over the val split, so
        # multi-vote evaluation sums logits over genuinely different views
        # (reference NuScenes_Evaluator, nusc_trainers.py:441-550)
        self.tta = tta and not self.train
        aug_on = self.train or self.tta
        self.flip_aug = flip_aug and aug_on
        self.rotate_aug = rotate_aug and aug_on
        self.translate_std = translate_std if self.train else None
        self.inst_augmenter = inst_augmenter if self.train else None
        self.samples = nusc_splits.select_samples(
            self.nusc.sample, split, self.nusc.scene_name,
            allow_unofficial=allow_unofficial_split,
        )
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.samples)

    def _load_points_labels(self, sample):
        sd_token = sample["data"]["LIDAR_TOP"]
        sd = self.nusc.get("sample_data", sd_token)
        pts = np.fromfile(
            os.path.join(self.root, sd["filename"]), dtype=np.float32
        ).reshape(-1, 5)[:, :4]
        if self.split == "test":
            labels = np.zeros(len(pts), np.int32)
        else:
            seg = self.nusc.get("lidarseg", sd_token)
            raw = np.fromfile(
                os.path.join(self.root, seg["filename"]), dtype=np.uint8
            )
            labels = remap_labels(raw)
        return pts, labels, sd_token

    def _aggregate_sweeps(self, sample) -> List[np.ndarray]:
        """Pose-chain warp of past/future sweeps into the keyframe frame
        (reference ``semantic_nusc.py:170-239``)."""
        ref_sd = self.nusc.get("sample_data", sample["data"]["LIDAR_TOP"])
        ref_pose = self.nusc.get("ego_pose", ref_sd["ego_pose_token"])
        ref_cs = self.nusc.get("calibrated_sensor", ref_sd["calibrated_sensor_token"])
        ref_time = 1e-6 * ref_sd["timestamp"]
        ref_from_car = geometry.transform_matrix(
            ref_cs["translation"], ref_cs["rotation"], inverse=True
        )
        car_from_global = geometry.transform_matrix(
            ref_pose["translation"], ref_pose["rotation"], inverse=True
        )

        def agg(n, direction):
            cur = ref_sd
            pts_list, ts_list = [], []
            for _ in range(n):
                if not cur[direction]:
                    break
                cur = self.nusc.get("sample_data", cur[direction])
                pts = np.fromfile(
                    os.path.join(self.root, cur["filename"]), dtype=np.float32
                ).reshape(-1, 5)[:, :4]
                close = (np.fabs(pts[:, 0]) < 1.0) & (np.fabs(pts[:, 1]) < 1.0)
                pts = pts[~close]
                pose = self.nusc.get("ego_pose", cur["ego_pose_token"])
                cs = self.nusc.get("calibrated_sensor", cur["calibrated_sensor_token"])
                tm = reduce(
                    np.dot,
                    [
                        ref_from_car, car_from_global,
                        geometry.transform_matrix(pose["translation"],
                                                  pose["rotation"]),
                        geometry.transform_matrix(cs["translation"],
                                                  cs["rotation"]),
                    ],
                )
                xyz = geometry.apply_transform(tm, pts[:, :3].astype(np.float64))
                warped = np.concatenate(
                    [xyz.astype(np.float32), pts[:, 3:4]], axis=1
                )
                if direction == "prev":
                    lag = ref_time - 1e-6 * cur["timestamp"]
                else:
                    lag = 1e-6 * cur["timestamp"] - ref_time
                pts_list.append(warped)
                ts_list.append(np.full(len(warped), lag, np.float32))
            return pts_list, ts_list

        prev_pts, prev_ts = agg(self.num_sweeps, "prev")
        if not self.only_past:
            next_pts, next_ts = agg(2 * self.num_sweeps - len(prev_pts), "next")
        else:
            next_pts, next_ts = [], []
        return prev_pts + next_pts, prev_ts + next_ts

    def __getitem__(self, index: int):
        sample = self.samples[index]
        pts, labels, sd_token = self._load_points_labels(sample)
        if self.inst_augmenter is not None:
            xyz, labels, inten = self.inst_augmenter.inst_aug(
                pts[:, :3], labels, pts[:, 3:]
            )
            pts = np.concatenate([xyz, inten], axis=1)

        keyframe_mask = np.ones(len(pts), bool)
        if self.num_sweeps:
            sweep_pts, sweep_ts = self._aggregate_sweeps(sample)
            if sweep_pts:
                sw = np.concatenate(sweep_pts)
                pts = np.concatenate([pts, sw])
                labels = np.concatenate(
                    [labels, np.zeros(len(sw), np.int32)]
                )
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
        feed["lidar_token"] = sd_token
        feed["info"] = info
        return feed


def collate(feeds: List[Dict]) -> Dict[str, np.ndarray]:
    """Stack padded feeds into batched arrays (infos kept as a list)."""
    keys = ("pcoords", "xyz", "feats", "labels", "pmask", "keyframe_mask")
    out = {k: np.stack([f[k] for f in feeds]) for k in keys}
    out["infos"] = [f.get("info") for f in feeds]
    out["lidar_tokens"] = [f.get("lidar_token") for f in feeds]
    return out
