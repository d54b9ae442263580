"""nuScenes LiDAR+camera paired dataset for TSD distillation (student stage).

Port of ``u2mkd_tpu/data/lc_semantic_nusc.py``, the reference's
``core/datasets/lc_semantic_nusc_tsd_full.py``: each sample yields a
*student* feed (single-sweep cloud + camera images at ``im_cr`` scale +
per-camera normalized projections and FOV masks, ``im_drop`` random cameras
dropped in train) and a *teacher* feed (multisweep cloud with independent
augmentation), plus the composed teacher->student gather map ``t2s`` that
replaces the trainer's per-sample inverse_map/keyframe/inds remapping loops
(``nusc_trainers.py:288-324``). The keys are those the port's stage-2 steps
read (``train/distill.py``), as ``data/synthetic.make_multimodal_batch``
gives them.

Camera chain (``lc_semantic_nusc_tsd_full.py:344-392``): LiDAR -> ego(lidar
t) -> global -> ego(cam t) -> cam -> intrinsics; keep z > 1 m; normalize
pixel coords to [-1, 1] over (size - 1); in-bounds FOV mask. Images are
resize-only (no normalization; float 0-255), read with Pillow as the JAX
package reads them. Instance-augmented points are excluded from FOV masks
(``:394-396``). Random draws come from the dataset's one ``RandomState`` in
the JAX package's order: label drop, teacher rotate+scale then flip, camera
choice, student rotate+scale.
"""

from __future__ import annotations

import os
from functools import reduce
from typing import Dict, List

import numpy as np

from u2mkd_tpu_torch.data import geometry, transforms
from u2mkd_tpu_torch.data.semantic_nusc import CAM_CHANNELS, SemanticNusc


class LCSemanticNuscTSD(SemanticNusc):
    IMAGE_SIZE = (900, 1600)  # (H, W)

    def __init__(
        self,
        root: str,
        voxel_size: float,
        student_capacity: int,
        teacher_capacity: int,
        version: str = "v1.0-trainval",
        split: str = "train",
        num_sweeps: int = 2,
        only_past: bool = False,
        im_drop: int = 3,
        im_cr: float = 0.4,
        inst_augmenter=None,
        seed: int = 0,
        allow_unofficial_split: bool = False,
        tta: bool = False,
        label_drop_p: float = 0.0,
        label_drop_classes=(),
    ):
        super().__init__(
            root, voxel_size, teacher_capacity, version, split,
            num_sweeps=num_sweeps, only_past=only_past,
            flip_aug=True, rotate_aug=True, translate_std=None,
            inst_augmenter=inst_augmenter, seed=seed,
            allow_unofficial_split=allow_unofficial_split,
            tta=tta,
        )
        self.student_capacity = student_capacity
        self.teacher_capacity = teacher_capacity
        # label-efficiency ablation knob (train split only): fraction of
        # keyframe point labels re-marked as ignore_index 0 before the loss
        # sees them, simulating partial annotation. Distillation's KL/feat
        # terms use the frozen teacher's dense predictions, not labels, so
        # this isolates what the teacher contributes beyond the annotations
        # (tools/distill_ablation.py; val labels are never touched).
        self.label_drop_p = float(label_drop_p)
        # class-holdout variant of the same knob: every train keyframe label
        # in these (mapped, 1..16) classes is re-marked ignore. Unlike the
        # random per-point drop, a scratch student structurally CANNOT learn
        # a held-out class — the decisive distill-efficacy axis.
        self.label_drop_classes = tuple(int(c) for c in label_drop_classes or ())
        self.im_drop = im_drop if self.train else 0
        self.n_keep = len(CAM_CHANNELS) - self.im_drop
        self.im_size = (
            int(self.IMAGE_SIZE[0] * im_cr), int(self.IMAGE_SIZE[1] * im_cr)
        )

    def _cam_from_lidar(self, lidar_sd, cam_sd) -> np.ndarray:
        """4x4 transform LiDAR frame -> camera frame (the reference's 4-step
        rotate/translate chain as one matrix product)."""
        cs_l = self.nusc.get("calibrated_sensor", lidar_sd["calibrated_sensor_token"])
        pose_l = self.nusc.get("ego_pose", lidar_sd["ego_pose_token"])
        pose_c = self.nusc.get("ego_pose", cam_sd["ego_pose_token"])
        cs_c = self.nusc.get("calibrated_sensor", cam_sd["calibrated_sensor_token"])
        return reduce(
            np.dot,
            [
                geometry.transform_matrix(cs_c["translation"], cs_c["rotation"],
                                          inverse=True),
                geometry.transform_matrix(pose_c["translation"], pose_c["rotation"],
                                          inverse=True),
                geometry.transform_matrix(pose_l["translation"], pose_l["rotation"]),
                geometry.transform_matrix(cs_l["translation"], cs_l["rotation"]),
            ],
        )

    def _load_image(self, cam_sd) -> np.ndarray:
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError("reading the camera JPEGs of the stage-2 dataset needs Pillow "
                              "(the PIL package), which is not installed") from e

        im = Image.open(os.path.join(self.root, cam_sd["filename"])).convert("RGB")
        im = im.resize((self.im_size[1], self.im_size[0]), Image.BILINEAR)
        return np.asarray(im, np.float32)

    def __getitem__(self, index: int):
        sample = self.samples[index]
        pts, labels, sd_token = self._load_points_labels(sample)
        raw_num = len(pts)
        inst_aug_mask = np.ones(len(pts), bool)
        if self.inst_augmenter is not None:
            xyz_a, labels, inten = self.inst_augmenter.inst_aug(
                pts[:, :3], labels, pts[:, 3:]
            )
            pts = np.concatenate([xyz_a, inten], axis=1)
            inst_aug_mask = np.zeros(len(pts), bool)
            inst_aug_mask[:raw_num] = True
        if self.train and self.label_drop_p > 0.0:
            drop = self.rng.random(len(labels)) < self.label_drop_p
            labels = np.where(drop, 0, labels).astype(labels.dtype)
        if self.train and self.label_drop_classes:
            held = np.isin(labels, np.asarray(self.label_drop_classes))
            labels = np.where(held, 0, labels).astype(labels.dtype)

        # ---- teacher feed: multisweep + independent aug ----
        t_pts = pts.copy()
        t_labels = labels.copy()
        t_kf = np.ones(len(t_pts), bool)
        if self.num_sweeps:
            sweep_pts, _ = self._aggregate_sweeps(sample)
            if sweep_pts:
                sw = np.concatenate(sweep_pts)
                t_pts = np.concatenate([t_pts, sw])
                t_labels = np.concatenate([t_labels, np.zeros(len(sw), np.int32)])
                t_kf = np.concatenate([t_kf, np.zeros(len(sw), bool)])
        t_xyz = t_pts[:, :3]
        if self.train or self.tta:
            t_xyz, _, _ = transforms.random_rotate_scale(t_xyz, self.rng, True)
            t_xyz = transforms.random_flip(t_xyz, self.rng)
        t_feed, t_info = transforms.build_feed(
            t_xyz, t_pts[:, 3], t_labels, t_kf, self.voxel_size,
            self.teacher_capacity,
        )

        # ---- cameras (projection from the *un-augmented* cloud) ----
        lidar_sd = self.nusc.get("sample_data", sample["data"]["LIDAR_TOP"])
        if self.train and self.im_drop:
            keep = np.sort(
                self.rng.choice(len(CAM_CHANNELS), self.n_keep, replace=False)
            )
        else:
            keep = np.arange(len(CAM_CHANNELS))
        images, coords_list, masks_list = [], [], []
        for ci in keep:
            cam_sd = self.nusc.get("sample_data", sample["data"][CAM_CHANNELS[ci]])
            images.append(self._load_image(cam_sd))
            tm = self._cam_from_lidar(lidar_sd, cam_sd)
            xyz_cam = geometry.apply_transform(tm, pts[:, :3].astype(np.float64))
            cs_c = self.nusc.get(
                "calibrated_sensor", cam_sd["calibrated_sensor_token"]
            )
            intr = np.asarray(cs_c["camera_intrinsic"], np.float64)
            uv, depth = geometry.project_to_image(xyz_cam, intr)
            w, h = self.IMAGE_SIZE[1], self.IMAGE_SIZE[0]
            uv = uv / np.array([w - 1.0, h - 1.0]) * 2.0 - 1.0
            m = (depth > 1.0) & np.all((uv > -1) & (uv < 1), axis=1)
            m &= inst_aug_mask
            coords_list.append(uv.astype(np.float32))
            masks_list.append(m)
        images = np.stack(images)                # [NKEEP, h, w, 3]
        coords = np.stack(coords_list)           # [NKEEP, N, 2]
        cam_masks = np.stack(masks_list)         # [NKEEP, N]
        fov_full = cam_masks.any(0)

        # ---- student feed: rotate+scale only (projection indices survive) ----
        # tta: fresh rotate+scale per val pass so multi-vote evaluation sums
        # logits over genuinely different views (reference NuScenes_Evaluator,
        # nusc_trainers.py:441-550); rotation keeps the per-point camera
        # projections valid because it never reorders points
        s_xyz = pts[:, :3]
        s_xyz, _, _ = transforms.random_rotate_scale(
            s_xyz, self.rng, self.train or self.tta
        )
        s_feed, s_info = transforms.build_feed(
            s_xyz, pts[:, 3], labels, np.ones(len(pts), bool),
            self.voxel_size, self.student_capacity,
        )
        inds_s = s_info["inds"][: self.student_capacity]
        m = len(inds_s)
        cap = self.student_capacity

        def pad_cam(a, fill=0):
            out = np.full((a.shape[0], cap) + a.shape[2:], fill, a.dtype)
            out[:, :m] = a[:, inds_s]
            return out

        s_feed["pix_coords"] = pad_cam(coords)
        s_feed["cam_masks"] = pad_cam(cam_masks, False)
        fov = np.zeros(cap, bool)
        fov[:m] = fov_full[inds_s]
        s_feed["fov_mask"] = fov
        s_feed["images"] = images
        # raw-cloud eval info: the reference devoxelizes student vox+pix
        # logits back to the raw points via inverse_map before scoring
        # (nusc_trainers.py:368-390); fov_full restricts the pixel head
        s_info["fov_full"] = fov_full
        s_feed["info"] = s_info
        t_feed["info"] = t_info

        # ---- composed teacher->student map ----
        # teacher raw cloud = [keyframe pts, sweeps...]; student point i's raw
        # index is inds_s[i] < raw keyframe count, so its teacher dedup row is
        # inverse_map_t[inds_s[i]] (reference gathers tmp[inv][kfm][inds],
        # nusc_trainers.py:291-301)
        inv_t = t_info["inverse_map"]
        t2s = np.full(cap, -1, np.int32)
        valid = inds_s < len(inv_t)
        rows = inv_t[inds_s[valid]]
        rows = np.where(rows < self.teacher_capacity, rows, -1)
        t2s[: m][valid] = rows
        return {
            "student": s_feed,
            "teacher": t_feed,
            "t2s": t2s,
            "lidar_token": sd_token,
        }


def collate_tsd(samples: List[Dict]) -> Dict:
    s_keys = ("pcoords", "xyz", "feats", "labels", "pmask", "keyframe_mask",
              "pix_coords", "cam_masks", "fov_mask", "images")
    t_keys = ("pcoords", "xyz", "feats", "labels", "pmask", "keyframe_mask")
    out = {
        "student": {k: np.stack([s["student"][k] for s in samples]) for k in s_keys},
        "teacher": {k: np.stack([s["teacher"][k] for s in samples]) for k in t_keys},
        "t2s": np.stack([s["t2s"] for s in samples]),
    }
    out["infos"] = [
        {"student": s["student"].get("info"), "teacher": s["teacher"].get("info")}
        for s in samples
    ]
    out["lidar_tokens"] = [s["lidar_token"] for s in samples]
    return out
