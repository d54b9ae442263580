"""Ground-aware instance copy-paste augmentation.

Port of ``u2mkd_tpu/data/instaug.py``, the reference's
``InstAugmentation`` / ``InstAugmentationV2`` (``core/datasets/utils.py:35-457``):
sample object instances from a per-class database (class-weighted), find
candidate ground patches (5x5 m grid cells of >=20 ground points, mean
position), place each instance on a ground patch -- V2 prefers patches at a
similar range and rotates the instance about the origin to the patch
azimuth -- and reject placements whose bounding box overlaps existing
geometry (>0.1% thing points or >5% other points); stop after 5000 added
points. Every draw comes from the augmenter's ``RandomState`` in the JAX
package's order.

Database format: pickle {class_name: [record, ...]} where a record is either
a dict with 'path' or a path string; each .bin holds [N, feat_dim_src]
float32 rows (xyz + features), as ``prepare_inst_database.py`` writes them.
The pickle is read as the database file of a trusted run: unpickling runs
code.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Sequence

import numpy as np


def ground_patches(xyz: np.ndarray, labels: np.ndarray,
                   ground_list: Sequence[int],
                   grid_size=(5.0, 5.0), min_pts: int = 20) -> Dict[int, np.ndarray]:
    """Mean position of every (5 m x 5 m) cell holding >= min_pts ground
    points, per ground class (reference ``ground_analyze``)."""
    gs = np.asarray(grid_size, np.float32)
    out = {}
    for g in ground_list:
        m = labels == g
        if not m.any():
            continue
        g_xyz = xyz[m]
        grid = np.round(g_xyz[:, :2] / gs).astype(np.int64)
        grid -= grid.min(0, keepdims=True)
        key = grid[:, 0] * (grid[:, 1].max() + 1) + grid[:, 1]
        uq, inv, cnt = np.unique(key, return_inverse=True, return_counts=True)
        centers = np.zeros((len(uq), 3))
        np.add.at(centers, inv, g_xyz)
        centers /= cnt[:, None]
        out[g] = centers[cnt >= min_pts]
    return out


def rot_z_to_azimuth(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Rotation about z taking src's azimuth toward dst's (reference
    ``calc_rot_matrix``)."""
    cross_z = src[0] * dst[1] - src[1] * dst[0]
    denom = np.linalg.norm(src) * np.linalg.norm(dst)
    cosv = np.clip(np.dot(src, dst) / max(denom, 1e-12), -1.0, 1.0)
    theta = np.arccos(cosv)
    if cross_z < 0:
        theta = -theta
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


class InstAugmentation:
    """V2-style augmenter (the variant wired into the live datasets,
    ``semantic_nusc.py:141-148``)."""

    def __init__(
        self,
        instance_pkl_path: str,
        thing_list: Sequence[int],
        ground_list: Sequence[int],
        pair_list: Sequence[Sequence[int]],
        add_num: int,
        num_classes: int,
        class_name: Optional[Sequence[str]] = None,
        class_weight: Optional[Sequence[float]] = None,
        class_min_num: Optional[Sequence[int]] = None,
        feat_dim: int = 4,
        feat_dim_s: int = 5,
        random_trans: bool = True,
        random_flip: bool = False,
        random_rotate: bool = False,
        max_added_points: int = 5000,
        rng: Optional[np.random.RandomState] = None,
    ):
        self.thing_list = list(thing_list)
        self.ground_list = list(ground_list)
        self.pair_list = [list(p) for p in pair_list]
        self.add_num = add_num
        # reference V2 names this parameter feat_dim_s (utils.py:227)
        self.feat_dim_src = feat_dim_s
        self.max_added_points = max_added_points
        self.random_trans = random_trans
        self.random_flip = random_flip
        self.random_rotate = random_rotate
        self.grid_size = np.array([5.0, 5.0], np.float32)
        self.rng = rng or np.random.RandomState()
        self.inst_root = os.path.dirname(instance_pkl_path)
        with open(instance_pkl_path, "rb") as f:
            db = pickle.load(f)
        if class_name is not None:
            # a class with no database instances (possible on small splits)
            # simply never gets sampled — inst_aug skips empty record lists
            self.records = [db.get(c, []) for c in class_name]
        else:
            self.records = list(db.values()) if isinstance(db, dict) else db
        if class_weight is not None:
            w = np.asarray([class_weight[i] for i in self.thing_list], np.float64)
            self.weights = w / w.sum()
        else:
            self.weights = np.full(len(self.thing_list), 1.0 / len(self.thing_list))
        self.thing_mask = np.zeros(num_classes, bool)
        self.thing_mask[self.thing_list] = True

    def _load_record(self, rec) -> np.ndarray:
        if isinstance(rec, dict):
            path = os.path.join(self.inst_root, rec["path"])
        else:
            parts = str(rec).split("/")
            path = os.path.join(self.inst_root, *parts[-3:])
        return np.fromfile(path, dtype=np.float32).reshape(-1, self.feat_dim_src)

    def _try_place(self, xyz, labels, add_xyz, n_add):
        """Occupancy rejection test (reference ``utils.py:376-388``):
        overlap with things > 0.1% or with anything else > 5% of the
        instance size -> reject."""
        mn = add_xyz.min(0)
        mx = add_xyz.max(0)
        inside = np.all((xyz > mn) & (xyz < mx), axis=1)
        if inside.any():
            occ = labels[inside]
            n_thing = int(self.thing_mask[occ].sum())
            if n_thing / n_add > 0.001:
                return False
            if (len(occ) - n_thing) / n_add > 0.05:
                return False
        return True

    def inst_aug(self, xyz: np.ndarray, labels: np.ndarray,
                 feats: Optional[np.ndarray] = None):
        rng = self.rng
        grounds = ground_patches(xyz, labels, self.ground_list, self.grid_size)
        choice = rng.choice(len(self.thing_list), self.add_num, replace=True,
                            p=self.weights)
        uni, counts = np.unique(choice, return_counts=True)
        total_added = 0
        if feats is not None and feats.ndim == 1:
            feats = feats[:, None]
        for ci, cnt in zip(uni, counts):
            if len(self.records[ci]) == 0:
                continue
            recs = rng.choice(self.records[ci], cnt)
            for rec in recs:
                pts = self._load_record(rec)
                add_xyz = pts[:, :3].copy()
                center = add_xyz.mean(0)
                center[2] = add_xyz[:, 2].min()

                cands = [grounds[g] for g in self.pair_list[ci] if g in grounds]
                cands = [c for c in cands if len(c)]
                if not cands:
                    continue
                cands = np.concatenate(cands)
                # V2: prefer patches at similar range, rotate to azimuth
                d_gnd = np.linalg.norm(cands, axis=-1)
                d_obj = np.linalg.norm(center)
                order = np.argsort(np.fabs(d_obj - d_gnd))
                cands = cands[order][:9]

                placed = False
                for g_center in cands:
                    g_center = g_center.copy()
                    for _ in range(5):
                        if self.random_trans:
                            g_center[:2] += (2 * rng.random(2) - 1) * self.grid_size / 10
                            g_center[2] += rng.random() * 0.05
                        if self.random_flip:
                            # reference V2 4-way axis flip (utils.py:353-360)
                            ft = rng.choice(4)
                            if ft == 1:
                                add_xyz[:, 0] = -add_xyz[:, 0]
                            elif ft == 2:
                                add_xyz[:, 1] = -add_xyz[:, 1]
                            elif ft == 3:
                                add_xyz[:, :2] = -add_xyz[:, :2]
                        if self.random_rotate:
                            ang = rng.uniform(-np.pi / 36, np.pi / 36)
                            c, s = np.cos(ang), np.sin(ang)
                            r = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
                            add_xyz = (add_xyz - center) @ r + center
                        rot = rot_z_to_azimuth(center, g_center)
                        add_xyz = add_xyz @ rot.T
                        center = (center[None] @ rot.T)[0]
                        arrow = g_center - center
                        if not self._try_place(xyz, labels, add_xyz + arrow,
                                               len(add_xyz)):
                            continue
                        xyz = np.concatenate([xyz, add_xyz + arrow])
                        labels = np.concatenate(
                            [labels,
                             np.full(len(add_xyz), self.thing_list[ci],
                                     labels.dtype)]
                        )
                        if feats is not None:
                            add_f = pts[:, 3:3 + feats.shape[1]]
                            feats = np.concatenate([feats, add_f])
                        total_added += len(add_xyz)
                        placed = True
                        break
                    if placed:
                        break
                if total_added > self.max_added_points:
                    break
        if feats is not None:
            return xyz, labels, feats
        return xyz, labels
