"""The benchmark's traffic generator: synthetic LiDAR-like scenes and a
fake camera rig, drawn from a numpy ``RandomState``.

A frozen copy of the program's ``data/synthetic.py`` (``make_scene``,
``make_batch``, ``project_to_cameras``, ``make_multimodal_batch``), which
the program's tests hold bitwise to the JAX package's generator: a ground
plane, walls, five box vehicles and a pole in a 40 m square, every point a
keyframe point, coordinates quantized and deduplicated as the dataset
pipeline does. The benchmark owns this copy, so that a change to the
program cannot change the inputs it is measured on.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def make_scene(rng: np.random.RandomState, num_points: int, extent: float = 40.0):
    """Returns (xyz [N,3] float32 metric, intensity [N,1], labels [N] int32).

    Labels: 0 ignore/noise, 1 ground, 2 building, 3 vehicle, 4 pole.
    """
    n_ground = int(num_points * 0.5)
    n_build = int(num_points * 0.2)
    n_veh = int(num_points * 0.2)
    n_pole = num_points - n_ground - n_build - n_veh

    g_xy = (rng.rand(n_ground, 2) - 0.5) * extent
    g = np.concatenate([g_xy, 0.05 * rng.randn(n_ground, 1)], 1)

    walls = []
    for _ in range(4):
        cx, cy = (rng.rand(2) - 0.5) * extent * 0.8
        w, h = 4 + 4 * rng.rand(), 3 + 3 * rng.rand()
        n = n_build // 4
        side = rng.randint(2)
        x = cx + (rng.rand(n) - 0.5) * w if side else np.full(n, cx)
        y = np.full(n, cy) if side else cy + (rng.rand(n) - 0.5) * w
        z = rng.rand(n) * h
        walls.append(np.stack([x, y, z], 1))
    b = np.concatenate(walls)[:n_build]
    if len(b) < n_build:
        b = np.concatenate([b, b[: n_build - len(b)]])

    vehs = []
    for _ in range(5):
        cx, cy = (rng.rand(2) - 0.5) * extent * 0.7
        n = n_veh // 5
        v = np.stack(
            [
                cx + (rng.rand(n) - 0.5) * 4.0,
                cy + (rng.rand(n) - 0.5) * 1.8,
                rng.rand(n) * 1.6,
            ],
            1,
        )
        vehs.append(v)
    v = np.concatenate(vehs)[:n_veh]
    if len(v) < n_veh:
        v = np.concatenate([v, v[: n_veh - len(v)]])

    px, py = (rng.rand(2) - 0.5) * extent * 0.9
    p = np.stack(
        [
            px + 0.05 * rng.randn(n_pole),
            py + 0.05 * rng.randn(n_pole),
            rng.rand(n_pole) * 6.0,
        ],
        1,
    )

    xyz = np.concatenate([g, b, v, p]).astype(np.float32)
    labels = np.concatenate(
        [
            np.full(n_ground, 1),
            np.full(n_build, 2),
            np.full(n_veh, 3),
            np.full(n_pole, 4),
        ]
    ).astype(np.int32)
    # sprinkle ignore labels
    ign = rng.rand(num_points) < 0.02
    labels[ign] = 0
    intensity = rng.rand(num_points, 1).astype(np.float32)
    perm = rng.permutation(num_points)
    return xyz[perm], intensity[perm], labels[perm]


def project_to_cameras(xyz: np.ndarray, num_cams: int = 6):
    """Fake pinhole rig: cameras spaced around the azimuth, 90deg horizontal
    FOV. Returns (coords [NCAM, N, 2] normalized [-1,1], masks [NCAM, N])."""
    n = len(xyz)
    coords = np.zeros((num_cams, n, 2), np.float32)
    masks = np.zeros((num_cams, n), bool)
    for ci in range(num_cams):
        yaw = 2 * np.pi * ci / num_cams
        fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        left = np.array([-np.sin(yaw), np.cos(yaw), 0.0])
        up = np.array([0.0, 0.0, 1.0])
        d = xyz @ fwd
        u = -(xyz @ left) / np.maximum(d, 1e-6)
        v = -(xyz @ up - 1.5) / np.maximum(d, 1e-6)
        ok = (d > 1.0) & (np.abs(u) < 1.0) & (np.abs(v) < 0.6)
        coords[ci, :, 0] = np.clip(u, -1, 1)
        coords[ci, :, 1] = np.clip(v / 0.6, -1, 1)
        masks[ci] = ok
    return coords, masks


def make_multimodal_batch(
    rng: np.random.RandomState,
    batch_size: int,
    num_points: int,
    teacher_points: int,
    voxel_size: float = 0.2,
    num_cams: int = 2,
    im_hw=(64, 96),
):
    """Paired student/teacher feed (reference
    ``lc_semantic_nusc_tsd_full.py:458-462``): the student sees the
    single-sweep cloud + cameras; the teacher sees the same keyframe points
    plus extra 'sweep' points. ``t2s`` maps each student point to its row in
    the teacher cloud."""
    student = make_batch(rng, batch_size, num_points, voxel_size)
    b = batch_size
    h, w = im_hw
    tp = teacher_points
    teacher = dict(
        pcoords=np.zeros((b, tp, 3), np.float32),
        xyz=np.zeros((b, tp, 3), np.float32),
        feats=np.zeros((b, tp, 4), np.float32),
        labels=np.zeros((b, tp), np.int32),
        pmask=np.zeros((b, tp), bool),
        keyframe_mask=np.zeros((b, tp), bool),
    )
    t2s = np.full((b, num_points), -1, np.int32)
    images = rng.rand(b, num_cams, h, w, 3).astype(np.float32)
    pix_coords = np.zeros((b, num_cams, num_points, 2), np.float32)
    cam_masks = np.zeros((b, num_cams, num_points), bool)
    for i in range(b):
        m = student["pmask"][i]
        nm = int(m.sum())
        # teacher cloud = student keyframe points first, then extra sweeps
        n_extra = min(tp - nm, tp // 3)
        extra_xyz = (rng.rand(n_extra, 3) * 30 - 15).astype(np.float32)
        xyz_t = np.concatenate([student["xyz"][i, :nm], extra_xyz])
        nt = len(xyz_t)
        teacher["xyz"][i, :nt] = xyz_t
        teacher["pcoords"][i, :nt] = np.round(xyz_t / voxel_size) - np.round(
            xyz_t / voxel_size
        ).min(0)
        teacher["feats"][i, :nt, :3] = xyz_t
        teacher["feats"][i, :nt, 3] = rng.rand(nt)
        teacher["labels"][i, :nm] = student["labels"][i, :nm]
        teacher["pmask"][i, :nt] = True
        teacher["keyframe_mask"][i, :nm] = True
        t2s[i, :nm] = np.arange(nm)
        co, ma = project_to_cameras(student["xyz"][i, :nm], num_cams)
        pix_coords[i, :, :nm] = co
        cam_masks[i, :, :nm] = ma & m[None, :nm]
    fov_mask = cam_masks.any(axis=1)
    student.update(
        images=images, pix_coords=pix_coords, cam_masks=cam_masks,
        fov_mask=fov_mask,
    )
    return {"student": student, "teacher": teacher, "t2s": t2s}


def make_batch(
    rng: np.random.RandomState,
    batch_size: int,
    num_points: int,
    voxel_size: float = 0.2,
) -> Dict[str, np.ndarray]:
    """Padded fixed-shape batch in the framework's feed format; every point
    is a keyframe point (the JAX version's ``num_sweep_factor=1``)."""
    b = batch_size
    p = num_points
    pcoords = np.zeros((b, p, 3), np.float32)
    xyz = np.zeros((b, p, 3), np.float32)
    feats = np.zeros((b, p, 4), np.float32)
    labels = np.zeros((b, p), np.int32)
    pmask = np.zeros((b, p), bool)
    kf_mask = np.zeros((b, p), bool)
    for i in range(b):
        n = int(p * (0.85 + 0.15 * rng.rand()))
        sxyz, inten, lab = make_scene(rng, n)
        # quantize like the dataset pipeline: coords relative to min
        vox = np.round(sxyz / voxel_size).astype(np.int64)
        vox -= vox.min(0)
        # first-occurrence dedup (sparse_quantize semantics)
        _, inds = np.unique(
            vox.view([("x", "i8"), ("y", "i8"), ("z", "i8")]).reshape(-1),
            return_index=True,
        )
        inds = np.sort(inds)[: p]
        m = len(inds)
        pcoords[i, :m] = vox[inds]
        xyz[i, :m] = sxyz[inds]
        feats[i, :m] = np.concatenate([sxyz[inds], inten[inds]], 1)
        labels[i, :m] = lab[inds]
        pmask[i, :m] = True
        kf_mask[i, :m] = True
    return dict(
        pcoords=pcoords, xyz=xyz, feats=feats, labels=labels,
        pmask=pmask, keyframe_mask=kf_mask,
    )
