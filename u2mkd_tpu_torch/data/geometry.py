"""Pose/quaternion geometry for multisweep aggregation and camera projection.

Port of ``u2mkd_tpu/data/geometry.py`` (numpy): replacements for
pyquaternion and nuscenes-devkit's ``transform_matrix``, which the reference
uses in its sweep pose chains (``semantic_nusc.py:188-240``).
"""

from __future__ import annotations

import numpy as np


def quat_to_rot(q) -> np.ndarray:
    """Unit quaternion [w, x, y, z] -> 3x3 rotation matrix."""
    w, x, y, z = q
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1 - (xx + yy)],
        ]
    )


def transform_matrix(translation, rotation_quat, inverse: bool = False) -> np.ndarray:
    """4x4 homogeneous transform from translation + quaternion (devkit
    ``transform_matrix`` semantics)."""
    tm = np.eye(4)
    r = quat_to_rot(rotation_quat)
    t = np.asarray(translation, np.float64)
    if inverse:
        tm[:3, :3] = r.T
        tm[:3, 3] = -(r.T @ t)
    else:
        tm[:3, :3] = r
        tm[:3, 3] = t
    return tm


def apply_transform(tm: np.ndarray, xyz: np.ndarray) -> np.ndarray:
    """Apply a 4x4 transform to [N, 3] points."""
    return xyz @ tm[:3, :3].T + tm[:3, 3]


def project_to_image(xyz_cam: np.ndarray, intrinsic: np.ndarray):
    """Pinhole projection of camera-frame points.

    Returns (uv [N, 2] pixel coords, depth [N]).
    """
    depth = xyz_cam[:, 2]
    pts = xyz_cam @ intrinsic.T  # [N, 3]
    uv = pts[:, :2] / np.maximum(np.abs(depth[:, None]), 1e-6) * np.sign(
        depth[:, None]
    )
    return uv, depth
