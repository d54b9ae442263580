"""Host-side point-cloud transforms: augmentation, quantization, padding.

Port of ``u2mkd_tpu/data/transforms.py``, the reference's in-dataset
pipeline (``semantic_nusc.py:287-350``) in numpy: 4-way flip, z-rotation +
uniform scale, gaussian translate, voxel quantization with min-shift,
first-occurrence dedup (torchsparse ``sparse_quantize`` semantics, by the
native library only), and fixed-capacity padding into the feed format.
Every random draw comes from the caller's ``RandomState``, in the JAX
package's order, so both packages augment a scan identically.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from u2mkd_tpu_torch.data import native


def random_flip(xyz: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """4-way flip (none / x / y / both), reference ``semantic_nusc.py:288-295``."""
    flip_type = rng.choice(4)
    xyz = xyz.copy()
    if flip_type == 1:
        xyz[:, 0] = -xyz[:, 0]
    elif flip_type == 2:
        xyz[:, 1] = -xyz[:, 1]
    elif flip_type == 3:
        xyz[:, :2] = -xyz[:, :2]
    return xyz


def random_rotate_scale(xyz: np.ndarray, rng: np.random.RandomState,
                        rotate: bool = True) -> Tuple[np.ndarray, np.ndarray, float]:
    """z-rotation (0..2pi) + uniform scale (0.95..1.05) applied as
    ``xyz @ R`` (reference ``semantic_nusc.py:297-317``). Returns
    (transformed xyz, rot matrix, scale)."""
    if rotate:
        theta = rng.uniform(0, 2 * np.pi)
        scale = rng.uniform(0.95, 1.05)
    else:
        theta, scale = 0.0, 1.0
    rot = np.array(
        [
            [np.cos(theta), np.sin(theta), 0],
            [-np.sin(theta), np.cos(theta), 0],
            [0, 0, 1],
        ]
    )
    return (xyz @ rot) * scale, rot, scale


def random_translate(xyz: np.ndarray, std, rng: np.random.RandomState) -> np.ndarray:
    noise = np.array([rng.normal(0, s) for s in std])
    return xyz + noise


def quantize(xyz: np.ndarray, voxel_size: float):
    """round(xyz / voxel) - min (reference ``semantic_nusc.py:320-322``)."""
    voxel = np.round(xyz / voxel_size).astype(np.int32)
    voxel -= voxel.min(0, keepdims=True)
    return voxel


def sparse_quantize_index(voxel: np.ndarray):
    """First-occurrence dedup of integer voxel coords.

    torchsparse ``sparse_quantize(return_index, return_inverse)`` semantics
    (``semantic_nusc.py:325-328``): ``inds`` = first occurrence (in scan
    order) of each unique voxel; ``inverse`` maps every point to its
    representative's position in ``inds``. The native pointcore hash dedup;
    there is no numpy fallback.
    """
    return native.dedup_first(voxel)


def pad_to_capacity(arrays: Dict[str, np.ndarray], capacity: int,
                    pad_values: Optional[Dict[str, float]] = None):
    """Pad/truncate every [N, ...] array to [capacity, ...] + mask [capacity]."""
    n = next(iter(arrays.values())).shape[0]
    m = min(n, capacity)
    out = {}
    for k, a in arrays.items():
        pv = (pad_values or {}).get(k, 0)
        padded = np.full((capacity,) + a.shape[1:], pv, a.dtype)
        padded[:m] = a[:m]
        out[k] = padded
    mask = np.zeros(capacity, bool)
    mask[:m] = True
    return out, mask, n


def build_feed(
    xyz_aug: np.ndarray,      # [N, 3] augmented metric coords
    intensity: np.ndarray,    # [N] or [N, k] extra features
    labels: np.ndarray,       # [N]
    keyframe_mask: np.ndarray,  # [N]
    voxel_size: float,
    capacity: int,
):
    """Quantize + dedup + pad into the model feed format. Returns
    (feed dict, info dict with inds/inverse_map/num for eval devox)."""
    voxel = quantize(xyz_aug, voxel_size)
    inds, inverse = sparse_quantize_index(voxel)
    feats = np.concatenate(
        [xyz_aug.astype(np.float32),
         np.atleast_2d(intensity.astype(np.float32).T).T.reshape(len(xyz_aug), -1)],
        axis=1,
    )
    sel = dict(
        pcoords=voxel[inds].astype(np.float32),
        xyz=xyz_aug[inds].astype(np.float32),
        feats=feats[inds],
        labels=labels[inds].astype(np.int32),
        keyframe_mask=keyframe_mask[inds],
    )
    padded, pmask, n_unique = pad_to_capacity(sel, capacity)
    padded["pmask"] = pmask
    info = dict(inds=inds, inverse_map=inverse, num_vox=n_unique,
                labels_full=labels, keyframe_mask_full=keyframe_mask)
    return padded, info
