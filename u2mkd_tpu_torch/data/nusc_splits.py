"""nuScenes official split resolution (port of
``u2mkd_tpu/data/nusc_splits.py``).

Priority: (1) the official sample-index files shipped in the repository's
``data/nuscenes/`` (the artifacts the reference loads,
``semantic_nusc.py:154-159``); (2) a deterministic md5 hash split by scene
name, only behind ``allow_unofficial`` (with a warning: it is NOT the
official benchmark split).
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional

import numpy as np

_REPO_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "..", "..", "data", "nuscenes")


def official_indices(split: str) -> Optional[np.ndarray]:
    path = os.path.join(_REPO_DATA, f"nuscenes_{split}_official.npy")
    if os.path.exists(path):
        return np.load(path)
    return None


def select_samples(samples: List[dict], split: str, scene_name_fn,
                   allow_unofficial: bool = False) -> List[dict]:
    if split == "test":
        # the reference evaluates the test split over ALL keyframe samples
        # of the v1.0-test table (no index file exists for it)
        return list(samples)
    idx = official_indices(split)
    if idx is not None and len(samples) > int(idx.max()):
        return [samples[i] for i in idx]
    # Deterministic hash fallback: ~85/15 by scene name. For benchmark-parity
    # runs a silent non-official split would corrupt mIoU comparisons, so it
    # must be opted into explicitly.
    if not allow_unofficial:
        raise RuntimeError(
            "official nuScenes split indices unavailable or incompatible "
            f"with this table (split={split!r}, n_samples={len(samples)}); "
            "place nuscenes_{train,val}_official.npy under data/nuscenes/ "
            "(the artifacts the reference loads, semantic_nusc.py:154-159) "
            "or pass allow_unofficial_split=True to use a deterministic "
            "hash split that is NOT the benchmark split"
        )
    import warnings

    warnings.warn(
        "official nuScenes split indices unavailable or incompatible; "
        "using a deterministic hash split (NOT the benchmark split)"
    )
    out = []
    for s in samples:
        h = int(hashlib.md5(scene_name_fn(s).encode()).hexdigest(), 16) % 100
        is_val = h < 15
        if (split == "val") == is_val:
            out.append(s)
    return out
