"""Minimal self-contained nuScenes table reader (port of
``u2mkd_tpu/data/nusc_reader.py``).

The reference uses nuscenes-devkit only for JSON table lookup and pose
records (``semantic_nusc.py:66, 188-240``). This reader loads the v1.0 JSON
tables directly and gives the same ``get(table, token)`` access, keyframe
sample listing, and the devkit's reverse index (``sample["data"]``). The
split comes from :mod:`u2mkd_tpu_torch.data.nusc_splits`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

from u2mkd_tpu_torch.data import nusc_splits

TABLES = (
    "sample", "sample_data", "ego_pose", "calibrated_sensor", "scene",
    "sensor", "lidarseg",
)


class NuScenesTables:
    def __init__(self, dataroot: str, version: str = "v1.0-trainval",
                 verbose: bool = False):
        self.dataroot = dataroot
        self.version = version
        table_dir = os.path.join(dataroot, version)
        self._tables: Dict[str, List[dict]] = {}
        self._index: Dict[str, Dict[str, dict]] = {}
        for t in TABLES:
            path = os.path.join(table_dir, f"{t}.json")
            if not os.path.exists(path):
                self._tables[t] = []
                self._index[t] = {}
                continue
            with open(path) as f:
                rows = json.load(f)
            self._tables[t] = rows
            self._index[t] = {r["token"]: r for r in rows}
            if verbose:
                print(f"{t}: {len(rows)} rows")
        # lidarseg is keyed by sample_data token in usage
        self._lidarseg_by_sd = {
            r["sample_data_token"]: r for r in self._tables.get("lidarseg", [])
        }
        self.sample = self._tables["sample"]
        self._make_reverse_index()

    def _make_reverse_index(self):
        """Devkit parity: real nuScenes ``sample.json`` rows have NO
        ``data`` channel map — the devkit synthesizes it in
        ``__make_reverse_index__`` from the keyframe sample_data rows.
        The datasets read ``sample["data"]["LIDAR_TOP"]``/``CAM_*``, so
        build the same map here (fixture tables that already carry
        ``data`` are left untouched)."""
        for s in self.sample:
            s.setdefault("data", {})
        for sd in self._tables.get("sample_data", []):
            if not sd.get("is_key_frame"):
                continue
            cs = self._index["calibrated_sensor"].get(
                sd.get("calibrated_sensor_token"))
            if cs is None:
                continue
            sensor = self._index.get("sensor", {}).get(cs.get("sensor_token"))
            if sensor is None:
                continue
            samp = self._index["sample"].get(sd.get("sample_token"))
            if samp is not None:
                samp["data"].setdefault(sensor["channel"], sd["token"])

    def get(self, table: str, token: str) -> dict:
        if table == "lidarseg":
            return self._lidarseg_by_sd.get(token) or self._index["lidarseg"][token]
        return self._index[table][token]

    def scene_name(self, sample_rec: dict) -> str:
        return self.get("scene", sample_rec["scene_token"])["name"]

    def split_samples(self, split: str,
                      allow_unofficial: bool = False) -> List[dict]:
        """Keyframe samples of the official split, in table order (routes
        through :func:`nusc_splits.select_samples`, the live path the
        datasets use — the old scene-list fallback always raised)."""
        return nusc_splits.select_samples(
            self.sample, split, self.scene_name,
            allow_unofficial=allow_unofficial,
        )
