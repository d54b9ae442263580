"""Build the instance-augmentation database (port of the root
``prepare_inst_database.py``; numpy and the port's own readers only).

Replaces the reference's three offline builders
(``prepare_nusc_inst_database.py`` / ``prepare_semkitti_inst_database.py`` /
``prepare_waymo_inst_database.py``): cut every panoptic instance of a thing
class out of its scan into a ``.bin`` of its own and index them in the
pickle ``dataset.inst_aug`` reads (``data/instaug.py``:
{class_name: [record_path, ...]}; .bin rows = xyz + features).

Usage:
  python -m u2mkd_tpu_torch.prepare_inst_database nusc  --root DATA --out DB_DIR [--split train]
  python -m u2mkd_tpu_torch.prepare_inst_database kitti --root DATA --out DB_DIR
  python -m u2mkd_tpu_torch.prepare_inst_database waymo --root DATA --out DB_DIR

nuScenes: panoptic .npz labels ('data' array, instance ids as shipped by
nuScenes-panoptic); rows are xyzie (5 floats). SemanticKITTI: instance id =
anno >> 16, semantics = anno & 0xFFFF (reference
``prepare_semkitti_inst_database.py:52-60``); rows are xyzi.
"""

from __future__ import annotations

import argparse
import os
import pickle
from collections import defaultdict

import numpy as np

# per-dataset minimum instance size, matching the reference builders
# (prepare_nusc_inst_database.py:53 = 10, prepare_semkitti_:25 = 40,
# prepare_waymo_:54 = 50)
MIN_INST_POINT = {"nusc": 10, "kitti": 40, "waymo": 50}

NUSC_THING_LIST = list(range(1, 11))
NUSC_CLASS_NAMES = [
    "barrier", "bicycle", "bus", "car", "construction_vehicle", "motorcycle",
    "pedestrian", "traffic_cone", "trailer", "truck",
]
KITTI_THING_LIST = [1, 2, 3, 4, 5, 6, 7, 8]
KITTI_CLASS_NAMES = [
    "car", "bicycle", "motorcycle", "truck", "other-vehicle", "person",
    "bicyclist", "motorcyclist",
]
# Waymo 22-class set: things 1-13 (reference
# prepare_waymo_inst_database.py:53 + visualize_utils.py:138-162)
WAYMO_THING_LIST = list(range(1, 14))
WAYMO_CLASS_NAMES = [
    "car", "truck", "bus", "other_vehicle", "motorcyclist", "bicyclist",
    "pedestrian", "sign", "traffic_light", "pole", "construction_cone",
    "bicycle", "motorcycle",
]


def extract_instances(points, sem_label, pano_label, thing_list, class_names,
                      token, out_dir, db, min_points=10):
    """Cut every panoptic instance of a thing class into its own .bin."""
    for ti, thing_id in enumerate(thing_list):
        name = class_names[ti]
        mask = sem_label == thing_id
        if not mask.any():
            continue
        for inst_id in np.unique(pano_label[mask]):
            # 0 = unlabeled; -1 = invalid waymo panoptic id (reference
            # prepare_waymo_inst_database.py:136-137)
            if inst_id == 0 or inst_id == -1:
                continue
            idx = np.where(pano_label == inst_id)[0]
            if len(idx) < min_points:
                continue
            d = os.path.join(out_dir, name)
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"{token}_{name}_{inst_id}.bin")
            if not os.path.exists(path):
                points[idx].astype(np.float32).tofile(path)
            db[name].append(os.path.relpath(path, out_dir))


def run_nusc(args):
    from u2mkd_tpu_torch.data import nusc_splits
    from u2mkd_tpu_torch.data.nusc_reader import NuScenesTables
    from u2mkd_tpu_torch.data.semantic_nusc import remap_labels

    nusc = NuScenesTables(args.root, args.version)
    samples = nusc_splits.select_samples(
        nusc.sample, args.split, nusc.scene_name,
        allow_unofficial=args.allow_unofficial_split,
    )
    db = defaultdict(list)
    for i, sample in enumerate(samples):
        sd_token = sample["data"]["LIDAR_TOP"]
        sd = nusc.get("sample_data", sd_token)
        pts = np.fromfile(os.path.join(args.root, sd["filename"]),
                          np.float32).reshape(-1, 5)
        seg = nusc.get("lidarseg", sd_token)
        sem = remap_labels(
            np.fromfile(os.path.join(args.root, seg["filename"]), np.uint8)
        )
        pano_path = os.path.join(
            args.root, seg["filename"]
            .replace("lidarseg", "panoptic")
            .replace(".bin", ".npz")
        )
        if not os.path.exists(pano_path):
            continue
        pano = np.load(pano_path)["data"]
        extract_instances(pts, sem, pano, NUSC_THING_LIST, NUSC_CLASS_NAMES,
                          sd_token, args.out, db,
                          min_points=MIN_INST_POINT["nusc"])
        if i % 500 == 0:
            print(f"{i}/{len(samples)}")
    return db


def run_kitti(args):
    import yaml

    with open(os.path.join(args.root, "semantic-kitti.yaml")) as f:
        lm = yaml.safe_load(f)["learning_map"]
    remap = np.zeros(max(lm) + 1, np.int32)
    for k, v in lm.items():
        remap[k] = v
    seqs = ["00", "01", "02", "03", "04", "05", "06", "07", "09", "10"]
    db = defaultdict(list)
    for seq in seqs:
        vdir = os.path.join(args.root, "sequences", seq, "velodyne")
        if not os.path.isdir(vdir):
            continue
        for name in sorted(os.listdir(vdir)):
            path = os.path.join(vdir, name)
            pts = np.fromfile(path, np.float32).reshape(-1, 4)
            anno = np.fromfile(
                path.replace("velodyne", "labels")[:-3] + "label", np.int32
            )
            sem = remap[anno & 0xFFFF]
            pano = anno >> 16
            extract_instances(pts, sem, pano, KITTI_THING_LIST,
                              KITTI_CLASS_NAMES, f"{seq}_{name[:-4]}",
                              args.out, db,
                              min_points=MIN_INST_POINT["kitti"])
    return db


def run_waymo(args):
    """Waymo keyframes.txt-driven extraction (reference
    ``prepare_waymo_inst_database.py:53-125``).

    Raw-format lines (``<seq>/lidar/<frame>.bin``) follow the reference's
    exact parsing: 6-col float32 lidar + [pano, sem] int32 labels + top-
    lidar sensor masks, both returns (``_ri2`` siblings) merged, rows
    saved as xyzie; ``.npy`` lines use the pre-extracted convenience
    format (xyzi + sem + pano columns)."""
    from u2mkd_tpu_torch.data.waymo import load_waymo_raw_keyframe

    keyframes = os.path.join(args.root, "keyframes.txt")
    with open(keyframes) as f:
        frames = [l for l in f.read().splitlines() if l]
    db = defaultdict(list)
    for fr in frames:
        if fr.endswith(".bin"):
            pts, sem, pano, token = load_waymo_raw_keyframe(args.root, fr)
        else:
            arr = np.load(os.path.join(args.root, fr))
            pts, sem, pano = (arr[:, :4], arr[:, 4].astype(np.int32),
                              arr[:, 5].astype(np.int64))
            token = os.path.splitext(os.path.basename(fr))[0]
        extract_instances(pts, sem, pano, WAYMO_THING_LIST, WAYMO_CLASS_NAMES,
                          token, args.out, db,
                          min_points=MIN_INST_POINT["waymo"])
    return db


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("dataset", choices=["nusc", "kitti", "waymo"])
    p.add_argument("--root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--version", default="v1.0-trainval")
    p.add_argument("--allow-unofficial-split", action="store_true",
                   help="permit the hash-split fallback when official "
                        "nuScenes split indices are missing")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    db = {"nusc": run_nusc, "kitti": run_kitti, "waymo": run_waymo}[args.dataset](args)
    for k, v in db.items():
        print(f"{k}: {len(v)} instances")
    pkl = os.path.join(args.out, f"inst_database_{args.split}_info.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(dict(db), f, protocol=pickle.HIGHEST_PROTOCOL)
    print("saved", pkl)
    return pkl


if __name__ == "__main__":
    main()
