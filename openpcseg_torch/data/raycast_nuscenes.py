"""Ray-cast surrogate sweeps written as a nuScenes-lidarseg tree.

The layout ``data/nuscenes.py`` reads (the official one, as
``tests/test_nuscenes.py make_mini_nuscenes`` writes it):
``<root>/v1.0-trainval/{scene,sample,sample_data,lidarseg}.json``, one
key-frame sweep per sample as ``samples/LIDAR_TOP/*.pcd.bin`` (float32
``[x, y, z, intensity, ring]``) and its labels as
``lidarseg/v1.0-trainval/<sample_data_token>_lidarseg.bin`` (uint8 raw
categories). Each sweep is a ray-cast scene (``raycast.py``) seen by
nuScenes' HDL-32E: 32 beams over [-30, +10] degrees (``nuscenes_meta``'s
FOV), 1088 columns (the range view's width), 70 m of range, from 1.84 m
above the ground, written in the sensor frame as nuScenes' sweeps are
(z of the ground -1.84). The ring column is the beam (0 the lowest, as
``NuscenesDataset.ring_from_pitch`` counts), the intensity the ray-cast
one times 255. Labels go from the ray-cast classes to nuScenes' 16
classes through ``NUSC_OF_RAYCAST``, then to the first raw category of
each (``LEARNING_MAP_INV``), which the reader maps back. A sweep holds
about 30-32k points.

The reader splits by scene, by a seeded permutation of the scene names
(85 / 15); the writer names the scenes so that this split puts the
`n_val` sweeps in val and the `n_train` sweeps in train.

    python -m openpcseg_torch.data.raycast_nuscenes <root> [n_train] [n_val]
"""
from __future__ import annotations

import json
import math
import os
import sys

import numpy as np

from .nuscenes_meta import LEARNING_MAP_INV
from .raycast import raycast_scan

VERSION = "v1.0-trainval"
N_BEAMS, N_AZIMUTH = 32, 1088
FOV_UP, FOV_DOWN = 10.0, -30.0
MAX_RANGE = 70.0
SENSOR_Z = 1.84
SWEEPS_PER_SCENE = 10
# ray-cast class (SemanticKITTI train id, raycast.py) -> nuScenes train id
# (nuscenes_meta.CLASS_NAMES): car car, road driveable_surface, sidewalk
# sidewalk, building / fence / pole / sign manmade, vegetation and trunk
# vegetation, terrain terrain; 0 ignore
NUSC_OF_RAYCAST = np.zeros(20, np.int32)
for _kitti, _nusc in ((1, 4), (9, 11), (11, 13), (13, 15), (14, 15),
                      (15, 16), (16, 16), (17, 14), (18, 15), (19, 15)):
    NUSC_OF_RAYCAST[_kitti] = _nusc


def nuscenes_sweep(seed: int):
    """(points [N, 5] float32 x, y, z, intensity, ring in the sensor frame;
    raw lidarseg categories [N] uint8) of the sweep of `seed`."""
    xyz, feats, lab = raycast_scan(
        seed, n_beams=N_BEAMS, n_azimuth=N_AZIMUTH, max_range=MAX_RANGE,
        fov_up=FOV_UP, fov_down=FOV_DOWN, sensor_z=SENSOR_Z)
    rel = xyz.astype(np.float64) - np.array([0.0, 0.0, SENSOR_Z])
    pitch = np.degrees(np.arcsin(rel[:, 2] / np.linalg.norm(rel, axis=1)))
    ring = np.clip(np.rint((pitch - FOV_DOWN) / (FOV_UP - FOV_DOWN)
                           * (N_BEAMS - 1)), 0, N_BEAMS - 1)
    intensity = np.clip(feats[:, 3] * 255.0, 0.0, 255.0)
    pts = np.stack([rel[:, 0], rel[:, 1], rel[:, 2], intensity, ring],
                   axis=1).astype(np.float32)
    raw = LEARNING_MAP_INV[NUSC_OF_RAYCAST[lab]].astype(np.uint8)
    return pts, raw


def scene_plan(n_train: int, n_val: int):
    """Scene names and the sweeps of each, [(name, split, count)], such
    that the reader's default split (NuscenesDataset: a permutation of
    the sorted names by default_rng(0), its first max(1, round(0.15 S))
    in val) puts the val scenes in val."""
    for s in range(max(2, math.ceil((n_train + n_val) / SWEEPS_PER_SCENE)),
                   1, -1):
        v = max(1, int(round(s * 0.15)))
        if v <= n_val and s - v <= n_train:
            break
    names = [f"scene-{i:04d}" for i in range(s)]
    val = set(np.random.default_rng(0).permutation(s)[:v].tolist())
    tr = [i for i in range(s) if i not in val]
    va = sorted(val)

    def spread(n, k):
        return [n // k + (j < n % k) for j in range(k)]
    plan = dict(zip(tr, (("train", c) for c in spread(n_train, len(tr)))))
    plan.update(zip(va, (("val", c) for c in spread(n_val, len(va)))))
    return [(names[i],) + plan[i] for i in range(s)]


def write_tree(root, n_train: int = 32, n_val: int = 8,
               verbose: bool = False) -> str:
    """Write the tree under `root` (train sweeps of seeds 0.., val sweeps of
    seeds 10000..); returns `root` (the DATA_PATH to give the configs)."""
    for d in (VERSION, "samples/LIDAR_TOP", f"lidarseg/{VERSION}"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    tables = {"scene": [], "sample": [], "sample_data": [], "lidarseg": []}
    next_seed = {"train": 0, "val": 10_000}
    for si, (name, split, count) in enumerate(scene_plan(n_train, n_val)):
        scene_tok = f"scene{si:04d}"
        tables["scene"].append({"token": scene_tok, "name": name})
        for k in range(count):
            seed = next_seed[split]
            next_seed[split] += 1
            samp_tok, sd_tok = f"samp{si:04d}_{k}", f"sd{si:04d}_{k}"
            fn = f"samples/LIDAR_TOP/n{si:04d}_{k:03d}.pcd.bin"
            lab_fn = f"lidarseg/{VERSION}/{sd_tok}_lidarseg.bin"
            pts, raw = nuscenes_sweep(seed)
            pts.tofile(os.path.join(root, fn))
            raw.tofile(os.path.join(root, lab_fn))
            tables["sample"].append({"token": samp_tok,
                                     "scene_token": scene_tok})
            tables["sample_data"].append({
                "token": sd_tok, "sample_token": samp_tok, "filename": fn,
                "is_key_frame": True, "fileformat": "pcd"})
            tables["lidarseg"].append({"token": f"ls{si:04d}_{k}",
                                       "sample_data_token": sd_tok,
                                       "filename": lab_fn})
            if verbose:
                print(f"{name} ({split}) {fn}: {len(pts)} points",
                      flush=True)
    for name, tbl in tables.items():
        with open(os.path.join(root, VERSION, f"{name}.json"), "w") as f:
            json.dump(tbl, f)
    return str(root)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Write ray-cast sweeps as a nuScenes-lidarseg tree.")
    ap.add_argument("root")
    ap.add_argument("n_train", type=int, nargs="?", default=32)
    ap.add_argument("n_val", type=int, nargs="?", default=8)
    args = ap.parse_args(argv)
    print("done ->", write_tree(args.root, args.n_train, args.n_val,
                                verbose=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
